"""BFV encryptor (port of mkhe_tpu/mkbfv/encryptor.py): integer slot
encode (scaled by Q/t) + mkrlwe public-key encryption."""

from __future__ import annotations

from .. import mkrlwe
from .params import Parameters
from . import encoder


class Encryptor:
    def __init__(self, params: Parameters, seed: int = 2):
        self.params = params
        self._enc = mkrlwe.Encryptor(params.rlwe, seed=seed)

    def encrypt_msg(self, values, pk: mkrlwe.PublicKey) -> mkrlwe.Ciphertext:
        return self._enc.encrypt(encoder.encode(self.params, values), pk)
