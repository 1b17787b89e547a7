"""BFV decryptor (port of mkhe_tpu/mkbfv/decryptor.py): multi-key partial
decryption + exact integer decode."""

from __future__ import annotations

import numpy as np

from .. import mkrlwe
from .params import Parameters
from . import encoder


class Decryptor:
    def __init__(self, params: Parameters):
        self.params = params
        self._dec = mkrlwe.Decryptor(params.rlwe)

    def partial_decrypt(self, ct: mkrlwe.Ciphertext, sk: mkrlwe.SecretKey
                        ) -> mkrlwe.Ciphertext:
        return self._dec.partial_decrypt(ct, sk)

    def decrypt(self, ct: mkrlwe.Ciphertext, sk_set: mkrlwe.SecretKeySet
                ) -> np.ndarray:
        """int64 slot values (N,), centered mod t."""
        return encoder.decode(self.params, self._dec.decrypt(ct, sk_set))
