"""CKKS decryptor: multi-key decrypt + decode (port of
mkhe_tpu/mkckks/decryptor.py)."""

from __future__ import annotations

import numpy as np

from .. import mkrlwe
from .params import Parameters
from .elements import Ciphertext, Message
from . import encoder


class Decryptor:
    def __init__(self, params: Parameters):
        self.params = params
        self._dec = mkrlwe.Decryptor(params.rlwe)

    def partial_decrypt(self, ct: Ciphertext, sk: mkrlwe.SecretKey
                        ) -> Ciphertext:
        return Ciphertext(ct=self._dec.partial_decrypt(ct.ct, sk),
                          scale=ct.scale)

    def decrypt(self, ct: Ciphertext, sk_set: mkrlwe.SecretKeySet,
                exact: bool | None = None) -> Message:
        """Decrypt, copy the plaintext to the host, decode (exact=None
        lets decode pick its safe per-level CRT path)."""
        p = self.params
        pt = self._dec.decrypt(ct.ct, sk_set).cpu().numpy().astype(np.uint32)
        z = encoder.decode(pt, ct.scale, p.rlwe.q_moduli[:ct.level + 1],
                           p.logn, logslots=p.logslots, exact=exact)
        return Message(value=z)
