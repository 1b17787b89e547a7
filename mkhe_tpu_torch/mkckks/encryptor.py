"""CKKS encryptor: canonical-embedding encode + mkrlwe public-key encrypt
(port of mkhe_tpu/mkckks/encryptor.py)."""

from __future__ import annotations

import numpy as np
import torch

from .. import mkrlwe
from .params import Parameters
from .elements import Ciphertext, Message
from . import encoder


class Encryptor:
    def __init__(self, params: Parameters, seed: int = 2):
        self.params = params
        self._enc = mkrlwe.Encryptor(params.rlwe, seed=seed)

    def encode_msg(self, msg: Message, level: int | None = None,
                   scale: float | None = None) -> np.ndarray:
        """Message -> coefficient-domain plaintext, numpy uint32 (Lq, N)."""
        p = self.params
        if level is None:
            level = p.max_level
        if scale is None:
            scale = p.scale
        return encoder.encode(msg.value, scale, p.rlwe.q_moduli[:level + 1],
                              p.logn, logslots=p.logslots)

    def encrypt_msg(self, msg: Message, pk: mkrlwe.PublicKey,
                    level: int | None = None) -> Ciphertext:
        """Encode, then encrypt (EncryptMsgNew)."""
        p = self.params
        if level is None:
            level = p.max_level
        pt = torch.from_numpy(self.encode_msg(msg, level).astype(np.int64)
                              ).to(p.rlwe.device)
        ct = self._enc.encrypt(pt, pk, level=level)
        return Ciphertext(ct=ct, scale=p.scale)
