"""Single-party RLWE public-key encryption producing 2-component multi-key
ciphertexts (port of mkhe_tpu/mkrlwe/encryptor.py, coefficient-domain
plaintext and output):

    ct = { "0": u*pk0 + e0 + m,   id: u*pk1 + e1 }

with ternary u and gaussian e0, e1.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import sampling
from .params import Parameters
from .elements import Ciphertext
from .keys import PublicKey


def _encrypt_core(rp: Parameters, pk_data, pt, u_signed, e0_signed,
                  e1_signed, level: int) -> torch.Tensor:
    """pt: (level+1, N) coefficient-domain plaintext or None."""
    ring = rp.ring_q_at(level)
    u_ntt = ring.ntt(sampling.lift_signed(u_signed, ring))
    # both products share one inverse NTT (poly-wise, so bit-identical)
    c = ring.intt(ring.mul_mont(u_ntt[None], pk_data[:, :level + 1]))
    c0 = ring.add(c[0], sampling.lift_signed(e0_signed, ring))
    c1 = ring.add(c[1], sampling.lift_signed(e1_signed, ring))
    if pt is not None:
        c0 = ring.add(c0, pt)
    return torch.stack([c0, c1])


class Encryptor:
    def __init__(self, params: Parameters, seed: int = 2):
        self.params = params
        self.gen = torch.Generator(device=params.device)
        self.gen.manual_seed(seed)

    def encrypt(self, plaintext: Optional[torch.Tensor], pk: PublicKey,
                level: Optional[int] = None) -> Ciphertext:
        """plaintext: (Lq_level, N) coefficient domain, or None for an
        encryption of zero. Returns a fresh 2-component ciphertext."""
        p = self.params
        if level is None:
            level = (plaintext.shape[-2] - 1 if plaintext is not None
                     else p.max_level)
        u = sampling.ternary(self.gen, p.n, p.device)
        e0 = sampling.gaussian(self.gen, p.n, p.device, sigma=p.sigma)
        e1 = sampling.gaussian(self.gen, p.n, p.device, sigma=p.sigma)
        data = _encrypt_core(p, pk.data, plaintext, u, e0, e1, level)
        return Ciphertext(ids=(pk.id,), data=data)
