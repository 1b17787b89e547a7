"""Single-party RLWE public-key encryption producing 2-component multi-key
ciphertexts (port of mkhe_tpu/mkrlwe/encryptor.py):

    ct = { "0": u*pk0 + e0 + m,   id: u*pk1 + e1 }

with ternary u and gaussian e0, e1, drawn from threefry key(seed) as the
JAX package draws them, so the same seed gives the same ciphertext. As in
the reference, the plaintext and the output may each be in the
coefficient or the NTT domain (pt_ntt / ct_ntt; encryptor.go:55-118
branches on both IsNTT flags).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import sampling, threefry
from .params import Parameters
from .elements import Ciphertext
from .keys import PublicKey


def _encrypt_core(rp: Parameters, pk_data, pt, u_signed, e0_signed,
                  e1_signed, level: int, pt_ntt: bool = False,
                  ct_ntt: bool = False) -> torch.Tensor:
    """pt: (level+1, N) plaintext (NTT domain if pt_ntt) or None; the
    result is in the NTT domain if ct_ntt. Both polynomials share each
    NTT launch (poly-wise, so bit-identical to separate calls)."""
    ring = rp.ring_q_at(level)
    u_ntt = ring.ntt(sampling.lift_signed(u_signed, ring))
    uk = ring.mul_mont(u_ntt[None], pk_data[:, :level + 1])
    e = sampling.lift_signed(torch.stack([e0_signed, e1_signed]), ring)
    if ct_ntt:
        # NTT-domain output (encryptor.go:74-93): a coefficient-domain
        # plaintext joins e0 before its NTT
        if pt is not None and not pt_ntt:
            e[0] = ring.add(e[0], pt)
        c = ring.add(uk, ring.ntt(e))
        if pt is not None and pt_ntt:
            c[0] = ring.add(c[0], pt)
        return c
    # coefficient-domain output (encryptor.go:95-112)
    c = ring.add(ring.intt(uk), e)
    if pt is not None:
        c[0] = ring.add(c[0], ring.intt(pt) if pt_ntt else pt)
    return c


class Encryptor:
    def __init__(self, params: Parameters, seed: int = 2):
        self.params = params
        self._keys = threefry.KeyChain(seed)

    def encrypt(self, plaintext: Optional[torch.Tensor], pk: PublicKey,
                level: Optional[int] = None, pt_ntt: bool = False,
                ct_ntt: bool = False) -> Ciphertext:
        """plaintext: (Lq_level, N), in the NTT domain if pt_ntt, or None
        for an encryption of zero. Returns a fresh 2-component
        ciphertext, in the NTT domain if ct_ntt (the reference's four
        IsNTT combinations)."""
        p = self.params
        if level is None:
            level = (plaintext.shape[-2] - 1 if plaintext is not None
                     else p.max_level)
        # u, e0, e1, each under its own key, in the JAX package's order
        u = sampling.ternary(self._keys.next(), p.n, p.device)
        e0 = sampling.gaussian(self._keys.next(), p.n, p.device,
                               sigma=p.sigma)
        e1 = sampling.gaussian(self._keys.next(), p.n, p.device,
                               sigma=p.sigma)
        data = _encrypt_core(p, pk.data, plaintext, u, e0, e1, level,
                             pt_ntt, ct_ntt)
        return Ciphertext(ids=(pk.id,), data=data)
