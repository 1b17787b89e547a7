"""Distributed decryption (port of mkhe_tpu/mkrlwe/decryptor.py).

partial_decrypt is the MPC primitive: party i computes c_0 += c_i * s_i
and drops its component; decrypt folds all parties' shares at once.
"""

from __future__ import annotations

import torch

from .params import Parameters
from .elements import Ciphertext
from .keys import SecretKey, SecretKeySet


def _partial_core(rp: Parameters, c0, ci, sk_data, level: int):
    ring = rp.ring_q_at(level)
    prod = ring.intt(ring.mul_mont(ring.ntt(ci), sk_data[:level + 1]))
    return ring.add(c0, prod)


def _full_core(rp: Parameters, data, sk_stack, level: int):
    """c0 + sum_i c_i * s_i in one batched pass."""
    ring = rp.ring_q_at(level)
    total = ring.intt(ring.mul_mont(ring.ntt(data[1:]),
                                    sk_stack[:, :level + 1]))
    out = data[0]
    for i in range(total.shape[0]):
        out = ring.add(out, total[i])
    return out


class Decryptor:
    def __init__(self, params: Parameters):
        self.params = params

    def partial_decrypt(self, ct: Ciphertext, sk: SecretKey) -> Ciphertext:
        i = ct.ids.index(sk.id)
        c0 = _partial_core(self.params, ct.data[0], ct.data[1 + i],
                           sk.data, ct.level)
        rest = torch.cat([c0[None], ct.data[1:1 + i], ct.data[2 + i:]])
        return Ciphertext(ids=ct.ids[:i] + ct.ids[i + 1:], data=rest)

    def decrypt(self, ct: Ciphertext, sk_set: SecretKeySet) -> torch.Tensor:
        """Coefficient-domain plaintext (Lq, N)."""
        if not ct.ids:
            return ct.data[0]
        sk_stack = torch.stack([sk_set.get(pid).data for pid in ct.ids])
        return _full_core(self.params, ct.data, sk_stack, ct.level)
