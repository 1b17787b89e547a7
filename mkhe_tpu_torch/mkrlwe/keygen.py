"""Key generation (port of mkhe_tpu/mkrlwe/keygen.py).

With CRS a = crs[0] and u = crs[-1], all NTT + Montgomery:

  sk:   ternary s (P(0) = 1/2), extended to QP
  pk:   (-a_0 s + e, a_0)
  swk(s'): g*s' + e, where digit i of g adds P*s' on the i-th RNS block
  rlk:  b = -s a + e;  d = swk(s) - r a;  v = -(s u + swk(r))

The array work lives in the "cores" below, which take the signed samples
as tensors, so a test can feed this package and the JAX one the same
samples. KeyGenerator draws the samples from a torch.Generator.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops import sampling
from .params import Parameters
from .keys import SecretKey, PublicKey, SwitchingKey, RelinearizationKey


# -- cores -------------------------------------------------------------------

def _secret_key_core(rp: Parameters, s_signed) -> torch.Tensor:
    ring = rp.ring_qp
    return ring.to_mont(ring.ntt(sampling.lift_signed(s_signed, ring)))


def _gaussian_qp_core(rp: Parameters, e_signed) -> torch.Tensor:
    ring = rp.ring_qp
    return ring.to_mont(ring.ntt(sampling.lift_signed(e_signed, ring)))


def _public_key_core(rp: Parameters, e_mont, s_mont) -> torch.Tensor:
    ring = rp.ring_qp
    a = rp.crs[0][0]
    return torch.stack([ring.sub(e_mont, ring.mul_mont(a, s_mont)), a])


def _switching_key_core(rp: Parameters, e_mont, s_mont) -> torch.Tensor:
    """swk_i = e_i + P*s on RNS block i of Q (alpha limbs starting at
    i*alpha), all in Montgomery + NTT."""
    lq = rp.qcount
    beta = e_mont.shape[0]
    ps = rp.ring_q.mul_scalar_mont(s_mont[:lq], rp.pmodq_mont)  # P*s, Mont
    limb = torch.arange(lq, device=rp.device)
    digit = torch.arange(beta, device=rp.device)[:, None]
    mask = (limb[None, :] // rp.alpha) == digit                 # (beta, lq)
    swk_q = torch.where(mask[:, :, None],
                        rp.ring_q.add(e_mont[:, :lq], ps[None]),
                        e_mont[:, :lq])
    return torch.cat([swk_q, e_mont[:, lq:]], dim=1)


def _relin_b_core(rp: Parameters, e_mont, s_mont) -> torch.Tensor:
    # b and d are stored in DOUBLE-Montgomery form (see keys.py).
    ring = rp.ring_qp
    a = rp.crs[0][:e_mont.shape[0]]
    return ring.to_mont(ring.sub(e_mont, ring.mul_mont(a, s_mont[None])))


def _relin_d_core(rp: Parameters, sg, r_mont) -> torch.Tensor:
    ring = rp.ring_qp
    a = rp.crs[0][:sg.shape[0]]
    return ring.to_mont(ring.sub(sg, ring.mul_mont(a, r_mont[None])))


def _relin_v_core(rp: Parameters, rg, s_mont) -> torch.Tensor:
    ring = rp.ring_qp
    u = rp.crs[-1][:rg.shape[0]]
    return ring.neg(ring.add(ring.mul_mont(u, s_mont[None]), rg))


# ----------------------------------------------------------------------------


class KeyGenerator:
    def __init__(self, params: Parameters, seed: int = 1):
        self.params = params
        self.gen = torch.Generator(device=params.device)
        self.gen.manual_seed(seed)

    def gen_secret_key(self, pid: str) -> SecretKey:
        p = self.params
        s = sampling.ternary(self.gen, p.n, p.device)
        return SecretKey(id=pid, data=_secret_key_core(p, s))

    def _gaussian_qp(self, *batch) -> torch.Tensor:
        """Gaussian error, extended to QP, NTT domain, Montgomery form."""
        p = self.params
        total = 1
        for b in batch:
            total *= b
        e = sampling.gaussian(self.gen, total * p.n, p.device,
                              sigma=p.sigma).reshape(*batch, p.n)
        return _gaussian_qp_core(p, e)

    def gen_public_key(self, sk: SecretKey) -> PublicKey:
        return PublicKey(id=sk.id, data=_public_key_core(
            self.params, self._gaussian_qp(), sk.data))

    def gen_key_pair(self, pid: str) -> Tuple[SecretKey, PublicKey]:
        sk = self.gen_secret_key(pid)
        return sk, self.gen_public_key(sk)

    def gen_switching_key(self, sk_in: SecretKey) -> SwitchingKey:
        """g * s_in + e in Montgomery + NTT (the reference's gadget
        g_i = P * (Q/B_i) * ((Q/B_i)^-1 mod B_i), keygen.go:301-324)."""
        p = self.params
        e = self._gaussian_qp(p.beta(p.max_level))
        return SwitchingKey(id=sk_in.id,
                            data=_switching_key_core(p, e, sk_in.data))

    def gen_relinearization_key(self, sk: SecretKey, r: SecretKey
                                ) -> RelinearizationKey:
        p = self.params
        b = _relin_b_core(p, self._gaussian_qp(p.beta(p.max_level)),
                          sk.data)
        d = _relin_d_core(p, self.gen_switching_key(sk).data, r.data)
        v = _relin_v_core(p, self.gen_switching_key(r).data, sk.data)
        return RelinearizationKey(id=sk.id, b=b, d=d, v=v)
