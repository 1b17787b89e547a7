"""Key generation (port of mkhe_tpu/mkrlwe/keygen.py).

With CRS a = crs[0] and u = crs[-1], all NTT + Montgomery:

  sk:   ternary s (P(0) = 1/2), extended to QP
  pk:   (-a_0 s + e, a_0)
  swk(s'): g*s' + e, where digit i of g adds P*s' on the i-th RNS block
  rlk:  b = -s a + e;  d = swk(s) - r a;  v = -(s u + swk(r))
  rtk:  swk(s) - a^(rot) sigma_{g^-1}(s)        (keygen.go:190-229)
  cjk:  swk(sigma_conj(s)) - a^(conj) s         (keygen.go:240-267)

The array work lives in the "cores" below, which take the signed samples
as tensors. KeyGenerator draws the samples as the JAX package's does:
from threefry key(seed), one split per sampler call, in the JAX package's
order, so that the same seed gives both packages the same keys.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..ops import sampling, threefry
from ..ops.ring import galois_element_conj, galois_element_rot
from .params import Parameters
from .keys import (SecretKey, PublicKey, SwitchingKey, RelinearizationKey,
                   RotationKey, ConjugationKey)


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


def _rotation_key_core(rp: Parameters, sg, s_mont, rot_idx: int,
                       gal_inv: int) -> torch.Tensor:
    ring = rp.ring_qp
    sk_out = ring.permute_ntt(s_mont, gal_inv)
    a = rp.crs[rot_idx][:sg.shape[0]]
    return ring.sub(sg, ring.mul_mont(a, sk_out[None]))


def _conjugation_key_core(rp: Parameters, sg_conj, s_mont) -> torch.Tensor:
    ring = rp.ring_qp
    a = rp.crs[-2][:sg_conj.shape[0]]
    return ring.sub(sg_conj, ring.mul_mont(a, s_mont[None]))


# ----------------------------------------------------------------------------


class KeyGenerator:
    def __init__(self, params: Parameters, seed: int = 1):
        self.params = params
        self._keys = threefry.KeyChain(seed)

    def gen_secret_key(self, pid: str) -> SecretKey:
        p = self.params
        s = sampling.ternary(self._keys.next(), p.n, p.device)
        return SecretKey(id=pid, data=_secret_key_core(p, s))

    def gen_secret_key_sparse(self, pid: str, hw: int) -> SecretKey:
        """Secret with exactly hw non-zero coefficients
        (GenSecretKeySparse, keygen.go:78-85)."""
        p = self.params
        s = sampling.ternary_sparse(self._keys.next(), p.n, hw, p.device)
        return SecretKey(id=pid, data=_secret_key_core(p, s))

    def gen_secret_key_gaussian(self, pid: str) -> SecretKey:
        """Gaussian secret (GenSecretKeyGaussian, keygen.go:63-65)."""
        p = self.params
        s = sampling.gaussian(self._keys.next(), p.n, p.device,
                              sigma=p.sigma)
        return SecretKey(id=pid, data=_secret_key_core(p, s))

    def _gaussian_qp(self, *batch) -> torch.Tensor:
        """Gaussian error, extended to QP, NTT domain, Montgomery form."""
        p = self.params
        e = sampling.gaussian(self._keys.next(), math.prod(batch) * p.n,
                              p.device, sigma=p.sigma).reshape(*batch, p.n)
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

    def gen_rotation_key(self, rot_idx: int, sk: SecretKey) -> RotationKey:
        """Key of the rotation by rot_idx slots (a negative index counts
        from the end: rot_idx mod N/2). Needs the CRS at that index."""
        p = self.params
        if rot_idx < 0:
            rot_idx %= p.n // 2
        if rot_idx not in p.crs:
            raise KeyError(f"no CRS for rotation {rot_idx}; call add_crs "
                           "first (the reference panics too, "
                           "keygen.go:202-205)")
        gal = galois_element_rot(rot_idx, p.n)
        sg = self.gen_switching_key(sk).data
        data = _rotation_key_core(p, sg, sk.data, rot_idx,
                                  pow(gal, -1, 2 * p.n))
        return RotationKey(id=sk.id, rot_idx=rot_idx, data=data)

    def gen_default_rotation_keys(self, sk: SecretKey, rtk_set) -> None:
        """The power-of-two rotation keys 1, 2, ..., N/4 (keygen.go:
        232-237)."""
        rot = 1
        while rot < self.params.n // 2:
            rtk_set.add(self.gen_rotation_key(rot, sk))
            rot *= 2

    def gen_conjugation_key(self, sk: SecretKey) -> ConjugationKey:
        """Needs the CRS at -2 (a default one)."""
        p = self.params
        if -2 not in p.crs:
            raise KeyError("no CRS for conjugation (index -2); call "
                           "add_crs(-2)")
        s_conj = p.ring_qp.permute_ntt(sk.data, galois_element_conj(p.n))
        sg = self.gen_switching_key(SecretKey(id=sk.id, data=s_conj)).data
        return ConjugationKey(id=sk.id,
                              data=_conjugation_key_core(p, sg, sk.data))
