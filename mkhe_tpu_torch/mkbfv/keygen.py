"""BFV key generation (port of mkhe_tpu/mkbfv/keygen.py).

The fused-pair relinearization key over a = [CRS[0]; CRS[-3]] (2*beta
digits) and u = CRS[-1], all NTT + Montgomery:

  b = -s*a + e                        (2*beta digits, double-Montgomery)
  d = gBFV*s + e - r*a                (2*beta digits, double-Montgomery)
  v = -s*u - g*r - e                  (beta digits, the standard Q-basis
                                       gadget; Montgomery)

where digit i of the BFV gadget carries the scalar
  G_i = floor( t * P * (QQMul/B_i) * ((QQMul/B_i)^-1 mod B_i) / QMul )
with B_i the i-th alpha-limb block of Q (first half) or QMul (second half)
(mkbfv/keygen.go:91-162). As in mkrlwe/keygen.py, the array work lives in
cores that take the samples as tensors; KeyGenerator draws them from its
threefry key in the JAX package's order (b's 2*beta gaussians, then
gen_bfv_switching_key(s), then gen_switching_key(r)), so that the same
seed gives both packages the same keys.
"""

from __future__ import annotations

import functools
import math

import torch

from .. import mkrlwe
from ..mkrlwe import keygen as rlwe_keygen
from ..ops import modmath as mm
from .params import Parameters
from .keys import RelinearizationKey


@functools.lru_cache(maxsize=None)
def _gadget_scalars(q_moduli, qmul_moduli, p_moduli, alpha: int, t: int):
    Q, QMul, P = (math.prod(m) for m in (q_moduli, qmul_moduli, p_moduli))
    out = []
    for half in (q_moduli, qmul_moduli):
        for i in range(0, len(half), alpha):
            b_i = math.prod(half[i:i + alpha])
            g = Q * QMul // b_i
            out.append(t * P * g * pow(g % b_i, -1, b_i) // QMul)
    return tuple(out)


def bfv_gadget_scalars(params: Parameters) -> tuple:
    """The 2*beta python-int scalars G_i (KeyGenerator._bfv_gadget_scalars
    of the JAX package)."""
    rp = params.rlwe
    return _gadget_scalars(rp.q_moduli, params.qmul_moduli, rp.p_moduli,
                           rp.alpha, params.t)


def _crs_pair(params: Parameters) -> torch.Tensor:
    """a = [CRS[0][:beta]; CRS[-3][:beta]], (2*beta, Lqp, N)."""
    rp = params.rlwe
    beta = rp.beta(rp.max_level)
    return torch.cat([rp.crs[0][:beta], rp.crs[-3][:beta]])


# -- cores -------------------------------------------------------------------

def _bfv_switching_key_core(params: Parameters, e_mont, s_mont
                            ) -> torch.Tensor:
    """gBFV * s + e over QP, (2*beta, Lqp, N), NTT + Montgomery."""
    ring = params.rlwe.ring_qp
    g_mont = torch.tensor([[mm.to_mont_host(g % q, q) for q in ring.moduli]
                           for g in bfv_gadget_scalars(params)],
                          dtype=torch.int64, device=ring.device)
    gs = mm.mont_mul(s_mont[None], g_mont[:, :, None], ring.q[:, None],
                     ring.r_inv[:, None])
    return ring.add(e_mont, gs)


def _relin_b_core(params: Parameters, e_mont, s_mont) -> torch.Tensor:
    ring = params.rlwe.ring_qp
    a = _crs_pair(params)
    return ring.to_mont(ring.sub(e_mont, ring.mul_mont(a, s_mont[None])))


def _relin_d_core(params: Parameters, sg, r_mont) -> torch.Tensor:
    ring = params.rlwe.ring_qp
    a = _crs_pair(params)
    return ring.to_mont(ring.sub(sg, ring.mul_mont(a, r_mont[None])))


# ----------------------------------------------------------------------------


class KeyGenerator(mkrlwe.KeyGenerator):
    def __init__(self, params: Parameters, seed: int = 1):
        super().__init__(params.rlwe, seed=seed)
        self.bfv_params = params

    def gen_bfv_switching_key(self, sk: mkrlwe.SecretKey) -> torch.Tensor:
        """gBFV * s + e over QP, (2*beta, Lqp, N), NTT + Montgomery."""
        p = self.bfv_params
        e = self._gaussian_qp(2 * p.rlwe.beta(p.max_level))
        return _bfv_switching_key_core(p, e, sk.data)

    def gen_relinearization_key_bfv(self, sk: mkrlwe.SecretKey,
                                    r: mkrlwe.SecretKey
                                    ) -> RelinearizationKey:
        p = self.bfv_params
        b = _relin_b_core(p, self._gaussian_qp(2 * p.rlwe.beta(p.max_level)),
                          sk.data)
        d = _relin_d_core(p, self.gen_bfv_switching_key(sk), r.data)
        v = rlwe_keygen._relin_v_core(p.rlwe,
                                      self.gen_switching_key(r).data,
                                      sk.data)
        return RelinearizationKey(id=sk.id, b=b, d=d, v=v)
