"""BFV double-basis conversions (port of mkhe_tpu/mkbfv/basis.py):

  mod_up_q_to_r: lift x mod Q into basis R = Q ++ QMul (value x + small*Q).
  rescale_q_to_r: w in basis R with w = -(y*QMul mod Q) * Q^-1 mod QMul,
    i.e. w ~ y*QMul/Q; with the lift of the other operand and the final
    t/QMul quantization this is the BFV cross-basis multiplication.
  quantize: round(t * x / QMul): tensor results in R (NTT domain) back
    down to Q.

Each converts 28 limbs into 28 at PN15QP880 (ops/basis.mod_up at Ls = 28).
"""

from __future__ import annotations

import functools

import torch

from ..ops import basis
from ..ops import modmath as mm
from ..utils.profiling import span
from .params import Parameters


@functools.lru_cache(maxsize=None)
def _consts(q_moduli, qmul_moduli, t: int, device):
    """(QMul mod q_j, Q^-1 mod p_j, t mod r_k), each in Montgomery form."""
    Q = QMul = 1
    for q in q_moduli:
        Q *= q
    for p in qmul_moduli:
        QMul *= p
    vec = lambda xs: torch.tensor(xs, dtype=torch.int64, device=device)
    return (vec([mm.to_mont_host(QMul % q, q) for q in q_moduli]),
            vec([mm.to_mont_host(pow(Q % p, -1, p), p) for p in qmul_moduli]),
            vec([mm.to_mont_host(t % r, r)
                 for r in (*q_moduli, *qmul_moduli)]))


def _c(params: Parameters):
    return _consts(params.ring_q.moduli, params.qmul_moduli, params.t,
                   params.device)


def _tables(src, dst):
    return basis.mod_up_tables(src.moduli, dst.moduli, dst.device)


def mod_up_q_to_r(params: Parameters, x) -> torch.Tensor:
    """(..., Lq, N) mod Q -> (..., 2Lq, N) mod R, coefficient domain
    (FastBasisExtender.ModUpQtoR, mkbfv/basis_extension.go:49-63)."""
    with span("bfv.lift"):
        rq, rqm = params.ring_q, params.ring_qmul
        return torch.cat([x, basis.mod_up(x, rq, rqm, _tables(rq, rqm))],
                         dim=-2)


def rescale_q_to_r(params: Parameters, y) -> torch.Tensor:
    """(..., Lq, N) mod Q -> (..., 2Lq, N) mod R holding
    w = -(y*QMul mod Q) * Q^-1 mod QMul, extended to R
    (FastBasisExtender.Rescale, mkbfv/basis_extension.go:83-97)."""
    with span("bfv.rescale_qr"):
        rq, rqm = params.ring_q, params.ring_qmul
        qmul_mod_q, qinv_mod_qmul, _ = _c(params)
        a = rq.mul_scalar_mont(y, qmul_mod_q)                 # y*QMul mod Q
        conv = basis.mod_up(a, rq, rqm, _tables(rq, rqm))     # a mod QMul
        w = rqm.mul_scalar_mont(rqm.neg(conv), qinv_mod_qmul)
        w_q = basis.mod_up(w, rqm, rq, _tables(rqm, rq))      # w mod Q
        return torch.cat([w_q, w], dim=-2)


def quantize(params: Parameters, x_r_ntt) -> torch.Tensor:
    """NTT-domain (..., 2Lq, N) over R -> coefficient-domain (..., Lq, N)
    over Q: round(t * x / QMul) (FastBasisExtender.Quantize,
    mkbfv/basis_extension.go:66-80)."""
    with span("bfv.quantize"):
        ring_r = params.ring_r
        tx = ring_r.intt(ring_r.mul_scalar_mont(x_r_ntt, _c(params)[2]))
        lq = params.ring_q.nlimbs
        return basis.mod_down(tx[..., :lq, :], tx[..., lq:, :],
                              params.ring_q, params.ring_qmul)
