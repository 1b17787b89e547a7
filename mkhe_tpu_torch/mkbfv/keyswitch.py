"""BFV key switching over the double basis (port of
mkhe_tpu/mkbfv/keyswitch.py; the reference's mkbfv/keyswitch.go and
keyswitch_hoisted.go).

The R-basis gadget decomposition gives 2*beta digits of alpha source limbs
each (Q-half digits first, then QMul-half), every digit extended to the 32
QP limbs; the paired switching keys are fused as (2*beta, Lqp, N), so each
external product is one 2*beta-term accumulation. The tensor product runs
in the NTT domain of R and is quantized by t/QMul back to Q
(keyswitch.go:191-228); the relinearization fixups are mkrlwe's
relinearize over QP.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..mkrlwe import keyswitch as ksw
from ..mkrlwe.elements import Ciphertext, union_ids
from ..ops import basis as rns_basis
from ..utils.profiling import span
from .params import Parameters
from . import basis as bfv_basis


@dataclasses.dataclass(frozen=True)
class HoistedCiphertext:
    """Both double-basis forms of a BFV ciphertext and their
    decompositions, for hoisted multiplication (the reference fills these
    once per operand, mkbfv/evaluator.go:118-144, and
    MulAndRelinBFVHoisted consumes them, keyswitch_hoisted.go:39-207).
    lift / dec_lift serve as operand 0 (ModUpQtoR), resc / dec_resc as
    operand 1 (Rescale by QMul/Q), so one hoisted form serves either
    slot."""
    ids: Tuple[str, ...]
    lift: torch.Tensor       # (k+1, 2Lq, N) coefficient domain over R
    resc: torch.Tensor       # (k+1, 2Lq, N) coefficient domain over R
    dec_lift: torch.Tensor   # (k, 2beta, Lqp, N) NTT digits of lift[1:]
    dec_resc: torch.Tensor   # (k, 2beta, Lqp, N) NTT digits of resc[1:]


def decompose_bfv(params: Parameters, x_r) -> torch.Tensor:
    """R-basis coefficient-domain (..., 2Lq, N) -> NTT-domain digits
    (..., 2beta, Lqp, N), alpha source limbs per digit."""
    rp = params.rlwe
    return rns_basis.decompose_ntt(x_r, params.ring_r, rp.ring_qp, rp.alpha)


def hoist(params: Parameters, ct: Ciphertext) -> HoistedCiphertext:
    """Both double-basis forms of ct and their decompositions."""
    with span("ksw.decompose"):
        lift = bfv_basis.mod_up_q_to_r(params, ct.data)
        resc = bfv_basis.rescale_q_to_r(params, ct.data)
        return HoistedCiphertext(ids=ct.ids, lift=lift, resc=resc,
                                 dec_lift=decompose_bfv(params, lift[1:]),
                                 dec_resc=decompose_bfv(params, resc[1:]))


def mul_and_relin_bfv(params: Parameters, ct0r: Ciphertext,
                      ct1r: Ciphertext,
                      rlk_stacked: Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor],
                      dec0: Optional[torch.Tensor] = None,
                      dec1: Optional[torch.Tensor] = None) -> Ciphertext:
    """KKLSS multiplication in the BFV double basis
    (MulAndRelinBFV[Hoisted], keyswitch.go:116-250): ct0r holds lifted
    components (ModUpQtoR), ct1r QMul/Q-rescaled ones; the tensor in R is
    quantized by t/QMul back to Q, and mkrlwe's relinearize runs the
    x/y/v/u fixups over QP as in CKKS, with 2*beta digits for x and y.
    The data may carry a batch axis behind the party axis, (k+1, B, 2Lq,
    N), as in mkrlwe's mul_and_relin."""
    rp = params.rlwe
    level = rp.max_level
    ids0, ids1 = ct0r.ids, ct1r.ids
    ids = union_ids(ids0, ids1)
    if dec0 is None or dec1 is None:
        with span("ksw.decompose"):
            if dec0 is None:
                dec0 = decompose_bfv(params, ct0r.data[1:])
            if dec1 is None:
                dec1 = decompose_bfv(params, ct1r.data[1:])
    (d_keys, b_keys, v_keys, u_key), i0, i1 = ksw._relin_keys(
        rp, rlk_stacked, ids, ids0, ids1, level)
    x, y = ksw._aggregate(rp, dec0, dec1, d_keys, b_keys, level)
    with span("bfv.tensor"):
        tensor = ksw._tensor_ntt(params.ring_r, ct0r.data, ct1r.data, ids0,
                                 ids1, ids)
    out = bfv_basis.quantize(params, tensor)
    z1_ntt, t_ntt = ksw._external_products(rp, dec0, dec1, x, y, level)
    return Ciphertext(ids=ids, data=ksw.relinearize(
        rp, out, z1_ntt, t_ntt, v_keys, u_key, i0, i1, level))
