"""BFV key switching over the double basis (port of
mkhe_tpu/mkbfv/keyswitch.py; the reference's mkbfv/keyswitch.go and
keyswitch_hoisted.go).

The R-basis gadget decomposition gives 2*beta digits of alpha source limbs
each (Q-half digits first, then QMul-half), every digit extended to the 32
QP limbs; the paired switching keys are fused as (2*beta, Lqp, N), so each
external product is one 2*beta-term accumulation. The tensor product runs
in the NTT domain of R and is quantized by t/QMul back to Q
(keyswitch.go:191-228); the relinearization fixups reuse mkrlwe's
key-switching steps over QP.
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
    quantized by t/QMul back to Q, and the x/y/v/u relinearization fixups
    run over QP as in CKKS, with 2*beta digits for x and y. The data may
    carry a batch axis behind the party axis, (k+1, B, 2Lq, N), as in
    mkrlwe's mul_and_relin."""
    rp = params.rlwe
    level = rp.max_level
    ring_q, ring_r = rp.ring_q, params.ring_r
    ids0, ids1 = ct0r.ids, ct1r.ids
    ids = union_ids(ids0, ids1)

    if dec0 is None or dec1 is None:
        with span("ksw.decompose"):
            if dec0 is None:
                dec0 = decompose_bfv(params, ct0r.data[1:])
            if dec1 is None:
                dec1 = decompose_bfv(params, ct1r.data[1:])

    b_all, d_all, v_all = rlk_stacked
    sel0 = [ids.index(i) for i in ids0]
    sel1 = [ids.index(i) for i in ids1]
    d_keys = ksw._rows(d_all, sel0)
    b_keys = ksw._rows(b_all, sel1)
    v_keys = ksw._rows(v_all, sel0)
    u_key = rp.crs_at(-1, level)

    with span("ksw.aggregate"):
        x = ksw._aggregate_keys(rp, dec0, d_keys, level)
        y = ksw._aggregate_keys(rp, dec1, b_keys, level)

    # tensor in R (NTT domain), then quantize every component by t/QMul
    with span("bfv.tensor"):
        nt0 = ring_r.ntt(ct0r.data)
        nt1 = ring_r.ntt(ct1r.data)
        nt0_0m = ring_r.to_mont(nt0[0])
        nt1_0m = ring_r.to_mont(nt1[0])
        tensor = [ring_r.mul_mont(nt1[0], nt0_0m)]
        for pid in ids:
            acc = None
            if pid in ids0:
                acc = ring_r.mul_mont(nt0[1 + ids0.index(pid)], nt1_0m)
            if pid in ids1:
                term = ring_r.mul_mont(nt1[1 + ids1.index(pid)], nt0_0m)
                acc = term if acc is None else ring_r.add(acc, term)
            tensor.append(acc)
    out = bfv_basis.quantize(params, torch.stack(tensor))

    # out_j += Ext(ct1r_j, x); t_i = Ext(ct0r_i, y): one batched iNTT +
    # ModDown for both (poly-wise, so bit-identical)
    with span("ksw.external_product"):
        z1_ntt = ksw.external_product_ntt(rp, dec1, x, level)
        t_ntt = ksw.external_product_ntt(rp, dec0, y, level)
    k1 = len(ids1)
    with span("ksw.mod_down"):
        zt = ksw.mod_down_qp(rp, torch.cat([z1_ntt, t_ntt]), level)
        z1, t = zt[:k1], zt[k1:]
        i1 = ksw.index(tuple(1 + s for s in sel1), out.device)
        out[i1] = ring_q.add(out[i1], z1)

    # Q-basis fixups with v_i and u, again one batched ModDown
    with span("ksw.decompose"):
        dec_t = ksw.decompose(rp, t, level)
    with span("ksw.v_sum"):
        v_ntt = ksw._sum_parties_ntt(rp, ksw.parties_inner(dec_t), v_keys,
                                     level)
    with span("ksw.external_product"):
        zu_ntt = ksw.external_product_ntt(rp, dec_t, u_key, level)
    with span("ksw.mod_down"):
        vz = ksw.mod_down_qp(rp, torch.cat([v_ntt[None], zu_ntt]), level)
        out[0] = ring_q.add(out[0], vz[0])
        i0 = ksw.index(tuple(1 + s for s in sel0), out.device)
        out[i0] = ring_q.add(out[i0], vz[1:])
    return Ciphertext(ids=ids, data=out)
