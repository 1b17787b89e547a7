"""Gadget decomposition, external products and the KKLSS multi-key
multiply-relinearize (port of mkhe_tpu/mkrlwe/keyswitch.py:39-314).

Every per-party loop of the reference is a batched tensor op over a party
axis. Digit and party contractions are sums of products reduced once
(ops/modmath.mul_accum), and every result is canonical: the JAX package's
lazy intermediates (< 8q) are not unique representatives, but they only
ever feed an inverse NTT or a reduction, whose canonical outputs agree
bit for bit with the ones here.

As in the JAX package, the NTT-domain partial products are summed across
parties before one ModDown (where the reference does a ModDown per party,
keyswitch.go:220-229): algebraically identical up to <= k half-ulp
rounding differences.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..ops import basis
from ..ops import modmath as mm
from ..ops.ring import Ring
from .params import Parameters
from .elements import Ciphertext, HoistedCiphertext, union_ids


# ----------------------------------------------------------------------------
# Decomposition
# ----------------------------------------------------------------------------

def decompose(params: Parameters, x, level: int) -> torch.Tensor:
    """Gadget-decompose coeff-domain (..., level+1, N) polys into canonical
    NTT-domain digits (..., beta, Lqp, N) (KeySwitcher.Decompose)."""
    return basis.decompose_ntt(x, params.ring_q_at(level),
                               params.ring_qp_at(level), params.alpha)


def slice_swk(params: Parameters, swk, level: int) -> torch.Tensor:
    """Slice a (..., beta_max, Lq+Lp, N) switching key to the level."""
    if level == params.max_level:
        return swk
    return swk[..., :params.beta(level), :, :][
        ..., params.qp_limb_index(level), :]


def slice_digits(params: Parameters, digits, level: int) -> torch.Tensor:
    """Slice hoisted digits (..., beta_h, (lh+1)+Lp, N) computed at a
    higher level lh down to `level`: the first beta(level) digits and the
    level's Q limbs plus the P limbs (digit d only depends on source limbs
    [d*alpha, (d+1)*alpha))."""
    from_level = digits.shape[-2] - params.pcount - 1
    if from_level == level:
        return digits
    sel = torch.cat([
        torch.arange(level + 1),
        torch.arange(from_level + 1, from_level + 1 + params.pcount)]
    ).to(digits.device)
    return digits[..., :params.beta(level), :, :][..., sel, :]


# ----------------------------------------------------------------------------
# External products
# ----------------------------------------------------------------------------

def _accum_digits(digits, swk) -> list:
    """The terms digits[..., b, :, :] * swk[..., b, :, :] of the digit sum
    (to be reduced by _reduce_qp)."""
    return [(digits[..., b, :, :], swk[..., b, :, :])
            for b in range(digits.shape[-3])]


def _reduce_qp(pairs: Sequence, ring_qp: Ring) -> torch.Tensor:
    """(sum a * b) * 2^-32 mod q over QP, canonical."""
    return mm.mul_accum(pairs, ring_qp.q[:, None], ring_qp.r_inv[:, None])


def external_product_ntt(params: Parameters, digits, swk, level: int
                         ) -> torch.Tensor:
    """sum_b digits_b * swk_b, still NTT domain over QP, canonical.
    digits (..., beta, Lqp, N) plain NTT values; swk Montgomery NTT."""
    return _reduce_qp(_accum_digits(digits, swk), params.ring_qp_at(level))


def mod_down_qp(params: Parameters, c_qp, level: int) -> torch.Tensor:
    """InvNTT + divide-and-round by P: (..., Lqp, N) NTT -> (..., Lq, N)
    coeff domain (the tail of ExternalProduct, keyswitch.go:112-117)."""
    lq = level + 1
    c = params.ring_qp_at(level).intt(c_qp)
    return basis.mod_down(c[..., :lq, :], c[..., lq:, :],
                          params.ring_q_at(level), params.ring_p)


def external_product(params: Parameters, digits, swk, level: int
                     ) -> torch.Tensor:
    """digits (NTT) x swk -> coeff-domain (..., Lq, N)."""
    return mod_down_qp(params, external_product_ntt(params, digits, swk,
                                                    level), level)


def _aggregate_keys(params: Parameters, digits, keys, level: int
                    ) -> torch.Tensor:
    """x_b = sum_k digits[k, b] * keys[k, b]: collapse the party axis, keep
    the digit axis (the x/y aggregation of MulAndRelin,
    keyswitch.go:156-180). digits (k, beta, Lqp, N) -> (beta, Lqp, N).
    keys are b/d relinearization keys in DOUBLE-Montgomery form, so the
    one Montgomery reduction leaves the aggregate in Montgomery form."""
    return _reduce_qp([(digits[i], keys[i]) for i in range(digits.shape[0])],
                      params.ring_qp_at(level))


def _sum_parties_ntt(params: Parameters, digits, swks, level: int
                     ) -> torch.Tensor:
    """sum_k sum_b digits[..., k, b] * swks[..., k, b] over QP, NTT
    domain, canonical. digits (..., k, beta, Lqp, N), swks broadcastable.
    One reduction for all k * beta products (mul_accum keeps the int64
    partial sums in range however many there are)."""
    k, beta = digits.shape[-4], digits.shape[-3]
    return _reduce_qp([(digits[..., i, b, :, :], swks[..., i, b, :, :])
                       for i in range(k) for b in range(beta)],
                      params.ring_qp_at(level))


# ----------------------------------------------------------------------------
# Hoisting
# ----------------------------------------------------------------------------

def hoisted_form(params: Parameters, ct: Ciphertext) -> HoistedCiphertext:
    """Gadget decompositions of all party polys (Evaluator.HoistedForm)."""
    return HoistedCiphertext(ids=ct.ids,
                             digits=decompose(params, ct.data[1:], ct.level))


# ----------------------------------------------------------------------------
# MulAndRelin
# ----------------------------------------------------------------------------

def _rows(t, sel):
    """t[sel] along dim 0, without a copy when sel selects every row."""
    if list(sel) == list(range(t.shape[0])):
        return t
    return t[torch.tensor(sel, device=t.device)]


def mul_and_relin(params: Parameters, ct0: Ciphertext, ct1: Ciphertext,
                  rlk_stacked: Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor],
                  level: int,
                  h0: Optional[HoistedCiphertext] = None,
                  h1: Optional[HoistedCiphertext] = None,
                  square: bool = False) -> Ciphertext:
    """The KKLSS multi-key multiplication with relinearization
    (keyswitch.go:122-230 / keyswitch_hoisted.go:44-179):

      x = MForm(sum_i d_i . Dec(ct0_i)),  y = MForm(sum_i b_i . Dec(ct1_i))
      out_0 = ct0_0 * ct1_0
      out_j = ct0_0 * ct1_j + ct0_j * ct1_0          (tensor terms)
      out_j += Ext(ct1_j, x)                          j in ids1
      t_i   = Ext(ct0_i, y)                           i in ids0
      out_0 += Ext(Dec(t_i), v_i);  out_i += Ext(Dec(t_i), u)
    """
    ids0, ids1 = ct0.ids, ct1.ids
    ids = union_ids(ids0, ids1)
    ring_q = params.ring_q_at(level)
    square = square or (ct0.data is ct1.data and ids0 == ids1)

    d0 = ct0.data[..., :level + 1, :]
    d1 = d0 if square else ct1.data[..., :level + 1, :]

    if (h0 is None and h1 is None and not square
            and d0.shape == d1.shape):
        # distinct operands: decompose both in one pass (one NTT launch
        # over 2k parties instead of two over k)
        both = decompose(params, torch.cat([d0[1:], d1[1:]]), level)
        k0 = d0.shape[0] - 1
        dec0, dec1 = both[:k0], both[k0:]
    else:
        dec0 = (slice_digits(params, h0.digits, level) if h0 is not None
                else decompose(params, d0[1:], level))
        if square and (h1 is None or h1 is h0 or h1.digits is dec0):
            dec1 = dec0
        else:
            dec1 = (slice_digits(params, h1.digits, level)
                    if h1 is not None
                    else decompose(params, d1[1:], level))

    b_all, d_all, v_all = rlk_stacked  # each (k_union, beta, Lqp, N)
    sel0 = [ids.index(i) for i in ids0]
    sel1 = [ids.index(i) for i in ids1]
    d_keys = slice_swk(params, _rows(d_all, sel0), level)
    b_keys = slice_swk(params, _rows(b_all, sel1), level)
    v_keys = slice_swk(params, _rows(v_all, sel0), level)
    u_key = params.crs_at(-1, level)

    x = _aggregate_keys(params, dec0, d_keys, level)
    y = _aggregate_keys(params, dec1, b_keys, level)

    # tensor terms (NTT over Q limbs only)
    nt0 = ring_q.ntt(d0)
    nt1 = nt0 if square else ring_q.ntt(d1)
    nt0_0m = ring_q.to_mont(nt0[0])
    nt1_0m = ring_q.to_mont(nt1[0])

    out = [ring_q.mul_mont(nt1[0], nt0_0m)]
    for pid in ids:
        acc = None
        if pid in ids0:
            acc = ring_q.mul_mont(nt0[1 + ids0.index(pid)], nt1_0m)
        if pid in ids1:
            t = ring_q.mul_mont(nt1[1 + ids1.index(pid)], nt0_0m)
            acc = t if acc is None else ring_q.add(acc, t)
        out.append(acc)
    out_arr = ring_q.intt(torch.stack(out))

    # out_j += Ext(ct1_j, x); t_i = Ext(ct0_i, y): one batched
    # iNTT + ModDown for both (poly-wise, so bit-identical).
    z1_ntt = external_product_ntt(params, dec1, x, level)
    t_ntt = external_product_ntt(params, dec0, y, level)
    k1 = len(ids1)
    zt = mod_down_qp(params, torch.cat([z1_ntt, t_ntt]), level)
    z1, t = zt[:k1], zt[k1:]                       # (k1|k0, Lq, N)
    i1 = torch.tensor([1 + s for s in sel1], device=out_arr.device)
    out_arr[i1] = ring_q.add(out_arr[i1], z1)

    # out_0 += Ext(Dec t_i, v_i); out_i += Ext(Dec t_i, u): again one
    # batched iNTT + ModDown for the v-sum and the u products.
    dec_t = decompose(params, t, level)            # (k0, beta, Lqp, N)
    v_ntt = _sum_parties_ntt(params, dec_t, v_keys, level)
    zu_ntt = external_product_ntt(params, dec_t, u_key, level)
    vz = mod_down_qp(params, torch.cat([v_ntt[None], zu_ntt]), level)
    out_arr[0] = ring_q.add(out_arr[0], vz[0])
    i0 = torch.tensor([1 + s for s in sel0], device=out_arr.device)
    out_arr[i0] = ring_q.add(out_arr[i0], vz[1:])

    return Ciphertext(ids=ids, data=out_arr)
