"""Gadget decomposition, external products, the KKLSS multi-key
multiply-relinearize (also as a lazily relinearized sum of products), and
rotation and conjugation (port of mkhe_tpu/mkrlwe/keyswitch.py).

The mult's steps (key selection, aggregation, the tensor terms over any
ring, the relinearization tail `relinearize`) are written once here; the
BFV mult (mkbfv/keyswitch.py) and the party-sharded mult
(parallel/party_mul.py) call them too.

Every per-party loop of the reference is a batched tensor op over a party
axis. Digit and party contractions are sums of products reduced once
(_reduce_qp: csrc/keyswitch.cu's contraction kernel on the card, over
strided and broadcast views in place), and every result is canonical:
the JAX package's lazy intermediates (< 8q) are not unique
representatives, but they only ever feed an inverse NTT or a reduction,
whose canonical outputs agree bit for bit with the ones here.

As in the JAX package, the NTT-domain partial products are summed across
parties before one ModDown (where the reference does a ModDown per party,
keyswitch.go:220-229): algebraically identical up to <= k half-ulp
rounding differences.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from ..ops import basis, basis_cuda
from ..ops.ring import (Ring, coeff_perm, galois_element_conj,
                        galois_element_rot)
from ..utils.profiling import span
from .params import Parameters
from .elements import Ciphertext, HoistedCiphertext, union_ids


# ----------------------------------------------------------------------------
# Decomposition
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def index(sel: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """sel as an int64 index tensor on the device, made once per (sel,
    device) and kept: inside a captured CUDA graph (fuse.py) a tensor
    made from host values would be a host-to-device copy."""
    return torch.tensor(sel, dtype=torch.int64, device=device)


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
    sel = index((*range(level + 1),
                 *range(from_level + 1, from_level + 1 + params.pcount)),
                digits.device)
    return digits[..., :params.beta(level), :, :][..., sel, :]


# ----------------------------------------------------------------------------
# External products
# ----------------------------------------------------------------------------

def _reduce_qp(a, b, nterms: int, ring_qp: Ring) -> torch.Tensor:
    """(sum_t a[t] * b[t]) * 2^-32 mod q over QP, canonical, the sum over
    the first nterms axes of a and b (the rest broadcast): one launch of
    csrc/keyswitch.cu's contraction on a CUDA tensor, the plain version
    on a CPU tensor (basis_cuda.mul_accum)."""
    return basis_cuda.mul_accum(
        a, b, nterms, basis_cuda.limb_tables(ring_qp.moduli, ring_qp.device))


def external_product_ntt(params: Parameters, digits, swk, level: int
                         ) -> torch.Tensor:
    """sum_b digits_b * swk_b, still NTT domain over QP, canonical.
    digits (..., beta, Lqp, N) plain NTT values; swk Montgomery NTT."""
    return _reduce_qp(digits.movedim(-3, 0), swk.movedim(-3, 0), 1,
                      params.ring_qp_at(level))


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
    return _reduce_qp(digits, keys, 1, params.ring_qp_at(level))


def parties_inner(digits) -> torch.Tensor:
    """Digits laid out party axis first, (k, [B,] beta, Lqp, N), as the
    mult has them (the batch of mul_relin_batched_new behind the party
    axis), viewed with the party axis at -4 as _sum_parties_ntt takes it."""
    return digits.movedim(0, -4)


def _sum_parties_ntt(params: Parameters, digits, swks, level: int
                     ) -> torch.Tensor:
    """sum_k sum_b digits[..., k, b] * swks[..., k, b] over QP, NTT
    domain, canonical. digits (..., k, beta, Lqp, N), swks broadcastable.
    One reduction for all k * beta products (the contraction keeps its
    partial sums in range however many there are)."""
    return _reduce_qp(digits.movedim((-4, -3), (0, 1)),
                      swks.movedim((-4, -3), (0, 1)), 2,
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
    return t[index(tuple(sel), t.device)]


def _digits(params: Parameters, h: Optional[HoistedCiphertext], d,
            level: int) -> torch.Tensor:
    """The party polys' digits: hoisted ones sliced to the level, or a
    fresh decomposition of d[1:]."""
    if h is not None:
        return slice_digits(params, h.digits, level)
    with span("ksw.decompose"):
        return decompose(params, d[1:], level)


def _operand_digits(params: Parameters, d0, d1,
                    h0: Optional[HoistedCiphertext],
                    h1: Optional[HoistedCiphertext], level: int):
    """The digits (dec0, dec1) of both operands' party polys, d1 is d0 for
    the square (one decomposition)."""
    if h0 is None and h1 is None and d1 is not d0 and d0.shape == d1.shape:
        # distinct operands: decompose both in one pass (one NTT launch
        # over 2k parties instead of two over k)
        with span("ksw.decompose"):
            both = decompose(params, torch.cat([d0[1:], d1[1:]]), level)
        k0 = d0.shape[0] - 1
        return both[:k0], both[k0:]
    dec0 = _digits(params, h0, d0, level)
    if d1 is d0 and (h1 is None or h1 is h0 or h1.digits is dec0):
        return dec0, dec0
    return dec0, _digits(params, h1, d1, level)


def _relin_keys(params: Parameters, rlk_stacked, ids, ids0, ids1,
                level: int, u_key=None):
    """(d, b, v) keys of the operands' parties and the CRS u (u_key where
    given, else the params' CRS at -1), at the level; the row indices
    1 + sel0 and 1 + sel1 of ids0 and ids1 in the output."""
    b_all, d_all, v_all = rlk_stacked  # each (k_union, beta, Lqp, N)
    sel0 = [ids.index(i) for i in ids0]
    sel1 = [ids.index(i) for i in ids1]
    keys = (slice_swk(params, _rows(d_all, sel0), level),
            slice_swk(params, _rows(b_all, sel1), level),
            slice_swk(params, _rows(v_all, sel0), level),
            params.crs_at(-1, level) if u_key is None else u_key)
    dev = d_all.device
    return (keys, index(tuple(1 + s for s in sel0), dev),
            index(tuple(1 + s for s in sel1), dev))


def _aggregate(params: Parameters, dec0, dec1, d_keys, b_keys, level: int):
    """x = MForm(sum_i d_i . Dec(ct0_i)), y = MForm(sum_i b_i . Dec(ct1_i))
    over QP, NTT domain."""
    with span("ksw.aggregate"):
        return (_aggregate_keys(params, dec0, d_keys, level),
                _aggregate_keys(params, dec1, b_keys, level))


def _tensor_ntt(ring: Ring, d0, d1, ids0, ids1, ids) -> torch.Tensor:
    """The tensor terms of ct0 x ct1 over the ring, from the coefficient
    domain (d1 is d0 for the square: one NTT) into the NTT domain,
    (1 + k, L, N): out_0 = ct0_0 ct1_0, out_j = ct0_0 ct1_j + ct0_j ct1_0
    (basis_cuda.tensor_terms: one kernel launch on the card)."""
    nt0 = ring.ntt(d0)
    nt1 = nt0 if d1 is d0 else ring.ntt(d1)
    return basis_cuda.tensor_terms(
        nt0, nt1, ids0, ids1, ids,
        basis_cuda.limb_tables(ring.moduli, ring.device))


def _external_products(params: Parameters, dec0, dec1, x, y, level: int):
    """z1_j = Ext(ct1_j, x) and t_i = Ext(ct0_i, y), NTT domain over QP."""
    with span("ksw.external_product"):
        return (external_product_ntt(params, dec1, x, level),
                external_product_ntt(params, dec0, y, level))


def relinearize(params: Parameters, out, z1_ntt, t_ntt, v_keys, u_key,
                i0, i1, level: int, psum=None) -> torch.Tensor:
    """The relinearization tail of the KKLSS mult (keyswitch.go:182-229),
    from the NTT-domain products z1 and t of _external_products (or their
    sums over an inner product's pairs), into the coefficient-domain
    tensor terms out (1 + k, Lq, N) over Q, in place; returns out.

      out_j += z1_j                                   j in ids1 (rows i1)
      out_0 += Ext(Dec t_i, v_i) summed over i;  out_i += Ext(Dec t_i, u)
                                                      i in ids0 (rows i0)

    Each pair of ModDowns is one batched iNTT + ModDown (poly-wise, so
    bit-identical to separate ones). psum, where given, sums the v-sum's
    NTT-domain partials over the ranks that hold the other parties
    (parallel/party_mul.py)."""
    ring_q = params.ring_q_at(level)
    k1 = z1_ntt.shape[0]
    with span("ksw.mod_down"):
        zt = mod_down_qp(params, torch.cat([z1_ntt, t_ntt]), level)
        z1, t = zt[:k1], zt[k1:]                   # (k1|k0, Lq, N)
        out[i1] = ring_q.add(out[i1], z1)
    with span("ksw.decompose"):
        dec_t = decompose(params, t, level)        # (k0, beta, Lqp, N)
    with span("ksw.v_sum"):
        v_ntt = _sum_parties_ntt(params, parties_inner(dec_t), v_keys, level)
        if psum is not None:
            v_ntt = psum(v_ntt)
    with span("ksw.external_product"):
        zu_ntt = external_product_ntt(params, dec_t, u_key, level)
    with span("ksw.mod_down"):
        vz = mod_down_qp(params, torch.cat([v_ntt[None], zu_ntt]), level)
        out[0] = ring_q.add(out[0], vz[0])
        out[i0] = ring_q.add(out[i0], vz[1:])
    return out


def mul_and_relin(params: Parameters, ct0: Ciphertext, ct1: Ciphertext,
                  rlk_stacked: Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor],
                  level: int,
                  h0: Optional[HoistedCiphertext] = None,
                  h1: Optional[HoistedCiphertext] = None,
                  square: bool = False,
                  u_key: Optional[torch.Tensor] = None) -> Ciphertext:
    """The KKLSS multi-key multiplication with relinearization
    (keyswitch.go:122-230 / keyswitch_hoisted.go:44-179). The data may
    carry a batch axis behind the party axis, (k+1, B, L, N): every step
    is polynomial-wise or contracts the party axis, so each of the B
    results is bit-identical to its own call, and each NTT launch covers
    B times the polynomials. u_key, the CRS u at the level, replaces
    params.crs_at(-1, level) where given (a sharded caller passes its
    rank's chunk, parallel/coeff_mul.py).

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
    dec0, dec1 = _operand_digits(params, d0, d1, h0, h1, level)
    (d_keys, b_keys, v_keys, u_key), i0, i1 = _relin_keys(
        params, rlk_stacked, ids, ids0, ids1, level, u_key)
    x, y = _aggregate(params, dec0, dec1, d_keys, b_keys, level)
    with span("ksw.tensor"):
        out = ring_q.intt(_tensor_ntt(ring_q, d0, d1, ids0, ids1, ids))
    z1_ntt, t_ntt = _external_products(params, dec0, dec1, x, y, level)
    return Ciphertext(ids=ids, data=relinearize(
        params, out, z1_ntt, t_ntt, v_keys, u_key, i0, i1, level))


def mul_and_relin_sum(params: Parameters, pairs, rlk_stacked, level: int,
                      u_key: Optional[torch.Tensor] = None) -> Ciphertext:
    """sum_i MulAndRelin(a_i, b_i) with the relinearization tail deferred
    across the whole inner product (lazy relinearization,
    mkhe_tpu/mkrlwe/keyswitch.py:317-407).

    pairs: (ct0, ct1, h0, h1) with the same id sets in every pair (h0, h1
    may be None). The tensor terms and the z1 and t products are summed in
    the NTT domain, so the sum costs one iNTT of the tensor sum and one
    relinearize (two batched iNTT + ModDowns, one re-decomposition and
    v/u products), instead of one of each per pair. It decrypts to
    sum_i a_i b_i with one rounding instead of one per pair: it is not
    bit-identical to a sum of mul_and_relin results (of one pair it is).
    u_key as in mul_and_relin.
    """
    ids0, ids1 = pairs[0][0].ids, pairs[0][1].ids
    ids = union_ids(ids0, ids1)
    if any(p[0].ids != ids0 or p[1].ids != ids1 for p in pairs[1:]):
        raise ValueError("mul_and_relin_sum needs identical id sets "
                         "across pairs")
    ring_q = params.ring_q_at(level)
    ring_qp = params.ring_qp_at(level)
    (d_keys, b_keys, v_keys, u_key), i0, i1 = _relin_keys(
        params, rlk_stacked, ids, ids0, ids1, level, u_key)

    out_ntt = z1_qp = t_qp = None   # NTT-domain sums over the pairs
    for ct0, ct1, h0, h1 in pairs:
        d0 = ct0.data[..., :level + 1, :]
        d1 = d0 if ct0.data is ct1.data else ct1.data[..., :level + 1, :]
        dec0, dec1 = _operand_digits(params, d0, d1, h0, h1, level)
        x, y = _aggregate(params, dec0, dec1, d_keys, b_keys, level)
        with span("ksw.tensor"):
            tensor = _tensor_ntt(ring_q, d0, d1, ids0, ids1, ids)
        z1, t = _external_products(params, dec0, dec1, x, y, level)
        if out_ntt is None:
            out_ntt, z1_qp, t_qp = tensor, z1, t
        else:
            out_ntt = ring_q.add(out_ntt, tensor)
            z1_qp = ring_qp.add(z1_qp, z1)
            t_qp = ring_qp.add(t_qp, t)

    with span("ksw.tensor"):
        out = ring_q.intt(out_ntt)
    return Ciphertext(ids=ids, data=relinearize(
        params, out, z1_qp, t_qp, v_keys, u_key, i0, i1, level))


# ----------------------------------------------------------------------------
# Rotate / Conjugate
# ----------------------------------------------------------------------------

def _switch_parties(params: Parameters, c0, dec, swks, a, level: int
                    ) -> torch.Tensor:
    """(c0 + sum_i Ext(dec_i, swk_i), Ext(dec_1, a), ..., Ext(dec_k, a)),
    (..., k+1, Lq, N) coefficient domain, with one batched iNTT + ModDown
    (poly-wise, bit-identical to separate calls). dec (..., k, beta, Lqp,
    N), swks broadcastable to it, a (..., beta, Lqp, N) broadcastable
    against dec's party axis."""
    with span("ksw.v_sum"):
        s_ntt = _sum_parties_ntt(params, dec, swks, level)
    with span("ksw.external_product"):
        ci_ntt = external_product_ntt(params, dec, a, level)
    with span("ksw.mod_down"):
        both = mod_down_qp(params, torch.cat([s_ntt.unsqueeze(-3), ci_ntt],
                                             dim=-3), level)
        c0 = params.ring_q_at(level).add(c0, both[..., 0, :, :])
        return torch.cat([c0.unsqueeze(-3), both[..., 1:, :, :]], dim=-3)


def rotation_steps(params: Parameters, rot_idx: int) -> list:
    """The rotations that make up one by rot_idx slots (mod N/2): itself
    if it has a CRS, else the powers of two of its binary form in
    ascending order (evaluator.go:516-524); none at 0. Raises KeyError
    naming the steps that have no CRS (the JAX package recurses without
    end there)."""
    rot_idx %= params.n // 2
    if rot_idx == 0:
        return []
    if rot_idx in params.crs:
        return [rot_idx]
    steps = [1 << b for b in range(rot_idx.bit_length()) if rot_idx >> b & 1]
    missing = [k for k in steps if k not in params.crs]
    if missing:
        raise KeyError(f"no CRS for rotation {rot_idx} nor for its "
                       f"power-of-two steps {missing}; call add_crs")
    return steps


def rotation_tables(params: Parameters, rot_idx: int):
    """The coefficient-domain Galois map of a rotation by rot_idx slots
    (X -> X^g with sign fold, keyswitch.go:266-296) as (src, sign)
    tensors on the params' device."""
    return coeff_perm(params.logn, galois_element_rot(rot_idx, params.n),
                      params.device)


def rotate_with(params: Parameters, ct: Ciphertext, rtk_stacked, a_crs,
                perm_src, perm_sign,
                h: Optional[HoistedCiphertext] = None) -> Ciphertext:
    """Rotation core, given the rotation keys (k, beta, Lqp, N), the CRS
    and the Galois tables of rotation_tables."""
    level = ct.level
    out = _switch_parties(params, ct.data[0],
                          _digits(params, h, ct.data, level),
                          slice_swk(params, rtk_stacked, level), a_crs,
                          level)
    g = out.index_select(-1, perm_src)
    return Ciphertext(ids=ct.ids, data=torch.where(
        perm_sign, params.ring_q_at(level).neg(g), g))


def rotate(params: Parameters, ct: Ciphertext, rot_idx: int, rtk_stacked,
           h: Optional[HoistedCiphertext] = None) -> Ciphertext:
    """Slot rotation (keyswitch.go:234-298 / RotateHoisted):
      out_0 = ct_0 + sum_i Ext(ct_i, rtk_i);  out_i = Ext(ct_i, a_rot),
    then the coefficient-domain Galois map X -> X^g with sign fold."""
    if rot_idx < 0:
        rot_idx %= params.n // 2
    src, sign = rotation_tables(params, rot_idx)
    return rotate_with(params, ct, rtk_stacked,
                       params.crs_at(rot_idx, ct.level), src, sign, h)


def rotate_hoisted_batched(params: Parameters, ct: Ciphertext,
                           rot_idxs: Sequence[int], rtk_multi,
                           h: HoistedCiphertext) -> torch.Tensor:
    """R rotations of one hoisted ciphertext in one batched pass (the
    reference reuses one decomposition across FC1's rotations,
    cnn/cnn.go:42-71, keyswitch_hoisted.go:183-247). The digits broadcast
    over the R axis; they are not copied R times.

    rtk_multi: (R, k, beta, Lqp, N) rotation keys, one stack per index.
    Returns data (R, k+1, Lq, N), bit-identical to R calls of rotate()."""
    level = ct.level
    dec = slice_digits(params, h.digits, level)          # (k, beta, Lqp, N)
    a_multi = torch.stack([params.crs_at(i, level) for i in rot_idxs])
    tables = [rotation_tables(params, i) for i in rot_idxs]
    src = torch.stack([s for s, _ in tables])            # (R, N)
    sign = torch.stack([g for _, g in tables])
    out = _switch_parties(params, ct.data[0], dec[None],
                          slice_swk(params, rtk_multi, level),
                          a_multi[:, None], level)       # (R, k+1, Lq, N)
    g = torch.gather(out, -1, src[:, None, None, :].expand(out.shape))
    return torch.where(sign[:, None, None, :],
                       params.ring_q_at(level).neg(g), g)


def conjugate(params: Parameters, ct: Ciphertext, cjk_stacked
              ) -> Ciphertext:
    """Conjugation (keyswitch.go:302-332): permute first, then
    key-switch with the conjugation keys and the CRS at -2."""
    level = ct.level
    permuted = params.ring_q_at(level).permute_coeffs(
        ct.data, galois_element_conj(params.n))
    with span("ksw.decompose"):
        dec = decompose(params, permuted[1:], level)
    data = _switch_parties(params, permuted[0], dec,
                           slice_swk(params, cjk_stacked, level),
                           params.crs_at(-2, level), level)
    return Ciphertext(ids=ct.ids, data=data)
