"""Party-sharded multi-key multiplication and rotation (port of
mkhe_tpu/parallel/party_mul.py).

The KKLSS ciphertext grows with the party count, and every per-party term
of MulAndRelin (keyswitch.go:122-230) and Rotate (keyswitch.go:234-298)
is independent until the sums into x, y and c0. So the parties are split
over the ranks of a mesh dimension:

  rank d holds parties P_d: their digits and their relin / rotation keys
  x = sum_d( sum_{k in P_d} d_k . dec_k )     (comm.all_reduce_sum, mod q)
  y likewise; the c0 tensor term on every rank; party outputs local;
  out_0 = tensor_00 + ModDown( sum_d sum_{k in P_d} Dec(t_k) . v_k ).

Each rank's partial sum is canonical (the port reduces every contraction
once, keyswitch._reduce_qp), the sum over C ranks stays far below 2^63,
and one `% q` makes it canonical again: equal to the single-rank
contraction mod q, so the outputs equal ksw.mul_and_relin's and
ksw.rotate's bit for bit. The party outputs are gathered at the end, and
every rank returns the whole ciphertext.

Covers the reference's shapes: distinct operands (id sets unioned by
zero-padding, elements.go:91-105), hoisted operands
(keyswitch_hoisted.go:44-179), the square, and RotateHoisted
(keyswitch_hoisted.go:183-247).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..mkrlwe import keyswitch as ksw
from ..mkrlwe.elements import (Ciphertext, HoistedCiphertext, pad_ciphertext,
                               union_ids)
from ..mkrlwe.params import Parameters
from . import comm
from .mesh import block, placements


def party_block(x: torch.Tensor, mesh, axis: str = "party") -> torch.Tensor:
    """This rank's block of the party axis (axis 0) of x: its parties'
    stacked keys or hoisted digits."""
    return block(x, mesh, placements(mesh, **{axis: 0}))


def _psum(rp: Parameters, x, level: int, group) -> torch.Tensor:
    """The sum over the group of canonical QP partials, canonical."""
    return comm.all_reduce_sum(x, group) % rp.ring_qp_at(level).q[:, None]


def _check_parties(k: int, group_size: int, key_rows: int) -> int:
    if k % group_size:
        raise ValueError(f"{k} parties do not split over {group_size} "
                         f"ranks")
    if key_rows != k // group_size:
        raise ValueError(f"keys for {key_rows} parties, the rank holds "
                         f"{k // group_size}")
    return k // group_size


def mul_and_relin_party_sharded(
        rp: Parameters, ct0: Ciphertext, rlk_block, mesh,
        axis: str = "party", ct1: Optional[Ciphertext] = None,
        h0: Optional[HoistedCiphertext] = None,
        h1: Optional[HoistedCiphertext] = None) -> Ciphertext:
    """KKLSS mult + relin with the party axis split over the mesh
    dimension `axis` (MulAndRelin[Hoisted], keyswitch.go:122-230 /
    keyswitch_hoisted.go:44-179). ct0 and ct1 are whole on every rank; ct1
    omitted (or ct0 itself) is the square, with one decomposition; ct1 may
    carry another id set (both are zero-padded to the union, and hoisted
    digits, indexed by operand, are dropped across a pad). rlk_block is
    the rank's block (party_block) of the union's stacked (b, d, v); h0 /
    h1, where given, hold the rank's block of the operands' digits. The
    union's party count must divide the dimension. Every rank of the
    dimension calls it together, and each returns the whole product,
    equal to ksw.mul_and_relin's."""
    level = ct0.level
    square = ct1 is None or (ct1.data is ct0.data and ct1.ids == ct0.ids)
    if square:
        ct1 = ct0
    ids = union_ids(ct0.ids, ct1.ids)
    if ids != ct0.ids or ids != ct1.ids:
        ct0, ct1 = pad_ciphertext(ct0, ids), pad_ciphertext(ct1, ids)
        h0 = h1 = None
    group = mesh.get_group(axis)
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    k_loc = _check_parties(len(ids), size, rlk_block[0].shape[0])
    lo = mesh.get_local_rank(axis) * k_loc
    # the rank's share: c0 and its parties' polys, keys and digits
    rows = (0, *range(1 + lo, 1 + lo + k_loc))
    d0 = ksw._rows(ct0.data[..., :level + 1, :], rows)
    d1 = d0 if square else ksw._rows(ct1.data[..., :level + 1, :], rows)
    loc = tuple(range(k_loc))
    ring_q = rp.ring_q_at(level)

    def psum(x):
        return _psum(rp, x, level, group)

    dec0, dec1 = ksw._operand_digits(rp, d0, d1, h0, h1, level)
    (d_keys, b_keys, v_keys, u_key), i0, i1 = ksw._relin_keys(
        rp, rlk_block, loc, loc, loc, level)
    x = psum(ksw._aggregate_keys(rp, dec0, d_keys, level))
    y = psum(ksw._aggregate_keys(rp, dec1, b_keys, level))
    out = ring_q.intt(ksw._tensor_ntt(ring_q, d0, d1, loc, loc, loc))
    z1_ntt, t_ntt = ksw._external_products(rp, dec0, dec1, x, y, level)
    out = ksw.relinearize(rp, out, z1_ntt, t_ntt, v_keys, u_key, i0, i1,
                          level, psum=psum)
    data = torch.cat([out[:1], comm.all_gather_cat(out[1:], group)])
    return Ciphertext(ids=ids, data=data)


def rotate_party_sharded(rp: Parameters, ct: Ciphertext, rot_idx: int,
                         rtk_block: torch.Tensor, mesh,
                         axis: str = "party",
                         h: Optional[HoistedCiphertext] = None
                         ) -> Ciphertext:
    """Slot rotation with the party axis split over the mesh dimension
    `axis` (Rotate, keyswitch.go:234-298 / RotateHoisted,
    keyswitch_hoisted.go:183-247):
      out_0 = ct_0 + ModDown( sum_d sum_{k in P_d} Dec(ct_k) . rtk_k )
      out_k = Ext(ct_k, a_rot)                           (local)
    then the Galois coefficient map with its sign fold. ct is whole on
    every rank, rtk_block the rank's block (party_block) of the rotation
    keys (k, beta, Lqp, N), h the rank's block of the hoisted digits. Every
    rank returns the whole result, equal to ksw.rotate's."""
    level = ct.level
    group = mesh.get_group(axis)
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    k_loc = _check_parties(len(ct.ids), size, rtk_block.shape[0])
    lo = mesh.get_local_rank(axis) * k_loc
    rot_idx %= rp.n // 2
    ring_q = rp.ring_q_at(level)
    parties = ct.data[1 + lo:1 + lo + k_loc]
    dec = (ksw.slice_digits(rp, h.digits, level) if h is not None
           else ksw.decompose(rp, parties, level))
    s_sum = _psum(rp, ksw._sum_parties_ntt(
        rp, dec, ksw.slice_swk(rp, rtk_block, level), level), level, group)
    c0 = ring_q.add(ct.data[0], ksw.mod_down_qp(rp, s_sum, level))
    ci = ksw.external_product(rp, dec, rp.crs_at(rot_idx, level), level)
    out = torch.cat([c0[None], comm.all_gather_cat(ci, group)])
    src, sign = ksw.rotation_tables(rp, rot_idx)
    g = out.index_select(-1, src)
    return Ciphertext(ids=ct.ids, data=torch.where(sign, ring_q.neg(g), g))
