"""Coefficient-sharded negacyclic NTT over torch.distributed (port of
mkhe_tpu/parallel/dist_ntt.py).

A contiguous split of the N coefficients over C ranks splits the
Cooley-Tukey dataflow cleanly:

  - the first log2(C) butterfly stages pair coefficients j and j + t with
    t >= N/C: a rank's whole chunk is the u side or the v side of its
    block, its partner chunk lives on rank d ^ (t C / N), and the block's
    twiddle is one scalar per (rank, stage, limb). One chunk exchange a
    stage (comm.exchange), then one elementwise pass (_cross_stage);
  - every later stage (t < N/C) is chunk-local, and together they are a
    negacyclic NTT of length N/C whose twiddles are a run of the global
    psi table: rank d's table is psi[:, A + d B] (_local_gather_idx).

So the local stages run on the full NTT kernels (csrc/ntt.cu, the
counterparts of mkhe_tpu/ops/ntt_pallas.py's _fwd_kernel and _inv_kernel)
at logN' = logN - log2(C), given the rank's table in the kernels' packed
layout (ntt_cuda.pack_twiddles). The inverse mirrors the forward: the
local Gentleman-Sande stages (the inverse kernel with N'^-1 replaced by 1),
then log2(C) exchange stages, then the global 1/N. Each butterfly computes
what the unsharded transform computes, so the result is bit-identical to
Ring.ntt / Ring.intt. A CPU tensor takes the kernels' plain versions.

Ring.with_dist(group, C) makes a ring whose ntt / intt run ntt_in_shard on
local chunks; its `dist` is a Dist, which take / concat slice and join
limb-wise like the ring's own tables.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..ops import modmath as mm
from ..ops import ntt_cuda
from . import comm
from .mesh import block, placements

# Dist's tables, all with the limb axis first: the local stages' twiddles
# (natural order, Shoup quotients, the kernels' packed layout), the cross
# stages' scalars (L, log2 C), and 1 with its Shoup quotient, the local
# inverse's N'^-1.
DIST_FIELDS = ("fwd_loc", "fwd_loc_sh", "fwd_pack", "fwd_s", "fwd_s_sh",
               "inv_loc", "inv_loc_sh", "inv_pack", "inv_s", "inv_s_sh",
               "one", "one_sh")


# ----------------------------------------------------------------------------
# Host tables
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _local_gather_idx(chunk: int, C: int):
    """Index maps (A, B) such that rank d's local-stage table is
    tab[:, A + d * B]: position p in the stage run [m, 2m) reads the
    global table at (C + d) m + (p - m) (mkhe_tpu/parallel/dist_ntt.py:
    188-202)."""
    A = np.zeros(chunk, np.int64)
    B = np.zeros(chunk, np.int64)
    m = 1
    while m < chunk:
        A[m:2 * m] = C * m + np.arange(m)
        B[m:2 * m] = m
        m *= 2
    return A, B


def cross_stage(C: int, d: int, k: int, inverse: bool):
    """Cross stage k of rank d of C: (the partner's distance, the index
    of the stage's scalar in the global table, whether d holds the u
    side). Forward stage k: dist C >> (k+1), scalar tab[2^k + (d >>
    (logC - k))]; inverse stage k: dist 2^k, scalar tab[C >> (k+1) + (d
    >> (k+1))] (mkhe_tpu/parallel/dist_ntt.py:69-93)."""
    logc = C.bit_length() - 1
    if inverse:
        dst, idx = 1 << k, (C >> (k + 1)) + (d >> (k + 1))
    else:
        dst, idx = C >> (k + 1), (1 << k) + (d >> (logc - k))
    return dst, idx, (d // dst) % 2 == 0


@functools.lru_cache(maxsize=None)
def _rank_tables(moduli, logn: int, C: int, d: int, device) -> dict:
    """Rank d's DIST_FIELDS tables for the ring over `moduli`, on the
    device (made once per rank and ring)."""
    from ..ops.ring import _host_tables

    host = _host_tables(moduli, logn)
    chunk = (1 << logn) // C
    A, B = _local_gather_idx(chunk, C)
    idx = A + d * B
    out = {}
    for name, fwd in (("fwd", True), ("inv", False)):
        tab, tab_sh = ((host["psi"], host["psi_sh"]) if fwd
                       else (host["ipsi"], host["ipsi_sh"]))
        loc, loc_sh = tab[:, idx], tab_sh[:, idx]
        out[name + "_loc"], out[name + "_loc_sh"] = loc, loc_sh
        out[name + "_pack"] = ntt_cuda.pack_twiddles(loc, loc_sh, moduli,
                                                     fwd)
        cols = [cross_stage(C, d, k, not fwd)[1]
                for k in range(C.bit_length() - 1)]
        out[name + "_s"] = tab[:, cols].reshape(len(moduli), -1)
        out[name + "_s_sh"] = tab_sh[:, cols].reshape(len(moduli), -1)
    out["one"] = np.ones(len(moduli), np.int64)
    out["one_sh"] = np.array([mm.shoup_host(1, q) for q in moduli],
                             np.int64)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in out.items()}


# ----------------------------------------------------------------------------
# The dist setting of a ring
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Dist:
    """A ring's coefficient sharding: the process group, its size C, this
    rank's index d in it, and the rank's tables (DIST_FIELDS, limb axis
    first)."""
    group: Any
    size: int
    rank: int
    fwd_loc: torch.Tensor
    fwd_loc_sh: torch.Tensor
    fwd_pack: torch.Tensor
    fwd_s: torch.Tensor
    fwd_s_sh: torch.Tensor
    inv_loc: torch.Tensor
    inv_loc_sh: torch.Tensor
    inv_pack: torch.Tensor
    inv_s: torch.Tensor
    inv_s_sh: torch.Tensor
    one: torch.Tensor
    one_sh: torch.Tensor

    @staticmethod
    def create(ring, group, n_shards: int) -> "Dist":
        size = dist.get_world_size(group)
        if n_shards != size:
            raise ValueError(f"{n_shards} shards over a group of {size}")
        if size & (size - 1) or not 2 <= ring.n // size:
            raise ValueError(f"C = {size}: the sharded NTT takes a power "
                             f"of two with chunks of 2 or more coefficients")
        rank = dist.get_rank(group)
        return Dist(group=group, size=size, rank=rank, **_rank_tables(
            ring.moduli, ring.logn, size, rank, ring.device))

    def take(self, lo: int, hi: int) -> "Dist":
        return dataclasses.replace(
            self, **{k: getattr(self, k)[lo:hi] for k in DIST_FIELDS})

    def concat(self, other: "Dist") -> "Dist":
        if other.group is not self.group or other.rank != self.rank:
            raise ValueError("rings sharded over different groups")
        return dataclasses.replace(self, **{
            k: torch.cat([getattr(self, k), getattr(other, k)])
            for k in DIST_FIELDS})


# ----------------------------------------------------------------------------
# The sharded transform of a local chunk
# ----------------------------------------------------------------------------

def _cross_stage(a, recv, s, s_sh, is_u: bool, q, inverse: bool):
    """One cross-rank butterfly stage on this rank's half: a is the own
    chunk (..., L, c), recv the partner's; s, s_sh (L,) the stage's
    scalar. The u side keeps u + v s (forward) or u + v (inverse), the v
    side u - v s or (u - v) s (mkhe_tpu/parallel/dist_ntt.py:162-180)."""
    qq = q[:, None]
    u, v = (a, recv) if is_u else (recv, a)
    if inverse:
        if is_u:
            return mm.add_mod(u, v, qq)
        return mm.shoup_mul(mm.sub_mod(u, v, qq), s[:, None], s_sh[:, None],
                            qq)
    vs = mm.shoup_mul(v, s[:, None], s_sh[:, None], qq)
    return mm.add_mod(u, vs, qq) if is_u else mm.sub_mod(u, vs, qq)


def _cross(ring, a, k: int, inverse: bool):
    d = ring.dist
    dst, _, is_u = cross_stage(d.size, d.rank, k, inverse)
    recv = comm.exchange(a, d.rank ^ dst, d.group)
    s, s_sh = (d.inv_s, d.inv_s_sh) if inverse else (d.fwd_s, d.fwd_s_sh)
    return _cross_stage(a, recv, s[:, k], s_sh[:, k], is_u, ring.q, inverse)


def ntt_in_shard(ring, a: torch.Tensor, inverse: bool = False
                 ) -> torch.Tensor:
    """NTT / iNTT of this rank's chunk (..., L, N/C) under ring.dist:
    any u32 input, canonical output, equal to the matching chunk of
    Ring.ntt / Ring.intt of the whole. Every rank of the group calls it
    together."""
    d = ring.dist
    if a.shape[-1] != ring.n // d.size or a.shape[-2] != ring.nlimbs:
        raise ValueError(f"local chunk {tuple(a.shape)}: want (..., "
                         f"{ring.nlimbs}, {ring.n // d.size})")
    logc = d.size.bit_length() - 1
    if inverse:
        a = ntt_cuda.intt(a, ring.q, ring.bar, d.inv_loc, d.inv_loc_sh,
                          d.one, d.one_sh, d.inv_pack)
        for k in range(logc):
            a = _cross(ring, a, k, True)
        return mm.shoup_mul(a, ring.ninv[:, None], ring.ninv_sh[:, None],
                            ring.q[:, None])
    a = ring.reduce(a)
    for k in range(logc):
        a = _cross(ring, a, k, False)
    return ntt_cuda.ntt(a.contiguous(), ring.q, ring.bar, d.fwd_loc,
                        d.fwd_loc_sh, d.fwd_pack)


def ntt_sharded(ring, x: torch.Tensor, mesh, axis: str = "coeff",
                inverse: bool = False, limb_axis=None) -> torch.Tensor:
    """NTT / iNTT of the full (..., L, N) x, the same on every rank, with
    the coefficient axis split over the mesh dimension `axis` (and the
    limb axis over `limb_axis`): every rank takes its block, transforms
    it, and returns its block of ring.ntt(x) / ring.intt(x)."""
    dims = {axis: -1} if limb_axis is None else {axis: -1, limb_axis: -2}
    local = block(x, mesh, placements(mesh, **dims))
    lo = 0
    if limb_axis is not None:
        lo = mesh.get_local_rank(limb_axis) * local.shape[-2]
    group = mesh.get_group(axis)
    ring_d = ring.take(lo, lo + local.shape[-2]).with_dist(
        group, dist.get_world_size(group))
    return ring_d.intt(local) if inverse else ring_d.ntt(local)
