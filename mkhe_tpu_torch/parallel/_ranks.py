"""Rank bodies of the parallel tier, and the launcher that spawns them.

`run(tasks, world, backend, device)` writes the tasks' inputs to a
temporary directory, starts `world` ranks with torch.multiprocessing
(spawn), each of which joins one process group (a FileStore in that
directory) and runs every task in order, and returns each rank's results.
The tests and chip_smoke.py spawn their ranks through it, so that a child
imports this package and nothing of a test module (nor, through it, JAX).

A task is (name, inputs): a dict of plain values, numpy arrays and CPU
tensors. The rank loads the inputs memory-mapped, cuts its own block
before it moves anything to its device, and returns CPU tensors:

  ntt         ntt_sharded of x on a (rns, coeff) mesh; -> this rank's block
  coeff_mul   coeff_mul.mul_and_relin_sharded; -> this rank's chunk
  party_mul   party_mul.mul_and_relin_party_sharded; -> the product
  party_rot   party_mul.rotate_party_sharded; -> the rotated ciphertext

Besides, each rank reports each task's NTT kernel launches (the counters
set to 0 before the task) and seconds, its peak device memory, the
transport, and the modules of JAX or the JAX package that it loaded (none, or the test
fails). A rank on "cuda" takes card rank % device_count(): on a machine
with one card every rank shares it, over gloo (NCCL refuses two ranks on
one card).
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .. import convert
from ..mkrlwe.elements import Ciphertext, HoistedCiphertext
from ..ops import ntt_cuda
from ..ops.ring import Ring
from . import coeff_mul, comm, dist_ntt, mesh as pmesh, party_mul


def run(tasks, world: int, backend: str = "gloo", device: str = "cpu",
        timeout: float = 600.0) -> list:
    """Run `tasks` on `world` spawned ranks; returns each rank's output
    dict ({"results", "launches", "seconds": one entry a task;
    "peak_gib", "transport", "foreign_modules"}), in rank order. Raises on a rank's
    failure or on the timeout, after stopping every rank."""
    with tempfile.TemporaryDirectory(prefix="mkhe_ranks_") as tmp:
        torch.save(list(tasks), os.path.join(tmp, "tasks.pt"))
        ctx = mp.start_processes(_rank_main, args=(world, backend, device,
                                                   tmp),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks still running after "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(10)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def _rank_main(rank: int, world: int, backend: str, device: str,
               tmp: str) -> None:
    torch.set_num_threads(1)
    if device == "cuda":   # one card a rank where there are enough
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        tasks = torch.load(os.path.join(tmp, "tasks.pt"), mmap=True,
                           weights_only=False)
        ctx = _Context(rank, device)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        results, seconds, launches = [], [], []
        for name, inputs in tasks:
            ntt_cuda.reset_counters()
            t0 = time.perf_counter()
            results.append(TASKS[name](ctx, **inputs))
            if device == "cuda":
                torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            launches.append(ntt_cuda.counters())
        out = dict(
            results=results, launches=launches, seconds=seconds,
            transport=comm.transport(None),
            peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                      if device == "cuda" else 0.0),
            foreign_modules=sorted(
                m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "mkhe_tpu")))
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


class _Context:
    """A rank's device and its meshes, made once per (shape, names) in the
    same order on every rank."""

    def __init__(self, rank: int, device: str):
        self.rank, self.device, self.meshes = rank, device, {}

    def mesh(self, shape, names):
        key = (tuple(shape), tuple(names))
        if key not in self.meshes:
            self.meshes[key] = pmesh.mesh_of(shape, names)
        return self.meshes[key]

    def to(self, x):
        return None if x is None else x.contiguous().to(self.device)


def _params(ctx: _Context, p: dict):
    """mkrlwe Parameters from a task's (logn, q, p, gamma, sigma, crs)."""
    return convert.rlwe_parameters(p["logn"], p["q"], p["p"], p["gamma"],
                                   p["sigma"], p["crs"], device=ctx.device)


def _ct(ctx: _Context, ct):
    return None if ct is None else Ciphertext(ids=tuple(ct[0]),
                                              data=ctx.to(ct[1]))


def _task_ntt(ctx, moduli, logn, x, rns, coeff, inverse, limb_axis):
    m = ctx.mesh((rns, coeff), ("rns", "coeff"))
    ring = Ring.create(moduli, logn, ctx.device)
    return dist_ntt.ntt_sharded(ring, ctx.to(x), m, inverse=inverse,
                                limb_axis="rns" if limb_axis else None
                                ).cpu()


def _task_coeff_mul(ctx, params, ct0, ct1, rlk, level, rns, coeff):
    m = ctx.mesh((rns, coeff), ("rns", "coeff"))
    rp = _params(ctx, params)
    cut = lambda x: ctx.to(coeff_mul.chunk(x, m))
    c0 = Ciphertext(ids=tuple(ct0[0]), data=cut(ct0[1]))
    c1 = Ciphertext(ids=tuple(ct1[0]), data=cut(ct1[1]))
    out = coeff_mul.mul_and_relin_sharded(rp, c0, c1,
                                          tuple(cut(a) for a in rlk),
                                          level, m)
    return out.ids, out.data.cpu()


def _party_mesh(ctx, parties: int):
    world = dist.get_world_size()
    return ctx.mesh((world // parties, parties), ("replica", "party"))


def _hoisted(ctx, m, h):
    return None if h is None else HoistedCiphertext(
        ids=tuple(h[0]), digits=ctx.to(party_mul.party_block(h[1], m)))


def _task_party_mul(ctx, params, ct0, ct1, rlk, h0, h1, parties):
    m = _party_mesh(ctx, parties)
    rp = _params(ctx, params)
    keys = tuple(ctx.to(party_mul.party_block(a, m)) for a in rlk)
    out = party_mul.mul_and_relin_party_sharded(
        rp, _ct(ctx, ct0), keys, m, ct1=_ct(ctx, ct1),
        h0=_hoisted(ctx, m, h0), h1=_hoisted(ctx, m, h1))
    return out.ids, out.data.cpu()


def _task_party_rot(ctx, params, ct, rot, rtk, h, parties):
    m = _party_mesh(ctx, parties)
    rp = _params(ctx, params)
    out = party_mul.rotate_party_sharded(
        rp, _ct(ctx, ct), rot, ctx.to(party_mul.party_block(rtk, m)), m,
        h=_hoisted(ctx, m, h))
    return out.ids, out.data.cpu()


def _task_mesh(ctx, ct, key, stacked):
    """The placement helpers on make_mesh(world, rns=2), for the tests."""
    from .. import mkckks
    from ..mkrlwe.params import build_parameters
    from ..ops.primes import ntt_primes

    m = pmesh.make_mesh(dist.get_world_size(), rns=2)
    rct = Ciphertext(ids=("a", "b"), data=ct)
    logn = key.shape[-1].bit_length() - 1
    rp = build_parameters(logn, ntt_primes(logn, 20, 4),
                          ntt_primes(logn, 20, 2, skip=4), 1, 3.2, 0,
                          "cpu", crs={0: key})
    return dict(
        coords=m.get_coordinate(), names=m.mesh_dim_names,
        ct_placements=str(pmesh.ciphertext_sharding(m)),
        stacked_placements=str(pmesh.stacked_key_sharding(m)),
        ct=pmesh.shard_ciphertext(rct, m).data,
        ckks_ct=pmesh.shard_ciphertext(
            mkckks.Ciphertext(ct=rct, scale=1.0), m).ct.data,
        stacked=pmesh.shard_rlk_stacked((stacked, stacked), m),
        crs=pmesh.shard_params(rp, m).crs[0])


def _task_dist_rings(ctx, params, level):
    """The dist setting through every sub-ring of Parameters.with_dist,
    made from parameters that had memoised their sub-rings, for the
    tests."""
    rp = _params(ctx, params)
    rp.ring_q_at(level), rp.ring_qp_at(level)
    memo_before = len(rp._rings)
    world = dist.get_world_size()
    group = ctx.mesh((1, world), ("rns", "coeff")).get_group("coeff")
    pd = rp.with_dist(group, world)
    subs = [pd.ring_q, pd.ring_p, pd.ring_qp, pd.ring_q_at(level),
            pd.ring_qp_at(level), pd.ring_q_at(0), pd.ring_qp_at(0),
            pd.ring_q.take(1, 2), pd.ring_q_at(0).concat(pd.ring_p)]
    c = rp.n // world
    all_dist = all(
        r.dist is not None and r.dist.group is group and r.dist.size == world
        and tuple(r.dist.fwd_loc.shape) == (r.nlimbs, c) for r in subs)
    fresh = dist_ntt.Dist.create(Ring.create(pd.ring_qp_at(0).moduli,
                                             rp.logn, ctx.device),
                                 group, world)
    tables = all(torch.equal(getattr(pd.ring_qp_at(0).dist, f),
                             getattr(fresh, f))
                 for f in dist_ntt.DIST_FIELDS)
    gen = torch.Generator().manual_seed(11)
    ring, full = pd.ring_qp_at(0), rp.ring_qp_at(0)
    x = torch.randint(0, 1 << 32, (2, ring.nlimbs, rp.n), generator=gen)
    lo = dist.get_rank(group) * c
    ntt_eq = torch.equal(ring.ntt(x[..., lo:lo + c]),
                         full.ntt(x)[..., lo:lo + c])
    intt_eq = torch.equal(ring.intt(x[..., lo:lo + c]),
                          full.intt(x)[..., lo:lo + c])
    try:
        pd.ring_q.concat(rp.ring_p)
        mixed = False
    except ValueError:
        mixed = True
    return dict(memo_before=memo_before, all_dist=all_dist,
                ntt_equal=ntt_eq, intt_equal=intt_eq,
                take_concat_tables=tables, concat_mixed_raises=mixed,
                local_again=pd.ring_q.with_dist(None).dist is None)


TASKS = {"ntt": _task_ntt, "coeff_mul": _task_coeff_mul,
         "party_mul": _task_party_mul, "party_rot": _task_party_rot,
         "mesh": _task_mesh, "dist_rings": _task_dist_rings}
