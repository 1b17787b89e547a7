"""The NTT cost probe's transform in the port (mkhe_tpu_torch/ops/ntt_cuda.py
ntt_variant / ntt_variant_plain, mkhe_tpu_torch.ntt_probe) against the JAX
package's benchmarks/ntt_probe.py::_variant_kernel, run as a Pallas call in
interpret mode, bit for bit:

  - every setting of the probe (all stages, 8 or logN - 2, 1, no twiddle
    multiplies, no exchange) at logN 8 and 10, in both grid orders, on
    any-u32 input;
  - every stage == Ring.ntt, logN - 7 stages == the split head;
  - a numpy emulation of csrc/ntt_variant.cu's schedule (passes, register
    layout, twiddle addresses, lazy arithmetic, warp-staged stores, block
    order) against the plain version for every setting the kernel is
    built for, at logN 10, 14 and 15;
  - the block order, the route, the wrapper's checks, the bound and the
    entry point's CPU dry run."""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from benchmarks import ntt_probe as jprobe
from mkhe_tpu.ops import ring as jring
from mkhe_tpu.ops.primes import ntt_primes
from mkhe_tpu_torch import ntt_probe, profile_ntt
from mkhe_tpu_torch.ops import ntt_cuda
from mkhe_tpu_torch.ops import ring as tring

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = jprobe.LIMB_TILE
LIMBS = 8
BATCH = 2
M32 = np.uint64(0xFFFFFFFF)


def _settings(logn):
    """(stages, exchange, mul) of the probe's rows at logN."""
    mid = 8 if logn > 8 else logn - 2
    return [(logn, True, True), (mid, True, True), (1, True, True),
            (logn, True, False), (logn, False, True)]


def _pallas(x, r, logn, stages, do_roll, do_mul, swap_grid):
    """benchmarks/ntt_probe.py::_call at 2^logN, in interpret mode."""
    n = 1 << logn
    b, lpad = x.shape[0], x.shape[1]
    if swap_grid:
        grid, dat_map = (lpad // TILE, b), lambda j, i: (i, j, 0)
        tbl_map = lambda j, i: (j, 0)
    else:
        grid, dat_map = (b, lpad // TILE), lambda i, j: (i, j, 0)
        tbl_map = lambda i, j: (j, 0)
    tbl = pl.BlockSpec((TILE, n), tbl_map)
    col = pl.BlockSpec((TILE, 1), tbl_map)
    dat = pl.BlockSpec((1, TILE, n), dat_map)
    kern = functools.partial(jprobe._variant_kernel, n, logn, stages=stages,
                             do_roll=do_roll, do_mul=do_mul)
    return pl.pallas_call(
        kern, grid=grid, in_specs=[dat, tbl, tbl, tbl, tbl, col, col],
        out_specs=dat, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True)(x, r.wpack, r.wpack_sh, r.twist, r.twist_sh,
                        r.q[:, None], r.bar[:, None])


@pytest.fixture(scope="module")
def jax_runs():
    """Per logN: the port's ring, the any-u32 input and the JAX variant's
    output of every (setting, grid order)."""
    out = {}
    for logn in (8, 10):
        mods = ntt_primes(logn, 28.9, LIMBS)
        jr = jring.Ring.create(mods, logn)
        rng = np.random.default_rng(logn)
        x = rng.integers(0, 1 << 32, (BATCH, LIMBS, 1 << logn),
                         dtype=np.uint64).astype(np.uint32)
        runs = {(s, swap): np.asarray(_pallas(jnp.asarray(x), jr, logn, *s,
                                              swap)).astype(np.int64)
                for s in _settings(logn) for swap in (False, True)}
        out[logn] = (tring.Ring.create(mods, logn, "cpu"),
                     torch.from_numpy(x.astype(np.int64)), runs)
    return out


@pytest.mark.parametrize("logn", [8, 10])
@pytest.mark.parametrize("row", range(5))
def test_variant_matches_jax(jax_runs, logn, row):
    """ntt_variant_plain, and ntt_variant on a CPU tensor in both orders,
    equal the Pallas _variant_kernel in both grid orders."""
    ring, x, runs = jax_runs[logn]
    t = ntt_probe.variant_tables(ring)
    stages, exchange, mul = _settings(logn)[row]
    want = runs[(stages, exchange, mul), False]
    np.testing.assert_array_equal(runs[(stages, exchange, mul), True], want)
    got = ntt_cuda.ntt_variant_plain(x, t, stages=stages,
                                     exchange=exchange, mul=mul)
    np.testing.assert_array_equal(got.numpy(), want)
    for order in ntt_cuda.ORDERS:
        got = ntt_cuda.ntt_variant(x, t, stages=stages,
                                   exchange=exchange, mul=mul, order=order)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("logn", [8, 10])
def test_full_is_ntt_and_head(jax_runs, logn):
    """Every stage gives Ring.ntt; logN - 7 stages the split head."""
    ring, x, _ = jax_runs[logn]
    t = ntt_probe.variant_tables(ring)
    assert torch.equal(
        ntt_cuda.ntt_variant(x, t, stages=logn), ring.ntt(x))
    assert torch.equal(
        ntt_cuda.ntt_variant(x, t, stages=logn - 7),
        ntt_cuda.ntt_head_plain(x, t.q, t.twist, t.twist_sh, t.wpack,
                                t.wpack_sh))


def test_split_tables_leave_the_route(monkeypatch):
    """Reading the split tables (as the probe does) does not switch
    Ring.ntt to the split: config.ntt_mxu_tail alone decides."""
    ring = tring.Ring.create(ntt_primes(9, 28.9, 2), 9, "cpu")
    ntt_probe.variant_tables(ring)
    calls = []
    monkeypatch.setattr(ntt_cuda, "ntt_head",
                        lambda *a: calls.append("head"))
    monkeypatch.setattr(ntt_cuda, "ntt",
                        lambda *a: calls.append("full"))
    ring.ntt(torch.zeros((2, ring.n), dtype=torch.int64))
    assert calls == ["full"]


@pytest.mark.parametrize("shape", [(4, 32), (1, 3), (56, 32), (7, 1)])
def test_limb_major_order_covers_each_polynomial_once(shape):
    b, L = shape
    n_polys = b * L
    assert np.array_equal(ntt_cuda.variant_poly_order(n_polys, L, "poly"),
                          np.arange(n_polys))
    limb = ntt_cuda.variant_poly_order(n_polys, L, "limb")
    assert np.array_equal(np.sort(limb), np.arange(n_polys))
    # consecutive slots share a limb: slot r is on limb r // b
    assert np.array_equal(limb % L, np.arange(n_polys) // b)


# ----------------------------------------------------------------------------
# A numpy emulation of csrc/ntt_variant.cu
# ----------------------------------------------------------------------------

def _csub(a, m):
    return np.minimum(a, (a - m) & M32)


def _shoup_lazy(a, w, q):
    """a * lo(w) - umulhi(a, hi(w)) * q mod 2^32 (the high word of the
    64-bit product taken in 16-bit halves of a, so that nothing wraps)."""
    sh, b16 = w >> np.uint64(32), np.uint64(16)
    hi = ((a >> b16) * sh + (((a & np.uint64(0xFFFF)) * sh) >> b16)) >> b16
    return (a * (w & M32) - hi * q) & M32


def _padded(i):
    return i + (i >> 5)


def _passes(logn, stages, exchange):
    """(lo, R, first, last, end) of each register pass (the kernel's
    `passes`, or its one pass with the exchange off)."""
    if not exchange:
        r = min(stages, 5)
        return [(logn - r, r, True, True, logn - stages)]
    out, done = [], 0
    while done < stages:
        r = min(stages - done, 5)
        lo = logn - done - r
        out.append((lo, r, done == 0, done + r == stages, lo))
        done += r
    return out


def _bottom(d, b, lo, J, low, jl, limb, wpack_pack, qv, mul, read):
    """The bottom of a butterfly of stage bit b = lo + J whose twiddle is
    W_b^(low << lo | jl) (csrc/ntt_dif.cuh::stage): at lo >= 5 the lane's
    root W_b^jl times stage J's shared W_J^low, else the table entry itself.
    `read` collects the entries read as (limb, wpack index, shared, lo)."""
    n = wpack_pack.shape[-1]
    if not (mul and b > 0):
        return _csub(d, 2 * qv)
    if lo >= 5:
        ri, si = n - (2 << b) + jl, n - (2 << J) + low
        if low == 0:    # one root a stage
            read.append((limb, ri, False, lo))
        if J > 0:    # the kernel reads stage J's entries in pairs
            read.append((limb, si + 0 * jl, True, lo))
        t = d if low == 0 else _shoup_lazy(d, wpack_pack[limb, si], qv)
        return _shoup_lazy(t, wpack_pack[limb, ri], qv)
    wi = n - (2 << b) + (low << lo) + jl
    read.append((limb, wi, lo == 0, lo))
    return _shoup_lazy(d, wpack_pack[limb, wi], qv)


def emulate_variant(x, q, twist_pack, wpack_pack, stages, exchange, mul,
                    order, read=None):
    """The kernel's schedule and arithmetic on numpy uint64 words, all
    blocks and threads at once: x (n_polys, N), q (L,), packed tables
    (L, N) as uint64. `read`, a list, collects every twiddle read as
    (limbs, wpack indices, shared by the limb's threads, the bit lo of
    the pass whose stage reads it), each index array (blocks, threads)."""
    read = [] if read is None else read
    n_polys, n = x.shape
    L, logn = len(q), n.bit_length() - 1
    geom = ntt_cuda.geometry(logn, n_polys)
    size = 1 << (logn + geom.log_polys)
    out = np.full_like(x, 0xDEAD)
    smem = np.zeros((geom.blocks, size + size // 32), np.uint64)
    blk = np.arange(geom.blocks)[:, None]
    tid = np.arange(geom.threads)[None, :]
    lane = tid & 31
    rows = np.arange(geom.blocks)[:, None]
    polys = ntt_cuda.variant_poly_order(n_polys, L, order)
    for lo, R, first, last, end in _passes(logn, stages, exchange):
        C, G = 1 << R, 32 >> R
        for g in range(G):
            base = ntt_cuda.value_index(tid, geom.threads, g, 0, lo, R) \
                + 0 * blk
            r = (blk << geom.log_polys) + (base >> logn)
            valid = r < n_polys
            pv = polys[np.where(valid, r, 0)]
            limb = pv % L
            j0 = base & (n - 1)
            qv = q[limb]
            q2 = 2 * qv
            if first:
                v = [np.where(valid, _shoup_lazy(
                    x[pv, j0 | (c << lo)] & M32,
                    twist_pack[limb, j0 | (c << lo)], qv), 0)
                    for c in range(C)]
            else:
                v = [smem[rows, _padded(base | (c << lo))] for c in range(C)]
            jl = j0 & ((1 << lo) - 1)
            for J in range(R - 1, -1, -1):
                b = lo + J
                for low in range(1 << J):
                    for hi in range(1 << (R - 1 - J)):
                        c0 = (hi << (J + 1)) | low
                        c1 = c0 | (1 << J)
                        x0, y0 = v[c0], v[c1]
                        d = ((x0 if exchange else y0) - y0 + q2) & M32
                        v[c0] = _csub((x0 + (y0 if exchange else x0)) & M32,
                                      q2)
                        v[c1] = _bottom(d, b, lo, J, low, jl, limb,
                                        wpack_pack, qv, mul,
                                        read if hi == 0 else [])
            done = logn - lo    # exchange off: the full row's later passes
            while done < logn - end:
                p = min(logn - end - done, 5)
                klo = logn - done - p
                for J in range(p - 1, -1, -1):
                    b = klo + J
                    want = (j0 >> klo) & ((1 << J) - 1)
                    d = q2  # the partner is the value itself
                    jl = j0 & ((1 << klo) - 1)
                    if mul and b > 0 and klo >= 5:
                        # the root and stage J's 2^J shared entries; W_J^0
                        # = 1 is multiplied too: no branch on want
                        ri = n - (2 << b) + jl
                        read.append((limb, ri, False, klo))
                        t = d
                        if J > 0:
                            read.extend((limb, n - (2 << J) + low + 0 * j0,
                                         True, klo) for low in range(1 << J))
                            t = _shoup_lazy(d, wpack_pack[
                                limb, n - (2 << J) + want], qv)
                        bot = _shoup_lazy(t, wpack_pack[limb, ri], qv)
                    elif mul and b > 0:
                        wi = [n - (2 << b) + (low << klo) + jl
                              for low in range(1 << J)]
                        read.extend((limb, i, klo == 0, klo) for i in wi)
                        w = wpack_pack[limb, wi[0]]
                        for low in range(1, 1 << J):
                            w = np.where(low == want,
                                         wpack_pack[limb, wi[low]], w)
                        bot = _shoup_lazy(d, w, qv)
                    else:
                        bot = _csub(d, q2)
                    bottom = (j0 >> b) & 1 != 0
                    for c in range(C):
                        v[c] = np.where(bottom, bot,
                                        _csub(2 * v[c] & M32, q2))
                done += p
            if last:
                v = [_csub(vc, qv) for vc in v]
            if last and lo != 0:
                for c in range(C):
                    out[pv[valid], (j0 | (c << lo))[valid]] = v[c][valid]
                continue
            for c in range(C):
                smem[rows, _padded(base) + c * ((1 << lo) + ((1 << lo) >> 5))
                     if lo >= 5 else _padded(base | (c << lo))] = v[c]
            if last:  # lo = 0: the warp's 32 groups, staged
                wj, wbase = j0 - lane * C, base - lane * C
                for k in range(C // 2):
                    e = 2 * (lane + 32 * k)
                    for o in (0, 1):
                        vals = smem[rows, _padded(wbase + e + o)]
                        ok = np.broadcast_to(valid, vals.shape)
                        out[np.broadcast_to(pv, vals.shape)[ok],
                            (wj + e + o)[ok]] = vals[ok]
    return out


@pytest.mark.parametrize("logn", ntt_cuda.VARIANT_LOGNS)
def test_emulated_kernel_matches_plain(logn):
    """Every setting the kernel is built for, in both block orders, with
    a polynomial count that leaves the last block short below logN 13."""
    L, batch = 3, 3
    mods = ntt_primes(logn, 28.9, 1) + ntt_primes(logn, 27.0, L - 1)
    ring = tring.Ring.create(mods, logn, "cpu")
    t = ntt_probe.variant_tables(ring)
    rng = np.random.default_rng(logn)
    x = rng.integers(0, 1 << 32, (batch, L, ring.n), dtype=np.uint64)
    x[0, 0, :4] = 0xFFFFFFFF
    xt = torch.from_numpy(x.astype(np.int64))
    tables = [a.numpy().view(np.uint64)
              for a in (t.q, t.twist_pack, t.wpack_pack)]
    for stages, exchange, mul in sorted(ntt_cuda.variant_settings(logn)):
        want = ntt_cuda.ntt_variant_plain(xt, t, stages=stages,
                                          exchange=exchange, mul=mul)
        for order in ntt_cuda.ORDERS:
            got = emulate_variant(x.reshape(-1, ring.n), *tables, stages,
                                  exchange, mul, order)
            np.testing.assert_array_equal(
                got.reshape(x.shape).astype(np.int64), want.numpy(),
                err_msg=f"stages {stages} exchange {exchange} mul {mul} "
                        f"order {order}")


def _worst_bank(words):
    """Largest number of distinct words one bank serves in one warp's
    access; words (threads, registers)."""
    worst = 1
    for w in words.reshape(-1, 32, words.shape[-1]).transpose(0, 2, 1
                                                              ).reshape(-1, 32):
        worst = max(worst, np.bincount(np.unique(w) % 32).max())
    return worst


@pytest.mark.parametrize("logn", [14, 15])
def test_shared_memory_accesses_are_conflict_free(logn):
    """At the probe's timed shapes (logN 14, 15) every register of every
    shared-memory pass of every built setting hits 32 banks. (logN 10's 8
    stages end in a pass at lo = 2, which does not; it is only checked.)"""
    geom = ntt_cuda.geometry(logn, 1)
    threads = np.arange(geom.threads)[:, None]
    for stages, exchange, _ in ntt_cuda.variant_settings(logn):
        passes = _passes(logn, stages, exchange)
        for lo, r, first, last, _ in passes:
            if first and last:
                continue        # HBM in and out, no shared memory
            idx = np.stack([ntt_cuda.value_index(threads, geom.threads, g, c,
                                                 lo, r)
                            for g in range(32 >> r) for c in range(1 << r)],
                           axis=-1)[:, 0, :]
            assert _worst_bank(_padded(idx)) == 1, (stages, lo, r)


@pytest.mark.parametrize("logn", ntt_cuda.VARIANT_LOGNS)
def test_twiddle_entries_are_powers_of_omega(logn):
    """What the kernel reads of a limb's packed wpack (w | w_sh << 32)
    against Python's powers of omega mod q: stage bit b's entry l is
    W_b^l, W_b = omega^(N / 2^(b+1)), with its exact Shoup quotient; and
    the identity the lane roots rest on, W_b^(low << lo) = W_J^low (J =
    b - lo), for every pass of every built setting at lo >= 5."""
    mods = ntt_primes(logn, 28.9, 1) + ntt_primes(logn, 27.0, 1)
    t = ntt_probe.variant_tables(tring.Ring.create(mods, logn, "cpu"))
    n = 1 << logn
    for q, pack in zip(mods, t.wpack_pack.numpy().view(np.uint64)):
        w, w_sh = pack & M32, pack >> np.uint64(32)
        omega = int(w[1])   # stage bit logN - 1: omega^l
        assert pow(omega, n // 2, q) == q - 1
        for b in range(logn):
            want = [pow(omega, (n >> (b + 1)) * l, q) for l in range(1 << b)]
            got = w[n - (2 << b):n - (1 << b)]
            assert got.tolist() == want, b
            assert np.array_equal(w_sh[n - (2 << b):n - (1 << b)],
                                  (got << np.uint64(32)) // np.uint64(q))
        for stages, _, _ in ntt_cuda.variant_settings(logn):
            for lo, r, *_ in _passes(logn, stages, True):
                for j in range(r if lo >= 5 else 0):
                    b = lo + j
                    low = np.arange(1 << j)
                    assert np.array_equal(pack[n - (2 << b) + (low << lo)],
                                          pack[n - (2 << j) + low])


@pytest.mark.parametrize("logn", ntt_cuda.VARIANT_LOGNS)
def test_twiddle_reads(logn):
    """The emulated kernel's twiddle reads, every built setting with the
    multiplies: the entries read are ntt_cuda.variant_twiddle_entries (the
    bound's count) on every limb, with and without the exchange; an entry
    the limb's threads share is one address across each warp (a
    broadcast); at lo >= 5 a lane reads one root a stage, and a warp's
    roots are 32 neighbouring words."""
    L = 2
    mods = ntt_primes(logn, 28.9, L)
    ring = tring.Ring.create(mods, logn, "cpu")
    t = ntt_probe.variant_tables(ring)
    x = np.zeros((L * (1 if logn >= 13 else 3), ring.n), np.uint64)
    tables = [a.numpy().view(np.uint64)
              for a in (t.q, t.twist_pack, t.wpack_pack)]
    for stages, exchange, mul in sorted(ntt_cuda.variant_settings(logn)):
        if not mul:
            continue
        read = []
        emulate_variant(x, *tables, stages, exchange, mul, "poly", read)
        want = ntt_cuda.variant_twiddle_entries(logn, stages)
        for limb in range(L):
            got = np.unique(np.concatenate(
                [i[lm == limb] for lm, i, *_ in read]))
            assert np.array_equal(got, want), (stages, exchange, limb)
        for lm, i, shared, _ in read:
            warps = (i + lm * ring.n).reshape(-1, 32)
            if shared:
                assert (warps == warps[:, :1]).all(), (stages, exchange)
        if exchange:
            for lo, r, *_ in _passes(logn, stages, True):
                if lo < 5:
                    continue
                roots = [i for _, i, shared, at in read
                         if at == lo and not shared]
                # one root a stage for each of the thread's 32 / 2^r groups
                assert len(roots) == r * (32 >> r), (stages, lo)
                for i in roots:
                    assert (np.diff(i.reshape(-1, 32), axis=1) == 1).all()


# ----------------------------------------------------------------------------
# The wrapper, the bound and the entry point
# ----------------------------------------------------------------------------

def test_wrapper_checks():
    ring = tring.Ring.create(ntt_primes(10, 28.9, 2), 10, "cpu")
    t = ntt_probe.variant_tables(ring)
    x = torch.zeros((2, ring.n), dtype=torch.int64)
    for kw in (dict(stages=0), dict(stages=11),
               dict(stages=10, order="other")):
        with pytest.raises(ValueError):
            ntt_cuda.ntt_variant(x, t, **kw)
    bad = dataclasses.replace(t, wpack_pack=t.wpack_pack[:, :-1].contiguous())
    with pytest.raises(ValueError):
        ntt_cuda.ntt_variant(x, bad, stages=10)
    with pytest.raises(TypeError):
        ntt_cuda.ntt_variant(x.to(torch.int32), t, stages=10)
    with pytest.raises(ValueError, match="2\\^30"):
        ntt_cuda.pack_natural(t.wpack.numpy(), t.wpack_sh.numpy(),
                              (ring.moduli[0], 1 << 30))
    assert ntt_cuda.variant_settings(12) == frozenset()
    assert len(ntt_cuda.variant_settings(15)) == 5   # logN - 7 = 8
    assert len(ntt_cuda.variant_settings(14)) == 6


def test_variant_bound():
    """Bytes: 16 a coefficient and the tables read (the wpack entries the
    kernel reads, each once); operations: 6 a butterfly with a multiply, 3
    without, 4 a coefficient for the twist. At logN 10 the pass at bit 5
    reads 32 lane roots for each of its stages 5..9 and the shared entries
    of stages 1..4 (2 + 4 + 8 + 16), which are also all that the pass at
    bit 0 (every stage) or bit 2 (8 stages) reads: 190 entries; one stage
    reads its lane roots, the stage's 512 entries."""
    ring = tring.Ring.create(ntt_primes(10, 28.9, 4), 10, "cpu")
    t = ntt_probe.variant_tables(ring)
    x = torch.zeros((2, 4, ring.n), dtype=torch.int64)
    n, L, bfly = x.numel(), 4, x.numel() // 2
    for stages, mul, used, ops in (
            (10, True, 5 * 32 + 30, 6 * bfly * 9 + 3 * bfly),
            (10, False, 0, 3 * bfly * 10), (8, True, 5 * 32 + 30,
                                            6 * bfly * 8),
            (1, True, ring.n // 2, 6 * bfly)):
        reads = ntt_probe.variant_reads(t, stages, mul)
        nbytes = 16 * n + 8 * L + 8 * L * ring.n + 8 * L * used
        assert sum(a.numel() * 8 for a in reads) == nbytes - 16 * n
        want = profile_ntt.bound(nbytes, ops + 4 * n)
        assert profile_ntt.kernel_bound("ntt_variant", x, reads, stages,
                                        mul) == want


def test_probe_rows():
    names = [name for name, _ in ntt_probe.rows(15)]
    assert names == ["full 15 stages", "stages=8", "stages=1",
                     "no twiddle muls", "no rolls",
                     "swap grid (tables resident)"]
    for logn in ntt_cuda.VARIANT_LOGNS:
        for _, kw in ntt_probe.rows(logn):
            assert (kw["stages"], kw["exchange"], kw["mul"]) in \
                ntt_cuda.variant_settings(logn)


def test_probe_cpu_dry_run():
    """python -m mkhe_tpu_torch.ntt_probe --device cpu runs the checks of
    every row and prints its JSON last."""
    res = subprocess.run(
        [sys.executable, "-m", "mkhe_tpu_torch.ntt_probe", "--device", "cpu",
         "--logn", "9"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[0].startswith("cpu")
    out = json.loads(lines[-1])
    assert out["probe"]["probe"]["shape"] == [4, 32, 512]
    assert out["probe"]["probe"]["rows"] == {}


def test_probe_other_option():
    """ntt_probe --other DIR parses, and --device cpu refuses it, saying
    why; probe() holds another checkout's rows (this one, loaded under the
    other name) against its own, here on the CPU's plain route."""
    with pytest.raises(SystemExit, match="--other times two checkouts"):
        ntt_probe.main(["--device", "cpu", "--other", REPO])
    other = ntt_probe.load_other(REPO)
    assert other[0].__name__.startswith("mkhe_tpu_torch_other")
    ring = tring.Ring.create(ntt_primes(8, 28.9, 2), 8, "cpu")
    res = ntt_probe.probe(ring, (2,), timed=False, other=other)
    assert res["shape"] == [2, 2, 256] and res["rows"] == {}


def test_sass_mix_counts_each_variant_kernel():
    """The probe's static instruction counts, per variant kernel of one
    logN, from cuobjdump's listing (predicated instructions included, the
    encoding lines and the other kernels not; IMAD.HI.U32 counts as
    IMAD.HI, a plain IMAD not)."""
    body = ("        /*0000*/                   LDG.E.64.CONSTANT R2, "
            "desc[UR4][R2.64] ;   /* 0x0000000402027981 */\n"
            "                                          "
            "/* 0x000ea2000c1e9b00 */\n"
            "        /*0010*/              @!P2 BRA 0x580 ;   "
            "/* 0x000000040028a947 */\n"
            "        /*0020*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;"
            "\n        /*0030*/                   LDS R4, [R5] ;"
            "\n        /*0040*/                   IMAD.HI.U32 R6, R4, R7, RZ ;"
            "\n        /*0050*/                   IMAD R6, R4, R7, RZ ;\n")
    sass = "".join(f"\t\tFunction : _ZN4anon{name}EvNS_4ArgsE\n" + body
                   for name in ("18ntt_variant_kernelILi15ELi15ELb0ELb1EE",
                                "18ntt_variant_kernelILi14ELi14ELb1ELb1EE",
                                "10ntt_kernelILb1EE"))
    mix = {"LDG": 1, "LDS": 1, "STS": 0, "BAR": 1, "BRA": 1, "IMAD.HI": 1,
           "all": 6}
    assert ntt_probe.sass_mix(sass, 15) == {"stages=15 exchange=0 mul=1": mix}
    assert list(ntt_probe.sass_mix(sass, 14)) == ["stages=14 exchange=1 mul=1"]
