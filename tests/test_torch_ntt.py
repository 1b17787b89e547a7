"""The port's NTT (mkhe_tpu_torch/ops/ntt_cuda.py plain versions, reached
through Ring.ntt / Ring.intt on CPU tensors) against mkhe_tpu's Ring.ntt /
Ring.intt, bit for bit. On the CPU the JAX package runs its jnp path, the
Pallas kernels' bit-identical plain reference."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mkhe_tpu.ops import ring as jring
from mkhe_tpu.ops.primes import ntt_primes
from mkhe_tpu_torch.ops import ring as tring
from mkhe_tpu_torch.ops import ntt_cuda

torch.set_num_threads(1)

LOGNS = (4, 8, 10, 12)
LIMBS = 3
BATCH = 2


def _moduli(logn):
    return ntt_primes(logn, 28.9, 1) + ntt_primes(logn, 27.0, 2)


@pytest.fixture(scope="module", params=LOGNS)
def rings(request):
    logn = request.param
    mods = _moduli(logn)
    return (logn, jring.Ring.create(mods, logn),
            tring.Ring.create(mods, logn, "cpu"))


def _inputs(logn, kind, seed):
    """(BATCH, LIMBS, N) uint32: canonical, any u32, or lazy < 8q."""
    rng = np.random.default_rng(seed)
    q = np.array(_moduli(logn), np.uint64)[:, None]
    shape = (BATCH, LIMBS, 1 << logn)
    if kind == "u32":
        return rng.integers(0, 1 << 32, shape, dtype=np.uint64
                            ).astype(np.uint32)
    hi = q if kind == "canonical" else 8 * q
    return (rng.integers(0, 1 << 62, shape, dtype=np.uint64) % hi
            ).astype(np.uint32)


# one compiled graph per shape (the JAX eager path compiles op by op)
_jntt = jax.jit(lambda r, x: r.ntt(x, reduce_input=True))
_jintt = jax.jit(lambda r, x: r.intt(x, reduce_input=True))


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


def test_host_tables_match(rings):
    """Every table the port keeps equals the JAX package's."""
    logn, jr, tr = rings
    want = jring._host_tables(jr.moduli, logn)
    got = tring._host_tables(tr.moduli, logn)
    shared = [k for k in tring.TABLE_FIELDS
              if k not in ("r_inv", "psi_pack", "ipsi_pack")]
    for k in shared:
        np.testing.assert_array_equal(got[k], want[k].astype(np.int64),
                                      err_msg=k)
        np.testing.assert_array_equal(getattr(tr, k).numpy(), got[k])
    for q, r_inv in zip(tr.moduli, got["r_inv"]):
        assert (int(r_inv) << 32) % q == 1


@pytest.mark.parametrize("kind", ["canonical", "u32"])
def test_forward(rings, kind):
    """Canonical input and any-u32 input (the JAX reduce_input=True)."""
    logn, jr, tr = rings
    x = _inputs(logn, kind, seed=logn)
    _same(tr.ntt(_t(x)), _jntt(jr, jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["canonical", "lazy8q"])
def test_inverse(rings, kind):
    """Canonical input and lazy < 8q input with reduce_input."""
    logn, jr, tr = rings
    x = _inputs(logn, kind, seed=logn + 100)
    _same(tr.intt(_t(x)), _jintt(jr, jnp.asarray(x)))


def test_round_trip(rings):
    logn, _, tr = rings
    x = _t(_inputs(logn, "canonical", seed=logn + 200))
    y = tr.ntt(x)
    assert not torch.equal(y, x)
    assert torch.equal(tr.intt(y), x)


def test_unbatched_and_deep_batch(rings):
    """Leading axes are flattened and restored: (L, N) and (2, 2, L, N)
    give the rows of the (2, L, N) transform."""
    logn, _, tr = rings
    x = _t(_inputs(logn, "canonical", seed=logn + 300))
    for f in (tr.ntt, tr.intt):
        y = f(x)
        assert torch.equal(f(x[1]), y[1])
        assert torch.equal(f(torch.stack([x, x.flip(0)])),
                           torch.stack([y, y.flip(0)]))


def test_cpu_tensor_never_counts_a_launch(rings):
    """On a CPU tensor the wrapper runs the plain version, and only a
    kernel launch counts."""
    logn, _, tr = rings
    ntt_cuda.reset_counters()
    tr.intt(tr.ntt(_t(_inputs(logn, "canonical", seed=1))))
    assert (ntt_cuda.fwd_launches, ntt_cuda.inv_launches) == (0, 0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    tr = tring.Ring.create(_moduli(4), 4, "cpu")
    x = torch.zeros((LIMBS, 16), dtype=torch.int64)
    tables = (tr.psi, tr.psi_sh)
    with pytest.raises(TypeError):
        ntt_cuda._check(x.to(torch.int32), tables, (tr.q, tr.bar))
    with pytest.raises(ValueError):
        ntt_cuda._check(x[:, :12], tables, (tr.q, tr.bar))
    with pytest.raises(ValueError):
        ntt_cuda._check(x.t().contiguous().t(), tables, (tr.q, tr.bar))
    with pytest.raises(ValueError):
        ntt_cuda._check(x[:2], tables, (tr.q, tr.bar))
    assert ntt_cuda._check(x, tables, (tr.q, tr.bar)) == (LIMBS, LIMBS, 4)


# ----------------------------------------------------------------------------
# The full kernels' packed tables, launch geometry and schedule (the CUDA
# kernels themselves run only on the card: tests/test_torch_cuda.py)
# ----------------------------------------------------------------------------

def test_packed_tables_unpack_and_survive_take_concat(rings):
    """psi_pack / ipsi_pack unpack to psi / psi_sh and ipsi / ipsi_sh, and
    take() / concat() carry them limb by limb."""
    logn, _, tr = rings
    for pack, w, wsh, fwd in ((tr.psi_pack, tr.psi, tr.psi_sh, True),
                              (tr.ipsi_pack, tr.ipsi, tr.ipsi_sh, False)):
        got_w, got_sh = ntt_cuda.unpack_twiddles(pack, fwd)
        assert torch.equal(got_w, w) and torch.equal(got_sh, wsh)
    part = tr.take(1, LIMBS)
    both = tr.take(0, 1).concat(part)
    for k in ("psi_pack", "ipsi_pack"):
        assert torch.equal(getattr(part, k), getattr(tr, k)[1:])
        assert torch.equal(getattr(both, k), getattr(tr, k))
    x = _t(_inputs(logn, "u32", seed=logn + 400))
    assert torch.equal(part.ntt(x[:, 1:]), tr.ntt(x)[:, 1:])
    assert torch.equal(both.intt(x), tr.intt(x))


def _pass_indices(g, lo, r):
    """value_index of every (thread, g, c) of a pass over bits [lo, lo +
    r), shape (threads, 32 >> r, 2^r)."""
    return ntt_cuda.value_index(np.arange(g.threads)[:, None, None],
                                g.threads, np.arange(32 >> r)[None, :, None],
                                np.arange(1 << r)[None, None, :], lo, r)


@pytest.mark.parametrize("logn", range(1, ntt_cuda.MAX_LOGN + 1))
@pytest.mark.parametrize("n_polys", [1, 3, 7, 1 << 11 | 1])
def test_geometry_covers_every_polynomial_and_stage(logn, n_polys):
    """Every polynomial lies in exactly one block, every pass touches
    every coefficient of the block exactly once, and the passes cover the
    stages logN - 1 .. 0 (forward; the inverse runs them back) once each,
    within the card's limits."""
    g = ntt_cuda.geometry(logn, n_polys)
    per = 1 << g.log_polys
    assert (g.blocks - 1) * per < n_polys <= g.blocks * per
    size = 1 << (logn + g.log_polys)
    assert g.threads << ntt_cuda.LOG_VALS == size
    assert g.threads <= 1024 and g.threads % 32 == 0
    assert g.smem <= 232448 and g.smem >= 4 * size * 33 // 32
    assert sum(g.passes) == logn and all(1 <= r <= 5 for r in g.passes)
    assert all(r == 5 for r in g.passes[:-1])   # only the last is short
    stages, top = [], logn
    for r in g.passes:
        lo = top - r
        stages += list(range(top - 1, lo - 1, -1))
        top = lo
        idx = _pass_indices(g, lo, r)
        assert np.array_equal(np.sort(idx.ravel()), np.arange(size))
        # the kernel's address form: padded(base | c << lo) =
        # padded(base) + t + t // 32, t = c << lo
        pad = lambda i: i + (i >> 5)
        t = np.arange(1 << r) << lo
        assert np.array_equal(pad(idx), pad(idx[..., :1]) + t + (t >> 5))
        # a butterfly's two values are in one thread, 2^b apart
        for j in range(r):
            c0 = np.arange(1 << r)
            c0 = c0[(c0 >> j) & 1 == 0]
            assert np.all(idx[..., c0 | 1 << j] - idx[..., c0]
                          == 1 << (lo + j))
        if lo == 0:
            # a warp's 32 groups are neighbours: its lane k holds the
            # k-th 2^r coefficients after the first lane's base
            base = idx[..., 0].reshape(-1, 32, idx.shape[1])
            assert np.all(base - base[:, :1] == (np.arange(32) << r)[:, None])
    assert stages == list(range(logn - 1, -1, -1))


def _banks(addr):
    """Largest number of distinct words one bank serves in a warp access."""
    worst = 1
    for w in addr.reshape(-1, 32, addr.shape[-1]).transpose(0, 2, 1
                                                            ).reshape(-1, 32):
        words = np.unique(w)
        worst = max(worst, np.bincount(words % 32).max())
    return worst


@pytest.mark.parametrize("logn", range(5, ntt_cuda.MAX_LOGN + 1))
def test_shared_memory_accesses_are_conflict_free(logn):
    """Every warp's access to the padded shared array (index i at i +
    i // 32) hits 32 different banks: every register of every pass, and
    the pairs of a warp's staging at lo = 0."""
    g = ntt_cuda.geometry(logn, 1)
    pad = lambda i: i + i // 32
    top = logn
    for r in g.passes:
        for lo in (top - r, logn - top):     # forward, inverse
            idx = _pass_indices(g, lo, r)
            assert _banks(pad(idx.reshape(g.threads, -1))) == 1
        top -= r
    lane = np.arange(32)[:, None]
    for r in {g.passes[0], g.passes[-1]}:      # the passes at lo = 0
        pairs = 2 * (lane + 32 * np.arange(1 << (r - 1))[None, :])
        for word in (pairs, pairs + 1):
            assert _banks(pad(word)) == 1


M32 = np.uint64(0xFFFFFFFF)


def _emulate(fwd, x, q, bar, pack, ninv, ninv_sh, logn):
    """The full kernels' schedule in numpy u32 arithmetic: the geometry's
    blocks and passes, value_index, the twiddle offsets into the packed
    table (spread order at lo = 0) and the lazy butterflies of
    csrc/ntt.cu, with their ranges asserted."""
    L, n = x.shape[-2], x.shape[-1]
    flat = x.reshape(-1, n).astype(np.uint64)
    n_polys = flat.shape[0]
    g = ntt_cuda.geometry(logn, n_polys)
    per, size = 1 << g.log_polys, 1 << (logn + g.log_polys)
    pw = pack.astype(np.uint64) & M32
    psh = pack.astype(np.uint64) >> np.uint64(32)
    out = np.zeros_like(flat)
    for group in range(g.blocks):
        polys = np.arange(group * per, (group + 1) * per)
        ok = polys < n_polys
        data = np.zeros((per, n), np.uint64)
        data[ok] = flat[polys[ok]]
        limbs = polys % L
        qq, bb = q[limbs][:, None], bar[limbs][:, None]
        s = ((data - (((data * bb) >> np.uint64(32)) * qq)) & M32).ravel()
        assert np.all(s < 2 * np.repeat(q[limbs], n))
        lo = logn if fwd else 0
        for k, r in enumerate(g.passes):
            lo -= r if fwd else 0
            idx = _pass_indices(g, lo, r)
            v = s[idx]
            base = idx[..., 0]
            limb = limbs[base >> logn]
            qv = q[limb][..., None]
            hi = (base & (n - 1)) >> (lo + r)
            for j in (range(r - 1, -1, -1) if fwd else range(r)):
                c = np.arange(1 << r)
                c0 = c[(c >> j) & 1 == 0]
                c1 = c0 | 1 << j
                m, cc = n >> (lo + j + 1), (c0 >> (j + 1))[None, None, :]
                if lo == 0:     # the spread order (twiddle_order)
                    t = m + cc * (n >> r) + hi[..., None]
                else:
                    t = m + (hi[..., None] << (r - 1 - j)) + cc
                w, wsh = pw[limb[..., None], t], psh[limb[..., None], t]
                a, b = v[..., c0], v[..., c1]
                if fwd:
                    a = np.minimum(a, (a - 2 * qv) & M32)
                    tt = (b * w - ((b * wsh) >> np.uint64(32)) * qv) & M32
                    v[..., c0], v[..., c1] = (a + tt) & M32, (a - tt + 2 * qv) & M32
                    assert np.all(v < 4 * qv)
                else:
                    sm, d = (a + b) & M32, (a - b + 2 * qv) & M32
                    v[..., c0] = np.minimum(sm, (sm - 2 * qv) & M32)
                    v[..., c1] = (d * w - ((d * wsh) >> np.uint64(32)) * qv) & M32
                    assert np.all(v < 2 * qv)
            if k == len(g.passes) - 1:
                if fwd:
                    v = np.minimum(v, (v - 2 * qv) & M32)
                else:
                    nv, nsh = ninv[limb][..., None], ninv_sh[limb][..., None]
                    v = (v * nv - ((v * nsh) >> np.uint64(32)) * qv) & M32
                v = np.minimum(v, (v - qv) & M32)
            s[idx] = v
            lo += 0 if fwd else r
        out[polys[ok]] = s.reshape(per, n)[ok]
    return out.reshape(x.shape).astype(np.int64)


@pytest.mark.parametrize("logn", range(1, ntt_cuda.MAX_LOGN + 1))
def test_kernel_schedule_matches_plain(logn):
    """The kernels' schedule and lazy arithmetic, emulated in numpy at
    every logN with odd batches (a partly filled last block), equal the
    plain versions bit for bit, for any-u32 forward and < 8q inverse
    inputs."""
    L = 3
    mods = _moduli(logn)
    tr = tring.Ring.create(mods, logn, "cpu")
    rng = np.random.default_rng(logn)
    batch = 5 if logn > 11 else 7
    x = rng.integers(0, 1 << 32, (batch, L, 1 << logn), dtype=np.uint64)
    q = np.array(mods, np.uint64)
    lazy = (x % (8 * q)[:, None]).astype(np.int64)
    consts = {k: getattr(tr, k).numpy().astype(np.uint64)
              for k in ("q", "bar", "ninv", "ninv_sh")}
    got = _emulate(True, x, consts["q"], consts["bar"], tr.psi_pack.numpy(),
                   None, None, logn)
    want = tr.ntt(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got, want.numpy())
    got = _emulate(False, lazy, consts["q"], consts["bar"],
                   tr.ipsi_pack.numpy(), consts["ninv"], consts["ninv_sh"],
                   logn)
    np.testing.assert_array_equal(got, tr.intt(torch.from_numpy(lazy)).numpy())


def test_large_moduli_and_malformed_packed_tables_are_rejected():
    """A ring with a modulus of 2^30 or more gets no packed tables (the
    kernels' lazy values must stay below 2^32); the wrapper refuses packed
    tables of the wrong shape, type or alignment, and logN above 15."""
    for q in (1073741857, 2013265921):   # NTT primes (1 mod 32) >= 2^30
        with pytest.raises(ValueError, match="2\\^30"):
            tring.Ring.create(tuple(_moduli(4)[:1]) + (q,), 4, "cpu")
        with pytest.raises(ValueError, match="2\\^30"):
            ntt_cuda.pack_twiddles(np.zeros((1, 16), np.int64),
                                   np.zeros((1, 16), np.int64), (q,), True)
    tr = tring.Ring.create(_moduli(4), 4, "cpu")
    x = torch.zeros((LIMBS, 16), dtype=torch.int64)
    fwd = (tr.q, tr.bar, tr.psi, tr.psi_sh)
    for bad in (tr.psi_pack[:, :8].contiguous(), tr.psi_pack[:2]):
        with pytest.raises(ValueError):
            ntt_cuda.ntt(x, *fwd, bad)
    with pytest.raises(TypeError):
        ntt_cuda.ntt(x, *fwd, tr.psi_pack.to(torch.int32))
    with pytest.raises(ValueError):
        ntt_cuda.intt(x, tr.q, tr.bar, tr.ipsi, tr.ipsi_sh, tr.ninv,
                      tr.ninv_sh, tr.ipsi_pack[:2])
    flat = torch.zeros(LIMBS * 16 + 1, dtype=torch.int64)
    skewed = flat[1:].view(LIMBS, 16)
    skewed.copy_(tr.psi_pack)
    with pytest.raises(ValueError, match="16-byte"):
        ntt_cuda.ntt(x, *fwd, skewed)
    with pytest.raises(ValueError):
        ntt_cuda.geometry(16, 1)
    big = tring.Ring.create(ntt_primes(16, 28.9, 1), 16, "cpu")  # tables build
    with pytest.raises(ValueError):
        big.ntt(torch.zeros((1, big.n), dtype=torch.int64))


def test_cpu_route_reads_the_natural_tables(rings):
    """On a CPU tensor ntt / intt run the plain versions on psi / psi_sh
    and ipsi / ipsi_sh, whatever the packed table holds (only its shape
    is checked): the kernels alone read it."""
    logn, _, tr = rings
    x = _t(_inputs(logn, "u32", seed=logn + 500))
    junk = torch.zeros_like(tr.psi_pack)
    got = ntt_cuda.ntt(x, tr.q, tr.bar, tr.psi, tr.psi_sh, junk)
    assert torch.equal(got, tr.ntt(x))
    assert torch.equal(ntt_cuda.intt(got, tr.q, tr.bar, tr.ipsi, tr.ipsi_sh,
                                     tr.ninv, tr.ninv_sh, junk),
                       tr.reduce(x))
