"""The port's split NTT (config.ntt_mxu_tail; mkhe_tpu_torch/ops/ntt_cuda.py
ntt_head / tail / intt_tailed, plain versions on CPU tensors) against
mkhe_tpu, bit for bit:

  - the split's tables against the JAX Ring's (twist .. iwpack_sh,
    tail_fwd, tail_inv, tail_pow) at logN 8-12;
  - tail_plain against the JAX package's _tail_apply (plain XLA int8
    products, which run on the CPU) on any-u32 input;
  - head + tail against Ring.ntt, and tail + tailed inverse against
    Ring.intt(reduce_input=True) on < 8q input;
  - Ring.ntt / intt routing as the switch flips, and the tables of
    take / concat rings;
  - the split kernel's own tables, and numpy emulations of its schedules
    (the forward's u8 fragment arithmetic; the inverse's tail in place
    and its DIT register passes) against the plain versions."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mkhe_tpu.ops import ntt_pallas
from mkhe_tpu.ops import ring as jring
from mkhe_tpu.ops.primes import ntt_primes
from mkhe_tpu_torch import config
from mkhe_tpu_torch.ops import ntt_cuda
from mkhe_tpu_torch.ops import ring as tring

torch.set_num_threads(1)

LIMBS = 3
BATCH = 2


def _moduli(logn):
    return ntt_primes(logn, 28.9, 1) + ntt_primes(logn, 27.0, LIMBS - 1)


def _rings(logn):
    mods = _moduli(logn)
    return jring.Ring.create(mods, logn), tring.Ring.create(mods, logn, "cpu")


def _inputs(logn, kind, seed):
    """(BATCH, LIMBS, N) uint32: any u32, or lazy < 8q."""
    rng = np.random.default_rng(seed)
    shape = (BATCH, LIMBS, 1 << logn)
    if kind == "u32":
        return rng.integers(0, 1 << 32, shape, dtype=np.uint64
                            ).astype(np.uint32)
    q = np.array(_moduli(logn), np.uint64)[:, None]
    return (rng.integers(0, 1 << 62, shape, dtype=np.uint64) % (8 * q)
            ).astype(np.uint32)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


@pytest.fixture
def split_on():
    config.ntt_mxu_tail = True
    yield
    config.ntt_mxu_tail = False


_jntt = jax.jit(lambda r, x: r.ntt(x, reduce_input=True))
_jintt = jax.jit(lambda r, x: r.intt(x, reduce_input=True))
_jtail = jax.jit(ntt_pallas._tail_apply)


@pytest.mark.parametrize("logn", [8, 9, 10, 11, 12])
def test_split_tables_match_jax(logn):
    jr, tr = _rings(logn)
    tables = tr.split_tables()
    for k in tring.SPLIT_FIELDS:
        want = np.asarray(getattr(jr, k))
        got = getattr(tables, k).numpy()
        assert got.shape == want.shape, k
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=k)
    assert tables.tail_fwd.dtype == torch.int8
    assert tr.split_tables() is tables     # cached


@pytest.mark.parametrize("logn", [8, 10, 12])
@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_tail_plain_matches_tail_apply(logn, direction):
    jr, tr = _rings(logn)
    t = tr.split_tables()
    x = _inputs(logn, "u32", seed=logn)
    jm = jr.tail_fwd if direction == "fwd" else jr.tail_inv
    tm = t.tail_fwd if direction == "fwd" else t.tail_inv
    want = _jtail(jnp.asarray(x), jm, jr.tail_pow, jr.q, jr.qinv_neg)
    _same(ntt_cuda.tail(_t(x), tr.q, tr.r_inv, tm, t.tail_pow), want)


@pytest.mark.parametrize("logn", [8, 10, 12])
def test_head_then_tail_is_the_ntt(logn):
    """head_plain + tail_plain (forward map) on any-u32 input equals the
    JAX Ring.ntt(reduce_input=True)."""
    jr, tr = _rings(logn)
    t = tr.split_tables()
    x = _inputs(logn, "u32", seed=logn + 10)
    head = ntt_cuda.ntt_head_plain(_t(x), tr.q, t.twist, t.twist_sh,
                                   t.wpack, t.wpack_sh)
    got = ntt_cuda.tail_plain(head, tr.q, tr.r_inv, t.tail_fwd, t.tail_pow)
    _same(got, _jntt(jr, jnp.asarray(x)))


@pytest.mark.parametrize("logn", [8, 10, 12])
def test_tail_then_tailed_inverse_is_the_intt(logn):
    """tail_plain (inverse map) + intt_tailed_plain on < 8q input equals
    the JAX Ring.intt(reduce_input=True)."""
    jr, tr = _rings(logn)
    t = tr.split_tables()
    x = _inputs(logn, "lazy8q", seed=logn + 20)
    tailed = ntt_cuda.tail_plain(_t(x), tr.q, tr.r_inv, t.tail_inv,
                                 t.tail_pow)
    got = ntt_cuda.intt_tailed_plain(tailed, tr.q, tr.bar, t.iwpack,
                                     t.iwpack_sh, t.untwist, t.untwist_sh)
    _same(got, _jintt(jr, jnp.asarray(x)))


def test_switch_flips_routing_both_ways():
    """Turning the switch on, off and on again between calls routes each
    call by the switch at that call, with equal outputs."""
    _, tr = _rings(10)
    x = _t(_inputs(10, "u32", seed=30))
    y = _t(_inputs(10, "lazy8q", seed=31))
    calls = []
    real_head, real_inv = ntt_cuda.ntt_head_plain, ntt_cuda.intt_plain

    def head(*a):
        calls.append("head")
        return real_head(*a)

    def inv(*a):
        calls.append("inv")
        return real_inv(*a)

    outs = []
    try:
        ntt_cuda.ntt_head_plain, ntt_cuda.intt_plain = head, inv
        for on in (False, True, False, True):
            config.ntt_mxu_tail = on
            outs.append((tr.ntt(x), tr.intt(y)))
    finally:
        ntt_cuda.ntt_head_plain, ntt_cuda.intt_plain = real_head, real_inv
        config.ntt_mxu_tail = False
    assert calls == ["inv", "head", "inv", "head"]
    for f, i in outs[1:]:
        assert torch.equal(f, outs[0][0]) and torch.equal(i, outs[0][1])


def test_small_rings_stay_unsplit(split_on):
    """Below N = 256 the switch changes nothing: no split tables needed."""
    _, tr = _rings(7)
    x = _t(_inputs(7, "u32", seed=40))
    want = ntt_cuda.ntt_plain(x, tr.q, tr.bar, tr.psi, tr.psi_sh)
    assert torch.equal(tr.ntt(x), want)
    assert torch.equal(tr.intt(want), ntt_cuda.intt_plain(
        want, tr.q, tr.bar, tr.ipsi, tr.ipsi_sh, tr.ninv, tr.ninv_sh))


def test_take_and_concat_rings_get_the_tables(split_on):
    """A sub-ring and a concatenated ring get their own limbs' tables and
    the same transforms as the unsplit path."""
    _, tr = _rings(9)
    sub, other = tr.take(1, 3), tr.take(0, 1)
    both = sub.concat(other)
    full = tr.split_tables()
    for k in tring.SPLIT_FIELDS:
        assert torch.equal(getattr(sub.split_tables(), k),
                           getattr(full, k)[1:3])
        assert torch.equal(getattr(both.split_tables(), k),
                           torch.cat([getattr(full, k)[1:3],
                                      getattr(full, k)[:1]]))
    x = _t(_inputs(9, "u32", seed=50))[:, [1, 2, 0]]
    want = ntt_cuda.ntt_plain(x, both.q, both.bar, both.psi, both.psi_sh)
    assert torch.equal(both.ntt(x), want)
    assert torch.equal(both.intt(want), both.reduce(x))


def test_cpu_calls_never_count_a_launch(split_on):
    _, tr = _rings(8)
    ntt_cuda.reset_counters()
    tr.intt(tr.ntt(_t(_inputs(8, "u32", seed=60))))
    assert set(ntt_cuda.counters().values()) == {0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    _, tr = _rings(8)
    t = tr.split_tables()
    x = _t(_inputs(8, "u32", seed=70))
    args = (tr.q, tr.r_inv, t.tail_fwd, t.tail_pow)
    with pytest.raises(ValueError):
        ntt_cuda.tail(x, tr.q, tr.r_inv, t.tail_fwd.to(torch.int64),
                      t.tail_pow)
    with pytest.raises(ValueError):
        ntt_cuda.tail(x, tr.q, tr.r_inv, t.tail_fwd[:2], t.tail_pow)
    with pytest.raises(ValueError):
        ntt_cuda.tail(x[..., :64], *args)
    with pytest.raises(ValueError):
        ntt_cuda.ntt_head(x[:, :2], tr.q, t.twist, t.twist_sh, t.wpack,
                          t.wpack_sh)
    with pytest.raises(TypeError):
        ntt_cuda.intt_tailed(x.to(torch.int32), tr.q, tr.bar, t.iwpack,
                             t.iwpack_sh, t.untwist, t.untwist_sh)


# ----------------------------------------------------------------------------
# The fused forward (ntt_split_fwd) and the split kernel's tables
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("logn", [8, 10, 12])
@pytest.mark.parametrize("kind", ["canonical", "u32"])
def test_split_fwd_matches_jax_ntt(logn, kind):
    """ntt_split_fwd on a CPU tensor equals the JAX Ring.ntt
    (reduce_input=True), bit for bit."""
    jr, tr = _rings(logn)
    x = _inputs(logn, "u32", seed=logn + 80)
    if kind == "canonical":
        x = (x.astype(np.uint64) % np.array(_moduli(logn), np.uint64)
             [:, None]).astype(np.uint32)
    got = ntt_cuda.ntt_split_fwd(_t(x), tr.q, tr.r_inv, tr.split_tables())
    _same(got, _jntt(jr, jnp.asarray(x)))


def test_split_on_ring_runs_one_fused_forward(monkeypatch, split_on):
    """With the split on, Ring.ntt makes one ntt_split_fwd call (not
    ntt_head then tail), and Ring.intt one ntt_split_inv call (not tail
    then intt_tailed)."""
    _, tr = _rings(9)
    x = _t(_inputs(9, "u32", seed=90))
    want_f, want_i = tr.ntt(x), tr.intt(x)
    calls = []
    for name in ("ntt_split_fwd", "ntt_split_inv", "ntt_head", "tail",
                 "intt_tailed", "ntt", "intt"):
        real = getattr(ntt_cuda, name)
        monkeypatch.setattr(ntt_cuda, name,
                            lambda *a, _n=name, _f=real:
                            calls.append(_n) or _f(*a))
    assert torch.equal(tr.ntt(x), want_f)
    assert calls == ["ntt_split_fwd"]
    assert torch.equal(tr.intt(x), want_i)
    assert calls == ["ntt_split_fwd", "ntt_split_inv"]


def _frag_matrix(frag):
    """The 128x128 map a fragment table holds: byte b of lane's 8 bytes
    for (plane d, k-step ks, n-tile nt) is byte d of entry (32 ks + 16
    (b // 4) + lane % 4 + 4 (b % 4), 8 nt + lane // 4)."""
    m = np.zeros((128, 128), np.uint64)
    f = frag.numpy()
    for d, ks, nt, lane, b in np.ndindex(*f.shape):
        row = 32 * ks + 16 * (b >> 2) + (lane & 3) + 4 * (b & 3)
        m[row, 8 * nt + (lane >> 2)] += np.uint64(f[d, ks, nt, lane, b]) \
            << np.uint64(8 * d)
    return m


def _planes_matrix(planes):
    """The map the JAX package's int8 base-2^7 planes hold."""
    return sum(planes.numpy()[d].astype(np.uint64)
               << np.uint64(ntt_cuda.TAIL_DIGIT_BITS * d)
               for d in range(ntt_cuda.TAIL_DIGITS))


@pytest.mark.parametrize("logn", [8, 10, 12])
def test_kernel_tables_match_the_jax_tables(logn):
    """The split kernel's tables hold what the JAX-parity ones hold: the
    fragment tables the same maps (each entry canonical), tail_pow8 the
    powers 2^(8t+32) mod q, the packed twist, wpack, untwist and iwpack
    their words."""
    _, tr = _rings(logn)
    t = tr.split_tables()
    assert t.tail_fwd_frag.shape == (LIMBS, *ntt_cuda.FRAG_SHAPE)
    assert t.tail_fwd_frag.dtype == torch.uint8
    for limb, q in enumerate(_moduli(logn)):
        for frag, planes in ((t.tail_fwd_frag, t.tail_fwd),
                             (t.tail_inv_frag, t.tail_inv)):
            m = _frag_matrix(frag[limb])
            assert (m < q).all()
            np.testing.assert_array_equal(m, _planes_matrix(planes[limb]))
        assert t.tail_pow8[limb].tolist() == [pow(2, 8 * k + 32, q)
                                              for k in range(7)]
    for pack, w, w_sh in ((t.twist_pack, t.twist, t.twist_sh),
                          (t.wpack_pack, t.wpack, t.wpack_sh),
                          (t.untwist_pack, t.untwist, t.untwist_sh),
                          (t.iwpack_pack, t.iwpack, t.iwpack_sh)):
        assert torch.equal(pack & 0xFFFFFFFF, w)
        assert torch.equal((pack >> 32) & 0xFFFFFFFF, w_sh)


def _emulate_tail_kernel(x, q, frag, pw8):
    """csrc/ntt_split.cu::tail_rows in numpy, limb by limb: the A
    fragments from the kernel's shared-memory reads (byte e of register
    (hf, row) of thread c is column 32 ks + 16 hf + c + 4 e), the B
    fragments from the table by lane, mma.sync's sum over k = 16 hf + 4 c
    + e, 7 partial sums of the 16 u8 plane products, the recombination
    with pw8 and one Montgomery step (-q^-1 by Newton) and one csub."""
    *batch, L, n = x.shape
    hf, c, e = np.meshgrid(np.arange(2), np.arange(4), np.arange(4),
                           indexing="ij")
    k_mma = (16 * hf + 4 * c + e).ravel()      # the MMA's k
    col = (16 * hf + c + 4 * e).ravel()        # the column it reads
    out = np.empty(x.shape, np.uint64)
    m32 = np.uint64(0xFFFFFFFF)
    for limb in range(L):
        qq = int(q[limb])
        rows = x[..., limb, :].reshape(-1, 128).astype(np.uint64)
        f = frag[limb]
        s = np.zeros((7, rows.shape[0], 128), np.int64)
        for ks in range(4):
            for dx in range(4):
                a = np.zeros((rows.shape[0], 32), np.int64)
                a[:, k_mma] = ((rows[:, 32 * ks + col] >> np.uint64(8 * dx))
                               & np.uint64(255)).astype(np.int64)
                for dm in range(4):
                    b = np.zeros((32, 128), np.int64)
                    for nn in range(128):
                        lane = 4 * (nn % 8) + c.ravel()
                        b[k_mma, nn] = f[dm, ks, nn // 8, lane,
                                         4 * hf.ravel() + e.ravel()]
                    s[dx + dm] += a @ b
        assert s.max() < 1 << 25
        qinv = qq
        for _ in range(4):
            qinv = qinv * (2 - qq * qinv) % (1 << 32)
        qneg = np.uint64((-qinv) % (1 << 32))
        acc = sum(s[t].astype(np.uint64) * np.uint64(int(pw8[limb, t]))
                  for t in range(7))
        mq = ((acc & m32) * qneg) & m32
        r = (acc + mq * np.uint64(qq)) >> np.uint64(32)
        r = np.where(r >= qq, r - np.uint64(qq), r)
        out[..., limb, :] = r.reshape(*batch, n)
    return out


@pytest.mark.parametrize("logn", [8, 10])
@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_u8_fragment_arithmetic_matches_tail_plain(logn, direction):
    """The kernel's u8 fragment arithmetic, emulated, equals tail_plain
    (the JAX package's s8 arithmetic) on any-u32 input with extremes."""
    _, tr = _rings(logn)
    t = tr.split_tables()
    x = _inputs(logn, "u32", seed=logn + 100)
    x[0, :, :200] = 0xFFFFFFFF
    mat, frag = ((t.tail_fwd, t.tail_fwd_frag) if direction == "fwd"
                 else (t.tail_inv, t.tail_inv_frag))
    want = ntt_cuda.tail_plain(_t(x), tr.q, tr.r_inv, mat, t.tail_pow)
    got = _emulate_tail_kernel(x, tr.q.numpy(), frag.numpy(),
                               t.tail_pow8.numpy())
    np.testing.assert_array_equal(got.astype(np.int64), want.numpy())


def test_split_wrappers_reject_what_the_kernel_does_not_take():
    import dataclasses
    _, tr = _rings(8)
    t = tr.split_tables()
    x = _t(_inputs(8, "u32", seed=110))
    fwd = ntt_cuda.ntt_split_fwd
    with pytest.raises(ValueError):
        fwd(x, tr.q, tr.r_inv, dataclasses.replace(
            t, tail_fwd_frag=t.tail_fwd_frag.to(torch.int8)))
    with pytest.raises(ValueError):
        fwd(x, tr.q, tr.r_inv, dataclasses.replace(
            t, tail_pow8=t.tail_pow))
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.zeros(t.tail_fwd_frag.numel() + 1, dtype=torch.uint8)
        skewed = flat[1:].view(t.tail_fwd_frag.shape)
        fwd(x, tr.q, tr.r_inv, dataclasses.replace(t, tail_fwd_frag=skewed))
    with pytest.raises(ValueError):
        fwd(x, tr.q, tr.r_inv, dataclasses.replace(
            t, wpack_pack=t.wpack_pack[:, :-1].contiguous()))
    with pytest.raises(TypeError):
        fwd(x.to(torch.int32), tr.q, tr.r_inv, t)
    _, small = _rings(7)
    with pytest.raises(ValueError):     # the kernel is built from logN 8
        ntt_cuda.tail(_t(_inputs(7, "u32", seed=111)), small.q, small.r_inv,
                      *(torch.zeros((LIMBS, 5, 128, 128), dtype=torch.int8),
                        torch.zeros((LIMBS, 9), dtype=torch.int64)))
    with pytest.raises(ValueError):
        ntt_cuda.ntt_head(x, tr.q, t.twist, t.twist_sh, t.wpack, t.wpack_sh,
                          t.twist_pack[:2], t.wpack_pack)
    with pytest.raises(ValueError):
        ntt_cuda.tail(x, tr.q, tr.r_inv, t.tail_inv, t.tail_pow,
                      t.tail_inv_frag[:, :3], t.tail_pow8)


# ----------------------------------------------------------------------------
# The fused inverse (ntt_split_inv): plain version, and numpy emulations of
# csrc/ntt_split.cu::ntt_split_inv_kernel's schedules
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("logn", [8, 9, 10])
@pytest.mark.parametrize("kind", ["canonical", "lazy8q", "u32"])
def test_split_inv_matches_jax_intt(logn, kind):
    """ntt_split_inv on a CPU tensor (ntt_split_inv_plain) equals the JAX
    Ring.intt(reduce_input=True), bit for bit."""
    jr, tr = _rings(logn)
    x = _inputs(logn, "lazy8q" if kind == "lazy8q" else "u32",
                seed=logn + 120)
    if kind == "canonical":
        x = (x.astype(np.uint64) % np.array(_moduli(logn), np.uint64)
             [:, None]).astype(np.uint32)
    got = ntt_cuda.ntt_split_inv(_t(x), tr.q, tr.bar, tr.r_inv,
                                 tr.split_tables())
    _same(got, _jintt(jr, jnp.asarray(x)))


def _padded(i):
    return i + (i >> 5)


def _fragment_b(frag):
    """b[ks][dm]: the (32, 128) u8 B operand of k-step ks, plane dm, rows
    in MMA k order, as the lanes' fragment registers hold it."""
    hf, c, e = np.meshgrid(np.arange(2), np.arange(4), np.arange(4),
                           indexing="ij")
    k_mma = (16 * hf + 4 * c + e).ravel()
    b = np.zeros((4, 4, 32, 128), np.int64)
    for nn in range(128):
        lane = 4 * (nn % 8) + c.ravel()
        b[:, :, k_mma, nn] = np.moveaxis(
            frag[:, :, nn // 8, lane, 4 * hf.ravel() + e.ravel()], 0, 1)
    return b


def _u8_rows(rows, qq, b, pw8):
    """rows @ M for (R, 128) u32 rows by the kernel's u8 fragment
    arithmetic (the A fragments' permuted columns, 7 partial sums, the
    recombination with pw8 and one Montgomery step and csub)."""
    hf, c, e = np.meshgrid(np.arange(2), np.arange(4), np.arange(4),
                           indexing="ij")
    k_mma = (16 * hf + 4 * c + e).ravel()
    col = (16 * hf + c + 4 * e).ravel()
    s = np.zeros((7, rows.shape[0], 128), np.int64)
    for ks in range(4):
        for dx in range(4):
            a = np.zeros((rows.shape[0], 32), np.int64)
            a[:, k_mma] = ((rows[:, 32 * ks + col] >> np.uint64(8 * dx))
                           & np.uint64(255)).astype(np.int64)
            for dm in range(4):
                s[dx + dm] += a @ b[ks, dm]
    assert s.max() < 1 << 25
    qinv = qq
    for _ in range(4):
        qinv = qinv * (2 - qq * qinv) % (1 << 32)
    qneg = np.uint64((-qinv) % (1 << 32))
    acc = sum(s[t].astype(np.uint64) * np.uint64(int(pw8[t]))
              for t in range(7))
    mq = ((acc & M32) * qneg) & M32
    r = (acc + mq * np.uint64(qq)) >> np.uint64(32)
    return np.where(r >= qq, r - np.uint64(qq), r)


def _item_words(logn, item, reads):
    """The padded words an item (row tile, first n-tile, n-tiles) of the
    in-place tail reads (its rows, every column) or writes (its rows, its
    n-tiles' columns)."""
    rt, nt0, tiles = item
    rows = np.arange(16 * rt, min(16 * rt + 16, (1 << logn) // 128))
    cols = np.arange(128) if reads else np.arange(8 * nt0, 8 * (nt0 + tiles))
    return set(_padded(128 * rows[:, None] + cols[None, :]).ravel().tolist())


@pytest.mark.parametrize("logn", range(ntt_cuda.SPLIT_MIN_LOGN,
                                       ntt_cuda.MAX_LOGN + 1))
def test_tail_in_place_schedule_is_safe(logn):
    """The inverse's tail in place (ntt_cuda.tail_schedule, the kernel's
    rule): every (row tile, n-tile) is computed once, and no word is
    written while another warp, or a later item of the same warp, may
    still read it: with warps sharing row tiles a block barrier stands
    between all reads and all writes; without, a warp writes only words
    that no other warp and none of its later items read."""
    items, split = ntt_cuda.tail_schedule(logn)
    warps = ntt_cuda.split_threads(logn) // 32
    assert len(items) == warps
    row_tiles = max(1, (1 << logn) // 128 // 16)
    cells = [(rt, nt) for its in items for rt, nt0, k in its
             for nt in range(nt0, nt0 + k)]
    assert sorted(cells) == [(rt, nt) for rt in range(row_tiles)
                             for nt in range(16)]
    if split > 1:
        assert all(len(its) == 1 for its in items)   # one barrier each
        return
    reads = [[_item_words(logn, it, True) for it in its] for its in items]
    for w, its in enumerate(items):
        for k, it in enumerate(its):
            written = _item_words(logn, it, False)
            for w2 in range(warps):
                for k2, r in enumerate(reads[w2]):
                    if w2 != w or k2 > k:
                        assert not written & r, (w, k, w2, k2)


def _emulate_tail_in_place(x, q, frag, pw8, order):
    """ntt_split_inv_kernel's tail in numpy: each polynomial in a padded
    shared array, the items of tail_schedule run in place, warps one
    after another in `order` (split = 1: any order is legal) or all
    reads before all writes (split > 1). Returns the unpadded arrays."""
    *batch, L, n = x.shape
    logn = n.bit_length() - 1
    items, split = ntt_cuda.tail_schedule(logn)
    idx = _padded(np.arange(n))
    flat = x.reshape(-1, L, n).astype(np.uint64)
    out = np.empty_like(flat)
    warps = range(len(items))
    for limb in range(L):
        b = _fragment_b(frag[limb])
        for p in range(flat.shape[0]):
            s = np.zeros(n + n // 32, np.uint64)
            s[idx] = flat[p, limb]

            def compute(item):
                rt, nt0, k = item
                rows = np.arange(16 * rt, min(16 * rt + 16, n // 128))
                words = _padded(128 * rows[:, None] + np.arange(128))
                res = _u8_rows(s[words], int(q[limb]), b, pw8[limb])
                cols = np.arange(8 * nt0, 8 * (nt0 + k))
                return words[:, cols], res[:, cols]

            if split > 1:
                done = [compute(it) for w in warps for it in items[w]]
                for words, res in done:
                    s[words] = res
            else:
                for w in (warps if order == "up" else reversed(warps)):
                    for it in items[w]:
                        words, res = compute(it)
                        s[words] = res
            out[p, limb] = s[idx]
    return out.reshape(x.shape)


@pytest.mark.parametrize("logn", [8, 10, 12])
def test_tail_in_place_emulation_matches_tail_plain(logn):
    """The inverse's tail in place, emulated with the kernel's u8
    fragment arithmetic and both warp orders, equals tail_plain (inverse
    map) on any-u32 input with extremes."""
    _, tr = _rings(logn)
    t = tr.split_tables()
    x = _inputs(logn, "u32", seed=logn + 130)
    x[0, :, :200] = 0xFFFFFFFF
    want = ntt_cuda.tail_plain(_t(x), tr.q, tr.r_inv, t.tail_inv,
                               t.tail_pow).numpy()
    for order in ("up", "down"):
        got = _emulate_tail_in_place(x, tr.q.numpy(), t.tail_inv_frag.numpy(),
                                     t.tail_pow8.numpy(), order)
        np.testing.assert_array_equal(got.astype(np.int64), want)


def _emulate_dit(x, q, bar, iwpack_pack, untwist_pack, reduce):
    """ntt_split_inv_kernel's DIT register passes in numpy, every block
    and thread at once: x (n_polys, L, N) u32 in padded shared arrays
    (Barrett below 2q first where `reduce`, the DIT-alone mode); each pass
    of split_inv_passes, each thread's groups of 2^R values
    (value_index), the twiddle each lane loads at each stage (checked:
    the top's position mod h, 32 neighbouring words a warp), the lazy
    butterflies (values < 4q), the untwist and csub in the last pass."""
    n_polys, L, n = x.shape
    logn = n.bit_length() - 1
    threads = ntt_cuda.split_threads(logn)
    lv = logn - (threads.bit_length() - 1)
    tid = np.arange(threads)
    qv = q.astype(np.uint64)[None, :, None]
    w_lo = iwpack_pack.view(np.uint64)[None]      # (1, L, N)
    u_lo = untwist_pack.view(np.uint64)[None]
    s = np.zeros((n_polys, L, n + n // 32), np.uint64)
    v0 = x.astype(np.uint64)
    if reduce:
        v0 = (v0 - ((v0 * bar.astype(np.uint64)[None, :, None])
                    >> np.uint64(32)) * qv) & M32
        assert np.all(v0 < 2 * qv)
    s[..., _padded(np.arange(n))] = v0
    out = np.zeros((n_polys, L, n), np.uint64)
    passes = ntt_cuda.split_inv_passes(logn)
    assert [r for _, r in passes] and passes[0][0] == 7
    for lo, r in passes:
        last = lo + r == logn
        stride = (1 << lo) + ((1 << lo) >> 5)
        for g in range((1 << lv) >> r):
            j0 = ntt_cuda.value_index(tid, threads, g, 0, lo, r)
            v = [s[..., _padded(j0) + c * stride] for c in range(1 << r)]
            for J in range(r):
                b = lo + J
                for low in range(1 << J):
                    widx = (n - (2 << b)) + (low << lo) + (j0 & ((1 << lo) - 1))
                    top = j0 | (low << lo)
                    assert np.array_equal(widx - (n - (2 << b)),
                                          top & ((1 << b) - 1))
                    assert np.all(np.diff(widx.reshape(-1, 32), axis=1) == 1)
                    w = w_lo[..., widx]
                    for hi in range(1 << (r - 1 - J)):
                        c0 = (hi << (J + 1)) | low
                        c1 = c0 | (1 << J)
                        a = _csub_np(v[c0], 2 * qv)
                        tt = _shoup_lazy_np(v[c1], w, qv)
                        v[c0] = (a + tt) & M32
                        v[c1] = (a - tt + 2 * qv) & M32
                        assert np.all(v[c0] < 4 * qv) and np.all(v[c1] < 4 * qv)
            for c in range(1 << r):
                j = j0 | (c << lo)
                if last:
                    val = _shoup_lazy_np(v[c], u_lo[..., j], qv)
                    out[..., j] = _csub_np(val, qv)
                else:
                    s[..., _padded(j0) + c * stride] = v[c]
    return out


def _csub_np(a, m):
    return np.minimum(a, (a - m) & M32)


def _shoup_lazy_np(a, w, q):
    """a * lo(w) - umulhi(a, hi(w)) * q mod 2^32, the high word taken in
    16-bit halves of a so that nothing wraps."""
    sh, b16 = w >> np.uint64(32), np.uint64(16)
    hi = ((a >> b16) * sh + (((a & np.uint64(0xFFFF)) * sh) >> b16)) >> b16
    return (a * (w & M32) - hi * q) & M32


M32 = np.uint64(0xFFFFFFFF)


@pytest.mark.parametrize("logn", [8, 9, 10, 11, 12, 13])
def test_dit_pass_emulation_matches_intt_tailed_plain(logn):
    """The DIT register passes, emulated on any-u32 input with extremes,
    equal intt_tailed_plain (DIT alone, Barrett first) and, after the
    plain tail, ntt_split_inv_plain (the fused mode)."""
    _, tr = _rings(logn)
    t = tr.split_tables()
    x = _inputs(logn, "u32", seed=logn + 140)
    x[0, :, :300] = 0xFFFFFFFF
    packs = (t.iwpack_pack.numpy(), t.untwist_pack.numpy())
    q, bar = tr.q.numpy(), tr.bar.numpy()
    want = ntt_cuda.intt_tailed_plain(_t(x), tr.q, tr.bar, t.iwpack,
                                      t.iwpack_sh, t.untwist, t.untwist_sh)
    got = _emulate_dit(x, q, bar, *packs, reduce=True)
    np.testing.assert_array_equal(got.astype(np.int64), want.numpy())
    tailed = ntt_cuda.tail_plain(_t(x), tr.q, tr.r_inv, t.tail_inv,
                                 t.tail_pow).numpy().astype(np.uint64)
    got = _emulate_dit(tailed, q, bar, *packs, reduce=False)
    want = ntt_cuda.ntt_split_inv_plain(_t(x), tr.q, tr.bar, tr.r_inv, t)
    np.testing.assert_array_equal(got.astype(np.int64), want.numpy())


def _worst_bank(words):
    """Largest number of distinct words one bank serves in one warp's
    access; words (threads, registers)."""
    worst = 1
    for w in words.reshape(-1, 32, words.shape[-1]).transpose(0, 2, 1
                                                              ).reshape(-1, 32):
        worst = max(worst, np.bincount(np.unique(w) % 32).max())
    return worst


@pytest.mark.parametrize("logn", range(ntt_cuda.SPLIT_MIN_LOGN,
                                       ntt_cuda.MAX_LOGN + 1))
def test_split_inv_shared_memory_accesses_are_conflict_free(logn):
    """Every warp access of the inverse's DIT passes (each register of each
    group, padded(j0) + c * stride) and of its 16-byte HBM read into
    shared memory (two words a lane) hits 32 banks; the passes cover the
    stages 7 .. logN - 1 once, each thread's values once a pass."""
    threads = ntt_cuda.split_threads(logn)
    lv = logn - (threads.bit_length() - 1)
    tid = np.arange(threads)[:, None]
    stages = []
    for lo, r in ntt_cuda.split_inv_passes(logn):
        assert 1 <= r <= ntt_cuda.MAX_PASS_BITS and r <= lv
        stages += list(range(lo, lo + r))
        stride = (1 << lo) + ((1 << lo) >> 5)
        idx = np.stack([ntt_cuda.value_index(tid, threads, g, c, lo, r)
                        for g in range((1 << lv) >> r)
                        for c in range(1 << r)], axis=-1)[:, 0, :]
        assert np.array_equal(np.sort(idx.ravel()), np.arange(1 << logn))
        words = np.stack([_padded(ntt_cuda.value_index(
            tid[:, 0], threads, g, 0, lo, r)) + c * stride
            for g in range((1 << lv) >> r) for c in range(1 << r)], axis=-1)
        assert np.array_equal(words, _padded(idx))
        assert _worst_bank(words) == 1, (lo, r)
    assert stages == list(range(7, logn))
    load = 2 * np.arange(threads)[:, None]
    for word in (_padded(load), _padded(load) + 1):
        assert _worst_bank(word) == 1


def test_split_inv_wrappers_reject_what_the_kernel_does_not_take():
    import dataclasses
    _, tr = _rings(8)
    t = tr.split_tables()
    x = _t(_inputs(8, "u32", seed=150))
    inv = ntt_cuda.ntt_split_inv
    consts = (tr.q, tr.bar, tr.r_inv)
    with pytest.raises(TypeError):
        inv(x.to(torch.int32), *consts, t)
    with pytest.raises(ValueError):
        inv(x, tr.q, tr.bar[:2], tr.r_inv, t)
    with pytest.raises(ValueError):
        inv(x, *consts, dataclasses.replace(
            t, iwpack_pack=t.iwpack_pack[:, :-1].contiguous()))
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.zeros(t.untwist_pack.numel() + 1, dtype=torch.int64)
        skewed = flat[1:].view(t.untwist_pack.shape)
        inv(x, *consts, dataclasses.replace(t, untwist_pack=skewed))
    with pytest.raises(ValueError):
        inv(x, *consts, dataclasses.replace(
            t, tail_inv_frag=t.tail_inv_frag.to(torch.int8)))
    with pytest.raises(ValueError):
        inv(x[..., :64], *consts, t)      # the kernel is built from logN 8
    args = (tr.q, tr.bar, t.iwpack, t.iwpack_sh, t.untwist, t.untwist_sh)
    with pytest.raises(ValueError):
        ntt_cuda.intt_tailed(x, *args, t.iwpack_pack[:2], t.untwist_pack)
    with pytest.raises(ValueError):
        ntt_cuda.intt_tailed(x, *args, t.iwpack_pack,
                             t.untwist_pack.to(torch.int32))
    assert torch.equal(inv(x, *consts, t), ntt_cuda.intt_tailed(
        ntt_cuda.tail(x, tr.q, tr.r_inv, t.tail_inv, t.tail_pow), *args,
        t.iwpack_pack, t.untwist_pack))


def test_ptxas_lines_name_each_kernel():
    """build()'s compiler report reads as kernel names with their template
    arguments, then spills and registers."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__3572db64"
        "_12_ntt_split_cu_6af7f84b20ntt_split_inv_kernelILi15ELb1EEEvN3dif4"
        "ArgsEPKhPKlS6_' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN45_GLOBAL",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110ntt"
        "_kernelILb1EEEvNS_4ArgsE' for 'sm_90a'",
        "ptxas info    : Compiling entry function 'plain_c_entry' for "
        "'sm_90a'"])
    assert ntt_cuda.ptxas_lines(log) == [
        "ntt_split_inv_kernel<15,1>",
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "Used 128 registers, used 1 barriers", "ntt_kernel<1>",
        "plain_c_entry"]


def test_kernel_name_reads_every_kernel_of_the_library():
    """kernel_name gives the fused decomposition's instantiations with
    their template arguments, and a kernel that is no template by its name
    alone."""
    assert ntt_cuda.kernel_name(
        "_ZN12_GLOBAL__N_120decompose_ntt_kernelILi15EEEvNS_4ArgsE"
    ) == "decompose_ntt_kernel<15>"
    assert ntt_cuda.kernel_name(
        "_ZN12_GLOBAL__N_116mul_accum_kernelEPKlS1_PlPKjNS_11ContractionEii"
    ) == "mul_accum_kernel"


def test_split_inv_bound_counts_its_bytes_and_operations():
    """profile_ntt's bound of the fused inverse: x read and written once
    (16 B a coefficient) with q, the packed untwist, the iwpack entries of
    the stages h >= 128 and the tail's fragment table and powers read
    once; at 8 x 32 x 2^15 the bytes bound it (153.0 MB, 0.0457 ms at
    3.35 TB/s). split_bound gives it for the inverse on a ring."""
    from mkhe_tpu_torch import profile_ntt
    L, n = 32, 1 << 15
    x = torch.empty((8, L, n), dtype=torch.int64)
    tables = (torch.empty(L, dtype=torch.int64),
              torch.empty((L, n), dtype=torch.int64),
              torch.empty((L, n - 128), dtype=torch.int64),
              torch.empty((L, *ntt_cuda.FRAG_SHAPE), dtype=torch.uint8),
              torch.empty((L, 7), dtype=torch.int64))
    nbytes = 16 * x.numel() + 8 * L + 8 * L * n + 8 * L * (n - 128) \
        + L * 65536 + 56 * L
    ms, by = profile_ntt.kernel_bound("ntt_split_inv", x, tables)
    assert by == "bytes" and ms == pytest.approx(
        1e3 * nbytes / profile_ntt.HBM_BYTES_PER_S, rel=1e-12)
    assert round(ms, 4) == 0.0457
    _, tr = _rings(10)
    xs = _t(_inputs(10, "u32", seed=160))
    t = tr.split_tables()
    assert profile_ntt.split_bound(tr, xs, False) == profile_ntt.kernel_bound(
        "ntt_split_inv", xs, (tr.q, t.untwist_pack, t.iwpack_pack[:, :-128],
                              t.tail_inv_frag, t.tail_pow8))
