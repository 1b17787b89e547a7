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
    take / concat rings."""

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
    ntt_head then tail), and Ring.intt tail then intt_tailed."""
    _, tr = _rings(9)
    x = _t(_inputs(9, "u32", seed=90))
    want_f, want_i = tr.ntt(x), tr.intt(x)
    calls = []
    for name in ("ntt_split_fwd", "ntt_head", "tail", "intt_tailed", "ntt",
                 "intt"):
        real = getattr(ntt_cuda, name)
        monkeypatch.setattr(ntt_cuda, name,
                            lambda *a, _n=name, _f=real:
                            calls.append(_n) or _f(*a))
    assert torch.equal(tr.ntt(x), want_f)
    assert calls == ["ntt_split_fwd"]
    assert torch.equal(tr.intt(x), want_i)
    assert calls == ["ntt_split_fwd", "tail", "intt_tailed"]


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
    powers 2^(8t+32) mod q, the packed twist and wpack their words."""
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
                          (t.wpack_pack, t.wpack, t.wpack_sh)):
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
