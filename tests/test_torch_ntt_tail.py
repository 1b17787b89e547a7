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
