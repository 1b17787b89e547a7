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
    shared = [k for k in tring.TABLE_FIELDS if k != "r_inv"]
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
