"""The port's modular primitives (mkhe_tpu_torch/ops/modmath.py) against
mkhe_tpu/ops/modmath.py on random u32 inputs: every ported primitive
returns the canonical value, bit-identical to the JAX primitive's
canonical result."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mkhe_tpu.ops import modmath as jmm
from mkhe_tpu.ops.primes import ntt_primes
from mkhe_tpu_torch.ops import modmath as tmm

torch.set_num_threads(1)

MODULI = ntt_primes(10, 28.9, 2) + ntt_primes(10, 20.0, 2) + \
    ntt_primes(10, 28.4, 1)
SIZE = 4096


@pytest.fixture(scope="module", params=MODULI)
def case(request):
    q = request.param
    rng = np.random.default_rng(q & 0xFFFF)
    return dict(
        q=q,
        a32=rng.integers(0, 1 << 32, SIZE, dtype=np.uint64).astype(np.uint32),
        a=rng.integers(0, q, SIZE, dtype=np.uint64).astype(np.uint32),
        b=rng.integers(0, q, SIZE, dtype=np.uint64).astype(np.uint32),
        w=np.uint32(rng.integers(0, q)))


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _same(got, want):
    got = got.numpy()
    want = np.asarray(want).astype(np.int64)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_add_sub_neg(case):
    q, a, b = case["q"], case["a"], case["b"]
    qj = jnp.uint32(q)
    _same(tmm.add_mod(_t(a), _t(b), q), jmm.add_mod(a, b, qj))
    _same(tmm.sub_mod(_t(a), _t(b), q), jmm.sub_mod(a, b, qj))
    _same(tmm.neg_mod(_t(a), q), jmm.neg_mod(a, qj))
    _same(tmm.csub(_t(a) + q // 2, q),
          jmm.csub(a + jnp.uint32(q // 2), qj))


def test_mul_hi32(case):
    a32, b = case["a32"], case["b"]
    b32 = a32[::-1].copy()
    _same(tmm.mul_hi32(_t(a32), _t(b32)), jmm.mul32_hi(a32, b32))
    _same(tmm.mul_hi32(_t(a32), _t(b)), jmm.mul32_hi(a32, b))


def test_montgomery(case):
    """mont_mul takes any u32 first operand (lazy), to/from_mont."""
    q, a32, a, b = case["q"], case["a32"], case["a"], case["b"]
    qinv_neg, r2 = jmm.mont_constants(q)
    r_inv, r2_t = tmm.mont_constants(q)
    assert r2_t == r2
    assert (r_inv << 32) % q == 1
    qj, qn = jnp.uint32(q), jnp.uint32(qinv_neg)
    _same(tmm.mont_mul(_t(a32), _t(b), q, r_inv),
          jmm.mont_mul(a32, b, qj, qn))
    _same(tmm.to_mont(_t(a), q, r_inv, r2),
          jmm.to_mont(a, qj, qn, jnp.uint32(r2)))
    _same(tmm.from_mont(_t(a32), q, r_inv), jmm.from_mont(a32, qj, qn))


def test_shoup_and_barrett(case):
    q, a32, w = case["q"], case["a32"], int(case["w"])
    w_sh = tmm.shoup_host(w, q)
    assert w_sh == jmm.shoup_host(w, q)
    _same(tmm.shoup_mul(_t(a32), w, w_sh, q),
          jmm.shoup_mul(a32, jnp.uint32(w), jnp.uint32(w_sh),
                        jnp.uint32(q)))
    bar = tmm.barrett_constant(q)
    assert bar == jmm.barrett_constant(q)
    _same(tmm.barrett_reduce(_t(a32), q, bar),
          jmm.barrett_reduce(a32, jnp.uint32(q), jnp.uint32(bar)))


@pytest.mark.parametrize("terms", [1, 17, 56])
def test_mul_accum(case, terms):
    """The reduced sum of up to 56 products (the PN15 party x digit
    contraction) equals the JAX 64-bit accumulate + Montgomery reduce,
    once that lazy result is reduced."""
    q = case["q"]
    rng = np.random.default_rng(terms)
    a = rng.integers(0, q, (terms, SIZE), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, q, (terms, SIZE), dtype=np.uint64).astype(np.uint32)
    qinv_neg, _ = jmm.mont_constants(q)
    qj = jnp.uint32(q)
    acc = jmm.mul_accum_init((SIZE,))
    for i in range(terms):
        acc = jmm.mul_accum_step(acc, a[i], b[i])
    want = jmm.mul_accum_reduce(acc, qj, jnp.uint32(qinv_neg))
    want = jmm.barrett_reduce(want, qj, jnp.uint32(jmm.barrett_constant(q)))
    r_inv, _ = tmm.mont_constants(q)
    got = tmm.mul_accum(zip(_t(a), _t(b)), q, r_inv)
    _same(got, want)
