"""The port's basis conversion (mkhe_tpu_torch/ops/basis.py) against
mkhe_tpu/ops/basis.py, bit for bit: mod_up (ls = 1, 2, 4, including the
float32 v-correction), mod_down (2 and 4 P limbs), decompose_ntt
(alpha = 1, 2) and div_round_by_last_moduli (nb = 1, 2)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mkhe_tpu.ops import basis as jbasis
from mkhe_tpu.ops import ring as jring
from mkhe_tpu.ops.primes import ntt_primes
from mkhe_tpu_torch.ops import basis as tbasis
from mkhe_tpu_torch.ops import ring as tring

torch.set_num_threads(1)

LOGN = 8
Q = ntt_primes(LOGN, 28.9, 1) + ntt_primes(LOGN, 27.0, 5)
P = ntt_primes(LOGN, 28.4, 4)
BATCH = 3

_j_mod_up = jax.jit(jbasis.mod_up, static_argnames=("lazy",))
_j_mod_down = jax.jit(jbasis.mod_down)
_j_decompose = jax.jit(jbasis.decompose_ntt, static_argnames=("alpha",))
_j_div_round = jax.jit(jbasis.div_round_by_last_moduli,
                       static_argnames=("nb",))


def _rings(moduli):
    return (jring.Ring.create(tuple(moduli), LOGN),
            tring.Ring.create(moduli, LOGN, "cpu"))


def _canonical(moduli, seed, batch=(BATCH,)):
    rng = np.random.default_rng(seed)
    q = np.array(moduli, np.uint64)[:, None]
    x = rng.integers(0, 1 << 62, (*batch, len(moduli), 1 << LOGN),
                     dtype=np.uint64) % q
    return x.astype(np.uint32)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("ls", [1, 2, 4])
def test_mod_up(ls):
    """Q[:ls] -> QP, against the canonical and the lazy (< 4q, then
    reduced) JAX outputs. ls = 2 is the JAX Shoup fast path."""
    src, dst = Q[:ls], Q + P
    (js, ts), (jd, td) = _rings(src), _rings(dst)
    x = _canonical(src, seed=ls)
    got = tbasis.mod_up(_t(x), ts, td,
                        tbasis.mod_up_tables(src, dst, td.device))
    jt = jbasis.mod_up_tables(src, dst)
    _same(got, _j_mod_up(jnp.asarray(x), js, jd, jt))
    lazy = _j_mod_up(jnp.asarray(x), js, jd, jt, lazy=True)
    assert int(np.max(np.asarray(lazy) // np.array(dst)[:, None])) < 4
    _same(got, jd.reduce(lazy))


@pytest.mark.parametrize("lp", [2, 4])
def test_mod_down(lp):
    """round(x / P) from QP to Q; the P -> Q step is mod_up with ls = lp,
    whose float32 sum over 4 terms is where addition order could show."""
    (jq, tq), (jp, tp) = _rings(Q), _rings(P[:lp])
    xq, xp = _canonical(Q, seed=10 + lp), _canonical(P[:lp], seed=20 + lp)
    _same(tbasis.mod_down(_t(xq), _t(xp), tq, tp),
          _j_mod_down(jnp.asarray(xq), jnp.asarray(xp), jq, jp))


@pytest.mark.parametrize("alpha,lq", [(1, 6), (2, 6), (2, 5)])
def test_decompose_ntt(alpha, lq):
    """Digits (..., beta, Lqp, N) in the NTT domain; lq = 5 with alpha = 2
    leaves a one-limb last digit."""
    (jq, tq), (jqp, tqp) = _rings(Q[:lq]), _rings(Q[:lq] + P)
    x = _canonical(Q[:lq], seed=30 + alpha + lq)
    got = tbasis.decompose_ntt(_t(x), tq, tqp, alpha)
    assert got.shape == (BATCH, -(-lq // alpha), lq + len(P), 1 << LOGN)
    _same(got, _j_decompose(jnp.asarray(x), jq, jqp, alpha=alpha))


@pytest.mark.parametrize("nb", [1, 2])
def test_div_round_by_last_moduli(nb):
    jq, tq = _rings(Q)
    x = _canonical(Q, seed=40 + nb, batch=(2, BATCH))
    got = tbasis.div_round_by_last_moduli(_t(x), tq, nb)
    assert got.shape[-2] == len(Q) - nb
    _same(got, _j_div_round(jnp.asarray(x), jq, nb=nb))
