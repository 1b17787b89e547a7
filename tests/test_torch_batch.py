"""The port's batched MulRelin (Evaluator.mul_relin_batched_new, CKKS and
BFV) against mkhe_tpu's, bit for bit, with the JAX package's CRS, keys and
ciphertexts carried across by convert.py:

  - CKKS at tests/test_mkckks.py's logN 10 parameters (:130-145), B = 3
    pairs of 2 parties: each output equals the JAX package's batched
    output and the port's mul_relin_new on its pair (scale and ids too),
    also for a batch of squares and at a lower level;
  - the validation errors of both evaluators;
  - BFV at logN 9 (tests/test_mkbfv.py:135-139, alpha 2), B = 2 pairs of
    a 1-party and a 2-party ciphertext, against the JAX package's
    mul_relin_new on each pair."""

import numpy as np
import pytest
import torch

from mkhe_tpu import mkbfv as jbfv
from mkhe_tpu import mkckks as jckks
from mkhe_tpu import mkrlwe as jrlwe
from mkhe_tpu.ops.primes import ntt_primes
from mkhe_tpu_torch import convert
from mkhe_tpu_torch import mkbfv as tbfv
from mkhe_tpu_torch import mkckks as tckks

torch.set_num_threads(1)

USERS = ("user0", "user1", "user2")
B = 3


def _same(got, want):
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))


def _to_port(ct):
    return convert.ckks_ciphertext(ct.ids, np.asarray(ct.ct.data), ct.scale,
                                   "cpu")


@pytest.fixture(scope="module")
def ckks():
    params = jckks.new_parameters(10, 9, q0_bits=28.9, level_bits=20.0,
                                  levels=4, scale=2.0 ** 40, p_bits=28.4)
    rp = params.rlwe
    kgen = jrlwe.KeyGenerator(rp, seed=91)
    pks, rlk = {}, jrlwe.RelinearizationKeySet()
    for uid in USERS[:2]:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
    enc = jckks.Encryptor(params, seed=92)
    rng = np.random.default_rng(93)

    def batch(uid):
        s = params.slots
        return [enc.encrypt_msg(jckks.Message(
            value=rng.uniform(-0.5, 0.5, s)
            + 1j * rng.uniform(-0.5, 0.5, s)), pks[uid]) for _ in range(B)]

    tp = convert.ckks_parameters(
        convert.rlwe_parameters(rp.logn, rp.q_moduli, rp.p_moduli, rp.gamma,
                                rp.sigma, {i: np.asarray(rp.crs[i])
                                           for i in (0, -1)},
                                rp.crs_seed, "cpu"),
        params.logslots, params.scale)
    t_rlk = convert.relinearization_key_set(
        {u: tuple(np.asarray(getattr(k, f)) for f in "bdv")
         for u, k in rlk.value.items()}, "cpu")
    return dict(ev=jckks.Evaluator(params), rlk=rlk, cts0=batch("user0"),
                cts1=batch("user1"), tev=tckks.Evaluator(tp), t_rlk=t_rlk)


def _check_batch(tev, t_rlk, t0, t1, got):
    assert len(got) == len(t0)
    for g, a, b in zip(got, t0, t1):
        want = tev.mul_relin_new(a, b, t_rlk)
        assert g.ids == want.ids and g.scale == want.scale
        assert torch.equal(g.ct.data, want.ct.data)


def test_ckks_batched_matches_jax_and_per_pair(ckks):
    c = ckks
    want = c["ev"].mul_relin_batched_new(c["cts0"], c["cts1"], c["rlk"])
    t0 = [_to_port(x) for x in c["cts0"]]
    t1 = [_to_port(x) for x in c["cts1"]]
    got = c["tev"].mul_relin_batched_new(t0, t1, c["t_rlk"])
    for g, w in zip(got, want):
        assert g.ids == w.ids and g.scale == w.scale
        assert g.ct.data.is_contiguous()
        _same(g.ct.data, w.ct.data)
    _check_batch(c["tev"], c["t_rlk"], t0, t1, got)


def test_ckks_batched_squares_and_lower_level(ckks):
    """A batch of squares (the pairs' operands are the same ciphertexts,
    which mul_relin_new takes as squares) and a batch one level down on
    one side (the other side dropped to it, as mul_relin_new does)."""
    c = ckks
    tev = c["tev"]
    t0 = [_to_port(x) for x in c["cts0"]]
    _check_batch(tev, c["t_rlk"], t0, t0,
                 tev.mul_relin_batched_new(t0, t0, c["t_rlk"]))
    low = [tev.drop_level(_to_port(x), 1) for x in c["cts1"]]
    _check_batch(tev, c["t_rlk"], t0, low,
                 tev.mul_relin_batched_new(t0, low, c["t_rlk"]))


def test_batched_validation_errors(ckks):
    c = ckks
    tev = c["tev"]
    t0 = [_to_port(x) for x in c["cts0"]]
    t1 = [_to_port(x) for x in c["cts1"]]
    with pytest.raises(ValueError, match="equal-length non-empty"):
        tev.mul_relin_batched_new([], [], c["t_rlk"])
    with pytest.raises(ValueError, match="equal-length non-empty"):
        tev.mul_relin_batched_new(t0, t1[:2], c["t_rlk"])
    for bad in ([t0[0], t1[1], t0[2]],                   # ids
                [t0[0], tev.drop_level(t0[1], 1), t0[2]],    # level
                [t0[0], tckks.Ciphertext(ct=t0[1].ct,
                                         scale=2 * t0[1].scale), t0[2]]):
        with pytest.raises(ValueError, match="ids, level, scale"):
            tev.mul_relin_batched_new(bad, t1, c["t_rlk"])
        with pytest.raises(ValueError, match="ids, level, scale"):
            tev.mul_relin_batched_new(t1, bad, c["t_rlk"])
    bev = tbfv.Evaluator(None)
    with pytest.raises(ValueError, match="equal-length non-empty"):
        bev.mul_relin_batched_new([t0[0].ct], [], None)
    with pytest.raises(ValueError, match="id tuple"):
        bev.mul_relin_batched_new([t0[0].ct, t1[0].ct],
                                  [t0[0].ct, t0[1].ct], None)


def test_bfv_batched_matches_jax_per_pair():
    logn = 9
    params = jbfv.new_parameters(
        logn, ntt_primes(logn, 26.5, 6, skip=10),
        ntt_primes(logn, 26.5, 6, skip=16), ntt_primes(logn, 28.0, 4),
        t=65537)
    kgen = jbfv.KeyGenerator(params, seed=94)
    pks, rlk = {}, jbfv.RelinearizationKeySet()
    for uid in USERS:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        rlk.add(kgen.gen_relinearization_key_bfv(sk,
                                                 kgen.gen_secret_key(uid)))
    enc = jbfv.Encryptor(params, seed=95)
    ev = jbfv.Evaluator(params)
    rng = np.random.default_rng(96)

    def ct(uid):
        return enc.encrypt_msg(rng.integers(0, 65537, params.n), pks[uid])

    cts0 = [ct("user0") for _ in range(2)]
    cts1 = [ev.add_new(ct("user1"), ct("user2")) for _ in range(2)]
    rp = params.rlwe
    tp = convert.bfv_parameters(
        convert.rlwe_parameters(rp.logn, rp.q_moduli, rp.p_moduli, rp.gamma,
                                rp.sigma, {i: np.asarray(rp.crs[i])
                                           for i in (0, -1, -3)},
                                rp.crs_seed, "cpu"),
        params.qmul_moduli, params.t)
    t_rlk = convert.relinearization_key_set(
        {u: tuple(np.asarray(getattr(k, f)) for f in "bdv")
         for u, k in rlk.value.items()}, "cpu")

    def port(cts):
        return [convert.rlwe_ciphertext(c.ids, np.asarray(c.data), "cpu")
                for c in cts]

    got = tbfv.Evaluator(tp).mul_relin_batched_new(port(cts0), port(cts1),
                                                   t_rlk)
    assert len(got) == 2
    for g, a, b in zip(got, cts0, cts1):
        want = ev.mul_relin_new(a, b, rlk)
        assert g.ids == want.ids == USERS
        _same(g.data, want.data)
