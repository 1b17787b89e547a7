"""The port's whole-pipeline capture (mkhe_tpu_torch.fuse) against
mkhe_tpu.fuse, on the CPU route, bit for bit, with the JAX package's CRS,
keys and ciphertexts carried across by convert.py:

  - the CKKS pipeline of tests/test_fuse.py:43-72 (mult, rotate 3 by the
    power-of-two fallback, conjugate, add) at logN 10, 2 parties: the
    fused output equals the JAX package's fused output and the port's
    staged one; the recorded key requests equal the JAX recorder's, in
    order, and the recorded stacks its tables; the callable is reused
    with fresh inputs;
  - fuse_chained at k = 0 and k = 2 against the JAX package's
    fuse_chained, with the same sum feedback (benchmarks/_timing.py);
  - inputs, parameters or tables that differ from the recorded ones
    raise ValueError;
  - the BFV mult + add at logN 9 against the JAX package's staged
    mul_relin_new and add_new.

The card's own checks (capture equals eager, default capture mode, no
aliasing of results) are in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mkhe_tpu import fuse as jfuse
from mkhe_tpu import mkbfv as jbfv
from mkhe_tpu import mkckks as jckks
from mkhe_tpu import mkrlwe as jrlwe
from mkhe_tpu.ops.primes import ntt_primes
from mkhe_tpu_torch import convert
from mkhe_tpu_torch import fuse as tfuse
from mkhe_tpu_torch import mkckks as tckks
from mkhe_tpu_torch import mkrlwe as trlwe

torch.set_num_threads(1)

USERS = ("alice", "bob")
MASK32 = (1 << 32) - 1


def _same(got, want):
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))


def _to_port(ct):
    return convert.ckks_ciphertext(ct.ids, np.asarray(ct.ct.data), ct.scale,
                                   "cpu")


def _pipe(ev, keys, ct_a, ct_b):
    """tests/test_fuse.py:56-60, on either package's evaluator."""
    prod = ev.mul_relin_new(ct_a, ct_b, keys.rlk)
    rot = ev.rotate_new(prod, 3, keys.rtk)   # pow2 fallback: 1 + 2
    conj = ev.conjugate_new(rot, keys.cjk)
    return ev.add_new(conj, prod)


@pytest.fixture(scope="module")
def ckks():
    """tests/test_fuse.py:17-39's state, and the port's copy of it."""
    params = jckks.new_parameters(
        10, 9, q0_bits=28.9, level_bits=20.0, levels=4, scale=2.0 ** 40,
        p_bits=28.4)
    rp = params.rlwe
    kgen = jrlwe.KeyGenerator(rp, seed=31)
    pks, rlk = {}, jrlwe.RelinearizationKeySet()
    rtk, cjk = jrlwe.RotationKeySet(), jrlwe.ConjugationKeySet()
    for uid in USERS:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
        cjk.add(kgen.gen_conjugation_key(sk))
        kgen.gen_default_rotation_keys(sk, rtk)
    enc = jckks.Encryptor(params, seed=32)
    rng = np.random.default_rng(11)

    def fresh():
        s = params.slots
        return tuple(enc.encrypt_msg(jckks.Message(
            value=rng.uniform(-0.5, 0.5, s)
            + 1j * rng.uniform(-0.5, 0.5, s)), pks[uid]) for uid in USERS)

    tp = convert.ckks_parameters(
        convert.rlwe_parameters(rp.logn, rp.q_moduli, rp.p_moduli, rp.gamma,
                                rp.sigma, {i: np.asarray(a)
                                           for i, a in rp.crs.items()},
                                rp.crs_seed, "cpu"),
        params.logslots, params.scale)
    port = dict(
        params=tp,
        rlk=convert.relinearization_key_set(
            {u: tuple(np.asarray(getattr(k, f)) for f in "bdv")
             for u, k in rlk.value.items()}, "cpu"),
        rtk=convert.rotation_key_set(
            {(u, r): np.asarray(k.data) for u, by_rot in rtk.value.items()
             for r, k in by_rot.items()}, "cpu"),
        cjk=convert.conjugation_key_set(
            {u: np.asarray(k.data) for u, k in cjk.value.items()}, "cpu"))
    return dict(params=params, rlk=rlk, rtk=rtk, cjk=cjk, fresh=fresh,
                port=port)


def _port_fuse(c, cts, fuse=tfuse.fuse, **kw):
    p = c["port"]
    return fuse(p["params"], _pipe, tuple(_to_port(ct) for ct in cts),
                rlk_set=p["rlk"], rtk_set=p["rtk"], cjk_set=p["cjk"], **kw)


def _staged(c, cts):
    p = c["port"]
    keys = type("K", (), dict(rlk=p["rlk"], rtk=p["rtk"], cjk=p["cjk"]))()
    return _pipe(tckks.Evaluator(p["params"]), keys,
                 *(_to_port(ct) for ct in cts))


def _same_ct(got, want):
    assert got.ids == want.ids and got.scale == want.scale
    _same(got.ct.data, want.ct.data)


def test_fused_ckks_pipeline_matches_jax(ckks):
    c = ckks
    cts = c["fresh"]()
    jfn, jargs = jfuse.fuse(c["params"], _pipe, cts, rlk_set=c["rlk"],
                            rtk_set=c["rtk"], cjk_set=c["cjk"])
    fn, args = _port_fuse(c, cts)
    # the recorded requests, in order, and the recorded stacks
    assert ({n: list(t) for n, t in args[1].items()}
            == {n: list(t) for n, t in jargs[1].items()}
            == {"rlk": [USERS], "rtk": [(USERS, 1), (USERS, 2)],
                "cjk": [USERS]})
    for name, table in args[1].items():
        for k, stack in table.items():
            for got, want in zip(
                    stack if isinstance(stack, tuple) else (stack,),
                    jargs[1][name][k] if name == "rlk"
                    else (jargs[1][name][k],)):
                _same(got, want)
    out = fn(*args)
    assert isinstance(out, tckks.Ciphertext)
    _same_ct(out, jfn(*jargs))
    _same_ct(out, _staged(c, cts))
    # reuse with fresh inputs
    cts2 = c["fresh"]()
    out2 = fn(args[0], args[1], tuple(_to_port(ct) for ct in cts2))
    _same_ct(out2, jfn(jargs[0], jargs[1], cts2))
    _same_ct(out2, _staged(c, cts2))


def _jax_chain(cts, out):
    a = cts[0]
    w = jnp.sum(out.ct.data, dtype=jnp.uint32)
    return (jckks.Ciphertext(ct=jrlwe.Ciphertext(ids=a.ids,
                                                 data=a.ct.data ^ w),
                             scale=a.scale), cts[1])


def _port_chain(cts, out):
    """_jax_chain on int64 tensors of u32 values: the whole output's sum
    mod 2^32 XORed into the first input (benchmarks/_timing.py)."""
    a = cts[0]
    w = out.ct.data.sum() & MASK32
    return (tckks.Ciphertext(ct=trlwe.Ciphertext(ids=a.ids,
                                                 data=a.ct.data ^ w),
                             scale=a.scale), cts[1])


def test_fuse_chained_matches_jax(ckks):
    c = ckks
    cts = c["fresh"]()
    jrun, jargs = jfuse.fuse_chained(c["params"], _pipe, cts, _jax_chain,
                                     rlk_set=c["rlk"], rtk_set=c["rtk"],
                                     cjk_set=c["cjk"])
    run_k, args = _port_fuse(c, cts, tfuse.fuse_chained, chain=_port_chain)
    for k in (0, 2):
        want = jrun(*jargs, k)
        got = run_k(*args, k)
        _same_ct(got, want)
        staged = tuple(_to_port(ct) for ct in cts)
        p = c["port"]
        keys = type("K", (), dict(rlk=p["rlk"], rtk=p["rtk"],
                                  cjk=p["cjk"]))()
        ev = tckks.Evaluator(p["params"])
        for _ in range(k):
            staged = _port_chain(staged, _pipe(ev, keys, *staged))
        _same_ct(got, _pipe(ev, keys, *staged))


def test_mismatches_raise(ckks):
    c = ckks
    a, b = (_to_port(ct) for ct in c["fresh"]())
    fn, args = _port_fuse(c, c["fresh"]())
    ev = tckks.Evaluator(c["port"]["params"])
    with pytest.raises(ValueError, match="call fuse again"):
        fn(args[0], args[1], (a, ev.drop_level(b, 1)))        # level
    with pytest.raises(ValueError, match="call fuse again"):
        fn(args[0], args[1], (b, a))                          # ids
    with pytest.raises(ValueError, match="call fuse again"):
        fn(args[0], args[1], (a, tckks.Ciphertext(ct=b.ct,
                                                  scale=2 * b.scale)))
    with pytest.raises(ValueError, match="call fuse again"):
        fn(args[0], args[1], (a, b, a))                       # structure
    with pytest.raises(ValueError, match="call fuse again"):
        fn(c["port"]["params"].add_crs(5).rlwe, args[1], (a, b))
    with pytest.raises(ValueError, match="call fuse again"):
        fn(args[0], {"rlk": args[1]["rlk"]}, (a, b))          # tables
    with pytest.raises(TypeError):
        fn(args[0], args[1], (a, "b"))
    # other tables of the same requests and shapes are taken
    tables = {n: dict(t) for n, t in args[1].items()}
    _same_ct(fn(args[0], tables, (a, b)), fn(args[0], args[1], (a, b)))


def test_fused_bfv_matches_jax_staged():
    """tests/test_fuse.py:75-108's BFV pipeline (mult + add) at logN 9,
    against the JAX package's staged ops."""
    logn = 9
    params = jbfv.new_parameters(
        logn, ntt_primes(logn, 26.5, 5), ntt_primes(logn, 26.5, 5, skip=5),
        ntt_primes(logn, 28.4, 2), t=65537)
    kgen = jbfv.KeyGenerator(params, seed=33)
    pks, rlk = {}, jbfv.RelinearizationKeySet()
    for uid in USERS:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        rlk.add(kgen.gen_relinearization_key_bfv(sk,
                                                 kgen.gen_secret_key(uid)))
    enc = jbfv.Encryptor(params, seed=34)
    rng = np.random.default_rng(12)
    cts = [enc.encrypt_msg(rng.integers(0, 65537, params.n), pks[uid])
           for uid in USERS]

    def pipe(ev, keys, ct1, ct2):
        return ev.add_new(ev.mul_relin_new(ct1, ct2, keys.rlk), ct1)

    want = pipe(jbfv.Evaluator(params), type("K", (), dict(rlk=rlk))(),
                *cts)
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
    fn, args = tfuse.fuse(
        tp, pipe, tuple(convert.rlwe_ciphertext(c.ids, np.asarray(c.data),
                                                "cpu") for c in cts),
        rlk_set=t_rlk)
    assert args[0] is tp and list(args[1]) == ["rlk"]
    got = fn(*args)
    assert got.ids == want.ids == USERS
    _same(got.data, want.data)
