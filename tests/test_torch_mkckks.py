"""The port's CKKS slice as a whole against mkhe_tpu, at the
tests/test_mkckks.py recipe (logN 10, alpha = 1):

  - the keygen cores, fed the same numpy signed samples, give bit-identical
    keys; encryption with the same samples is bit-identical;
  - Evaluator.mul_relin_new + rescale is bit-identical on state carried
    across by convert.py, and decrypts within the reference bound
    log2|err| <= -log2(scale) + logslots + 12 (tests/test_mkckks.py:58-64);
  - the port's own path (keys and encryptions from its own seeds, no JAX
    state) meets the bound for 2 and 4 parties;
  - importing the port loads no JAX.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mkhe_tpu import mkckks as jckks
from mkhe_tpu import mkrlwe as jrlwe
from mkhe_tpu.mkrlwe import encryptor as jenc
from mkhe_tpu.mkrlwe import keygen as jkg
from mkhe_tpu_torch import convert
from mkhe_tpu_torch import mkckks as tckks
from mkhe_tpu_torch import mkrlwe as trlwe
from mkhe_tpu_torch.mkrlwe import encryptor as tenc
from mkhe_tpu_torch.mkrlwe import keygen as tkg

torch.set_num_threads(1)

RECIPE = dict(logn=10, logslots=9, q0_bits=28.9, level_bits=20.0, levels=4,
              scale=2.0 ** 40, p_bits=28.4)
USERS = tuple(f"user{i}" for i in range(4))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bound(params):
    return -math.log2(params.scale) + params.logslots + 12


def _log2_err(got, want):
    return math.log2(max(float(np.max(np.abs(got - want))), 1e-300))


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _same(got, want):
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))


def _msgs(params, k, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.1 / k, 1.0 / k, params.slots)
            + 1j * rng.uniform(0.1 / k, 1.0 / k, params.slots)
            for _ in range(k)]


def _bench_operands(ev, cts, msgs):
    """ct0 = running sum, ct1 = running difference (bench.py:354-364)."""
    ct0 = ct1 = cts[0]
    for c in cts[1:]:
        ct0, ct1 = ev.add_new(ct0, c), ev.sub_new(ct1, c)
    want = sum(msgs) * (msgs[0] - sum(msgs[1:]))
    return ct0, ct1, want


@pytest.fixture(scope="module")
def jctx():
    params = jckks.new_parameters(**RECIPE)
    rp = params.rlwe
    crs = {i: np.asarray(rp.crs[i]) for i in (0, -1)}
    tp = convert.ckks_parameters(
        convert.rlwe_parameters(rp.logn, rp.q_moduli, rp.p_moduli, rp.gamma,
                                rp.sigma, crs, rp.crs_seed, "cpu"),
        params.logslots, params.scale)
    return dict(params=params, tparams=tp)


def test_keygen_cores_bit_identical(jctx):
    rp, tp = jctx["params"].rlwe, jctx["tparams"].rlwe
    n, beta = rp.n, rp.beta(rp.max_level)
    rng = np.random.default_rng(41)
    tern = lambda *s: rng.integers(-1, 2, (*s, n)).astype(np.int32)
    gauss = lambda *s: np.clip(np.rint(rng.normal(0, 3.2, (*s, n))), -19,
                               19).astype(np.int32)

    def both(jcore, tcore, *args):
        want = jcore(rp, *[jnp.asarray(a) for a in args])
        got = tcore(tp, *[_t(a) for a in args])
        _same(got, want)
        return np.asarray(want)

    s = both(jkg._secret_key_core, tkg._secret_key_core, tern())
    r = both(jkg._secret_key_core, tkg._secret_key_core, tern())
    e = both(jkg._gaussian_qp_core, tkg._gaussian_qp_core, gauss())
    both(jkg._public_key_core, tkg._public_key_core, e, s)
    eb = both(jkg._gaussian_qp_core, tkg._gaussian_qp_core, gauss(beta))
    both(jkg._relin_b_core, tkg._relin_b_core, eb, s)
    sg = both(jkg._switching_key_core, tkg._switching_key_core,
              both(jkg._gaussian_qp_core, tkg._gaussian_qp_core,
                   gauss(beta)), s)
    both(jkg._relin_d_core, tkg._relin_d_core, sg, r)
    rg = both(jkg._switching_key_core, tkg._switching_key_core,
              both(jkg._gaussian_qp_core, tkg._gaussian_qp_core,
                   gauss(beta)), r)
    both(jkg._relin_v_core, tkg._relin_v_core, rg, s)


def test_encryption_bit_identical(jctx):
    params = jctx["params"]
    rp, tp = params.rlwe, jctx["tparams"].rlwe
    kgen = jrlwe.KeyGenerator(rp, seed=42)
    _, pk = kgen.gen_key_pair("user0")
    level = rp.max_level
    pt = jckks.Encryptor(params).encode_msg(
        jckks.Message(value=_msgs(params, 1, 43)[0]))
    rng = np.random.default_rng(44)
    u = rng.integers(-1, 2, rp.n).astype(np.int32)
    e0, e1 = rng.integers(-19, 20, (2, rp.n)).astype(np.int32)
    want = jenc._encrypt_core(rp, pk.data, jnp.asarray(pt), jnp.asarray(u),
                              jnp.asarray(e0), jnp.asarray(e1), level, True)
    t_pk = convert.public_key_set({pk.id: np.asarray(pk.data)}, "cpu")
    got = tenc._encrypt_core(tp, t_pk.get(pk.id).data, _t(pt), _t(u),
                             _t(e0), _t(e1), level)
    _same(got, want)


@pytest.fixture(scope="module")
def carried(jctx):
    """JAX keys and 4 fresh encryptions, with the port's copies."""
    params = jctx["params"]
    kgen = jrlwe.KeyGenerator(params.rlwe, seed=45)
    sks, rlk, pks = jrlwe.SecretKeySet(), jrlwe.RelinearizationKeySet(), {}
    for uid in USERS:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        sks.add(sk)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
    msgs = _msgs(params, len(USERS), 46)
    enc = jckks.Encryptor(params, seed=47)
    cts = [enc.encrypt_msg(jckks.Message(value=m), pks[uid])
           for m, uid in zip(msgs, USERS)]
    t_sks = convert.secret_key_set(
        {uid: np.asarray(k.data) for uid, k in sks.value.items()}, "cpu")
    t_rlk = convert.relinearization_key_set(
        {uid: tuple(np.asarray(getattr(k, f)) for f in "bdv")
         for uid, k in rlk.value.items()}, "cpu")
    return dict(rlk=rlk, msgs=msgs, cts=cts, t_sks=t_sks, t_rlk=t_rlk)


def _to_port(ct):
    return convert.ckks_ciphertext(ct.ids, np.asarray(ct.ct.data), ct.scale,
                                   "cpu")


@pytest.mark.parametrize("k,square", [(4, False), (2, True)])
def test_mul_relin_new_bit_identical(jctx, carried, k, square):
    params, tp = jctx["params"], jctx["tparams"]
    jev, tev = jckks.Evaluator(params), tckks.Evaluator(tp)
    msgs = carried["msgs"][:k]
    ct0, ct1, want_msg = _bench_operands(jev, carried["cts"][:k], msgs)
    if square:
        ct1, want_msg = ct0, sum(msgs) ** 2
    want = jev.mul_relin_new(ct0, ct1, carried["rlk"])

    t0 = _to_port(ct0)
    got = tev.mul_relin_new(t0, t0 if square else _to_port(ct1),
                            carried["t_rlk"])
    assert got.ids == want.ids and got.scale == want.scale
    assert got.level == want.level < ct0.level
    _same(got.ct.data, want.ct.data)
    out = tckks.Decryptor(tp).decrypt(got, carried["t_sks"]).value
    assert _log2_err(out, want_msg) <= _bound(tp)


def test_add_sub_union_and_levels_bit_identical(jctx, carried):
    """add_new / sub_new over different id sets (a party only in the
    second operand is negated by sub) and different levels."""
    params, tp = jctx["params"], jctx["tparams"]
    jev, tev = jckks.Evaluator(params), tckks.Evaluator(tp)
    a = jev.add_new(carried["cts"][0], carried["cts"][1])
    b = jev.drop_level(carried["cts"][2], 1)
    for jop, top in ((jev.add_new, tev.add_new), (jev.sub_new, tev.sub_new)):
        want = jop(a, b)
        got = top(_to_port(a), _to_port(b))
        assert got.ids == want.ids == USERS[:3]
        assert got.level == want.level == a.level - 1
        _same(got.ct.data, want.ct.data)


def test_unequal_scales_raise(jctx, carried):
    """add_new aligns unequal scales (mult_by_const_new, checked against
    the JAX package in tests/test_torch_rotation.py), but the terms of a
    lazily relinearized inner product must share their product scale."""
    tev = tckks.Evaluator(jctx["tparams"])
    a, b = _to_port(carried["cts"][0]), _to_port(carried["cts"][1])
    doubled = tckks.Ciphertext(ct=b.ct, scale=b.scale * 4)
    assert tev.add_new(a, doubled).scale == doubled.scale
    with pytest.raises(ValueError, match="product scale"):
        tev.mul_relin_sum_new([(a, b), (a, doubled)], carried["t_rlk"])


def test_partial_decryptions_fold_to_the_full_decryption(jctx, carried):
    tp = jctx["tparams"]
    ct = _to_port(jckks.Evaluator(jctx["params"]).add_new(
        carried["cts"][0], carried["cts"][3])).ct
    dec = trlwe.Decryptor(tp.rlwe)
    full = dec.decrypt(ct, carried["t_sks"])
    for uid in ct.ids:
        ct = dec.partial_decrypt(ct, carried["t_sks"].get(uid))
    assert ct.ids == () and torch.equal(dec.decrypt(ct, None), full)


@pytest.mark.parametrize("preset", ["PN15QP880", "PN14QP439",
                                    "PN14QP433_CNN"])
def test_preset_moduli_match(preset):
    """The presets pick the JAX package's primes (no rings built)."""
    from mkhe_tpu.mkckks import params as jparams
    from mkhe_tpu_torch.mkckks import params as tparams
    args = {k: v for k, v in tparams._PRESETS[preset].items()
            if k not in ("logslots", "scale")}
    assert tparams.select_moduli(**args) == jparams.select_moduli(**args)


@pytest.mark.parametrize("levels", [1, 4])
def test_encoder_matches_jax(jctx, levels):
    """encode is bit-identical to the JAX package's; decode's fast 2-limb
    CRT and its exact python-int CRT (the JAX package may take its C++ one)
    give the JAX decode's values. At 1 level (2 limbs) decode picks the
    exact path by itself."""
    from mkhe_tpu.mkckks import encoder as jencoder
    from mkhe_tpu_torch.mkckks import encoder as tencoder
    params = jctx["params"]
    moduli = params.rlwe.q_moduli[:2 * levels]
    z = _msgs(params, 1, 61)[0]
    args = (params.scale, moduli, params.logn)
    pt = tencoder.encode(z, *args, logslots=params.logslots)
    np.testing.assert_array_equal(
        pt, jencoder.encode(z, *args, logslots=params.logslots))
    want = jencoder.decode(pt, *args, logslots=params.logslots)
    for exact in (None, True, False):
        got = tencoder.decode(pt, *args, logslots=params.logslots,
                              exact=exact)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
        assert _log2_err(got, z) <= _bound(params)


@pytest.mark.parametrize("logn", range(10, 19))
def test_security_table_matches_jax(logn):
    """The port's copy of the HE-Standard table (utils.security, which
    mkrlwe.new_parameters reads) agrees with mkhe_tpu.utils.security just
    inside and just outside each level's bound."""
    from mkhe_tpu.utils import security
    from mkhe_tpu_torch.utils import security as tsec
    for lvl in (128, 192, 256):
        cap = (security.max_logqp(logn, lvl) if logn <= 17 else
               int(security.max_logqp(17, lvl) * (1 << logn) / (1 << 17)))
        for total in (cap, cap + 0.5):
            assert tsec.security_bits(logn, total) == security.security_bits(
                logn, total)
        assert tsec.security_bits(logn, cap) >= lvl
        assert tsec.security_bits(logn, cap + 0.5) < lvl


@pytest.mark.parametrize("k", [2, 4])
def test_port_generator_path(k):
    """Keys, encryption, mult and decryption from the port's seeds alone
    (threefry keys, as the JAX package draws them)."""
    params = tckks.new_parameters(**RECIPE, device="cpu")
    kgen = trlwe.KeyGenerator(params.rlwe, seed=51)
    sks, rlk, pks = trlwe.SecretKeySet(), trlwe.RelinearizationKeySet(), {}
    for uid in USERS[:k]:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        sks.add(sk)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
    enc, ev = tckks.Encryptor(params, seed=52), tckks.Evaluator(params)
    msgs = _msgs(params, k, 53)
    cts = [enc.encrypt_msg(tckks.Message(value=m), pks[uid])
           for m, uid in zip(msgs, USERS)]
    ct0, ct1, want = _bench_operands(ev, cts, msgs)
    res = ev.mul_relin_new(ct0, ct1, rlk)
    assert res.ids == USERS[:k] and res.level == ct0.level - 2
    got = tckks.Decryptor(params).decrypt(res, sks).value
    assert _log2_err(got, want) <= _bound(params)


def test_port_imports_no_jax():
    """Neither JAX nor any module of the JAX package mkhe_tpu loads."""
    code = ("import json, sys\n"
            "import mkhe_tpu_torch, mkhe_tpu_torch.mkckks, "
            "mkhe_tpu_torch.mkbfv, mkhe_tpu_torch.convert, "
            "mkhe_tpu_torch.models, mkhe_tpu_torch.profile_cnn, "
            "mkhe_tpu_torch.profile_ntt, mkhe_tpu_torch.profile_ab, "
            "mkhe_tpu_torch.ntt_probe, mkhe_tpu_torch.utils.serialize, "
            "mkhe_tpu_torch.ops.threefry, mkhe_tpu_torch.profile_params, "
            "mkhe_tpu_torch.utils.oracle, mkhe_tpu_torch.utils.crt, "
            "mkhe_tpu_torch.examples.two_party_ckks, "
            "mkhe_tpu_torch.examples.two_party_bfv\n"
            "print(json.dumps(sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'jaxlib', 'mkhe_tpu'))))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
