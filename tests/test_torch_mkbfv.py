"""The port's MKBFV slice (mkhe_tpu_torch.mkbfv) against mkhe_tpu.mkbfv, bit
for bit, at both tests/test_mkbfv.py parameter sets (logN 9: alpha 1 with
5 + 5 limbs and P of 2, :18-22; alpha 2 with 6 + 6 limbs and P of 4,
:135-139), with the JAX package's CRS and keys carried by convert.py:

  - the preset moduli, the gadget scalars, the keygen cores fed the same
    numpy samples, encode / decode and encryption;
  - mod_up at the PN15QP880 Q <-> QMul moduli (Ls = 28, logN 15), and the
    double-basis conversions mod_up_q_to_r, rescale_q_to_r and quantize;
  - Evaluator.mul_relin_new and the hoisted mult at 2 and 4 parties, which
    also decrypt exactly to the plaintext product mod t;
  - the split NTT (config.ntt_mxu_tail) on and off give the same mult;
  - Evaluator.rotate_new (with a CRS of its own, and by power-of-two
    steps) and conjugate_new at 2 and 4 parties, with the split on and
    off, which also decrypt exactly to the rotated slot rows;
  - the port's own path, keys from torch.Generators, decrypts exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mkhe_tpu import mkbfv as jbfv
from mkhe_tpu import mkrlwe as jrlwe
from mkhe_tpu.mkbfv import basis as jbb
from mkhe_tpu.mkrlwe import encryptor as jenc
from mkhe_tpu.mkrlwe import keygen as jkg
from mkhe_tpu.ops import basis as jbasis
from mkhe_tpu.ops import ring as jring
from mkhe_tpu.ops.primes import ntt_primes
from mkhe_tpu_torch import config, convert
from mkhe_tpu_torch import mkbfv as tbfv
from mkhe_tpu_torch import mkrlwe as trlwe
from mkhe_tpu_torch.mkbfv import basis as tbb
from mkhe_tpu_torch.mkbfv import keygen as tbkg
from mkhe_tpu_torch.mkrlwe import encryptor as tenc
from mkhe_tpu_torch.mkrlwe import keygen as tkg
from mkhe_tpu_torch.ops import basis as tbasis
from mkhe_tpu_torch.ops import ring as tring

torch.set_num_threads(1)

LOGN = 9
T = 65537
ROTS = (1, 2)   # rotation keys: 3 goes by 1 then 2
USERS = tuple(f"user{i}" for i in range(4))
SETS = {   # tests/test_mkbfv.py:18-22 and :135-139
    1: (ntt_primes(LOGN, 26.5, 5), ntt_primes(LOGN, 26.5, 5, skip=5),
        ntt_primes(LOGN, 28.4, 2)),
    2: (ntt_primes(LOGN, 26.5, 6, skip=10), ntt_primes(LOGN, 26.5, 6, skip=16),
        ntt_primes(LOGN, 28.0, 4)),
}


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _same(got, want):
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))


def _cmod(x):
    r = np.mod(x, T)
    return np.where(r > T // 2, r - T, r)


def _msg(rng):
    return rng.integers(-(T // 2) + 1, T // 2, size=1 << LOGN, dtype=np.int64)


def carry_params(params):
    """JAX mkbfv Parameters -> the port's, same moduli and CRS."""
    rp = params.rlwe
    crs = {i: np.asarray(a) for i, a in rp.crs.items()}
    rl = convert.rlwe_parameters(rp.logn, rp.q_moduli, rp.p_moduli,
                                 rp.gamma, rp.sigma, crs, rp.crs_seed, "cpu")
    return convert.bfv_parameters(rl, params.qmul_moduli, params.t)


@pytest.fixture(scope="module", params=sorted(SETS))
def ctx(request):
    """JAX keys for 4 parties and fresh encryptions, with the port's
    copies."""
    alpha = request.param
    params = jbfv.new_parameters(LOGN, *SETS[alpha], t=T)
    assert params.rlwe.alpha == alpha
    kgen = jbfv.KeyGenerator(params, seed=61)
    sks, rlk, pks = jrlwe.SecretKeySet(), jbfv.RelinearizationKeySet(), {}
    for uid in USERS:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        sks.add(sk)
        rlk.add(kgen.gen_relinearization_key_bfv(sk, kgen.gen_secret_key(uid)))
    rkgen = jbfv.KeyGenerator(params, seed=64)
    rtk, cjk = jrlwe.RotationKeySet(), jrlwe.ConjugationKeySet()
    for uid in USERS:
        for r in ROTS:
            rtk.add(rkgen.gen_rotation_key(r, sks.get(uid)))
        cjk.add(rkgen.gen_conjugation_key(sks.get(uid)))
    rng = np.random.default_rng(62 + alpha)
    msgs = [_msg(rng) for _ in USERS]
    enc = jbfv.Encryptor(params, seed=63)
    cts = [enc.encrypt_msg(m, pks[uid]) for m, uid in zip(msgs, USERS)]
    tp = carry_params(params)
    t_sks = convert.secret_key_set(
        {uid: np.asarray(k.data) for uid, k in sks.value.items()}, "cpu")
    t_rlk = convert.relinearization_key_set(
        {uid: tuple(np.asarray(getattr(k, f)) for f in "bdv")
         for uid, k in rlk.value.items()}, "cpu")
    t_rtk = convert.rotation_key_set(
        {(uid, r): np.asarray(k.data) for uid, by_rot in rtk.value.items()
         for r, k in by_rot.items()}, "cpu")
    t_cjk = convert.conjugation_key_set(
        {uid: np.asarray(k.data) for uid, k in cjk.value.items()}, "cpu")
    return dict(params=params, tparams=tp, ev=jbfv.Evaluator(params),
                tev=tbfv.Evaluator(tp), rlk=rlk, t_rlk=t_rlk, t_sks=t_sks,
                rtk=rtk, cjk=cjk, t_rtk=t_rtk, t_cjk=t_cjk,
                pks=pks, msgs=msgs, cts=cts)


def _operands(ctx, k):
    """k = 2: user0 x user1; k = 4: (user0 + user1) x (user2 + user3)."""
    ev, cts, msgs = ctx["ev"], ctx["cts"], ctx["msgs"]
    if k == 2:
        return cts[0], cts[1], msgs[0] * msgs[1]
    return (ev.add_new(cts[0], cts[1]), ev.add_new(cts[2], cts[3]),
            (msgs[0] + msgs[1]) * (msgs[2] + msgs[3]))


def _to_port(ct):
    return convert.rlwe_ciphertext(ct.ids, np.asarray(ct.data), "cpu")


@pytest.mark.parametrize("k", [2, 4])
def test_mul_relin_bit_identical_and_exact(ctx, k):
    ct0, ct1, want_msg = _operands(ctx, k)
    want = ctx["ev"].mul_relin_new(ct0, ct1, ctx["rlk"])
    t0, t1 = _to_port(ct0), _to_port(ct1)
    got = ctx["tev"].mul_relin_new(t0, t1, ctx["t_rlk"])
    assert got.ids == want.ids == USERS[:k]
    _same(got.data, want.data)
    out = tbfv.Decryptor(ctx["tparams"]).decrypt(got, ctx["t_sks"])
    np.testing.assert_array_equal(out, _cmod(want_msg))


@pytest.mark.parametrize("k", [2, 4])
def test_mul_relin_hoisted_bit_identical(ctx, k):
    """Hoisted forms and the hoisted mult equal the JAX package's; the
    hoisted mult equals the plain one."""
    ct0, ct1, _ = _operands(ctx, k)
    jh0, jh1 = ctx["ev"].hoisted_form(ct0), ctx["ev"].hoisted_form(ct1)
    want = ctx["ev"].mul_relin_hoisted_new(jh0, jh1, ctx["rlk"])
    tev = ctx["tev"]
    th0, th1 = (tev.hoisted_form(_to_port(c)) for c in (ct0, ct1))
    for f in ("lift", "resc", "dec_lift", "dec_resc"):
        _same(getattr(th0, f), getattr(jh0, f))
    got = tev.mul_relin_hoisted_new(th0, th1, ctx["t_rlk"])
    _same(got.data, want.data)
    plain = tev.mul_relin_new(_to_port(ct0), _to_port(ct1), ctx["t_rlk"])
    assert torch.equal(got.data, plain.data)


def test_split_ntt_gives_the_same_mult(ctx):
    """The 4-party mult with the split NTT equals it without, as the
    switch flips off -> on -> off."""
    ct0, ct1, _ = _operands(ctx, 4)
    t0, t1 = _to_port(ct0), _to_port(ct1)
    outs = []
    try:
        for on in (False, True, False):
            config.ntt_mxu_tail = on
            outs.append(ctx["tev"].mul_relin_new(t0, t1, ctx["t_rlk"]).data)
    finally:
        config.ntt_mxu_tail = False
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("k,split", [(2, False), (4, True), (4, False)])
def test_rotate_and_conjugate_bit_identical(ctx, k, split):
    """rotate_new by 1 (its own CRS) and 3 (1 then 2), and conjugate_new,
    of the sum of k parties' ciphertexts: bit for bit the JAX package's,
    and exact: two rows of N/2, a rotation moves the columns of both rows
    (tests/test_mkbfv.py:121-131), conjugation swaps the rows."""
    jev, tev = ctx["ev"], ctx["tev"]
    ct = ctx["cts"][0]
    for c in ctx["cts"][1:k]:
        ct = jev.add_new(ct, c)
    m = _cmod(sum(ctx["msgs"][:k]))
    nh = (1 << LOGN) // 2
    dec = tbfv.Decryptor(ctx["tparams"])
    tct = _to_port(ct)
    try:
        config.ntt_mxu_tail = split
        for rot in (1, 3):
            want = jev.rotate_new(ct, rot, ctx["rtk"])
            got = tev.rotate_new(tct, rot, ctx["t_rtk"])
            assert got.ids == want.ids == USERS[:k]
            _same(got.data, want.data)
            np.testing.assert_array_equal(
                dec.decrypt(got, ctx["t_sks"]),
                np.concatenate([np.roll(m[:nh], -rot), np.roll(m[nh:], -rot)]))
        want = jev.conjugate_new(ct, ctx["cjk"])
        got = tev.conjugate_new(tct, ctx["t_cjk"])
        _same(got.data, want.data)
        np.testing.assert_array_equal(dec.decrypt(got, ctx["t_sks"]),
                                      np.concatenate([m[nh:], m[:nh]]))
        assert tev.rotate_new(tct, nh, ctx["t_rtk"]) is tct
    finally:
        config.ntt_mxu_tail = False


def test_rotate_without_a_crs_raises(ctx):
    """The port's parameters with the CRS 0, -1, -2, -3 and 1 alone: 3 =
    1 + 2 has no CRS at 2, so rotate_new raises a KeyError naming it."""
    rp = ctx["tparams"].rlwe
    limited = convert.rlwe_parameters(
        rp.logn, rp.q_moduli, rp.p_moduli, rp.gamma, rp.sigma,
        {i: convert.to_numpy(rp.crs[i]) for i in (0, -1, -2, -3, 1)},
        rp.crs_seed, "cpu")
    tev = tbfv.Evaluator(convert.bfv_parameters(
        limited, ctx["tparams"].qmul_moduli, T))
    with pytest.raises(KeyError, match=r"steps \[2\]"):
        tev.rotate_new(_to_port(ctx["cts"][0]), 3, ctx["t_rtk"])


def test_add_sub_bit_identical(ctx):
    """add_new / sub_new over different id sets (a party only in the
    second operand is negated by sub)."""
    jev, tev = ctx["ev"], ctx["tev"]
    a = jev.add_new(ctx["cts"][0], ctx["cts"][1])
    b = ctx["cts"][2]
    for jop, top in ((jev.add_new, tev.add_new), (jev.sub_new, tev.sub_new)):
        want = jop(a, b)
        got = top(_to_port(a), _to_port(b))
        assert got.ids == want.ids == USERS[:3]
        _same(got.data, want.data)


_j_mod_up = jax.jit(jbasis.mod_up)


@pytest.mark.parametrize("direction", ["q_to_qmul", "qmul_to_q"])
def test_mod_up_at_ls28_pn15(direction):
    """mod_up between the PN15QP880 Q and QMul moduli (28 limbs each,
    logN 15), where the float32 v-correction sums 28 terms."""
    logn, q, qmul, _ = tbfv.params.preset_moduli("PN15QP880")
    src, dst = (q, qmul) if direction == "q_to_qmul" else (qmul, q)
    rng = np.random.default_rng(71)
    x = (rng.integers(0, 1 << 62, (3, len(src), 1 << logn), dtype=np.uint64)
         % np.array(src, np.uint64)[:, None]).astype(np.uint32)
    js, jd = (jring.Ring.create(tuple(m), logn) for m in (src, dst))
    want = _j_mod_up(jnp.asarray(x), js, jd,
                     jbasis.mod_up_tables(tuple(src), tuple(dst)))
    ts, td = (tring.Ring.create(m, logn, "cpu") for m in (src, dst))
    got = tbasis.mod_up(_t(x), ts, td,
                        tbasis.mod_up_tables(ts.moduli, td.moduli, td.device))
    _same(got, want)


@pytest.mark.parametrize("fn", ["mod_up_q_to_r", "rescale_q_to_r",
                                "quantize"])
def test_double_basis_conversions_bit_identical(ctx, fn):
    params, tp = ctx["params"], ctx["tparams"]
    rng = np.random.default_rng(72)
    moduli = (params.rlwe.q_moduli if fn != "quantize"
              else params.ring_r.moduli)
    x = (rng.integers(0, 1 << 62, (3, len(moduli), 1 << LOGN),
                      dtype=np.uint64)
         % np.array(moduli, np.uint64)[:, None]).astype(np.uint32)
    want = jax.jit(getattr(jbb, fn))(params, jnp.asarray(x))
    _same(getattr(tbb, fn)(tp, _t(x)), want)


def test_keygen_bit_identical(ctx):
    """Gadget scalars, and the BFV relinearization key from the same
    numpy samples (the generators' gaussian draws replaced by them)."""
    params, tp = ctx["params"], ctx["tparams"]
    rp, trp = params.rlwe, tp.rlwe
    jk = jbfv.KeyGenerator(params, seed=73)
    tk = tbfv.KeyGenerator(tp, seed=73)
    assert list(tbkg.bfv_gadget_scalars(tp)) == jk._bfv_gadget_scalars()
    rng = np.random.default_rng(74)
    beta = rp.beta(rp.max_level)
    tern = lambda: rng.integers(-1, 2, rp.n).astype(np.int32)
    gauss = lambda b: np.clip(np.rint(rng.normal(0, 3.2, (b, rp.n))), -19,
                              19).astype(np.int32)
    s, r = tern(), tern()
    es = [gauss(2 * beta), gauss(2 * beta), gauss(beta)]
    jq = [jkg._gaussian_qp_core(rp, jnp.asarray(e)) for e in es]
    tq = [tkg._gaussian_qp_core(trp, _t(e)) for e in es]
    jk._gaussian_qp = lambda *batch: jq.pop(0)
    tk._gaussian_qp = lambda *batch: tq.pop(0)
    jsk, jr = (jrlwe.SecretKey(id="a", data=jkg._secret_key_core(
        rp, jnp.asarray(v))) for v in (s, r))
    tsk, tr = (trlwe.SecretKey(id="a", data=tkg._secret_key_core(trp, _t(v)))
               for v in (s, r))
    want = jk.gen_relinearization_key_bfv(jsk, jr)
    got = tk.gen_relinearization_key_bfv(tsk, tr)
    assert not jq and not tq
    for f in "bdv":
        _same(getattr(got, f), getattr(want, f))
    assert got.b.shape == (2 * beta, trp.qcount + trp.pcount, rp.n)


def test_encode_decode_and_encryption_bit_identical(ctx):
    from mkhe_tpu.mkbfv import encoder as jencoder
    params, tp = ctx["params"], ctx["tparams"]
    rp = params.rlwe
    rng = np.random.default_rng(75)
    m = _msg(rng)
    pt = jencoder.encode(params, m)
    tpt = tbfv.encoder.encode(tp, m)
    _same(tpt, pt)
    for poly in (pt, (rng.integers(0, 1 << 62, pt.shape, dtype=np.uint64)
                      % np.array(rp.q_moduli, np.uint64)[:, None]
                      ).astype(np.uint32)):
        np.testing.assert_array_equal(tbfv.encoder.decode(tp, _t(poly)),
                                      jencoder.decode(params, poly))
    np.testing.assert_array_equal(tbfv.encoder.decode(tp, tpt), _cmod(m))
    u = rng.integers(-1, 2, rp.n).astype(np.int32)
    e0, e1 = rng.integers(-19, 20, (2, rp.n)).astype(np.int32)
    pk = ctx["pks"]["user0"]
    want = jenc._encrypt_core(rp, pk.data, jnp.asarray(pt), jnp.asarray(u),
                              jnp.asarray(e0), jnp.asarray(e1), rp.max_level,
                              True)
    got = tenc._encrypt_core(tp.rlwe, _t(pk.data), tpt, _t(u), _t(e0),
                             _t(e1), rp.max_level)
    _same(got, want)


@pytest.mark.parametrize("preset", ["PN15QP880", "PN14QP439"])
def test_preset_moduli_match(preset):
    """The presets pick the JAX package's primes (mkhe_tpu/mkbfv/
    params.py:84-87, 95-98; no rings built)."""
    logn, bits, count = {"PN15QP880": (15, 27.3, 28),
                         "PN14QP439": (14, 26.6, 12)}[preset]
    assert tbfv.params.preset_moduli(preset) == (
        logn, ntt_primes(logn, bits, count),
        ntt_primes(logn, bits, count, skip=count), ntt_primes(logn, 28.4, 4))


def test_new_parameters_rejects_what_the_jax_package_rejects():
    q, qmul, p = SETS[2]
    with pytest.raises(ValueError, match="equal length"):
        tbfv.new_parameters(LOGN, q, qmul[:-1], p, device="cpu")
    with pytest.raises(ValueError, match="multiple of alpha"):
        tbfv.new_parameters(LOGN, q[:5], qmul[:5], p, device="cpu")


@pytest.mark.parametrize("k", [2, 4])
def test_port_generator_path(k):
    """Keys, encryption, mult and decryption from torch.Generators alone
    (alpha 2), with the split NTT on: exact."""
    params = tbfv.new_parameters(LOGN, *SETS[2], t=T, device="cpu")
    kgen = tbfv.KeyGenerator(params, seed=81)
    sks, rlk, pks = trlwe.SecretKeySet(), tbfv.RelinearizationKeySet(), {}
    for uid in USERS[:k]:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        sks.add(sk)
        rlk.add(kgen.gen_relinearization_key_bfv(sk, kgen.gen_secret_key(uid)))
    enc, ev = tbfv.Encryptor(params, seed=82), tbfv.Evaluator(params)
    dec = tbfv.Decryptor(params)
    rng = np.random.default_rng(83)
    msgs = [_msg(rng) for _ in range(k)]
    cts = [enc.encrypt_msg(m, pks[uid]) for m, uid in zip(msgs, USERS)]
    half = k // 2
    ct0, ct1 = cts[0], cts[half]
    for c in cts[1:half]:
        ct0 = ev.add_new(ct0, c)
    for c in cts[half + 1:]:
        ct1 = ev.add_new(ct1, c)
    want = _cmod(sum(msgs[:half]) * sum(msgs[half:]))
    try:
        config.ntt_mxu_tail = True
        res = ev.mul_relin_new(ct0, ct1, rlk)
        np.testing.assert_array_equal(dec.decrypt(res, sks), want)
        h0, h1 = ev.hoisted_form(ct0), ev.hoisted_form(ct1)
        hres = ev.mul_relin_hoisted_new(h0, h1, rlk)
    finally:
        config.ntt_mxu_tail = False
    assert res.ids == USERS[:k] and torch.equal(hres.data, res.data)
