"""The port's rotation, conjugation, lazy-relin inner product, mul_ptxt and
mult_by_const (mkhe_tpu_torch) against mkhe_tpu's, bit for bit, with the
JAX package's CRS, keys and ciphertexts carried across by convert.py:

  - the Galois tables, and the automorphisms of Ring, for several gal;
  - the rotation and conjugation key cores, fed the same switching key
    and secret;
  - Evaluator.rotate_new at the top and a lower level, with positive,
    negative and non-power-of-two indices (with a CRS, and by the
    power-of-two fallback); the KeyError of a missing CRS;
    rotate_hoisted_new and rotate_hoisted_many_new (against the JAX
    package and against single hoisted rotations); conjugate_new;
  - mul_relin_sum_new with shared and separate hoisted forms;
  - mult_by_const_new with integer, fractional and imaginary constants,
    add_new of ciphertexts whose scales differ by 2x, and mul_ptxt_new.

Recipes: alpha = 1 is tests/test_mkckks.py's (logN 10, P of 2 limbs);
alpha = 2 has P of 4 limbs (logN 10), with 2- and 4-party ciphertexts."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mkhe_tpu import mkckks as jckks
from mkhe_tpu import mkrlwe as jrlwe
from mkhe_tpu.mkrlwe import keygen as jkg
from mkhe_tpu.ops import ring as jring
from mkhe_tpu.ops.primes import ntt_primes
from mkhe_tpu_torch import convert
from mkhe_tpu_torch import mkckks as tckks
from mkhe_tpu_torch import mkrlwe as trlwe
from mkhe_tpu_torch.mkrlwe import keygen as tkg
from mkhe_tpu_torch.ops import ring as tring

torch.set_num_threads(1)

USERS = tuple(f"user{i}" for i in range(4))
RECIPES = {
    1: dict(logn=10, logslots=9, q0_bits=28.9, level_bits=20.0, levels=4,
            scale=2.0 ** 40, p_bits=28.4),
    2: dict(logn=10, logslots=9, q0_bits=28.9, level_bits=20.0, levels=3,
            scale=2.0 ** 40, p_bits=28.0, p_count=4),
}
# rotation keys: 1 and 4 (the fallback's steps for 5), 6 (not a power of
# two, with its own CRS) and 511 (= -1 mod N/2). The port's parameters
# carry the JAX package's CRS at PORT_CRS alone (no CRS at 2), so rotating
# by 3 must raise.
ROTS = (1, 4, 6, 511)
PORT_CRS = (0, -1, -2) + ROTS


def _same(got, want):
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))


def _to_port(ct):
    return convert.ckks_ciphertext(ct.ids, np.asarray(ct.ct.data), ct.scale,
                                   "cpu")


@pytest.fixture(scope="module")
def ctx(request):
    alpha = request.param
    params = jckks.new_parameters(**RECIPES[alpha])
    assert params.rlwe.alpha == alpha
    for r in ROTS:
        params = params.add_crs(r)
    rp = params.rlwe
    kgen = jrlwe.KeyGenerator(rp, seed=71)
    sks, rlk = jrlwe.SecretKeySet(), jrlwe.RelinearizationKeySet()
    rtk, cjk = jrlwe.RotationKeySet(), jrlwe.ConjugationKeySet()
    pks = {}
    for uid in USERS:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        sks.add(sk)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
        for r in ROTS[:-1]:
            rtk.add(kgen.gen_rotation_key(r, sk))
        rtk.add(kgen.gen_rotation_key(-1, sk))
        cjk.add(kgen.gen_conjugation_key(sk))
    enc = jckks.Encryptor(params, seed=72)
    rng = np.random.default_rng(73)
    msgs = [rng.uniform(-0.5, 0.5, params.slots)
            + 1j * rng.uniform(-0.5, 0.5, params.slots) for _ in USERS]
    cts = [enc.encrypt_msg(jckks.Message(value=m), pks[uid])
           for m, uid in zip(msgs, USERS)]
    ev = jckks.Evaluator(params)
    tp = convert.ckks_parameters(
        convert.rlwe_parameters(rp.logn, rp.q_moduli, rp.p_moduli, rp.gamma,
                                rp.sigma, {i: np.asarray(rp.crs[i])
                                           for i in PORT_CRS},
                                rp.crs_seed, "cpu"),
        params.logslots, params.scale)
    port = dict(
        params=tp, ev=tckks.Evaluator(tp),
        sks=convert.secret_key_set(
            {u: np.asarray(k.data) for u, k in sks.value.items()}, "cpu"),
        rlk=convert.relinearization_key_set(
            {u: tuple(np.asarray(getattr(k, f)) for f in "bdv")
             for u, k in rlk.value.items()}, "cpu"),
        rtk=convert.rotation_key_set(
            {(u, r): np.asarray(k.data) for u, by_rot in rtk.value.items()
             for r, k in by_rot.items()}, "cpu"),
        cjk=convert.conjugation_key_set(
            {u: np.asarray(k.data) for u, k in cjk.value.items()}, "cpu"))
    return dict(alpha=alpha, params=params, ev=ev, sks=sks, rlk=rlk,
                rtk=rtk, cjk=cjk, msgs=msgs, cts=cts, port=port)


def _sum(ctx, k):
    """Sum of the first k parties' ciphertexts and of their messages."""
    ct = ctx["cts"][0]
    for c in ctx["cts"][1:k]:
        ct = ctx["ev"].add_new(ct, c)
    return ct, sum(ctx["msgs"][:k])


def _decrypt(ctx, ct):
    tp = ctx["port"]["params"]
    return tckks.Decryptor(tp).decrypt(ct, ctx["port"]["sks"]).value


def _close(got, want, ctx):
    """Decrypts within tests/test_mkckks.py's bound, 2^(-log2 scale +
    logslots + 12)."""
    tp = ctx["port"]["params"]
    bound = 2.0 ** (-np.log2(tp.scale) + tp.logslots + 12)
    assert np.max(np.abs(got - want)) <= bound


# ----------------------------------------------------------------------------
# Galois tables and keys
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("logn", [4, 10, 11])
def test_galois_tables_match_jax(logn):
    """The tables, and Ring.permute_coeffs / permute_ntt on random data,
    for rotations by 1, 3, 6 and N/4 slots, conjugation (2N - 1) and
    2N - 3."""
    n = 1 << logn
    gals = sorted({jring.galois_element_rot(k, n) for k in (1, 3, 6, n // 4)}
                  | {jring.galois_element_conj(n), 2 * n - 3})
    moduli = ntt_primes(logn, 28.0, 3)
    jr, tr = jring.Ring.create(moduli, logn), tring.Ring.create(moduli, logn,
                                                               "cpu")
    x = np.random.default_rng(logn).integers(
        0, np.array(moduli)[:, None], (2, 3, n)).astype(np.uint32)
    for gal in gals:
        src, sign = tring._coeff_perm_host(logn, gal)
        jsrc, jsign = jring._coeff_perm_host(logn, gal)
        assert src.dtype == jsrc.dtype and sign.dtype == jsign.dtype
        np.testing.assert_array_equal(src, jsrc)
        np.testing.assert_array_equal(sign, jsign)
        pi = tring._ntt_perm_host(logn, gal)
        assert pi.dtype == np.int32
        np.testing.assert_array_equal(pi, jring._ntt_perm_host(logn, gal))
        _same(tr.permute_coeffs(convert.tensor(x, "cpu"), gal),
              jr.permute_coeffs(jnp.asarray(x), gal))
        _same(tr.permute_ntt(convert.tensor(x, "cpu"), gal),
              jr.permute_ntt(jnp.asarray(x), gal))
    assert tring.galois_element_rot(5, n) == jring.galois_element_rot(5, n)
    assert tring.galois_element_conj(n) == jring.galois_element_conj(n)


@pytest.mark.parametrize("ctx", [1, 2], indirect=True)
def test_key_cores_bit_identical(ctx):
    """_rotation_key_core and _conjugation_key_core, given the JAX
    package's switching key and secret; and the conjugation key's secret
    permutation."""
    rp, tp = ctx["params"].rlwe, ctx["port"]["params"].rlwe
    n = rp.n
    kgen = jrlwe.KeyGenerator(rp, seed=74)
    sk = ctx["sks"].get("user0")
    sg = kgen.gen_switching_key(sk).data
    t_sg, t_s = convert.tensor(sg, "cpu"), convert.tensor(sk.data, "cpu")
    for r in (1, 6, 511):
        gal_inv = pow(jring.galois_element_rot(r, n), -1, 2 * n)
        _same(tkg._rotation_key_core(tp, t_sg, t_s, r, gal_inv),
              jkg._rotation_key_core(rp, sg, sk.data, r, gal_inv))
    _same(tkg._conjugation_key_core(tp, t_sg, t_s),
          jkg._conjugation_key_core(rp, sg, sk.data))
    gal = jring.galois_element_conj(n)
    _same(tp.ring_qp.permute_ntt(t_s, gal), rp.ring_qp.permute_ntt(sk.data,
                                                                   gal))


def test_port_keygen_normalises_and_checks_the_crs():
    """On parameters with an explicit, limited CRS dict (0, -1, -2, as
    convert.rlwe_parameters builds them) plus add_crs(511): -1 becomes
    511, and rotations 3 and 1 (gen_default_rotation_keys' first) raise
    for want of their CRS; add_crs(1) then draws the default CRS 1."""
    full = tckks.new_parameters(**RECIPES[1], device="cpu")
    rp = full.rlwe
    limited = convert.rlwe_parameters(
        rp.logn, rp.q_moduli, rp.p_moduli, rp.gamma, rp.sigma,
        {i: convert.to_numpy(rp.crs[i]) for i in (0, -1, -2)}, rp.crs_seed,
        "cpu")
    params = convert.ckks_parameters(limited, full.logslots,
                                     full.scale).add_crs(511)
    kgen = trlwe.KeyGenerator(params.rlwe, seed=75)
    sk = kgen.gen_secret_key("user0")
    assert kgen.gen_rotation_key(-1, sk).rot_idx == 511
    with pytest.raises(KeyError, match="no CRS for rotation 3"):
        kgen.gen_rotation_key(3, sk)
    rtk = trlwe.RotationKeySet()
    with pytest.raises(KeyError, match="no CRS for rotation 1"):
        kgen.gen_default_rotation_keys(sk, rtk)
    params = params.add_crs(1)
    assert trlwe.add_crs(params.rlwe, 1) is params.rlwe
    assert torch.equal(params.rlwe.crs[1], rp.crs[1])
    kgen = trlwe.KeyGenerator(params.rlwe, seed=75)
    key = kgen.gen_rotation_key(1, sk)
    rtk.add(key)
    assert rtk.has("user0", 1) and not rtk.has("user0", 2)
    assert torch.equal(rtk.stacked(("user0",), 1)[0], key.data)
    # a key added later replaces the memoised stack
    other = trlwe.RotationKey(id="user0", rot_idx=1, data=key.data + 0)
    rtk.add(other)
    assert rtk.stacked(("user0",), 1)[0] is not key.data


# ----------------------------------------------------------------------------
# Rotation and conjugation
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("ctx,k,rot,lower,hoisted", [
    (1, 2, 1, False, False), (1, 2, 6, True, True), (1, 2, -1, False, True),
    (1, 2, 5, True, False),
    (2, 4, 4, False, True), (2, 4, -1, True, False), (2, 4, 5, False, False),
    (2, 2, 6, True, True)], indirect=["ctx"])
def test_rotate_bit_identical(ctx, k, rot, lower, hoisted):
    """rotate_new (5 has no CRS: it goes by 1 then 4) or, hoisted at the
    top level, rotate_hoisted_new, at the top level or one level down."""
    jev, tev = ctx["ev"], ctx["port"]["ev"]
    ct, msg = _sum(ctx, k)
    h = jev.hoisted_form(ct) if hoisted else None
    th = (trlwe.HoistedCiphertext(ids=h.ids, digits=convert.tensor(
        h.digits, "cpu")) if hoisted else None)
    if lower:
        ct = jev.drop_level(ct, 1)
    if hoisted:
        want = jev.rotate_hoisted_new(ct, rot, h, ctx["rtk"])
        got = tev.rotate_hoisted_new(_to_port(ct), rot, th,
                                     ctx["port"]["rtk"])
    else:
        want = jev.rotate_new(ct, rot, ctx["rtk"])
        got = tev.rotate_new(_to_port(ct), rot, ctx["port"]["rtk"])
    assert got.ids == want.ids and got.scale == want.scale
    assert got.level == ct.level
    _same(got.ct.data, want.ct.data)
    _close(_decrypt(ctx, got), np.roll(msg, -rot), ctx)


@pytest.mark.parametrize("ctx", [1], indirect=True)
def test_rotate_without_crs_raises(ctx):
    """3 = 1 + 2 and the port's parameters (the JAX package's CRS at
    PORT_CRS alone, carried by convert.rlwe_parameters) have no CRS at 2:
    KeyError, no recursion."""
    tev, rtk = ctx["port"]["ev"], ctx["port"]["rtk"]
    ct = _to_port(ctx["cts"][0])
    with pytest.raises(KeyError, match=r"steps \[2\]"):
        tev.rotate_new(ct, 3, rtk)
    h = tev.hoisted_form(ct)
    with pytest.raises(KeyError, match="no CRS for rotation 5"):
        tev.rotate_hoisted_new(ct, 5, h, rtk)
    with pytest.raises(ValueError):
        tev.rotate_hoisted_many_new(ct, [1, 512], h, rtk)
    assert tev.rotate_new(ct, 512, rtk) is ct


@pytest.mark.parametrize("ctx,k,lower", [(1, 2, True), (2, 4, False)],
                         indirect=["ctx"])
def test_rotate_hoisted_many(ctx, k, lower):
    """rotate_hoisted_many_new against the JAX package's and against one
    rotate_hoisted_new per index."""
    jev, tev = ctx["ev"], ctx["port"]["ev"]
    ct, msg = _sum(ctx, k)
    h = jev.hoisted_form(ct)
    th = trlwe.HoistedCiphertext(ids=h.ids,
                                 digits=convert.tensor(h.digits, "cpu"))
    if lower:
        ct = jev.drop_level(ct, 1)
    idxs = [1, 6, -1, 4]
    want = jev.rotate_hoisted_many_new(ct, idxs, h, ctx["rtk"])
    tct = _to_port(ct)
    got = tev.rotate_hoisted_many_new(tct, idxs, th, ctx["port"]["rtk"])
    assert len(got) == len(want) == len(idxs)
    for g, w, r in zip(got, want, idxs):
        assert g.ids == w.ids and g.scale == w.scale
        _same(g.ct.data, w.ct.data)
        single = tev.rotate_hoisted_new(tct, r, th, ctx["port"]["rtk"])
        assert torch.equal(g.ct.data, single.ct.data)
    _close(_decrypt(ctx, got[2]), np.roll(msg, 1), ctx)


@pytest.mark.parametrize("ctx,k", [(1, 2), (2, 4)], indirect=["ctx"])
def test_conjugate_bit_identical(ctx, k):
    jev, tev = ctx["ev"], ctx["port"]["ev"]
    ct, msg = _sum(ctx, k)
    ct = jev.drop_level(ct, 1)
    want = jev.conjugate_new(ct, ctx["cjk"])
    got = tev.conjugate_new(_to_port(ct), ctx["port"]["cjk"])
    assert got.ids == want.ids and got.scale == want.scale
    _same(got.ct.data, want.ct.data)
    _close(_decrypt(ctx, got), np.conj(msg), ctx)


# ----------------------------------------------------------------------------
# Lazy-relin inner product, mul_ptxt, mult_by_const
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("ctx,shared", [(1, True), (2, False)],
                         indirect=["ctx"])
def test_mul_relin_sum_bit_identical(ctx, shared):
    """sum_i a_i b_i over three pairs with ids0 = (user0, user1) and ids1 =
    (user2, user3): hoisted forms shared across pairs (one b for all, and
    a hoisted pair with a plain one) or separate for every operand."""
    jev, tev = ctx["ev"], ctx["port"]["ev"]
    cts, msgs = ctx["cts"], ctx["msgs"]
    a = [jev.add_new(cts[0], cts[1]), jev.sub_new(cts[0], cts[1]),
         jev.add_new(cts[1], cts[0])]
    b = [jev.add_new(cts[2], cts[3]), jev.sub_new(cts[3], cts[2]),
         jev.add_new(cts[3], cts[2])]
    ma = [msgs[0] + msgs[1], msgs[0] - msgs[1], msgs[0] + msgs[1]]
    mb = [msgs[2] + msgs[3], msgs[3] - msgs[2], msgs[2] + msgs[3]]
    if shared:
        b[2] = b[0]
        mb[2] = mb[0]
        hb = jev.hoisted_form(b[0])
        jpairs = [(a[0], b[0], jev.hoisted_form(a[0]), hb),
                  (a[1], b[1]), (a[2], b[2], None, hb)]
    else:
        jpairs = [(x, y, jev.hoisted_form(x), jev.hoisted_form(y))
                  for x, y in zip(a, b)]
    want = jev.mul_relin_sum_new(jpairs, ctx["rlk"])

    def port(p):
        if len(p) == 2 or p[2] is None and p[3] is None:
            return tuple(_to_port(c) for c in p[:2])
        return (_to_port(p[0]), _to_port(p[1]),
                *(None if h is None else trlwe.HoistedCiphertext(
                    ids=h.ids, digits=convert.tensor(h.digits, "cpu"))
                  for h in p[2:]))
    tpairs = [port(p) for p in jpairs]
    if shared:   # the same object for the shared hoisted form
        tpairs[2] = (*tpairs[2][:3], tpairs[0][3])
    got = tev.mul_relin_sum_new(tpairs, ctx["port"]["rlk"])
    assert got.ids == want.ids == USERS and got.scale == want.scale
    assert got.level == want.level < a[0].level
    _same(got.ct.data, want.ct.data)
    _close(_decrypt(ctx, got), sum(x * y for x, y in zip(ma, mb)), ctx)


@pytest.mark.parametrize("ctx,const", [(1, 3), (1, 0.5), (2, 2j),
                                       (2, -1.5 + 0.25j)], indirect=["ctx"])
def test_mult_by_const_bit_identical(ctx, const):
    """Integer constants keep the scale; fractional ones multiply it by
    q_level; an imaginary part goes through X^(N/2)."""
    ct, msg = _sum(ctx, 2)
    want = ctx["ev"].mult_by_const_new(ct, const)
    got = ctx["port"]["ev"].mult_by_const_new(_to_port(ct), const)
    assert got.scale == want.scale
    _same(got.ct.data, want.ct.data)
    _close(_decrypt(ctx, got), msg * const, ctx)


@pytest.mark.parametrize("ctx", [2], indirect=True)
def test_add_aligns_scales_2x_apart(ctx):
    """The second operand's scale is twice the first's: add_new multiplies
    the first by 2 (integer MultByConst) before adding, on either side."""
    jev, tev = ctx["ev"], ctx["port"]["ev"]
    a, b = ctx["cts"][0], ctx["cts"][1]
    b2 = jckks.Ciphertext(ct=b.ct, scale=b.scale * 2)
    for x, y in ((a, b2), (b2, a)):
        for jop, top in ((jev.add_new, tev.add_new),
                         (jev.sub_new, tev.sub_new)):
            want = jop(x, y)
            got = top(_to_port(x), _to_port(y))
            assert got.scale == want.scale == b2.scale
            _same(got.ct.data, want.ct.data)


@pytest.mark.parametrize("ctx,lower", [(1, False), (2, True)],
                         indirect=["ctx"])
def test_mul_ptxt_bit_identical(ctx, lower):
    params = ctx["params"]
    jev, tev = ctx["ev"], ctx["port"]["ev"]
    ct, msg = _sum(ctx, 2)
    if lower:
        ct = jev.drop_level(ct, 2)
    m = np.random.default_rng(76).uniform(-1, 1, params.slots)
    pt = jckks.Encryptor(params).encode_msg(jckks.Message(value=m))
    want = jev.mul_ptxt_new(ct, pt, params.scale)
    for tpt in (pt, convert.tensor(pt, "cpu")):
        got = tev.mul_ptxt_new(_to_port(ct), tpt, params.scale)
        assert got.scale == want.scale and got.level == want.level
        _same(got.ct.data, want.ct.data)
    _close(_decrypt(ctx, got), msg * m, ctx)


def test_encrypt_ptxt_decrypts():
    params = tckks.new_parameters(**RECIPES[1], device="cpu")
    kgen = trlwe.KeyGenerator(params.rlwe, seed=77)
    sks = trlwe.SecretKeySet()
    sk, pk = kgen.gen_key_pair("user0")
    sks.add(sk)
    enc = tckks.Encryptor(params, seed=78)
    m = np.random.default_rng(79).uniform(-1, 1, params.slots)
    pt = enc.encode_msg(tckks.Message(value=m), level=2)
    ct = enc.encrypt_ptxt(pt, pk, params.scale)
    assert ct.ids == ("user0",) and ct.level == 2
    got = tckks.Decryptor(params).decrypt(ct, sks).value
    assert np.max(np.abs(got - m)) <= 2.0 ** (-40 + 9 + 12)
