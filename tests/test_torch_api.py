"""The port's public surface beyond the main paths (mkhe_tpu_torch) against
mkhe_tpu's, on the CPU at small logN:

  - the default CRS index set (with and without extra_crs) equals the JAX
    package's at logN 10 and 12; rotation and conjugation keys come from
    the port's own defaults, and the rotations and the conjugation
    decrypt within tests/test_mkckks.py's bound;
  - unsafe_skip_noise_guard: the port raises where JAX raises, and with
    the flag the alpha-4 configuration builds and its mult is destroyed
    (tests/test_alpha2.py::test_alpha4_noise_demonstrated);
  - mkckks.from_literal picks the JAX package's moduli, scale and slots;
  - IDSet, Ciphertext.c0 / party, new_ciphertext, pad_ciphertext,
    KeySet.delete / ids, new_message and the CNN module aliases;
  - the sparse and Gaussian secret keys, bit for bit given the same
    signed samples, and the law of the port's own samples; gaussian_rns
    and ternary_rns;
  - the four pt_ntt / ct_ntt combinations of encryption, bit for bit;
  - utils.crt and utils.security on random inputs.

Everything is bit for bit unless a tolerance is stated."""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mkhe_tpu import mkckks as jckks
from mkhe_tpu import mkrlwe as jrlwe
from mkhe_tpu.mkrlwe import encryptor as jenc
from mkhe_tpu.mkrlwe import keygen as jkg
from mkhe_tpu.ops import sampling as jsampling
from mkhe_tpu.ops.primes import ntt_primes
from mkhe_tpu.utils import crt as jcrt
from mkhe_tpu.utils import security as jsec
from mkhe_tpu_torch import convert
from mkhe_tpu_torch import mkckks as tckks
from mkhe_tpu_torch import mkrlwe as trlwe
from mkhe_tpu_torch.mkrlwe import encryptor as tenc
from mkhe_tpu_torch.mkrlwe import keygen as tkg
from mkhe_tpu_torch.ops import sampling as tsampling
from mkhe_tpu_torch.utils import crt as tcrt
from mkhe_tpu_torch.utils import security as tsec

torch.set_num_threads(1)

# tests/test_torch_rotation.py's alpha-2 recipe (logN 10, P of 4 limbs)
RECIPE = dict(logn=10, logslots=9, q0_bits=28.9, level_bits=20.0, levels=3,
              scale=2.0 ** 40, p_bits=28.0, p_count=4)
# tests/test_alpha2.py:100-103, rejected by the noise guard
ALPHA4 = dict(logn=9, logslots=8, q0_bits=28.9, level_bits=20.0, levels=3,
              scale=2.0 ** 40, p_bits=28.0, p_count=4, gamma=1)
USERS = ("user0", "user1")


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _same(got, want):
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))


def _bound(params):
    """tests/test_mkckks.py's, log2|err| <= -log2(scale) + logslots + 12."""
    return -math.log2(params.scale) + params.logslots + 12


def _log2_err(got, want):
    return math.log2(max(float(np.max(np.abs(got - want))), 1e-300))


# ----------------------------------------------------------------------------
# Default CRS, rotation and conjugation from the port's own parameters
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("logn", [10, 12])
@pytest.mark.parametrize("extra", [(), (3, 6, -5)])
def test_default_crs_indices_match_jax(logn, extra):
    q, p = ntt_primes(logn, 25.0, 4), ntt_primes(logn, 25.4, 2, skip=4)
    jp = jrlwe.new_parameters(logn, q, p, 2, extra_crs=extra)
    tp = trlwe.new_parameters(logn, q, p, 2, extra_crs=extra, device="cpu")
    assert sorted(tp.crs) == sorted(jp.crs)
    assert sorted(trlwe.params.default_crs_indices(logn, extra)) == sorted(
        jp.crs)
    for idx, a in tp.crs.items():
        assert tuple(a.shape) == tuple(jp.crs[idx].shape)
        assert a.dtype == torch.int64 and bool((a < tp.ring_qp.q[:, None]
                                                ).all())
    # add_crs draws what the defaults drew
    small = convert.rlwe_parameters(logn, q, p, 2, 3.2,
                                    {0: convert.to_numpy(tp.crs[0])},
                                    tp.crs_seed, "cpu")
    assert torch.equal(trlwe.add_crs(small, 2).crs[2], tp.crs[2])


@pytest.fixture(scope="module")
def port():
    """The port's defaults alone: keys for two parties, the default
    rotation keys and conjugation keys, two fresh encryptions."""
    params = tckks.new_parameters(**RECIPE, device="cpu")
    kgen = trlwe.KeyGenerator(params.rlwe, seed=91)
    sks, rlk = trlwe.SecretKeySet(), trlwe.RelinearizationKeySet()
    rtk, cjk = trlwe.RotationKeySet(), trlwe.ConjugationKeySet()
    pks = {}
    for uid in USERS:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        sks.add(sk)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
        kgen.gen_default_rotation_keys(sk, rtk)
        cjk.add(kgen.gen_conjugation_key(sk))
    enc = tckks.Encryptor(params, seed=92)
    rng = np.random.default_rng(93)
    msgs = [rng.uniform(-0.5, 0.5, params.slots)
            + 1j * rng.uniform(-0.5, 0.5, params.slots) for _ in USERS]
    cts = [enc.encrypt_msg(tckks.Message(value=m), pks[u])
           for m, u in zip(msgs, USERS)]
    return dict(params=params, kgen=kgen, sks=sks, rlk=rlk, rtk=rtk,
                cjk=cjk, pks=pks, msgs=msgs, cts=cts,
                ev=tckks.Evaluator(params), dec=tckks.Decryptor(params))


def test_rotation_and_conjugation_keys_from_defaults(port):
    """gen_rotation_key(1) and gen_conjugation_key need no add_crs; the
    default rotation keys are the powers of two below N/2."""
    params = port["params"]
    sk = port["sks"].get("user0")
    assert port["kgen"].gen_rotation_key(1, sk).rot_idx == 1
    assert port["kgen"].gen_conjugation_key(sk).id == "user0"
    assert sorted(port["rtk"].value["user1"]) == [
        1 << i for i in range(params.logn - 1)]


@pytest.mark.parametrize("rot", [1, 5, -1, 0])
def test_rotate_from_defaults_decrypts(port, rot):
    """1 and 4 have a CRS (one key switch each); 5 goes by 1 then 4 and
    -1 = 511 by its nine power-of-two steps; 0 returns ct itself."""
    ev, ct = port["ev"], port["ev"].add_new(*port["cts"])
    got = ev.rotate_new(ct, rot, port["rtk"])
    if rot == 0:
        assert got is ct
    assert got.ids == USERS and got.scale == ct.scale
    out = port["dec"].decrypt(got, port["sks"]).value
    assert _log2_err(out, np.roll(sum(port["msgs"]), -rot)) <= _bound(
        port["params"])


def test_conjugate_from_defaults_decrypts(port):
    ev, ct = port["ev"], port["ev"].add_new(*port["cts"])
    out = port["dec"].decrypt(ev.conjugate_new(ct, port["cjk"]), port["sks"])
    assert _log2_err(out.value, np.conj(sum(port["msgs"]))) <= _bound(
        port["params"])


def test_conjugation_key_names_a_missing_crs(port):
    rp = port["params"].rlwe
    params = dataclasses.replace(rp, crs={i: rp.crs[i] for i in (0, -1)})
    with pytest.raises(KeyError, match="conjugation"):
        trlwe.KeyGenerator(params).gen_conjugation_key(
            port["sks"].get("user0"))


# ----------------------------------------------------------------------------
# The noise guard
# ----------------------------------------------------------------------------

def test_noise_guard_raises_where_jax_raises():
    with pytest.raises(ValueError, match="gadget digit too large"):
        jckks.new_parameters(**ALPHA4)
    with pytest.raises(ValueError, match="gadget digit too large"):
        tckks.new_parameters(**ALPHA4, device="cpu")


def test_unsafe_skip_noise_guard_shows_the_mult_destroyed():
    """tests/test_alpha2.py::test_alpha4_noise_demonstrated on the port:
    with alpha = 4 (B ~ 2^98, P ~ 2^112) the t-path noise B^2/P swamps
    the product, which a correct mult gets within 2^-20 of."""
    params = tckks.new_parameters(**ALPHA4, unsafe_skip_noise_guard=True,
                                  device="cpu")
    assert params.rlwe.alpha == 4
    kgen = trlwe.KeyGenerator(params.rlwe, seed=71)
    sks, rlk, pks = trlwe.SecretKeySet(), trlwe.RelinearizationKeySet(), {}
    for uid in USERS:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        sks.add(sk)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
    enc = tckks.Encryptor(params, seed=72)
    rng = np.random.default_rng(12)
    m = [rng.uniform(0.2, 0.5, params.slots)
         + 1j * rng.uniform(0.2, 0.5, params.slots) for _ in USERS]
    cts = [enc.encrypt_msg(tckks.Message(value=v), pks[u])
           for v, u in zip(m, USERS)]
    out = tckks.Decryptor(params).decrypt(
        tckks.Evaluator(params).mul_relin_new(*cts, rlk), sks, exact=True)
    err = float(np.max(np.abs(out.value - m[0] * m[1])))
    assert err > 1e3, f"alpha=4 noise unexpectedly small: {err}"


# ----------------------------------------------------------------------------
# from_literal
# ----------------------------------------------------------------------------

def test_from_literal_matches_jax(tmp_path):
    """Q entries as an int, a hex string and bit sizes (one above 57.8
    bits: a triple of limbs), P as bit sizes; a dict and a path."""
    doc = {"LogN": 12, "LogSlots": 10, "Scale": 2.0 ** 30, "Gamma": 2,
           "Q": [(1 << 49) + 1, hex((1 << 45) + 7), 30.0, 58.5],
           "P": [52.0, 27.5]}
    path = tmp_path / "params.json"
    path.write_text(json.dumps(doc))
    want = jckks.from_literal(doc)
    for src in (doc, str(path)):
        got = tckks.from_literal(src, device="cpu")
        assert (got.logn, got.rlwe.q_moduli, got.rlwe.p_moduli, got.logslots,
                got.scale, got.rlwe.gamma) == (
            want.logn, want.rlwe.q_moduli, want.rlwe.p_moduli, want.logslots,
            want.scale, want.rlwe.gamma)
        assert sorted(got.rlwe.crs) == sorted(want.rlwe.crs)
    assert len(got.rlwe.q_moduli) == 2 + 2 + 2 + 3   # 58.5 bits: three


# ----------------------------------------------------------------------------
# IDSet, ciphertext helpers, KeySet.delete / ids, new_message, CNN aliases
# ----------------------------------------------------------------------------

def test_idset_behaves_as_jax():
    for cls in (jrlwe.IDSet, trlwe.IDSet):
        with pytest.raises(ValueError, match="reserved"):
            cls(["a", "0"])
        with pytest.raises(ValueError, match="reserved"):
            cls().add("0")
    ops = []
    for cls in (jrlwe.IDSet, trlwe.IDSet):
        a, b = cls(["c", "a"]), cls(["b", "c"])
        a.add("d")
        a.remove("d")
        a.remove("zz")
        u, i, c = a.union(b), a.intersection(b), a.copy()
        c.add("e")
        ops.append((a.as_tuple(), u.as_tuple(), i.as_tuple(), c.as_tuple(),
                    list(u), len(u), u.size(), "b" in u, u.has("a"),
                    i.has("a")))
    assert ops[0] == ops[1]


def test_ciphertext_helpers_match_jax():
    rng = np.random.default_rng(5)
    params = tckks.new_parameters(**RECIPE, device="cpu")
    data = rng.integers(0, 1 << 28, (3, 4, params.n)).astype(np.uint32)
    jct = jrlwe.Ciphertext(ids=("b", "d"), data=jnp.asarray(data))
    tct = convert.rlwe_ciphertext(("b", "d"), data, "cpu")
    _same(tct.c0, jct.c0)
    _same(tct.party("d"), jct.party("d"))
    for ids in (("a", "c"), ("d",), ("e", "b", "a")):
        want = jrlwe.pad_ciphertext(jct, ids)
        got = trlwe.pad_ciphertext(tct, ids)
        assert got.ids == want.ids
        _same(got.data, want.data)
    assert trlwe.pad_ciphertext(tct, ("d",)) is tct
    jparams = jckks.new_parameters(**RECIPE)
    want = jrlwe.new_ciphertext(jparams.rlwe, ("z", "a"), 2)
    got = trlwe.new_ciphertext(params.rlwe, ("z", "a"), 2)
    assert got.ids == want.ids and got.data.device.type == "cpu"
    _same(got.data, want.data)


def test_keyset_delete_and_ids_drop_the_stacks():
    rng = np.random.default_rng(6)

    def key(cls, pid, v):
        a = _t(rng.integers(0, 100, (2, 3, 8)) + v)
        return cls(b=a, d=a + 1, v=a + 2, id=pid)

    for jset, tset in ((jrlwe.SecretKeySet(), trlwe.SecretKeySet()),
                       (jrlwe.ConjugationKeySet(), trlwe.ConjugationKeySet())):
        for s in (jset, tset):
            for pid in ("c", "a", "b"):
                s.add(trlwe.SecretKey(id=pid, data=_t([1])))
            s.delete("b")
            s.delete("nobody")
        assert tset.ids() == jset.ids() == ("a", "c")
    rlk = trlwe.RelinearizationKeySet()
    for pid in ("a", "b"):
        rlk.add(key(trlwe.RelinearizationKey, pid, 0))
    first = rlk.stacked(("a", "b"))
    rlk.delete("b")
    assert rlk.ids() == ("a",)
    with pytest.raises(KeyError, match="'b'"):
        rlk.stacked(("a", "b"))
    rlk.add(key(trlwe.RelinearizationKey, "b", 1000))
    again = rlk.stacked(("a", "b"))
    assert torch.equal(again[0][1], rlk.get("b").b)
    assert not torch.equal(again[0][1], first[0][1])
    rtk = trlwe.RotationKeySet()
    rtk.add(trlwe.RotationKey(data=_t([[1]]), id="a", rot_idx=1))
    rtk.stacked(("a",), 1)
    rtk.delete("a")
    assert rtk.ids() == () and not rtk.has("a", 1)
    with pytest.raises(KeyError):
        rtk.stacked(("a",), 1)


def test_new_message_and_cnn_aliases_match_jax():
    from mkhe_tpu.models import cnn as jcnn
    from mkhe_tpu_torch.models import cnn as tcnn
    params = tckks.new_parameters(**RECIPE, device="cpu")
    for values in (None, np.arange(params.slots) * (1 + 2j), [1, 2.5]):
        want = jckks.new_message(params, values)
        got = tckks.new_message(params, values)
        assert got.value.dtype == want.value.dtype == np.complex128
        np.testing.assert_array_equal(got.value, want.value)
    for name in ("IMAGE", "NUM_KERNELS", "KSIZE", "BLOCK", "CONV_OUT",
                 "FC_UNITS", "CLASSES", "GAP", "EXTRA_ROTS"):
        assert getattr(tcnn, name) == getattr(jcnn, name), name


# ----------------------------------------------------------------------------
# Sparse and Gaussian secrets, RNS samplers, encryption's IsNTT flags
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def carried():
    """The JAX package's parameters, a key pair, and the port's copies
    (CRS 0 and -1)."""
    params = jckks.new_parameters(**RECIPE)
    rp = params.rlwe
    tp = convert.rlwe_parameters(
        rp.logn, rp.q_moduli, rp.p_moduli, rp.gamma, rp.sigma,
        {i: np.asarray(rp.crs[i]) for i in (0, -1)}, rp.crs_seed, "cpu")
    sk, pk = jrlwe.KeyGenerator(rp, seed=94).gen_key_pair("user0")
    return dict(rp=rp, tp=tp, pk=pk)


@pytest.mark.parametrize("kind,seed", [("sparse", 1), ("sparse", 2),
                                       ("gaussian", 3)])
def test_sparse_and_gaussian_secret_keys(carried, kind, seed):
    """The key of the port's own sample equals the JAX core's on the same
    signed sample; the sample has exactly hw non-zeros in {-1, 1}, or
    stays within the CDT's bound floor(6 sigma)."""
    rp, tp = carried["rp"], carried["tp"]
    hw = 64
    kgen = trlwe.KeyGenerator(tp, seed=seed)
    g = torch.Generator()
    g.manual_seed(seed)
    if kind == "sparse":
        sk = kgen.gen_secret_key_sparse("a", hw)
        s = tsampling.ternary_sparse(g, tp.n, hw, "cpu")
        assert int(torch.count_nonzero(s)) == hw
        assert set(s[s != 0].tolist()) <= {-1, 1}
    else:
        sk = kgen.gen_secret_key_gaussian("a")
        s = tsampling.gaussian(g, tp.n, "cpu", sigma=tp.sigma)
        assert int(s.abs().max()) <= math.floor(6 * tp.sigma)
        assert float(s.double().std()) > 1.0
    assert torch.equal(sk.data, tkg._secret_key_core(tp, s))
    _same(sk.data, jkg._secret_key_core(rp, jnp.asarray(s.numpy(),
                                                        jnp.int32)))


def test_sparse_sampler_law():
    """Over 200 draws at n = 64, hw = 16: every draw has 16 non-zeros, and
    every position and both signs turn up (bounds > 6 sigma wide)."""
    g = torch.Generator()
    g.manual_seed(4)
    draws = torch.stack([tsampling.ternary_sparse(g, 64, 16, "cpu")
                         for _ in range(200)])
    assert bool((torch.count_nonzero(draws, dim=1) == 16).all())
    hits = (draws != 0).sum(0)          # mean 50, sd ~6.1
    assert int(hits.min()) > 10 and int(hits.max()) < 90
    plus = int((draws == 1).sum())      # mean 1600, sd 28
    assert 1400 < plus < 1800


def test_rns_samplers_match_jax_lift(carried):
    rp, tp = carried["rp"], carried["tp"]
    ring, jring = tp.ring_q, rp.ring_q
    for fn, base in ((tsampling.gaussian_rns, tsampling.gaussian),
                     (tsampling.ternary_rns, tsampling.ternary)):
        g1, g2 = torch.Generator(), torch.Generator()
        g1.manual_seed(8)
        g2.manual_seed(8)
        got = fn(g1, ring, 2, 3)
        vals = base(g2, 6 * ring.n, "cpu").reshape(2, 3, ring.n)
        assert got.shape == (2, 3, ring.nlimbs, ring.n)
        _same(got, jsampling.lift_signed(jnp.asarray(vals.numpy(),
                                                     jnp.int32), jring))
        assert fn(g1, ring).shape == (ring.nlimbs, ring.n)


@pytest.mark.parametrize("pt_ntt,ct_ntt", [(False, False), (True, False),
                                           (False, True), (True, True)])
@pytest.mark.parametrize("has_pt", [True, False])
def test_encrypt_ntt_flags_bit_identical(carried, pt_ntt, ct_ntt, has_pt):
    """_encrypt_core's four IsNTT combinations, with and without a
    plaintext, against the JAX core on the same samples; an NTT-domain
    output is the NTT of the coefficient-domain one."""
    rp, tp, pk = carried["rp"], carried["tp"], carried["pk"]
    rng = np.random.default_rng(95)
    level = rp.max_level - 1
    ring, jring = tp.ring_q_at(level), rp.ring_q_at(level)
    n = rp.n
    u = rng.integers(-1, 2, n)
    e0, e1 = rng.integers(-19, 20, n), rng.integers(-19, 20, n)
    pt = rng.integers(0, np.array(rp.q_moduli[:level + 1])[:, None],
                      (level + 1, n)).astype(np.uint32)
    jpt = jnp.asarray(pt)
    if pt_ntt:
        jpt = jring.ntt(jpt)
    want = jenc._encrypt_core(rp, pk.data, jpt, *(jnp.asarray(x, jnp.int32)
                                                  for x in (u, e0, e1)),
                              level, has_pt, pt_ntt, ct_ntt)
    tpt = convert.tensor(np.asarray(jpt), "cpu") if has_pt else None
    args = (tp, convert.tensor(pk.data, "cpu"), tpt, _t(u), _t(e0), _t(e1),
            level)
    got = tenc._encrypt_core(*args, pt_ntt, ct_ntt)
    _same(got, want)
    if ct_ntt:
        assert torch.equal(ring.intt(got),
                           tenc._encrypt_core(*args, pt_ntt, False))


def test_encryptor_flags_decrypt(carried):
    """Encryptor.encrypt of an NTT-domain plaintext into an NTT-domain
    ciphertext decrypts (after an inverse NTT) to the plaintext, within
    the encryption noise."""
    tp = carried["tp"]
    kgen = trlwe.KeyGenerator(tp, seed=96)
    sk, pk = kgen.gen_key_pair("a")
    sks = trlwe.SecretKeySet()
    sks.add(sk)
    ring = tp.ring_q
    pt = tsampling.uniform(torch.Generator().manual_seed(1), ring)
    ct = trlwe.Encryptor(tp, seed=97).encrypt(ring.ntt(pt), pk, pt_ntt=True,
                                              ct_ntt=True)
    ct = trlwe.Ciphertext(ids=ct.ids, data=ring.intt(ct.data))
    diff = ring.sub(trlwe.Decryptor(tp).decrypt(ct, sks), pt)
    centered = torch.where(diff > ring.q[:, None] // 2,
                           diff - ring.q[:, None], diff)
    assert int(centered.abs().max()) < 1 << 12


# ----------------------------------------------------------------------------
# utils.crt and utils.security
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_crt_matches_jax(seed):
    rng = np.random.default_rng(seed)
    moduli = ntt_primes(10, 28.0, 5)
    limbs = rng.integers(0, np.array(moduli)[:, None], (5, 64)
                         ).astype(np.uint32)
    for fn in ("crt_reconstruct", "crt_center"):
        got, want = getattr(tcrt, fn)(limbs, moduli), getattr(jcrt, fn)(
            limbs, moduli)
        assert got.dtype == want.dtype == object
        assert list(got) == list(want)
    Q = math.prod(moduli)
    vals = [int(rng.integers(-(1 << 62), 1 << 62)) * int(
        rng.integers(1, 1 << 40)) % Q - Q // 2 for _ in range(64)]
    got = tcrt.to_rns(vals, moduli)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jcrt.to_rns(vals, moduli))
    assert list(tcrt.crt_center(got, moduli)) == vals
    for arr in (np.array(vals, dtype=object), np.zeros(3, dtype=object)):
        assert tcrt.log2_max_abs(arr) == jcrt.log2_max_abs(arr)


def test_security_matches_jax():
    rng = np.random.default_rng(7)
    for logn in range(10, 19):
        for total in rng.uniform(10, 8000, 40):
            assert tsec.security_bits(logn, total) == jsec.security_bits(
                logn, total)
        if logn <= 17:
            for lvl in (128, 192, 256):
                assert tsec.max_logqp(logn, lvl) == jsec.max_logqp(logn, lvl)
    for bad in ((9, 128), (15, 100)):
        for mod in (tsec, jsec):
            with pytest.raises(ValueError):
                mod.max_logqp(*bad)
    for logn, bits, count in ((15, 27.3, 28), (14, 26.6, 12), (12, 28.0, 6)):
        q, p = ntt_primes(logn, bits, count), ntt_primes(logn, 28.4, 4)
        assert tsec.logqp(q, p) == jsec.logqp(q, p)
        try:
            want = jsec.check_security(logn, q, p)
        except ValueError as e:
            with pytest.raises(ValueError, match="below 128-bit"):
                tsec.check_security(logn, q, p)
            assert "below 128-bit" in str(e)
        else:
            assert tsec.check_security(logn, q, p) == want
