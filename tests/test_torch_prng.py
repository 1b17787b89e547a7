"""The port's threefry (mkhe_tpu_torch.ops.threefry) and everything drawn
from it against jax.random and mkhe_tpu, on the CPU at small sizes, bit for
bit, with no state carried across by convert.py:

  - Threefry-2x32's known answers (Random123);
  - key / split / fold_in / bits at eight seeds and four shapes, also with
    the chunk of bits cut so that the draws cross chunk boundaries;
  - permutation at n = 1 .. 2^15 (0, 1 and 2 rounds of sorting);
  - every sampler under the same key as mkhe_tpu.ops.sampling;
  - new_parameters' CRS at every default index, extra_crs and add_crs, for
    a CKKS and a BFV recipe, from the crs_seed alone;
  - KeyGenerator(seed) and Encryptor(seed) outputs, CKKS and BFV;
  - the 2- and 4-party CKKS mult+relin+rescale and BFV mult from seeds;
  - (slow) the digests chip_smoke.py's phase 10 holds the card against,
    recomputed from the JAX package at full size.

The suite runs under jax_threefry_partitionable=True, the semantics the
port copies. Run this file as a script to rewrite the digests:

    JAX_PLATFORMS=cpu python tests/test_torch_prng.py
"""

import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mkhe_tpu import mkbfv as jbfv
from mkhe_tpu import mkckks as jckks
from mkhe_tpu import mkrlwe as jrlwe
from mkhe_tpu.ops import sampling as jsampling
from mkhe_tpu.ops.primes import ntt_primes
from mkhe_tpu_torch import convert, profile_params
from mkhe_tpu_torch import mkbfv as tbfv
from mkhe_tpu_torch import mkckks as tckks
from mkhe_tpu_torch import mkrlwe as trlwe
from mkhe_tpu_torch.ops import sampling as tsampling
from mkhe_tpu_torch.ops import threefry

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIGESTS = os.path.join(REPO, "tests", "torch_seed_digests.json")
SEEDS = (0, 1, 2, 99, 2 ** 31 - 1, 2 ** 31, 2 ** 32 + 5, -1)
SHAPES = ((), (7,), (3, 5, 7), (2, 3, 1 << 10))
# tests/test_torch_mkckks.py's recipe (logN 10, alpha 1) and
# tests/test_torch_mkbfv.py's alpha-2 set (logN 9, 6 + 6 limbs, P of 4)
CKKS = dict(logn=10, logslots=9, q0_bits=28.9, level_bits=20.0, levels=4,
            scale=2.0 ** 40, p_bits=28.4)
BFV_LOGN, T = 9, 65537
BFV = (ntt_primes(BFV_LOGN, 26.5, 6, skip=10),
       ntt_primes(BFV_LOGN, 26.5, 6, skip=16), ntt_primes(BFV_LOGN, 28.0, 4))
USERS = tuple(f"user{i}" for i in range(4))


def _kd(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def _same(got, want):
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))


def _same_keys(tk, jk):
    """Port and JAX key objects: every array field equal."""
    for f in ("data", "b", "d", "v"):
        if hasattr(jk, f):
            _same(getattr(tk, f), getattr(jk, f))


def test_partitionable_threefry_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("k,x,want", [
    ((0, 0), (0, 0), (0x6b200159, 0x99ba4efe)),
    ((2 ** 32 - 1,) * 2, (2 ** 32 - 1,) * 2, (0x1cb996fc, 0xbb002be7)),
    ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
     (0xc4923a9c, 0x483df7a0)),
])
def test_known_answers(k, x, want):
    """Random123's known answers, on python ints and on int64 tensors."""
    assert threefry.threefry2x32(*k, *x) == want
    y = threefry.threefry2x32(*k, *(torch.tensor([v]) for v in x))
    assert tuple(int(v) for v in y) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bits(seed):
    jk, tk = jax.random.key(seed), threefry.key(seed)
    assert _kd(jk) == tk
    for num in (2, 3):
        assert tuple(_kd(k) for k in jax.random.split(jk, num)) == \
            threefry.split(tk, num)
    for d in (0, 7, 2 ** 32 - 1):
        assert _kd(jax.random.fold_in(jk, d)) == threefry.fold_in(tk, d)
    for shape in SHAPES:
        got = threefry.bits(tk, shape, "cpu")
        assert got.shape == shape
        _same(got, jax.random.bits(jk, shape, jnp.uint32))


@pytest.mark.parametrize("chunk", [5, 1000])
def test_bits_across_chunks(monkeypatch, chunk):
    """Chunks that do not divide the draw give the one-pass bits."""
    monkeypatch.setattr(threefry, "CHUNK", chunk)
    for seed in (3, 2 ** 31):
        for shape in ((7,), (2, 3, 1 << 10)):
            _same(threefry.bits(threefry.key(seed), shape, "cpu"),
                  jax.random.bits(jax.random.key(seed), shape, jnp.uint32))


@pytest.mark.parametrize("n", [1, 2, 64, 1625, 1626, 4096, 1 << 15])
def test_permutation(n):
    """0 rounds at n = 1, 1 up to 1625, 2 from 1626 (ties among the
    2^15 32-bit sort keys need the stable sort)."""
    for seed in (5, 6):
        got = threefry.permutation(threefry.key(seed), n, "cpu")
        _same(got, jax.random.permutation(jax.random.key(seed), n))


@pytest.fixture(scope="module")
def ckks():
    """Both packages' CKKS parameters, each drawn from the crs_seed."""
    return jckks.new_parameters(**CKKS), tckks.new_parameters(**CKKS,
                                                              device="cpu")


@pytest.fixture(scope="module")
def bfv():
    return (jbfv.new_parameters(BFV_LOGN, *BFV, t=T),
            tbfv.new_parameters(BFV_LOGN, *BFV, t=T, device="cpu"))


@pytest.mark.parametrize("seed", [11, 2 ** 32 - 3])
def test_samplers(ckks, seed):
    """Each sampler of the port under a key equals mkhe_tpu's under the
    same key; uniform on the QP ring at logN 10 with a batch."""
    jp, tp = ckks[0].rlwe, ckks[1].rlwe
    jk, tk = jax.random.key(seed), threefry.key(seed)
    n = tp.n
    _same(tsampling.uniform(tk, tp.ring_qp, 3),
          jsampling.uniform(jk, jp.ring_qp, 3))
    _same(tsampling.uniform(tk, tp.ring_q), jsampling.uniform(jk, jp.ring_q))
    np.testing.assert_array_equal(tsampling.ternary(tk, n, "cpu").numpy(),
                                  jsampling.ternary(jk, n))
    np.testing.assert_array_equal(
        tsampling.gaussian(tk, n, "cpu", sigma=3.2).numpy(),
        jsampling.gaussian(jk, n, sigma=3.2))
    for hw in (1, 64, n):
        np.testing.assert_array_equal(
            tsampling.ternary_sparse(tk, n, hw, "cpu").numpy(),
            jsampling.ternary_sparse(jk, n, hw))
    for name in ("gaussian_rns", "ternary_rns"):
        for batch in ((), (2, 3)):
            _same(getattr(tsampling, name)(tk, tp.ring_q, *batch),
                  getattr(jsampling, name)(jk, jp.ring_q, *batch))


def _same_crs(tp, jp):
    assert sorted(tp.crs) == sorted(jp.crs)
    for idx, a in jp.crs.items():
        _same(tp.crs[idx], a)


@pytest.mark.parametrize("scheme", ["ckks", "bfv"])
def test_default_crs(ckks, bfv, scheme):
    """Every default CRS of new_parameters, from crs_seed alone."""
    jp, tp = ckks if scheme == "ckks" else bfv
    _same_crs(tp.rlwe, jp.rlwe)


@pytest.mark.parametrize("scheme", ["ckks", "bfv"])
def test_extra_and_added_crs(ckks, bfv, scheme):
    """extra_crs at construction and add_crs after it, at another
    crs_seed too."""
    jp, tp = (ckks if scheme == "ckks" else bfv)
    jp, tp = jp.rlwe, tp.rlwe
    args = (jp.logn, jp.q_moduli, jp.p_moduli, jp.gamma)
    for seed in (jp.crs_seed, 2 ** 32 + 9):
        extra = (5, 384, -7)
        jx = jrlwe.new_parameters(*args, crs_seed=seed, extra_crs=extra)
        tx = trlwe.new_parameters(*args, crs_seed=seed, extra_crs=extra,
                                  device="cpu")
        for idx in (3, -9):
            jx, tx = jrlwe.add_crs(jx, idx), trlwe.params.add_crs(tx, idx)
        _same_crs(tx, jx)


def _keys(kgen, bfv_keys):
    """One run of key generation, in one order for both packages."""
    sk, pk = kgen.gen_key_pair("user0")
    out = dict(sk=sk, pk=pk,
               sparse=kgen.gen_secret_key_sparse("user1", 64),
               gaussian=kgen.gen_secret_key_gaussian("user2"))
    r = kgen.gen_secret_key("user0")
    out["r"] = r
    out["rlk"] = (kgen.gen_relinearization_key_bfv(sk, r) if bfv_keys
                  else kgen.gen_relinearization_key(sk, r))
    out["rot1"] = kgen.gen_rotation_key(1, sk)
    out["rot2"] = kgen.gen_rotation_key(2, sk)
    out["cjk"] = kgen.gen_conjugation_key(sk)
    return out


@pytest.mark.parametrize("scheme", ["ckks", "bfv"])
def test_key_generator_from_seed(ckks, bfv, scheme):
    """sk, sparse sk, gaussian sk, pk, the relinearization key (BFV's
    fused pair for BFV), rotation keys 1 and 2 and the conjugation key."""
    if scheme == "ckks":
        (jp, tp), mod = ckks, (jrlwe, trlwe)
        jp, tp = jp.rlwe, tp.rlwe
    else:
        (jp, tp), mod = bfv, (jbfv, tbfv)
    want = _keys(mod[0].KeyGenerator(jp, seed=7), scheme == "bfv")
    got = _keys(mod[1].KeyGenerator(tp, seed=7), scheme == "bfv")
    for name, k in want.items():
        _same_keys(got[name], k)


@pytest.mark.parametrize("scheme", ["ckks", "bfv"])
@pytest.mark.parametrize("pt_ntt,ct_ntt", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_encryptor_from_seed(ckks, bfv, scheme, pt_ntt, ct_ntt):
    """Encryptor(seed): two encryptions of a plaintext and one of zero in
    a row, each equal to the JAX package's, for each IsNTT combination."""
    jp, tp = ckks if scheme == "ckks" else bfv
    jp, tp = jp.rlwe, tp.rlwe
    _, jpk = jrlwe.KeyGenerator(jp, seed=21).gen_key_pair("user0")
    _, tpk = trlwe.KeyGenerator(tp, seed=21).gen_key_pair("user0")
    level = jp.max_level - 1
    rng = np.random.default_rng(22)
    pt = rng.integers(0, np.array(jp.q_moduli[:level + 1])[:, None],
                      (level + 1, jp.n)).astype(np.uint32)
    jpt = jp.ring_q_at(level).ntt(jnp.asarray(pt)) if pt_ntt else \
        jnp.asarray(pt)
    tpt = convert.tensor(np.asarray(jpt), "cpu")
    jenc, tenc = jrlwe.Encryptor(jp, seed=23), trlwe.Encryptor(tp, seed=23)
    for p_j, p_t in ((jpt, tpt), (jpt, tpt), (None, None)):
        want = jenc.encrypt(p_j, jpk, level=level, pt_ntt=pt_ntt,
                            ct_ntt=ct_ntt)
        got = tenc.encrypt(p_t, tpk, level=level, pt_ntt=pt_ntt,
                           ct_ntt=ct_ntt)
        assert got.ids == want.ids
        _same(got.data, want.data)


def _ckks_mult(m, params, k):
    """k parties' keys and encryptions from seeds, the bench operands
    (running sum and difference) and one mul_relin_new."""
    kgen = m[1].KeyGenerator(params.rlwe, seed=51)
    rlk, pks = m[1].RelinearizationKeySet(), {}
    for uid in USERS[:k]:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
    enc, ev = m[0].Encryptor(params, seed=52), m[0].Evaluator(params)
    rng = np.random.default_rng(53)
    cts = [enc.encrypt_msg(m[0].Message(value=rng.uniform(-0.5, 0.5,
                                                          params.slots)),
                           pks[uid]) for uid in USERS[:k]]
    ct0 = ct1 = cts[0]
    for c in cts[1:]:
        ct0, ct1 = ev.add_new(ct0, c), ev.sub_new(ct1, c)
    return ev.mul_relin_new(ct0, ct1, rlk)


@pytest.mark.parametrize("k", [2, 4])
def test_ckks_mult_from_seeds(ckks, k):
    want = _ckks_mult((jckks, jrlwe), ckks[0], k)
    got = _ckks_mult((tckks, trlwe), ckks[1], k)
    assert got.ids == want.ids and got.scale == want.scale
    assert got.level == want.level
    _same(got.ct.data, want.ct.data)


def _bfv_mult(m, params, k):
    kgen = m.KeyGenerator(params, seed=81)
    rlk, pks = m.RelinearizationKeySet(), {}
    for uid in USERS[:k]:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        rlk.add(kgen.gen_relinearization_key_bfv(sk, kgen.gen_secret_key(uid)))
    enc, ev = m.Encryptor(params, seed=82), m.Evaluator(params)
    rng = np.random.default_rng(83)
    cts = [enc.encrypt_msg(rng.integers(-(T // 2) + 1, T // 2, params.n,
                                        dtype=np.int64), pks[uid])
           for uid in USERS[:k]]
    half = k // 2
    ct0, ct1 = cts[0], cts[half]
    for c in cts[1:half]:
        ct0 = ev.add_new(ct0, c)
    for c in cts[half + 1:]:
        ct1 = ev.add_new(ct1, c)
    return ev.mul_relin_new(ct0, ct1, rlk)


@pytest.mark.parametrize("k", [2, 4])
def test_bfv_mult_from_seeds(bfv, k):
    want = _bfv_mult(jbfv, bfv[0], k)
    got = _bfv_mult(tbfv, bfv[1], k)
    assert got.ids == want.ids
    _same(got.data, want.data)


# -- the digests of chip_smoke.py's phase 10 ---------------------------------

def _sha(a) -> str:
    """sha256 of an array's u32 words, little-endian, in the JAX layout."""
    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(a), dtype="<u4").tobytes()).hexdigest()


def test_port_digest_is_the_jax_layout(ckks):
    """convert.sha256_u32 (what chip_smoke.py hashes on the card) and
    _sha give one digest for one array."""
    jp, tp = ckks[0].rlwe, ckks[1].rlwe
    assert convert.sha256_u32(tp.crs[0]) == _sha(jp.crs[0])


def jax_digests() -> dict:
    """The JAX package's digests of the objects chip_smoke.py's phase 10
    makes on the card: every default CRS of CKKS and BFV PN15QP880 and of
    CKKS PN14QP433_CNN; at CKKS PN15QP880, KeyGenerator(seed=1)'s "user0"
    sk, pk and relinearization key (r its next secret key), and
    Encryptor(seed=2)'s encryption of the fixed plaintext
    profile_params.fixed_plaintext under that pk. One preset at a time."""
    out = {}
    for label, make in (("ckks_PN15QP880", jckks.PN15QP880),
                        ("bfv_PN15QP880", jbfv.PN15QP880),
                        ("ckks_PN14QP433_CNN", jckks.PN14QP433_CNN)):
        rp = make.__wrapped__().rlwe
        for idx, a in rp.crs.items():
            out[f"{label}/crs/{idx}"] = _sha(a)
        if label == "ckks_PN15QP880":
            kgen = jrlwe.KeyGenerator(rp, seed=1)
            sk, pk = kgen.gen_key_pair("user0")
            rlk = kgen.gen_relinearization_key(sk,
                                               kgen.gen_secret_key("user0"))
            out[f"{label}/sk"] = _sha(sk.data)
            out[f"{label}/pk"] = _sha(pk.data)
            for f in "bdv":
                out[f"{label}/rlk/{f}"] = _sha(getattr(rlk, f))
            pt = profile_params.fixed_plaintext(rp.q_moduli, rp.n,
                                                "cpu").numpy()
            ct = jrlwe.Encryptor(rp, seed=2).encrypt(
                jnp.asarray(pt.astype(np.uint32)), pk)
            out[f"{label}/ct"] = _sha(ct.data)
        del rp
    return out


@pytest.mark.slow
def test_seed_digests_match_jax():
    """The committed digests are the JAX package's (full size, minutes)."""
    with open(DIGESTS) as f:
        assert json.load(f) == jax_digests()


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    digests = jax_digests()
    with open(DIGESTS, "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(digests)} digests -> {DIGESTS}", file=sys.stderr)
