"""The port's KKLSS multiply-relinearize (mkhe_tpu_torch/mkrlwe/keyswitch.py
mul_and_relin) against mkhe_tpu's, bit for bit, with the JAX package's
CRS, relinearization keys and ciphertexts carried across by
mkhe_tpu_torch/convert.py.

Recipes: alpha = 1 is tests/test_mkckks.py's (logN 10, P of 2 limbs),
alpha = 2 is tests/test_alpha2.py's (logN 9, P of 4 limbs). Operands:
k-party running sum x running difference (the bench's distinct
operands), a square, and two 2-party ciphertexts over disjoint id sets
(the 4-party union). The tensor terms' plain version against the torch
chain the port ran before the tensor kernel, bit for bit."""

import functools

import numpy as np
import pytest
import torch

import jax

from mkhe_tpu import mkckks as jckks
from mkhe_tpu import mkrlwe as jrlwe
from mkhe_tpu.mkrlwe import keyswitch as jksw
from mkhe_tpu_torch import convert
from mkhe_tpu_torch.mkrlwe import keyswitch as tksw
from mkhe_tpu_torch.ops import basis_cuda
from mkhe_tpu_torch.ops.primes import ntt_primes
from mkhe_tpu_torch.ops.ring import Ring

torch.set_num_threads(1)

USERS = tuple(f"user{i}" for i in range(4))
RECIPES = {
    1: dict(logn=10, logslots=9, q0_bits=28.9, level_bits=20.0, levels=4,
            scale=2.0 ** 40, p_bits=28.4),
    2: dict(logn=9, logslots=8, q0_bits=28.9, level_bits=20.0, levels=3,
            scale=2.0 ** 40, p_bits=28.0, p_count=4),
}


def carry_params(params):
    """JAX mkckks Parameters -> the port's, same moduli and CRS."""
    rp = params.rlwe
    crs = {i: np.asarray(rp.crs[i]) for i in (0, -1)}
    rl = convert.rlwe_parameters(rp.logn, rp.q_moduli, rp.p_moduli,
                                 rp.gamma, rp.sigma, crs, rp.crs_seed, "cpu")
    return convert.ckks_parameters(rl, params.logslots, params.scale)


@pytest.fixture(scope="module")
def ctx(request):
    alpha = request.param
    params = jckks.new_parameters(**RECIPES[alpha])
    assert params.rlwe.alpha == alpha
    kgen = jrlwe.KeyGenerator(params.rlwe, seed=31)
    rlk = jrlwe.RelinearizationKeySet()
    pks = {}
    for uid in USERS:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
    enc = jckks.Encryptor(params, seed=32)
    rng = np.random.default_rng(33)
    cts = [enc.encrypt_msg(jckks.Message(
        value=rng.uniform(-0.5, 0.5, params.slots)
        + 1j * rng.uniform(-0.5, 0.5, params.slots)), pks[uid])
        for uid in USERS]
    t_rlk = convert.relinearization_key_set(
        {uid: tuple(np.asarray(getattr(k, f)) for f in "bdv")
         for uid, k in rlk.value.items()}, "cpu")
    return dict(params=params, tparams=carry_params(params),
                ev=jckks.Evaluator(params), rlk=rlk, t_rlk=t_rlk, cts=cts)


@functools.partial(jax.jit, static_argnames=("level", "square"))
def _j_mul_and_relin(rp, c0, c1, rlk, level, square):
    return jksw.mul_and_relin(rp, c0, c1, rlk, level, square=square).data


def _operands(ctx, mode, k):
    ev, cts = ctx["ev"], ctx["cts"]
    if mode == "union":
        return ev.add_new(cts[0], cts[1]), ev.sub_new(cts[2], cts[3])
    ct0 = ct1 = cts[0]
    for c in cts[1:k]:
        ct0, ct1 = ev.add_new(ct0, c), ev.sub_new(ct1, c)
    return ct0, (ct0 if mode == "square" else ct1)


# each JAX variant compiles anew, so the cases cover alpha x k x operand
# kind without the full cross product
@pytest.mark.parametrize("ctx,mode,k", [(1, "distinct", 2), (1, "square", 4),
                                        (1, "union", 4), (2, "distinct", 4),
                                        (2, "square", 2)],
                         indirect=["ctx"])
def test_mul_and_relin_bit_identical(ctx, mode, k):
    ct0, ct1 = _operands(ctx, mode, k)
    square = mode == "square"
    ids = jrlwe.union_ids(ct0.ids, ct1.ids)
    assert len(ids) == k
    level = ct0.level
    want = _j_mul_and_relin(ctx["params"].rlwe, ct0.ct, ct1.ct,
                            ctx["rlk"].stacked(ids), level, square)

    tp = ctx["tparams"].rlwe
    t0 = convert.rlwe_ciphertext(ct0.ids, np.asarray(ct0.ct.data), "cpu")
    t1 = (t0 if square else
          convert.rlwe_ciphertext(ct1.ids, np.asarray(ct1.ct.data), "cpu"))
    got = tksw.mul_and_relin(tp, t0, t1, ctx["t_rlk"].stacked(ids), level)
    assert got.ids == ids
    np.testing.assert_array_equal(convert.to_numpy(got.data),
                                  np.asarray(want))


@pytest.mark.parametrize("ctx,mode", [(1, "distinct"), (1, "square"),
                                      (1, "hoisted"), (2, "distinct"),
                                      (2, "square"), (2, "hoisted")],
                         indirect=["ctx"])
def test_sum_of_one_pair_is_the_mult(ctx, mode):
    """mul_and_relin_sum of one pair equals mul_and_relin bit for bit, for
    distinct, square and hoisted operands: both run the one tensor-terms
    function and the one relinearize tail."""
    ct0, ct1 = _operands(ctx, "square" if mode == "square" else "distinct",
                         2)
    tp = ctx["tparams"].rlwe
    t0 = convert.rlwe_ciphertext(ct0.ids, np.asarray(ct0.ct.data), "cpu")
    t1 = (t0 if mode == "square" else
          convert.rlwe_ciphertext(ct1.ids, np.asarray(ct1.ct.data), "cpu"))
    h0 = h1 = None
    if mode == "hoisted":
        h0, h1 = tksw.hoisted_form(tp, t0), tksw.hoisted_form(tp, t1)
    ids, level = t0.ids, t0.level
    keys = ctx["t_rlk"].stacked(ids)
    one = tksw.mul_and_relin(tp, t0, t1, keys, level, h0, h1)
    two = tksw.mul_and_relin_sum(tp, [(t0, t1, h0, h1)], keys, level)
    assert two.ids == one.ids == ids
    np.testing.assert_array_equal(convert.to_numpy(two.data),
                                  convert.to_numpy(one.data))


@functools.partial(jax.jit, static_argnames=("level",))
def _j_mul_and_relin_hoisted(rp, c0, c1, rlk, level, h0, h1):
    return jksw.mul_and_relin(rp, c0, c1, rlk, level, h0, h1).data


@pytest.mark.parametrize("ctx", [2], indirect=True)
def test_hoisted_digits_sliced_to_a_lower_level(ctx):
    """Digits hoisted at the top level and sliced one level down
    (slice_digits), and a mult at that level from them, equal the JAX
    package's. With alpha = 2 the sliced last digit still spans two
    limbs, so it is not the lower level's own decomposition: both packages
    slice the same way."""
    ct0, ct1 = _operands(ctx, "distinct", 2)
    rp, tp = ctx["params"].rlwe, ctx["tparams"].rlwe
    t0 = convert.rlwe_ciphertext(ct0.ids, np.asarray(ct0.ct.data), "cpu")
    t1 = convert.rlwe_ciphertext(ct1.ids, np.asarray(ct1.ct.data), "cpu")
    level = t0.level - 1
    jh0, jh1 = ctx["ev"].hoisted_form(ct0), ctx["ev"].hoisted_form(ct1)
    th0, th1 = tksw.hoisted_form(tp, t0), tksw.hoisted_form(tp, t1)
    np.testing.assert_array_equal(
        convert.to_numpy(tksw.slice_digits(tp, th0.digits, level)),
        np.asarray(jksw.slice_digits(rp, jh0.digits, level)))

    ids = t0.ids
    want = _j_mul_and_relin_hoisted(
        rp, jrlwe.drop_level(ct0.ct, 1), jrlwe.drop_level(ct1.ct, 1),
        ctx["rlk"].stacked(ids), level, jh0, jh1)
    got = tksw.mul_and_relin(tp, t0, t1, ctx["t_rlk"].stacked(ids), level,
                             h0=th0, h1=th1)
    np.testing.assert_array_equal(convert.to_numpy(got.data),
                                  np.asarray(want))


@functools.partial(jax.jit, static_argnames=("level",))
def _j_external_product(rp, digits, swk, level):
    return jksw.external_product(rp, digits, swk, level)


@pytest.mark.parametrize("ctx", [2], indirect=True)
def test_external_product_bit_identical(ctx):
    """Digits x a switching-key-shaped vector (the CRS u), down to Q."""
    ct0, _ = _operands(ctx, "distinct", 2)
    rp, tp = ctx["params"].rlwe, ctx["tparams"].rlwe
    level = ct0.level
    digits = ctx["ev"].hoisted_form(ct0).digits
    want = _j_external_product(rp, digits, rp.crs_at(-1, level), level)
    got = tksw.external_product(tp, convert.tensor(digits, "cpu"),
                                tp.crs_at(-1, level), level)
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))


@functools.partial(jax.jit, static_argnames=("level",))
def _j_u_key_products(rp, c0, c1, rlk, level, u_key):
    one = jksw.mul_and_relin(rp, c0, c1, rlk, level, u_key=u_key).data
    two = jksw.mul_and_relin_sum(rp, [(c0, c1, None, None),
                                      (c1, c0, None, None)], rlk, level,
                                 u_key=u_key).data
    return one, two


@pytest.mark.parametrize("ctx", [1], indirect=True)
def test_u_key_operand(ctx):
    """u_key= replaces the CRS u in mul_and_relin and mul_and_relin_sum
    (a sharded caller passes its chunk): given another CRS both equal the
    JAX package's with the same u_key, and given the CRS at -1 they equal
    the default, bit for bit."""
    ct0, ct1 = _operands(ctx, "distinct", 2)
    ct0, ct1 = ctx["ev"].drop_level(ct0, 1), ctx["ev"].drop_level(ct1, 1)
    ids, level = ct0.ids, ct0.level
    rp, tp = ctx["params"].rlwe, ctx["tparams"].rlwe
    want_one, want_two = _j_u_key_products(
        rp, ct0.ct, ct1.ct, ctx["rlk"].stacked(ids), level,
        rp.crs_at(0, level))
    t0 = convert.rlwe_ciphertext(ids, np.asarray(ct0.ct.data), "cpu")
    t1 = convert.rlwe_ciphertext(ids, np.asarray(ct1.ct.data), "cpu")
    keys = ctx["t_rlk"].stacked(ids)
    pairs = [(t0, t1, None, None), (t1, t0, None, None)]
    for u, one_w, two_w in ((tp.crs_at(0, level), np.asarray(want_one),
                             np.asarray(want_two)),
                            (tp.crs_at(-1, level), None, None)):
        one = tksw.mul_and_relin(tp, t0, t1, keys, level, u_key=u)
        two = tksw.mul_and_relin_sum(tp, pairs, keys, level, u_key=u)
        if one_w is None:   # the default's CRS: the default's output
            one_w = convert.to_numpy(
                tksw.mul_and_relin(tp, t0, t1, keys, level).data)
            two_w = convert.to_numpy(
                tksw.mul_and_relin_sum(tp, pairs, keys, level).data)
        np.testing.assert_array_equal(convert.to_numpy(one.data), one_w)
        np.testing.assert_array_equal(convert.to_numpy(two.data), two_w)


# -- the tensor terms ---------------------------------------------------------

def _tensor_chain(ring, nt0, nt1, ids0, ids1, ids):
    """The tensor terms as the port computed them before the tensor kernel:
    to_mont of both operands' row 0, a mul_mont a product, add_mod."""
    nt0_0m, nt1_0m = ring.to_mont(nt0[0]), ring.to_mont(nt1[0])
    out = [ring.mul_mont(nt1[0], nt0_0m)]
    for pid in ids:
        acc = None
        if pid in ids0:
            acc = ring.mul_mont(nt0[1 + ids0.index(pid)], nt1_0m)
        if pid in ids1:
            t = ring.mul_mont(nt1[1 + ids1.index(pid)], nt0_0m)
            acc = t if acc is None else ring.add(acc, t)
        out.append(acc)
    return torch.stack(out)


TENSOR_LOGN = 6
TENSOR_CASES = {
    # name: (moduli, batch axes, ids0, ids1, square)
    "ckks_4_parties": (ntt_primes(TENSOR_LOGN, 28.99, 4), (), USERS, USERS,
                       False),
    "bfv_ring_r_batched": (ntt_primes(TENSOR_LOGN, 28.9, 3)
                           + ntt_primes(TENSOR_LOGN, 28.4, 3), (2,), USERS,
                           USERS, False),
    "cnn_conv_disjoint": (ntt_primes(TENSOR_LOGN, 28.9, 3), (), USERS[:1],
                          USERS[1:2], False),
    "ids0_strict_subset": (ntt_primes(TENSOR_LOGN, 28.9, 3), (), USERS[1:2],
                           USERS[:3], False),
    "square": (ntt_primes(TENSOR_LOGN, 28.9, 3), (), USERS[:2], USERS[:2],
               True),
    "party_sharded_local_ids": (ntt_primes(TENSOR_LOGN, 28.9, 3), (2,),
                                (0, 1, 2), (0, 1, 2), False),
}


@pytest.mark.parametrize("name", sorted(TENSOR_CASES))
def test_tensor_terms_plain_is_the_chain(name):
    """basis_cuda.tensor_terms_plain (one product sum and one %) and the
    wrapper's CPU route equal the to_mont / mul_mont / add_mod chain bit
    for bit in each caller's shape: 4 parties in both operands, BFV's
    two-ring R with a batch axis, the CNN conv's disjoint ids, ids0 a
    strict subset of the union, the square (one tensor for both) and the
    party-sharded mult's local ids; residues q - 1 in the first columns
    (the largest sums)."""
    mods, batch, ids0, ids1, square = TENSOR_CASES[name]
    ring = Ring.create(mods, TENSOR_LOGN, "cpu")
    ids = tuple(sorted(set(ids0) | set(ids1)))
    rng = np.random.default_rng(sorted(TENSOR_CASES).index(name))
    q = np.array(mods, np.int64)[:, None]

    def operand(k):
        x = rng.integers(0, 1 << 40, (1 + k, *batch, len(mods), ring.n)) % q
        x[..., :3] = q - 1
        return torch.from_numpy(x)

    nt0 = operand(len(ids0))
    nt1 = nt0 if square else operand(len(ids1))
    want = _tensor_chain(ring, nt0, nt1, ids0, ids1, ids)
    t = basis_cuda.limb_tables(ring.moduli, ring.device)
    for got in (basis_cuda.tensor_terms_plain(nt0, nt1, ids0, ids1, ids, t),
                basis_cuda.tensor_terms(nt0, nt1, ids0, ids1, ids, t)):
        assert got.shape == (1 + len(ids), *batch, len(mods), ring.n)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
