"""The port's party-sharded mult and rotation (mkhe_tpu_torch.parallel.
party_mul) against mkhe_tpu's, bit for bit, on ranks spawned over gloo.

One spawn of 4 CPU ranks (mkhe_tpu_torch.parallel._ranks.run, as in
tests/test_torch_parallel.py) runs the square, distinct, 8-party distinct
(two parties a rank), hoisted and union mults and the plain and hoisted
rotations, over 2 and 4 ranks (a 2 x 2 ("replica", "party") mesh for 2),
with tests/test_party_sharding.py's parameters, keys and seeds. The parent
builds the inputs with the JAX package and computes its single-device
cores and party_mul's sharded functions (once per operands).
"""

import numpy as np
import pytest
import torch

import jax
from jax.experimental import mesh_utils
from jax.sharding import Mesh

from mkhe_tpu import mkckks as jckks
from mkhe_tpu import mkrlwe as jrlwe
from mkhe_tpu.mkckks.evaluator import _mul_relin_core, _rotate_core
from mkhe_tpu.mkrlwe import keyswitch as jksw
from mkhe_tpu.mkrlwe.elements import union_ids
from mkhe_tpu.parallel import party_mul as jparty
from mkhe_tpu_torch.parallel import _ranks

torch.set_num_threads(1)

WORLD = 4


def _jmesh(n, name):
    return Mesh(mesh_utils.create_device_mesh((n,), devices=jax.devices()[:n]),
                (name,))


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _state(rp, crs_idx):
    """A task's parameters: the JAX package's moduli and CRS."""
    return dict(logn=rp.logn, q=rp.q_moduli, p=rp.p_moduli, gamma=rp.gamma,
                sigma=rp.sigma, crs={i: _t(rp.crs[i]) for i in crs_idx})


def _ct(ct):
    return (ct.ct.ids, _t(ct.ct.data))


def _party_cases():
    params = jckks.new_parameters(9, 8, q0_bits=28.9, level_bits=20.0,
                                  levels=2, scale=2.0 ** 40, p_bits=28.4)
    rp = params.rlwe
    users = [f"u{i}" for i in range(4)]
    kgen = jrlwe.KeyGenerator(rp, seed=91)
    rlk, rtk, pks = jrlwe.RelinearizationKeySet(), jrlwe.RotationKeySet(), {}
    for uid in users:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
        rtk.add(kgen.gen_rotation_key(2, sk))
    enc = jckks.Encryptor(params, seed=92)
    ev = jckks.Evaluator(params)
    rng = np.random.default_rng(14)
    cts = {}
    for uid in users:
        m = rng.uniform(-0.2, 0.2, params.slots) \
            + 1j * rng.uniform(-0.2, 0.2, params.slots)
        cts[uid] = enc.encrypt_msg(jckks.Message(value=m), pks[uid])

    def total(uids, sign=False):
        ct = cts[uids[0]]
        for i, uid in enumerate(uids[1:], 1):
            ct = (ev.sub_new if sign and i % 2 else ev.add_new)(ct, cts[uid])
        return ct

    # 8 parties (the JAX test's 8-device case), two a rank on 4 ranks
    users8 = [f"w{i}" for i in range(8)]
    kgen8 = jrlwe.KeyGenerator(rp, seed=93)
    rlk8, pks8 = jrlwe.RelinearizationKeySet(), {}
    for uid in users8:
        sk, pks8[uid] = kgen8.gen_key_pair(uid)
        rlk8.add(kgen8.gen_relinearization_key(sk, kgen8.gen_secret_key(uid)))
    enc8 = jckks.Encryptor(params, seed=94)
    rng8 = np.random.default_rng(15)
    a8 = b8 = None
    for uid in users8:
        m = rng8.uniform(-0.1, 0.1, params.slots) \
            + 1j * rng8.uniform(-0.1, 0.1, params.slots)
        c = enc8.encrypt_msg(jckks.Message(value=m), pks8[uid])
        a8 = c if a8 is None else ev.add_new(a8, c)
        b8 = c if b8 is None else ev.sub_new(b8, c)

    hoist = jax.jit(lambda c: jksw.hoisted_form(rp, c))
    sum4, diff4 = total(users), total(users, sign=True)
    h_sum, h_diff = hoist(sum4.ct), hoist(diff4.ct)
    half0, half1 = total(users[:2]), total(users[2:])
    state = _state(rp, (-1, 2))
    cases, jax_side = {}, {}

    def mul(name, parties, c0, c1, keys, h0=None, h1=None, square=False):
        """The case `name` on `parties` ranks; the JAX side once per
        operands (it does not depend on the port's rank count)."""
        ids = union_ids(c0.ct.ids, c1.ct.ids)
        stacked = keys.stacked(ids)
        key = name.rsplit("_", 1)[0]
        if key not in jax_side:
            jax_side[key] = (
                _mul_relin_core(rp, c0.ct, c1.ct, *stacked, c0.level, h0,
                                h1, h0 is not None, h1 is not None, square),
                jparty.mul_and_relin_party_sharded(
                    rp, c0.ct, stacked, _jmesh(len(ids), "party"),
                    ct1=None if square else c1.ct, h0=h0, h1=h1))
        want, jsh = jax_side[key]
        cases[name] = dict(
            task=("party_mul", dict(
                params=state, ct0=_ct(c0), ct1=None if square else _ct(c1),
                rlk=tuple(_t(a) for a in stacked),
                h0=None if h0 is None else (h0.ids, _t(h0.digits)),
                h1=None if h1 is None else (h1.ids, _t(h1.digits)),
                parties=parties)),
            ids=want.ids, want=np.asarray(want.data),
            want_jax_sharded=np.asarray(jsh.data))

    mul("square_4", 4, sum4, sum4, rlk, square=True)
    mul("distinct_4", 4, sum4, diff4, rlk)
    mul("distinct_2", 2, sum4, diff4, rlk)
    mul("distinct8_4", 4, a8, b8, rlk8)
    mul("hoisted_2", 2, sum4, diff4, rlk, h0=h_sum, h1=h_diff)
    mul("hoisted_4", 4, sum4, diff4, rlk, h0=h_sum, h1=h_diff)
    mul("union_4", 4, half0, half1, rlk)

    rtk_stacked = rtk.stacked(sum4.ct.ids, 2)
    a_crs = rp.crs_at(2, sum4.level)
    src, sign = jksw.rotation_tables(rp, 2)
    for name, parties, h in (("rotate_4", 4, None), ("rotate_2", 2, None),
                             ("rotate_hoisted_4", 4, h_sum)):
        key = name.rsplit("_", 1)[0]
        if key not in jax_side:
            jax_side[key] = (
                _rotate_core(rp, sum4.ct, rtk_stacked, a_crs, src, sign, h,
                             h is not None),
                jparty.rotate_party_sharded(rp, sum4.ct, 2, rtk_stacked,
                                            _jmesh(4, "party"), h=h))
        want, jsh = jax_side[key]
        cases[name] = dict(
            task=("party_rot", dict(
                params=state, ct=_ct(sum4), rot=2, rtk=_t(rtk_stacked),
                h=None if h is None else (h.ids, _t(h.digits)),
                parties=parties)),
            ids=want.ids, want=np.asarray(want.data),
            want_jax_sharded=np.asarray(jsh.data))
    return cases


@pytest.fixture(scope="module")
def run():
    """Every case through one spawn of WORLD gloo ranks."""
    cases = _party_cases()
    names = list(cases)
    outs = _ranks.run([cases[n]["task"] for n in names], WORLD, timeout=240)
    return dict(outs=outs, cases=cases, index={n: i for i, n in
                                               enumerate(names)})


def _results(run, name):
    return [o["results"][run["index"][name]] for o in run["outs"]]


# ----------------------------------------------------------------------------
# The party-sharded mult and rotation
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "square_4", "distinct_4", "distinct_2", "distinct8_4", "hoisted_2",
    "hoisted_4", "union_4", "rotate_4", "rotate_2", "rotate_hoisted_4"])
def test_party_sharded_bit_identical(run, name):
    case = run["cases"][name]
    for ids, data in _results(run, name):
        assert ids == case["ids"]
        np.testing.assert_array_equal(data.numpy(), case["want"])
        np.testing.assert_array_equal(data.numpy(), case["want_jax_sharded"])


def test_children_load_no_jax(run):
    for out in run["outs"]:
        assert out["foreign_modules"] == []
        assert out["transport"] == "gloo"
