"""The port's parallel tier (mkhe_tpu_torch.parallel) against mkhe_tpu's,
bit for bit, on ranks spawned over gloo (the party-sharded mult and
rotation are in tests/test_torch_parallel_party.py).

One spawn of 4 CPU ranks (mkhe_tpu_torch.parallel._ranks.run: a FileStore
in a temporary directory, torch.multiprocessing spawn, one torch thread a
rank) runs every case of this file; the parent builds the inputs with the
JAX package, carries them across as arrays, and computes the JAX side:

  - the coefficient-sharded NTT, forward and inverse, at C = 2 and 4 and
    on a 2 x 2 ("rns", "coeff") mesh with the limbs sharded too, against
    mkhe_tpu's Ring.ntt / intt and dist_ntt.ntt_sharded
    (tests/test_dist_ntt.py's ring and data);
  - the coefficient-sharded mult at C = 2 and 4 and at a lower level,
    against mkhe_tpu's mul_and_relin and coeff_mul.mul_and_relin_sharded
    (tests/test_coeff_mul.py's parameters), and on the 2 x 2 mesh, the
    counterpart of tests/test_sharding.py::test_sharded_mul_matches_
    unsharded (no GSPMD here: each row of the mesh runs the
    coefficient-sharded mult on its own);
  - the placement helpers, the dist setting of every sub-ring (take,
    concat, ring_q_at, ring_qp_at, also of Parameters that had memoised
    their sub-rings), and that no rank loaded jax or mkhe_tpu.
"""

import numpy as np
import pytest
import torch

import jax
from jax.experimental import mesh_utils
from jax.sharding import Mesh

from mkhe_tpu import mkckks as jckks
from mkhe_tpu import mkrlwe as jrlwe
from mkhe_tpu.mkckks.evaluator import _mul_relin_core
from mkhe_tpu.ops.primes import ntt_primes
from mkhe_tpu.ops.ring import Ring as JRing
from mkhe_tpu.parallel import coeff_mul as jcoeff
from mkhe_tpu.parallel import dist_ntt as jdist
from mkhe_tpu_torch.parallel import _ranks

torch.set_num_threads(1)

WORLD = 4
NTT_LOGN = 10


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


# ----------------------------------------------------------------------------
# The cases, built with the JAX package
# ----------------------------------------------------------------------------

def _ntt_cases():
    ring = JRing.create(ntt_primes(NTT_LOGN, 26.5, 4), NTT_LOGN)
    rng = np.random.default_rng(5)
    q = np.asarray(ring.q)
    x = (rng.integers(0, 2 ** 32, size=(3, len(q), 1 << NTT_LOGN),
                      dtype=np.uint64) % q[None, :, None]).astype(np.uint32)
    nt = ring.ntt(x)
    cases = {}
    for name, (rns, coeff), inverse in (
            ("fwd_C2", (2, 2), False), ("inv_C2", (2, 2), True),
            ("fwd_C4", (1, 4), False), ("inv_C4", (1, 4), True),
            ("fwd_2x2", (2, 2), False), ("inv_2x2", (2, 2), True)):
        limb = name.endswith("2x2")
        src = nt if inverse else x
        if limb:
            mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                        ("rns", "coeff"))
        else:
            mesh = Mesh(np.array(jax.devices()[:coeff]).reshape(coeff),
                        ("coeff",))
        cases[name] = dict(
            task=dict(moduli=ring.moduli, logn=NTT_LOGN, x=_t(src),
                      rns=rns, coeff=coeff, inverse=inverse,
                      limb_axis=limb),
            want=np.asarray(ring.intt(nt) if inverse else nt),
            want_jax_sharded=np.asarray(jdist.ntt_sharded(
                ring, src, mesh, inverse=inverse,
                limb_axis="rns" if limb else None)))
    return cases


def _coeff_cases():
    params = jckks.new_parameters(8, 7, q0_bits=28.9, level_bits=20.0,
                                  levels=2, scale=2.0 ** 40, p_bits=28.4)
    rp = params.rlwe
    kgen = jrlwe.KeyGenerator(rp, seed=51)
    pks, rlk = {}, jrlwe.RelinearizationKeySet()
    for uid in ("alice", "bob"):
        sk, pks[uid] = kgen.gen_key_pair(uid)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
    enc = jckks.Encryptor(params, seed=52)
    ev = jckks.Evaluator(params)
    rng = np.random.default_rng(9)
    msg = lambda: jckks.Message(value=rng.uniform(-0.5, 0.5, params.slots))
    ct0 = enc.encrypt_msg(msg(), pks["alice"])
    ct1 = enc.encrypt_msg(msg(), pks["bob"])
    low0, low1 = ev.drop_level(ct0, 1), ev.drop_level(ct1, 1)
    stacked = rlk.stacked(("alice", "bob"))
    cases = {}
    for name, (c0, c1), (rns, coeff) in (
            ("C2", (ct0, ct1), (2, 2)), ("C4", (ct0, ct1), (1, 4)),
            ("C4_lower_level", (low0, low1), (1, 4)),
            ("rns_coeff_2x2", (ct0, ct1), (2, 2))):
        level = c0.level
        want = _mul_relin_core(rp, c0.ct, c1.ct, *stacked, level, None,
                               None, False, False)
        jmesh = _jmesh(coeff, "coeff")
        cases[name] = dict(
            task=dict(params=_state(rp, (-1,)), ct0=_ct(c0), ct1=_ct(c1),
                      rlk=tuple(_t(a) for a in stacked), level=level,
                      rns=rns, coeff=coeff),
            ids=want.ids, want=np.asarray(want.data),
            want_jax_sharded=np.asarray(jcoeff.mul_and_relin_sharded(
                rp, c0.ct, c1.ct, stacked, level, jmesh).data))
    return cases


@pytest.fixture(scope="module")
def run():
    """Every case through one spawn of WORLD gloo ranks."""
    ntt, coeff = _ntt_cases(), _coeff_cases()
    tasks, index = [], {}
    for kind, cases in (("ntt", ntt), ("coeff_mul", coeff)):
        for name, case in cases.items():
            index[(kind, name)] = len(tasks)
            tasks.append((kind, case["task"]))
    index["mesh"] = len(tasks)
    rng = np.random.default_rng(3)
    mesh_inputs = dict(ct=_t(rng.integers(0, 1 << 20, (3, 4, 16))),
                       key=_t(rng.integers(0, 1 << 20, (2, 6, 16))),
                       stacked=_t(rng.integers(0, 1 << 20, (3, 2, 6, 16))))
    tasks.append(("mesh", mesh_inputs))
    index["rings"] = len(tasks)
    tasks.append(("dist_rings", dict(
        params=_state(jckks.new_parameters(
            8, 7, q0_bits=28.9, level_bits=20.0, levels=2, scale=2.0 ** 40,
            p_bits=28.4).rlwe, (-1,)),
        level=1)))
    outs = _ranks.run(tasks, WORLD, timeout=240)
    return dict(outs=outs, index=index, ntt=ntt, coeff=coeff,
                mesh_inputs=mesh_inputs)


def _results(run, key):
    return [o["results"][run["index"][key]] for o in run["outs"]]


# ----------------------------------------------------------------------------
# The coefficient-sharded NTT
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["fwd_C2", "inv_C2", "fwd_C4", "inv_C4",
                                  "fwd_2x2", "inv_2x2"])
def test_sharded_ntt_bit_identical(run, name):
    case = run["ntt"][name]
    task = case["task"]
    rns, coeff = task["rns"], task["coeff"]
    blocks = _results(run, ("ntt", name))
    if task["limb_axis"]:
        got = torch.cat([torch.cat(blocks[r * coeff:(r + 1) * coeff], -1)
                         for r in range(rns)], -2)
    else:   # every row of the mesh computes the whole transform
        rows = [torch.cat(blocks[r * coeff:(r + 1) * coeff], -1)
                for r in range(rns)]
        assert all(torch.equal(rows[0], row) for row in rows[1:])
        got = rows[0]
    np.testing.assert_array_equal(got.numpy(), case["want"])
    np.testing.assert_array_equal(got.numpy(), case["want_jax_sharded"])


# ----------------------------------------------------------------------------
# The coefficient-sharded mult
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["C2", "C4", "C4_lower_level",
                                  "rns_coeff_2x2"])
def test_coeff_sharded_mult_bit_identical(run, name):
    """C2 and rns_coeff_2x2 run on the 2 x 2 mesh (each row on its own: the
    counterpart of tests/test_sharding.py's GSPMD mult); C4 on 1 x 4."""
    case = run["coeff"][name]
    coeff = case["task"]["coeff"]
    res = _results(run, ("coeff_mul", name))
    assert all(ids == case["ids"] for ids, _ in res)
    rows = [torch.cat([d for _, d in res[r:r + coeff]], -1)
            for r in range(0, WORLD, coeff)]
    for got in rows:
        np.testing.assert_array_equal(got.numpy(), case["want"])
        np.testing.assert_array_equal(got.numpy(), case["want_jax_sharded"])


# ----------------------------------------------------------------------------
# Placements, the dist setting of sub-rings, the children's imports
# ----------------------------------------------------------------------------

def test_placement_helpers(run):
    """make_mesh(4, rns=2) is 2 x 2, rank r at (r // 2, r % 2); each helper
    cuts the limb axis over "rns" and the coefficients over "coeff"."""
    full = run["mesh_inputs"]
    for r, got in enumerate(_results(run, "mesh")):
        i, j = divmod(r, 2)
        assert list(got["coords"]) == [i, j]
        assert got["names"] == ("rns", "coeff")
        assert got["ct_placements"] == "(Shard(dim=1), Shard(dim=2))"
        assert got["stacked_placements"] == "(Shard(dim=2), Shard(dim=3))"
        cut = lambda x: x[..., 2 * i:2 * i + 2, 8 * j:8 * j + 8] \
            if x.shape[-2] == 4 else x[..., 3 * i:3 * i + 3, 8 * j:8 * j + 8]
        assert torch.equal(got["ct"], cut(full["ct"]))
        assert torch.equal(got["ckks_ct"], cut(full["ct"]))
        for a, b in zip(got["stacked"], (full["stacked"],) * 2):
            assert torch.equal(a, cut(b))
        assert torch.equal(got["crs"], cut(full["key"]))


def test_sub_rings_keep_the_dist_setting(run):
    """Parameters.with_dist on parameters that had memoised ring_q_at and
    ring_qp_at first: every sub-ring (take, concat, ring_q_at,
    ring_qp_at) carries the group and chunk tables, and its NTT of a chunk
    is the chunk of the unsharded NTT."""
    for r, got in enumerate(_results(run, "rings")):
        assert got["memo_before"] > 0
        assert got["all_dist"], got
        assert got["ntt_equal"] and got["intt_equal"]
        assert got["take_concat_tables"]
        assert got["concat_mixed_raises"]
        assert got["local_again"]


def test_children_load_no_jax(run):
    for out in run["outs"]:
        assert out["foreign_modules"] == []
        assert out["transport"] == "gloo"
