"""The benchmark's plain BFV reference (hebench/reference/bfv.py) and its
BFV mult request kind (hebench/kinds/bfv_mulrelin.py) against the port on
the CPU at logN 10 (6 + 6 limbs, P of 4, alpha 2):

  - the reference decodes the port's fresh encryptions to their messages,
    slot for slot as the port's own Decryptor, with the noise far below
    Q / (2t);
  - it judges the port's 2- and 4-party mul_relin_new outputs exact
    (wrong_slots 0, noise_log2 < -1), and planted faults wrong: the input
    returned as the output, one coefficient altered;
  - moduli other than the reference's own raise, and the cell's
    configuration gives the port's PN15QP880 recipe's moduli;
  - once a mult has run, the next one at the same shapes builds nothing
    lazily (no lru_cache of the port misses), so a warmed-up window holds
    no first-use build."""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hebench import harness
from hebench.parties import ternary
from hebench.reference import bfv as ref_bfv

torch.set_num_threads(1)

HOME = Path(__file__).resolve().parent.parent / "hebench"
BFV = harness.kind(HOME, "bfv_mulrelin")
PARAMS = {"logn": 10, "q_bits": 26.5, "q_count": 6, "p_bits": 28.4,
          "p_count": 4, "t": 65537, "gamma": 2}
SEED = 2 ** 32 + 77


def _cfg(parties: int) -> dict:
    return {"params": PARAMS, "parties": parties}


@pytest.fixture(scope="module", params=[2, 4], ids=["2p", "4p"])
def state(request):
    return BFV.State(_cfg(request.param), {"pool": 2, "warmup": 1},
                     harness.seeds_of(SEED + request.param), "cpu", None)


def test_lattigo_root_and_moduli():
    assert ref_bfv.lattigo_psi(65537, 15) == 3
    assert ref_bfv.lattigo_psi(65537, 10) == pow(3, 32, 65537)
    q, qmul, p = ref_bfv.bfv_moduli(**PARAMS)
    assert len(set(q) | set(qmul) | set(p)) == 16
    assert all(m % 2048 == 1 and m < 2 ** 29 for m in q + qmul + p)


def test_configuration_is_the_pn15qp880_recipe():
    """The cell's configuration numbers give, through the reference's own
    prime search, the moduli of the port's mkbfv.PN15QP880 recipe."""
    from mkhe_tpu_torch.mkbfv import params as port
    cfg = json.loads((HOME / "configs" / "bfv_pn15qp880_4p.json")
                     .read_text())
    logn, *moduli = port.preset_moduli("PN15QP880")
    assert logn == cfg["params"]["logn"]
    assert tuple(moduli) == ref_bfv.bfv_moduli(**cfg["params"])


def test_reference_decodes_fresh_encryptions():
    from mkhe_tpu_torch import mkbfv, mkrlwe
    from mkhe_tpu_torch.mkrlwe.keygen import _secret_key_core
    params = BFV.parameters(_cfg(2), "cpu")
    q = ref_bfv.bfv_moduli(**PARAMS)[0]
    gen = torch.Generator().manual_seed(5)
    sec = ternary(gen, (2, params.n), "cpu")
    kgen = mkbfv.KeyGenerator(params, seed=6)
    enc = mkbfv.Encryptor(params, seed=7)
    dec = mkbfv.Decryptor(params)
    for i, s in enumerate(sec):
        sk = mkrlwe.SecretKey(id=f"user{i}",
                              data=_secret_key_core(params.rlwe, s))
        m = torch.randint(0, params.t, (params.n,), generator=gen)
        ct = enc.encrypt_msg(m.numpy(), kgen.gen_public_key(sk))
        got, noise = ref_bfv.open_ciphertext(ct.data, s[None], q, params.t)
        assert torch.equal(got, ref_bfv.centered(m, params.t))
        assert noise < -20
        sks = mkrlwe.SecretKeySet()
        sks.add(sk)
        assert np.array_equal(dec.decrypt(ct, sks), got.numpy())


def test_mult_outputs_judged_exact(state):
    kept = [(i, state.request(i)) for i in range(2)]
    got = state.judge(kept)
    assert got["wrong_slots"] == 0
    assert got["noise_log2"] < -1


def test_planted_faults_judged_wrong(state):
    unchanged = state.pool[0][0]
    out = state.request(0)
    data = out.data.clone()
    data[1, 0, 7] = (data[1, 0, 7] + 1) % state.moduli[0][0]
    altered = type(out)(ids=out.ids, data=data)
    n = state.params.n
    for fault in (unchanged, altered):
        got = state.judge([(0, fault)])
        assert got["wrong_slots"] > n // 2, got
    assert state.judge([(0, altered)])["noise_log2"] > -1


def test_control_is_judged_wrong(state):
    got = state.judge([(0, None), (1, None)], control=torch.float32)
    assert got["wrong_slots"] > 0
    assert got["noise_log2"] == pytest.approx(
        -(math.log2(math.prod(state.moduli[0])) - math.log2(2 * 65537)))


def test_other_moduli_raise(state):
    q, qmul, p = state.moduli
    BFV.check_moduli(state.params, _cfg(2), state.moduli)
    for moduli in ((qmul, q, p), (q, qmul, p[:2]),
                   ref_bfv.bfv_moduli(**dict(PARAMS, q_bits=26.0))):
        with pytest.raises(ValueError, match="not the configuration's"):
            BFV.check_moduli(state.params, _cfg(2), moduli)


def _misses() -> dict:
    """Misses of every lru_cache of the port's loaded modules."""
    out = {}
    for name, mod in list(sys.modules.items()):
        if name.startswith("mkhe_tpu_torch"):
            for key, fn in vars(mod).items():
                if hasattr(fn, "cache_info"):
                    out[f"{name}.{key}"] = fn.cache_info().misses
    return out


def test_second_mult_builds_nothing(state):
    state.request(0)
    before, stacked = _misses(), set(state.rlk._cache)
    state.request(1)
    assert _misses() == before
    assert set(state.rlk._cache) == stacked
