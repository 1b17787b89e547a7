"""The batched mult's serving cell (hebench/kinds/ckks_mulrelin_batched.py,
the request kind of ckks4.mulrelin_b4) and the port's batching helper
(mkrlwe/elements.py: stack_batch, split_batch, batch_counters) on the CPU,
at hebench/tests/_tiny.py's CKKS parameters (logN 10, 5 Q + 4 P limbs, 4
parties) with B = 3 pairs a request, so that the batch and the party axis
differ in length:

  - a run of the kind is `correct`, and a traced run reads the cell's
    host-clock metric;
  - planted faults are not `correct`: one pair's input returned, two
    pairs' outputs swapped, one coefficient of one pair altered;
  - the complex64 control fails the limit;
  - the inventory counts the relinearization keys and the CRS once and
    each pair's operands and output once a pair;
  - both evaluators reject, through the helper, a batch whose second
    side's ids differ;
  - batch_counters() reads one call of B pairs after a CKKS and after a
    BFV batched mult, and under spans_on() batch.stack and batch.split
    open once each a batched mult."""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from hebench import harness
from hebench.reference.primes import ckks_moduli
from mkhe_tpu_torch import mkbfv, mkckks, mkrlwe, profile_mult
from mkhe_tpu_torch.ops.primes import ntt_primes

ROOT = Path(__file__).resolve().parent.parent
HOME = ROOT / "hebench"
TINY = harness.load_module(HOME / "tests" / "_tiny.py", "tiny")
BATCHED = harness.kind(HOME, "ckks_mulrelin_batched")
SINGLE = harness.kind(HOME, "ckks_mulrelin")
B = 3
CELL = "tiny.mulrelin_b3"
SEED = 2 ** 32 + 91
RECIPE = dict(logn=10, logslots=9, q0_bits=28.9, level_bits=20.0, levels=4,
              scale=2.0 ** 40, p_bits=28.4)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """_tiny's checkout with one more cell: the batched mix on the tiny
    CKKS configuration at B pairs, under _tiny's mult limits, reporting
    op_ms and the cell's .b4 metrics."""
    root = TINY.make_root(tmp_path_factory.mktemp("tiny"))
    home = root / "hebench"
    cfg = dict(TINY.CKKS, name="ckks_tiny_b3", batch=B)
    (home / "configs" / "ckks_tiny_b3.json").write_text(json.dumps(cfg))
    number, limit = TINY.CELLS["tiny.mulrelin"][2:]
    (home / "workloads" / f"{CELL}.json").write_text(json.dumps(
        {"sample": 2, "trace_requests": 2,
         "limits": {number: limit, "not_small": 0}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": cfg["name"], "source": "test",
                             "file": "hebench/configs/ckks_tiny_b3.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": cfg["name"],
                               "traffic": "mulrelin_b4", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] == "op_ms":
            m["workloads"].append(CELL)
        elif m["name"].endswith(".b4"):
            m["workloads"] = [CELL]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_batched_run_is_correct(root):
    r = harness.run_cell(CELL, SEED, 0.1, False, "cpu", root)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"op_ms", "setup_s"}
    traced = harness.run_cell(CELL, SEED + 1, 0.1, True, "cpu", root)
    assert traced["correct"], traced["checks"]
    assert traced["metrics"]["mfu.b4"]["value"] > 0


def input_returned(request):
    """Pair 1's output replaced by its own ct0: the request's input."""
    state = request.__self__

    def run(i):
        outs = request(i)
        outs[1] = state.batches[i % len(state.batches)][0][1]
        return outs
    return run


def swapped(request):
    """Pairs 0 and 2 given each other's outputs."""
    def run(i):
        outs = request(i)
        outs[0], outs[2] = outs[2], outs[0]
        return outs
    return run


def altered(request):
    """One coefficient of one limb of pair 2's output, plus one."""
    def run(i):
        outs = request(i)
        data = outs[2].ct.data.clone()
        data[1, 0, 7] += 1
        outs[2] = dataclasses.replace(
            outs[2], ct=dataclasses.replace(outs[2].ct, data=data))
        return outs
    return run


@pytest.mark.parametrize("fault", [input_returned, swapped, altered])
def test_broken_pair_is_not_correct(root, fault):
    r = harness.run_cell(CELL, SEED + 2, 0.1, False, "cpu", root,
                         broken=fault)
    assert not r["correct"], r["checks"]


def test_control_fails_the_limit(root):
    r = harness.run_cell(CELL, 2 ** 31 + 3, 0.1, False, "cpu", root,
                         controls=["complex64"])
    assert r["correct"], r["checks"]
    got = r["controls"]["complex64"]
    assert got["correct"] is False, got
    assert got["checks"]["max_err_log2"]["value"] > \
        got["checks"]["max_err_log2"]["limit"]


@pytest.mark.parametrize("batch", [1, 4])
def test_inventory_counts_keys_once(batch):
    params = TINY.CKKS["params"]
    moduli = ckks_moduli(**params)
    cfg = dict(params, parties=TINY.CKKS["parties"])
    one = SINGLE.inventory(cfg, moduli)
    many = BATCHED.inventory(dict(cfg, batch=batch), moduli)
    keys = {k: v for k, v in one.reads.items() if k.startswith(("rlk.",
                                                                "crs."))}
    assert len(keys) == 3 * cfg["parties"] + 1
    assert {k: many.reads[k] for k in keys} == keys
    for name in ("ct0", "ct1", "out"):
        for b in range(batch):
            assert many.reads[f"{name}.{b}"] == one.reads[name]
    assert len(many.reads) == len(keys) + 3 * batch
    assert many.calls == one.calls * batch


def _ckks_side(uid, n=3):
    ct = mkrlwe.Ciphertext(ids=(uid,), data=torch.zeros((2, 3, 8),
                                                        dtype=torch.int64))
    return [mkckks.Ciphertext(ct=ct, scale=2.0 ** 40)] * n


@pytest.mark.parametrize("scheme,message", [("ckks", "ids, level, scale"),
                                            ("bfv", "id tuple")])
def test_second_side_ids_differ(scheme, message):
    """Both evaluators reject a batch whose first side agrees and whose
    second side mixes two id tuples, before touching their parameters."""
    side0 = _ckks_side("user0")
    side1 = _ckks_side("user1", 2) + _ckks_side("user2", 1)
    if scheme == "bfv":
        side0, side1 = [c.ct for c in side0], [c.ct for c in side1]
        ev = mkbfv.Evaluator(None)
    else:
        ev = mkckks.Evaluator(None)
    with pytest.raises(ValueError, match=message):
        ev.mul_relin_batched_new(side0, side1, None)


@pytest.fixture(scope="module", params=["ckks", "bfv"])
def batched_mult(request):
    """A batched mult of B pairs at logN 10 on 2 parties, CKKS (B distinct
    pairs) or BFV (the bench operands in B pairs)."""
    if request.param == "ckks":
        params = mkckks.new_parameters(**RECIPE, device="cpu")
        ev, cts0, cts1, rlk = profile_mult.setup_batch(params, 2, B, seed=7)
        return lambda: ev.mul_relin_batched_new(cts0, cts1, rlk)
    params = mkbfv.new_parameters(10, ntt_primes(10, 26.5, 6),
                                  ntt_primes(10, 26.5, 6, skip=6),
                                  ntt_primes(10, 28.4, 4), device="cpu")
    ev, ct0, ct1, rlk = profile_mult.setup_bfv(params, 2, seed=7)
    return lambda: ev.mul_relin_batched_new([ct0, ct1, ct0],
                                            [ct1, ct1, ct0], rlk)


def test_batch_counters(batched_mult):
    mkrlwe.reset_batch_counters()
    assert len(batched_mult()) == B
    assert mkrlwe.batch_counters() == {"calls": 1, "pairs": B}
    mkrlwe.reset_batch_counters()
    assert mkrlwe.batch_counters() == {"calls": 0, "pairs": 0}


def test_batch_spans_open_once_a_mult(batched_mult):
    spans = profile_mult.trace(batched_mult, 1, torch.device("cpu"))["spans"]
    assert spans["batch.stack"][0] == spans["batch.split"][0] == 1
