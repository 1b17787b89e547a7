"""The BFV mult cell at a size the CPU can hold: the request kind
(kinds/bfv_mulrelin.py) comes out correct under the harness, a broken
request and the float32 control do not, its work inventory matches the
calls the port makes (and the step counts at PN15QP880), the
double-basis reader finds nothing in a trace without the 32-wide basis
kernel, and the BFV reference loads nothing of either package."""

import collections
import json

import numpy as np
import pytest

from _tiny import CKKS, HOME, make_root
from hebench import calibrate, harness
from hebench.reference import bfv as ref_bfv
from hebench.reference import primes
from test_hebench_imports import FORBIDDEN, _run
from test_hebench_work import recorded

BFV = harness.kind(HOME, "bfv_mulrelin")
TINY = {"name": "bfv_tiny", "scheme": "bfv",
        "params": {"logn": 10, "q_bits": 26.5, "q_count": 6, "p_bits": 28.4,
                   "p_count": 4, "t": 65537, "gamma": 2},
        "parties": 4}
CELL = "tiny.bfv"
SEED = 2 ** 33 + 19


def add_bfv(root):
    """The tiny BFV configuration and its cell beside _tiny's, reporting
    the BFV cell's metrics."""
    home = root / "hebench"
    (home / "configs" / "bfv_tiny.json").write_text(json.dumps(TINY))
    (home / "workloads" / f"{CELL}.json").write_text(json.dumps(
        {"sample": 2, "trace_requests": 2,
         "limits": {"wrong_slots": 0, "noise_log2": -1.0}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "bfv_tiny", "source": "test",
                             "file": "hebench/configs/bfv_tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "bfv_tiny",
                               "traffic": "bfv_mulrelin", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] == "op_ms":
            m["workloads"] = m["workloads"] + [CELL]
        elif m["name"].endswith(".bfv"):
            m["workloads"] = [CELL]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return add_bfv(make_root(tmp_path_factory.mktemp("tiny")))


def test_cell_is_correct_and_reports_its_metrics(root):
    r = harness.run_cell(CELL, SEED, 0.2, False, "cpu", root)
    assert r["correct"], r["checks"]
    assert r["checks"]["wrong_slots"]["value"] == 0
    assert r["checks"]["noise_log2"]["value"] < -1
    assert set(r["metrics"]) == {"op_ms", "setup_s"}
    r = harness.run_cell(CELL, SEED + 1, 0.2, True, "cpu", root)
    assert r["correct"], r["checks"]
    # no device trace on the CPU: the host-clock share alone is read
    assert set(r["metrics"]) == {"mfu.bfv"}
    assert {m["name"] for m in harness.cell_spec(CELL, root)["per_layer"]} \
        == {"idle_pct.bfv", "kernels.bfv", "mfu.bfv", "ntt_roofline.bfv",
            "ks_roofline.bfv", "bfv_basis_roofline.bfv"}


def unchanged(request):
    """The request's own first operand returned as its output."""
    return lambda i: request.__self__.pool[i % len(request.__self__.pool)][0]


def altered(request):
    """One coefficient of one limb of the output, plus one."""
    def run(i):
        out = request(i)
        data = out.data.clone()
        data[1, 0, 7] += 1
        return type(out)(ids=out.ids, data=data)
    return run


@pytest.mark.parametrize("fault", [unchanged, altered])
def test_broken_request_is_not_correct(root, fault):
    r = harness.run_cell(CELL, SEED, 0.1, False, "cpu", root, broken=fault)
    assert not r["correct"], r["checks"]
    assert r["checks"]["wrong_slots"]["value"] > 0


def test_float32_control_is_not_correct(root, capsys):
    assert calibrate.main(["--workload", CELL, "--seconds", "0.1", "--seeds",
                           str(SEED), "--control", "float32", "--device",
                           "cpu"], root=root) == 0
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last["program_correct"] is True
    assert last["control_correct"] == {"float32": False}
    assert last["control_min"]["float32.wrong_slots"] > 0
    assert last["program_max"]["wrong_slots"] == 0


def _moduli(cfg):
    return ref_bfv.bfv_moduli(**cfg["params"])


def test_inventory_matches_the_port_calls():
    """The calls the port's mul_relin_new makes on the CPU route, in
    work.py's form, are the inventory's, the conversions included."""
    from mkhe_tpu_torch.ops import basis_cuda
    st = BFV.State(TINY, {"pool": 1, "warmup": 1},
                   harness.seeds_of(SEED), "cpu", None)
    st.request(0)
    mod_up = basis_cuda.mod_up
    with recorded() as calls:
        def wrapped(x, t):
            out = mod_up(x, t)
            calls.append(("mod_up", int(np.prod(x.shape[:-1])),
                          int(np.prod(out.shape[:-1]))))
            return out
        basis_cuda.mod_up = wrapped
        try:
            st.request(0)
        finally:
            basis_cuda.mod_up = mod_up
    w = BFV.inventory(dict(TINY["params"], parties=4), _moduli(TINY))
    assert collections.Counter(calls) == collections.Counter(w.calls)
    assert all(c in w.calls for c in w.double_basis)


def test_inventory_step_counts_at_pn15qp880():
    """28 + 28 limbs, P of 4, alpha 2, 4 parties: 2 beta = 28 digits of
    the R-basis operands, 14 of t, each over 32 QP limbs; three 28 -> 28
    conversions of 5 polys and the quantize's ModDown by the 28 QMul
    limbs; NTTs over the 56 limbs of R."""
    cfg = json.loads((HOME / "configs" / "bfv_pn15qp880_4p.json")
                     .read_text())
    q, qmul, p = _moduli(cfg)
    assert (len(q), len(qmul), len(p)) == (28, 28, 4)
    w = BFV.inventory(dict(cfg["params"], parties=4), (q, qmul, p))
    assert w.alpha == 2 and w.beta(28) == 14 and w.beta(56) == 28
    calls = collections.Counter(w.calls)
    assert calls == collections.Counter({
        ("mod_up", 5 * 28, 5 * 28): 3,
        ("mod_up", 4 * 56, 4 * 28 * 32): 2,
        ("ntt", 4 * 28, 32): 2,
        ("mul_accum", 4 * 28 * 32, 4 * 28 * 32, 28 * 32): 2,
        ("ntt", 5, 56): 2, ("intt", 5, 56): 1,
        ("mod_down", 5, 28, 28): 1,
        ("mul_accum", 4 * 28 * 32, 28 * 32, 4 * 32): 2,
        ("intt", 8, 32): 1, ("mod_down", 8, 28, 4): 1,
        ("mod_up", 4 * 28, 4 * 14 * 32): 1, ("ntt", 4 * 14, 32): 1,
        ("mul_accum", 4 * 14 * 32, 4 * 14 * 32, 32): 1,
        ("mul_accum", 4 * 14 * 32, 14 * 32, 4 * 32): 1,
        ("intt", 5, 32): 1, ("mod_down", 5, 28, 4): 1})
    assert w.double_basis == [("mod_up", 140, 140)] * 3 + [
        ("mod_down", 5, 28, 28)]
    assert w.reads["ct0"] == w.reads["out"] == 5 * 28
    assert w.reads["rlk.b.0"] == w.reads["rlk.d.3"] == 28 * 32
    assert w.reads["rlk.v.2"] == w.reads["crs.u"] == 14 * 32
    # the conversions: 3 x (140 + 140) + 5 x (2 x 28 + 28) words of 2^15
    least = w.seconds(3 * 280 + 5 * 84)
    assert least == pytest.approx(1260 * 2 ** 15 * 4 / 3.35e12)


def _trace(names):
    tr = harness.Trace.__new__(harness.Trace)
    tr.requests = 1
    tr.kernels = [(n, 0.0, 10.0) for n in names]
    return tr


def test_double_basis_reader():
    read = harness.reader(HOME, "bfv_basis_roofline.bfv")
    maps = harness.kernel_maps(HOME)
    w = BFV.inventory(dict(TINY["params"], parties=4), _moduli(TINY))
    ctx = {"trace": _trace(["void (anonymous namespace)::basis_kernel<2, "
                            "false>((anonymous namespace)::BasisArgs)",
                            "mul_accum_kernel"]),
           "work": w, "kernel_maps": maps}
    assert read(ctx) is None
    ctx["trace"] = _trace(["void (anonymous namespace)::basis_kernel<32, "
                           "true>((anonymous namespace)::BasisArgs)"])
    assert read(ctx) > 0
    ctx["work"] = harness.kind(HOME, "ckks_mulrelin").inventory(
        dict(CKKS["params"], parties=4), primes.ckks_moduli(**CKKS["params"]))
    assert read(ctx) is None           # a request that converts no basis



def test_reference_loads_nothing_of_either_package(tmp_path):
    got = _run("""
        import json, sys
        import torch
        from hebench.reference import bfv
        q, _, _ = bfv.bfv_moduli(logn=10, q_bits=26.5, q_count=3,
                                 p_bits=28.4, p_count=2)
        data = torch.randint(0, q[0], (3, len(q), 1024))
        bfv.open_ciphertext(data, torch.zeros(2, 1024), q, 65537)
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
        """, tmp_path)
    assert not (FORBIDDEN | {"mkhe_tpu_torch"}) & set(got)
