"""The harness is driven by data: a configuration, a cell, a per-layer
metric and a kernel map added as files are picked up; the trace's
reduction; BENCHMARK.json against the benchmark's own files; and the
command fails without a card."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from _tiny import ROOT, make_root
from hebench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


def test_new_files_are_picked_up(root):
    """The tiny configurations and cells of _tiny are themselves files the
    harness never saw; a new reader and a new kernel map join them. A
    per-layer metric without a `workloads` key is read in every cell that
    reports the end-to-end metric it moves, and in no other."""
    home = root / "hebench"
    (home / "metrics" / "answer.py").write_text(
        "def read(ctx):\n    return 42.0 + ctx['requests'] * 0\n")
    (home / "kernel_maps" / "extra.json").write_text(json.dumps(
        {"layer": "ntt", "kernels": ["extra_ntt_kernel"]}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "answer", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "evaluator", "moves": "ptmul_ms"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    maps = harness.kernel_maps(home)
    assert "extra_ntt_kernel" in maps["ntt"] and "ntt_kernel" in maps["ntt"]
    r = harness.run_cell("tiny.ptmul", 99, 0.2, True, "cpu", root)
    assert r["metrics"]["answer"]["value"] == 42.0
    assert "mfu.ptmul" in r["metrics"]
    assert list(r)[-1] == "checks"
    r = harness.run_cell("tiny.ptmul", 99, 0.2, False, "cpu", root)
    assert set(r["metrics"]) == {"ptmul_ms", "ptmul_ms.p95", "setup_s"}
    assert r["setup_steps"]["compiled"] is False
    assert "answer" not in {m["name"] for m in
                            harness.cell_spec("tiny.mulrelin",
                                              root)["per_layer"]}


ADD_KIND = '''
"""ckks_add: one Evaluator.add_new(ct0, ct1) a request."""
from hebench import work as W
from hebench.parties import CkksOp


def inventory(cfg, moduli):
    w = W.Work.of(cfg, moduli)
    k, limbs = cfg["parties"], len(moduli[0])
    for name in ("ct0", "ct1", "out"):
        w.read(name, (k + 1) * limbs)
    return w


class State(CkksOp):
    def __init__(self, cfg, mix, seeds, device, root):
        super().__init__(cfg, mix, seeds, device, root)
        self.work = inventory(dict(cfg["params"], parties=cfg["parties"]),
                              self.moduli)

    def operands(self, m):
        cts = self.parties_encrypt(m)
        ct0, ct1 = cts[0], cts[1]
        for c in cts[2:]:
            ct0 = self.ev.add_new(ct0, c)
        return ct0, ct1

    def call(self, operands):
        return self.ev.add_new(*operands)

    def expected(self, m):
        return m.sum(0)

    def out_scale_level(self):
        return self.scale, len(self.moduli[0]) - 1
'''


def test_new_request_kind_is_picked_up(tmp_path):
    """A request kind, its traffic mix and its cell added as files: the
    harness runs them, and the reference judges the new op."""
    root = make_root(tmp_path)
    home = root / "hebench"
    (home / "kinds" / "ckks_add.py").write_text(ADD_KIND)
    (home / "traffic" / "add.json").write_text(json.dumps(
        {"kind": "ckks_add", "pool": 2, "warmup": 1, "message": [0.1, 1.0]}))
    (home / "workloads" / "tiny.add.json").write_text(json.dumps(
        {"sample": 2, "trace_requests": 2,
         "limits": {"max_err_log2": -24.5, "not_small": 0}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.add", "config": "ckks_tiny",
                               "traffic": "add", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "add_ms", "unit": "ms",
                                "better": "lower", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["tiny.add"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = harness.run_cell("tiny.add", 2 ** 31 + 17, 0.2, False, "cpu", root)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"add_ms", "setup_s"}
    broken = harness.run_cell(
        "tiny.add", 2 ** 31 + 17, 0.2, False, "cpu", root,
        broken=lambda req: lambda i: req.__self__.pool[i % 2][0])
    assert not broken["correct"], broken["checks"]


def test_trace_union_gaps_and_breakdown():
    tr = harness.Trace.__new__(harness.Trace)
    tr.device_ops = [("k1", 0.0, 10.0), ("k2", 5.0, 12.0),
                     ("Memcpy HtoD", 20.0, 22.0), ("k1", 30.0, 31.0)]
    tr.kernels = [d for d in tr.device_ops if not d[0].startswith("Memcpy")]
    import numpy as np
    tr.host_start = np.array([0.0, 11.0, 21.0])
    tr.host_name = ["launch", "sync", "python"]
    busy, gaps = tr._union()
    assert busy == 15.0 and gaps == [(12.0, 8.0), (22.0, 8.0)]
    tr.gaps = gaps
    assert tr.time_of(["k1"]) == 11e-6
    b = tr.breakdown()
    assert b["device_ops"][0][0] == "k1"
    assert b["device_ops"][0][1] == pytest.approx(11e-6)
    assert dict(map(tuple, b["idle_gaps"])) == pytest.approx(
        {"sync": 8e-6, "python": 8e-6})


def test_benchmark_json_names_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    home = ROOT / "hebench"
    assert bench["paths"] == ["hebench"]
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics + bench["workloads"] + bench["configs"]:
        assert NAME.match(m["name"]), m["name"]
    names = {m["name"] for m in metrics}
    assert len(names) == len(metrics)
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and c["reduced"] == []
    for w in bench["workloads"]:
        assert (home / "workloads" / f"{w['name']}.json").is_file()
        mix = json.loads((home / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert harness.kind(home, mix["kind"]).State
        spec = harness.cell_spec(w["name"])
        assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
        assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
        moved = {m["name"] for m in spec["end_to_end"]}
        assert all(m["moves"] in moved for m in spec["per_layer"])
    for m in bench["per_layer"]:
        assert harness.reader(home, m["name"])
    assert set(harness.kernel_maps(home)) >= {"ntt", "keyswitch"}


def test_command_fails_without_a_card(tmp_path):
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
           "OMP_NUM_THREADS": "2",
           "CUDA_VISIBLE_DEVICES": ""}
    cmd = [sys.executable, "hebench/run.py", "--workload", "ckks4.mulrelin",
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0 and not out.stdout.strip()
    alone = tmp_path / "alone"
    shutil.copytree(ROOT / "hebench", alone / "hebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", alone)
    out = subprocess.run(cmd, cwd=alone, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0 and not out.stdout.strip()
