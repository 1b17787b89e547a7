"""A copy of the benchmark's data files at CPU-sized configurations, for
the tests: the real metrics, kernel maps, request kinds and traffic
mixes, with tiny configurations, a staged CNN mix and cells of their own
written beside them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import torch

# a few threads a test process: pytest-xdist's workers share the cores
torch.set_num_threads(2)

HOME = Path(__file__).resolve().parent.parent
ROOT = HOME.parent

CKKS = {"name": "ckks_tiny", "scheme": "ckks",
        "params": {"logn": 10, "logslots": 9, "q0_bits": 28.9,
                   "level_bits": 20.0, "levels": 4, "scale": 2.0 ** 40,
                   "p_bits": 28.4, "p_count": 4, "gamma": 2},
        "parties": 4}
MINI = {"image": 8, "num_kernels": 5, "ksize": 4, "fc_units": 32,
        "classes": 10, "quad": 128, "gap": 32}
CNN = {"name": "cnn_mini", "scheme": "ckks",
       "params": {"logn": 11, "logslots": 10, "q0_bits": 28.9,
                  "level_bits": 20.0, "levels": 7, "scale": 2.0 ** 40,
                  "p_bits": 28.4, "p_count": 4, "gamma": 2},
       "parties": 2, "layout": MINI, "weights": "mini_weights.npz"}
# limits between the port's readings at these sizes (2^-25.4, 2.1e-5) and
# their controls' (complex64 2^-23.5, float16 1.6e-4)
CELLS = {"tiny.mulrelin": ("ckks_tiny", "mulrelin", "max_err_log2", -24.5),
         "tiny.ptmul": ("ckks_tiny", "ptmul", "max_err_log2", -24.5),
         "mini.infer": ("cnn_mini", "infer_staged", "max_logit_err", 6e-5),
         "mini.infer_fused": ("cnn_mini", "infer_fused", "max_logit_err",
                              6e-5)}


def mini_weights(seed: int = 0):
    rng = np.random.default_rng(seed)
    co = (MINI["image"] - MINI["ksize"]) // 2 + 1
    return {"kernels": rng.normal(0, 0.3, (5, 4, 4)),
            "fc1": rng.normal(0, 0.1, (5 * co * co, MINI["fc_units"])),
            "fc2": rng.normal(0, 0.1, (MINI["fc_units"], 10)),
            "b1": rng.normal(0, 0.1, MINI["fc_units"]),
            "b2": rng.normal(0, 0.1, 10)}


def make_root(tmp: Path, pool: int = 2) -> Path:
    """tmp as a checkout: BENCHMARK.json with the tiny cells and the
    benchmark's metrics, hebench/'s data folders and request kinds, the
    tiny files."""
    home = tmp / "hebench"
    for sub in ("metrics", "kernel_maps", "traffic", "kinds"):
        shutil.copytree(HOME / sub, home / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for sub in ("configs", "workloads"):
        (home / sub).mkdir(parents=True)
    (home / "traffic" / "infer_staged.json").write_text(json.dumps(
        {"kind": "cnn", "mode": "staged", "pool": pool, "warmup": 1}))
    for mix in (home / "traffic").glob("*.json"):
        doc = json.loads(mix.read_text())
        doc.update(pool=pool, warmup=1)
        mix.write_text(json.dumps(doc))
    np.savez(tmp / "mini_weights.npz", **mini_weights())
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = []
    for cfg in (CKKS, CNN):
        path = home / "configs" / f"{cfg['name']}.json"
        path.write_text(json.dumps(cfg))
        bench["configs"].append({"name": cfg["name"], "source": "test",
                                 "file": f"hebench/configs/{path.name}",
                                 "reduced": [], "why": "test"})
    bench["workloads"] = []
    for name, (cfg, mix, number, limit) in CELLS.items():
        bench["workloads"].append({"name": name, "config": cfg,
                                   "traffic": mix, "chips": 1, "why": "test"})
        (home / "workloads" / f"{name}.json").write_text(json.dumps(
            {"sample": 2, "trace_requests": 2,
             "limits": {number: limit, "not_small": 0}}))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = (["mini.infer", "mini.infer_fused"]
                              if "infer" in m["name"] else ["tiny.ptmul"]
                              if "ptmul" in m["name"] else ["tiny.mulrelin"])
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
