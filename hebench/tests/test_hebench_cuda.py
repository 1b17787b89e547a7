"""On the card: one short run of each cell, correct, with the contract's
result line. Skips without a card; run on the chip with
`python -m pytest hebench/tests/test_hebench_cuda.py -q -o addopts=""`."""

import json
import subprocess
import sys

import pytest
import torch

from _tiny import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ckks4.mulrelin", "cnn2.infer_fused",
                                  "ckks4.ptmul"])
def test_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "hebench/run.py", "--workload",
                          cell, "--seed", "2147483659", "--seconds", "2",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
