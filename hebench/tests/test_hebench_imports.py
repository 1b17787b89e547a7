"""The import rules: what the runner and the reference load, compared by
whole top-level module names, and what the runner reads from disk."""

import json
import subprocess
import sys
import textwrap

from _tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "mkhe_tpu"}


def _run(code: str, tmp_path) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
        capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
             "OMP_NUM_THREADS": "2",
             "PYTHONPATH": f"{ROOT}:{ROOT / 'hebench' / 'tests'}"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_runner_loads_no_jax_and_reads_no_old_benchmark(tmp_path):
    got = _run(f"""
        import json, sys
        opened = []
        sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                         if ev == "open" and args and isinstance(args[0], str)
                         else None)
        from pathlib import Path
        import _tiny
        from hebench import harness, run
        root = _tiny.make_root(Path({str(tmp_path)!r}))
        r = harness.run_cell("tiny.ptmul", 2**33 + 5, 0.2, True, "cpu", root)
        mods = sorted({{m.split(".")[0] for m in sys.modules}})
        print(json.dumps({{"mods": mods, "opened": opened,
                           "correct": r["correct"]}}))
        """, tmp_path)
    assert got["correct"]
    assert "mkhe_tpu_torch" in got["mods"]          # the port ran
    assert not FORBIDDEN & set(got["mods"])
    old = [p for p in got["opened"]
           if str(ROOT / "benchmarks") in p or p.endswith("bench.py")]
    assert not old


def test_reference_and_work_load_nothing_of_either_package(tmp_path):
    got = _run("""
        import json, sys
        import torch
        from hebench import work
        from hebench.reference import ckks, cnn, primes
        q, p = primes.ckks_moduli(logn=10, q0_bits=28.9, level_bits=20.0,
                                  levels=2, p_bits=28.4, p_count=2)
        data = torch.randint(0, q[-1], (3, len(q), 1024))
        ckks.open_ciphertext(data, torch.zeros(2, 1024), q, 2.0 ** 30, 512)
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
        """, tmp_path)
    assert not (FORBIDDEN | {"mkhe_tpu_torch"}) & set(got)


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from hebench import harness
    monkeypatch.setitem(sys.modules, "mkhe_tpu_torch", sys.modules[__name__])
    assert "mkhe_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mkhe_tpu.ops", sys.modules[__name__])
    assert harness.forbidden_modules() == ["mkhe_tpu"]
