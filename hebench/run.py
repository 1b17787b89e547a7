"""Run one benchmark cell once and print its result line.

    python3 hebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or `python3 -m hebench.run ...` from the repository's root). It needs a
CUDA card: without one, or with fewer than the cell asks for, it exits
with code 2 and prints no result. It never falls back to the CPU.
"""

import time

T_START = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch
    from hebench import harness
    spec = harness.cell_spec(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec["chips"]:
        print(f"{args.workload} needs {spec['chips']} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", ROOT, T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
