"""Readings that the limits of `correct` are set from: the program's
compared numbers over many seeds, and the control's (the reference
computed in a lower precision, put in the program's place) on the same
kept requests, in one process.

    python3 hebench/calibrate.py --workload <cell> --seconds 2 \\
        --control complex64 --seeds 11 12 13 ...

Prints one JSON line per seed, with whether the program and each control
came out correct by the cell's own limits, and a summary line last: the
cell's limits, the largest reading of the program and the smallest of
each control, per number, and each control's verdict over all seeds.
Exits with 1 where a control came out correct on some seed, or the
program did not. The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None, root: Path = ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch
    from hebench import harness
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    worst, least = {}, {}
    program_ok, control_ok = True, {c: False for c in args.control}
    for seed in args.seeds:
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             args.device, root, controls=args.control)
        controls = r.get("controls", {})
        line = {"seed": seed, "correct": r["correct"],
                "attempted": r["attempted"],
                "setup_s": r["metrics"]["setup_s"]["value"],
                "program": {k: c["value"] for k, c in r["checks"].items()},
                "controls": {name: {"correct": c["correct"], **{
                    k: n["value"] for k, n in c["checks"].items()}}
                    for name, c in controls.items()}}
        print(json.dumps(line), flush=True)
        program_ok &= r["correct"]
        for k, v in line["program"].items():
            worst[k] = max(worst.get(k, v), v)
        for name, c in controls.items():
            control_ok[name] |= c["correct"]
            for k, n in c["checks"].items():
                key = f"{name}.{k}"
                least[key] = min(least.get(key, n["value"]), n["value"])
    limits = harness.cell_spec(args.workload, root)["cell"]["limits"]
    print(json.dumps({"limits": limits, "program_max": worst,
                      "program_correct": program_ok, "control_min": least,
                      "control_correct": control_ok,
                      "device": harness.device_info(
                          torch.device(args.device), 1)}), flush=True)
    if any(control_ok.values()):
        print("a control came out correct: the limits do not separate it "
              "from the program", file=sys.stderr)
    return 0 if program_ok and not any(control_ok.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
