"""This checkout against another one in one process, in turns: the CKKS
mult, the CNN inference and the host cost of the NTT wrappers.

    python -m mkhe_tpu_torch.profile_ab --other DIR [--rounds N]

DIR is the root of another checkout (e.g. the parent commit unpacked with
`git archive` into build/, which git ignores). Its `mkhe_tpu_torch` is
loaded beside this one under another name, builds its own kernels into
DIR/build/, and runs on the same card in the same process, so that the
host's speed, which varies between processes and calls, varies alike for
both. Per round, in the order other, this, this, other:

  mult   the 4-party PN15QP880 mult+relin+rescale (profile_mult.setup):
         median ms of REPS mults from CUDA events;
  cnn    one two-party PN14QP433_CNN inference, REF layout
         (profile_cnn.setup / infer): median ms of REPS inferences from
         CUDA events, and from the host clock with a synchronize;
  ntt    host microseconds per Ring.ntt / Ring.intt call on the CNN's QP
         ring (1 x 18 limbs x 2^14), enqueueing CALLS calls and then
         synchronizing: the wrappers' checks and launch, which the
         kernel (~0.01 ms) does not hide.

Both checkouts are timed by this checkout's code (profile_mult.median_ms,
host_ms). The last line is one JSON object of every reading.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import profile_cnn, profile_mult

REPS = 5
CALLS = 500
OTHER = "mkhe_tpu_torch_other"


def load_other(root: Path):
    """The other checkout's package, imported under the name OTHER."""
    pkg = root / "mkhe_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        OTHER, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[OTHER] = mod
    spec.loader.exec_module(mod)
    return mod


def _modules(name: str) -> dict:
    return {m: importlib.import_module(f"{name}.{m}") for m in
            ("mkckks", "profile_cnn", "profile_mult", "models.cnn")}


def subjects(name: str) -> dict:
    """name -> timed callable, for the package `name`."""
    m = _modules(name)
    params = m["mkckks"].PN15QP880("cuda")
    ev, ct0, ct1, rlk = m["profile_mult"].setup(params, 4)
    cparams = m["mkckks"].PN14QP433_CNN("cuda")
    s = m["profile_cnn"].setup(cparams, m["models.cnn"].REF)
    ct_img = s.encrypt_image(m["profile_cnn"].image(s.layout,
                                                    profile_cnn.SEED))
    ring = cparams.rlwe.ring_qp
    gen = torch.Generator(device="cuda")
    gen.manual_seed(profile_cnn.SEED)
    x = torch.randint(0, 1 << 32, (1, ring.nlimbs, ring.n), generator=gen,
                      dtype=torch.int64, device="cuda")

    def host_us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) * 1e6 / CALLS

    return {"mult": lambda: ev.mul_relin_new(ct0, ct1, rlk),
            "cnn": lambda: m["profile_cnn"].infer(s, ct_img),
            "ntt": lambda: host_us(lambda: ring.ntt(x)),
            "intt": lambda: host_us(lambda: ring.intt(x))}


def run(other: Path, rounds: int) -> dict:
    load_other(other)
    dev = torch.device("cuda")
    subs = {"other": subjects(OTHER), "this": subjects(__package__)}
    res = {t: {"mult_ms": [], "cnn_ms": [], "cnn_host_ms": [], "ntt_us": [],
               "intt_us": []} for t in subs}
    for _ in range(rounds):
        for t in ("other", "this", "this", "other"):
            f, r = subs[t], res[t]
            r["mult_ms"].append(profile_mult.median_ms(f["mult"], REPS, dev))
            r["cnn_ms"].append(profile_mult.median_ms(f["cnn"], REPS, dev))
            r["cnn_host_ms"].append(profile_mult.host_ms(f["cnn"], REPS, dev))
            r["ntt_us"].append(f["ntt"]())
            r["intt_us"].append(f["intt"]())
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of another checkout")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_ab needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    res = run(Path(args.other).resolve(), args.rounds)
    for t, r in res.items():
        print(f"{t}: " + "; ".join(
            f"{k} {[round(v, 3) for v in vs]} (median "
            f"{statistics.median(vs):.3f})" for k, vs in r.items()),
            flush=True)
    print(json.dumps({"device": smi, "rounds": args.rounds, "reps": REPS,
                      "calls": CALLS, "ab": res}), flush=True)


if __name__ == "__main__":
    main()
