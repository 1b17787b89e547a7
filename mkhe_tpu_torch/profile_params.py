"""Set-up seconds of the parameter sets chip_smoke.py holds (CKKS and BFV
PN15QP880, CKKS PN14QP433_CNN), this checkout against another one in one
process, in turns.

    python -m mkhe_tpu_torch.profile_params [--other DIR]

Three readings a set, each on the host clock between two synchronizes:
construction, one uncached build of the preset's recipe through the
package's mk{scheme}.new_parameters (the rings, their NTT tables and every
default CRS); keygen, KeyGenerator(seed=1) on the set's RLWE parameters
making a key pair and the relinearization key (r its next secret key);
encrypt, one Encryptor(seed=2).encrypt of fixed_plaintext under that pk.
Each set is measured once per checkout before the ROUNDS rounds (the first
build of a process also builds what later builds find cached), and
dropped after each measurement, so that one set at a time lies on the
card. Per round and set, the order is other, this, this, other (this alone
without --other; DIR as for profile_ab). The last line is one JSON object
of every reading.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import time
from pathlib import Path
from typing import Sequence

import torch

from .config import get_device
from .mkbfv.params import preset_moduli
from .mkckks.params import _PRESETS as CKKS_PRESETS

SETS = (("ckks", "PN15QP880"), ("bfv", "PN15QP880"),
        ("ckks", "PN14QP433_CNN"))
READINGS = ("construction_s", "keygen_s", "encrypt_s")
ROUNDS = 2


def fixed_plaintext(moduli: Sequence[int], n: int, device=None
                    ) -> torch.Tensor:
    """A plaintext (L, N) fixed by its moduli and N alone, (7919 i + 104729
    j) mod q_j, for digests of encryptions that no float encoding enters."""
    i = torch.arange(n, dtype=torch.int64)
    q = torch.tensor([int(m) for m in moduli], dtype=torch.int64)[:, None]
    j = torch.arange(len(q), dtype=torch.int64)[:, None]
    return ((7919 * i + 104729 * j) % q).to(get_device(device))


def timed(f, device):
    """f() and its seconds on the host clock between two synchronizes."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = f()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def build(scheme: str, name: str, device="cuda", pkg: str = __package__):
    """A fresh preset `name` of package pkg's mk{scheme} on device, built
    from this package's recipe (the presets' cache passed by), and its
    construction seconds."""
    mk = importlib.import_module(f"{pkg}.mk{scheme}")
    args, kw = (((), CKKS_PRESETS[name]) if scheme == "ckks"
                else (preset_moduli(name), {}))
    return timed(lambda: mk.new_parameters(*args, **kw, device=device),
                 device)


def measure(scheme: str, name: str, device="cuda",
            pkg: str = __package__) -> dict:
    """{reading: seconds} of one set in package pkg (see the docstring)."""
    params, construction_s = build(scheme, name, device, pkg)
    rp = params.rlwe
    mkrlwe = importlib.import_module(f"{pkg}.mkrlwe")

    def keygen():
        kgen = mkrlwe.KeyGenerator(rp, seed=1)
        sk, pk = kgen.gen_key_pair("user0")
        kgen.gen_relinearization_key(sk, kgen.gen_secret_key("user0"))
        return pk

    pk, keygen_s = timed(keygen, device)
    pt = fixed_plaintext(rp.q_moduli, rp.n, device)
    _, encrypt_s = timed(
        lambda: mkrlwe.Encryptor(rp, seed=2).encrypt(pt, pk), device)
    return {"construction_s": construction_s, "keygen_s": keygen_s,
            "encrypt_s": encrypt_s}


def run(pkgs: dict, device="cuda") -> dict:
    """{label: {set: {reading: [seconds, ...]}}} for each package of pkgs
    (label -> package name), in the turns the docstring gives."""
    order = (("other", "this", "this", "other") if "other" in pkgs
             else ("this",))
    res = {t: {f"{s}_{n}": {r: [] for r in READINGS} for s, n in SETS}
           for t in pkgs}
    for pkg in pkgs.values():
        for s, n in SETS:
            measure(s, n, device, pkg)
            torch.cuda.empty_cache()
    for _ in range(ROUNDS):
        for s, n in SETS:
            for t in order:
                for r, secs in measure(s, n, device, pkgs[t]).items():
                    res[t][f"{s}_{n}"][r].append(secs)
                torch.cuda.empty_cache()
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="root of another checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_params needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    pkgs = {"this": __package__}
    if args.other:
        from .profile_ab import OTHER, load_other
        load_other(Path(args.other).resolve())
        pkgs["other"] = OTHER
    res = run(pkgs)
    for t, sets in res.items():
        for k, rs in sets.items():
            print(f"{t} {k}: " + "; ".join(
                f"{r} {vs} (median {statistics.median(vs)})"
                for r, vs in rs.items()), flush=True)
    print(json.dumps({"device": smi, "rounds": ROUNDS, "seconds": res}),
          flush=True)


if __name__ == "__main__":
    main()
