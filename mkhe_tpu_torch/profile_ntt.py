"""Time the NTT kernels on the card at the main path's shapes, against
their bound and, optionally, the kernels of another checkout.

    python -m mkhe_tpu_torch.profile_ntt [--other DIR] [--reps N] [--split]

Shapes (polynomials x limbs x N, the QP moduli of the preset):
  pn15    8 x 32 x 2^15, PN15QP880 (phase 3 of chip_smoke.py);
  cnn     8 x 18 x 2^14, PN14QP433_CNN;
  digits  4 x 14 x 32 x 2^15, PN15QP880: one decomposition's digit NTT of
          the 4-party mult (1792 polynomials);
  cnn_hoist  2 x 7 x 18 x 2^14, PN14QP433_CNN: a CNN hoisting's digit NTT
          of the two parties (252 polynomials).
Variants: `new` (this checkout's Ring.ntt / Ring.intt) and, with
--other, `old`: those of another checkout (e.g. the parent commit
unpacked with `git archive` into build/), loaded beside this one in the
same process (profile_ab.load_other) with its own kernels and tables.
With --split, config.ntt_mxu_tail is on for both checkouts (whatever
each launches for Ring.ntt / Ring.intt: here csrc/ntt_split.cu's fused
forward and fused inverse, one launch each), and a third variant, `full`,
is this checkout's unsplit Ring.ntt / Ring.intt (csrc/ntt.cu); the bound
is this checkout's split path's (ntt_split_fwd; ntt_split_inv).
Each variant's output must equal the new one's bit for bit (and the plain
version's at pn15). Times are medians of `reps` CUDA-event timings per
turn, each the mean of 10 back-to-back calls, the variants in turns old,
new(, full, full), new, old; the last line is one JSON object.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
from pathlib import Path

import torch

from . import config, profile_ab
from .mkckks import params as ckks_params
from .ops import ntt_cuda
from .ops.ring import Ring

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM (NVIDIA data sheet)
# 132 SMs x 64 INT32 lanes x 1.98 GHz: int32 instructions per second (half
# the float32 lanes behind the 67 TFLOP/s of the same data sheet)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
INT8_OPS_PER_S = 1.979e15                 # dense int8 tensor-core rate

SHAPES = {"pn15": ("PN15QP880", (8,)), "cnn": ("PN14QP433_CNN", (8,)),
          "digits": ("PN15QP880", (4, 14)),
          "cnn_hoist": ("PN14QP433_CNN", (2, 7))}


def qp_ring(preset: str, device="cuda", ring_cls=Ring):
    """The QP ring of a CKKS preset, without its keys or CRS."""
    kw = dict(ckks_params._PRESETS[preset])
    logn = kw.pop("logn")
    kw.pop("logslots")
    kw.pop("scale")
    q, p = ckks_params.select_moduli(logn, **kw)
    return ring_cls.create(q + p, logn, device)


def bound(nbytes: int, int32_ops: int = 0, int8_ops: int = 0):
    """(ms, "bytes" or "operations"): the least time an H100 could take to
    move nbytes through HBM and do the operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(int32_ops / INT32_OPS_PER_S, int8_ops / INT8_OPS_PER_S)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_work(name: str, x, tables, stages: int = 0, mul: bool = True):
    """(bytes, int32 operations, int8 operations) of one launch of an NTT
    kernel on x (..., L, N) with its tables: x read once and the output
    written once (int64), every table and constant read once; 6 int32
    operations a butterfly (three products, three sums), 3 a coefficient
    for the Barrett reduction and 4 for each multiply by a per-coefficient
    or per-limb constant (twist, untwist, N^-1); the split kernel's tail
    (ntt_tail, after the head in ntt_split_fwd, before the DIT stages in
    ntt_split_inv): 16 u8 digit-plane products (2 x 128 int8 operations a
    coefficient each) and the recombination of 7 partial sums (3 a term,
    6 for the Montgomery step).
    "ntt_variant" (the probe's transform, `stages` DIF stages, twiddle
    multiplies if `mul`): 6 a butterfly of a stage with a multiply (every
    stage but h = 1 when mul), 3 (the sums) a butterfly of one without, and
    4 a coefficient for the twist, whether the exchange is on or off (the
    same function of the same inputs); its tables are what it reads: q,
    the packed twist and the packed wpack entries of the stages that
    multiply (ntt_probe.variant_reads)."""
    n, logn = x.numel(), x.shape[-1].bit_length() - 1
    nbytes = 16 * n + sum(t.numel() * t.element_size() for t in tables)
    bfly, int8 = n // 2, 0
    sums = 2 * ntt_cuda.FRAG_PLANES - 1
    recomb = 3 * sums + 6
    muls = (stages - (stages == logn)) if mul else 0
    ops = {"ntt_fwd": 6 * bfly * logn + 3 * n,
           "ntt_inv": 6 * bfly * logn + 7 * n,
           "ntt_fwd_head": 6 * bfly * (logn - 7) + 4 * n,
           "ntt_inv_tailed": 6 * bfly * (logn - 7) + 7 * n,
           "ntt_tail": recomb * n,
           "ntt_split_fwd": 6 * bfly * (logn - 7) + 4 * n + recomb * n,
           "ntt_split_inv": 6 * bfly * (logn - 7) + 4 * n + recomb * n,
           "ntt_variant": 6 * bfly * muls + 3 * bfly * (stages - muls)
           + 4 * n}[name]
    if name in ("ntt_tail", "ntt_split_fwd", "ntt_split_inv"):
        int8 = ntt_cuda.FRAG_PLANES ** 2 * 2 * ntt_cuda.TAIL_LANES * n
    return nbytes, ops, int8


def kernel_bound(name: str, x, tables, stages: int = 0, mul: bool = True):
    """bound() of kernel_work: the least ms an H100 could take for one
    launch, and whether bytes or operations set it."""
    return bound(*kernel_work(name, x, tables, stages, mul))


def cuda_ms(fn, reps: int, inner: int = 10) -> float:
    """Median over reps runs (CUDA events, after a warm-up) of the mean ms
    of `inner` back-to-back calls of fn(): the queue stays ahead of the
    card, so the host's launch time stays out of a kernel's time."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(fn, reps: int, inner: int = 10) -> float:
    """Median over reps replays (CUDA events) of a CUDA graph of `inner`
    calls of fn(), per call: the device's time alone, also where a call's
    host work outlasts its kernel and cuda_ms would time the host. (A
    wrapper's launch counter sees the captured calls, not the replays.)"""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _switched(cfg, on: bool, fn):
    """fn, called with cfg.ntt_mxu_tail = on (then off again)."""
    def call():
        cfg.ntt_mxu_tail = on
        try:
            return fn()
        finally:
            cfg.ntt_mxu_tail = False
    return call


def split_bound(ring, inp, fwd: bool):
    """The split path's bound on inp: the fused forward's or the fused
    inverse's; each counts the tables it reads (the stages only the wpack
    or iwpack entries h >= 128 take)."""
    st = ring.split_tables()
    if fwd:
        return kernel_bound("ntt_split_fwd", inp, (
            ring.q, st.twist_pack, st.wpack_pack[:, :ring.n - 128],
            st.tail_fwd_frag, st.tail_pow8))
    return kernel_bound("ntt_split_inv", inp, (
        ring.q, st.untwist_pack, st.iwpack_pack[:, :ring.n - 128],
        st.tail_inv_frag, st.tail_pow8))


def run(reps: int, other=None, split: bool = False) -> dict:
    pkgs = {"new": (Ring, config)}
    if other:
        profile_ab.load_other(Path(other).resolve())
        pkgs["old"] = (importlib.import_module(
            profile_ab.OTHER + ".ops.ring").Ring,
            importlib.import_module(profile_ab.OTHER + ".config"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2024)
    result = {}
    for label, (preset, batch) in SHAPES.items():
        rs = {name: qp_ring(preset, ring_cls=cls)
              for name, (cls, _) in pkgs.items()}
        ring = rs["new"]
        subjects = [(name, rs[name], cfg, split)
                    for name, (_, cfg) in pkgs.items()]
        if split:
            subjects.append(("full", ring, config, False))
        x = torch.randint(0, 1 << 32, (*batch, ring.nlimbs, ring.n),
                          generator=gen, dtype=torch.int64, device="cuda")
        x_inv = x % (8 * ring.q[:, None])
        n_polys = x.numel() >> ring.logn
        row = {"shape": [*batch, ring.nlimbs, ring.n], "n_polys": n_polys}
        for fwd, inp in ((True, x), (False, x_inv)):
            kind = "fwd" if fwd else "inv"
            var = {name: _switched(cfg, on, (lambda r=r: r.ntt(inp)) if fwd
                                   else (lambda r=r: r.intt(inp)))
                   for name, r, cfg, on in subjects}
            want = var["new"]()
            if label == "pn15":
                plain = (ntt_cuda.ntt_plain(inp, ring.q, ring.bar, ring.psi,
                                            ring.psi_sh) if fwd else
                         ntt_cuda.intt_plain(inp, ring.q, ring.bar, ring.ipsi,
                                             ring.ipsi_sh, ring.ninv,
                                             ring.ninv_sh))
                if not torch.equal(want, plain):
                    raise AssertionError(f"{label} {kind}: new != plain")
            for name, fn in var.items():
                if not torch.equal(fn(), want):
                    raise AssertionError(f"{label} {kind}: {name} != new")
            names = [n for n in ("old", "new", "full") if n in var]
            times = {name: [] for name in names}
            for name in names + names[::-1]:
                times[name].append(cuda_ms(var[name], reps))
            if split:
                b_ms, b_by = split_bound(ring, inp, fwd)
            else:
                b_ms, b_by = kernel_bound(
                    "ntt_" + kind, inp,
                    (ring.psi_pack, ring.q, ring.bar) if fwd else
                    (ring.ipsi_pack, ring.q, ring.bar, ring.ninv,
                     ring.ninv_sh))
            row[kind] = {"bound_ms": b_ms, "bound_by": b_by, "ms": times,
                         "share": {name: b_ms / statistics.median(t)
                                   for name, t in times.items()}}
        result[label] = row
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="root of another checkout")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--split", action="store_true",
                    help="time the split NTT (config.ntt_mxu_tail) and this "
                         "checkout's full kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_ntt needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print("ptxas: " + " | ".join(ntt_cuda.ptxas_lines(ntt_cuda.build())),
          flush=True)
    res = run(args.reps, args.other, args.split)
    for label, row in res.items():
        for kind in ("fwd", "inv"):
            r = row[kind]
            print(f"{label} {row['shape']} {kind}: bound {r['bound_ms']:.4f} "
                  f"ms ({r['bound_by']}); " + ", ".join(
                      f"{name} {[round(t, 4) for t in ts]} (share "
                      f"{r['share'][name]:.3f})"
                      for name, ts in r["ms"].items()), flush=True)
    print(json.dumps({"device": smi, "split": args.split, "ntt": res}),
          flush=True)


if __name__ == "__main__":
    main()
