"""NTT cost probe: the forward NTT's time taken apart on the card (the
port of benchmarks/ntt_probe.py).

    python -m mkhe_tpu_torch.ntt_probe [--shape probe cnn digits]
                                       [--other DIR]
    python -m mkhe_tpu_torch.ntt_probe --device cpu [--logn 8]   # dry run

Runs the variant kernel (csrc/ntt_variant.cu, ops/ntt_cuda.ntt_variant)
in the TPU probe's six settings:
  full logN stages   every stage, exchange and twiddle multiplies on;
  stages=8, =1       the top 8 (logN - 2 below logN 9) or 1 stage only:
                     the slope per stage;
  no twiddle muls    every stage without a multiply: the twiddles' loads
                     and products;
  no rolls           every stage, each value its own partner: the exchange
                     (shared memory between register passes, barriers),
                     with the full row's twiddle loads and no branch;
  swap grid          the full row with the blocks in limb-major order, so
                     that a limb's tables stay in L2;
and the production forward kernel (ntt_fwd, what Ring.ntt runs) at the
same shape, against which the full row reads. Shapes: `probe`, 4 x 32 x
2^15 with ntt_primes(15, 28.9, 32) (the TPU probe's); `cnn` and `digits`,
those of profile_ntt.SHAPES. Any-u32 input from a seeded torch.Generator.
Before any timing, every row must equal its plain version
(ntt_variant_plain) and the full row Ring.ntt, bit for bit, or it raises.
Times: `ms`, profile_ntt.cuda_ms (median of REPS means of 10
back-to-back calls, CUDA events), and `graph_ms`, profile_ntt.graph_ms
(the same calls captured in a CUDA graph and replayed: the device's time
alone, where a call's host work outlasts its kernel), with us per limb
(per polynomial), the row's bound (profile_ntt.kernel_bound) and its
share of graph_ms; then, from graph_ms, the slope per stage (full -
stages=1) / (logN - 1), the twiddle share (full - no muls) / full, the
exchange share (full - no rolls) / full and swap grid - full; and each
variant kernel's static SASS counts (`sass_mix`), which show that a row
does the work it claims (loads the compiler kept, no shared memory
without the exchange, no twiddle products without the multiplies).
Prints nvidia-smi's "name, power.limit" line first and one JSON object
last. On the card unless --device cpu, which runs the checks alone
(plain versions, no times) at the probe's shape cut to --logn.

With --other DIR (the root of another checkout, e.g. the parent commit
unpacked with `git archive` into build/), that checkout's variant kernel
is loaded beside this one (profile_ab.load_other, its own kernels built
into DIR/build/), every row of it must equal this one's bit for bit, and
each of the six rows is timed in turns, other, this, this, other
(graph_ms each turn; `graph_ms` is then the mean of this checkout's two
turns, `other_graph_ms` the other's two, both against this checkout's
bound); the derived shares are given for both, and the other library's
SASS counts beside this one's. On the card only.
"""

from __future__ import annotations

import argparse
import importlib
import json
import re
import statistics
import subprocess
from pathlib import Path

import torch

from . import profile_ab, profile_ntt
from .ops import ntt_cuda
from .ops.primes import ntt_primes
from .ops.ring import Ring

SEED = 2024
PROBE_BATCH = 4
PROBE_LIMBS = 32
REPS = 20   # timings a row, each the mean of 10 calls


def variant_tables(ring: Ring) -> ntt_cuda.VariantTables:
    """The variant's tables of a ring (its split tables; building them
    leaves Ring.ntt's route alone, which config.ntt_mxu_tail decides)."""
    st = ring.split_tables()
    return ntt_cuda.VariantTables(
        ring.q, st.twist, st.twist_sh, st.wpack, st.wpack_sh, st.twist_pack,
        st.wpack_pack)


def rows(logn: int) -> list:
    """(name, ntt_variant settings) of the probe's six rows at logN."""
    mid = 8 if logn > 8 else max(1, logn - 2)
    full = dict(stages=logn, exchange=True, mul=True, order="poly")
    return [(f"full {logn} stages", full),
            (f"stages={mid}", dict(full, stages=mid)),
            ("stages=1", dict(full, stages=1)),
            ("no twiddle muls", dict(full, mul=False)),
            ("no rolls", dict(full, exchange=False)),
            ("swap grid (tables resident)", dict(full, order="limb"))]


def variant_reads(t: ntt_cuda.VariantTables, stages: int,
                  mul: bool) -> tuple:
    """The tables a variant launch reads, for its bound: q, the packed
    twist, and the packed wpack entries the kernel reads, each once
    (ntt_cuda.variant_twiddle_entries; none without the multiplies)."""
    logn = t.wpack.shape[-1].bit_length() - 1
    idx = ntt_cuda.variant_twiddle_entries(logn, stages) if mul else []
    return (t.q, t.twist_pack,
            t.wpack_pack[:, torch.as_tensor(idx, dtype=torch.long,
                                            device=t.wpack_pack.device)])


def load_other(root) -> tuple:
    """(ntt_cuda, ntt_probe, Ring) of another checkout, loaded beside this
    one (profile_ab.load_other)."""
    profile_ab.load_other(Path(root).resolve())
    return tuple(importlib.import_module(f"{profile_ab.OTHER}.{m}")
                 for m in ("ops.ntt_cuda", "ntt_probe")) + (
        importlib.import_module(f"{profile_ab.OTHER}.ops.ring").Ring,)


def _derived(ms: list, logn: int) -> dict:
    """The attribution from the six rows' graph_ms, in rows() order."""
    return dict(slope_ms_per_stage=(ms[0] - ms[2]) / (logn - 1),
                twiddle_share=(ms[0] - ms[3]) / ms[0],
                exchange_share=(ms[0] - ms[4]) / ms[0],
                swap_minus_full_ms=ms[5] - ms[0])


def probe(ring: Ring, batch: tuple, timed: bool, other=None) -> dict:
    """The six rows and the ntt_fwd row on (*batch, L, N) any-u32 input of
    the ring: checks, then (if timed) times, bounds and the attribution
    from the device times. other: load_other()'s modules, whose rows must
    equal these and are timed in turns with them."""
    t = variant_tables(ring)
    gen = torch.Generator(device=ring.device)
    gen.manual_seed(SEED)
    x = torch.randint(0, 1 << 32, (*batch, ring.nlimbs, ring.n),
                      generator=gen, dtype=torch.int64, device=ring.device)
    n_polys = x.numel() >> ring.logn
    settings = rows(ring.logn)
    full = ring.ntt(x)
    if other:
        o_cuda, o_probe, o_ring = other
        o_t = o_probe.variant_tables(o_ring.create(ring.moduli, ring.logn,
                                                   ring.device))
    for name, kw in settings:
        got = ntt_cuda.ntt_variant(x, t, **kw)
        plain = ntt_cuda.ntt_variant_plain(
            x, t, stages=kw["stages"], exchange=kw["exchange"],
            mul=kw["mul"])
        if not torch.equal(got, plain):
            raise AssertionError(f"{name}: kernel != plain in "
                                 f"{int((got != plain).sum())} values")
        if kw["stages"] == ring.logn and kw["exchange"] and kw["mul"] \
                and not torch.equal(got, full):
            raise AssertionError(f"{name}: != Ring.ntt")
        if other and not torch.equal(o_cuda.ntt_variant(x, o_t, **kw), got):
            raise AssertionError(f"{name}: the other checkout's kernel "
                                 f"differs from this one's")
        del got, plain
    res = {"shape": list(x.shape), "n_polys": n_polys, "rows": {}}
    if not timed:
        return res

    def row(name, fn, b_ms, b_by, other_fn=None):
        r = dict(ms=profile_ntt.cuda_ms(fn, REPS))
        if other_fn is None:
            r["graph_ms"] = profile_ntt.graph_ms(fn, REPS)
        else:
            turns = {"other": [], "this": []}
            for who in ("other", "this", "this", "other"):
                turns[who].append(profile_ntt.graph_ms(
                    fn if who == "this" else other_fn, REPS))
            r["graph_ms"] = statistics.mean(turns["this"])
            r.update(graph_ms_turns=turns["this"],
                     other_graph_ms=turns["other"],
                     other_share=b_ms / statistics.mean(turns["other"]))
        r.update(us_per_limb=r["graph_ms"] * 1e3 / n_polys, bound_ms=b_ms,
                 bound_by=b_by, share=b_ms / r["graph_ms"])
        res["rows"][name] = r

    for name, kw in settings:
        row(name, lambda kw=kw: ntt_cuda.ntt_variant(x, t, **kw),
            *profile_ntt.kernel_bound(
                "ntt_variant", x, variant_reads(t, kw["stages"], kw["mul"]),
                kw["stages"], kw["mul"]),
            other_fn=(lambda kw=kw: o_cuda.ntt_variant(x, o_t, **kw))
            if other else None)
    fwd = (ring.q, ring.bar, ring.psi, ring.psi_sh, ring.psi_pack)
    row("ntt_fwd (Ring.ntt)", lambda: ntt_cuda.ntt(x, *fwd),
        *profile_ntt.kernel_bound("ntt_fwd", x,
                                  (ring.psi_pack, ring.q, ring.bar)))
    res["derived"] = _derived([res["rows"][name]["graph_ms"]
                               for name, _ in settings], ring.logn)
    if other:
        res["other_derived"] = _derived(
            [statistics.mean(res["rows"][name]["other_graph_ms"])
             for name, _ in settings], ring.logn)
    return res


SASS_OPS = ("LDG", "LDS", "STS", "BAR", "BRA", "IMAD.HI")


def sass_mix(sass: str, logn: int) -> dict:
    """Static instruction counts of each variant kernel built at logN, from
    `cuobjdump -sass` of the library: global loads, shared loads and
    stores, barriers, branches, the high halves of 32-bit products
    (IMAD.HI: one in each lazy Shoup product, of the twist or of a
    twiddle) and all instructions (what a row's kernel issues, not how
    often). An opcode counts under each entry it starts with."""
    out = {}
    for body in sass.split("Function : ")[1:]:
        m = re.match(r"\S*ntt_variant_kernelILi(\d+)ELi(\d+)ELb([01])ELb([01])E",
                     body)
        if not m or int(m[1]) != logn:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z0-9]+(?:\.[A-Z0-9_]+)*)", body)
        out[f"stages={m[2]} exchange={m[3]} mul={m[4]}"] = dict(
            {op: sum(o == op or o.startswith(op + ".") for o in ops)
             for op in SASS_OPS}, all=len(ops))
    return out


def read_sass(lib=None) -> str:
    """`cuobjdump -sass` of the built library, or of `lib` (cuobjdump
    beside nvcc)."""
    tool = Path(ntt_cuda._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(lib or ntt_cuda.LIB_PATH)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout


def shape_ring(label: str, device, logn: int = 15):
    """(ring, batch) of a shape: `probe` (at logN, 15 on the card) or a
    profile_ntt.SHAPES entry."""
    if label == "probe":
        return (Ring.create(ntt_primes(logn, 28.9, PROBE_LIMBS), logn,
                            device), (PROBE_BATCH,))
    preset, batch = profile_ntt.SHAPES[label]
    return profile_ntt.qp_ring(preset, device), batch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", nargs="+", default=["probe"],
                    choices=["probe", "cnn", "digits"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--logn", type=int, default=None,
                    help="logN of the probe shape (default 15; 8 on cpu)")
    ap.add_argument("--other", metavar="DIR",
                    help="root of another checkout, timed in turns")
    args = ap.parse_args(argv)
    cpu = args.device == "cpu"
    if cpu and args.shape != ["probe"]:
        raise SystemExit("--device cpu runs the probe shape only")
    if cpu and args.other:
        raise SystemExit("--other times two checkouts' kernels on the card; "
                         "--device cpu runs no kernel and no times")
    if not cpu and not torch.cuda.is_available():
        raise SystemExit("ntt_probe needs a CUDA device (or --device cpu)")
    logn = args.logn or (8 if cpu else 15)
    if cpu:
        device = "cpu (plain versions only, no times)"
    else:
        device = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    print(device, flush=True)
    other = other_sass = None
    if not cpu:
        log = ntt_cuda.build()
        print("ptxas: " + (" | ".join(ntt_cuda.ptxas_lines(log)) or
                           "library up to date"), flush=True)
        sass = read_sass()
        if args.other:
            other = load_other(args.other)
            log = other[0].build()
            print("other ptxas: " + (" | ".join(ntt_cuda.ptxas_lines(log))
                                     or "library up to date"), flush=True)
            other_sass = read_sass(other[0].LIB_PATH)
    result = {}
    for label in args.shape:
        ring, batch = shape_ring(label, args.device, logn)
        res = probe(ring, batch, timed=not cpu, other=other)
        print(f"{label} {res['shape']}: every row equals its plain version"
              f" and the full row Ring.ntt" + (
                  ", and the other checkout's row" if other else ""),
              flush=True)
        for name, r in res["rows"].items():
            print(f"  {name:30s} {r['ms']:8.4f} ms, graph {r['graph_ms']:8.4f}"
                  f" ms  {r['us_per_limb']:7.3f} us/limb  bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']})  share "
                  f"{r['share']:.1%}" + (
                      f"  turns {r['graph_ms_turns']}, other "
                      f"{r['other_graph_ms']} (share {r['other_share']:.1%})"
                      if "other_graph_ms" in r else ""), flush=True)
        if not cpu:
            for key in ("derived", "other_derived"):
                if key not in res:
                    continue
                d = res[key]
                print(f"  {'other ' if key != 'derived' else ''}from "
                      f"graph_ms: slope {d['slope_ms_per_stage']:.5f} "
                      f"ms/stage, twiddle share {d['twiddle_share']:.1%}, "
                      f"exchange share {d['exchange_share']:.1%}, swap grid"
                      f" - full {d['swap_minus_full_ms']:+.4f} ms",
                      flush=True)
            res["sass"] = sass_mix(sass, ring.logn)
            if other_sass:
                res["other_sass"] = sass_mix(other_sass, ring.logn)
            for key in ("sass", "other_sass"):
                for kernel, mix in res.get(key, {}).items():
                    print(f"  {'other ' if key != 'sass' else ''}SASS "
                          f"{kernel}: " + ", ".join(
                              f"{op} {k}" for op, k in mix.items()),
                          flush=True)
        result[label] = res
    print(json.dumps({"device": device, "probe": result}), flush=True)


if __name__ == "__main__":
    main()
