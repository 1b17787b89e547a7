"""Where the time of one multi-party mult + relin + rescale goes.

    python -m mkhe_tpu_torch.profile_mult [--trace PATH] [--bfv | --batch B]

Builds PN15QP880 keys for 4 parties from a seed on the first CUDA device
and the bench operands (ct0 the running sum, ct1 the running difference of fresh
encryptions, as bench.py does), then prints:

  latency   median ms of Evaluator.mul_relin_new, from CUDA events and
            from the host clock with a synchronize;
  launches  NTT and key-switching kernel launches per mult (ops/ntt_cuda
            and ops/basis_cuda counters: `decompose_ntt` counts the fused
            decompositions, `mod_up` and `ntt_fwd` would count one that
            took the two-kernel path);
  steps     median ms (CUDA events) of each step mul_relin_new runs:
            hoisted_form (the fused decomposition, beside the mod_ups +
            digit NTT it replaces), mul_and_relin from hoisted digits
            (key aggregation, external products, party sum, ModDown) and
            the rescale;
  trace     torch.profiler over TRACE_CALLS mults: device kernel time,
            kernel count and device idle share per mult, and the ops that
            own the most device time; then the same mults again with the
            program's spans on (utils/profiling.span): device ms a mult
            under each span, the host ms of the top span (the enqueue),
            the idle time by the span open when each gap opened, and what
            the spans cost on and off. --trace writes a Chrome trace of
            the second stretch.
  ptmul     the same trace of Evaluator.mul_ptxt_new on ct0.

--bfv profiles the 4-party MKBFV PN15QP880 mult + relin instead (the
same operands, messages uniform mod t): its latency and the same trace,
spans on, with the BFV steps (bfv.lift, bfv.rescale_qr, bfv.tensor,
bfv.quantize) beside the key switch's, and its launches per mult.

--batch B profiles Evaluator.mul_relin_batched_new on B distinct pairs
of the same operands instead: its latency a call and a pair, launches a
call beside mkrlwe.batch_counters() (one call of B pairs), and the same
trace, spans on, with the batching helper's batch.stack and batch.split
beside the key switch's steps.

`profile` and `trace` take any parameters and device, so the same code
runs at a small size on the CPU (host-clock times, no device rows).
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import (ProfilerActivity, profile as torch_profile,
                            record_function)

from . import mkbfv, mkckks, mkrlwe
from .mkrlwe import keyswitch as ksw
from .ops import basis, basis_cuda, ntt_cuda
from .utils import profiling

SEED = 2024
PARTIES = 4   # the bench's op: the 4-party PN15QP880 mult
REPS = 10
TRACE_CALLS = 20
REQUEST = "profile.request"   # the span around each traced call


def setup(params, parties: int, seed: int = SEED):
    """Keys for `parties` users and the bench operands ct0, ct1."""
    ev, cts0, cts1, rlk = setup_batch(params, parties, 1, seed)
    return ev, cts0[0], cts1[0], rlk


def setup_batch(params, parties: int, pairs: int, seed: int = SEED):
    """Keys for `parties` users and `pairs` distinct pairs of bench
    operands, each as setup's: the two sides cts0, cts1 of a batched
    mult."""
    users = tuple(f"user{i}" for i in range(parties))
    kgen = mkrlwe.KeyGenerator(params.rlwe, seed=seed)
    rlk, pks = mkrlwe.RelinearizationKeySet(), {}
    for uid in users:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
    enc = mkckks.Encryptor(params, seed=seed + 1)
    ev = mkckks.Evaluator(params)
    rng = np.random.default_rng(seed + 2)
    cts0, cts1 = [], []
    for _ in range(pairs):
        cts = [enc.encrypt_msg(mkckks.Message(
            value=rng.uniform(0.1 / parties, 1.0 / parties, params.slots)
            + 0j), pks[uid]) for uid in users]
        ct0 = ct1 = cts[0]
        for c in cts[1:]:
            ct0, ct1 = ev.add_new(ct0, c), ev.sub_new(ct1, c)
        cts0.append(ct0)
        cts1.append(ct1)
    return ev, cts0, cts1, rlk


def setup_bfv(params, parties: int, seed: int = SEED):
    """BFV keys for `parties` users and the bench operands ct0 (the sum)
    and ct1 (the running difference) of fresh encryptions of messages
    uniform mod t."""
    users = tuple(f"user{i}" for i in range(parties))
    kgen = mkbfv.KeyGenerator(params, seed=seed)
    rlk, pks = mkbfv.RelinearizationKeySet(), {}
    for uid in users:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        rlk.add(kgen.gen_relinearization_key_bfv(sk,
                                                 kgen.gen_secret_key(uid)))
    enc = mkbfv.Encryptor(params, seed=seed + 1)
    ev = mkbfv.Evaluator(params)
    rng = np.random.default_rng(seed + 2)
    cts = [enc.encrypt_msg(rng.integers(0, params.t, params.n), pks[uid])
           for uid in users]
    ct0 = ct1 = cts[0]
    for c in cts[1:]:
        ct0, ct1 = ev.add_new(ct0, c), ev.sub_new(ct1, c)
    return ev, ct0, ct1, rlk


def median_ms(fn, reps: int, device: torch.device) -> float:
    """Median ms of fn() over reps runs after one warm-up: CUDA events on
    a CUDA device, the host clock otherwise."""
    fn()
    cuda = device.type == "cuda"
    times = []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def host_ms(fn, reps: int, device: torch.device) -> float:
    """Median host-clock ms of fn() followed by a synchronize."""
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def launches(fn) -> dict:
    """NTT and key-switching kernel launches of one fn() (after a warm-up
    call)."""
    fn()
    ntt_cuda.reset_counters()
    basis_cuda.reset_counters()
    fn()
    return {"ntt_fwd": ntt_cuda.fwd_launches,
            "ntt_inv": ntt_cuda.inv_launches, **basis_cuda.counters()}


def profile(params, ev, ct0, ct1, rlk, reps: int) -> dict:
    """Latency, NTT launches per mult and the per-step medians."""
    rp = params.rlwe
    dev = rp.device
    level = ct0.level
    rq, rqp = rp.ring_q_at(level), rp.ring_qp_at(level)
    stk = rlk.stacked(ct0.ids)
    h0, h1 = ev.hoisted_form(ct0), ev.hoisted_form(ct1)
    x = ct0.ct.data[1:]
    xk = ksw._aggregate_keys(rp, h0.digits, stk[1], level)
    prod = ksw.mul_and_relin(rp, ct0.ct, ct1.ct, stk, level, h0, h1)
    prod = mkckks.Ciphertext(ct=prod, scale=ct0.scale * ct1.scale)
    k = len(ct0.ids)
    ext = ksw.external_product_ntt(rp, h0.digits, xk, level)
    mod_down_in = torch.cat([ext, ext])            # 2k polys, as the mult

    def mult():
        return ev.mul_relin_new(ct0, ct1, rlk)

    n = launches(mult)
    out = {"ntt_fwd_launches": n.pop("ntt_fwd"),
           "ntt_inv_launches": n.pop("ntt_inv"), "keyswitch_launches": n}
    out["mult_ms"] = median_ms(mult, reps, dev)
    out["mult_host_ms"] = host_ms(mult, reps, dev)
    steps = {
        "hoisted_form (one operand)": lambda: ev.hoisted_form(ct0),
        f"  decompose_ntt: {rp.beta(level)} digits of {k} polys":
            lambda: basis.decompose_ntt(x, rq, rqp, rp.alpha),
        "  the two-kernel decomposition it replaces (mod_up, digit NTT)":
            lambda: rqp.ntt(basis.decompose_digits(x, rq, rqp, rp.alpha)),
        "mul_and_relin from hoisted digits":
            lambda: ksw.mul_and_relin(rp, ct0.ct, ct1.ct, stk, level, h0, h1),
        "  _aggregate_keys (one of x, y)":
            lambda: ksw._aggregate_keys(rp, h0.digits, stk[1], level),
        "  external_product_ntt (one of two)":
            lambda: ksw.external_product_ntt(rp, h0.digits, xk, level),
        "  _sum_parties_ntt": lambda: ksw._sum_parties_ntt(
            rp, h0.digits, stk[2], level),
        f"  mod_down_qp ({2 * k} polys)":
            lambda: ksw.mod_down_qp(rp, mod_down_in, level),
        "rescale": lambda: ev.rescale(prod),
    }
    out["steps_ms"] = {name: median_ms(fn, max(1, reps // 2), dev)
                       for name, fn in steps.items()}
    return out


def _self_device_us(evt) -> float:
    return evt.self_device_time_total


def _stretch(fn, calls: int, acts, device: torch.device, spans: bool):
    """torch.profiler over `calls` runs of fn, each inside a REQUEST span,
    with the program's spans on or off; (profile, wall ms)."""
    with torch_profile(activities=acts) as prof:
        with profiling.spans_on() if spans else contextlib.nullcontext():
            t0 = time.perf_counter()
            for _ in range(calls):
                with record_function(REQUEST):
                    fn()
            if device.type == "cuda":
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms


def _kernels(events) -> int:
    return sum(e.kind == "device" and not e.name.startswith(
        ("Memcpy", "Memset")) for e in events)


def trace(fn, calls: int, device: torch.device, path=None,
          top: int = 12) -> dict:
    """torch.profiler over `calls` runs of fn, each inside a REQUEST span,
    twice, after a shorter traced warm-up (the profiler's first start
    costs the host). The first stretch, with the program's spans off: the
    device ops' summed time and count, the share of the window from the
    first op's start to the last op's end in which none ran, and the ops
    that own the most device time. The second, with spans on, read by
    profiling.SpanTrace: per span name, calls, device ms (with and
    without its children's) and host ms a call; the host ms of the
    top-level spans a call (`enqueue_ms`); the device's idle share, and
    its idle share while the host is inside a top-level span; the idle ms
    a call by the span open when each gap opened; the share of the device
    time under a program span (`span_coverage`) and without a runtime
    call in the trace (`unresolved_share`); kernels a call; and the
    second stretch's wall time over the first's, less 1
    (`spans_overhead`)."""
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    fn()
    _stretch(fn, max(1, calls // 4), acts, device, spans=False)
    prof, wall_ms = _stretch(fn, calls, acts, device, spans=False)
    events = profiling.kineto_events(prof)
    st = profiling.SpanTrace(events, REQUEST)
    avgs = prof.key_averages()

    def ranked(device_type):
        """(name, ms per call, count per call) of the rows of one device
        type that own device time, most first. CPU rows are the torch ops
        that launched the kernels; the NTT kernels, launched through
        ctypes, have no such op and show only among the CUDA rows."""
        rows = sorted((a for a in avgs if a.device_type == device_type
                       and a.key != REQUEST and _self_device_us(a)),
                      key=_self_device_us, reverse=True)
        return [(a.key[:90], _self_device_us(a) / 1e3 / calls,
                 a.count / calls) for a in rows[:top]]

    out = {
        "calls": calls,
        "wall_ms_per_call": wall_ms / calls,
        "kernel_ms_per_call": st.device_us / 1e3 / calls,
        "kernels_per_call": _kernels(events) / calls,
        "device_idle_share": (1 - st.busy_us / st.window_us)
        if st.window_us else None,
        "top_ops": ranked(DeviceType.CPU),
        "top_kernels": ranked(DeviceType.CUDA),
    }

    sprof, span_wall_ms = _stretch(fn, calls, acts, device, spans=True)
    if path:
        sprof.export_chrome_trace(str(path))
    events = profiling.kineto_events(sprof)
    st = profiling.SpanTrace(events, REQUEST)
    per = 1e3 * calls                       # us in all -> ms a call
    dev, win = st.device_us, st.window_us
    idle = sorted(st.idle_by_span().items(), key=lambda kv: -kv[1])
    out.update({
        "spans": {name: (r["calls"] / calls, r["device_us"] / per,
                         r["self_us"] / per, r["host_us"] / per)
                  for name, r in st.by_name().items() if name != REQUEST},
        "enqueue_ms": sum(s.end - s.start for s in st.top_level()) / per,
        "span_idle_share": (1 - st.busy_us / win) if win else None,
        "idle_in_op_share": st.idle_in_top_us() / win if win else None,
        "idle_by_span": [(k, v / per) for k, v in idle[:top]],
        "span_coverage": st.covered_us() / dev if dev else None,
        "unresolved_share": st.unresolved_us / dev if dev else None,
        "span_kernels_per_call": _kernels(events) / calls,
        "spans_overhead": span_wall_ms / wall_ms - 1,
    })
    return out


def enqueue_ms(fn, reps: int, device: torch.device) -> float:
    """Median host-clock ms of fn() alone, untraced, each run starting on
    an idle device: the time the host takes to enqueue its work."""
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    times = []
    for _ in range(reps + 1):
        sync()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    sync()
    return statistics.median(times[1:])


def span_ns(reps: int = 20_000, repeat: int = 5) -> tuple:
    """Host ns that one `with profiling.span(...)` costs over an empty
    loop's, the least of `repeat` loops of `reps`: with the spans off, and
    on under a running CPU profiler."""
    def loop(span):
        t0 = time.perf_counter()
        if span is None:
            for _ in range(reps):
                pass
        else:
            for _ in range(reps):
                with span("ksw.tensor"):
                    pass
        return time.perf_counter() - t0

    base = min(loop(None) for _ in range(repeat))
    off = min(loop(profiling.span) for _ in range(repeat))
    with torch_profile(activities=[ProfilerActivity.CPU]):
        with profiling.spans_on():
            on = min(loop(profiling.span) for _ in range(repeat))
    return tuple((t - base) / reps * 1e9 for t in (off, on))


def print_trace(tr: dict, what: str) -> None:
    """trace()'s result, one line per row."""
    print(f"traced {tr['calls']} {what}s, per {what}: wall "
          f"{tr['wall_ms_per_call']:.3f} ms, kernel time "
          f"{tr['kernel_ms_per_call']:.3f} ms, {tr['kernels_per_call']:.1f} "
          f"kernels, device idle share {tr['device_idle_share']:.4f}",
          flush=True)
    for kind in ("ops", "kernels"):
        for key, ms, count in tr["top_" + kind]:
            print(f"  {kind[:-1]} {key}: {ms:.3f} ms in {count:.1f} calls "
                  f"per {what}", flush=True)
    print(f"spans on, per {what}: {tr['span_kernels_per_call']:.1f} kernels, "
          f"enqueue (host ms of the top span) {tr['enqueue_ms']:.4f} ms, "
          f"device idle share {tr['span_idle_share']:.4f}, of it while "
          f"inside the top span {tr['idle_in_op_share']:.4f}; device time "
          f"under a program span {tr['span_coverage']:.5f}, without a "
          f"runtime call {tr['unresolved_share']:.5f}; spans_overhead "
          f"{tr['spans_overhead']:.4f}", flush=True)
    rows = sorted(tr["spans"].items(), key=lambda kv: -kv[1][1])
    for name, (n, dev_ms, self_ms, host_ms) in rows:
        print(f"  span {name}: {n:g} calls, device {dev_ms:.4f} ms (self "
              f"{self_ms:.4f}), host {host_ms:.4f} ms", flush=True)
    for name, ms in tr["idle_by_span"]:
        print(f"  idle under {name}: {ms:.4f} ms", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", default=None,
                    help="write a Chrome trace of the traced mults here")
    how = ap.add_mutually_exclusive_group()
    how.add_argument("--bfv", action="store_true",
                     help="profile the MKBFV mult + relin instead")
    how.add_argument("--batch", type=int, default=0, metavar="B",
                     help="profile the batched mult of B pairs instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    if args.bfv:
        params = mkbfv.PN15QP880("cuda")
        ev, ct0, ct1, rlk = setup_bfv(params, PARTIES)
        dev = params.device

        def mult():
            return ev.mul_relin_new(ct0, ct1, rlk)

        print(f"BFV PN15QP880, {PARTIES} parties, torch {torch.__version__}:"
              f" mult+relin {median_ms(mult, REPS, dev):.3f} ms (CUDA "
              f"events, median of {REPS}), {host_ms(mult, REPS, dev):.3f} "
              f"ms (host clock + synchronize); launches per mult "
              f"{launches(mult)}", flush=True)
        print_trace(trace(mult, TRACE_CALLS, dev, args.trace), "bfv mult")
        return
    params = mkckks.PN15QP880("cuda")
    if args.batch:
        ev, cts0, cts1, rlk = setup_batch(params, PARTIES, args.batch)
        dev = params.rlwe.device

        def batched():
            return ev.mul_relin_batched_new(cts0, cts1, rlk)

        ms = median_ms(batched, REPS, dev)
        host = host_ms(batched, REPS, dev)
        n = launches(batched)
        mkrlwe.reset_batch_counters()
        batched()
        print(f"PN15QP880, {PARTIES} parties, batch of {args.batch}, torch "
              f"{torch.__version__}: batched mult+relin+rescale {ms:.3f} ms "
              f"a call, {ms / args.batch:.3f} ms a pair (CUDA events, median"
              f" of {REPS}), {host:.3f} ms a call (host clock + synchronize);"
              f" launches a call {n}; batch counters a call "
              f"{mkrlwe.batch_counters()}", flush=True)
        print_trace(trace(batched, TRACE_CALLS, dev, args.trace),
                    "batched mult")
        return
    ev, ct0, ct1, rlk = setup(params, PARTIES)
    res = profile(params, ev, ct0, ct1, rlk, REPS)
    print(f"PN15QP880, {PARTIES} parties, torch {torch.__version__}: "
          f"mult+relin+rescale {res['mult_ms']:.3f} ms (CUDA events, median "
          f"of {REPS}), {res['mult_host_ms']:.3f} ms (host clock + "
          f"synchronize); NTT launches per mult fwd "
          f"{res['ntt_fwd_launches']} inv {res['ntt_inv_launches']}, "
          f"key-switching {res['keyswitch_launches']}", flush=True)
    for name, ms in res["steps_ms"].items():
        print(f"  step {name}: {ms:.3f} ms", flush=True)
    dev = params.rlwe.device
    rng = np.random.default_rng(SEED + 3)
    pt = torch.from_numpy(mkckks.Encryptor(params, seed=SEED + 4).encode_msg(
        mkckks.Message(value=rng.uniform(0.1, 1.0, params.slots) + 0j))
        .astype(np.int64)).to(dev)
    ops = {"mult": lambda: ev.mul_relin_new(ct0, ct1, rlk),
           "ptmul": lambda: ev.mul_ptxt_new(ct0, pt, params.scale)}
    for what, fn in ops.items():
        print_trace(trace(fn, TRACE_CALLS, dev,
                          args.trace if what == "mult" else None), what)
    print("untraced enqueue (host ms of the call alone, median of "
          f"{REPS}): " + ", ".join(f"{what} {enqueue_ms(fn, REPS, dev):.4f}"
                                   for what, fn in ops.items())
          + "; host ns a span, off and on (traced): %.1f, %.1f" % span_ns(),
          flush=True)

if __name__ == "__main__":
    main()
