"""Where the time of one multi-party mult + relin + rescale goes.

    python -m mkhe_tpu_torch.profile_mult [--trace PATH]

Builds PN15QP880 keys for 4 parties from a seed on the first CUDA device
and the bench operands (ct0 the running sum, ct1 the running difference of fresh
encryptions, as bench.py does), then prints:

  latency   median ms of Evaluator.mul_relin_new, from CUDA events and
            from the host clock with a synchronize;
  launches  NTT and key-switching kernel launches per mult (ops/ntt_cuda
            and ops/basis_cuda counters);
  steps     median ms (CUDA events) of each step mul_relin_new runs:
            hoisted_form (digit mod_ups, digit NTT), mul_and_relin from
            hoisted digits (key aggregation, external products, party
            sum, ModDown) and the rescale;
  trace     torch.profiler over three mults: device kernel time, kernel
            count and device idle share per mult, and the ops that own
            the most device time. --trace also writes a Chrome trace.

`profile` and `trace` take any parameters and device, so the same code
runs at a small size on the CPU (host-clock times, no device rows).
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile as torch_profile

from . import mkckks, mkrlwe
from .mkrlwe import keyswitch as ksw
from .ops import basis, basis_cuda, ntt_cuda

SEED = 2024
PARTIES = 4   # the bench's op: the 4-party PN15QP880 mult
REPS = 10


def setup(params, parties: int, seed: int = SEED):
    """Keys for `parties` users and the bench operands ct0, ct1."""
    users = tuple(f"user{i}" for i in range(parties))
    kgen = mkrlwe.KeyGenerator(params.rlwe, seed=seed)
    rlk, pks = mkrlwe.RelinearizationKeySet(), {}
    for uid in users:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
    enc = mkckks.Encryptor(params, seed=seed + 1)
    ev = mkckks.Evaluator(params)
    rng = np.random.default_rng(seed + 2)
    cts = [enc.encrypt_msg(mkckks.Message(
        value=rng.uniform(0.1 / parties, 1.0 / parties, params.slots)
        + 0j), pks[uid]) for uid in users]
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


def profile(params, ev, ct0, ct1, rlk, reps: int) -> dict:
    """Latency, NTT launches per mult and the per-step medians."""
    rp = params.rlwe
    dev = rp.device
    level = ct0.level
    rq, rqp = rp.ring_q_at(level), rp.ring_qp_at(level)
    stk = rlk.stacked(ct0.ids)
    h0, h1 = ev.hoisted_form(ct0), ev.hoisted_form(ct1)
    x = ct0.ct.data[1:]
    dig = basis.decompose_digits(x, rq, rqp, rp.alpha)
    xk = ksw._aggregate_keys(rp, h0.digits, stk[1], level)
    prod = ksw.mul_and_relin(rp, ct0.ct, ct1.ct, stk, level, h0, h1)
    prod = mkckks.Ciphertext(ct=prod, scale=ct0.scale * ct1.scale)
    k = len(ct0.ids)
    ext = ksw.external_product_ntt(rp, h0.digits, xk, level)
    mod_down_in = torch.cat([ext, ext])            # 2k polys, as the mult

    def mult():
        return ev.mul_relin_new(ct0, ct1, rlk)

    mult()
    ntt_cuda.reset_counters()
    basis_cuda.reset_counters()
    mult()
    out = {"ntt_fwd_launches": ntt_cuda.fwd_launches,
           "ntt_inv_launches": ntt_cuda.inv_launches,
           "keyswitch_launches": basis_cuda.counters()}
    out["mult_ms"] = median_ms(mult, reps, dev)
    out["mult_host_ms"] = host_ms(mult, reps, dev)
    steps = {
        "hoisted_form (one operand)": lambda: ev.hoisted_form(ct0),
        f"  decompose_digits: {rp.beta(level)} mod_ups of {k} polys":
            lambda: basis.decompose_digits(x, rq, rqp, rp.alpha),
        f"  digit NTT {tuple(dig.shape[:-1])}": lambda: rqp.ntt(dig),
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


def trace(fn, calls: int, device: torch.device, path=None,
          top: int = 12) -> dict:
    """torch.profiler over `calls` runs of fn. Device numbers come from the
    kernel events alone (device_type CUDA): their summed time, their count,
    and the share of the window from the first kernel's start to the last
    kernel's end in which no kernel ran."""
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    fn()
    if cuda:
        torch.cuda.synchronize()
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        if cuda:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, spans = 0.0, sorted((e.time_range.start, e.time_range.end)
                                 for e in kern)
    cur_s = cur_e = None
    for s, e in spans:                    # union of the kernel intervals
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    window_us = spans[-1][1] - spans[0][0] if spans else 0.0
    avgs = prof.key_averages()

    def ranked(device_type):
        """(name, ms per call, count per call) of the rows of one device
        type that own device time, most first. CPU rows are the torch ops
        that launched the kernels; the NTT kernels, launched through
        ctypes, have no such op and show only among the CUDA rows."""
        rows = sorted((a for a in avgs if a.device_type == device_type
                       and _self_device_us(a)),
                      key=_self_device_us, reverse=True)
        return [(a.key[:90], _self_device_us(a) / 1e3 / calls,
                 a.count / calls) for a in rows[:top]]

    if path:
        prof.export_chrome_trace(str(path))
    return {
        "calls": calls,
        "wall_ms_per_call": wall_ms / calls,
        "kernel_ms_per_call": sum(_self_device_us(e) for e in kern)
        / 1e3 / calls,
        "kernels_per_call": len(kern) / calls,
        "device_idle_share": (1 - busy_us / window_us) if window_us else None,
        "top_ops": ranked(DeviceType.CPU),
        "top_kernels": ranked(DeviceType.CUDA),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", default=None,
                    help="write a Chrome trace of the traced mults here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    params = mkckks.PN15QP880("cuda")
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
    tr = trace(lambda: ev.mul_relin_new(ct0, ct1, rlk), 3, params.rlwe.device,
               args.trace)
    print(f"traced {tr['calls']} mults, per mult: wall "
          f"{tr['wall_ms_per_call']:.3f} ms, kernel time "
          f"{tr['kernel_ms_per_call']:.3f} ms, {tr['kernels_per_call']:.1f} "
          f"kernels, device idle share {tr['device_idle_share']:.4f}",
          flush=True)
    for kind in ("ops", "kernels"):
        for key, ms, count in tr["top_" + kind]:
            print(f"  {kind[:-1]} {key}: {ms:.3f} ms in {count:.1f} calls "
                  "per mult", flush=True)


if __name__ == "__main__":
    main()
