"""Timing, spans and analytic bounds (port of mkhe_tpu/utils/profiling.py).

Timer times labelled regions on the host clock, synchronizing the device
of a region's tensor at both ends, so that a region's time holds its own
device work and no one else's. The roofline is the H100's: the NTT's bytes
and operations as profile_ntt.kernel_work counts them, over the card's
memory and int32 rates (profile_ntt.HBM_BYTES_PER_S, INT32_OPS_PER_S), in
place of the JAX package's TPU model (800 GB/s and a VPU rate).

Spans mark the program's steps for torch.profiler. `span(name)` opens one
at a step's boundary; it is off by default, and then returns one shared
null context, so that an op pays a `with` on it and nothing more. Inside
`spans_on()` it enters `torch.profiler.record_function(name)`, which
Kineto records on the clock of the kernels and of the CUDA runtime calls
that launched them. `SpanTrace` reads a profile taken with spans on: each
span's nesting, each device op put down through its correlation id to the
runtime call that launched it and so to the innermost span open around
that call, and each idle gap of the device put down to the innermost span
open on the host when it opened. Spans change no device work: the kernels
an op launches are the same with spans on and off.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch


def _sync(sync_out) -> None:
    """Synchronize the CUDA device of sync_out (a tensor or a device)."""
    device = (sync_out if isinstance(sync_out, torch.device)
              else getattr(sync_out, "device", None))
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Timer:
    """Seconds per labelled region. With sync_out (a tensor or a device)
    the region synchronizes that device when it starts and when it ends;
    without it the region times the host alone (a launch, not its work)."""
    records: Dict[str, List[float]] = field(default_factory=dict)

    @contextlib.contextmanager
    def region(self, label: str, sync_out=None):
        _sync(sync_out)
        t0 = time.perf_counter()
        yield
        _sync(sync_out)
        self.records.setdefault(label, []).append(
            time.perf_counter() - t0)

    def summary(self) -> str:
        lines = []
        for k, v in sorted(self.records.items()):
            lines.append(f"{k}: n={len(v)} mean={np.mean(v)*1e3:.3f}ms "
                         f"min={np.min(v)*1e3:.3f}ms")
        return "\n".join(lines)


def ntt_roofline_us(logn: int, nlimbs: int) -> dict:
    """Bytes and operations bounds (us) of one forward NTT launch on
    (nlimbs, 2^logn) int64 with its tables (q, Barrett constants, the
    packed twiddles) on an H100: profile_ntt.kernel_work's counts over the
    card's rates."""
    from .. import profile_ntt
    meta = dict(dtype=torch.int64, device="meta")
    x = torch.empty((nlimbs, 1 << logn), **meta)
    tables = (torch.empty(nlimbs, **meta), torch.empty(nlimbs, **meta), x)
    nbytes, ops, _ = profile_ntt.kernel_work("ntt_fwd", x, tables)
    return dict(memory_us=1e6 * nbytes / profile_ntt.HBM_BYTES_PER_S,
                compute_us=1e6 * ops / profile_ntt.INT32_OPS_PER_S)


def roofline_report(logn: int, nlimbs: int, measured_us: float) -> str:
    """One-line bound-vs-measured summary of a forward NTT launch."""
    r = ntt_roofline_us(logn, nlimbs)
    floor = max(r["memory_us"], r["compute_us"])
    return (f"roofline logN={logn} x{nlimbs} limbs: memory "
            f"{r['memory_us']:.1f} us, compute {r['compute_us']:.1f} us "
            f"-> floor {floor:.1f} us; measured {measured_us:.1f} us "
            f"({measured_us / max(floor, 1e-9):.2f}x of floor)")


# ----------------------------------------------------------------------------
# Spans
# ----------------------------------------------------------------------------

_ON = False
_NULL = contextlib.nullcontext()
# the label of an idle gap that no program span was open around
OUTSIDE_PROGRAM = "(request, outside the program)"   # inside a request
OUTSIDE = "(harness)"                                # between requests


def span(name: str):
    """The context of one step of the program: record_function(name)
    inside spans_on(), else the shared null context."""
    return torch.profiler.record_function(name) if _ON else _NULL


@contextlib.contextmanager
def spans_on():
    """Spans on for the block; as they were after it."""
    global _ON
    was, _ON = _ON, True
    try:
        yield
    finally:
        _ON = was


@dataclass
class Event:
    """One profiled event, us on the profiler's clock. kind: "span" (a
    record_function on the host), "runtime" (a CUDA API call, named
    cuda* or cu*, which may launch device work), "device" (a kernel, copy or
    fill) or "host" (anything else). corr: the correlation id that ties a
    device op to the runtime call that launched it."""
    name: str
    kind: str
    start: float
    end: float
    thread: int = 0
    corr: int = 0


def _kind(e) -> Optional[str]:
    """The Event kind of a Kineto event; None for a span's copy on the
    device's timeline."""
    cuda = e.device_type() == torch.autograd.DeviceType.CUDA
    if e.is_user_annotation():
        return None if cuda else "span"
    if cuda:
        return "device"
    return "runtime" if e.name().startswith("cu") else "host"


def kineto_events(prof) -> List[Event]:
    """The events of a finished torch.profiler.profile, from its raw Kineto
    results (the profiler's function events take minutes to build over a
    CNN's ~10^5 events)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind is not None:
            out.append(Event(e.name(), kind, e.start_ns() / 1e3,
                             e.end_ns() / 1e3, e.start_thread_id(),
                             e.correlation_id()))
    return out


@dataclass
class Span:
    name: str
    start: float
    end: float
    parent: Optional[int]     # index in SpanTrace.spans
    request: Optional[int]    # index of the enclosing request span
    self_us: float = 0.0      # device time launched inside it, not below
    total_us: float = 0.0     # the same with its descendants'


class SpanTrace:
    """Spans of the host thread that holds the most of them, with nesting
    and request indices (`request` names the span that marks a request;
    spans of one request share its index), and the device time and idle
    gaps put down to them. A device op whose runtime call is not in the
    events counts in `unresolved_us`; the spans' device-timeline copies
    (gpu_user_annotation) are not read."""

    def __init__(self, events, request: Optional[str] = None):
        spans = [e for e in events if e.kind == "span"]
        threads = [e.thread for e in spans]
        main = max(set(threads), key=threads.count) if spans else None
        self.request_name = request
        self.spans: List[Span] = []
        self.requests = 0
        stack: List[int] = []
        for e in sorted((e for e in spans if e.thread == main),
                        key=lambda e: (e.start, -e.end)):
            while stack and self.spans[stack[-1]].end <= e.start:
                stack.pop()
            parent = stack[-1] if stack else None
            if e.name == request:
                req, self.requests = self.requests, self.requests + 1
            else:
                req = None if parent is None else self.spans[parent].request
            stack.append(len(self.spans))
            self.spans.append(Span(e.name, e.start, e.end, parent, req))
        self._times, self._owner = self._segments()

        launch = {e.corr: e.start for e in events if e.kind == "runtime"}
        dev = sorted((e for e in events if e.kind == "device"),
                     key=lambda e: e.start)
        self.device_us = sum(e.end - e.start for e in dev)
        self.unresolved_us = 0.0
        for e in dev:
            if e.corr not in launch:
                self.unresolved_us += e.end - e.start
                continue
            i = self.innermost(launch[e.corr])
            if i is not None:
                self.spans[i].self_us += e.end - e.start
        for s in reversed(self.spans):
            s.total_us += s.self_us
            if s.parent is not None:
                self.spans[s.parent].total_us += s.total_us

        self.busy_us, self.gaps = 0.0, []
        cur_s = cur_e = None
        for e in dev:                        # the union of the device ops
            if cur_e is None or e.start > cur_e:
                if cur_e is not None:
                    self.busy_us += cur_e - cur_s
                    self.gaps.append((cur_e, e.start - cur_e))
                cur_s, cur_e = e.start, e.end
            else:
                cur_e = max(cur_e, e.end)
        if cur_e is not None:
            self.busy_us += cur_e - cur_s
        self.window_us = cur_e - dev[0].start if dev else 0.0

    def _segments(self):
        """Times at which the innermost open span changes, and that span
        (an index, or None) from each time on."""
        marks = []
        for i, s in enumerate(self.spans):
            marks.append((s.start, 1, -s.end, i))     # outer spans open first
            marks.append((s.end, 0, -s.start, i))     # inner spans close first
        marks.sort()
        times, owner, stack = [], [], []
        for t, opening, _, i in marks:
            if opening:
                stack.append(i)
            else:
                stack.remove(i)
            top = stack[-1] if stack else None
            if times and times[-1] == t:
                owner[-1] = top
            else:
                times.append(t)
                owner.append(top)
        return times, owner

    def innermost(self, t: float) -> Optional[int]:
        """The innermost span open at time t, or None."""
        k = bisect.bisect_right(self._times, t) - 1
        return self._owner[k] if k >= 0 else None

    def program(self, i: Optional[int]) -> bool:
        """Whether span i is a span of the program, not a request mark."""
        return i is not None and self.spans[i].name != self.request_name

    def label(self, t: float) -> str:
        """The innermost program span open at t, else whether t lies
        inside a request."""
        i = self.innermost(t)
        if self.program(i):
            return self.spans[i].name
        return OUTSIDE if i is None else OUTSIDE_PROGRAM

    def by_name(self) -> Dict[str, dict]:
        """name -> calls, host_us (the spans' host durations), device_us
        (device time under them, theirs and their descendants') and
        self_us (theirs alone). Spans of one name do not nest."""
        out: Dict[str, dict] = {}
        for s in self.spans:
            row = out.setdefault(s.name, dict(calls=0, host_us=0.0,
                                              device_us=0.0, self_us=0.0))
            row["calls"] += 1
            row["host_us"] += s.end - s.start
            row["device_us"] += s.total_us
            row["self_us"] += s.self_us
        return out

    def top_level(self) -> List[Span]:
        """The program spans with no program span above them."""
        return [s for i, s in enumerate(self.spans)
                if self.program(i) and not self.program(s.parent)]

    def covered_us(self) -> float:
        """Device time under a program span."""
        return sum(s.total_us for s in self.top_level())

    def idle_by_span(self) -> Dict[str, float]:
        """Idle gaps, us summed by label() at the time each opened."""
        out: Dict[str, float] = {}
        for start, length in self.gaps:
            k = self.label(start)
            out[k] = out.get(k, 0.0) + length
        return out

    def idle_in_top_us(self) -> float:
        """Idle device time while the host is inside a top-level program
        span."""
        tops = sorted((s.start, s.end) for s in self.top_level())
        idle = 0.0
        for start, length in self.gaps:
            k = bisect.bisect_right(tops, (start, float("inf")))
            for a, b in tops[max(k - 1, 0):]:
                if a >= start + length:
                    break
                idle += max(0.0, min(b, start + length) - max(a, start))
        return idle
