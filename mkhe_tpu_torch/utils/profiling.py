"""Timing and analytic bounds (port of mkhe_tpu/utils/profiling.py).

Timer times labelled regions on the host clock, synchronizing the device
of a region's tensor at both ends, so that a region's time holds its own
device work and no one else's. The roofline is the H100's: the NTT's bytes
and operations as profile_ntt.kernel_work counts them, over the card's
memory and int32 rates (profile_ntt.HBM_BYTES_PER_S, INT32_OPS_PER_S), in
place of the JAX package's TPU model (800 GB/s and a VPU rate).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from .. import profile_ntt


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


def mulrelin_op_counts(logn: int, lq: int, lp: int, beta: int, parties: int
                       ) -> dict:
    """Operation inventory of one multi-key mult+relin (square case), for
    comparing measured time against the model."""
    n = 1 << logn
    lqp = lq + lp
    ntts = (parties * beta * lqp) * 2 + (parties + 1) * lq + \
        parties * lqp * 2 + lqp
    mulaccs = (2 + 3) * parties * beta * lqp * n  # x/y agg + 3 ext products
    return dict(limb_ntts=ntts, mul_accumulate_terms=mulaccs)
