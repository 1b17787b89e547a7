"""One run of one benchmark cell: set-up, warm-up, the measured window, an
optional traced stretch, the check of the outputs, and the result line.

Everything a cell needs is found by name: its entry in BENCHMARK.json (the
configuration, the traffic mix, the chips and the metrics it reports),
the configuration's file, traffic/<mix>.json, kinds/<kind>.py (the
request kind the mix names: its state and its work inventory),
workloads/<cell>.json (the limits of the compared numbers and the traced
stretch's length), metrics/<metric>.py (the per-layer readers) and every
kernel_maps/*.json.

Requests run in a closed loop with one client: each is issued after the
previous one has finished, and timed on the host clock from its issue to
a torch.cuda.synchronize(). A seeded reservoir keeps a sample of the
outputs; the reference judges them after the window, once the peak memory
has been read and the program's state freed.
"""

from __future__ import annotations

import importlib.util
import json
import random
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mkhe_tpu")
TOP = 10   # entries of each breakdown list
# the lower precisions a control may be computed in (calibrate.py)
CONTROLS = {"complex64": np.complex64, "float32": torch.float32,
            "float16": torch.float16, "bfloat16": torch.bfloat16}


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def seeds_of(seed: int) -> dict:
    """Independent seeds of the cell's parts, all from --seed."""
    words = np.random.SeedSequence(seed).generate_state(4)
    return {"inputs": int(words[0]), "keygen": int(words[1]) >> 1,
            "encrypt": int(words[2]) >> 1, "order": int(words[3])}


def cell_spec(name: str, root: Path = ROOT) -> dict:
    """The cell's entry and files, and the metrics it reports."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    home = root / "hebench"
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return {"name": name, "chips": entry["chips"], "home": home,
            "config": load_json(root / config["file"]),
            "traffic": load_json(home / "traffic"
                                 / f"{entry['traffic']}.json"),
            "cell": load_json(home / "workloads" / f"{name}.json"),
            "end_to_end": e2e, "per_layer": layer}


def kernel_maps(home: Path) -> dict:
    """layer -> name fragments of its kernels, merged over every map."""
    layers = {}
    for path in sorted((home / "kernel_maps").glob("*.json")):
        doc = load_json(path)
        layers.setdefault(doc["layer"], []).extend(doc["kernels"])
    return layers


def load_module(path: Path, tag: str):
    """The Python file at path, as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"hebench_{tag}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(home: Path, metric: str):
    """metrics/<metric>.py, else metrics/<metric up to its first dot>.py."""
    for stem in (metric, metric.split(".")[0]):
        path = home / "metrics" / f"{stem}.py"
        if path.exists():
            return load_module(path, "metric").read
    raise FileNotFoundError(f"no reader for per-layer metric {metric}")


def kind(home: Path, name: str):
    """kinds/<name>.py: a request kind. It gives `State(cfg, mix, seeds,
    device, root)`, whose `request(i)` is the timed call on pool entry i,
    `judge(kept, control=None)` the numbers compared with the cell's
    limits, `release()` drops the program's state and `work` is the
    request's inventory; and `inventory(cfg, moduli)`, that inventory
    from a configuration (work.py)."""
    path = home / "kinds" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no request kind {name!r} ({path})")
    return load_module(path, "kind")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trace:
    """What a traced stretch leaves for the readers: device activities
    (name, start us, end us), the kernels among them, host ops (start us,
    name), the stretch's length, the busy time and the idle gaps."""

    def __init__(self, prof, requests: int, window_ns: int):
        self.requests = requests
        dev, host = [], []
        for name, kind, start, end in _events(prof):
            if kind == torch.autograd.DeviceType.CUDA:
                dev.append((name, start, end))
            elif kind == torch.autograd.DeviceType.CPU:
                host.append((start, name))
        self.device_ops = sorted(dev, key=lambda x: x[1])
        self.kernels = [d for d in self.device_ops
                        if not d[0].startswith(("Memcpy", "Memset"))]
        host.sort()
        self.host_start = np.array([h[0] for h in host])
        self.host_name = [h[1] for h in host]
        self.busy_us, self.gaps = self._union()
        self.window_us = window_ns / 1e3
        if self.device_ops:   # at least from the first activity to the last
            self.window_us = max(self.window_us, self.device_ops[-1][2]
                                 - self.device_ops[0][1])

    def _union(self):
        """Busy time (the union of the device intervals in the window) and
        the idle gaps (start us, length us) between them."""
        busy, gaps = 0.0, []
        cur_s = cur_e = None
        for _, s, e in self.device_ops:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, s - cur_e))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy, gaps

    def time_of(self, fragments) -> float:
        """Seconds of the kernels whose names hold one of the fragments."""
        return sum(e - s for n, s, e in self.kernels
                   if any(f in n for f in fragments)) / 1e6

    def breakdown(self) -> dict:
        """The device ops that took most time, and the idle gaps summed by
        the host op that had started last before each gap opened."""
        ops = {}
        for n, s, e in self.device_ops:
            ops[n[:120]] = ops.get(n[:120], 0.0) + (e - s) / 1e6
        idle = {}
        if len(self.host_start):
            at = np.searchsorted(self.host_start,
                                 [g[0] for g in self.gaps]) - 1
            for (_, length), i in zip(self.gaps, at):
                name = self.host_name[i][:120] if i >= 0 else "(none)"
                idle[name] = idle.get(name, 0.0) + length / 1e6
        top = (lambda d: [[k, v] for k, v in
                          sorted(d.items(), key=lambda kv: -kv[1])[:TOP]])
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def _events(prof):
    """(name, device type, start us, end us) of every profiled event, from
    the raw Kineto results (building the profiler's function events for
    a CNN stretch's ~10^5 events would take minutes). Annotations (the
    record_function spans, and their copies on the device's timeline)
    are left out: they are no work of the program."""
    for e in prof.profiler.kineto_results.events():
        if not e.is_user_annotation():
            yield (e.name(), e.device_type(), e.start_ns() / 1e3,
                   e.end_ns() / 1e3)


def trace_stretch(state, count: int, device: torch.device) -> Trace:
    """torch.profiler over `count` requests, after the window."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter_ns()
        for i in range(count):
            with record_function("hebench.request"):
                state.request(i)
        sync(device)
        t1 = time.perf_counter_ns()
    return Trace(prof, count, t1 - t0)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device="cuda", root: Path = ROOT, t_start=None,
             broken=None, controls=()) -> dict:
    """One run of the cell; returns the result object. `broken`, if given,
    wraps the state's request (tests plant faults in the timed path);
    `controls` names lower precisions whose readings, computed in the
    program's place on the same kept requests and held to the same
    limits, go under "controls"."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = cell_spec(name, root)
    device = torch.device(device)
    steps = {"start": time.perf_counter() - t_start}
    compiled = False
    if device.type == "cuda":
        from mkhe_tpu_torch.ops import ntt_cuda
        compiled = bool(ntt_cuda.build())
        ntt_cuda.load()
    steps["build"] = time.perf_counter() - t_start
    mix = spec["traffic"]
    seeds = seeds_of(seed)
    state = kind(spec["home"], mix["kind"]).State(
        spec["config"], mix, seeds, device, root)
    if broken is not None:
        state.request = broken(state.request)
    sync(device)
    steps["state"] = time.perf_counter() - t_start
    for i in range(max(mix["warmup"], mix["pool"])):
        state.request(i)
    sync(device)
    setup_s = time.perf_counter() - t_start
    steps["warm"] = setup_s
    print("set-up s, cumulative: " + ", ".join(
        f"{k} {v:.3f}" for k, v in steps.items())
        + f"; the kernels {'were' if compiled else 'were not'} built",
        file=sys.stderr)

    # the measured window
    rng = random.Random(seeds["order"])
    sample, kept, lat = spec["cell"]["sample"], [], []
    start = time.perf_counter()
    end = start
    i = 0
    while end - start < seconds:
        t0 = time.perf_counter()
        out = state.request(i)
        sync(device)
        end = time.perf_counter()
        lat.append(end - t0)
        if len(kept) < sample:              # a seeded reservoir
            kept.append((i, out))
        else:
            j = rng.randrange(i + 1)
            if j < sample:
                kept[j] = (i, out)
        i += 1
    window_s = end - start
    del out

    result = {"correct": False, "attempted": len(lat), "failed": 0,
              "metrics": {}}
    metrics = result["metrics"]
    if not traced:
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": _e2e(m["name"], setup_s, window_s,
                                                lat), "unit": m["unit"]}
    else:
        tr = trace_stretch(state, max(spec["cell"]["trace_requests"], 1),
                           device)
        ctx = {"trace": tr, "work": state.work, "window_s": window_s,
               "requests": len(lat), "kernel_maps": kernel_maps(spec["home"])}
        for m in spec["per_layer"]:
            value = reader(spec["home"], m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = tr.breakdown()
    result["device"] = device_info(device, spec["chips"])
    if traced:
        result["device"].update(busy_s=tr.busy_us / 1e6,
                                window_s=tr.window_us / 1e6)

    # set-up's steps, cumulative seconds from process start; a run that
    # builds the kernels (a checkout's first) says so
    result["setup_steps"] = dict(steps, compiled=compiled)

    state.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    limits = spec["cell"]["limits"]
    checks, result["correct"] = judged(state.judge(kept), limits)
    if controls:
        result["controls"] = {}
        for c in controls:
            numbers, ok = judged(state.judge(kept, control=CONTROLS[c]),
                                 limits)
            result["controls"][c] = {"checks": numbers, "correct": ok}
    result["checks"] = checks
    return result


def judged(numbers: dict, limits: dict):
    """Each number beside its limit, and whether all are within."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def _e2e(name: str, setup_s: float, window_s: float, lat: list) -> float:
    """setup_s; <x>.p95: the 95th percentile of every request's latency in
    ms; <x>_ms: the window over the requests completed in it, in ms."""
    if name == "setup_s":
        return setup_s
    if name.endswith(".p95"):
        return statistics.quantiles(lat, n=20)[18] * 1e3 if len(lat) > 1 \
            else lat[0] * 1e3
    return window_s / len(lat) * 1e3


def device_info(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}


def report(result: dict) -> None:
    """The compared numbers as the last lines of stderr, then the result as
    the last line of stdout."""
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
