#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (mkhe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, then two JSON lines:
  1. device   torch / CUDA versions and the card, plus nvidia-smi's
              "name, power.limit" line;
  2. build    nvcc builds csrc/ntt.cu (sm_90a) from the checkout;
  3. kernels  each NTT kernel against its plain PyTorch version on the
              card, bit for bit, at the PN15QP880 QP moduli (32 limbs,
              N = 2^15, batch 8) and again at logN = 10; round trip;
              median times from CUDA events;
  4. mult     the main path: PN15QP880, 4 parties, keys from
              torch.Generator on the card; three requests of fresh
              encryptions -> Evaluator.mul_relin_new (mult + relin +
              rescale) -> decrypt, and one 2-party request; each decrypts
              within log2|err| <= -log2(scale) + logslots + 12; the NTT
              launch counters must grow during the phase.
Then {"kernels": [...]} and, last, {"ok": true, "device": {...}}.

Any failure raises and the exit code is not 0. Without a CUDA device it
fails in phase 1.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import time

import numpy as np
import torch

from mkhe_tpu_torch import mkckks, mkrlwe
from mkhe_tpu_torch.ops import ntt_cuda
from mkhe_tpu_torch.ops.ring import Ring

BATCH = 8
SEED = 2024
KERNELS = (
    ("ntt_fwd", "mkhe_tpu/ops/ntt_pallas.py:126"),   # _fwd_kernel
    ("ntt_inv", "mkhe_tpu/ops/ntt_pallas.py:138"),   # _inv_kernel
)


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() over reps runs, from CUDA events,
    after one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip()
    print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}", flush=True)
    print(smi, flush=True)
    return {"platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    t0 = time.perf_counter()
    log = ntt_cuda.build()
    ntt_cuda.load()
    secs = time.perf_counter() - t0
    ptxas = [ln.split("ptxas info    :")[-1].strip()
             for ln in log.splitlines() if "registers" in ln]
    print(f"[2 build] {secs:.2f} s -> {ntt_cuda.LIB_PATH.name}; "
          f"ptxas: {' | '.join(ptxas)}", flush=True)


def _rand(gen, shape, bound):
    """Uniform int64 in [0, bound) per limb (bound: (L, 1) or int)."""
    r = torch.randint(0, 1 << 62, shape, generator=gen, dtype=torch.int64,
                      device="cuda")
    return r % bound


def phase_kernels(ring15: Ring) -> dict:
    """Kernel vs plain on the card; returns per-kernel max_abs_err and the
    times at logN = 15 (batch 8 of the 32 QP limbs)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    err = {"ntt_fwd": 0, "ntt_inv": 0}
    mism = 0
    times = {}
    for logn in (15, 10):
        ring = ring15 if logn == 15 else Ring.create(ring15.moduli, logn)
        shape = (BATCH, ring.nlimbs, ring.n)
        q = ring.q[:, None]
        fwd_t = (ring.q, ring.bar, ring.psi, ring.psi_sh)
        inv_t = (ring.q, ring.bar, ring.ipsi, ring.ipsi_sh, ring.ninv,
                 ring.ninv_sh)
        cases = (
            ("ntt_fwd", ntt_cuda.ntt, ntt_cuda.ntt_plain, fwd_t,
             _rand(gen, shape, q)),                       # canonical
            ("ntt_fwd", ntt_cuda.ntt, ntt_cuda.ntt_plain, fwd_t,
             _rand(gen, shape, 1 << 32)),                 # any u32
            ("ntt_inv", ntt_cuda.intt, ntt_cuda.intt_plain, inv_t,
             _rand(gen, shape, 8 * q)),                   # lazy < 8q
        )
        for name, kern, plain, tabs, x in cases:
            got, want = kern(x, *tabs), plain(x, *tabs)
            torch.cuda.synchronize()
            mism += int((got != want).sum())
            err[name] = max(err[name], int((got - want).abs().max()))
        x = cases[0][4]
        back = ntt_cuda.intt(ntt_cuda.ntt(x, *fwd_t), *inv_t)
        torch.cuda.synchronize()
        mism += int((back != x).sum())
        if logn == 15:
            times = {
                "ntt_fwd": cuda_ms(lambda: ntt_cuda.ntt(x, *fwd_t), 20),
                "ntt_inv": cuda_ms(lambda: ntt_cuda.intt(x, *inv_t), 20),
                "ntt_fwd_plain": cuda_ms(
                    lambda: ntt_cuda.ntt_plain(x, *fwd_t), 5),
                "ntt_inv_plain": cuda_ms(
                    lambda: ntt_cuda.intt_plain(x, *inv_t), 5),
            }
    print(f"[3 kernels] mismatches {mism} (logN 15 and 10, canonical, "
          f"any-u32 and <8q inputs, round trip); logN 15 batch {BATCH} x "
          f"{ring15.nlimbs} limbs median ms: fwd {times['ntt_fwd']:.4f} "
          f"(plain {times['ntt_fwd_plain']:.4f}), inv "
          f"{times['ntt_inv']:.4f} (plain {times['ntt_inv_plain']:.4f})",
          flush=True)
    if mism:
        raise AssertionError(f"kernel and plain version differ in {mism} "
                             "values")
    return {name: dict(max_abs_err=err[name], ms=times[name],
                       plain_ms=times[name + "_plain"])
            for name, _ in KERNELS}


def phase_mult(params) -> dict:
    """The main path: keys, requests of fresh encryptions, mult + relin +
    rescale, decryption within the bound. Returns the launch counts."""
    users = [f"user{i}" for i in range(4)]
    t0 = time.perf_counter()
    kgen = mkrlwe.KeyGenerator(params.rlwe, seed=SEED + 1)
    sks, rlk, pks = mkrlwe.SecretKeySet(), mkrlwe.RelinearizationKeySet(), {}
    for uid in users:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        sks.add(sk)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    enc = mkckks.Encryptor(params, seed=SEED + 2)
    dec = mkckks.Decryptor(params)
    ev = mkckks.Evaluator(params)
    rng = np.random.default_rng(SEED + 3)
    bound = -math.log2(params.scale) + params.logslots + 12

    def request(parties):
        """Fresh encryptions -> ct0 = running sum, ct1 = running
        difference (bench.py:354-364) -> one mult -> decrypt."""
        k = len(parties)
        msgs = [rng.uniform(0.1 / k, 1.0 / k, params.slots)
                + 1j * rng.uniform(0.1 / k, 1.0 / k, params.slots)
                for _ in parties]
        cts = [enc.encrypt_msg(mkckks.Message(value=m), pks[uid])
               for m, uid in zip(msgs, parties)]
        ct0 = ct1 = cts[0]
        for c in cts[1:]:
            ct0, ct1 = ev.add_new(ct0, c), ev.sub_new(ct1, c)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = ev.mul_relin_new(ct0, ct1, rlk)
        end.record()
        torch.cuda.synchronize()
        got = dec.decrypt(res, sks).value
        want = sum(msgs) * (msgs[0] - sum(msgs[1:]))
        log2_err = math.log2(max(float(np.max(np.abs(got - want))), 1e-300))
        if not (res.ids == tuple(parties) and np.all(np.isfinite(got))
                and got.shape == (params.slots,) and log2_err <= bound):
            raise AssertionError(
                f"{k}-party mult: ids {res.ids}, log2 err {log2_err:.2f} "
                f"(bound {bound:.2f})")
        return start.elapsed_time(end), log2_err

    torch.cuda.reset_peak_memory_stats()
    ntt_cuda.reset_counters()
    runs4 = [request(users) for _ in range(3)]
    ms2, err2 = request(users[:2])
    launches = {"ntt_fwd": ntt_cuda.fwd_launches,
                "ntt_inv": ntt_cuda.inv_launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"the main path launched no kernel: {launches}")
    ms4 = [ms for ms, _ in runs4]
    print(f"[4 mult] PN15QP880 logN {params.logn} L {params.max_level + 1} "
          f"+ {params.rlwe.pcount} P, alpha {params.rlwe.alpha}; keygen "
          f"{keygen_s:.1f} s; 4-party mult+relin+rescale ms "
          f"{[round(m, 3) for m in ms4]} median {statistics.median(ms4):.3f}"
          f", log2 err {max(e for _, e in runs4):.2f}; 2-party ms "
          f"{ms2:.3f}, log2 err {err2:.2f}; bound {bound:.2f}; launches "
          f"{launches}; peak mem "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    return launches


def main() -> None:
    device = phase_device()
    phase_build()
    params = mkckks.PN15QP880("cuda")
    stats = phase_kernels(params.rlwe.ring_qp)
    launches = phase_mult(params)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "mkhe_tpu_torch/csrc/ntt.cu", "replaces": replaces,
         "launches": launches[name], **stats[name]}
        for name, replaces in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
