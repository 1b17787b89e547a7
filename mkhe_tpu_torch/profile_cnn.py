"""Where the time of one two-party encrypted CNN inference goes.

    python -m mkhe_tpu_torch.profile_cnn [--trace PATH]

Builds the PN14QP433_CNN CRS and the keys of both parties (dataOwner,
modelOwner) from a seed on the first CUDA device, encrypts the model's
weights under modelOwner and one synthetic 28x28 image under dataOwner
(models/cnn.py, REF layout), checks the first inference's logits against
plain_forward, then prints, per warm inference of the staged pipeline
(cnn._pipeline):

  latency   median ms from CUDA events, and from the host clock with a
            synchronize;
  launches  NTT and key-switching kernel launches (ops/ntt_cuda and
            ops/basis_cuda counters) and key-switched rotations
            (count_rotations), mean over REPS inferences;
  spans     over the same inferences, the calls and the device ms of
            each span of the program (op_profile: the layers cnn.conv,
            cnn.fc1 and cnn.fc2, the evaluator ops ckks.*, the key
            switch's steps ksw.*), from a torch.profiler trace with the
            spans on;
  trace     torch.profiler over two inferences (profile_mult.trace):
            kernel time, kernel count and the device idle share of the
            traced window, which the tracer's host cost inflates; beside
            it an estimate of the untraced idle share, 1 - (traced kernel
            ms) / (untraced CUDA-event ms), from the two runs; then the
            same with the spans on, per span;
  fused     the inference as one CUDA-graph replay (build_fused_inference):
            warm latency, and profile_mult.trace over FUSED_CALLS calls
            (the spans fuse.call and fuse.replay, and Fused.replays).

`setup`, `infer`, `op_profile` and `count_rotations` take any parameters,
layout and device, so the same code runs at the MINI layout on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile as torch_profile

from . import mkckks, mkrlwe
from .mkrlwe import keyswitch as ksw
from .models import cnn
from .ops import basis_cuda, ntt_cuda
from .profile_mult import (enqueue_ms, host_ms, median_ms, print_trace,
                           trace)
from .utils import profiling

SEED = 2024
REPS = 5
FUSED_CALLS = 20
USERS = ("dataOwner", "modelOwner")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


@dataclasses.dataclass
class Setup:
    params: mkckks.Parameters     # with the CRS the inference needs
    layout: cnn.Layout
    weights: tuple                # (kernels, fc1, fc2, b1, b2)
    ev: mkckks.Evaluator
    enc: mkckks.Encryptor
    dec: mkckks.Decryptor
    sks: mkrlwe.SecretKeySet
    pks: dict
    rlk: mkrlwe.RelinearizationKeySet
    rtk: mkrlwe.RotationKeySet
    cjk: mkrlwe.ConjugationKeySet
    model: tuple                  # ct_k, ct_fc1, ct_fc2, ct_b1, ct_b2
    pt_mask: torch.Tensor
    keygen_s: float               # CRS and keys
    model_s: float                # model encryption, key stacks, tables

    def encrypt(self, v, uid: str = "modelOwner") -> mkckks.Ciphertext:
        return self.enc.encrypt_msg(mkckks.Message(value=v), self.pks[uid])

    def encrypt_image(self, img: np.ndarray) -> mkckks.Ciphertext:
        return self.encrypt(
            cnn.pack_image(img, self.params.slots, self.layout), "dataOwner")

    def logits(self, out: mkckks.Ciphertext) -> np.ndarray:
        return np.real(
            self.dec.decrypt(out, self.sks).value[:self.layout.classes])


def setup(params, layout: cnn.Layout = cnn.REF, weights=None,
          seed: int = SEED) -> Setup:
    """The CRS of layout.extra_rots (those of the powers of two below N/2
    and of conjugation are default ones); both parties' key pairs,
    relinearization, rotation and conjugation keys from seed; the model
    (load_weights() unless
    weights are given) encrypted under modelOwner from seed + 1; the fc2
    mask plaintext on the device; and the stacked rotation keys and Galois
    tables of every index, so that no inference builds them."""
    weights = cnn.load_weights() if weights is None else weights
    dev = params.rlwe.device
    rots = list(layout.extra_rots) + [1 << i for i in range(params.logn - 1)]
    t0 = time.perf_counter()
    for idx in layout.extra_rots:
        params = params.add_crs(idx)
    kgen = mkrlwe.KeyGenerator(params.rlwe, seed=seed)
    sks, pks = mkrlwe.SecretKeySet(), {}
    rlk, rtk = mkrlwe.RelinearizationKeySet(), mkrlwe.RotationKeySet()
    cjk = mkrlwe.ConjugationKeySet()
    for uid in USERS:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        sks.add(sk)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
        for r in rots:
            rtk.add(kgen.gen_rotation_key(r, sk))
        cjk.add(kgen.gen_conjugation_key(sk))
    _sync(dev)
    keygen_s = time.perf_counter() - t0
    s = Setup(params=params, layout=layout, weights=weights,
              ev=mkckks.Evaluator(params),
              enc=mkckks.Encryptor(params, seed=seed + 1),
              dec=mkckks.Decryptor(params), sks=sks, pks=pks, rlk=rlk,
              rtk=rtk, cjk=cjk, model=(), pt_mask=None, keygen_s=keygen_s,
              model_s=0.0)
    t0 = time.perf_counter()
    kernels, fc1, fc2, b1, b2 = weights
    slots = params.slots
    s.model = ([s.encrypt(v) for v in cnn.pack_kernels(kernels, slots,
                                                        layout)],
               [s.encrypt(v) for v in cnn.pack_fc1(fc1, slots, layout)],
               s.encrypt(cnn.pack_fc2(fc2, slots, layout)),
               s.encrypt(cnn.pack_b1(b1, slots, layout)),
               s.encrypt(cnn.pack_b2(b2, slots, layout)))
    s.pt_mask = torch.from_numpy(s.enc.encode_msg(mkckks.Message(
        value=cnn.mask_vector(slots, layout))).astype(np.int64)).to(dev)
    for r in rots:
        rtk.stacked(USERS, r)
        ksw.rotation_tables(params.rlwe, r)
    _sync(dev)
    s.model_s = time.perf_counter() - t0
    return s


def image(layout: cnn.Layout, seed: int) -> np.ndarray:
    """A synthetic image, uniform in [0, 1)."""
    return np.random.default_rng(seed).uniform(0, 1, (layout.image,
                                                      layout.image))


def infer(s: Setup, ct_img) -> mkckks.Ciphertext:
    """One inference through the staged pipeline."""
    return cnn._pipeline(s.ev, s.rlk, s.rtk, ct_img, *s.model, s.pt_mask,
                         s.params.scale, s.layout)


@contextlib.contextmanager
def count_rotations():
    """Counts the key-switched rotations made while the block runs: one
    per keyswitch.rotate call, one per index of each
    keyswitch.rotate_hoisted_batched call. Yields a dict whose
    "rotations" entry holds the count."""
    count = {"rotations": 0}
    rotate, batched = ksw.rotate, ksw.rotate_hoisted_batched

    def counted_rotate(*args, **kwargs):
        count["rotations"] += 1
        return rotate(*args, **kwargs)

    def counted_batched(params, ct, rot_idxs, *args, **kwargs):
        count["rotations"] += len(rot_idxs)
        return batched(params, ct, rot_idxs, *args, **kwargs)

    ksw.rotate, ksw.rotate_hoisted_batched = counted_rotate, counted_batched
    try:
        yield count
    finally:
        ksw.rotate, ksw.rotate_hoisted_batched = rotate, batched


@contextlib.contextmanager
def op_profile(device: torch.device):
    """Traces the block with torch.profiler and the program's spans on,
    and counts the key-switched rotations. Yields a dict that, once the
    block has ended, maps each span name to (calls, ms) and "rotations"
    to the rotation count. ms: the device time of the kernels launched
    inside the span on a CUDA device, the span's host time otherwise."""
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    stats = {}
    with torch_profile(activities=acts) as prof:
        with profiling.spans_on(), count_rotations() as rot:
            yield stats
        _sync(device)
    key = "device_us" if cuda else "host_us"
    for name, row in profiling.SpanTrace(
            profiling.kineto_events(prof)).by_name().items():
        stats[name] = (row["calls"], row[key] / 1e3)
    stats["rotations"] = rot["rotations"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", default=None,
                    help="write a Chrome trace of the traced inferences here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    s = setup(mkckks.PN14QP433_CNN("cuda"))
    lo, dev = s.layout, s.params.rlwe.device
    img = image(lo, SEED)
    ct_img = s.encrypt_image(img)
    t0 = time.perf_counter()
    out = infer(s, ct_img)
    _sync(dev)
    first_ms = (time.perf_counter() - t0) * 1e3
    err = float(np.max(np.abs(s.logits(out)
                              - cnn.plain_forward(img, *s.weights, lo))))
    if not err <= 5e-3:
        raise AssertionError(f"logits differ from plain_forward by {err}")
    ms = median_ms(lambda: infer(s, ct_img), REPS, dev)
    ms_host = host_ms(lambda: infer(s, ct_img), REPS, dev)
    print(f"PN14QP433_CNN, REF layout, 2 parties, torch {torch.__version__}:"
          f" keygen {s.keygen_s:.2f} s, model encryption and key stacks "
          f"{s.model_s:.2f} s; first inference {first_ms:.3f} ms (host "
          f"clock), max logit err {err:.3g}; warm {ms:.3f} ms (CUDA events, "
          f"median of {REPS}), {ms_host:.3f} ms (host clock + synchronize)",
          flush=True)
    ntt_cuda.reset_counters()
    basis_cuda.reset_counters()
    with op_profile(dev) as ops:
        for _ in range(REPS):
            infer(s, ct_img)
    launches = {**ntt_cuda.counters(), **basis_cuda.counters()}
    rotations = ops.pop("rotations")
    print(f"per inference, mean of {REPS}: launches "
          + ", ".join(f"{k} {launches[k] / REPS:g}" for k in (
              "ntt_fwd", "ntt_inv", *basis_cuda.counters()))
          + f", {rotations / REPS:g} key-switched rotations; device ms "
          "under each span (traced, spans on):", flush=True)
    for name, (calls, op_ms) in sorted(ops.items(), key=lambda kv: kv[0]):
        print(f"  span {name}: {calls / REPS:g} calls, {op_ms / REPS:.3f} ms",
              flush=True)
    tr = trace(lambda: infer(s, ct_img), 2, dev, args.trace)
    print_trace(tr, "inference")
    print(f"untraced idle share estimated from two runs "
          f"{1 - tr['kernel_ms_per_call'] / ms:.4f}", flush=True)

    fn, fargs = cnn.build_fused_inference(
        s.params, s.rlk, s.rtk, ct_img, *s.model, s.pt_mask, layout=lo)

    def fused():
        return fn(fargs[0], fargs[1], (ct_img,) + tuple(fargs[2][1:]))

    fused_ms = host_ms(fused, REPS, dev)
    before = fn.replays
    tr = trace(fused, FUSED_CALLS, dev)
    print(f"fused: {fused_ms:.3f} ms an inference (host clock + "
          f"synchronize, median of {REPS}); Fused.replays rose by "
          f"{fn.replays - before} over the trace's {FUSED_CALLS // 4 + 1} "
          f"warm-up calls and its two stretches of {FUSED_CALLS} calls; "
          f"untraced enqueue (host ms of the call alone, median of {REPS}) "
          f"staged {enqueue_ms(lambda: infer(s, ct_img), REPS, dev):.3f}, "
          f"fused {enqueue_ms(fused, REPS, dev):.4f}", flush=True)
    print_trace(tr, "fused inference")


if __name__ == "__main__":
    main()
