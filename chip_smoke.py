#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (mkhe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, then two JSON lines:
  1. device   torch / CUDA versions and the card, plus nvidia-smi's
              "name, power.limit" line;
  2. build    nvcc builds csrc/ntt.cu, csrc/ntt_split.cu and
              csrc/ntt_variant.cu (sm_90a) from the checkout, one
              compiler per source, started together;
              ptxas's spills and registers per kernel;
  3. kernels  the NTT kernels against their plain PyTorch versions on the
              card, bit for bit, at the PN15QP880 QP moduli (32 limbs,
              N = 2^15, batch 8), at logN = 10 and at the CNN's
              PN14QP433_CNN QP moduli (18 limbs, N = 2^14, batch 8), with
              canonical, any-u32 and < 8q inputs: ntt_fwd, ntt_inv, the
              split kernels (csrc/ntt_split.cu) in their five modes (the
              fused forward ntt_split_fwd, the tail with either map, the
              head, the fused inverse ntt_split_inv, the DIT stages alone
              ntt_inv_tailed); ntt_fwd and ntt_inv also at the 4-party
              mult's digit launch (4 x 14 digits x 32 QP limbs x 2^15);
              the fused forward and head + tail against the full forward
              kernel, the fused inverse and tail + DIT alone against the
              full inverse kernel; round trips (the fused inverse of the
              fused forward among them); median times from CUDA events
              of single launches (`ms`, as in the earlier smoke runs) and
              of the mean of 10 back-to-back launches (`ms_mean10`,
              without the host's launch time), each beside its bound
              (profile_ntt.kernel_bound) and share of it;
  3b. probe   the NTT cost probe's variant kernel (csrc/ntt_variant.cu)
              against its plain version on the card, bit for bit, in every
              setting it is built for and both block orders: at the TPU
              probe's shape (4 x 32 x 2^15, ntt_primes(15, 28.9, 32)), at
              logN 10 and at the CNN's logN 14 QP moduli (8 x 18); every
              stage against Ring.ntt and logN - 7 stages against the head
              kernel's head mode; its times (full setting, 4 x 32 x 2^15)
              beside its
              bound and its plain version's; then, counters at 0, the
              probe's path (mkhe_tpu_torch.ntt_probe.probe: its six rows,
              checked and timed, and the ntt_fwd row) at 4 x 32 x 2^15,
              which must launch the kernel, with the twiddle and exchange
              shares; then the full row at the probe's `cnn` (8 x 18 x
              2^14) and `digits` (4 x 14 x 32 x 2^15) shapes, each equal
              to Ring.ntt, with its CUDA-graph ms, bound and share;
  4. mult     the CKKS main path: PN15QP880, 4 parties, keys from the
              port's seeds (threefry) on the card; three requests of fresh
              encryptions -> Evaluator.mul_relin_new (mult + relin +
              rescale) -> decrypt, and one 2-party request; each decrypts
              within log2|err| <= -log2(scale) + logslots + 12; the NTT
              launch counters must grow during the phase;
  5. bfv      the MKBFV path with the split NTT on (config.ntt_mxu_tail):
              PN15QP880, 4 parties, keys from the port's seeds on the card;
              two 4-party requests ((user0 + user1) x (user2 + user3))
              and, between them, one 2-party request (user0 x user1) of
              fresh encryptions -> Evaluator.mul_relin_new -> decrypt,
              each exactly equal to the plaintext product mod t; the
              split's launch counters (the fused forward, the fused
              inverse) must grow and the full kernels', the head's, the
              tail's and the DIT-alone mode's stay at 0; the last 4-party
              mult again with the
              switch off, off and on must give the same ciphertext bit for
              bit;
  6. cnn      the two-party encrypted MNIST CNN (models/cnn.py, REF
              layout) at PN14QP433_CNN: CRS and keys (key pairs,
              relinearization, rotation keys for REF.extra_rots and the
              powers of two 1..4096, conjugation) from the port's seeds on
              the card; the model's weights encrypted once under
              modelOwner; three requests, each a fresh synthetic 28x28
              image encrypted under dataOwner -> the staged pipeline
              (conv -> square -> fc1 -> square -> fc2) timed with CUDA
              events, per layer too -> decrypt, each logit within
              rtol = atol = 5e-3 of plain_forward and the same argmax;
              a batched hoisted rotation over fc1's 7 indices equal to 7
              single ones bit for bit, and a conjugation that decrypts to
              the conjugate; the NTT launch counters must grow; the
              key-switched rotations of the requests are counted
              (profile_cnn.count_rotations).
  7. fused    the runtime tier at full width (fuse.py, the CNN's
              build_fused_inference, the batched mults), every replay on
              inputs that are not the capture's: CKKS PN15QP880, 4
              parties, fuse of mul_relin_new, three fresh requests each
              equal to eager mul_relin_new bit for bit and within phase
              4's bound, eager and replay ms in turns (CUDA events);
              fuse_chained (sum feedback) at k = 1 and 4 equal to the
              eager chain, and the slope (t(4) - t(1)) / 3; the batched
              mult at B = 1, 2 and 4, each output equal to mul_relin_new,
              ms per mult; BFV PN15QP880 with the split on: fuse of mult +
              add equal to staged, and the batched mult at B = 2 equal to
              pair by pair; the CNN (PN14QP433_CNN, REF): build_fused_
              inference with profile_cnn.setup's model, three fresh images
              each equal to the staged pipeline bit for bit and within the
              logit gate, staged and replay ms in turns, the capture's
              time and peak memory; the NTT launches captured into the
              graphs (more than 0) and the graph replays: the counters
              count wrapper calls, so they see the captures and not the
              replays.
  8. api      the public surface at PN15QP880 from the port's own default
              parameters (no CRS added or carried in): the CRS index sets
              of the three parameter sets equal the JAX package's rule
              (0, -1..-4, 2^i for i < logN - 1; written out here), with
              their GB on the card; CKKS, 4 parties, the default rotation
              keys and conjugation keys: rotate_new by 1, 5 (1 then 4) and
              -1 (14 power-of-two steps) and conjugate_new, each within
              phase 4's bound; 4 relin keys, a secret key, a rotation key
              and a product ciphertext saved and loaded (utils.serialize,
              a temporary directory) bit for bit, and a mult with the
              loaded relin keys equal to one with the originals; BFV, 4
              parties: rotate_new by 1 and 3 (1 then 2) and conjugate_new,
              each exactly the plaintext's rotation (two rows of N/2), the
              rotation by 3 again with the split off and on, bit for bit;
              ms of rotate_new(1) and conjugate_new (CUDA events, median
              of 3 after a warm-up) in both schemes; the u64 oracle gate
              (utils.oracle.cross_validate("pn15", ..., seed=17), as
              bench.py::oracle_cross_check): both errors within the bound
              and within 6 bits of each other, with its seconds; both
              examples' main() on the card; the phase's NTT launches,
              which must be more than 0, on a line of their own;
  9. parallel the parallel tier: 4 ranks spawned on the one card
              (parallel/_ranks.py, gloo: the card's NCCL refuses two ranks
              on one device, and ranks sharing a card cannot time their
              exchanges), each run bit for bit against the
              single-device result on the card: the coefficient-sharded
              forward and inverse NTT of 8 x 32 x 2^15 at C = 2 and 4, the
              PN15QP880 4-party coefficient-sharded mult at C = 2 (which
              also decrypts within phase 4's bound, through the native
              CRT), the party-sharded mult and rotate_new(1) counterpart
              over 4 and 2 ranks; every rank's NTT launch counters grow
              in every run; the chunk-local kernels (8 x 32 x 2^14 and
              2^13, rank 0's tables) against their plain versions, with
              their times and bounds; the PN15 decodes' host ms, python
              CRT against the native one; the transport, each rank's peak
              GiB and the phase's seconds on one line.
 10. seeds    the card against the JAX package from seeds alone: the three
              parameter sets (CKKS and BFV PN15QP880, CKKS PN14QP433_CNN)
              built afresh, one at a time, with their construction seconds
              (profile_params.build); the sha256 of every default CRS's
              u32 words in the JAX layout (convert.sha256_u32), and at CKKS
              PN15QP880 of KeyGenerator(seed=1)'s "user0" sk, pk and
              relinearization key and of Encryptor(seed=2)'s encryption of
              profile_params.fixed_plaintext under that pk, each equal to
              the digest the JAX package gives (tests/torch_seed_digests.json,
              recomputed by tests/test_torch_prng.py).
Then {"kernels": [...]} (launches summed over phases 4-6, as before phase
7 existed, so phase 7's captured launches are not in them; ntt_variant's
from phase 3b's probe run: the wrapper's launches, those captured into
its CUDA graphs (profile_ntt.graph_ms) included and the graphs' replays,
which run without the wrapper, not; times, bounds and plain times, all single
launches, and ms_mean10 of phase 3 at logN 15, ntt_variant's of phase 3b)
and, last, {"ok": true, "device": {...}}.

Any failure raises and the exit code is not 0. Without a CUDA device it
fails in phase 1.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import tempfile
import time
import types

import numpy as np
import torch

from mkhe_tpu_torch import (config, convert, fuse, mkbfv, mkckks, mkrlwe,
                            native, ntt_probe, profile_cnn, profile_ntt,
                            profile_params)
from mkhe_tpu_torch.examples import two_party_bfv, two_party_ckks
from mkhe_tpu_torch.mkrlwe import keyswitch as ksw
from mkhe_tpu_torch.models import cnn
from mkhe_tpu_torch.ops import ntt_cuda
from mkhe_tpu_torch.ops.ring import Ring
from mkhe_tpu_torch.profile_ntt import cuda_ms, graph_ms
from mkhe_tpu_torch.parallel import _ranks, dist_ntt
from mkhe_tpu_torch.utils import crt, oracle, serialize

BATCH = 8
SEED = 2024
NTT_CU = "mkhe_tpu_torch/csrc/ntt.cu"
SPLIT_CU = "mkhe_tpu_torch/csrc/ntt_split.cu"
VARIANT_CU = "mkhe_tpu_torch/csrc/ntt_variant.cu"
DIGESTS = "tests/torch_seed_digests.json"
KERNELS = (   # name, source, the TPU kernel it replaces
    ("ntt_fwd", NTT_CU, "mkhe_tpu/ops/ntt_pallas.py:126"),   # _fwd_kernel
    ("ntt_inv", NTT_CU, "mkhe_tpu/ops/ntt_pallas.py:138"),   # _inv_kernel
    # the split kernel's fused forward: _fwd_kernel(head_only=True) (:102)
    # and _tail_apply (:266) in one launch
    ("ntt_split_fwd", SPLIT_CU, "mkhe_tpu/ops/ntt_pallas.py:102"),
    # the split inverse kernel's fused mode: _tail_apply (:266) with the
    # inverse map and _inv_kernel(tail_done=True) (:138) in one launch
    ("ntt_split_inv", SPLIT_CU, "mkhe_tpu/ops/ntt_pallas.py:138"),
    # the split kernel's tail mode alone: _tail_apply (phase 3 only)
    ("ntt_tail", SPLIT_CU, "mkhe_tpu/ops/ntt_pallas.py:266"),
    # the split inverse kernel's DIT mode alone: _inv_kernel(tail_done=True)
    # (phase 3 only)
    ("ntt_inv_tailed", SPLIT_CU, "mkhe_tpu/ops/ntt_pallas.py:175"),
    ("ntt_variant", VARIANT_CU, "benchmarks/ntt_probe.py:35"),
)
MAIN = KERNELS[:6]   # the kernels whose launches phases 4-6 count


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
    print(f"[2 build] {secs:.2f} s -> {ntt_cuda.LIB_PATH.name}; "
          f"ptxas: {' | '.join(ntt_cuda.ptxas_lines(log))}", flush=True)


def _rand(gen, shape, bound):
    """Uniform int64 in [0, bound) per limb (bound: (L, 1) or int)."""
    r = torch.randint(0, 1 << 62, shape, generator=gen, dtype=torch.int64,
                      device="cuda")
    return r % bound


def phase_kernels(ring15: Ring, ring14: Ring) -> dict:
    """Every kernel against its plain version on the card, and the split's
    compositions against the full kernels, at the CKKS and BFV paths'
    logN 15 QP moduli, at logN 10 and at the CNN path's shape (logN 14, its
    18 QP moduli); ntt_fwd / ntt_inv, and the split inverse's fused and
    DIT modes, also at the 4-party mult's digit launch (4 x 14 digits x
    32 QP limbs x 2^15). Returns per-kernel
    max_abs_err, the times at logN 15 (batch 8 of the 32 QP limbs) and
    their bounds."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    err = {}
    mism = comp_mism = 0
    times = {"15": {}, "14": {}, "digits": {}}
    ring10 = Ring.create(ring15.moduli, 10)
    for ring in (ring15, ring14, ring10, "digits"):
        digits = ring == "digits"
        ring = ring15 if digits else ring
        shape = ((4, 14) if digits else (BATCH,)) + (ring.nlimbs, ring.n)
        q = ring.q[:, None]
        fwd_p = (ring.q, ring.bar, ring.psi, ring.psi_sh)
        inv_p = (ring.q, ring.bar, ring.ipsi, ring.ipsi_sh, ring.ninv,
                 ring.ninv_sh)
        fwd_t, inv_t = fwd_p + (ring.psi_pack,), inv_p + (ring.ipsi_pack,)
        # what the full kernels read, for their bounds
        reads = {"ntt_fwd": (ring.q, ring.bar, ring.psi_pack),
                 "ntt_inv": (ring.q, ring.bar, ring.ninv, ring.ninv_sh,
                             ring.ipsi_pack)}
        canon = _rand(gen, shape, q)
        any32 = _rand(gen, shape, 1 << 32)
        lazy = _rand(gen, shape, 8 * q)
        K = ntt_cuda
        # name, kernel, its tables, plain version, its tables, input
        cases = (
            ("ntt_fwd", K.ntt, fwd_t, K.ntt_plain, fwd_p, any32),
            ("ntt_inv", K.intt, inv_t, K.intt_plain, inv_p, lazy),
        )
        if not digits:
            cases = (("ntt_fwd", K.ntt, fwd_t, K.ntt_plain, fwd_p, canon),
                     ) + cases
        # round trip
        pairs = [(K.intt(K.ntt(canon, *fwd_t), *inv_t), canon)]
        st = ring.split_tables()
        itail_t = (ring.q, ring.bar, st.iwpack, st.iwpack_sh, st.untwist,
                   st.untwist_sh)
        itail_k = itail_t + (st.iwpack_pack, st.untwist_pack)
        sinv_t = (ring.q, ring.bar, ring.r_inv, st)
        # the kernel's own tables (the plain versions read the rest)
        dit_r = (ring.q, st.iwpack_pack[:, :ring.n - 128], st.untwist_pack)
        reads.update(ntt_split_inv=dit_r + (st.tail_inv_frag, st.tail_pow8),
                     ntt_inv_tailed=dit_r + (ring.bar,))
        inv_cases = (
            ("ntt_inv_tailed", K.intt_tailed, itail_k, K.intt_tailed_plain,
             itail_t, any32),
            ("ntt_split_inv", K.ntt_split_inv, sinv_t, K.ntt_split_inv_plain,
             sinv_t, lazy))
        if digits:
            cases += inv_cases
        else:
            split_t = (ring.q, ring.r_inv, st)
            head_t = (ring.q, st.twist, st.twist_sh, st.wpack, st.wpack_sh,
                      st.twist_pack, st.wpack_pack)
            tfwd_t = (ring.q, ring.r_inv, st.tail_fwd, st.tail_pow,
                      st.tail_fwd_frag, st.tail_pow8)
            tinv_t = (ring.q, ring.r_inv, st.tail_inv, st.tail_pow,
                      st.tail_inv_frag, st.tail_pow8)
            head_r = (ring.q, st.twist_pack, st.wpack_pack[:, :ring.n - 128])
            reads.update(ntt_split_fwd=head_r + (st.tail_fwd_frag,
                                                 st.tail_pow8),
                         ntt_fwd_head=head_r,
                         ntt_tail=(ring.q, st.tail_inv_frag, st.tail_pow8))
            cases += (
                ("ntt_split_fwd", K.ntt_split_fwd, split_t,
                 K.ntt_split_fwd_plain, split_t, any32),
                ("ntt_split_fwd", K.ntt_split_fwd, split_t,
                 K.ntt_split_fwd_plain, split_t, canon),
                ("ntt_tail", K.tail, tinv_t, K.tail_plain, tinv_t[:4], lazy),
                ("ntt_tail", K.tail, tinv_t, K.tail_plain, tinv_t[:4],
                 any32),
                ("ntt_tail", K.tail, tfwd_t, K.tail_plain, tfwd_t[:4],
                 any32),
                ("ntt_fwd_head", K.ntt_head, head_t, K.ntt_head_plain,
                 head_t[:5], any32),
            ) + inv_cases + (
                ("ntt_split_inv", K.ntt_split_inv, sinv_t,
                 K.ntt_split_inv_plain, sinv_t, canon),
                ("ntt_split_inv", K.ntt_split_inv, sinv_t,
                 K.ntt_split_inv_plain, sinv_t, any32),
            )
            # the split's compositions against the full kernels
            split_fwd = K.ntt_split_fwd(any32, *split_t)
            pairs += [(split_fwd, K.ntt(any32, *fwd_t)),
                      (K.tail(K.ntt_head(any32, *head_t), *tfwd_t),
                       split_fwd),
                      (K.intt_tailed(K.tail(lazy, *tinv_t), *itail_k),
                       K.intt(lazy, *inv_t)),
                      (K.intt_tailed(K.tail(split_fwd, *tinv_t), *itail_k),
                       ring.reduce(any32)),
                      (K.ntt_split_inv(lazy, *sinv_t), K.intt(lazy, *inv_t)),
                      (K.ntt_split_inv(any32, *sinv_t),
                       K.intt(any32, *inv_t)),
                      (K.ntt_split_inv(split_fwd, *sinv_t),
                       ring.reduce(any32))]
        for name, kern, ktabs, plain, ptabs, x in cases:
            got, want = kern(x, *ktabs), plain(x, *ptabs)
            torch.cuda.synchronize()
            mism += int((got != want).sum())
            err[name] = max(err.get(name, 0),
                            int((got - want).abs().max()))
            del got, want
        for got, want in pairs:
            torch.cuda.synchronize()
            comp_mism += int((got != want).sum())
        if ring is ring10:
            continue
        out = times["digits" if digits else "15" if ring is ring15 else "14"]
        for name, kern, ktabs, plain, ptabs, x in cases:
            if name in out or (name in ("ntt_fwd", "ntt_split_fwd")
                               and x is canon):
                continue
            b_ms, b_by = profile_ntt.kernel_bound(name, x,
                                                  reads.get(name, ktabs))
            out[name] = dict(ms=cuda_ms(lambda: kern(x, *ktabs), 20, 1),
                             ms_mean10=cuda_ms(lambda: kern(x, *ktabs), 20),
                             bound_ms=b_ms, bound_by=b_by)
            if not digits:
                out[name]["plain_ms"] = cuda_ms(lambda: plain(x, *ptabs), 5,
                                                1)

    def show(t):
        return ", ".join(
            f"{name} {r['ms']:.4f}, mean of 10 {r['ms_mean10']:.4f} (bound "
            f"{r['bound_ms']:.4f}, {r['bound_ms'] / r['ms']:.1%} of it"
            + (f"; plain {r['plain_ms']:.4f}" if "plain_ms" in r else "")
            + ")" for name, r in t.items())

    print(f"[3 kernels] mismatches {mism} kernel vs plain (ntt_fwd, ntt_inv,"
          f" the split kernels' fused forward, tail, head, fused inverse "
          f"and DIT modes at logN 15, 14 and 10, ntt_fwd / ntt_inv also at "
          f"the digit launch with the split inverse's two modes; "
          f"canonical, any-u32 and <8q inputs), "
          f"{comp_mism} ntt_split_fwd vs ntt_fwd, head+tail vs "
          f"ntt_split_fwd, ntt_split_inv and tail+inv_tailed vs ntt_inv and "
          f"round trips; "
          f"median ms at logN 15 batch {BATCH} x {ring15.nlimbs} "
          f"limbs: {show(times['15'])}; logN 14 batch {BATCH} x "
          f"{ring14.nlimbs} limbs (the CNN's QP): {show(times['14'])}; "
          f"digit launch 4 x 14 x {ring15.nlimbs} x 2^15: "
          f"{show(times['digits'])}", flush=True)
    if mism or comp_mism:
        raise AssertionError(f"kernels differ from their plain versions in "
                             f"{mism} values, from the full kernels and in "
                             f"round trips in {comp_mism}")
    return {name: dict(max_abs_err=err[name], **times["15"][name])
            for name, _, _ in MAIN}


def phase_probe(ring14: Ring) -> dict:
    """The variant kernel against its plain version in every setting it is
    built for and both block orders, at the TPU probe's shape, logN 10 and
    the CNN's logN 14; the cross-checks; its times; then the probe's path
    with the counters at 0. Returns its kernel-line entry."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 31)
    ring15, batch = ntt_probe.shape_ring("probe", "cuda")
    ring10 = Ring.create(ring15.moduli, 10)
    mism = comp_mism = err = 0
    for ring, b in ((ring15, batch), (ring10, batch), (ring14, (BATCH,))):
        t = ntt_probe.variant_tables(ring)
        x = _rand(gen, (*b, ring.nlimbs, ring.n), 1 << 32)
        x[0, :, :64] = (1 << 32) - 1
        for stages, exchange, mul in sorted(
                ntt_cuda.variant_settings(ring.logn)):
            want = ntt_cuda.ntt_variant_plain(
                x, t, stages=stages, exchange=exchange, mul=mul)
            for order in ntt_cuda.ORDERS:
                got = ntt_cuda.ntt_variant(x, t, stages=stages,
                                           exchange=exchange, mul=mul,
                                           order=order)
                torch.cuda.synchronize()
                mism += int((got != want).sum())
                err = max(err, int((got - want).abs().max()))
        pairs = ((ntt_cuda.ntt_variant(x, t, stages=ring.logn),
                  ring.ntt(x)),
                 (ntt_cuda.ntt_variant(x, t, stages=ring.logn - 7),
                  ntt_cuda.ntt_head(x, t.q, t.twist, t.twist_sh, t.wpack,
                                    t.wpack_sh, t.twist_pack,
                                    t.wpack_pack)))
        torch.cuda.synchronize()
        comp_mism += sum(int((got != want).sum()) for got, want in pairs)
    if mism or comp_mism:
        raise AssertionError(f"ntt_variant differs from its plain version in"
                             f" {mism} values, from Ring.ntt / ntt_head in "
                             f"{comp_mism}")
    t = ntt_probe.variant_tables(ring15)
    x = _rand(gen, (*batch, ring15.nlimbs, ring15.n), 1 << 32)
    n = ring15.logn
    b_ms, b_by = profile_ntt.kernel_bound(
        "ntt_variant", x, ntt_probe.variant_reads(t, n, True), n)
    stats = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: ntt_cuda.ntt_variant(x, t, stages=n),
                   ntt_probe.REPS, 1),
        ms_mean10=cuda_ms(lambda: ntt_cuda.ntt_variant(x, t, stages=n),
                          ntt_probe.REPS),
        bound_ms=b_ms, bound_by=b_by,
        plain_ms=cuda_ms(lambda: ntt_cuda.ntt_variant_plain(
            x, t, stages=n), 5, 1))
    ntt_cuda.reset_counters()
    res = ntt_probe.probe(ring15, batch, timed=True)
    launches = ntt_cuda.counters()["ntt_variant"]
    if launches < 1:
        raise AssertionError("the probe launched no variant kernel")
    d = res["derived"]
    shapes = {}
    for label in ("cnn", "digits"):
        ring, b = ntt_probe.shape_ring(label, "cuda")
        tl = ntt_probe.variant_tables(ring)
        xl = _rand(gen, (*b, ring.nlimbs, ring.n), 1 << 32)
        full = lambda: ntt_cuda.ntt_variant(xl, tl, stages=ring.logn)
        if not torch.equal(full(), ring.ntt(xl)):
            raise AssertionError(f"ntt_variant's full row != Ring.ntt at "
                                 f"{label}")
        sb_ms, _ = profile_ntt.kernel_bound(
            "ntt_variant", xl, ntt_probe.variant_reads(tl, ring.logn, True),
            ring.logn)
        g = graph_ms(full, ntt_probe.REPS)
        shapes[label] = (list(xl.shape), g, sb_ms)
        del xl
    print(f"[3b probe] mismatches {mism} kernel vs plain (every built "
          f"setting, both block orders, at {batch[0]} x {ring15.nlimbs} x "
          f"2^15, logN 10 and logN 14 x {ring14.nlimbs} limbs), {comp_mism} "
          f"full vs Ring.ntt and logN - 7 stages vs ntt_head; full at "
          f"{res['shape']}: {stats['ms']:.4f} ms, mean of 10 "
          f"{stats['ms_mean10']:.4f} (bound {b_ms:.4f}, "
          f"{b_ms / stats['ms']:.1%} of it; plain {stats['plain_ms']:.4f}); "
          f"probe rows (mean of 10 / CUDA graph): " + ", ".join(
              f"{name} {r['ms']:.4f} / {r['graph_ms']:.4f}"
              for name, r in res["rows"].items())
          + f"; from the graph times: slope {d['slope_ms_per_stage']:.5f} "
          f"ms/stage, twiddle share "
          f"{d['twiddle_share']:.1%}, exchange share "
          f"{d['exchange_share']:.1%}, swap grid - full "
          f"{d['swap_minus_full_ms']:+.4f} ms; launches {launches}; full "
          f"row, equal to Ring.ntt, CUDA graph: " + ", ".join(
              f"{label} {shp} {g:.4f} ms (bound {sb:.4f}, {sb / g:.1%})"
              for label, (shp, g, sb) in shapes.items()),
          flush=True)
    return dict(stats, launches=launches)


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
    launches = ntt_cuda.counters()
    if min(launches["ntt_fwd"], launches["ntt_inv"]) < 1:
        raise AssertionError(f"the main path launched no kernel: {launches}")
    ms4 = [ms for ms, _ in runs4]
    print(f"[4 mult] PN15QP880 logN {params.logn} L {params.max_level + 1} "
          f"+ {params.rlwe.pcount} P, alpha {params.rlwe.alpha}; keygen "
          f"{keygen_s:.1f} s; 4-party mult+relin+rescale ms "
          f"{[round(m, 3) for m in ms4]} median {statistics.median(ms4):.3f}"
          f", log2 err {max(e for _, e in runs4):.2f}; 2-party ms "
          f"{ms2:.3f}, log2 err {err2:.2f}; bound {bound:.2f}; launches "
          f"{ {k: launches[k] for k in ('ntt_fwd', 'ntt_inv')} }; peak mem "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    return launches


def phase_bfv(params) -> dict:
    """The MKBFV path with the split NTT: keys, exact mults, the switch-off
    rerun. Returns the launch counts of the split requests."""
    config.ntt_mxu_tail = True
    try:
        users = [f"user{i}" for i in range(4)]
        t0 = time.perf_counter()
        kgen = mkbfv.KeyGenerator(params, seed=SEED + 11)
        sks, rlk, pks = (mkrlwe.SecretKeySet(),
                         mkbfv.RelinearizationKeySet(), {})
        for uid in users:
            sk, pks[uid] = kgen.gen_key_pair(uid)
            sks.add(sk)
            rlk.add(kgen.gen_relinearization_key_bfv(
                sk, kgen.gen_secret_key(uid)))
        torch.cuda.synchronize()
        keygen_s = time.perf_counter() - t0
        # the split's tables of R (the 28 QMul limbs are new), built
        # here and not inside the first timed mult
        t0 = time.perf_counter()
        params.ring_r.split_tables()
        torch.cuda.synchronize()
        tables_s = time.perf_counter() - t0
        enc = mkbfv.Encryptor(params, seed=SEED + 12)
        dec, ev = mkbfv.Decryptor(params), mkbfv.Evaluator(params)
        rng = np.random.default_rng(SEED + 13)
        t = params.t

        def operands(k):
            """Fresh encryptions: the first half of the parties summed
            times the second half summed (bench.py:101-145)."""
            half = k // 2
            lo, hi = -(t // 2) + 1, t // 2
            msgs = [rng.integers(lo // half, hi // half, params.n,
                                 dtype=np.int64) for _ in range(k)]
            cts = [enc.encrypt_msg(m, pks[uid])
                   for m, uid in zip(msgs, users)]
            c0, c1 = cts[0], cts[half]
            for c in cts[1:half]:
                c0 = ev.add_new(c0, c)
            for c in cts[half + 1:k]:
                c1 = ev.add_new(c1, c)
            want = np.mod(sum(msgs[:half]) * sum(msgs[half:]), t)
            return c0, c1, np.where(want > t // 2, want - t, want)

        def mult(c0, c1):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = ev.mul_relin_new(c0, c1, rlk)
            end.record()
            torch.cuda.synchronize()
            return res, start.elapsed_time(end)

        def request(k):
            c0, c1, want = operands(k)
            res, ms = mult(c0, c1)
            got = dec.decrypt(res, sks)
            if not (res.ids == tuple(users[:k]) and got.shape == want.shape
                    and np.array_equal(got, want)):
                raise AssertionError(
                    f"{k}-party BFV mult: ids {res.ids}, "
                    f"{int((got != want).sum())} slots differ")
            return c0, c1, res, ms

        torch.cuda.reset_peak_memory_stats()
        ntt_cuda.reset_counters()
        first4 = request(4)
        ms2 = request(2)[3]
        c0, c1, res_on, ms_on = request(4)
        launches = ntt_cuda.counters()
        split = ("ntt_split_fwd", "ntt_split_inv")
        unsplit = ("ntt_tail", "ntt_inv_tailed", "ntt_fwd_head", "ntt_fwd",
                   "ntt_inv")
        if (min(launches[k] for k in split) < 1
                or any(launches[k] for k in unsplit)):
            raise AssertionError(f"the BFV path did not run the fused split "
                                 f"kernels alone: {launches}")
        # the last 4-party mult again, in turns on, off, off, on
        turns = {True: [ms_on], False: []}
        for on in (False, False, True):
            config.ntt_mxu_tail = on
            res, ms = mult(c0, c1)
            turns[on].append(ms)
            if not (res.ids == res_on.ids
                    and torch.equal(res.data, res_on.data)):
                raise AssertionError("the BFV mult with the split "
                                     f"{'on' if on else 'off'} differs")
    finally:
        config.ntt_mxu_tail = False
    print(f"[5 bfv] PN15QP880 logN {params.logn} Q {len(params.rlwe.q_moduli)}"
          f" + QMul {len(params.qmul_moduli)} + P {params.rlwe.pcount}, alpha "
          f"{params.rlwe.alpha}, t {t}, split NTT on; keygen {keygen_s:.2f} s, "
          f"R's split tables {tables_s:.2f} s;"
          f" exact: 4-party mult ms {first4[3]:.3f} (first) and {ms_on:.3f},"
          f" 2-party {ms2:.3f}; last 4-party mult again, bit-identical, ms "
          f"split on {[round(m, 3) for m in turns[True]]} off "
          f"{[round(m, 3) for m in turns[False]]}; launches "
          f"{ {k: launches[k] for k in split} }; peak mem "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    return launches


def phase_cnn(params) -> dict:
    """The two-party encrypted CNN inference: keys, the encrypted model,
    three requests through the staged pipeline, each checked per logit
    against plain_forward. Returns the launch counts of the requests."""
    s = profile_cnn.setup(params, cnn.REF, seed=SEED + 21)
    params, lo, ev, slots = s.params, s.layout, s.ev, s.params.slots

    def request(k):
        img = profile_cnn.image(lo, SEED + k)
        ct_img = s.encrypt_image(img)
        torch.cuda.synchronize()
        events = {}

        def mark(name):
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()

        mark("start")
        out = profile_cnn.infer(s, ct_img, marks=mark)
        mark("end")
        torch.cuda.synchronize()
        ms = {name: events[a].elapsed_time(events[b]) for name, a, b in (
            ("total", "start", "end"), ("conv", "start", "conv"),
            ("fc1", "conv", "fc1"), ("fc2", "fc1", "end"))}
        logits = s.logits(out)
        want = cnn.plain_forward(img, *s.weights, lo)
        if not (out.ids == profile_cnn.USERS and logits.shape == want.shape
                and np.all(np.isfinite(logits))
                and np.allclose(logits, want, rtol=5e-3, atol=5e-3)
                and int(np.argmax(logits)) == int(np.argmax(want))):
            raise AssertionError(f"CNN request {k}: ids {out.ids}, logits "
                                 f"{logits} against {want}")
        return ms, float(np.max(np.abs(logits - want))), img, ct_img

    torch.cuda.reset_peak_memory_stats()
    ntt_cuda.reset_counters()
    with profile_cnn.count_rotations() as rot:
        runs = [request(k) for k in range(3)]
    launches = ntt_cuda.counters()
    if min(launches["ntt_fwd"], launches["ntt_inv"]) < 1:
        raise AssertionError(f"the CNN launched no NTT kernel: {launches}")
    # fc1's batched hoisted rotation against single ones, and conjugation
    _, _, img, ct = runs[-1]
    h = ev.hoisted_form(ct)
    idxs = [i * lo.gap for i in range(1, lo.n_diag)]
    for r, got in zip(idxs, ev.rotate_hoisted_many_new(ct, idxs, h, s.rtk)):
        if not torch.equal(got.ct.data,
                           ev.rotate_hoisted_new(ct, r, h, s.rtk).ct.data):
            raise AssertionError(f"batched hoisted rotation {r} differs")
    conj = s.dec.decrypt(ev.conjugate_new(ct, s.cjk), s.sks).value
    conj_err = float(np.max(np.abs(
        conj - np.conj(cnn.pack_image(img, slots, lo)))))
    if not math.log2(max(conj_err, 1e-300)) <= (
            -math.log2(params.scale) + params.logslots + 12):
        raise AssertionError(f"conjugation error {conj_err}")
    layers = {name: [round(ms[name], 3) for ms, _, _, _ in runs]
              for name in ("conv", "fc1", "fc2")}
    print(f"[6 cnn] PN14QP433_CNN logN {params.logn} L {params.max_level + 1}"
          f" + {params.rlwe.pcount} P, alpha {params.rlwe.alpha}, scale "
          f"2^{math.log2(params.scale):g}, {slots} slots, 2 parties, layout "
          f"{lo.image}x{lo.image} / {lo.num_kernels} kernels / "
          f"{lo.num_kernels * lo.conv_out ** 2}->{lo.fc_units}->{lo.classes}"
          f"; keygen {s.keygen_s:.2f} s ({len(s.rtk.value['dataOwner'])} "
          f"rotation keys per party), model encryption and key stacks "
          f"{s.model_s:.2f} s; ms per inference "
          f"{[round(ms['total'], 3) for ms, _, _, _ in runs]} (first, then "
          f"warm), per layer {layers}; key-switched rotations counted in the "
          f"three requests {rot['rotations']}; max logit err "
          f"{max(e for _, e, _, _ in runs):.3g} (rtol = atol = 5e-3), argmax "
          f"equal; batched hoisted rotation over {len(idxs)} indices "
          f"bit-identical to single ones; conjugation err {conj_err:.3g}; "
          f"launches { {k: launches[k] for k in ('ntt_fwd', 'ntt_inv')} }; "
          f"peak mem {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    return launches


def _timed(fn):
    """(fn(), its ms from CUDA events on the current stream)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _same_ct(got, want, what: str) -> None:
    """ids, scale (CKKS) and data bit for bit, else AssertionError."""
    g = getattr(got, "ct", got)
    w = getattr(want, "ct", want)
    if not (g.ids == w.ids and getattr(got, "scale", None)
            == getattr(want, "scale", None) and torch.equal(g.data, w.data)):
        raise AssertionError(f"{what}: the replay differs from eager")


def phase_fused(params, params_bfv, params_cnn) -> dict:
    """The runtime tier (fuse.py, build_fused_inference, the batched
    mults) at full width: every replay on inputs that are not the
    capture's, bit for bit against eager or staged, and the CKKS and CNN
    gates. Returns the NTT launches captured into the graphs."""
    users = [f"user{i}" for i in range(4)]
    phase_t0 = time.perf_counter()
    torch.cuda.synchronize()
    ntt_cuda.reset_counters()
    replays = 0
    captured = {}

    def note(fn):
        for k, v in fn.launches.items():
            captured[k] = captured.get(k, 0) + v

    # -- CKKS PN15QP880, 4 parties: fuse, fuse_chained, the batch --------
    kgen = mkrlwe.KeyGenerator(params.rlwe, seed=SEED + 41)
    sks, rlk, pks = mkrlwe.SecretKeySet(), mkrlwe.RelinearizationKeySet(), {}
    for uid in users:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        sks.add(sk)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
    enc = mkckks.Encryptor(params, seed=SEED + 42)
    dec, ev = mkckks.Decryptor(params), mkckks.Evaluator(params)
    rng = np.random.default_rng(SEED + 43)
    bound = -math.log2(params.scale) + params.logslots + 12

    def operands():
        """phase 4's request: the running sum and difference of four
        fresh encryptions, and the product they decrypt to."""
        msgs = [rng.uniform(0.025, 0.25, params.slots)
                + 1j * rng.uniform(0.025, 0.25, params.slots)
                for _ in users]
        cts = [enc.encrypt_msg(mkckks.Message(value=m), pks[u])
               for m, u in zip(msgs, users)]
        ct0 = ct1 = cts[0]
        for c in cts[1:]:
            ct0, ct1 = ev.add_new(ct0, c), ev.sub_new(ct1, c)
        return ct0, ct1, sum(msgs) * (msgs[0] - sum(msgs[1:]))

    def mult(ev, keys, a, b):
        return ev.mul_relin_new(a, b, keys.rlk)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn, args = fuse.fuse(params, mult, operands()[:2], rlk_set=rlk)
    torch.cuda.synchronize()
    mult_setup_s, mult_capture_s = time.perf_counter() - t0, fn.capture_s
    note(fn)
    eager_ms, replay_ms, errs = [], [], []
    for _ in range(3):
        a, b, want_msg = operands()
        want, ms = _timed(lambda: ev.mul_relin_new(a, b, rlk))
        eager_ms.append(ms)
        got, ms = _timed(lambda: fn(args[0], args[1], (a, b)))
        replay_ms.append(ms)
        replays += 1
        _same_ct(got, want, "fused CKKS mult")
        err = float(np.max(np.abs(dec.decrypt(got, sks).value - want_msg)))
        errs.append(math.log2(max(err, 1e-300)))
        if not errs[-1] <= bound:
            raise AssertionError(f"fused CKKS mult: log2 err {errs[-1]:.2f}"
                                 f" (bound {bound:.2f})")
    mult_mem = torch.cuda.max_memory_allocated() / 2 ** 30
    del fn, args

    def chain(cts, out):
        """bench.py's sum feedback (benchmarks/_timing.py): the whole
        output's sum mod 2^32 XORed into the first input."""
        a = cts[0]
        w = out.ct.data.sum() & 0xFFFFFFFF
        return (mkckks.Ciphertext(ct=mkrlwe.Ciphertext(
            ids=a.ids, data=a.ct.data ^ w), scale=a.scale), cts[1])

    run_k, kargs = fuse.fuse_chained(params, mult, operands()[:2], chain,
                                     rlk_set=rlk)
    note(run_k.fused)
    cts = operands()[:2]
    t_k = {1: [], 4: []}
    for k in (1, 4, 4, 1, 1, 4):
        got, ms = _timed(lambda: run_k(kargs[0], kargs[1], cts, k))
        replays += k + 1
        t_k[k].append(ms)
        c = cts
        for _ in range(k):
            c = chain(c, ev.mul_relin_new(*c, rlk))
        _same_ct(got, ev.mul_relin_new(*c, rlk), f"fuse_chained k={k}")
    slope = (statistics.median(t_k[4]) - statistics.median(t_k[1])) / 3
    del run_k, kargs

    batch_ms = {1: [], 2: [], 4: []}
    for bsz in (1, 2, 4, 4, 2, 1):
        ops = [operands() for _ in range(bsz)]
        outs, ms = _timed(lambda: ev.mul_relin_batched_new(
            [o[0] for o in ops], [o[1] for o in ops], rlk))
        batch_ms[bsz].append(ms / bsz)
        for got, (a, b, _) in zip(outs, ops):
            _same_ct(got, ev.mul_relin_new(a, b, rlk),
                     f"batched CKKS mult at B = {bsz}")
        del outs, ops
    del kgen, sks, rlk, pks, enc, dec, ev

    # -- BFV PN15QP880, split on: fuse of mult + add, the batch at B = 2 --
    config.ntt_mxu_tail = True
    try:
        kgen = mkbfv.KeyGenerator(params_bfv, seed=SEED + 51)
        brlk, bpks = mkbfv.RelinearizationKeySet(), {}
        for uid in users:
            sk, bpks[uid] = kgen.gen_key_pair(uid)
            brlk.add(kgen.gen_relinearization_key_bfv(
                sk, kgen.gen_secret_key(uid)))
        benc = mkbfv.Encryptor(params_bfv, seed=SEED + 52)
        bev = mkbfv.Evaluator(params_bfv)
        t = params_bfv.t

        def bfv_operands():
            cts = [benc.encrypt_msg(rng.integers(0, t, params_bfv.n),
                                    bpks[u]) for u in users]
            return (bev.add_new(cts[0], cts[1]),
                    bev.add_new(cts[2], cts[3]))

        def mult_add(ev, keys, a, b):
            return ev.add_new(ev.mul_relin_new(a, b, keys.rlk), a)

        keys = types.SimpleNamespace(rlk=brlk)
        fn, args = fuse.fuse(params_bfv, mult_add, bfv_operands(),
                             rlk_set=brlk)
        note(fn)
        bfv_ms = []
        for _ in range(2):
            a, b = bfv_operands()
            want, e_ms = _timed(lambda: mult_add(bev, keys, a, b))
            got, r_ms = _timed(lambda: fn(args[0], args[1], (a, b)))
            replays += 1
            bfv_ms.append((e_ms, r_ms))
            _same_ct(got, want, "fused BFV mult + add")
        del fn, args
        pairs = [bfv_operands() for _ in range(2)]
        for got, (a, b) in zip(bev.mul_relin_batched_new(
                [p[0] for p in pairs], [p[1] for p in pairs], brlk), pairs):
            _same_ct(got, bev.mul_relin_new(a, b, brlk),
                     "batched BFV mult at B = 2")
        del kgen, brlk, bpks, benc, bev, pairs
    finally:
        config.ntt_mxu_tail = False

    # -- CNN PN14QP433_CNN, REF layout: build_fused_inference -------------
    s = profile_cnn.setup(params_cnn, cnn.REF, seed=SEED + 61)
    lo = s.layout
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn, args = cnn.build_fused_inference(
        s.params, s.rlk, s.rtk, s.encrypt_image(profile_cnn.image(lo, 0)),
        *s.model, s.pt_mask, layout=lo)
    torch.cuda.synchronize()
    cnn_setup_s, cnn_capture_s = time.perf_counter() - t0, fn.capture_s
    note(fn)
    cnn_launches = sum(fn.launches.values())
    staged_ms, fused_ms, logit_err = [], [], 0.0
    for k in range(3):
        img = profile_cnn.image(lo, SEED + 70 + k)
        ct_img = s.encrypt_image(img)
        want, ms = _timed(lambda: profile_cnn.infer(s, ct_img))
        staged_ms.append(ms)
        got, ms = _timed(lambda: fn(args[0], args[1],
                                    (ct_img,) + args[2][1:]))
        fused_ms.append(ms)
        replays += 1
        _same_ct(got, want, f"fused CNN inference {k}")
        logits = s.logits(got)
        plain = cnn.plain_forward(img, *s.weights, lo)
        if not (got.ids == profile_cnn.USERS and logits.shape == plain.shape
                and np.all(np.isfinite(logits))
                and np.allclose(logits, plain, rtol=5e-3, atol=5e-3)
                and int(np.argmax(logits)) == int(np.argmax(plain))):
            raise AssertionError(f"fused CNN inference {k}: logits {logits} "
                                 f"against {plain}")
        logit_err = max(logit_err, float(np.max(np.abs(logits - plain))))
    cnn_mem = torch.cuda.max_memory_allocated() / 2 ** 30
    del fn, args, s

    if sum(captured.values()) < 1:
        raise AssertionError("no NTT launch was captured into a graph")
    r = lambda xs: [round(x, 3) for x in xs]
    print(f"[7 fused] CKKS PN15QP880 4 parties, fuse of mul_relin_new: setup "
          f"(recording pass + capture) {mult_setup_s:.3f} s, capture "
          f"{mult_capture_s:.3f} s; three fresh requests, each equal to eager"
          f" bit for bit, log2 err {max(errs):.2f} (bound {bound:.2f}); ms in "
          f"turns eager {r(eager_ms)} replay {r(replay_ms)}; peak mem "
          f"{mult_mem:.2f} GiB; fuse_chained equal to the eager chain at k = "
          f"1 and 4, ms k=1 {r(t_k[1])} k=4 {r(t_k[4])}, slope (t(4) - t(1))"
          f" / 3 = {slope:.3f} ms; batched mul_relin_batched_new, each "
          f"output equal to mul_relin_new, ms per mult "
          + ", ".join(f"B={b} {r(v)}" for b, v in batch_ms.items())
          + f"; BFV PN15QP880 split on: fuse of mult + add equal to staged, "
          f"ms eager / replay {[(round(e, 3), round(f, 3))
                                for e, f in bfv_ms]}"
          f", batched B=2 equal to per pair; CNN PN14QP433_CNN REF: "
          f"build_fused_inference {cnn_setup_s:.3f} s (capture "
          f"{cnn_capture_s:.3f} s, {cnn_launches} NTT launches captured), "
          f"three fresh images, each equal to staged bit for bit, max logit "
          f"err {logit_err:.3g} (rtol = atol = 5e-3), argmax equal; ms per "
          f"inference in turns staged {r(staged_ms)} replay {r(fused_ms)}; "
          f"peak mem {cnn_mem:.2f} GiB; NTT launches captured "
          f"{ {k: v for k, v in captured.items() if v} }, graph replays "
          f"{replays} (the counters see captures, not replays); phase "
          f"{time.perf_counter() - phase_t0:.1f} s", flush=True)
    return captured


def phase_api(params, params_bfv, params_cnn) -> dict:
    """The port's public surface at PN15QP880 from its own default
    parameters (no CRS added, none carried in): the default CRS set, CKKS
    and BFV rotation and conjugation, the u64 oracle gate, serialization
    and both examples. Returns the phase's NTT launches."""
    phase_t0 = time.perf_counter()
    users = [f"user{i}" for i in range(4)]
    # -- the default CRS: the JAX package's rule, written out here --------
    crs_gb = {}
    for name, rp in (("CKKS", params.rlwe), ("BFV", params_bfv.rlwe),
                     ("CNN", params_cnn.rlwe)):
        rule = {0, -1, -2, -3, -4} | {1 << i for i in range(rp.logn - 1)}
        if set(rp.crs) != rule:
            raise AssertionError(f"{name} CRS indices {sorted(rp.crs)} are "
                                 f"not the default set {sorted(rule)}")
        crs_gb[name] = sum(a.numel() * a.element_size()
                           for a in rp.crs.values()) / 1e9
    torch.cuda.synchronize()
    held_gib = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    ntt_cuda.reset_counters()

    # -- CKKS, 4 parties: rotation, conjugation, serialization ------------
    kgen = mkrlwe.KeyGenerator(params.rlwe, seed=SEED + 81)
    sks, rlk, pks = mkrlwe.SecretKeySet(), mkrlwe.RelinearizationKeySet(), {}
    rtk, cjk = mkrlwe.RotationKeySet(), mkrlwe.ConjugationKeySet()
    for uid in users:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        sks.add(sk)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
        kgen.gen_default_rotation_keys(sk, rtk)
        cjk.add(kgen.gen_conjugation_key(sk))
    enc = mkckks.Encryptor(params, seed=SEED + 82)
    dec, ev = mkckks.Decryptor(params), mkckks.Evaluator(params)
    rng = np.random.default_rng(SEED + 83)
    bound = -math.log2(params.scale) + params.logslots + 12
    msgs = [rng.uniform(-0.25, 0.25, params.slots)
            + 1j * rng.uniform(-0.25, 0.25, params.slots) for _ in users]
    cts = [enc.encrypt_msg(mkckks.Message(value=m), pks[u])
           for m, u in zip(msgs, users)]
    ct = cts[0]
    for c in cts[1:]:
        ct = ev.add_new(ct, c)
    msg = sum(msgs)

    def check(out, want, what):
        got = dec.decrypt(out, sks).value
        err = math.log2(max(float(np.max(np.abs(got - want))), 1e-300))
        if not (out.ids == tuple(users) and np.all(np.isfinite(got))
                and err <= bound):
            raise AssertionError(f"CKKS {what}: ids {out.ids}, log2 err "
                                 f"{err:.2f} (bound {bound:.2f})")
        return round(err, 2)

    ckks_err = {f"rot {r}": check(ev.rotate_new(ct, r, rtk),
                                  np.roll(msg, -r), f"rotation by {r}")
                for r in (1, 5, -1)}
    ckks_err["conj"] = check(ev.conjugate_new(ct, cjk), np.conj(msg),
                             "conjugation")
    ckks_ms = (cuda_ms(lambda: ev.rotate_new(ct, 1, rtk), 3, 1),
               cuda_ms(lambda: ev.conjugate_new(ct, cjk), 3, 1))

    a = ev.add_new(cts[0], cts[1])
    b = ev.add_new(cts[2], cts[3])
    prod = ev.mul_relin_new(a, b, rlk)
    check(prod, (msgs[0] + msgs[1]) * (msgs[2] + msgs[3]), "mult")
    t0 = time.perf_counter()
    loaded = mkrlwe.RelinearizationKeySet()
    with tempfile.TemporaryDirectory(prefix="mkhe_smoke_") as td:
        path = os.path.join(td, "f.npz")
        for uid in users:
            serialize.save_relin_key(path, rlk.get(uid))
            key = serialize.load_relin_key(path)
            if not all(torch.equal(getattr(key, f), getattr(rlk.get(uid), f))
                       for f in "bdv") or key.id != uid:
                raise AssertionError(f"relin key of {uid} changed on disk")
            loaded.add(key)
        serialize.save_secret_key(path, sks.get("user0"))
        sk = serialize.load_secret_key(path)
        top = params.n // 4     # the largest default rotation
        serialize.save_rotation_key(path, rtk.get("user3", top))
        rk = serialize.load_rotation_key(path)
        serialize.save_ciphertext(path, prod.ct, scale=prod.scale)
        pct, pscale = serialize.load_ciphertext(path)
    if not (torch.equal(sk.data, sks.get("user0").data)
            and rk.rot_idx == top and rk.id == "user3"
            and torch.equal(rk.data, rtk.get("user3", top).data)
            and pct.ids == prod.ids and pscale == prod.scale
            and torch.equal(pct.data, prod.ct.data)):
        raise AssertionError("a key or the ciphertext changed on disk")
    ser_s = time.perf_counter() - t0
    if not torch.equal(ev.mul_relin_new(a, b, loaded).ct.data, prod.ct.data):
        raise AssertionError("the mult with the loaded relin keys differs")
    del kgen, sks, rlk, pks, rtk, cjk, loaded, enc, dec, ev, cts, ct, a, b

    # -- BFV, 4 parties: rotation and conjugation, exact ------------------
    kgen = mkbfv.KeyGenerator(params_bfv, seed=SEED + 91)
    sks, pks = mkrlwe.SecretKeySet(), {}
    rtk, cjk = mkrlwe.RotationKeySet(), mkrlwe.ConjugationKeySet()
    for uid in users:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        sks.add(sk)
        for r in (1, 2):
            rtk.add(kgen.gen_rotation_key(r, sk))
        cjk.add(kgen.gen_conjugation_key(sk))
    benc = mkbfv.Encryptor(params_bfv, seed=SEED + 92)
    bdec, bev = mkbfv.Decryptor(params_bfv), mkbfv.Evaluator(params_bfv)
    t, nh = params_bfv.t, params_bfv.n // 2
    vals = [rng.integers(0, t, params_bfv.n) for _ in users]
    ct = benc.encrypt_msg(vals[0], pks[users[0]])
    for v, u in zip(vals[1:], users[1:]):
        ct = bev.add_new(ct, benc.encrypt_msg(v, pks[u]))
    m = np.mod(sum(vals), t)
    m = np.where(m > t // 2, m - t, m)

    def exact(out, want, what):
        got = bdec.decrypt(out, sks)
        if not (out.ids == tuple(users) and np.array_equal(got, want)):
            raise AssertionError(f"BFV {what}: {int((got != want).sum())} "
                                 "slots differ")

    for r in (1, 3):
        last = bev.rotate_new(ct, r, rtk)
        exact(last, np.concatenate([np.roll(m[:nh], -r),
                                    np.roll(m[nh:], -r)]),
              f"rotation by {r}")
    exact(bev.conjugate_new(ct, cjk), np.concatenate([m[nh:], m[:nh]]),
          "conjugation")
    try:
        for on in (False, True):
            config.ntt_mxu_tail = on
            if not torch.equal(bev.rotate_new(ct, 3, rtk).data, last.data):
                raise AssertionError(f"the BFV rotation by 3 with the split "
                                     f"{'on' if on else 'off'} differs")
    finally:
        config.ntt_mxu_tail = False
    bfv_ms = (cuda_ms(lambda: bev.rotate_new(ct, 1, rtk), 3, 1),
              cuda_ms(lambda: bev.conjugate_new(ct, cjk), 3, 1))
    del kgen, sks, pks, rtk, cjk, benc, bdec, bev, ct, last

    # -- the u64 oracle gate (bench.py::oracle_cross_check) ---------------
    t0 = time.perf_counter()
    err64, err32, _ = oracle.cross_validate("pn15", params, seed=17)
    oracle_s = time.perf_counter() - t0
    if not (err64 <= bound and err32 <= bound and abs(err64 - err32) <= 6):
        raise AssertionError(f"u64 oracle gate: err64 {err64:.2f}, err32 "
                             f"{err32:.2f}, bound {bound:.2f}")

    # -- the examples, on the card ----------------------------------------
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ex_err = two_party_ckks.main()
        two_party_bfv.main()
    ex_lines = [ln for ln in out.getvalue().splitlines()
                if "verified" in ln or "EXACT" in ln]
    if len(ex_lines) != 2:
        raise AssertionError(f"the examples printed {out.getvalue()!r}")

    launches = ntt_cuda.counters()
    if min(launches["ntt_fwd"], launches["ntt_inv"]) < 1:
        raise AssertionError(f"phase 8 launched no NTT kernel: {launches}")
    r3 = lambda xs: [round(x, 3) for x in xs]
    print(f"[8 api] default CRS sets = the JAX rule (0, -1..-4, 2^i for i < "
          f"logN - 1), GB on the card: "
          + ", ".join(f"{k} {v:.3f}" for k, v in crs_gb.items())
          + f"; held before the phase {held_gib:.2f} GiB; CKKS PN15QP880 4 "
          f"parties, default rotation keys and conjugation keys: log2 err "
          f"{ckks_err} (bound {bound:.2f}); ms rotate_new(1) / "
          f"conjugate_new {r3(ckks_ms)}; serialize: 4 relin keys, a secret "
          f"key, a rotation key and the product ciphertext equal bit for bit"
          f" after save + load, the mult with the loaded keys equal, "
          f"{ser_s:.1f} s; BFV PN15QP880 4 parties: rotate_new 1 and 3 and "
          f"conjugate_new exact, rotation by 3 equal with the split off and "
          f"on, ms rotate_new(1) / conjugate_new {r3(bfv_ms)}; u64 oracle "
          f"pn15 seed 17: err64 {err64:.2f} err32 {err32:.2f} (bound "
          f"{bound:.2f}, |diff| {abs(err64 - err32):.2f} <= 6), "
          f"{oracle_s:.1f} s; examples on the card: ckks err {ex_err:.2e}, "
          f"{' | '.join(ex_lines)}; peak mem "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; phase "
          f"{time.perf_counter() - phase_t0:.1f} s", flush=True)
    print(f"[8 api launches] "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return launches


def _host_ms(fn, reps: int = 3) -> float:
    """Median host ms of reps calls of fn()."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _python_decode_scale(poly: np.ndarray, moduli, t: int) -> np.ndarray:
    """round(t * c / Q) mod t with python ints (utils.crt): the BFV decode
    before the native CRT, for its time beside the native one."""
    Q = math.prod(int(q) for q in moduli)
    return np.array([(t * int(v) + Q // 2) // Q % t
                     for v in crt.crt_reconstruct(poly, moduli)], np.int64)


def phase_parallel(params, params_bfv) -> None:
    """The parallel tier: ranks spawned with torch.multiprocessing on the
    one card, over gloo (parallel/_ranks.py), each run bit for bit against
    the single-device result on the card; the chunk-local NTT kernels
    against their plain versions, timed beside their bounds; the native
    CRT decode against the python one."""
    phase_t0 = time.perf_counter()
    rp = params.rlwe
    ring = rp.ring_qp
    users = [f"user{i}" for i in range(4)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 90)

    # -- the chunk-local kernels: rank 0's tables at C = 2 and 4 ----------
    local = {}
    for C in (2, 4):
        t = dist_ntt._rank_tables(ring.moduli, ring.logn, C, 0,
                                  ring.q.device)
        x = _rand(gen, (BATCH, ring.nlimbs, ring.n // C), ring.q[:, None])
        fwd = (ring.q, ring.bar, t["fwd_loc"], t["fwd_loc_sh"])
        inv = (ring.q, ring.bar, t["inv_loc"], t["inv_loc_sh"], t["one"],
               t["one_sh"])
        for name, kern, plain, args, pack, reads in (
                ("ntt_fwd", ntt_cuda.ntt, ntt_cuda.ntt_plain, fwd,
                 t["fwd_pack"], (ring.q, ring.bar, t["fwd_pack"])),
                ("ntt_inv", ntt_cuda.intt, ntt_cuda.intt_plain, inv,
                 t["inv_pack"], (ring.q, ring.bar, t["one"], t["one_sh"],
                                 t["inv_pack"]))):
            got = kern(x, *args, pack)
            want = plain(x, *args)
            if not torch.equal(got, want):
                raise AssertionError(f"chunk-local {name} at C = {C} "
                                     f"differs from its plain version")
            local[f"{name} C={C}"] = dict(
                ms=cuda_ms(lambda: kern(x, *args, pack), 5, 1),
                ms_mean10=cuda_ms(lambda: kern(x, *args, pack), 5),
                plain_ms=cuda_ms(lambda: plain(x, *args), 3, 1),
                bound_ms=profile_ntt.kernel_bound(name, x, reads)[0])

    # -- the requests and their single-device results on the card ---------
    kgen = mkrlwe.KeyGenerator(rp, seed=SEED + 91)
    sks, rlk, rtk, pks = (mkrlwe.SecretKeySet(),
                          mkrlwe.RelinearizationKeySet(),
                          mkrlwe.RotationKeySet(), {})
    for uid in users:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        sks.add(sk)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
        rtk.add(kgen.gen_rotation_key(1, sk))
    enc = mkckks.Encryptor(params, seed=SEED + 92)
    rng = np.random.default_rng(SEED + 93)
    msgs = [rng.uniform(0.025, 0.25, params.slots)
            + 1j * rng.uniform(0.025, 0.25, params.slots) for _ in users]
    cts = [enc.encrypt_msg(mkckks.Message(value=m), pks[u])
           for m, u in zip(msgs, users)]
    ev = mkckks.Evaluator(params)
    ct0 = ct1 = cts[0]
    for c in cts[1:]:
        ct0, ct1 = ev.add_new(ct0, c), ev.sub_new(ct1, c)
    ids, level = ct0.ids, ct0.level
    stacked = rlk.stacked(ids)
    rtk1 = rtk.stacked(ids, 1)
    x = _rand(gen, (BATCH, ring.nlimbs, ring.n), ring.q[:, None])
    want = {"ntt": ring.ntt(x).cpu(), "intt": ring.intt(ring.ntt(x)).cpu(),
            "mul": ksw.mul_and_relin(rp, ct0.ct, ct1.ct, stacked,
                                     level).data.cpu(),
            "rot": ev.rotate_new(ct0, 1, rtk).ct.data.cpu()}
    host = lambda a: a.cpu()
    state = dict(logn=rp.logn, q=rp.q_moduli, p=rp.p_moduli, gamma=rp.gamma,
                 sigma=rp.sigma, crs={i: host(rp.crs[i]) for i in (-1, 1)})
    cts_host = [(c.ids, host(c.ct.data)) for c in (ct0, ct1)]
    keys_host = tuple(host(a) for a in stacked)
    ntt_in = dict(moduli=ring.moduli, logn=ring.logn, limb_axis=False)
    tasks = [  # (what, task); C = 2 runs on a 2 x 2 mesh, each row alone
        ("ntt C=2", ("ntt", dict(ntt_in, x=host(x), rns=2, coeff=2,
                                 inverse=False))),
        ("intt C=2", ("ntt", dict(ntt_in, x=want["ntt"], rns=2, coeff=2,
                                  inverse=True))),
        ("ntt C=4", ("ntt", dict(ntt_in, x=host(x), rns=1, coeff=4,
                                 inverse=False))),
        ("intt C=4", ("ntt", dict(ntt_in, x=want["ntt"], rns=1, coeff=4,
                                  inverse=True))),
        ("coeff mul C=2", ("coeff_mul", dict(
            params=state, ct0=cts_host[0], ct1=cts_host[1], rlk=keys_host,
            level=level, rns=2, coeff=2))),
    ] + [(f"party mul /{k}", ("party_mul", dict(
        params=state, ct0=cts_host[0], ct1=cts_host[1], rlk=keys_host,
        h0=None, h1=None, parties=k))) for k in (4, 2)] \
      + [(f"party rotate(1) /{k}", ("party_rot", dict(
          params=state, ct=cts_host[0], rot=1, rtk=host(rtk1), h=None,
          parties=k))) for k in (4, 2)]
    del stacked, rtk1, rlk, rtk
    torch.cuda.empty_cache()
    ranks_t0 = time.perf_counter()
    outs = _ranks.run([t for _, t in tasks], 4, backend="gloo",
                      device="cuda", timeout=600)
    ranks_s = time.perf_counter() - ranks_t0

    # -- every run against the single-device result -----------------------
    def whole(i, coeff):
        """The rows of task i's blocks, each concatenated along N."""
        res = [o["results"][i] for o in outs]
        res = [r[1] if isinstance(r, tuple) else r for r in res]
        return [torch.cat(res[r:r + coeff], -1) for r in range(0, 4, coeff)]

    for i, (what, (kind, task)) in enumerate(tasks):
        if kind in ("ntt", "coeff_mul"):
            key = ("intt" if task.get("inverse") else "ntt") \
                if kind == "ntt" else "mul"
            got = whole(i, task["coeff"])
        else:
            key = "mul" if kind == "party_mul" else "rot"
            got = [o["results"][i][1] for o in outs]
        if not all(torch.equal(g, want[key]) for g in got):
            raise AssertionError(f"phase 9 {what}: not bit-identical to the "
                                 f"single-device result")
        wants = {"ntt": ("ntt_inv" if task.get("inverse") else "ntt_fwd",),
                 "coeff_mul": ("ntt_fwd", "ntt_inv"),
                 "party_mul": ("ntt_fwd", "ntt_inv"),
                 "party_rot": ("ntt_inv",)}[kind]
        for o in outs:
            if min(o["launches"][i][k] for k in wants) < 1:
                raise AssertionError(f"phase 9 {what}: a rank launched no "
                                     f"{wants}: {o['launches'][i]}")
    if any(o["foreign_modules"] for o in outs):
        raise AssertionError("a rank loaded JAX or the JAX package")

    # the sharded product decrypts (scale^2, the native CRT at 28 limbs)
    prod = mkckks.Ciphertext(
        ct=mkrlwe.Ciphertext(ids=ids, data=whole(4, 2)[0].cuda()),
        scale=ct0.scale * ct1.scale)
    pt = mkrlwe.Decryptor(rp).decrypt(prod.ct, sks).cpu().numpy().astype(
        np.uint32)
    moduli = rp.q_moduli[:level + 1]
    got = mkckks.encoder.decode(pt, prod.scale, moduli, params.logn,
                                logslots=params.logslots)
    want_m = sum(msgs) * (msgs[0] - sum(msgs[1:]))
    bound = -math.log2(params.scale) + params.logslots + 12
    err = math.log2(max(float(np.max(np.abs(got - want_m))), 1e-300))
    if not (np.all(np.isfinite(got)) and err <= bound):
        raise AssertionError(f"the coefficient-sharded product: log2 err "
                             f"{err:.2f} (bound {bound:.2f})")
    # within 1e-15 (tests/test_native_crt.py): the native CRT rounds
    # through long double, python's float() of an int rounds once
    python_centered = np.array([float(v) for v in crt.crt_center(pt, moduli)])
    if not np.allclose(native.crt_center_double(pt, moduli),
                       python_centered, rtol=1e-15, atol=0):
        raise AssertionError("native and python CRT differ at PN15")

    # -- the decode's host time, native against python ---------------------
    tb = params_bfv.t
    bmod = params_bfv.rlwe.q_moduli
    bq = np.array(bmod, np.uint64)
    bpoly = (np.random.default_rng(SEED + 94).integers(
        0, 1 << 63, (len(bmod), params_bfv.n), np.uint64)
        % bq[:, None]).astype(np.uint32)
    if not np.array_equal(native.bfv_decode_scale(bpoly, bmod, tb),
                          _python_decode_scale(bpoly, bmod, tb)):
        raise AssertionError("native and python BFV decode differ at PN15")
    decode_ms = {  # median of 3, after the calls above
        "CKKS CRT python": _host_ms(lambda: [
            float(v) for v in crt.crt_center(pt, moduli)]),
        "CKKS CRT native": _host_ms(
            lambda: native.crt_center_double(pt, moduli)),
        "CKKS decode": _host_ms(lambda: mkckks.encoder.decode(
            pt, prod.scale, moduli, params.logn, logslots=params.logslots)),
        "BFV scale python": _host_ms(
            lambda: _python_decode_scale(bpoly, bmod, tb)),
        "BFV scale native": _host_ms(
            lambda: native.bfv_decode_scale(bpoly, bmod, tb)),
        "BFV decode": _host_ms(
            lambda: mkbfv.encoder.decode(params_bfv, bpoly))}

    r4 = lambda v: round(v, 4)
    secs = [round(sum(o["seconds"]), 1) for o in outs]
    print(f"[9 parallel] 4 ranks on one card, transport "
          f"{outs[0]['transport']} (the exchanges share one card: not "
          f"timed); bit-identical to the single-device results on the card:"
          f" {', '.join(w for w, _ in tasks)} (8 x 32 x 2^15 NTTs; "
          f"PN15QP880 4 parties); the C = 2 product decrypts, log2 err "
          f"{err:.2f} (bound {bound:.2f}); rank peak GiB "
          f"{[round(o['peak_gib'], 2) for o in outs]}; rank task s "
          f"{secs}; launches rank 0 "
          f"{[{k: v for k, v in l.items() if v} for l in outs[0]['launches']]}"
          f"; chunk-local kernels, 8 x 32 x 2^15/C, rank 0's tables (ms "
          f"single, mean of 10, plain, bound) "
          f"{ {k: [r4(v[f]) for f in ('ms', 'ms_mean10', 'plain_ms', 'bound_ms')] for k, v in local.items()} }"
          f"; decode host ms at {len(moduli)} limbs "
          f"{ {k: round(v, 1) for k, v in decode_ms.items()} }; ranks "
          f"{ranks_s:.1f} s, phase {time.perf_counter() - phase_t0:.1f} s",
          flush=True)


def phase_seeds() -> None:
    """Each parameter set afresh, its CRS, and at CKKS PN15QP880 one
    party's keys and one encryption, as digests against the JAX
    package's."""
    with open(DIGESTS) as f:
        want = json.load(f)
    got, secs = {}, {}
    for scheme, name in profile_params.SETS:
        label = f"{scheme}_{name}"
        params, secs[label] = profile_params.build(scheme, name)
        rp = params.rlwe
        for idx, a in rp.crs.items():
            got[f"{label}/crs/{idx}"] = convert.sha256_u32(a)
        if label == "ckks_PN15QP880":
            kgen = mkrlwe.KeyGenerator(rp, seed=1)
            sk, pk = kgen.gen_key_pair("user0")
            rlk = kgen.gen_relinearization_key(sk,
                                               kgen.gen_secret_key("user0"))
            got[f"{label}/sk"] = convert.sha256_u32(sk.data)
            got[f"{label}/pk"] = convert.sha256_u32(pk.data)
            for f in "bdv":
                got[f"{label}/rlk/{f}"] = convert.sha256_u32(getattr(rlk, f))
            pt = profile_params.fixed_plaintext(rp.q_moduli, rp.n, "cuda")
            ct = mkrlwe.Encryptor(rp, seed=2).encrypt(pt, pk)
            got[f"{label}/ct"] = convert.sha256_u32(ct.data)
            del kgen, sk, pk, rlk, pt, ct
        del params, rp
        torch.cuda.empty_cache()
    bad = sorted(k for k in set(want) | set(got) if got.get(k) != want.get(k))
    if bad:
        raise AssertionError(f"{len(bad)} of {len(want)} digests differ "
                             f"from the JAX package's: {bad[:8]}")
    print(f"[10 seeds] {len(got)} digests equal the JAX package's (CRS of "
          f"CKKS and BFV PN15QP880 and CKKS PN14QP433_CNN, CKKS PN15QP880 "
          f"KeyGenerator(seed=1) sk, pk, rlk b/d/v and Encryptor(seed=2) "
          f"ct); construction s (fresh, synchronized) "
          f"{ {k: round(v, 3) for k, v in secs.items()} }", flush=True)


def main() -> None:
    device = phase_device()
    phase_build()
    params = mkckks.PN15QP880("cuda")
    params_cnn = mkckks.PN14QP433_CNN("cuda")
    stats = phase_kernels(params.rlwe.ring_qp, params_cnn.rlwe.ring_qp)
    probe = phase_probe(params_cnn.rlwe.ring_qp)
    params_bfv = mkbfv.PN15QP880("cuda")
    phases = (phase_mult(params), phase_bfv(params_bfv),
              phase_cnn(params_cnn))
    for name, _, _ in MAIN:
        stats[name]["launches"] = sum(p[name] for p in phases)
    phase_fused(params, params_bfv, params_cnn)
    phase_api(params, params_bfv, params_cnn)
    phase_parallel(params, params_bfv)
    phase_seeds()
    stats["ntt_variant"] = probe
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, **stats[name], "library_ms": None}
        for name, source, replaces in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
