"""The u64 reference-oracle gate (port of mkhe_tpu/utils/oracle.py).

native/ref_oracle.cpp, a byte-identical copy of the JAX package's (a CPU
test holds the two equal), runs the KKLSS keygen, encryption,
MulAndRelin and exact decryption in the reference's 64-bit arithmetic at
its literal prime lists (mkckks/mkckks_test.go:51-72, or a logN 12 toy).
cross_validate feeds it and the port the same plaintext integers and
returns both decryption errors, so a caller can check that the port's
u32 limbs land within the reference noise bound and within a few bits of
the u64 run. Unlike the JAX harness, a failed build raises: the gate never
passes without the oracle.
"""

from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np

from ..native import gxx_build
from ..ops.ntt_cuda import BUILD_DIR
from . import crt

SRC = Path(__file__).resolve().parents[1] / "native" / "ref_oracle.cpp"
EXE = BUILD_DIR / "ref_oracle"


@functools.lru_cache(maxsize=1)
def oracle_binary() -> str:
    """Build SRC with g++ -O3 -std=c++17 into build/mkhe_tpu_torch/ when
    the binary is missing or was built from another source
    (native.gxx_build). Raises if g++ fails or is absent."""
    return gxx_build(SRC, EXE, [])


def run_oracle(config: str, seed: int, m0_coeffs: np.ndarray,
               m1_coeffs: np.ndarray) -> Tuple[Tuple[int, ...], np.ndarray]:
    """keygen -> encrypt(m0 under A), encrypt(m1 under B) -> MulAndRelin
    -> exact decryption, in u64. Returns (q_moduli, residues (Lq, N)
    uint64) of the decrypted plaintext."""
    exe = oracle_binary()
    with tempfile.TemporaryDirectory(prefix="mkhe_oracle_") as td:
        p0, p1, po = (os.path.join(td, f) for f in ("m0.i64", "m1.i64",
                                                     "out.bin"))
        np.asarray(m0_coeffs, np.int64).tofile(p0)
        np.asarray(m1_coeffs, np.int64).tofile(p1)
        r = subprocess.run([exe, config, str(seed), p0, p1, po],
                           check=True, capture_output=True, timeout=600)
        info = json.loads(r.stdout.decode().strip().splitlines()[-1])
        with open(po, "rb") as f:
            hdr = np.fromfile(f, np.int32, 4)
            logn, lq, lp = int(hdr[0]), int(hdr[1]), int(hdr[2])
            qmod = np.fromfile(f, np.uint64, lq)
            np.fromfile(f, np.uint64, lp)  # P moduli (unused here)
            res = np.fromfile(f, np.uint64, lq * (1 << logn))
    if info["lq"] != lq:
        raise RuntimeError(f"oracle output has {lq} limbs, its report "
                           f"{info['lq']}")
    return tuple(int(q) for q in qmod), res.reshape(lq, 1 << logn)


def center_coeffs_u64(residues: np.ndarray, moduli: Tuple[int, ...]
                      ) -> np.ndarray:
    """Centered plaintext coefficients (float64) from u64 RNS residues:
    a 2-limb CRT over python ints, exact while |value| < q0*q1/2, checked
    against the third limb, with the full CRT on a mismatch."""
    q0, q1 = int(moduli[0]), int(moduli[1])
    qq = q0 * q1
    inv = pow(q0, -1, q1)
    x0 = residues[0].astype(object)
    x1 = residues[1].astype(object)
    val = x0 + q0 * (((x1 - x0) * inv) % q1)
    val = np.where(val > qq // 2, val - qq, val)
    if residues.shape[0] > 2:
        q2 = int(moduli[2])
        if not np.array_equal(val % q2, residues[2].astype(object) % q2):
            centered = crt.crt_center(residues.astype(object), moduli)
            return np.array([float(v) for v in centered], np.float64)
    return val.astype(np.float64)


def decode_slots(coeffs: np.ndarray, scale: float, logn: int,
                 logslots: int) -> np.ndarray:
    """Centered float coefficients -> complex slots (the canonical
    embedding half of mkckks.encoder.decode)."""
    from ..mkckks.encoder import _tables

    n = 1 << logn
    _, t_pos, _, twist = _tables(logn)
    z = (np.fft.ifft((coeffs / scale) * twist) * n)[t_pos]
    if (1 << logslots) < n // 2:
        z = z[: 1 << logslots]
    return z


def cross_validate(config: str, params, seed: int = 7):
    """The u64 oracle and the port on the same plaintext integers (two
    parties, distinct operands). Returns (log2 max slot error of the
    oracle, that of the port, the wanted slots).

    params: a mkckks.Parameters whose logn / logslots / scale match the
    oracle's config ("toy": logN 12; "pn15": PN15QP880), on any device."""
    from .. import mkckks, mkrlwe
    from ..mkckks import encoder

    logn, logslots, scale = params.logn, params.logslots, params.scale
    rng = np.random.default_rng(seed)
    m0v = rng.uniform(0.1, 0.5, params.slots) \
        + 1j * rng.uniform(0.1, 0.5, params.slots)
    m1v = rng.uniform(0.1, 0.5, params.slots) \
        + 1j * rng.uniform(0.1, 0.5, params.slots)
    want = m0v * m1v

    m0c = np.round(encoder.encode_to_coeffs(m0v, scale, logn, logslots))
    m1c = np.round(encoder.encode_to_coeffs(m1v, scale, logn, logslots))
    qmod, res = run_oracle(config, seed, m0c.astype(np.int64),
                           m1c.astype(np.int64))
    got64 = decode_slots(center_coeffs_u64(res, qmod), scale * scale, logn,
                         logslots)
    err64 = math.log2(max(float(np.max(np.abs(got64 - want))), 1e-300))

    kgen = mkrlwe.KeyGenerator(params.rlwe, seed=seed + 100)
    sk_set = mkrlwe.SecretKeySet()
    rlk = mkrlwe.RelinearizationKeySet()
    pks = {}
    for uid in ("alice", "bob"):
        sk, pks[uid] = kgen.gen_key_pair(uid)
        sk_set.add(sk)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
    enc = mkckks.Encryptor(params, seed=seed + 200)
    ev = mkckks.Evaluator(params)
    ct0 = enc.encrypt_msg(mkckks.Message(value=m0v), pks["alice"])
    ct1 = enc.encrypt_msg(mkckks.Message(value=m1v), pks["bob"])
    out = mkckks.Decryptor(params).decrypt(ev.mul_relin_new(ct0, ct1, rlk),
                                           sk_set)
    err32 = math.log2(max(float(np.max(np.abs(out.value - want))), 1e-300))
    return err64, err32, want
