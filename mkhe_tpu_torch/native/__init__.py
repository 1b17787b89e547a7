"""The host's native tier: the exact-CRT decode in C++, and the g++ build
that it shares with the u64 oracle (port of mkhe_tpu/native/__init__.py).

crt_native.cpp, a byte-identical copy of the JAX package's (a CPU test
holds the two equal), reconstructs each coefficient from its u32 limbs in
fixed-width multiprecision: the CKKS decode's centred doubles
(crt_center_double), the BFV decode's round(t * c / Q) mod t
(bfv_decode_scale) and the noise measure (crt_max_bits). Python ints in
numpy object arrays (utils/crt.py, the plain version the tests compare
with) take seconds per decode at logN 15.

The library is built with g++ at first use into build/mkhe_tpu_torch/ at
the repository root, and again when the source's SHA-256 differs from the
one stored beside it. A failed build raises: there is no Python fallback
and no switch to ask for one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Sequence

import numpy as np

from ..ops.ntt_cuda import BUILD_DIR

SRC = Path(__file__).resolve().parent / "crt_native.cpp"
LIB = BUILD_DIR / "libcrt_native.so"
MAXW = 64  # must match crt_native.cpp


def gxx_build(src: Path, out: Path, flags: Sequence[str]) -> str:
    """Build src with `g++ -O3 -std=c++17 *flags` into out when out is
    missing or was built from another source (the source's SHA-256 is
    stored beside it: a checkout gives source and output the same mtimes).
    Returns out's path; raises if g++ fails or is absent."""
    src_hash = hashlib.sha256(src.read_bytes()).hexdigest()
    hash_path = out.with_name(out.name + ".sha256")
    have = hash_path.read_text().strip() if hash_path.exists() else ""
    if not out.exists() or have != src_hash:
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.build{os.getpid()}")
        res = subprocess.run(["g++", "-O3", "-std=c++17", *flags, "-o",
                              str(tmp), str(src)], capture_output=True,
                             text=True, timeout=300)
        if res.returncode:
            raise RuntimeError(f"g++ could not build {src.name}:\n"
                               f"{res.stderr}")
        os.replace(tmp, out)
        hash_path.write_text(src_hash)
    return str(out)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    # the JAX package's flags, so that both libraries compute the same
    # doubles (crt_center_double rounds through long double)
    lib = ctypes.CDLL(gxx_build(SRC, LIB, ["-shared", "-fPIC"]))
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f64p = ctypes.POINTER(ctypes.c_double)
    common = [u32p, ctypes.c_int32, ctypes.c_int64, u32p, u32p, u32p,
              ctypes.c_int32]
    lib.crt_center_double.argtypes = common + [f64p]
    lib.crt_center_double.restype = None
    lib.bfv_decode_scale.argtypes = common + [ctypes.c_uint32, u32p]
    lib.bfv_decode_scale.restype = None
    lib.crt_max_bits.argtypes = common
    lib.crt_max_bits.restype = ctypes.c_int32
    return lib


def _words(x: int, w: int) -> np.ndarray:
    out = np.empty(w, np.uint32)
    for k in range(w):
        out[k] = x & 0xFFFFFFFF
        x >>= 32
    if x:
        raise ValueError("word count too small")
    return out


@functools.lru_cache(maxsize=None)
def _tables(moduli: tuple) -> tuple:
    """(consts (L, W), Q words, Q/2 words, W) for a modulus chain:
    C_i = (Q/q_i) * ((Q/q_i)^-1 mod q_i) mod Q."""
    Q = 1
    for q in moduli:
        Q *= q
    w = max(1, -(-Q.bit_length() // 32))
    if w > MAXW - 2:
        raise ValueError(f"modulus chain too wide for the native CRT ({w} "
                         f"words)")
    consts = np.empty((len(moduli), w), np.uint32)
    for i, qi in enumerate(moduli):
        qhat = Q // qi
        consts[i] = _words((qhat * pow(qhat % qi, -1, qi)) % Q, w)
    return consts, _words(Q, w), _words(Q >> 1, w), w


def _u32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _args(limbs, moduli):
    """Checked (limbs as contiguous uint32 (L, N), the C arguments up to
    W); the returned array must stay alive during the call."""
    moduli = tuple(int(m) for m in moduli)
    limbs = np.ascontiguousarray(limbs, np.uint32)
    if limbs.ndim != 2 or limbs.shape[0] != len(moduli):
        raise ValueError(f"limbs {limbs.shape} for {len(moduli)} moduli")
    consts, q_w, half_w, w = _tables(moduli)
    L, N = limbs.shape
    return limbs, (_u32p(limbs), L, N, _u32p(consts), _u32p(q_w),
                   _u32p(half_w), w)


def crt_center_double(limbs: np.ndarray, moduli: Sequence[int]
                      ) -> np.ndarray:
    """uint32 (L, N) RNS -> float64 (N,) values centred in (-Q/2, Q/2]."""
    keep, args = _args(limbs, moduli)
    out = np.empty(keep.shape[1], np.float64)
    _lib().crt_center_double(
        *args, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def bfv_decode_scale(limbs: np.ndarray, moduli: Sequence[int], t: int
                     ) -> np.ndarray:
    """uint32 (L, N) RNS -> uint32 (N,) of round(t * c / Q) mod t, exact."""
    if not 1 < t < 1 << 32:
        raise ValueError(f"t = {t}: the native decode takes 1 < t < 2^32")
    keep, args = _args(limbs, moduli)
    out = np.empty(keep.shape[1], np.uint32)
    _lib().bfv_decode_scale(*args, int(t), _u32p(out))
    return out


def crt_max_bits(limbs: np.ndarray, moduli: Sequence[int]) -> int:
    """Bit length of the largest |centred coefficient| (the noise
    measure)."""
    keep, args = _args(limbs, moduli)
    return int(_lib().crt_max_bits(*args))
