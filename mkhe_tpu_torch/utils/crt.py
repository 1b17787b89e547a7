"""Exact CRT at the plaintext boundary (port of mkhe_tpu/utils/crt.py).

The device holds u32 RNS limbs; only decoding and noise measurement
rebuild big integers, here with python ints in numpy object arrays.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def crt_reconstruct(limbs: np.ndarray, moduli: Sequence[int]) -> np.ndarray:
    """limbs (L, N) -> object ndarray (N,) of ints in [0, Q)."""
    Q = 1
    for q in moduli:
        Q *= int(q)
    acc = np.zeros(limbs.shape[-1], dtype=object)
    for i, qi in enumerate(moduli):
        qi = int(qi)
        qhat = Q // qi
        c = (qhat * pow(qhat % qi, -1, qi)) % Q
        acc = (acc + limbs[i].astype(object) * c) % Q
    return acc


def crt_center(limbs: np.ndarray, moduli: Sequence[int]) -> np.ndarray:
    """Reconstruct and center into (-Q/2, Q/2]. Object ndarray (N,)."""
    Q = 1
    for q in moduli:
        Q *= int(q)
    x = crt_reconstruct(limbs, moduli)
    return np.where(x > Q // 2, x - Q, x)


def to_rns(values, moduli: Sequence[int]) -> np.ndarray:
    """Signed python-int array (N,) -> uint32 (L, N)."""
    values = np.asarray(values, dtype=object)
    out = np.empty((len(moduli), len(values)), np.uint32)
    for i, qi in enumerate(moduli):
        out[i] = np.array([int(v) % int(qi) for v in values],
                          dtype=np.uint64).astype(np.uint32)
    return out


def log2_max_abs(centered: np.ndarray) -> float:
    """Bit length of the largest |coefficient| (the noise measure of the
    reference's log2OfInnerSum, mkrlwe_test.go:92-155)."""
    m = max((abs(int(v)) for v in centered), default=0)
    return float(int(m).bit_length()) if m else 0.0
