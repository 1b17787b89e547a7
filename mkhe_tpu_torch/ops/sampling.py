"""Samplers for RLWE key material and encryption randomness.

Port of mkhe_tpu/ops/sampling.py: uniform mod q_i, ternary with P(0) =
1/2, a discrete gaussian (sigma = 3.2, truncated at 6 sigma) by inverse
CDT, a sparse ternary with a fixed Hamming weight, and RNS lifts of the
gaussian and the ternary. Each takes a threefry key (ops/threefry.py) and
draws the JAX package's bits under the same key, on the device it is
given, so both packages make the same samples from the same key.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import threefry
from .ring import Ring


def uniform(key, ring: Ring, *batch) -> torch.Tensor:
    """Uniform in [0, q_i) per limb, shape (*batch, L, N): two u32 draws
    hi, lo per coefficient, v = (hi * 2^32 + lo) mod q_i (bias < 2^-35
    for 29-bit q), the value the JAX package's Barrett and Shoup steps
    give."""
    shape = (*batch, ring.nlimbs, ring.n)
    hi, lo = threefry.bits(key, (2, *shape), ring.device)
    q = ring.q[:, None]
    v = hi % q
    return v.mul_((1 << 32) % q).add_(lo % q).remainder_(q)


def lift_signed(vals, ring: Ring) -> torch.Tensor:
    """Small signed ints (..., N) -> RNS (..., L, N): v >= 0 -> v,
    v < 0 -> q_i + v (lattigo's ExtendBasisSmallNormAndCenter)."""
    v = vals.to(torch.int64)[..., None, :]
    return torch.where(v < 0, ring.q[:, None] + v, v)


def ternary(key, n: int, device) -> torch.Tensor:
    """{-1, 0, +1} with P(0) = 1/2, P(+1) = P(-1) = 1/4: 2 bits a
    coefficient, 2 -> +1, 3 -> -1. int64 (n,)."""
    b = threefry.bits(key, (n,), device) & 3
    return torch.where(b == 2, 1, torch.where(b == 3, -1, 0))


@functools.lru_cache(maxsize=None)
def _gaussian_cdt(sigma: float, bound: int):
    """CDF thresholds over [-bound, bound] scaled to u32 (the JAX
    package's table), and the values they select."""
    ks = np.arange(-bound, bound + 1)
    probs = np.exp(-(ks.astype(np.float64) ** 2) / (2 * sigma * sigma))
    probs /= probs.sum()
    cdf = np.cumsum(probs)
    thresholds = np.minimum((cdf * (2.0 ** 32)).astype(np.uint64),
                            (1 << 32) - 1).astype(np.int64)
    return thresholds, ks.astype(np.int64)


def gaussian(key, n: int, device, sigma: float = 3.2,
             bound: int | None = None) -> torch.Tensor:
    """Discrete gaussian by inverse CDT, truncated at 6 sigma. int64 (n,)."""
    if bound is None:
        bound = int(math.floor(6 * sigma))
    thresholds, ks = _gaussian_cdt(float(sigma), bound)
    thresholds = torch.from_numpy(thresholds).to(device)
    ks = torch.from_numpy(ks).to(device)
    u = threefry.bits(key, (n,), device)
    idx = torch.searchsorted(thresholds, u, right=True)
    return ks[idx.clamp(max=len(ks) - 1)]


def ternary_sparse(key, n: int, hw: int, device) -> torch.Tensor:
    """Exactly hw non-zero coefficients, each +-1 with equal probability
    (lattigo's NewTernarySamplerSparse, GenSecretKeySparse, keygen.go:
    78-85): the first hw positions of a permutation under one half of the
    key, their signs from the other half's bits. int64 (n,)."""
    k1, k2 = threefry.split(key)
    pos = threefry.permutation(k1, n, device)[:hw]
    signs = torch.where((threefry.bits(k2, (n,), device) & 1) == 1, 1, -1)
    mask = torch.zeros(n, dtype=torch.int64, device=device)
    return signs * mask.index_fill_(0, pos, 1)


def gaussian_rns(key, ring: Ring, *batch, sigma: float = 3.2
                 ) -> torch.Tensor:
    """Gaussian error lifted to RNS, shape (*batch, L, N)."""
    e = gaussian(key, math.prod(batch) * ring.n, ring.device, sigma=sigma)
    return lift_signed(e.reshape(*batch, ring.n), ring)


def ternary_rns(key, ring: Ring, *batch) -> torch.Tensor:
    """Ternary values lifted to RNS, shape (*batch, L, N)."""
    t = ternary(key, math.prod(batch) * ring.n, ring.device)
    return lift_signed(t.reshape(*batch, ring.n), ring)
