"""Samplers for RLWE key material and encryption randomness.

Port of mkhe_tpu/ops/sampling.py, driven by an explicit torch.Generator
(on the device where the samples are drawn) instead of jax.random keys:
uniform mod q_i, ternary with P(0) = 1/2, and a discrete gaussian
(sigma = 3.2, truncated at 6 sigma) by inverse CDT. The distributions are
the JAX package's; the bits are not (a torch.Generator is not threefry),
so tests that need both packages to agree feed them the same samples.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .ring import Ring


def uniform(gen: torch.Generator, ring: Ring, *batch) -> torch.Tensor:
    """Uniform in [0, q_i) per limb, shape (*batch, L, N): a 62-bit draw
    reduced mod q_i (bias < 2^-33 for q < 2^29)."""
    shape = (*batch, ring.nlimbs, ring.n)
    r = torch.randint(0, 1 << 62, shape, generator=gen, dtype=torch.int64,
                      device=ring.device)
    return r % ring.q[:, None]


def lift_signed(vals, ring: Ring) -> torch.Tensor:
    """Small signed ints (..., N) -> RNS (..., L, N): v >= 0 -> v,
    v < 0 -> q_i + v (lattigo's ExtendBasisSmallNormAndCenter)."""
    v = vals.to(torch.int64)[..., None, :]
    return torch.where(v < 0, ring.q[:, None] + v, v)


def ternary(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """{-1, 0, +1} with P(0) = 1/2, P(+1) = P(-1) = 1/4. int64 (n,)."""
    b = torch.randint(0, 4, (n,), generator=gen, dtype=torch.int64,
                      device=device)
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


def gaussian(gen: torch.Generator, n: int, device, sigma: float = 3.2,
             bound: int | None = None) -> torch.Tensor:
    """Discrete gaussian by inverse CDT, truncated at 6 sigma. int64 (n,)."""
    if bound is None:
        bound = int(math.floor(6 * sigma))
    thresholds, ks = _gaussian_cdt(float(sigma), bound)
    thresholds = torch.from_numpy(thresholds).to(device)
    ks = torch.from_numpy(ks).to(device)
    u = torch.randint(0, 1 << 32, (n,), generator=gen, dtype=torch.int64,
                      device=device)
    idx = torch.searchsorted(thresholds, u, right=True)
    return ks[idx.clamp(max=len(ks) - 1)]
