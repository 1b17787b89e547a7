"""Exact modular arithmetic on int64 tensors holding u32 values.

Port of mkhe_tpu/ops/modmath.py. PyTorch has no u32 arithmetic on the CPU,
so values are u32 representatives in [0, 2^32) stored in torch.int64, and
every function here is exact int64 arithmetic that never leaves
[0, 2^63). All results are CANONICAL (in [0, q)); the JAX package's lazy
variants (mont_mul_lazy, shoup_mul_sloppy, ...) return non-unique
representatives and have no counterpart here — every seam where the JAX
package is canonical gives bit-identical values.

Conventions (the same as the JAX package, so key material carries over):
  - moduli q < 2^29 (mkhe_tpu/ops/primes.py)
  - "Montgomery form" of x is x * 2^32 mod q; mont_mul(a, b_mont) = a*b
  - "Shoup form" of a constant w < q is floor(w * 2^32 / q)

Broadcasting: q and the per-limb constants are int64 tensors shaped to
broadcast against the data, usually (L, 1) against (..., L, N).
"""

from __future__ import annotations

import torch

MASK16 = 0xFFFF
MASK32 = 0xFFFFFFFF

# mul_accum operands are canonical (< q < 2^29), so each product is
# < 2^58 and 16 of them plus one canonical residue stay below 2^63.
ACCUM_CHUNK = 16


# ----------------------------------------------------------------------------
# Host-side constant helpers (python ints)
# ----------------------------------------------------------------------------

def mont_constants(q: int):
    """(r_inv, r2): r_inv = 2^-32 mod q (the Montgomery reduction as a
    multiply) and r2 = 2^64 mod q (to_mont via mont_mul)."""
    return pow(1 << 32, -1, q), (1 << 64) % q


def to_mont_host(x: int, q: int) -> int:
    return (x << 32) % q


def shoup_host(w: int, q: int) -> int:
    """Shoup precomputation floor(w * 2^32 / q) for w in [0, q)."""
    return (w << 32) // q


def barrett_constant(q: int) -> int:
    """floor(2^32 / q) for the single-word Barrett reduction."""
    return (1 << 32) // q


# ----------------------------------------------------------------------------
# Tensor primitives
# ----------------------------------------------------------------------------

def mul_hi32(a, b):
    """floor(a * b / 2^32) for a, b < 2^32, exact in int64 (the 64-bit
    product itself may not fit, so a is split into 16-bit halves)."""
    return ((a >> 16) * b + (((a & MASK16) * b) >> 16)) >> 16


def csub(a, q):
    """a - q if a >= q else a."""
    return torch.where(a >= q, a - q, a)


def add_mod(a, b, q):
    """(a + b) mod q for canonical a, b."""
    return csub(a + b, q)


def sub_mod(a, b, q):
    """(a - b) mod q for canonical a, b."""
    return csub(a + q - b, q)


def neg_mod(a, q):
    """-a mod q for canonical a."""
    return torch.where(a == 0, a, q - a)


def mont_mul(a, b, q, r_inv):
    """a * b * 2^-32 mod q, canonical; any a < 2^32, b < q (b usually in
    Montgomery form). Exactly the canonical value the JAX REDC gives."""
    return (a * b % q) * r_inv % q


def shoup_mul(a, w, w_shoup, q):
    """a * w mod q, canonical; any a < 2^32, constant w < q with
    w_shoup = floor(w * 2^32 / q). The quotient is exact, so a*w - t*q
    lies in [0, 2q)."""
    return csub(a * w - mul_hi32(a, w_shoup) * q, q)


def barrett_reduce(a, q, b_const):
    """Reduce any a < 2^32 to [0, q); b_const = floor(2^32 / q)."""
    r = a - mul_hi32(a, b_const) * q
    return csub(csub(r, q), q)


def to_mont(a, q, r_inv, r2):
    """Canonical a -> a * 2^32 mod q."""
    return mont_mul(a, r2, q, r_inv)


def from_mont(a, q, r_inv):
    """Montgomery-form a (< 2^32) -> canonical a * 2^-32 mod q."""
    return a * r_inv % q


def mul_accum(pairs, q, r_inv):
    """(sum a_i * b_i) * 2^-32 mod q over an iterable of (a_i, b_i),
    canonical: the port's form of the JAX 64-bit (hi, lo) accumulate +
    one Montgomery reduction (mul_accum_step / mul_accum_reduce).

    Operands must be canonical (< q < 2^29). Products are < 2^58, so the
    int64 sum is reduced mod q every ACCUM_CHUNK terms and never
    overflows — however many terms (the JAX chain sums up to 56 products
    of ~2^58 into one u64 pair, which a signed int64 could not hold)."""
    acc = None
    for i, (a, b) in enumerate(pairs):
        acc = a * b if acc is None else acc + a * b
        if (i + 1) % ACCUM_CHUNK == 0:
            acc = acc % q
    return (acc % q) * r_inv % q
