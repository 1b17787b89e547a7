"""Threefry-2x32 and the jax.random functions the samplers draw from.

The port's own copy of what mkhe_tpu/ops/sampling.py takes from
jax.random: key, split, fold_in, bits (32-bit) and permutation, bit for
bit, so that the same seeds give both packages the same CRS, keys and
ciphertexts. Parity holds against jax_threefry_partitionable=True, the
default since jax 0.5.0 (which the JAX package never changes): a split is
"foldlike" and the bits of element i come from the counter i, split into
(hi, lo) words, as out0 ^ out1.

A key is a pair of u32 python ints, held on the host: split and fold_in
hash one counter pair with python-int arithmetic. bits hashes one counter
per element on the device it is given. Words are u32 values in int64
tensors, as everywhere in the port (modmath.py), masked after every add
and shift, so that the arithmetic is exact on the CPU and on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
# counters hashed per pass of bits(): each int64 temporary of a pass is
# 32 MB, where one PN15 CRS (2 x 14 x 32 x 2^15 words) would be 470 MB
CHUNK = 1 << 22
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (Random123; jax's _threefry2x32_lowering).
    k0, k1: the key's u32 words as python ints; x0, x1: the counter's
    words, python ints or int64 tensors of u32 values. Returns the two
    output words the same way."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        # key injection i + 1: the next key words, and its number
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ((ks[(i + 2) % 3] + i + 1) & M32)) & M32
    return x0, x1


def key(seed: int) -> tuple:
    """jax.random.key(seed) with x64 off: (0, seed mod 2^32)."""
    return (0, seed & M32)


def split(k: tuple, num: int = 2) -> tuple:
    """jax.random.split(k, num): key i is the hash of the counter
    (i >> 32, i mod 2^32)."""
    return tuple(threefry2x32(k[0], k[1], i >> 32, i & M32)
                 for i in range(num))


def fold_in(k: tuple, d: int) -> tuple:
    """jax.random.fold_in(k, d): the hash of the counter (0, d mod 2^32)."""
    return threefry2x32(k[0], k[1], 0, d & M32)


class KeyChain:
    """The running key of the JAX package's KeyGenerator and Encryptor:
    key(seed), and each next() splits it, keeps output 0 and returns
    output 1, the key of one sampler call."""

    def __init__(self, seed: int):
        self.key = key(seed)

    def next(self) -> tuple:
        self.key, k = split(self.key)
        return k


def bits(k: tuple, shape, device) -> torch.Tensor:
    """jax.random.bits(k, shape, uint32) as an int64 tensor on device:
    element i (row-major) is out0 ^ out1 of the counter i, hashed CHUNK
    counters at a time (the draw is counter-based, so the chunks give the
    bits of one pass)."""
    shape = tuple(shape)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.int64, device=device)
    for start in range(0, n, CHUNK):
        i = torch.arange(start, min(start + CHUNK, n), dtype=torch.int64,
                         device=device)
        y0, y1 = threefry2x32(k[0], k[1], i >> 32, i & M32)
        out[start:start + CHUNK] = y0 ^ y1
    return out.reshape(shape)


def permutation(k: tuple, n: int, device) -> torch.Tensor:
    """jax.random.permutation(k, n) (jax.random._shuffle): rounds of
    k, sub = split(k), then a stable sort of the running order by
    bits(sub, (n,)); stable as lax.sort_key_val, since 32-bit sort keys
    tie at n = 2^15. int64 (n,)."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(M32)))
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(rounds):
        k, sub = split(k)
        x = x[torch.sort(bits(sub, (n,), device), stable=True).indices]
    return x
