"""NTT-friendly RNS primes (a copy of mkhe_tpu/ops/primes.py, so that the
port imports nothing of the JAX package).

Primes q with q = 1 (mod 2N), so the negacyclic NTT of degree N exists, and
2^20 <= q < 2^29, so the products of two residues stay below 2^58.
"""

from __future__ import annotations

import functools


def _is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (enough for < 2**64)."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@functools.lru_cache(maxsize=None)
def ntt_primes(logn: int, bits: float, count: int, skip: int = 0) -> tuple:
    """`count` distinct primes q = 1 (mod 2^(logn+1)), q ~ 2**bits, found by
    searching outward from 2**bits (alternating above and below), in
    discovery order; the first `skip` are passed over, so callers can carve
    disjoint prime sets from one size class."""
    m = 1 << (logn + 1)
    k0 = round(2.0 ** bits) // m
    found = []
    offset = 0
    while len(found) < count + skip:
        for k in ((k0 + offset), (k0 - offset)) if offset else (k0,):
            q = k * m + 1
            if q >= (1 << 29) or q < (1 << 20):
                continue
            if _is_prime(q):
                found.append(q)
                if len(found) >= count + skip:
                    break
        offset += 1
        if offset > (1 << 24):
            raise RuntimeError(
                f"not enough NTT primes near 2**{bits} for logN={logn}")
    return tuple(found[skip:skip + count])


def primitive_root_2n(q: int, logn: int) -> int:
    """The primitive 2N-th root of unity psi mod q that the JAX package
    picks: g^((q-1)/2N) for the smallest g >= 2 with psi^N = -1."""
    two_n = 1 << (logn + 1)
    if (q - 1) % two_n:
        raise ValueError(f"{q} is not 1 mod 2N (logN={logn})")
    cofactor = (q - 1) // two_n
    for g in range(2, 10001):
        psi = pow(g, cofactor, q)
        if pow(psi, two_n // 2, q) == q - 1:
            return psi
    raise RuntimeError("no primitive root found")


def bit_reverse(x: int, bits: int) -> int:
    """x with its low `bits` bits in reverse order."""
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r
