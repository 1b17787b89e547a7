"""The configurations' RNS moduli, worked out from their numbers alone.

A frozen copy of the prime search and the CKKS modulus selection of the
system under test (NTT primes q = 1 mod 2N below 2^29, searched outward
from 2^bits; each level a pair whose product is closest to 2^(2 bits)),
so that the reference checks the program's moduli instead of taking them.
"""

from __future__ import annotations

import functools


def _is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
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
    """`count` primes q = 1 mod 2^(logn+1) in [2^20, 2^29), searched
    outward from 2^bits (above, then below), after passing over `skip`."""
    m = 1 << (logn + 1)
    k0 = round(2.0 ** bits) // m
    found, offset = [], 0
    while len(found) < count + skip:
        for k in ((k0 + offset), (k0 - offset)) if offset else (k0,):
            q = k * m + 1
            if (1 << 20) <= q < (1 << 29) and _is_prime(q):
                found.append(q)
                if len(found) >= count + skip:
                    break
        offset += 1
        if offset > (1 << 24):
            raise RuntimeError(f"too few NTT primes near 2^{bits}")
    return tuple(found[skip:skip + count])


def ckks_moduli(logn: int, q0_bits: float, level_bits: float, levels: int,
                q0_count: int = 2, limbs_per_level: int = 2,
                p_bits: float = 28.4, p_count: int = 2, **_) -> tuple:
    """(Q moduli, P moduli) of a CKKS configuration: q0_count base primes,
    `levels` levels of limbs_per_level primes (pairs balanced so that
    each level's product is closest to 2^(2 level_bits)), p_count
    special primes drawn past the size classes already used."""
    q0 = ntt_primes(logn, q0_bits, q0_count)
    if limbs_per_level == 2:
        pool = list(ntt_primes(logn, level_bits, 4 * levels * 2 + 16))
        target = 2.0 ** (2 * level_bits)
        lv = []
        for _ in range(levels):
            _, i, j = min((abs(pool[i] * pool[j] / target - 1.0), i, j)
                          for i in range(len(pool))
                          for j in range(i + 1, len(pool)))
            lv += [pool[i], pool[j]]
            pool = [p for k, p in enumerate(pool) if k not in (i, j)]
    else:
        lv = list(ntt_primes(logn, level_bits, levels * limbs_per_level))
    skip = 0
    if abs(p_bits - level_bits) < 0.3:
        skip += (4 * levels * 2 + 16 if limbs_per_level == 2
                 else levels * limbs_per_level)
    if abs(p_bits - q0_bits) < 0.3:
        skip += q0_count
    p = ntt_primes(logn, p_bits, p_count, skip=skip)
    if len(set(q0) | set(lv) | set(p)) != len(q0) + len(lv) + len(p):
        raise ValueError("prime collision across groups")
    return tuple(q0) + tuple(lv), tuple(p)
