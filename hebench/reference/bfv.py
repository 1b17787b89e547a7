"""Multi-key BFV, judged from the outside: decryption, the exact scale-down
round(t * phase / Q) mod t, the slot layout mod t and the noise, in plain
torch and Python integers.

A ciphertext (k+1, Lq, N) in the coefficient domain decrypts with the
parties' ternary secrets s_i to its phase

    phase = c_0 + sum_i c_i s_i  (mod Q, negacyclic in X^N + 1)

(ckks.decrypt: it is scheme-agnostic, with its own NTT). The phase is
lifted to an integer in [0, Q) exactly, by Garner's mixed-radix digits
over all Lq limbs and Python integers, never floats; the plaintext is

    m = round(t * phase / Q) mod t

and the noise is phase - round(Q * m / t), centered mod Q: decryption is
sound while every |noise| < Q / (2t).

Slots follow lattigo's BFV encoder (the scheme's published layout, as
SNUCP/MKHE-KKLSS encodes through it): psi = g^((t-1)/2N) mod t for g the
least generator of Z_t^* (lattigo's ring.primitiveRoot), value c sits at
m(psi^(5^c)) and value N/2 + c at m(psi^(-5^c)), c < N/2. The
evaluations come from a negacyclic NTT mod t written here.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import ckks
from .primes import ntt_primes


def bfv_moduli(logn: int, q_bits: float, q_count: int, p_bits: float,
               p_count: int, **_) -> tuple:
    """(Q, QMul, P) of a BFV configuration, as the system under test
    chooses them: Q the first q_count NTT primes from 2^q_bits, QMul the
    next q_count, P p_count primes from 2^p_bits."""
    return (ntt_primes(logn, q_bits, q_count),
            ntt_primes(logn, q_bits, q_count, skip=q_count),
            ntt_primes(logn, p_bits, p_count))


def _prime_factors(n: int) -> list:
    out, p = [], 2
    while p * p <= n:
        if n % p == 0:
            out.append(p)
            while n % p == 0:
                n //= p
        p += 1
    return out + ([n] if n > 1 else [])


def lattigo_psi(t: int, logn: int) -> int:
    """The primitive 2N-th root of unity mod t that lattigo's ring takes:
    g^((t-1)/2N), g the least generator of Z_t^*."""
    two_n = 2 << logn
    if (t - 1) % two_n:
        raise ValueError(f"t = {t} has no 2N-th roots of unity at logN "
                         f"{logn}")
    factors = _prime_factors(t - 1)
    g = next(g for g in range(2, t)
             if all(pow(g, (t - 1) // f, t) != 1 for f in factors))
    return pow(g, (t - 1) // two_n, t)


@functools.lru_cache(maxsize=4)
def _tables(t: int, logn: int, device: str):
    """(psi^i, omega^i for omega = psi^2, bit reversal, slot index) on
    the device; slot index: the evaluation j = (e - 1) / 2 at psi^e that
    each value c lands on."""
    n = 1 << logn
    psi = lattigo_psi(t, logn)
    dev = torch.device(device)
    q = torch.tensor([[t]], dtype=torch.int64, device=dev)
    twist = ckks._powers([psi], n, q)[0]
    omega = ckks._powers([psi * psi % t], n, q)[0]
    brv = torch.zeros(n, dtype=torch.int64)
    for b in range(logn):
        brv |= ((torch.arange(n) >> b) & 1) << (logn - 1 - b)
    e = np.empty(n // 2, np.int64)
    cur = 1
    for c in range(n // 2):
        e[c] = cur
        cur = cur * 5 % (2 * n)
    exps = np.concatenate([e, 2 * n - e])
    return (twist, omega, brv.to(dev),
            torch.from_numpy((exps - 1) // 2).to(dev))


def slots(m: torch.Tensor, t: int) -> torch.Tensor:
    """The slot values (N,) in [0, t) of the plaintext m (N,) mod t:
    m(psi^(2j+1)) for every j by a cyclic radix-2 DFT of m_i psi^i with
    omega = psi^2, then put in lattigo's slot order."""
    n = m.shape[-1]
    logn = n.bit_length() - 1
    twist, omega, brv, index = _tables(t, logn, str(m.device))
    a = (m.to(torch.int64) % t * twist % t)[brv]
    size = 1
    while size < n:
        a = a.reshape(n // (2 * size), 2, size)
        w = omega[::n // (2 * size)][:size]
        u, v = a[:, 0], a[:, 1] * w % t
        a = torch.stack([(u + v) % t, (u - v) % t], dim=1)
        size *= 2
    return a.reshape(n)[index]


def garner_int(x: torch.Tensor, moduli) -> np.ndarray:
    """Residues x (L, N) mod moduli[:L] as Python integers in [0, Q), an
    object array (N,): Garner's mixed-radix digits in int64 torch, then
    their sum by Python integers."""
    L = x.shape[0]
    q = [int(v) for v in moduli[:L]]
    digits = []
    for i in range(L):
        acc = torch.zeros_like(x[0])
        w = 1
        for j in range(i):
            acc = (acc + digits[j] * (w % q[i])) % q[i]
            w *= q[j]
        inv = pow(w % q[i], -1, q[i])
        digits.append((x[i] - acc) % q[i] * inv % q[i])
    out = np.zeros(x.shape[1], dtype=object)
    w = 1
    for d, qi in zip(digits, q):
        out = out + d.cpu().numpy().astype(object) * w
        w *= qi
    return out


def scale_down(phase: np.ndarray, Q: int, t: int) -> np.ndarray:
    """round(t * phase / Q) mod t of integers phase in [0, Q), int64."""
    m = (2 * t * phase + Q) // (2 * Q) % t
    return m.astype(np.int64)


def noise_log2(phase: np.ndarray, m: np.ndarray, Q: int, t: int) -> float:
    """log2 of max |phase - round(Q m / t)| (centered mod Q) over
    Q / (2t): below 0 while decryption is sound; a noise of 0 reads as
    one unit."""
    e = (phase - (2 * Q * m.astype(object) + t) // (2 * t)) % Q
    e = np.where(e > Q // 2, Q - e, e)
    return math.log2(max(int(e.max()), 1)) - (math.log2(Q) - math.log2(2 * t))


def open_ciphertext(data, secrets, moduli, t: int):
    """(slot values (N,) int64 centered mod t, noise_log2) of a
    ciphertext's limbs data (k+1, Lq, N) under the parties' secrets
    (k, N) in its party order, over the Q moduli."""
    L = data.shape[-2]
    Q = math.prod(int(q) for q in moduli[:L])
    phase = garner_int(ckks.decrypt(data, secrets, moduli), moduli)
    m = scale_down(phase, Q, t)
    vals = slots(torch.from_numpy(m).to(data.device), t).cpu()
    return torch.where(vals > t // 2, vals - t, vals), noise_log2(
        phase, m, Q, t)


def centered(x: torch.Tensor, t: int) -> torch.Tensor:
    """x mod t, centered in (-t/2, t/2]."""
    r = torch.remainder(x, t)
    return torch.where(r > t // 2, r - t, r)
