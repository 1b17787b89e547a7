"""Multi-key CKKS, judged from the outside: decryption, the small-value
CRT, the canonical-embedding decode and the rescale rule, in plain torch.

A ciphertext is judged from its limbs (k+1, L, N) in the coefficient
domain, its party order and the parties' ternary secrets s_i:

    m = c_0 + sum_i c_i s_i  (mod q_l, negacyclic in X^N + 1)

The products go through a plain negacyclic NTT whose roots are searched
here, so nothing of the program's tables is used. m must be small: its
mixed-radix (Garner) digits beyond the first VALUE_DIGITS are all 0 (m >=
0) or all q_l - 1 (m < 0); a coefficient that breaks this is counted as
not small, and a ciphertext with one such coefficient is judged wrong
outright. Slot j holds m(zeta^(5^j)) / scale, zeta = exp(i pi / N).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

VALUE_DIGITS = 3   # ~2^85 of headroom for |m|; a CKKS value is < 2^62


def _primitive_2n_root(q: int, logn: int) -> int:
    two_n = 1 << (logn + 1)
    cof = (q - 1) // two_n
    for g in range(2, 1 << 16):
        psi = pow(g, cof, q)
        if pow(psi, two_n // 2, q) == q - 1:
            return psi
    raise ValueError(f"no primitive 2N-th root mod {q}")


def _powers(bases, n: int, q: torch.Tensor) -> torch.Tensor:
    """(L, n) table of bases[l]^i mod q[l], by doubling."""
    out = torch.ones((len(bases), n), dtype=torch.int64, device=q.device)
    b = torch.tensor(bases, dtype=torch.int64, device=q.device)[:, None]
    out[:, 1:2] = b % q
    size = 2
    while size < n:
        half = out[:, size // 2:size // 2 + 1]       # b^(size/2)
        out[:, size:2 * size] = out[:, :size] * (half * half % q) % q
        size *= 2
    return out


class NegacyclicNTT:
    """Negacyclic products mod each q_l at degree N: the twist by psi^i,
    a radix-2 cyclic NTT with omega = psi^2, the pointwise product, the
    inverse and the untwist."""

    def __init__(self, moduli, logn: int, device):
        n = 1 << logn
        self.n, self.logn = n, logn
        self.q = torch.tensor(moduli, dtype=torch.int64,
                              device=device)[:, None]
        psi = [_primitive_2n_root(q, logn) for q in moduli]
        ipsi = [pow(p, -1, q) for p, q in zip(psi, moduli)]
        self.twist = _powers(psi, n, self.q)
        self.untwist = _powers(ipsi, n, self.q)
        ninv = torch.tensor([pow(n, -1, q) for q in moduli],
                            dtype=torch.int64, device=device)[:, None]
        self.untwist = self.untwist * ninv % self.q
        self.w = _powers([p * p % q for p, q in zip(psi, moduli)], n, self.q)
        self.iw = _powers([p * p % q for p, q in zip(ipsi, moduli)], n,
                          self.q)
        brv = torch.zeros(n, dtype=torch.int64)
        for b in range(logn):
            brv |= ((torch.arange(n) >> b) & 1) << (logn - 1 - b)
        self.brv = brv.to(device)

    def _cyclic(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Cyclic DFT mod q of (..., L, N) by iterative radix-2 DIT."""
        n, q = self.n, self.q
        a = a.index_select(-1, self.brv)
        shape = a.shape
        m = 1
        while m < n:
            blocks = n // (2 * m)
            a = a.reshape(*shape[:-1], blocks, 2, m)
            tw = w[:, ::blocks][:, :m][:, None, :]        # omega^(k n/2m)
            qq = q[:, None, :]
            u = a[..., 0, :]
            v = a[..., 1, :] * tw % qq
            a = torch.stack([(u + v) % qq, (u - v) % qq], dim=-2)
            m *= 2
        return a.reshape(shape)

    def forward(self, a: torch.Tensor) -> torch.Tensor:
        return self._cyclic(a % self.q * self.twist % self.q, self.w)

    def inverse(self, a: torch.Tensor) -> torch.Tensor:
        return self._cyclic(a, self.iw) * self.untwist % self.q


@functools.lru_cache(maxsize=8)
def _ntt(moduli: tuple, logn: int, device: str) -> NegacyclicNTT:
    return NegacyclicNTT(moduli, logn, torch.device(device))


def decrypt(data: torch.Tensor, secrets, moduli) -> torch.Tensor:
    """c_0 + sum_i c_i s_i mod q_l: data (k+1, L, N) coefficient domain,
    secrets (k, N) signed small ints in the parties' order. (L, N)."""
    L, n = data.shape[-2:]
    logn = n.bit_length() - 1
    ntt = _ntt(tuple(moduli[:L]), logn, str(data.device))
    q = ntt.q
    c = data.to(torch.int64) % q
    s = secrets.to(device=data.device, dtype=torch.int64)[:, None, :] % q
    prod = ntt.forward(c[1:]) * ntt.forward(s.expand_as(c[1:])) % q
    return (c[0] + ntt.inverse(prod.sum(0) % q)) % q


def small_values(x: torch.Tensor, moduli):
    """Centered integers of residues x (L, N), as float64 (N,), and the
    count of coefficients that are not small (Garner's digits beyond
    VALUE_DIGITS neither all 0 nor all q_l - 1)."""
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
    neg = digits[-1] > q[-1] // 2
    vals = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    bad = torch.zeros(x.shape[1], dtype=torch.bool, device=x.device)
    w = 1.0
    for i, (d, qi) in enumerate(zip(digits, q)):
        mag = torch.where(neg, qi - 1 - d, d)
        if i < VALUE_DIGITS:
            vals += mag.to(torch.float64) * w
            w *= qi
        else:
            bad |= mag != 0
    vals = torch.where(neg, -(vals + 1.0), vals)
    return vals, int(bad.sum())


@functools.lru_cache(maxsize=8)
def _slot_index(logn: int, device: str) -> torch.Tensor:
    n = 1 << logn
    e = np.empty(n // 2, np.int64)
    cur = 1
    for j in range(n // 2):
        e[j] = cur
        cur = cur * 5 % (2 * n)
    return torch.from_numpy((e - 1) // 2).to(device)


def decode(vals: torch.Tensor, scale: float, slots: int) -> torch.Tensor:
    """Slots 0..slots-1 of the centered coefficients vals (N,):
    m(zeta^(2t+1)) = N * IDFT(m_k zeta^k)[t] at t = (5^j - 1) / 2."""
    n = vals.shape[0]
    k = torch.arange(n, dtype=torch.float64, device=vals.device)
    twist = torch.polar(torch.ones_like(k), math.pi * k / n)
    ev = torch.fft.ifft(vals / scale * twist) * n
    return ev[_slot_index(n.bit_length() - 1, str(vals.device))[:slots]]


def open_ciphertext(data, secrets, moduli, scale: float, slots: int):
    """(slots as complex128, count of coefficients not small)."""
    vals, bad = small_values(decrypt(data, secrets, moduli), moduli)
    return decode(vals, scale, slots), bad


# -- the scheme's scale and level rules, worked out again ---------------------

def rescale(scale: float, level: int, moduli, min_scale: float):
    """(scale, level) after Rescale: divide by trailing moduli while
    scale / q_level >= min_scale / 2 and a level is left."""
    while level >= 1 and scale / moduli[level] >= min_scale / 2:
        scale /= moduli[level]
        level -= 1
    return scale, level
