"""RNS negacyclic polynomial ring Z_q[X]/(X^N+1) on int64 tensors.

Port of mkhe_tpu/ops/ring.py. Polynomials are int64 tensors of shape
(..., L, N) holding canonical u32 residues; every op is batched over the
leading axes. NTT-domain data is in bit-reversed evaluation order, slot j
holding the evaluation at psi^(2*brv(j)+1) — the JAX package's order, so
NTT-domain keys carried across from it are valid here.

Ring.ntt / Ring.intt dispatch on the tensor's device (ops/ntt_cuda.py):
the hand-written CUDA kernels for a CUDA tensor, their plain PyTorch
versions for a CPU tensor.

Only the tables the port uses are built: none of the JAX package's
Pallas-layout twiddles (wpack, twist, ...) or MXU-tail matrices.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from .. import config
from . import modmath as mm
from . import ntt_cuda
from .primes import primitive_root_2n

TABLE_FIELDS = ("q", "r_inv", "r2", "bar", "psi", "psi_sh", "ipsi",
                "ipsi_sh", "ninv", "ninv_sh")


def _pow_seq(base: int, n: int, q: int) -> np.ndarray:
    """[base^0, ..., base^(n-1)] mod q as uint64, by vectorized doubling."""
    out = np.ones(n, np.uint64)
    qq = np.uint64(q)
    m = 1
    while m < n:
        step = np.uint64(pow(int(base), m, int(q)))
        hi = min(2 * m, n)
        out[m:hi] = (out[:hi - m] * step) % qq
        m = hi
    return out


def _shoup_vec(v: np.ndarray, q: int) -> np.ndarray:
    """floor(v * 2^32 / q) for canonical v (< q < 2^32), exact in u64."""
    return (v.astype(np.uint64) << np.uint64(32)) // np.uint64(q)


def _brv_vec(logn: int) -> np.ndarray:
    j = np.arange(1 << logn, dtype=np.int64)
    r = np.zeros_like(j)
    for t in range(logn):
        r = (r << 1) | ((j >> t) & 1)
    return r


def _host_tables(moduli: Tuple[int, ...], logn: int) -> dict:
    """Per-limb constants as int64 numpy arrays. q, r2, bar, psi, psi_sh,
    ipsi, ipsi_sh, ninv and ninv_sh equal the JAX package's tables of the
    same names (mkhe_tpu/ops/ring.py::_host_tables); r_inv = 2^-32 mod q
    is the port's Montgomery reduction constant."""
    n = 1 << logn
    L = len(moduli)
    consts = {k: np.empty(L, np.int64)
              for k in ("q", "r_inv", "r2", "bar", "ninv", "ninv_sh")}
    tabs = {k: np.empty((L, n), np.int64)
            for k in ("psi", "psi_sh", "ipsi", "ipsi_sh")}
    brv = _brv_vec(logn)
    for i, qi in enumerate(moduli):
        consts["q"][i] = qi
        consts["r_inv"][i], consts["r2"][i] = mm.mont_constants(qi)
        consts["bar"][i] = mm.barrett_constant(qi)
        root = primitive_root_2n(qi, logn)
        # psi[j] = root^brv(j), ipsi[j] = root^-brv(j)
        tabs["psi"][i] = _pow_seq(root, n, qi)[brv]
        tabs["ipsi"][i] = _pow_seq(pow(root, -1, qi), n, qi)[brv]
        tabs["psi_sh"][i] = _shoup_vec(tabs["psi"][i], qi)
        tabs["ipsi_sh"][i] = _shoup_vec(tabs["ipsi"][i], qi)
        nv = pow(n, -1, qi)
        consts["ninv"][i] = nv
        consts["ninv_sh"][i] = mm.shoup_host(nv, qi)
    return {**consts, **tabs}


@dataclasses.dataclass(frozen=True, eq=False)
class Ring:
    """An RNS ring over a tuple of NTT-friendly primes < 2^29, with its
    tables on one device. Constants are (L,) int64 tensors, NTT tables
    (L, N) int64 tensors."""
    moduli: Tuple[int, ...]
    logn: int
    device: torch.device
    q: torch.Tensor
    r_inv: torch.Tensor
    r2: torch.Tensor
    bar: torch.Tensor
    psi: torch.Tensor
    psi_sh: torch.Tensor
    ipsi: torch.Tensor
    ipsi_sh: torch.Tensor
    ninv: torch.Tensor
    ninv_sh: torch.Tensor

    # -- construction -------------------------------------------------------

    @staticmethod
    def create(moduli, logn: int, device=None) -> "Ring":
        return _create(tuple(int(m) for m in moduli), int(logn),
                       config.get_device(device))

    @property
    def n(self) -> int:
        return 1 << self.logn

    @property
    def nlimbs(self) -> int:
        return len(self.moduli)

    def take(self, lo: int, hi: int) -> "Ring":
        """Sub-ring over moduli[lo:hi] (views of the tables)."""
        return Ring(moduli=self.moduli[lo:hi], logn=self.logn,
                    device=self.device,
                    **{k: getattr(self, k)[lo:hi] for k in TABLE_FIELDS})

    def concat(self, other: "Ring") -> "Ring":
        """Ring over moduli ++ other.moduli (the QP ring: every op is
        limb-wise, so Q and P limbs ride through one batched call)."""
        if self.logn != other.logn or self.device != other.device:
            raise ValueError("rings differ in degree or device")
        return Ring(moduli=self.moduli + other.moduli, logn=self.logn,
                    device=self.device,
                    **{k: torch.cat([getattr(self, k), getattr(other, k)])
                       for k in TABLE_FIELDS})

    # -- broadcast helper ---------------------------------------------------

    @staticmethod
    def _c(arr):
        """(L,) constant -> (L, 1), broadcasting against (..., L, N)."""
        return arr[:, None]

    # -- pointwise ops (all on (..., L, N), canonical in [0, q)) ------------

    def add(self, a, b):
        return mm.add_mod(a, b, self._c(self.q))

    def sub(self, a, b):
        return mm.sub_mod(a, b, self._c(self.q))

    def neg(self, a):
        return mm.neg_mod(a, self._c(self.q))

    def reduce(self, a):
        """Barrett-reduce any u32 values to canonical [0, q)."""
        return mm.barrett_reduce(a, self._c(self.q), self._c(self.bar))

    def mul_mont(self, a, b):
        """a * b * 2^-32 mod q; b in Montgomery form (key material)."""
        return mm.mont_mul(a, b, self._c(self.q), self._c(self.r_inv))

    def to_mont(self, a):
        return mm.to_mont(a, self._c(self.q), self._c(self.r_inv),
                          self._c(self.r2))

    def mul_scalar_mont(self, a, s_mont):
        """Multiply by per-limb scalars in Montgomery form, shape (L,)."""
        return mm.mont_mul(a, self._c(s_mont), self._c(self.q),
                           self._c(self.r_inv))

    # -- NTT ----------------------------------------------------------------

    def ntt(self, a):
        """Forward negacyclic NTT over (..., L, N): standard coefficient
        order in, bit-reversed evaluation order out, canonical. Accepts
        any u32 input (it is reduced first), so it also covers the JAX
        package's ntt(reduce_input=True)."""
        return ntt_cuda.ntt(a.contiguous(), self.q, self.bar, self.psi,
                            self.psi_sh)

    def intt(self, a):
        """Inverse negacyclic NTT: bit-reversed in, standard order out,
        canonical. Accepts any u32 input, which covers the lazy (< 8q)
        inputs of the JAX package's intt(reduce_input=True)."""
        return ntt_cuda.intt(a.contiguous(), self.q, self.bar, self.ipsi,
                             self.ipsi_sh, self.ninv, self.ninv_sh)


@functools.lru_cache(maxsize=None)
def _create(moduli: Tuple[int, ...], logn: int, device: torch.device
            ) -> Ring:
    t = _host_tables(moduli, logn)
    return Ring(moduli=moduli, logn=logn, device=device,
                **{k: torch.from_numpy(t[k]).to(device)
                   for k in TABLE_FIELDS})
