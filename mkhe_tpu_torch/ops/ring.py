"""RNS negacyclic polynomial ring Z_q[X]/(X^N+1) on int64 tensors.

Port of mkhe_tpu/ops/ring.py. Polynomials are int64 tensors of shape
(..., L, N) holding canonical u32 residues; every op is batched over the
leading axes. NTT-domain data is in bit-reversed evaluation order, slot j
holding the evaluation at psi^(2*brv(j)+1) — the JAX package's order, so
NTT-domain keys carried across from it are valid here.

Ring.ntt / Ring.intt dispatch on the tensor's device (ops/ntt_cuda.py):
the hand-written CUDA kernels for a CUDA tensor, their plain PyTorch
versions for a CPU tensor. With config.ntt_mxu_tail on and N >= 256 they
take the split form instead (mkhe_tpu/ops/ntt_pallas.py:9-17, 266-312):

  ntt  = head (twist by psi^j, DIF stages with half-block h >= 128)
         -> tail (the stages h = 64 .. 1 as one 128x128 map per limb),
         one launch of the fused split kernel on a CUDA tensor;
  intt = tail (DIT stages h = 1 .. 64) -> DIT stages h >= 128 + untwist,
         one launch of the fused split inverse kernel on a CUDA tensor.

The split's tables (twist, untwist, the stage-packed wpack / iwpack with
their Shoup companions, and the tail maps as int8 digit planes) equal the
JAX package's of the same names (mkhe_tpu/ops/ring.py:77-212); beside
them SplitTables holds the split kernels' own (packed twist, wpack,
untwist and iwpack, the maps as u8 planes in fragment order). They are built only when the
split is first used, from a cache keyed on (moduli, logn, device), so
rings made by take / concat get them too.

The automorphisms X -> X^gal (permute_coeffs, permute_ntt) are gathers
along the last axis. Their index tables are built with numpy once per
(logN, gal) and copied once per device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .. import config
from . import modmath as mm
from . import ntt_cuda
from .ntt_cuda import (FRAG_PLANES, SPLIT_MIN_LOGN, TAIL_DIGIT_BITS,
                       TAIL_DIGITS, TAIL_LANES, SplitTables)
from .primes import primitive_root_2n

TABLE_FIELDS = ("q", "r_inv", "r2", "bar", "psi", "psi_sh", "ipsi",
                "ipsi_sh", "ninv", "ninv_sh", "psi_pack", "ipsi_pack")

# Stages with half-block h < TAIL_LANES = 128 stay inside one 128-lane
# block: together they are one fixed 128x128 map per limb, stored as
# TAIL_DIGITS = 5 base-2^TAIL_DIGIT_BITS (2^7) digit planes (0..127 fit
# int8 exactly; 5 * 7 = 35 bits cover any u32) for the plain version, and
# as FRAG_PLANES = 4 base-2^8 planes in the split kernel's fragment order.
# Ring.ntt / intt take the split for N >= 2^SPLIT_MIN_LOGN = 256.


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
    is the port's Montgomery reduction constant; psi_pack / ipsi_pack hold
    each twiddle with its Shoup quotient in one word, in the order the NTT
    kernels read them (ntt_cuda.pack_twiddles, which raises for a modulus
    of 2^30 or more)."""
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
    tabs["psi_pack"] = ntt_cuda.pack_twiddles(tabs["psi"], tabs["psi_sh"],
                                              moduli, True)
    tabs["ipsi_pack"] = ntt_cuda.pack_twiddles(tabs["ipsi"], tabs["ipsi_sh"],
                                               moduli, False)
    return {**consts, **tabs}


# ----------------------------------------------------------------------------
# Tables of the split NTT (config.ntt_mxu_tail)
# ----------------------------------------------------------------------------

# The split's tables that equal the JAX package's of the same names
# (SplitTables has the split kernel's besides).
SPLIT_FIELDS = ("twist", "twist_sh", "untwist", "untwist_sh", "wpack",
                "wpack_sh", "iwpack", "iwpack_sh", "tail_fwd", "tail_inv",
                "tail_pow")


def _tail_maps(q: int, logn: int, wpack: np.ndarray, iwpack: np.ndarray):
    """The tail's two 128x128 maps over Z_q for one limb, canonical uint64:
    forward = the DIF stages h = 64 .. 1, inverse = the DIT stages h = 1
    .. 64, each an exact simulation of the stage arithmetic
    (mkhe_tpu/ops/ring.py::_tail_matrices)."""
    n = 1 << logn
    lanes = min(TAIL_LANES, n)
    lane = np.arange(lanes)
    qq = np.uint64(q)

    def tw(table, h):
        if h == 1:
            return np.ones(lanes, np.uint64)
        return np.tile(table[n - 2 * h:n - h], lanes // h).astype(np.uint64)

    fwd = np.eye(lanes, dtype=np.uint64)
    h = lanes // 2
    while h >= 1:
        first = (lane & h) == 0
        p, mn = np.roll(fwd, -h, axis=1), np.roll(fwd, h, axis=1)
        fwd = np.where(first[None, :], (fwd + p) % qq,
                       ((mn + qq - fwd) % qq) * tw(wpack, h)[None, :] % qq)
        h //= 2
    inv = np.eye(lanes, dtype=np.uint64)
    h = 1
    while h < lanes:
        first = (lane & h) == 0
        p, mn = np.roll(inv, -h, axis=1), np.roll(inv, h, axis=1)
        v = np.where(first[None, :], p, inv) * tw(iwpack, h)[None, :] % qq
        inv = np.where(first[None, :], (inv + v) % qq, (mn + qq - v) % qq)
        h *= 2
    return fwd, inv


def _digit_planes(m: np.ndarray) -> np.ndarray:
    """The JAX package's form of a tail map: TAIL_DIGITS int8 planes of
    base 2^TAIL_DIGIT_BITS."""
    shifts = np.uint64(TAIL_DIGIT_BITS) * np.arange(TAIL_DIGITS,
                                                    dtype=np.uint64)
    mask = np.uint64((1 << TAIL_DIGIT_BITS) - 1)
    return ((m[None] >> shifts[:, None, None]) & mask).astype(np.int8)


@functools.lru_cache(maxsize=None)
def _limb_split_tables(q: int, logn: int) -> dict:
    """The split's tables for one limb, numpy (see SplitTables)."""
    n = 1 << logn
    root = primitive_root_2n(q, logn)
    fwd = _pow_seq(root, n, q)
    inv = _pow_seq(pow(root, -1, q), n, q)
    omega = root * root % q
    iomega = pow(omega, -1, q)
    wpack = np.zeros(n, np.uint64)
    iwpack = np.zeros(n, np.uint64)
    for s in range(1, logn + 1):
        h = n >> s
        stride = 1 << (s - 1)
        wpack[n - 2 * h:n - h] = _pow_seq(pow(omega, stride, q), h, q)
        iwpack[n - 2 * h:n - h] = _pow_seq(pow(iomega, stride, q), h, q)
    out = dict(twist=fwd, untwist=inv * np.uint64(pow(n, -1, q))
               % np.uint64(q), wpack=wpack, iwpack=iwpack)
    for k in list(out):
        out[k + "_sh"] = _shoup_vec(out[k], q)
    for k in ("twist", "wpack", "untwist", "iwpack"):   # the kernel's
        out[k + "_pack"] = ntt_cuda.pack_natural(out[k], out[k + "_sh"], (q,))
    out = {k: v.astype(np.int64) for k, v in out.items()}
    fwd_m, inv_m = _tail_maps(q, logn, wpack, iwpack)
    out["tail_fwd"], out["tail_inv"] = map(_digit_planes, (fwd_m, inv_m))
    out["tail_fwd_frag"] = ntt_cuda.tail_fragments(fwd_m)
    out["tail_inv_frag"] = ntt_cuda.tail_fragments(inv_m)
    out["tail_pow"] = np.array(
        [(1 << (TAIL_DIGIT_BITS * t + 32)) % q
         for t in range(2 * TAIL_DIGITS - 1)], np.int64)
    out["tail_pow8"] = np.array(
        [(1 << (8 * t + 32)) % q for t in range(2 * FRAG_PLANES - 1)],
        np.int64)
    return out


@functools.lru_cache(maxsize=None)
def _split_tables(moduli: Tuple[int, ...], logn: int, device: torch.device
                  ) -> SplitTables:
    limbs = [_limb_split_tables(q, logn) for q in moduli]
    return SplitTables(**{
        f.name: torch.from_numpy(np.stack([t[f.name] for t in limbs]))
        .to(device) for f in dataclasses.fields(SplitTables)})


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
    psi_pack: torch.Tensor
    ipsi_pack: torch.Tensor
    # with_dist's setting (a parallel.dist_ntt.Dist), None for a local ring
    dist: Optional[Any] = None

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

    def with_dist(self, group, n_shards: int = 0) -> "Ring":
        """Copy of this ring whose ntt / intt take a local chunk (..., L,
        N / n_shards) of a coefficient axis split over the process group
        `group` of n_shards ranks and run the sharded transform
        (parallel/dist_ntt.py); every rank of the group calls them
        together. The ring keeps the group, its size, this rank's index in
        it and the rank's twiddle tables. with_dist(None) returns the
        local ring."""
        if group is None:
            return dataclasses.replace(self, dist=None)
        from ..parallel import dist_ntt
        return dataclasses.replace(
            self, dist=dist_ntt.Dist.create(self, group, n_shards))

    def take(self, lo: int, hi: int) -> "Ring":
        """Sub-ring over moduli[lo:hi] (views of the tables, the dist
        setting's too)."""
        return Ring(moduli=self.moduli[lo:hi], logn=self.logn,
                    device=self.device,
                    dist=None if self.dist is None
                    else self.dist.take(lo, hi),
                    **{k: getattr(self, k)[lo:hi] for k in TABLE_FIELDS})

    def concat(self, other: "Ring") -> "Ring":
        """Ring over moduli ++ other.moduli (the QP ring: every op is
        limb-wise, so Q and P limbs ride through one batched call). Both
        rings must have the same dist setting."""
        if self.logn != other.logn or self.device != other.device:
            raise ValueError("rings differ in degree or device")
        if (self.dist is None) != (other.dist is None):
            raise ValueError("one ring is coefficient-sharded, the other "
                             "not: give both the same with_dist")
        return Ring(moduli=self.moduli + other.moduli, logn=self.logn,
                    device=self.device,
                    dist=None if self.dist is None
                    else self.dist.concat(other.dist),
                    **{k: torch.cat([getattr(self, k), getattr(other, k)])
                       for k in TABLE_FIELDS})

    # -- broadcast helper ---------------------------------------------------

    @staticmethod
    def _c(arr):
        """(L,) constant -> (L, 1), broadcasting against (..., L, N)."""
        return arr[:, None]

    # -- pointwise ops (all on (..., L, N), canonical in [0, q)) ------------

    def zero(self, *batch) -> torch.Tensor:
        """The zero polynomial, (*batch, L, N), on the ring's device."""
        return torch.zeros((*batch, self.nlimbs, self.n), dtype=torch.int64,
                           device=self.device)

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

    def from_mont(self, a):
        """Montgomery-form a (any u32) -> canonical a * 2^-32 mod q."""
        return mm.from_mont(a, self._c(self.q), self._c(self.r_inv))

    def mul_scalar_mont(self, a, s_mont):
        """Multiply by per-limb scalars in Montgomery form, shape (L,)."""
        return mm.mont_mul(a, self._c(s_mont), self._c(self.q),
                           self._c(self.r_inv))

    # -- NTT ----------------------------------------------------------------

    def split_tables(self) -> SplitTables:
        """The split NTT's tables (built on first use, then cached)."""
        return _split_tables(self.moduli, self.logn, self.device)

    def _split(self) -> bool:
        return config.ntt_mxu_tail and self.logn >= SPLIT_MIN_LOGN

    def full_forward(self) -> bool:
        """Whether ntt launches ntt_cuda.ntt's full forward kernel (no
        dist setting, the split NTT off)."""
        return self.dist is None and not self._split()

    def ntt(self, a):
        """Forward negacyclic NTT over (..., L, N): standard coefficient
        order in, bit-reversed evaluation order out, canonical. Accepts
        any u32 input (it is reduced first), so it also covers the JAX
        package's ntt(reduce_input=True). A ring with a dist setting takes
        the local chunk (..., L, N / C) and runs the sharded transform
        (before the split's switch, as in the JAX package)."""
        a = a.contiguous()
        if self.full_forward():
            return ntt_cuda.ntt(a, self.q, self.bar, self.psi, self.psi_sh,
                                self.psi_pack)
        if self.dist is not None:
            from ..parallel import dist_ntt
            return dist_ntt.ntt_in_shard(self, a, inverse=False)
        return ntt_cuda.ntt_split_fwd(a, self.q, self.r_inv,
                                      self.split_tables())

    def intt(self, a):
        """Inverse negacyclic NTT: bit-reversed in, standard order out,
        canonical. Accepts any u32 input, which covers the lazy (< 8q)
        inputs of the JAX package's intt(reduce_input=True). Sharded
        like ntt for a ring with a dist setting."""
        a = a.contiguous()
        if self.dist is not None:
            from ..parallel import dist_ntt
            return dist_ntt.ntt_in_shard(self, a, inverse=True)
        if self._split():
            return ntt_cuda.ntt_split_inv(a, self.q, self.bar, self.r_inv,
                                          self.split_tables())
        return ntt_cuda.intt(a, self.q, self.bar, self.ipsi, self.ipsi_sh,
                             self.ninv, self.ninv_sh, self.ipsi_pack)

    # -- automorphisms ------------------------------------------------------

    def permute_coeffs(self, a, gal: int):
        """Apply X -> X^gal to coefficient-domain polys (..., L, N)."""
        src, sign = coeff_perm(self.logn, gal, self.device)
        g = a.index_select(-1, src)
        return torch.where(sign, self.neg(g), g)

    def permute_ntt(self, a, gal: int):
        """Apply X -> X^gal to NTT-domain polys (pure gather, no signs)."""
        return a.index_select(-1, ntt_perm(self.logn, gal, self.device))


@functools.lru_cache(maxsize=None)
def _coeff_perm_host(logn: int, gal: int):
    """Coefficient-domain Galois map X -> X^gal (odd gal): (src, sign)
    with out[j] = (-1)^sign[j] * in[src[j]], int32 and uint32 arrays equal
    to mkhe_tpu.ops.ring._coeff_perm_host's (the sign fold of the
    reference's Rotate, mkrlwe/keyswitch.go:266-296)."""
    n = 1 << logn
    i = np.arange(n, dtype=np.int64)
    raw = i * gal
    j = raw & (n - 1)
    src = np.empty(n, np.int32)
    sign = np.empty(n, np.uint32)
    src[j] = i
    sign[j] = (raw >> logn) & 1
    return src, sign


@functools.lru_cache(maxsize=None)
def _ntt_perm_host(logn: int, gal: int) -> np.ndarray:
    """NTT-domain (bit-reversed order) permutation for X -> X^gal (odd
    gal): out[j] = in[pi[j]], int32, equal to
    mkhe_tpu.ops.ring._ntt_perm_host's (lattigo's PermuteNTTIndex). Slot j
    holds the evaluation at psi^e, e = 2 brv(j) + 1; X^gal moves it to
    the slot of e * gal mod 2N."""
    n = 1 << logn
    e = 2 * _brv_vec(logn) + 1
    slot_of = np.empty(2 * n, np.int64)
    slot_of[e] = np.arange(n)
    return slot_of[(e * gal) % (2 * n)].astype(np.int32)


@functools.lru_cache(maxsize=None)
def coeff_perm(logn: int, gal: int, device: torch.device):
    """_coeff_perm_host as (src int64, sign bool) tensors on the device."""
    src, sign = _coeff_perm_host(logn, gal)
    return (torch.from_numpy(src.astype(np.int64)).to(device),
            torch.from_numpy(sign.astype(bool)).to(device))


@functools.lru_cache(maxsize=None)
def ntt_perm(logn: int, gal: int, device: torch.device) -> torch.Tensor:
    """_ntt_perm_host as an int64 index tensor on the device."""
    return torch.from_numpy(_ntt_perm_host(logn, gal).astype(np.int64)
                            ).to(device)


def galois_element_rot(k: int, n: int) -> int:
    """Galois element of a rotation of the CKKS slots by k (generator 5),
    lattigo's GaloisElementForColumnRotationBy."""
    return pow(5, k, 2 * n)


def galois_element_conj(n: int) -> int:
    """Galois element of conjugation (row rotation): 2N - 1."""
    return 2 * n - 1


@functools.lru_cache(maxsize=None)
def _create(moduli: Tuple[int, ...], logn: int, device: torch.device
            ) -> Ring:
    t = _host_tables(moduli, logn)
    return Ring(moduli=moduli, logn=logn, device=device,
                **{k: torch.from_numpy(t[k]).to(device)
                   for k in TABLE_FIELDS})
