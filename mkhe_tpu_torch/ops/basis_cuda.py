"""Key-switching element-wise kernels: their tables, launchers, launch
counters, device routing and plain PyTorch versions.

The kernels of csrc/keyswitch.cu are the port's counterpart of what XLA
fuses out of the JAX package's key switching (they have no Pallas
counterpart):

  mod_up     basis_kernel<.., false>: the exact basis extension of
             mkhe_tpu/ops/basis.py:93-154 (float32 v-correction, every
             Ls), with a digit axis: `decompose` gives all beta digits of
             decompose_digits (:202-230) in one launch; a digit of more
             than WIDE_ALPHA limbs (BFV's 28) takes the kernel's wide
             body (a thread per coefficient and group of WIDE_GROUP
             output limbs; `wide_geometry`);
  mod_down   basis_kernel<.., true>: basis.py:179-199, the P -> Q
             extension and (xq - conv) * P^-1 in one pass;
  mul_accum  mul_accum_kernel: (sum_t a_t * b_t) * 2^-32 mod q over term
             axes of strided, broadcast views (mkhe_tpu/mkrlwe/
             keyswitch.py:82-175, ops/modmath.py:207-227), the contraction
             of _aggregate_keys, external_product_ntt and _sum_parties_ntt;
  rescale    rescale_kernel: the CKKS rescale, mkhe_tpu/ops/basis.py's
             div_round_by_last_moduli, every dropped limb in one pass;
  tensor     tensor_kernel: the mult's tensor terms in the NTT domain
             (mkhe_tpu/mkrlwe/keyswitch.py:274-289, `tensor_terms`), each
             operand row read once, every output reduced once.

and of csrc/ntt.cu's decompose_ntt_kernel, the gadget digits and their
forward NTT in one launch (`decompose_ntt`: ring.ntt(decompose(x)) bit for
bit, without the digit tensor in between), which ops/basis.py::
decompose_ntt takes for the main path's digits (two limbs, logN 14 or 15)
wherever the ring's ntt is the full forward kernel.

Every wrapper dispatches on the tensor's device: a CPU tensor goes to the
plain version (`mod_up_plain`, `decompose_plain`, `decompose_ntt_plain`,
`mod_down_plain`, `mul_accum_plain`, `rescale_plain`, `tensor_terms_plain`:
the int64 torch code the port ran before the kernels, unchanged in
result), a CUDA tensor
launches the kernel or raises. There is no fallback from one to the
other. The
wrappers check shapes and devices on both routes, allocate outputs with
torch and launch on the current stream without a host sync, so a launch
can be captured into a CUDA graph (fuse.py); the tables are built once
per basis (lru_cache), by the first call, which the capture's warm-up
makes.

The kernels are built with the NTT kernels into one library
(ntt_cuda.build: every csrc/*.cu) and loaded with ctypes.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import itertools
import math
from typing import Tuple

import numpy as np
import torch

from . import modmath as mm
from . import ntt_cuda
from .ring import Ring

MAX_Q = 1 << 29      # products of two residues < 2^58: 64 fit a u64
MAX_LIMBS = 64       # the kernel's digit width (alpha) and output limbs
FOLD = 32            # mul_accum_kernel: terms between two folds of the sum
TERM_AXES, OUTER_AXES = 2, 3   # mul_accum_kernel's axes, after merging
MAX_DROP = 8         # rescale_kernel: the dropped limbs it holds in registers
MAX_RESCALE_WORDS = 12288   # its table, (2 + 3 nb) L words, in 48 KiB
MAX_TENSOR_OUT = 32  # tensor_kernel: outputs a launch's row map holds
WIDE_ALPHA = 8       # basis_kernel: wider digits take its wide body
WIDE_GROUP = 7       # the wide body: output limbs a thread
WIDE_STRIDE = 8      # its words a group of a qhat row in shared memory
WIDE_COEFFS = 64     # its coefficients a block
THREADS = 256        # basis_kernel's threads a block
U32 = 1 << 32

# Kernel launches since the last reset_counters(); only a launch of the
# CUDA kernel counts, never a call of the plain version.
mod_up_launches = 0
mod_down_launches = 0
mul_accum_launches = 0
rescale_launches = 0
decompose_ntt_launches = 0
tensor_launches = 0
basis_wide_launches = 0


def reset_counters() -> None:
    global mod_up_launches, mod_down_launches, mul_accum_launches
    global rescale_launches, decompose_ntt_launches, tensor_launches
    global basis_wide_launches
    mod_up_launches = mod_down_launches = mul_accum_launches = 0
    rescale_launches = decompose_ntt_launches = tensor_launches = 0
    basis_wide_launches = 0


def counters() -> dict:
    """Launches of each kernel since the last reset_counters()
    (`decompose_ntt`: the fused digits; a decomposition that takes the
    composition counts one `mod_up` and one `ntt_fwd` instead; `tensor`:
    one a mult's tensor terms up to MAX_TENSOR_OUT - 1 parties;
    `basis_wide`: the mod_up and mod_down launches that took the basis
    kernel's wide body, four a BFV mult)."""
    return {"mod_up": mod_up_launches, "mod_down": mod_down_launches,
            "mul_accum": mul_accum_launches, "rescale": rescale_launches,
            "decompose_ntt": decompose_ntt_launches,
            "tensor": tensor_launches, "basis_wide": basis_wide_launches}


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The kernel library (ntt_cuda.load builds it), with these kernels'
    entry points typed."""
    lib = ntt_cuda.load()
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mkhe_basis.argtypes = [vp, ll, ll, vp, ll, ll, vp, vp, ll] + \
        [ci] * 6 + [vp]
    lib.mkhe_basis.restype = ci
    lib.mkhe_mul_accum.argtypes = [vp, vp, vp, vp, ctypes.POINTER(ll), ci,
                                   ci, vp]
    lib.mkhe_mul_accum.restype = ci
    lib.mkhe_rescale.argtypes = [vp, ll, ll, vp, vp, ll, ci, ci, ci, vp]
    lib.mkhe_rescale.restype = ci
    lib.mkhe_decompose_ntt.argtypes = [vp, ll, ll] + [vp] * 5 + \
        [ci] * 10 + [vp]
    lib.mkhe_decompose_ntt.restype = ci
    lib.mkhe_tensor.argtypes = [vp, vp, vp, vp, ctypes.POINTER(ci), ci, ll,
                                ci, ci, vp]
    lib.mkhe_tensor.restype = ci
    return lib


# ----------------------------------------------------------------------------
# Tables
# ----------------------------------------------------------------------------

def _check_moduli(moduli) -> None:
    bad = [q for q in moduli if not (2 < q < MAX_Q and q % 2)]
    if bad:
        raise ValueError(f"the key-switching kernels take odd moduli "
                         f"below 2^29, got {bad}")


def _qinv_neg(q: int) -> int:
    """-q^-1 mod 2^32, the kernels' Montgomery constant."""
    return -pow(q, -1, U32) % U32


def _limb_words(q: int, extra: int = 0) -> tuple:
    """A modulus's four kernel words: q, -q^-1 mod 2^32, floor(2^32 / q)
    and `extra` (P^-1 in Montgomery form for ModDown, 2^64 mod q in
    limb_tables)."""
    return q, _qinv_neg(q), U32 // q, extra


def pack_table(src, dst, alpha: int, pinv=None) -> np.ndarray:
    """The basis kernel's u32 words for extending the digits of `src`
    (alpha limbs each, the last one possibly fewer) to `dst`, and with
    `pinv` (P^-1 mod d_j, Montgomery form, ModDown) in the dst words.
    Layout (csrc/keyswitch.cu, "Table words"): 4 words per dst modulus
    (_limb_words), then per digit k with product B_k, ds = 4 alpha +
    alpha Ld + Ld (alpha + 1) words: 4 per source limb i (b_i, -b_i^-1 mod
    2^32, (B_k/b_i)^-1 mod b_i in Montgomery form, float32 bits of 1/b_i),
    then B_k/b_i mod d_j in Montgomery form at i Ld + j, then v B_k mod d_j
    at j (alpha + 1) + v."""
    src, dst = tuple(src), tuple(dst)
    _check_moduli(src + dst)
    ls, ld = len(src), len(dst)
    if not (1 <= alpha <= MAX_LIMBS and 1 <= ld <= MAX_LIMBS and ls >= 1):
        raise ValueError(f"the basis kernel takes 1..{MAX_LIMBS} limbs a "
                         f"digit and 1..{MAX_LIMBS} output limbs, got "
                         f"alpha {alpha}, {ld} output limbs")
    beta = -(-ls // alpha)
    ds = 4 * alpha + alpha * ld + ld * (alpha + 1)
    t = np.zeros(4 * ld + beta * ds, np.uint64)
    for j, d in enumerate(dst):
        t[4 * j:4 * j + 4] = _limb_words(d, 0 if pinv is None else pinv[j])
    for k in range(beta):
        digit = src[k * alpha:(k + 1) * alpha]
        big_b = math.prod(digit)
        inv_b = (1.0 / np.array(digit, np.float64)).astype(np.float32)
        base = 4 * ld + k * ds
        qhat, vq = base + 4 * alpha, base + 4 * alpha + alpha * ld
        for i, b in enumerate(digit):
            bhat = big_b // b
            t[base + 4 * i:base + 4 * i + 4] = (
                b, _qinv_neg(b), mm.to_mont_host(pow(bhat % b, -1, b), b),
                int(inv_b[i:i + 1].view(np.uint32)[0]))
            for j, d in enumerate(dst):
                t[qhat + i * ld + j] = mm.to_mont_host(bhat % d, d)
        for j, d in enumerate(dst):
            for v in range(len(digit) + 1):
                t[vq + j * (alpha + 1) + v] = v * big_b % d
    return t.astype(np.uint32)


def _device_words(words: np.ndarray, device) -> torch.Tensor:
    """u32 words as an int32 tensor on the device (the kernels read u32)."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(
        device)


def _i64(xs, device) -> torch.Tensor:
    return torch.tensor(list(xs), dtype=torch.int64, device=device)


@dataclasses.dataclass(frozen=True)
class ModUpTables:
    """Tables for exact base conversion from src basis B to dst basis D:
    the plain version's int64 ones and the kernel's packed words."""
    src_moduli: Tuple[int, ...]
    dst_moduli: Tuple[int, ...]
    qhat_inv_mont: torch.Tensor   # (Ls,) (B/b_i)^-1 mod b_i, Montgomery
    qhat_dst_mont: torch.Tensor   # (Ls, Ld) B/b_i mod d_j, Montgomery
    vq_dst: torch.Tensor          # (Ld, Ls+1) v*B mod d_j for v = 0..Ls
    inv_b_f32: torch.Tensor       # (Ls,) float32 1/b_i
    src_q: torch.Tensor           # (Ls,) b_i
    src_r_inv: torch.Tensor       # (Ls,) 2^-32 mod b_i
    dst_q: torch.Tensor           # (Ld,) d_j
    dst_r_inv: torch.Tensor       # (Ld,) 2^-32 mod d_j
    pack: torch.Tensor            # pack_table(src, dst, Ls), int32


@functools.lru_cache(maxsize=None)
def mod_up_tables(src: Tuple[int, ...], dst: Tuple[int, ...],
                  device: torch.device) -> ModUpTables:
    B = math.prod(src)
    ls, ld = len(src), len(dst)
    qhat_inv = np.empty(ls, np.int64)
    qhat_dst = np.empty((ls, ld), np.int64)
    for i, bi in enumerate(src):
        bhat = B // bi
        qhat_inv[i] = mm.to_mont_host(pow(bhat % bi, -1, bi), bi)
        for j, dj in enumerate(dst):
            qhat_dst[i, j] = mm.to_mont_host(bhat % dj, dj)
    vq = np.array([[(v * B) % dj for v in range(ls + 1)] for dj in dst],
                  np.int64)
    inv_b = (1.0 / np.array(src, np.float64)).astype(np.float32)
    return ModUpTables(
        src_moduli=src, dst_moduli=dst,
        qhat_inv_mont=torch.from_numpy(qhat_inv).to(device),
        qhat_dst_mont=torch.from_numpy(qhat_dst).to(device),
        vq_dst=torch.from_numpy(vq).to(device),
        inv_b_f32=torch.from_numpy(inv_b).to(device),
        src_q=_i64(src, device),
        src_r_inv=_i64((mm.mont_constants(b)[0] for b in src), device),
        dst_q=_i64(dst, device),
        dst_r_inv=_i64((mm.mont_constants(d)[0] for d in dst), device),
        pack=_device_words(pack_table(src, dst, ls), device))


@dataclasses.dataclass(frozen=True)
class DigitTables:
    """The gadget digits of src (alpha limbs each, the last possibly
    fewer), each extended to dst: one ModUpTables a digit for the plain
    version, and all digits' words in one table for the kernel."""
    alpha: int
    digits: Tuple[ModUpTables, ...]
    pack: torch.Tensor            # pack_table(src, dst, alpha), int32


@functools.lru_cache(maxsize=None)
def digit_tables(src: Tuple[int, ...], dst: Tuple[int, ...], alpha: int,
                 device: torch.device) -> DigitTables:
    return DigitTables(
        alpha=alpha,
        digits=tuple(mod_up_tables(src[lo:lo + alpha], dst, device)
                     for lo in range(0, len(src), alpha)),
        pack=_device_words(pack_table(src, dst, alpha), device))


@dataclasses.dataclass(frozen=True)
class ModDownTables:
    """Divide-and-round by P from QP to Q: the P -> Q extension and
    P^-1 mod q_j (Montgomery form) for the plain version, and the
    extension's words with P^-1 in the dst words for the kernel."""
    up: ModUpTables
    pinv_mont: torch.Tensor       # (Lq,)
    pack: torch.Tensor            # pack_table(pm, qm, Lp, pinv), int32


@functools.lru_cache(maxsize=None)
def mod_down_tables(qm: Tuple[int, ...], pm: Tuple[int, ...],
                    device: torch.device) -> ModDownTables:
    P = math.prod(pm)
    pinv = [mm.to_mont_host(pow(P % q, -1, q), q) for q in qm]
    return ModDownTables(
        up=mod_up_tables(pm, qm, device), pinv_mont=_i64(pinv, device),
        pack=_device_words(pack_table(pm, qm, len(pm), pinv), device))


@dataclasses.dataclass(frozen=True)
class LimbTables:
    """Per-limb constants of a contraction and of the tensor terms: q
    and 2^-32 mod q (plain), (L, 4) kernel words (_limb_words with 2^64
    mod q, which takes the tensor kernel's Montgomery residue back to the
    plain one)."""
    q: torch.Tensor
    r_inv: torch.Tensor
    pack: torch.Tensor


@functools.lru_cache(maxsize=None)
def limb_tables(moduli: Tuple[int, ...], device: torch.device
                ) -> LimbTables:
    _check_moduli(moduli)
    words = np.array([_limb_words(q, (1 << 64) % q) for q in moduli],
                     np.uint64)
    return LimbTables(
        q=_i64(moduli, device),
        r_inv=_i64((mm.mont_constants(q)[0] for q in moduli), device),
        pack=_device_words(words.astype(np.uint32), device))


def rescale_table(moduli, nb: int) -> np.ndarray:
    """rescale_kernel's u32 words for dropping the last nb of `moduli`
    (csrc/keyswitch.cu, "Table words"): 2 per limb j (q_j, floor(2^32 /
    q_j)), then 3 per step s and limb j (q_j + floor(q_l / 2) mod q_j,
    q_l^-1 mod q_j and its Shoup word, for the dropped l = L-1-s and j <
    l; 0 for j >= l)."""
    moduli = tuple(moduli)
    _check_moduli(moduli)
    L = len(moduli)
    if not (1 <= nb <= MAX_DROP and nb < L
            and (2 + 3 * nb) * L <= MAX_RESCALE_WORDS):
        raise ValueError(f"the rescale kernel drops 1..{MAX_DROP} of L > nb "
                         f"limbs, (2 + 3 nb) L <= {MAX_RESCALE_WORDS}; got "
                         f"nb {nb} of {L}")
    t = np.zeros((2 + 3 * nb) * L, np.uint64)
    for j, q in enumerate(moduli):
        t[2 * j:2 * j + 2] = q, U32 // q
    for s in range(nb):
        ql = moduli[L - 1 - s]
        for j, q in enumerate(moduli[:L - 1 - s]):
            inv = pow(ql % q, -1, q)
            w = 2 * L + 3 * (s * L + j)
            t[w:w + 3] = q + (ql >> 1) % q, inv, mm.shoup_host(inv, q)
    return t.astype(np.uint32)


@functools.lru_cache(maxsize=None)
def rescale_words(moduli: Tuple[int, ...], nb: int, device: torch.device
                  ) -> torch.Tensor:
    """rescale_table on the device (int32), built once per (moduli, nb,
    device), by the first call."""
    return _device_words(rescale_table(moduli, nb), device)


@functools.lru_cache(maxsize=None)
def _rescale_consts(moduli: Tuple[int, ...], nb: int, device: torch.device):
    """rescale_plain's constants. For each of the nb dropped limbs (from
    the top): (half = q_last//2, half mod q_j for the remaining j,
    q_last^-1 mod q_j in Montgomery)."""
    steps = []
    mods = list(moduli)
    for _ in range(nb):
        ql = mods.pop()
        half = ql >> 1
        half_rem = torch.tensor([half % q for q in mods], dtype=torch.int64,
                                device=device)
        qlinv = torch.tensor([mm.to_mont_host(pow(ql % q, -1, q), q)
                              for q in mods], dtype=torch.int64,
                             device=device)
        steps.append((half, half_rem, qlinv))
    return steps


# ----------------------------------------------------------------------------
# Argument plans (shared by both routes, so the CPU tests check them)
# ----------------------------------------------------------------------------

def _route(x) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU tensor (plain)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no key-switching kernel for device {x.device}")


def _check_on(x, *tables) -> None:
    if x.dtype != torch.int64:
        raise TypeError(f"the key-switching kernels take int64, got "
                        f"{x.dtype}")
    for t in tables:
        if t.device != x.device:
            raise ValueError(f"tables on {t.device}, data on {x.device}")


def _check_limbs(x, limbs: int) -> None:
    if x.dim() < 2 or x.shape[-2] != limbs:
        raise ValueError(f"want (..., {limbs}, N), got {tuple(x.shape)}")


def polys(x, limbs: int) -> torch.Tensor:
    """x (..., limbs, N) as a (P, limbs, N) view with N contiguous, as the
    basis kernel reads it (a copy only where the leading axes do not
    flatten)."""
    _check_limbs(x, limbs)
    x3 = x if x.dim() == 3 else x.reshape(math.prod(x.shape[:-2]), limbs,
                                          x.shape[-1])
    if x3.shape[-1] > 1 and x3.stride(-1) != 1:
        x3 = x3.contiguous()
    return x3


_NO_GUARD = contextlib.nullcontext()


def _on(device):
    """(device guard, the device's current stream as a raw pointer) for a
    launch; the guard is a shared no-op where the device is the current
    one (a guard and torch.cuda.current_stream took ~6 us of host a
    launch on an H100 machine's host)."""
    guard = (_NO_GUARD if device.index == torch.cuda.current_device()
             else torch.cuda.device(device))
    return guard, torch._C._cuda_getCurrentRawStream(device.index)


def _launch_basis(x3, xq3, pack, alpha: int, beta: int, ld: int):
    """One launch of the basis kernel over x3 (P, Ls, N) (and xq3 (P, ld,
    N) for ModDown): out (P, beta, ld, N)."""
    global basis_wide_launches
    n_polys, ls, n = x3.shape
    out = torch.empty((n_polys, beta, ld, n), dtype=torch.int64,
                      device=x3.device)
    if out.numel() == 0:
        return out
    down = xq3 is not None
    guard, stream = _on(x3.device)
    with guard:
        err = load().mkhe_basis(
            x3.data_ptr(), x3.stride(0), x3.stride(1),
            xq3.data_ptr() if down else None,
            xq3.stride(0) if down else 0, xq3.stride(1) if down else 0,
            out.data_ptr(), pack.data_ptr(), n_polys, ls, alpha, beta, ld,
            n, int(down), stream)
    if err != 0:
        raise RuntimeError(f"mkhe_basis launch failed: CUDA error {err}")
    if alpha > WIDE_ALPHA:
        basis_wide_launches += 1
    return out


@dataclasses.dataclass(frozen=True)
class WideGeometry:
    """The basis kernel's wide body at digit width alpha and ld output
    limbs (csrc/keyswitch.cu::basis_wide): `groups` groups of WIDE_GROUP
    output limbs, a qhat row of `row` words (WIDE_STRIDE a group), and
    the offsets of its shared arrays in words (dst, src, qh, vq, ys, vs;
    `words` in all)."""
    groups: int
    row: int
    src: int
    qh: int
    vq: int
    ys: int
    vs: int
    words: int


def wide_geometry(alpha: int, ld: int) -> WideGeometry:
    groups = -(-ld // WIDE_GROUP)
    row = groups * WIDE_STRIDE
    src = 4 * ld
    qh = src + 4 * alpha
    vq = qh + alpha * row
    ys = vq + ld * (alpha + 1)
    vs = ys + alpha * WIDE_COEFFS
    return WideGeometry(groups, row, src, qh, vq, ys, vs, vs + WIDE_COEFFS)


@dataclasses.dataclass(frozen=True)
class Contraction:
    """mul_accum_kernel's launch: output shape (*outer, L, N), and the 17
    values it reads: term sizes (2), outer sizes (3), then a's strides
    (terms 2, outer 3, limb) and b's alike (csrc/keyswitch.cu::
    mkhe_mul_accum)."""
    out_shape: Tuple[int, ...]
    dims: Tuple[int, ...]


def _merge(sizes, sa, sb) -> list:
    """(size, a stride, b stride) of each axis, size-1 axes dropped and
    neighbours that step alike in both operands merged."""
    out = []
    for s, x, y in zip(sizes, sa, sb):
        if s == 1:
            continue
        if out and out[-1][1] == s * x and out[-1][2] == s * y:
            out[-1] = (out[-1][0] * s, x, y)
        else:
            out.append((s, x, y))
    return out


def contraction_plan(a, b, nterms: int, L: int) -> Contraction:
    """The contraction of a (T..., *outer_a, L, N) and b (T..., *outer_b,
    L, N) over their first `nterms` axes (broadcast against each other),
    the rest broadcast like torch (outer_a against outer_b): the strides
    the kernel reads, broadcast axes at stride 0 (no copy)."""
    if nterms < 1 or a.dim() < nterms + 2 or b.dim() < nterms + 2:
        raise ValueError(f"want (terms..., ..., L, N) operands with "
                         f"{nterms} term axes, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    n = a.shape[-1]
    if a.shape[-2:] != (L, n) or b.shape[-2:] != (L, n):
        raise ValueError(f"operands {tuple(a.shape)} and {tuple(b.shape)}"
                         f" must end in ({L}, N) alike")
    terms = tuple(torch.broadcast_shapes(a.shape[:nterms], b.shape[:nterms]))
    outer = tuple(torch.broadcast_shapes(a.shape[nterms:-2],
                                         b.shape[nterms:-2]))
    if math.prod(terms) == 0:
        raise ValueError("a contraction needs at least one term")

    def full(x):
        idx = ((slice(None),) * nterms
               + (None,) * (len(outer) - (x.dim() - nterms - 2)))
        return x[idx].expand(*terms, *outer, L, n)

    fa, fb = full(a), full(b)
    if n > 1 and (fa.stride(-1) != 1 or fb.stride(-1) != 1):
        raise ValueError("mul_accum takes operands with N contiguous")
    nt = len(terms)
    tax = _merge(terms, fa.stride()[:nt], fb.stride()[:nt])
    oax = _merge(outer, fa.stride()[nt:-2], fb.stride()[nt:-2])
    if len(tax) > TERM_AXES or len(oax) > OUTER_AXES:
        raise ValueError(f"mul_accum takes {TERM_AXES} term and "
                         f"{OUTER_AXES} outer axes that do not merge, got "
                         f"{len(tax)} and {len(oax)}")
    tax = [(1, 0, 0)] * (TERM_AXES - len(tax)) + tax
    oax = [(1, 0, 0)] * (OUTER_AXES - len(oax)) + oax
    dims = ([s for s, _, _ in tax] + [s for s, _, _ in oax]
            + [x for _, x, _ in tax] + [x for _, x, _ in oax]
            + [fa.stride(-2)]
            + [y for _, _, y in tax] + [y for _, _, y in oax]
            + [fb.stride(-2)])
    return Contraction(out_shape=(*outer, L, n), dims=tuple(dims))


# ----------------------------------------------------------------------------
# Wrappers
# ----------------------------------------------------------------------------

def mod_up(x, t: ModUpTables) -> torch.Tensor:
    """Convert (..., Ls, N) in basis src (any u32 values) to canonical
    (..., Ld, N) in basis dst (the lifted integer is the input's
    representative in [0, B) up to a rare +-B, ops/basis.py). Kernel on a
    CUDA tensor (one launch), `mod_up_plain` on a CPU tensor."""
    global mod_up_launches
    ls, ld = len(t.src_moduli), len(t.dst_moduli)
    _check_on(x, t.pack)
    _check_limbs(x, ls)
    if not _route(x):
        return mod_up_plain(x, t)
    out = _launch_basis(polys(x, ls), None, t.pack, ls, 1, ld)
    mod_up_launches += 1
    return out.view(*x.shape[:-2], ld, x.shape[-1])


def decompose(x, t: DigitTables) -> torch.Tensor:
    """The gadget digits of coefficient-domain (..., Ls, N): digit k is
    limbs [k alpha, min((k+1) alpha, Ls)) extended to dst, canonical
    (..., beta, Ld, N). One kernel launch for every digit on a CUDA
    tensor, `decompose_plain` on a CPU tensor."""
    global mod_up_launches
    ls = sum(len(d.src_moduli) for d in t.digits)
    beta, ld = len(t.digits), len(t.digits[0].dst_moduli)
    _check_on(x, t.pack)
    _check_limbs(x, ls)
    if not _route(x):
        return decompose_plain(x, t)
    out = _launch_basis(polys(x, ls), None, t.pack, t.alpha, beta, ld)
    mod_up_launches += 1
    return out.view(*x.shape[:-2], beta, ld, x.shape[-1])


DECOMPOSE_NTT_LOGNS = (14, 15)   # decompose_ntt_kernel's instantiations


def decompose_ntt(x, t: DigitTables, ring: Ring) -> torch.Tensor:
    """The gadget digits of coefficient-domain (..., Ls, N), each extended
    to the ring's basis (t's dst) and in its NTT domain, canonical
    (..., beta, Ld, N): ntt_cuda.ntt of decompose(x, t), bit for bit. On a
    CUDA tensor one launch of csrc/ntt.cu's decompose_ntt_kernel (the
    forward kernel with the digits computed in its first pass: they never
    reach device memory; x read by its strides, so a level-dropped view is
    read in place), which takes digits of two limbs at a logN of
    DECOMPOSE_NTT_LOGNS and raises otherwise; `decompose_ntt_plain` on a
    CPU tensor."""
    global decompose_ntt_launches
    ls = sum(len(d.src_moduli) for d in t.digits)
    beta, ld = len(t.digits), len(t.digits[0].dst_moduli)
    _check_on(x, t.pack, ring.q)
    _check_limbs(x, ls)
    if ring.moduli != t.digits[0].dst_moduli:
        raise ValueError("decompose_ntt: the ring is not the digits' "
                         "destination basis")
    if not _route(x):
        return decompose_ntt_plain(x, t, ring)
    if t.alpha != 2 or ring.logn not in DECOMPOSE_NTT_LOGNS:
        raise ValueError(f"decompose_ntt: the kernel takes digits of two "
                         f"limbs at logN {DECOMPOSE_NTT_LOGNS}, not alpha "
                         f"{t.alpha} at logN {ring.logn}")
    x3 = polys(x, ls)
    n_polys, _, n = x3.shape
    out = torch.empty((n_polys, beta, ld, n), dtype=torch.int64,
                      device=x.device)
    shape = ntt_cuda._check_full(out, (ring.psi, ring.psi_sh), ring.psi_pack,
                                 (ring.q, ring.bar))
    if out.numel():
        geom = ntt_cuda.geometry(shape[2], shape[0])
        guard, stream = _on(x.device)
        with guard:
            err = load().mkhe_decompose_ntt(
                x3.data_ptr(), x3.stride(0), x3.stride(1), out.data_ptr(),
                ring.psi_pack.data_ptr(), ring.q.data_ptr(),
                ring.bar.data_ptr(), t.pack.data_ptr(), ls, t.alpha, beta,
                shape[0], ld, shape[2], geom.log_polys, geom.blocks,
                geom.threads, geom.smem, stream)
        if err != 0:
            raise RuntimeError(f"mkhe_decompose_ntt launch failed: CUDA "
                               f"error {err}")
        decompose_ntt_launches += 1
    return out.view(*x.shape[:-2], beta, ld, n)


def mod_down(xq, xp, t: ModDownTables) -> torch.Tensor:
    """Divide-and-round by P: (xq, xp) (..., Lq, N) and (..., Lp, N) in
    basis QP, canonical (any u32 on xq) -> round(x / P) in basis Q,
    (..., Lq, N) canonical. Kernel on a CUDA tensor (one launch),
    `mod_down_plain` on a CPU tensor."""
    global mod_down_launches
    lp, lq = len(t.up.src_moduli), len(t.up.dst_moduli)
    _check_on(xq, t.pack)
    _check_on(xp, t.pack)
    if xq.shape[:-2] != xp.shape[:-2] or xq.shape[-1] != xp.shape[-1]:
        raise ValueError(f"ModDown of {tuple(xq.shape)} and "
                         f"{tuple(xp.shape)}: the Q and P parts differ")
    _check_limbs(xq, lq)
    _check_limbs(xp, lp)
    if not _route(xq):
        return mod_down_plain(xq, xp, t)
    out = _launch_basis(polys(xp, lp), polys(xq, lq), t.pack, lp, 1, lq)
    mod_down_launches += 1
    return out.view(xq.shape)


def mul_accum(a, b, nterms: int, t: LimbTables) -> torch.Tensor:
    """(sum_t a[t] * b[t]) * 2^-32 mod q_l, canonical (..., L, N), over
    the first `nterms` axes of a (T..., *outer_a, L, N) and b (T...,
    *outer_b, L, N) (contraction_plan: strided views, broadcast axes
    read in place). Operands canonical (< q). Kernel on a CUDA tensor
    (one launch), `mul_accum_plain` on a CPU tensor."""
    global mul_accum_launches
    _check_on(a, b, t.pack)
    L = t.q.shape[0]
    plan = contraction_plan(a, b, nterms, L)
    if not _route(a):
        return mul_accum_plain(a, b, nterms, t)
    out = torch.empty(plan.out_shape, dtype=torch.int64, device=a.device)
    if out.numel() == 0:
        return out
    dims = (ctypes.c_longlong * len(plan.dims))(*plan.dims)
    guard, stream = _on(a.device)
    with guard:
        err = load().mkhe_mul_accum(a.data_ptr(), b.data_ptr(),
                                    out.data_ptr(), t.pack.data_ptr(), dims,
                                    L, a.shape[-1], stream)
    if err != 0:
        raise RuntimeError(f"mkhe_mul_accum launch failed: CUDA error {err}")
    mul_accum_launches += 1
    return out


def rescale(x, ring_q: Ring, nb: int) -> torch.Tensor:
    """round(x / (q_{L-nb} ... q_{L-1})) of canonical coefficient-domain
    (..., L, N) over ring_q's L moduli: canonical (..., L-nb, N) over the
    first L-nb (Lattigo's DivRoundByLastModulusMany). Kernel on a CUDA
    tensor (one launch; x by its polynomial and limb strides, so a
    level-dropped view is read in place), `rescale_plain` on a CPU
    tensor."""
    global rescale_launches
    L = ring_q.nlimbs
    _check_on(x, ring_q.q)
    _check_limbs(x, L)
    if not 1 <= nb < L:
        raise ValueError(f"a rescale drops 1..{L - 1} of {L} limbs, got {nb}")
    if not _route(x):
        return rescale_plain(x, ring_q, nb)
    words = rescale_words(ring_q.moduli, nb, x.device)
    x3 = polys(x, L)
    n_polys, _, n = x3.shape
    # (..., L-nb, N) contiguous is the kernel's (P, L-nb, N)
    out = torch.empty((*x.shape[:-2], L - nb, n), dtype=torch.int64,
                      device=x.device)
    if out.numel():
        guard, stream = _on(x.device)
        with guard:
            err = load().mkhe_rescale(x3.data_ptr(), x3.stride(0),
                                      x3.stride(1), out.data_ptr(),
                                      words.data_ptr(), n_polys, L, nb, n,
                                      stream)
        if err != 0:
            raise RuntimeError(f"mkhe_rescale launch failed: CUDA error "
                               f"{err}")
        rescale_launches += 1
    return out


@functools.lru_cache(maxsize=None)
def tensor_rows(ids0: Tuple, ids1: Tuple, ids: Tuple
                ) -> Tuple[Tuple[int, int], ...]:
    """The tensor terms' row map, one (r0, r1) an output: out_0 =
    nt0_0 nt1_0 is (-1, 0); out_j, for party ids[j-1], is nt0_0 nt1_r1 +
    nt0_r0 nt1_0 with r0 = 1 + its index in ids0 and r1 = 1 + its index
    in ids1, -1 (no term) where the operand lacks the party."""
    rows = [(-1, 0)]
    for pid in ids:
        r = (1 + ids0.index(pid) if pid in ids0 else -1,
             1 + ids1.index(pid) if pid in ids1 else -1)
        if r == (-1, -1):
            raise ValueError(f"party {pid!r} is in neither operand")
        rows.append(r)
    return tuple(rows)


@functools.lru_cache(maxsize=None)
def _row_words(rows) -> ctypes.Array:
    """tensor_rows as the C entry's int array, r0 and r1 an output."""
    return (ctypes.c_int * (2 * len(rows)))(*itertools.chain(*rows))


def tensor_terms(nt0, nt1, ids0, ids1, ids, t: LimbTables) -> torch.Tensor:
    """The KKLSS tensor terms of NTT-domain canonical nt0 (1 + k0, ..., L,
    N) and nt1 (1 + k1, ..., L, N) (the same tensor for a square): (1 + k,
    ..., L, N) over the parties ids, canonical, out_0 = nt0_0 nt1_0 and
    out_j = nt0_0 nt1_j + nt0_j nt1_0 mod q_l, a term left out where
    party j is absent from that operand (tensor_rows). On a CUDA tensor
    the tensor kernel (one launch per MAX_TENSOR_OUT outputs: one at the
    main path's sizes), which takes contiguous, 16-byte aligned operands
    (ring.ntt's outputs), N even, and raises otherwise; on a CPU tensor
    `tensor_terms_plain`."""
    global tensor_launches
    rows = tensor_rows(tuple(ids0), tuple(ids1), tuple(ids))
    _check_on(nt0, nt1, t.pack)
    _check_on(nt1)
    _check_limbs(nt0, t.q.shape[0])
    if (nt0.shape[0] != 1 + len(ids0)
            or nt1.shape != (1 + len(ids1), *nt0.shape[1:])):
        raise ValueError(f"tensor terms of {tuple(nt0.shape)} and "
                         f"{tuple(nt1.shape)} over {len(ids0)} and "
                         f"{len(ids1)} parties")
    if not _route(nt0):
        return tensor_terms_plain(nt0, nt1, ids0, ids1, ids, t)
    n = nt0.shape[-1]
    if (n % 2 or not (nt0.is_contiguous() and nt1.is_contiguous())
            or (nt0.data_ptr() | nt1.data_ptr()) % 16):
        raise ValueError("the tensor kernel takes contiguous, 16-byte "
                         "aligned operands, N even")
    out = torch.empty((len(rows), *nt0.shape[1:]), dtype=torch.int64,
                      device=nt0.device)
    guard, stream = _on(nt0.device)
    with guard:
        err = load().mkhe_tensor(
            nt0.data_ptr(), nt1.data_ptr(), out.data_ptr(), t.pack.data_ptr(),
            _row_words(rows), len(rows), nt0.numel() // (nt0.shape[0] * n),
            t.q.shape[0], n, stream)
    if err != 0:
        raise RuntimeError(f"mkhe_tensor launch failed: CUDA error {err}")
    tensor_launches += -(-len(rows) // MAX_TENSOR_OUT)
    return out


# ----------------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------------

def mod_up_plain(x, t: ModUpTables) -> torch.Tensor:
    """mod_up as int64 torch ops. One exact path covers every Ls,
    including the JAX package's Ls = 2 Shoup fast path (basis.py:116-131),
    which yields the same residues."""
    ls = len(t.src_moduli)
    y = mm.mont_mul(x, t.qhat_inv_mont[:, None], t.src_q[:, None],
                    t.src_r_inv[:, None])                     # canonical
    # v = floor(sum_i y_i / b_i) in float32. The terms are added left to
    # right one at a time: the order is part of the result (an off-by-one
    # v shifts the output by B), and separate multiply and add ops keep
    # the compiler from contracting them into an FMA.
    yf = y.to(torch.float32) * t.inv_b_f32[:, None]
    vf = yf[..., 0, :]
    for i in range(1, ls):
        vf = vf + yf[..., i, :]
    v = torch.floor(vf).to(torch.int64).clamp(0, ls)[..., None, :]
    dq = t.dst_q[:, None]
    r = mm.mul_accum(((y[..., i:i + 1, :], t.qhat_dst_mont[i][:, None])
                      for i in range(ls)), dq, t.dst_r_inv[:, None])
    corr = torch.zeros_like(r)
    for vi in range(1, ls + 1):
        corr = torch.where(v == vi, t.vq_dst[:, vi:vi + 1], corr)
    return mm.sub_mod(r, corr, dq)


def decompose_plain(x, t: DigitTables) -> torch.Tensor:
    """decompose as one mod_up_plain a digit, stacked."""
    return torch.stack([mod_up_plain(x[..., k * t.alpha:
                                       k * t.alpha + len(d.src_moduli), :],
                                     d)
                        for k, d in enumerate(t.digits)], dim=-3)


def decompose_ntt_plain(x, t: DigitTables, ring: Ring) -> torch.Tensor:
    """decompose_ntt as the composition it fuses: decompose_plain, then
    the plain forward NTT."""
    return ntt_cuda.ntt_plain(decompose_plain(x, t), ring.q, ring.bar,
                              ring.psi, ring.psi_sh)


def rescale_plain(x, ring_q: Ring, nb: int) -> torch.Tensor:
    """rescale as int64 torch ops, one dropped limb at a time."""
    cur = x
    mods = ring_q
    for half, half_rem, qlinv in _rescale_consts(ring_q.moduli, nb,
                                                 ring_q.device):
        L = cur.shape[-2]
        last_t = mm.add_mod(cur[..., L - 1:L, :], half, mods.moduli[L - 1])
        mods = mods.take(0, L - 1)
        rest = mods.add(cur[..., :L - 1, :], half_rem[:, None])
        cur = mods.mul_scalar_mont(mods.sub(rest, mods.reduce(last_t)),
                                   qlinv)
    return cur


def mod_down_plain(xq, xp, t: ModDownTables) -> torch.Tensor:
    """mod_down as int64 torch ops: (xq - ModUp_PtoQ(xp)) * P^-1 mod q."""
    conv = mod_up_plain(xp, t.up)
    dq = t.up.dst_q[:, None]
    return mm.mont_mul(mm.sub_mod(xq, conv, dq), t.pinv_mont[:, None], dq,
                       t.up.dst_r_inv[:, None])


def mul_accum_plain(a, b, nterms: int, t: LimbTables) -> torch.Tensor:
    """mul_accum as int64 torch ops: one product a term (the term axes
    broadcast), summed and reduced by modmath.mul_accum."""
    terms = torch.broadcast_shapes(a.shape[:nterms], b.shape[:nterms])
    a = a.expand(*terms, *a.shape[nterms:])
    b = b.expand(*terms, *b.shape[nterms:])
    return mm.mul_accum(((a[i], b[i])
                         for i in itertools.product(*map(range, terms))),
                        t.q[:, None], t.r_inv[:, None])


def tensor_terms_plain(nt0, nt1, ids0, ids1, ids, t: LimbTables
                       ) -> torch.Tensor:
    """tensor_terms as int64 torch ops: each output's sum of at most two
    products of canonical residues (< 2^58 each), then one % q."""
    out = []
    for r0, r1 in tensor_rows(tuple(ids0), tuple(ids1), tuple(ids)):
        acc = nt0[0] * nt1[r1] if r1 >= 0 else None
        if r0 >= 0:
            acc = nt0[r0] * nt1[0] if acc is None else acc + nt0[r0] * nt1[0]
        out.append(acc)
    return torch.stack(out) % t.q[:, None]


# ----------------------------------------------------------------------------
# The float32 v-correction's boundary (for the tests and chip_smoke.py)
# ----------------------------------------------------------------------------

def v_floors(x, src, alpha: int):
    """(v32, exact) of each digit of x (..., Ls, N) (any u32; digit k is
    src limbs [k alpha, (k+1) alpha)), numpy int64 (..., beta, N): the
    float32 v the kernel and the plain version compute (the same rounded
    products, added left to right), and floor(sum_i y_i / b_i) exactly
    (float64, and python ints where that falls within 1e-9 of an
    integer). Where they differ, mod_up's output is the input's
    representative plus B."""
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                   np.int64).astype(np.uint64) & np.uint64(U32 - 1)
    src = tuple(src)
    v32s, exacts = [], []
    for lo in range(0, len(src), alpha):
        digit = src[lo:lo + alpha]
        big_b = math.prod(digit)
        ys = []
        vf = np.zeros(x.shape[:-2] + x.shape[-1:], np.float32)
        f64 = np.zeros(vf.shape, np.float64)
        for i, b in enumerate(digit):
            c = np.uint64(pow(big_b // b % b, -1, b))
            y = x[..., lo + i, :] * c % np.uint64(b)
            inv_b = np.float32(1.0 / b)
            vf = vf + y.astype(np.float32) * inv_b
            f64 += y.astype(np.float64) / b
            ys.append(y)
        exact = np.floor(f64).astype(np.int64)
        close = np.abs(f64 - np.round(f64)) < 1e-9
        for idx in zip(*np.nonzero(close)):
            total = sum(int(y[idx]) * (big_b // b) for y, b in zip(ys, digit))
            exact[idx] = total // big_b
        v32s.append(np.clip(np.floor(vf).astype(np.int64), 0, len(digit)))
        exacts.append(exact)
    return np.stack(v32s, axis=-2), np.stack(exacts, axis=-2)


def _v32(ys, digit) -> int:
    """The float32 v of the y of one coefficient (as the kernel adds)."""
    vf = np.float32(0)
    for y, b in zip(ys, digit):
        vf = vf + np.float32(y) * np.float32(1.0 / b)
    return min(int(np.floor(vf)), len(digit))


def boundary_ys(digit):
    """y of one coefficient whose float32 v exceeds the exact floor of
    sum_i y_i / b_i, or None where the digit has none (one limb whose
    float32 y_0 / b_0 never reaches 1): for several limbs, the last y
    puts the sum just below the integer above the others' sum (random
    others, from a fixed seed, until float32 rounds up); for one limb,
    y_0 just below b_0."""
    big_b = math.prod(digit)
    bhat = [big_b // b for b in digit]
    if len(digit) == 1:
        ys = ([digit[0] - 1 - t] for t in range(64))
    else:
        rng = np.random.default_rng(len(digit))

        def draws():
            for _ in range(4096):
                head = [int(rng.integers(0, b)) for b in digit[:-1]]
                s = sum(y * h for y, h in zip(head, bhat))
                k = s // big_b + 1
                yield head + [(k * big_b - 1 - s) // bhat[-1]]
        ys = draws()
    for y in ys:
        if _v32(y, digit) > sum(a * h for a, h in zip(y, bhat)) // big_b:
            return y
    return None


def plant_v_boundary(x, src, alpha: int, cols) -> torch.Tensor:
    """x with the coefficients `cols` of every digit (limbs [k alpha,
    (k+1) alpha) of src) that has such inputs (boundary_ys) set to one
    whose float32 v exceeds the exact floor, where mod_up's output is
    the input plus B (v_floors tells them apart)."""
    x = x.clone()
    cols = torch.as_tensor(cols, device=x.device)
    src = tuple(src)
    for lo in range(0, len(src), alpha):
        digit = src[lo:lo + alpha]
        big_b = math.prod(digit)
        ys = boundary_ys(digit)
        for i, b in enumerate(digit if ys is not None else ()):
            x[..., lo + i, cols] = ys[i] * (big_b // b) % b
    return x
