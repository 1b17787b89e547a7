"""Negacyclic NTT / iNTT: the CUDA kernels, their build, launch geometry
and launcher, launch counters, and the plain PyTorch versions.

The kernels of csrc/ntt.cu replace the TPU kernels
mkhe_tpu/ops/ntt_pallas.py::_fwd_kernel and ::_inv_kernel. On an H100 the
bytes bound them: at N = 2^15 a polynomial moves 512 KiB of int64 through
HBM for 15 x 2^14 butterflies. Each thread holds 32 coefficients and runs
up to 5 stages in registers per pass (3 passes and 2 block barriers at
logN 15); between passes the polynomial sits in padded, conflict-free shared
memory; HBM is read and written inside the first and last passes;
butterflies are Harvey's lazy ones (values below 4q, canonical once at the
end, so q < 2^30, which `pack_twiddles` enforces when a ring's tables are
built); twiddles come packed with their Shoup quotients, one 8-byte load
each (Ring.psi_pack / ipsi_pack), the ones of the pass at bit 0 in the
order its threads read them (`twiddle_order`). What holds them back
(PERF.md): at logN 15 one block fills an SM, and each stage waits on its
twiddles. `geometry` sets the launch: polynomials per block (several below
logN 13), blocks, threads and shared memory, which the kernel checks, and
the passes per logN, which the kernel works out by the same rule.

The split form of the same transforms (config.ntt_mxu_tail) is
csrc/ntt_split.cu, in five modes. ntt_split_kernel replaces
_fwd_kernel(head_only=True) and the int8 tail map _tail_apply
(ntt_pallas.py:47-104, 266-312): the fused forward (`ntt_split_fwd`,
Ring.ntt's one launch: head, then the tail on the tensor cores, one HBM
pass), the tail alone (`tail`, either map) and the head alone
(`ntt_head`). ntt_split_inv_kernel replaces _tail_apply with the inverse
map and _inv_kernel(tail_done=True) (:138-225): the fused inverse
(`ntt_split_inv`, Ring.intt's one launch: the tail in place in shared
memory, then the DIT stages, one HBM pass) and the DIT stages alone
(`intt_tailed`). They read the packed twist, wpack, untwist and iwpack
(`pack_natural`) and each limb's tail map in the kernel's fragment order
(`tail_fragments`: 4 u8 digit planes); `tail_schedule` and
`split_inv_passes` are the inverse's work split, for the tests. The
tables live in `SplitTables` (built by ops/ring.py).

The kernel of csrc/ntt_variant.cu replaces the NTT cost probe's
benchmarks/ntt_probe.py::_variant_kernel: `ntt_variant`, a forward NTT in
the split's decimation with its stage count, exchange and twiddle
multiplies switchable, built on the full kernels' passes, geometry and
packed twiddles (natural order, `pack_natural`; in a pass at bit 5 or
above a lane's root times an entry every thread shares, so it reads
`variant_twiddle_entries` of the table), for the settings of
`variant_settings`; mkhe_tpu_torch.ntt_probe drives it.

Every wrapper dispatches on the tensor's device: a CPU tensor goes to the
plain version (`ntt_plain` / `intt_plain`, the int64 transliteration of
the JAX package's jnp path, mkhe_tpu/ops/ring.py:377-440; `ntt_head_plain`
/ `tail_plain` / `ntt_split_fwd_plain` / `intt_tailed_plain` /
`ntt_split_inv_plain`, those of the Pallas split); a CUDA
tensor launches the kernel or raises. There is no fallback from one to the
other.

The build runs `nvcc` on first use, from csrc/*.cu alone (with the
headers csrc/*.cuh), into build/mkhe_tpu_torch/ at the repository root,
and again whenever a source or header is newer than the library. The
library has a plain C interface and is loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from . import modmath as mm

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mkhe_tpu_torch"
LIB_PATH = BUILD_DIR / "libmkhe_ntt.so"
MAX_LOGN = 15   # one polynomial of 2^15 u32 fills 132 KiB of shared memory
MAX_Q = 1 << 30  # the lazy butterflies keep values below 4q < 2^32
LOG_VALS = 5     # a thread of the full kernels holds 2^5 coefficients
MAX_PASS_BITS = 5   # stages of one register pass
LOG_MIN_BLOCK = 13  # a block of the full kernels holds >= 2^13 coefficients
SPLIT_MIN_LOGN = 8  # the split kernels are built for logN 8 .. 15
TAIL_LANES = 128
TAIL_DIGITS = 5      # the JAX package's s8 planes of the tail map (plain)
TAIL_DIGIT_BITS = 7
FRAG_PLANES = 4      # the split kernel's u8 planes: base 2^8, 4 cover u32
FRAG_SHAPE = (FRAG_PLANES, TAIL_LANES // 32, TAIL_LANES // 8, 32, 8)

VARIANT_LOGNS = (10, 14, 15)  # the logN the variant kernel is built for
ORDERS = ("poly", "limb")     # the variant's block orders

# Kernel launches since the last reset_counters(); only a launch of the
# CUDA kernel counts, never a call of the plain version.
fwd_launches = 0
inv_launches = 0
head_launches = 0
tail_launches = 0
inv_tailed_launches = 0
variant_launches = 0
split_fwd_launches = 0
split_inv_launches = 0


def reset_counters() -> None:
    global fwd_launches, inv_launches, head_launches, tail_launches
    global inv_tailed_launches, variant_launches, split_fwd_launches
    global split_inv_launches
    fwd_launches = inv_launches = 0
    head_launches = tail_launches = inv_tailed_launches = 0
    variant_launches = split_fwd_launches = split_inv_launches = 0


def counters() -> dict:
    """Launches of each kernel since the last reset_counters()."""
    return {"ntt_fwd": fwd_launches, "ntt_inv": inv_launches,
            "ntt_fwd_head": head_launches, "ntt_tail": tail_launches,
            "ntt_inv_tailed": inv_tailed_launches,
            "ntt_variant": variant_launches,
            "ntt_split_fwd": split_fwd_launches,
            "ntt_split_inv": split_inv_launches}


# ----------------------------------------------------------------------------
# Build and load
# ----------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = cuda_home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the NTT kernels")


def build() -> str:
    """Compile csrc/*.cu into LIB_PATH if it is missing or older than a
    source or a header (csrc/*.cuh): one nvcc per source, all started
    together, then one link.
    Returns the compiler's output (ptxas register and shared memory
    report) when it ran, else ''."""
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources in {CSRC}")
    newest = max(s.stat().st_mtime
                 for s in (*sources, *CSRC.glob("*.cuh")))
    if LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= newest:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"tmp{os.getpid()}"
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC"]
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in sources]
    tmp = LIB_PATH.with_suffix(f".so.{tag}")
    procs = []
    try:
        for src, obj in zip(sources, objs):
            procs.append(subprocess.Popen(
                [nvcc, *flags, "-Xptxas", "-v", "-c", "-o", str(obj),
                 str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=600)[0] for p in procs]
        for src, p, log in zip(sources, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"({p.returncode}):\n{log}")
        res = subprocess.run([nvcc, *flags, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True,
                             text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return "".join(logs)


def kernel_name(mangled: str) -> str:
    """A kernel's name and integer template arguments from its mangled
    name (`ntt_split_inv_kernel<15,1>`, or `decompose_ntt_kernel` for one
    that is no template), else the name's last 45 characters."""
    m = re.search(r"\d+([a-z][a-z_]*kernel)(?:I((?:L[a-z]\d+E)+)E)?",
                  mangled)
    if not m:
        return mangled[-45:]
    if m.group(2) is None:
        return m.group(1)
    return f"{m.group(1)}<{','.join(re.findall(r'L[a-z](\d+)E', m.group(2)))}>"


def ptxas_lines(log: str) -> list:
    """Each kernel's name (`kernel_name`), then its spills and registers,
    from build()'s compiler output."""
    return [kernel_name(ln.split("'")[1]) if "Compiling entry" in ln
            else ln.split("ptxas info    :")[-1].strip()
            for ln in log.splitlines()
            if "Compiling entry" in ln or "spill" in ln or "registers" in ln]


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    build()
    lib = ctypes.CDLL(str(LIB_PATH))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mkhe_ntt_fwd.argtypes = [vp] * 5 + [ci] * 7 + [vp]
    lib.mkhe_ntt_fwd.restype = ci
    lib.mkhe_ntt_inv.argtypes = [vp] * 7 + [ci] * 7 + [vp]
    lib.mkhe_ntt_inv.restype = ci
    lib.mkhe_ntt_split.argtypes = [vp] * 8 + [ci] * 4 + [vp]
    lib.mkhe_ntt_split.restype = ci
    lib.mkhe_ntt_variant.argtypes = [vp] * 5 + [ci] * 11 + [vp]
    lib.mkhe_ntt_variant.restype = ci
    return lib


# ----------------------------------------------------------------------------
# Launchers
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Geometry:
    """Launch of a full kernel (csrc/ntt.cu). `passes`: the stage bits of
    each register pass, summing to logN (the kernel's pass_bits is the same
    rule); the forward kernel runs them from the top bit down, the inverse
    from bit 0 up. A block holds 2^log_polys polynomials; `blocks` blocks
    of `threads` threads, each with `smem` bytes of dynamic shared memory
    (its coefficients, padded by one word per 32)."""
    logn: int
    passes: tuple
    log_polys: int
    blocks: int
    threads: int
    smem: int


def _passes(logn: int) -> tuple:
    """Stage bits of the register passes: MAX_PASS_BITS each, the rest in
    a last one."""
    full, rest = divmod(logn, MAX_PASS_BITS)
    return (MAX_PASS_BITS,) * full + ((rest,) if rest else ())


@functools.lru_cache(maxsize=1024)
def geometry(logn: int, n_polys: int) -> Geometry:
    """The full kernels' launch for n_polys polynomials of 2^logn: passes
    of MAX_PASS_BITS stages and one with the rest (this order keeps every
    warp's shared-memory access conflict-free with value_index's layout);
    a block of at least 2^LOG_MIN_BLOCK coefficients (several polynomials
    below that), each thread holding 2^LOG_VALS of them."""
    if not 1 <= logn <= MAX_LOGN:
        raise ValueError(f"logN = {logn}: the kernels take 1..{MAX_LOGN}")
    if n_polys < 0:
        raise ValueError(f"n_polys = {n_polys}")
    passes = _passes(logn)
    log_polys = max(0, LOG_MIN_BLOCK - logn)
    size = 1 << (logn + log_polys)
    return Geometry(logn=logn, passes=passes, log_polys=log_polys,
                    blocks=(n_polys + (1 << log_polys) - 1) >> log_polys,
                    threads=size >> LOG_VALS, smem=4 * (size + size // 32))


def value_index(thread, threads, g, c, lo: int, r: int):
    """Index in the block's coefficient array of the value a thread
    (of `threads`) keeps in register (g, c) during a pass over bits
    [lo, lo + r): the pass's bits come from c, every other bit from
    o = g * threads + thread. The kernel's formula (csrc/ntt.cu::
    value_index), for the tests; works on numpy arrays."""
    o = g * threads + thread
    return ((o >> lo) << (lo + r)) | (c << lo) | (o & ((1 << lo) - 1))


@functools.lru_cache(maxsize=None)
def twiddle_order(logn: int, fwd: bool) -> np.ndarray:
    """Where the full kernels' packed table keeps each twiddle: position k
    holds the natural (psi / ipsi) entry order[k]. The pass at lo = 0 (the
    forward's last, the inverse's first) has R = passes[-1] (forward) or
    passes[0] (inverse) stages, B = N / 2^R groups of 2^R coefficients,
    and in stage bit j < R takes the cnt = 2^(R-1-j) twiddles m + hi * cnt
    + cc (m = N / 2^(j+1)) for its group hi. Spread order stores entry
    m + hi * cnt + cc at m + cc * B + hi, so neighbouring threads (hi)
    read neighbouring words; the entries below N / 2^R, which threads
    share, keep their places."""
    passes = _passes(logn)
    r = passes[-1] if fwd else passes[0]
    n = 1 << logn
    order = np.arange(n)
    blocks = n >> r
    for j in range(r):
        m = n >> (j + 1)
        cnt = m // blocks
        hi, cc = np.meshgrid(np.arange(blocks), np.arange(cnt),
                             indexing="ij")
        order[m + cc * blocks + hi] = m + hi * cnt + cc
    return order


def _pack(w: np.ndarray, w_sh: np.ndarray, moduli) -> np.ndarray:
    """w | w_sh << 32 as uint64 of (L, N) tables w, w_sh of the L moduli.
    Raises unless every modulus is below MAX_Q, so that the kernels' lazy
    values (< 4q) fit in 32 bits: every packed table, and so every launch,
    has passed this check."""
    bad = [q for q in moduli if not 2 <= q < MAX_Q]
    if bad:
        raise ValueError(f"the NTT kernels take moduli 2 <= q < 2^30, got "
                         f"{bad}")
    return w.astype(np.uint64) | (w_sh.astype(np.uint64) << np.uint64(32))


def pack_twiddles(w: np.ndarray, w_sh: np.ndarray, moduli,
                  fwd: bool) -> np.ndarray:
    """The full kernels' twiddle table from (L, N) tables w, w_sh of the L
    moduli: w | w_sh << 32 as int64, so one 8-byte load gives a twiddle and
    its Shoup quotient (both < 2^32), in twiddle_order (`_pack` raises for a
    modulus of 2^30 or more)."""
    order = twiddle_order(w.shape[-1].bit_length() - 1, fwd)
    return np.ascontiguousarray(_pack(w, w_sh, moduli)[..., order]
                                ).view(np.int64)


def pack_natural(w: np.ndarray, w_sh: np.ndarray, moduli) -> np.ndarray:
    """The variant and split kernels' tables (twist, wpack) from (..., N)
    tables w, w_sh: w | w_sh << 32 as int64, in natural order (`_pack`
    raises for a modulus of 2^30 or more)."""
    return _pack(w, w_sh, moduli).view(np.int64)


def unpack_twiddles(pack: torch.Tensor, fwd: bool):
    """(w, w_sh) int64 tensors in natural order of a packed table (the
    inverse of pack_twiddles, for the tests)."""
    logn = pack.shape[-1].bit_length() - 1
    order = torch.from_numpy(twiddle_order(logn, fwd)).to(pack.device)
    natural = torch.empty_like(pack)
    natural[..., order] = pack
    return natural & mm.MASK32, (natural >> 32) & mm.MASK32


def _check_full(x, tables, pack, consts):
    """_check for the full kernels: the natural (L, N) tables of the plain
    version and the packed one of the kernel, 16-byte aligned (the kernels
    read twiddle pairs)."""
    shape = _check(x, (*tables, pack), consts)
    if pack.data_ptr() % 16:
        raise ValueError("packed twiddle table: the kernels read 16-byte "
                         "pairs, so it must be 16-byte aligned")
    return shape


def _check(x, tables, consts, min_logn=1):
    """Validate what the kernels take; returns (n_polys, L, logn)."""
    if x.dtype != torch.int64:
        raise TypeError(f"NTT input must be int64, got {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"NTT input must be (..., L, N), got {x.shape}")
    L, n = x.shape[-2], x.shape[-1]
    logn = n.bit_length() - 1
    if n != 1 << logn or not min_logn <= logn <= MAX_LOGN:
        raise ValueError(f"N = {n}: the kernels take N = 2^logN, "
                         f"{min_logn} <= logN <= {MAX_LOGN}")
    for t in (x, *tables, *consts):
        if t.device != x.device:
            raise ValueError("NTT input and tables on different devices")
        if not t.is_contiguous():
            raise ValueError("NTT kernels take contiguous tensors")
        if t.dtype != torch.int64:
            raise TypeError("NTT tables must be int64")
    for t in tables:
        if tuple(t.shape) != (L, n):
            raise ValueError(f"table shape {tuple(t.shape)} != {(L, n)}")
    for c in consts:
        if tuple(c.shape) != (L,):
            raise ValueError(f"constant shape {tuple(c.shape)} != {(L,)}")
    n_polys = x.numel() // n
    if n_polys >= 1 << 31:
        raise ValueError("too many polynomials for one launch")
    return n_polys, L, logn


def _check_tables(x, want: dict, align: int = 0):
    """Each named table (tensor, shape, dtype) contiguous, on x's device,
    of its shape and type and, with align, aligned to that many bytes;
    a table given as None is skipped."""
    for name, (t, shp, dtype) in want.items():
        if t is None:
            continue
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous, on {x.device}")
        if tuple(t.shape) != tuple(shp) or t.dtype != dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, "
                             f"want {tuple(shp)} {dtype}")
        if align and t.data_ptr() % align:
            raise ValueError(f"{name}: the kernel reads it in {align}-byte "
                             f"pieces, so it must be {align}-byte aligned")


def _check_tail(x, q, r_inv, mat, pw, frag=None, pw8=None):
    """_check for the tail: the (L, 5, 128, 128) int8 digit planes and the
    (L, 9) int64 recombination powers of the plain version beside the
    per-limb constants, and the kernel's (L, *FRAG_SHAPE) uint8 fragment
    table (16-byte aligned: cp.async) and (L, 7) powers where given."""
    shape = _check(x, (), (q, r_inv), min_logn=SPLIT_MIN_LOGN)
    L = shape[1]
    _check_tables(x, {
        "tail map": (mat, (L, TAIL_DIGITS, TAIL_LANES, TAIL_LANES),
                     torch.int8),
        "tail powers": (pw, (L, 2 * TAIL_DIGITS - 1), torch.int64),
        "kernel tail powers": (pw8, (L, 2 * FRAG_PLANES - 1), torch.int64)})
    _check_tables(x, {"tail fragments": (frag, (L, *FRAG_SHAPE),
                                         torch.uint8)}, align=16)
    return shape


def _check_packs(x, shape, **packs):
    """The split kernel's packed (L, N) int64 tables (`pack_natural`) given
    by name, where not None, 16-byte aligned."""
    L, n = shape[1], 1 << shape[2]
    _check_tables(x, {f"packed {name}": (t, (L, n), torch.int64)
                      for name, t in packs.items()}, align=16)


def _launch(fn, x, args, shape, extra=()):
    """Launch fn(x, out, *args, n_polys, L, logn, *extra, stream) on x's
    device, shape = _check(...)'s (n_polys, L, logn); an arg of None is a
    null pointer."""
    n_polys, L, logn = shape
    out = torch.empty_like(x)
    if n_polys == 0:
        return out
    # The C entry point launches on the runtime's current device: make it
    # the tensor's device so pointers, stream and launch agree.
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(),
                 *[None if t is None else t.data_ptr() for t in args],
                 n_polys, L, logn, *extra, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
    return out


def launch_full(fwd: bool, x, args, shape, geom: Geometry):
    """Launch the forward (fwd) or inverse full kernel on x with the
    tables `args` in the C order and the launch geom; shape =
    _check_full(...)'s (n_polys, L, logn). Counts nothing: ntt / intt do."""
    if shape[2] != geom.logn:
        raise ValueError(f"geometry for logN {geom.logn}, data {shape[2]}")
    if x.data_ptr() % 16:   # the kernels read 16-byte pairs
        x = x.clone()
    return _launch(load().mkhe_ntt_fwd if fwd else load().mkhe_ntt_inv, x,
                   args, shape, (geom.log_polys, geom.blocks, geom.threads,
                                 geom.smem))


def _device_route(x) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU tensor (plain)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no NTT for device {x.device}")


def ntt(x, q, bar, psi, psi_sh, psi_pack):
    """Forward NTT of (..., L, N), any u32 input -> canonical, bit-reversed
    order. Kernel on a CUDA tensor (it reads psi_pack, Ring.psi_pack),
    plain version on a CPU tensor (it reads psi and psi_sh)."""
    global fwd_launches
    shape = _check_full(x, (psi, psi_sh), psi_pack, (q, bar))
    if not _device_route(x):
        return ntt_plain(x, q, bar, psi, psi_sh)
    out = launch_full(True, x, (psi_pack, q, bar), shape,
                      geometry(shape[2], shape[0]))
    fwd_launches += 1
    return out


def intt(x, q, bar, ipsi, ipsi_sh, ninv, ninv_sh, ipsi_pack):
    """Inverse NTT of (..., L, N), any u32 input (in particular the lazy
    < 8q inputs of the key-switch pipeline) -> canonical, standard order.
    Kernel on a CUDA tensor (it reads ipsi_pack, Ring.ipsi_pack), plain
    version on a CPU tensor (it reads ipsi and ipsi_sh)."""
    global inv_launches
    shape = _check_full(x, (ipsi, ipsi_sh), ipsi_pack, (q, bar, ninv, ninv_sh))
    if not _device_route(x):
        return intt_plain(x, q, bar, ipsi, ipsi_sh, ninv, ninv_sh)
    out = launch_full(False, x, (ipsi_pack, q, bar, ninv, ninv_sh), shape,
                      geometry(shape[2], shape[0]))
    inv_launches += 1
    return out


@dataclasses.dataclass(frozen=True)
class SplitTables:
    """Per-limb tables of the split NTT, on the ring's device (built by
    ops/ring.py::_split_tables). (L, N) int64: twist = psi^j, untwist =
    psi^-j / N, wpack / iwpack = stage s (half-block h = N >> s) at offset
    N - 2h holding omega^(+-2^(s-1) l), l < h, each with its Shoup companion
    (*_sh). tail_fwd / tail_inv: (L, 5, 128, 128) int8 base-2^7 digit planes
    of the tail map M, out = x @ M on each 128-lane block; tail_pow: (L, 9)
    int64, 2^(7t+32) mod q. These equal the JAX package's tables of the
    same names and serve the plain versions. The split kernel reads:
    twist_pack / wpack_pack / untwist_pack / iwpack_pack, (L, N) int64
    w | w_sh << 32 (`pack_natural`);
    tail_fwd_frag / tail_inv_frag, (L, *FRAG_SHAPE) uint8, each limb's map
    in 4 base-2^8 planes in fragment order (`tail_fragments`); tail_pow8,
    (L, 7) int64, 2^(8t+32) mod q."""
    twist: torch.Tensor
    twist_sh: torch.Tensor
    untwist: torch.Tensor
    untwist_sh: torch.Tensor
    wpack: torch.Tensor
    wpack_sh: torch.Tensor
    iwpack: torch.Tensor
    iwpack_sh: torch.Tensor
    tail_fwd: torch.Tensor
    tail_inv: torch.Tensor
    tail_pow: torch.Tensor
    twist_pack: torch.Tensor
    wpack_pack: torch.Tensor
    untwist_pack: torch.Tensor
    iwpack_pack: torch.Tensor
    tail_fwd_frag: torch.Tensor
    tail_inv_frag: torch.Tensor
    tail_pow8: torch.Tensor


def tail_fragments(m: np.ndarray) -> np.ndarray:
    """The split kernel's table of one limb's tail map m ((128, 128)
    canonical values < 2^32, out = x @ m): t[d, ks, nt, lane, b] = byte d
    of m[32 ks + 16 hf + c + 4 e, 8 nt + g], hf = b // 4, e = b % 4,
    g = lane // 4, c = lane % 4, so lane's bytes b are its B fragment
    registers b0 (hf 0) and b1 (hf 1) of mma.sync m16n8k32 for k-step ks,
    n-tile nt and plane d, with the kernel's permuted k (MMA k = 16 hf +
    4 c + e is column 16 hf + c + 4 e of the k-step). uint8, FRAG_SHAPE."""
    d, ks, nt, lane, b = np.meshgrid(*map(np.arange, FRAG_SHAPE),
                                     indexing="ij")
    row = 32 * ks + 16 * (b >> 2) + (lane & 3) + 4 * (b & 3)
    col = 8 * nt + (lane >> 2)
    vals = np.asarray(m, np.uint64)[row, col]
    return ((vals >> (np.uint64(8) * d.astype(np.uint64))) & np.uint64(255)
            ).astype(np.uint8)


_HEAD, _TAIL, _INV = 1, 2, 4   # mode bits of mkhe_ntt_split


def tail_schedule(logn: int):
    """How the split inverse's tail (csrc/ntt_split.cu::tail_rows_in_place)
    deals its work at logN: (items, split). items[w] lists warp w's items
    in order, each (row tile, first n-tile, n-tiles); split > 1: that many
    warps share each row tile, each warp has one item, and a block barrier
    stands between all reads and all writes; split = 1: each row tile is
    one warp's, with a __syncwarp between its reads and its writes."""
    warps = split_threads(logn) // 32
    row_tiles = ((1 << logn) // TAIL_LANES + 15) // 16
    split = warps // row_tiles if warps > row_tiles else 1
    tiles = TAIL_LANES // 8 // split
    items = [[(it // split, it % split * tiles, tiles)
              for it in range(w, row_tiles * split, warps)]
             for w in range(warps)]
    return items, split


def split_threads(logn: int) -> int:
    """Threads of a split kernel's block (one polynomial):
    max(128, min(512, N / 32))."""
    return max(128, min(512, (1 << logn) >> 5))


def split_inv_passes(logn: int) -> list:
    """(lo, R) of the split inverse's DIT register passes from bit 7 up:
    (logN - 7) mod MAX_PASS_BITS bits first where that is not 0, then
    MAX_PASS_BITS each (csrc/ntt_split.cu::dit_passes)."""
    lo, rest, out = 7, (logn - 7) % MAX_PASS_BITS, []
    while lo < logn:
        r = rest if lo == 7 and rest else MAX_PASS_BITS
        out.append((lo, r))
        lo += r
    return out


def _launch_split(x, shape, mode, q, twist_pack=None, wpack_pack=None,
                  frag=None, pw8=None, bar=None):
    # every mode but the head reads x in 16-byte pairs
    if mode != _HEAD and x.data_ptr() % 16:
        x = x.clone()
    return _launch(load().mkhe_ntt_split, x,
                   (twist_pack, wpack_pack, frag, pw8, q, bar), shape,
                   (mode,))


def _need(x, tables, what):
    """Raise unless every kernel table is given (a CUDA tensor)."""
    if any(t is None for t in tables):
        raise ValueError(f"the split kernel on {x.device} reads {what}")


def ntt_head(x, q, twist, twist_sh, wpack, wpack_sh, twist_pack=None,
             wpack_pack=None):
    """Head of the split forward NTT over (..., L, N), any u32 input:
    twist by psi^j, then the DIF stages with half-block h = N/2 .. 128.
    Canonical output, still in the head's intermediate order (`tail`
    with the forward map finishes the transform). The split kernel's head
    mode on a CUDA tensor (it reads twist_pack and wpack_pack, SplitTables),
    plain version on a CPU tensor (it reads the natural tables)."""
    global head_launches
    shape = _check(x, (twist, twist_sh, wpack, wpack_sh), (q,),
                   min_logn=SPLIT_MIN_LOGN)
    _check_packs(x, shape, twist=twist_pack, wpack=wpack_pack)
    if not _device_route(x):
        return ntt_head_plain(x, q, twist, twist_sh, wpack, wpack_sh)
    _need(x, (twist_pack, wpack_pack), "twist_pack and wpack_pack")
    out = _launch_split(x, shape, _HEAD, q, twist_pack, wpack_pack)
    head_launches += 1
    return out


def tail(x, q, r_inv, mat, pw, frag=None, pw8=None):
    """Each 128-lane block of (..., L, N) times its limb's fixed 128x128
    map over Z_q (tail_fwd or tail_inv), any u32 input, canonical output.
    The split kernel's tail mode on a CUDA tensor (it reads the map's
    fragment table frag, SplitTables.tail_fwd_frag or tail_inv_frag, and
    pw8 = tail_pow8, and works out -q^-1 mod 2^32 itself), plain version
    on a CPU tensor (it reads mat and pw, and r_inv = 2^-32 mod q)."""
    global tail_launches
    shape = _check_tail(x, q, r_inv, mat, pw, frag, pw8)
    if not _device_route(x):
        return tail_plain(x, q, r_inv, mat, pw)
    _need(x, (frag, pw8), "the map's fragment table and tail_pow8")
    out = _launch_split(x, shape, _TAIL, q, frag=frag, pw8=pw8)
    tail_launches += 1
    return out


def ntt_split_fwd(x, q, r_inv, t: SplitTables):
    """The split forward NTT over (..., L, N), any u32 input -> canonical,
    bit-reversed order: the head, then the tail with the forward map.
    On a CUDA tensor one launch of the split kernel's fused mode (it reads
    q, t.twist_pack, t.wpack_pack, t.tail_fwd_frag and t.tail_pow8); on a
    CPU tensor `ntt_split_fwd_plain`."""
    global split_fwd_launches
    shape = _check(x, (t.twist, t.twist_sh, t.wpack, t.wpack_sh), (q,),
                   min_logn=SPLIT_MIN_LOGN)
    _check_tail(x, q, r_inv, t.tail_fwd, t.tail_pow, t.tail_fwd_frag,
                t.tail_pow8)
    _check_packs(x, shape, twist=t.twist_pack, wpack=t.wpack_pack)
    if not _device_route(x):
        return ntt_split_fwd_plain(x, q, r_inv, t)
    out = _launch_split(x, shape, _HEAD | _TAIL, q, t.twist_pack,
                        t.wpack_pack, t.tail_fwd_frag, t.tail_pow8)
    split_fwd_launches += 1
    return out


def ntt_split_inv(x, q, bar, r_inv, t: SplitTables):
    """The split inverse NTT over (..., L, N), any u32 input (the lazy < 8q
    inputs of the key-switch pipeline in particular) -> canonical,
    standard order: the tail with the inverse map, then the DIT stages
    h = 128 .. N/2 and the untwist. On a CUDA tensor one launch of the
    split inverse kernel's fused mode (it reads q, t.tail_inv_frag,
    t.tail_pow8, t.iwpack_pack and t.untwist_pack); on a CPU tensor
    `ntt_split_inv_plain`."""
    global split_inv_launches
    shape = _check(x, (t.iwpack, t.iwpack_sh, t.untwist, t.untwist_sh),
                   (q, bar), min_logn=SPLIT_MIN_LOGN)
    _check_tail(x, q, r_inv, t.tail_inv, t.tail_pow, t.tail_inv_frag,
                t.tail_pow8)
    _check_packs(x, shape, untwist=t.untwist_pack, iwpack=t.iwpack_pack)
    if not _device_route(x):
        return ntt_split_inv_plain(x, q, bar, r_inv, t)
    out = _launch_split(x, shape, _INV | _TAIL, q, t.untwist_pack,
                        t.iwpack_pack, t.tail_inv_frag, t.tail_pow8)
    split_inv_launches += 1
    return out


@functools.lru_cache(maxsize=None)
def variant_settings(logn: int) -> frozenset:
    """The (stages, exchange, mul) settings the variant kernel is built for
    at logN (csrc/ntt_variant.cu::find; none outside VARIANT_LOGNS): the
    probe's rows (every stage, 8 and 1 stage, every stage without twiddle
    multiplies, every stage without exchange) and logN - 7 stages, the
    split head's."""
    if logn not in VARIANT_LOGNS:
        return frozenset()
    return frozenset({(logn, True, True), (8, True, True), (1, True, True),
                      (logn - 7, True, True), (logn, True, False),
                      (logn, False, True)})


@functools.lru_cache(maxsize=None)
def variant_twiddle_entries(logn: int, stages: int) -> np.ndarray:
    """The entries of a limb's wpack table that the variant kernel reads
    with the multiplies on (csrc/ntt_dif.cuh::stage; the exchange changes
    nothing), sorted: its passes split the stages as `_passes` does, from
    the top; stage bit b = lo + J (h = 2^b > 1) of a pass at bit lo reads,
    at lo >= 5, the lanes' roots W_b^jl (entries [N - 2h, N - 2h + 2^lo))
    and stage J's shared table W_J^low (all 2^J entries, J > 0), and below
    lo = 5 the whole stage table [N - 2h, N - h)."""
    n, idx, done = 1 << logn, [], 0
    while done < stages:
        r = min(stages - done, MAX_PASS_BITS)
        lo = logn - done - r
        for j in range(r):
            b = lo + j
            if b == 0:
                continue
            if lo >= 5:
                idx.append(np.arange(n - (2 << b), n - (2 << b) + (1 << lo)))
                if j > 0:
                    idx.append(np.arange(n - (2 << j), n - (1 << j)))
            else:
                idx.append(np.arange(n - (2 << b), n - (1 << b)))
        done += r
    return np.unique(np.concatenate(idx)) if idx else np.zeros(0, np.int64)


def variant_poly_order(n_polys: int, L: int, order: str) -> np.ndarray:
    """The polynomial that block slot r of the variant kernel works on
    (csrc/ntt_variant.cu::poly_of), for the tests: r itself in "poly"
    (polynomial-major) order; (r % B) * L + r // B, B = n_polys / L, in
    "limb" (limb-major) order, so that consecutive blocks take the B
    polynomials of one limb and share its tables."""
    r = np.arange(n_polys)
    if order == "poly":
        return r
    b = n_polys // L
    return (r % b) * L + r // b


@dataclasses.dataclass(frozen=True)
class VariantTables:
    """What ntt_variant reads of a ring: q, the split's twist and wpack
    tables (natural, for the plain version) and their packed forms
    (`pack_natural`, for the kernel)."""
    q: torch.Tensor
    twist: torch.Tensor
    twist_sh: torch.Tensor
    wpack: torch.Tensor
    wpack_sh: torch.Tensor
    twist_pack: torch.Tensor
    wpack_pack: torch.Tensor


def ntt_variant(x, t: VariantTables, *, stages: int, exchange: bool = True,
                mul: bool = True, order: str = "poly"):
    """The NTT cost probe's transform over (..., L, N), any u32 input ->
    canonical: twist by psi^j, then `stages` DIF stages (h = N/2, N/4, ...)
    on the split's wpack table, with the exchange between a butterfly's
    two values (off: each value is its own partner) and the twiddle
    multiplies (off: none) switchable. With every stage it is Ring.ntt;
    with logN - 7 it is ntt_head. Kernel on a CUDA tensor (it reads
    t.twist_pack and t.wpack_pack; blocks in `order`, ORDERS; the settings
    of `variant_settings` only), plain version on a CPU tensor (it reads
    the natural tables; the order changes nothing)."""
    global variant_launches
    shape = _check(x, (t.twist, t.twist_sh, t.wpack, t.wpack_sh,
                       t.twist_pack, t.wpack_pack), (t.q,))
    logn = shape[2]
    exchange, mul = bool(exchange), bool(mul)
    if not 1 <= stages <= logn:
        raise ValueError(f"stages = {stages}: 1 <= stages <= logN = {logn}")
    if order not in ORDERS:
        raise ValueError(f"order {order!r} not in {ORDERS}")
    if not _device_route(x):
        return ntt_variant_plain(x, t, stages=stages, exchange=exchange,
                                 mul=mul)
    if (stages, exchange, mul) not in variant_settings(logn):
        raise ValueError(f"the variant kernel is not built for stages = "
                         f"{stages}, exchange = {exchange}, mul = {mul} at "
                         f"logN {logn} (variant_settings)")
    if t.wpack_pack.data_ptr() % 16:
        raise ValueError("packed wpack table: the kernel reads 16-byte "
                         "pairs, so it must be 16-byte aligned")
    geom = geometry(logn, shape[0])
    out = _launch(load().mkhe_ntt_variant, x, (t.twist_pack, t.wpack_pack,
                                                t.q),
                  shape, (stages, int(exchange), int(mul),
                          ORDERS.index(order), geom.log_polys, geom.blocks,
                          geom.threads, geom.smem if exchange else 0))
    variant_launches += 1
    return out


def intt_tailed(x, q, bar, iwpack, iwpack_sh, untwist, untwist_sh,
                iwpack_pack=None, untwist_pack=None):
    """Rest of the split inverse NTT after `tail` with the inverse map:
    the DIT stages with half-block h = 128 .. N/2, then the untwist by
    psi^-j / N. Any u32 input, canonical standard-order output. The split
    inverse kernel's DIT mode on a CUDA tensor (it reads q, bar and the
    packed iwpack_pack and untwist_pack, SplitTables), plain version on a
    CPU tensor (it reads the natural tables)."""
    global inv_tailed_launches
    shape = _check(x, (iwpack, iwpack_sh, untwist, untwist_sh), (q, bar),
                   min_logn=SPLIT_MIN_LOGN)
    _check_packs(x, shape, iwpack=iwpack_pack, untwist=untwist_pack)
    if not _device_route(x):
        return intt_tailed_plain(x, q, bar, iwpack, iwpack_sh, untwist,
                                 untwist_sh)
    _need(x, (iwpack_pack, untwist_pack), "iwpack_pack and untwist_pack")
    out = _launch_split(x, shape, _INV, q, untwist_pack, iwpack_pack,
                        bar=bar)
    inv_tailed_launches += 1
    return out


# ----------------------------------------------------------------------------
# Plain PyTorch versions (any device)
# ----------------------------------------------------------------------------

def ntt_plain(x, q, bar, psi, psi_sh):
    """Merged-twist Cooley-Tukey, as mkhe_tpu/ops/ring.py:377-397 with the
    input reduction of reduce_input=True."""
    L, n = x.shape[-2], x.shape[-1]
    batch = x.shape[:-2]
    a = mm.barrett_reduce(x, q[:, None], bar[:, None])
    qq = q[:, None, None]
    t, m = n, 1
    while m < n:
        t //= 2
        xr = a.reshape(*batch, L, m, 2, t)
        u, v = xr[..., 0, :], xr[..., 1, :]
        vs = mm.shoup_mul(v, psi[:, m:2 * m, None],
                          psi_sh[:, m:2 * m, None], qq)
        a = torch.stack([mm.add_mod(u, vs, qq), mm.sub_mod(u, vs, qq)],
                        dim=-2).reshape(*batch, L, n)
        m *= 2
    return a


def intt_plain(x, q, bar, ipsi, ipsi_sh, ninv, ninv_sh):
    """Gentleman-Sande + N^-1, as mkhe_tpu/ops/ring.py:418-440 with the
    input reduction of reduce_input=True."""
    L, n = x.shape[-2], x.shape[-1]
    batch = x.shape[:-2]
    a = mm.barrett_reduce(x, q[:, None], bar[:, None])
    qq = q[:, None, None]
    t, m = 1, n
    while m > 1:
        h = m // 2
        xr = a.reshape(*batch, L, h, 2, t)
        u, v = xr[..., 0, :], xr[..., 1, :]
        a = torch.stack(
            [mm.add_mod(u, v, qq),
             mm.shoup_mul(mm.sub_mod(u, v, qq), ipsi[:, h:2 * h, None],
                          ipsi_sh[:, h:2 * h, None], qq)],
            dim=-2).reshape(*batch, L, n)
        t *= 2
        m = h
    return mm.shoup_mul(a, ninv[:, None], ninv_sh[:, None], q[:, None])


# ----------------------------------------------------------------------------
# Plain PyTorch versions of the split (any device)
# ----------------------------------------------------------------------------

def _stage_view(a, h):
    """(..., L, N) -> the top and bottom halves of every 2h-block,
    each (..., L, N / 2h, h)."""
    xr = a.reshape(*a.shape[:-1], a.shape[-1] // (2 * h), 2, h)
    return xr[..., 0, :], xr[..., 1, :]


def ntt_head_plain(x, q, twist, twist_sh, wpack, wpack_sh):
    """Twist, then the DIF stages h = N/2 .. 128, all canonical: the
    arithmetic of mkhe_tpu/ops/ntt_pallas.py::_fwd_stages(head_only=True)
    (:73-104) with exact Shoup quotients."""
    L, n = x.shape[-2], x.shape[-1]
    a = mm.shoup_mul(x, twist, twist_sh, q[:, None])
    qq = q[:, None, None]
    h = n // 2
    while h >= TAIL_LANES:
        top, bot = _stage_view(a, h)
        w = wpack[:, None, n - 2 * h:n - h]
        wsh = wpack_sh[:, None, n - 2 * h:n - h]
        a = torch.stack([mm.add_mod(top, bot, qq),
                         mm.shoup_mul(mm.sub_mod(top, bot, qq), w, wsh, qq)],
                        dim=-2).reshape(x.shape)
        h //= 2
    return a


def ntt_variant_plain(x, t: VariantTables, *, stages: int,
                      exchange: bool = True, mul: bool = True):
    """benchmarks/ntt_probe.py::_variant_kernel (:35-63), all canonical:
    twist, then for s = 1 .. stages (h = N >> s) every 2h-block's top T and
    bottom B become T + B and wpack[N - 2h + l] (T - B), or with the
    exchange off T + T and wpack[N - 2h + l] (B - B); without the multiply,
    or at h = 1, the bottom is the difference alone. The probe's lazy
    values stay below 2q and end in csub(a, q), so its output is this
    canonical one."""
    n = x.shape[-1]
    a = mm.shoup_mul(x, t.twist, t.twist_sh, t.q[:, None])
    qq = t.q[:, None, None]
    for s in range(1, stages + 1):
        h = n >> s
        top, bot = _stage_view(a, h)
        up, down = (bot, top) if exchange else (top, bot)
        diff = mm.sub_mod(down, bot, qq)
        if mul and h > 1:
            diff = mm.shoup_mul(diff, t.wpack[:, None, n - 2 * h:n - h],
                                t.wpack_sh[:, None, n - 2 * h:n - h], qq)
        a = torch.stack([mm.add_mod(top, up, qq), diff],
                        dim=-2).reshape(x.shape)
    return a


def ntt_split_fwd_plain(x, q, r_inv, t: SplitTables):
    """The split forward NTT as its two plain parts: tail_plain (forward
    map) of ntt_head_plain."""
    head = ntt_head_plain(x, q, t.twist, t.twist_sh, t.wpack, t.wpack_sh)
    return tail_plain(head, q, r_inv, t.tail_fwd, t.tail_pow)


def tail_plain(x, q, r_inv, mat, pw):
    """mkhe_tpu/ops/ntt_pallas.py::_tail_apply: the input's 5 base-2^7
    digit planes times the map's 5, as 25 products summed into 9 partial
    sums s_t (t = digit of x + digit of the map), then sum_t s_t *
    2^(7t+32) reduced by one Montgomery step. The products run in float64:
    each term is < 2^14 and each sum < 2^24, so they are exact (and CUDA
    has no int64 matrix product)."""
    L, n = x.shape[-2], x.shape[-1]
    rows = x.reshape(-1, L, n // TAIL_LANES, TAIL_LANES).transpose(0, 1)
    rows = rows.reshape(L, -1, TAIL_LANES)        # (L, blocks, 128)
    m = mat.to(torch.float64)
    mask = (1 << TAIL_DIGIT_BITS) - 1
    s = [None] * (2 * TAIL_DIGITS - 1)
    for k in range(TAIL_DIGITS):
        dk = ((rows >> (TAIL_DIGIT_BITS * k)) & mask).to(torch.float64)
        for j in range(TAIL_DIGITS):
            p = torch.matmul(dk, m[:, j])
            s[k + j] = p if s[k + j] is None else s[k + j] + p
    acc = None                  # < 9 * 2^24 * 2^29 < 2^63
    for t, st in enumerate(s):
        term = st.to(torch.int64) * pw[:, t, None, None]
        acc = term if acc is None else acc + term
    qq = q[:, None, None]
    r = (acc % qq) * r_inv[:, None, None] % qq
    return r.reshape(L, -1, n // TAIL_LANES, TAIL_LANES).transpose(0, 1) \
        .reshape(x.shape).contiguous()


def ntt_split_inv_plain(x, q, bar, r_inv, t: SplitTables):
    """The split inverse NTT as its two plain parts: intt_tailed_plain of
    tail_plain (inverse map)."""
    tailed = tail_plain(x, q, r_inv, t.tail_inv, t.tail_pow)
    return intt_tailed_plain(tailed, q, bar, t.iwpack, t.iwpack_sh,
                             t.untwist, t.untwist_sh)


def intt_tailed_plain(x, q, bar, iwpack, iwpack_sh, untwist, untwist_sh):
    """The DIT stages h = 128 .. N/2, then the untwist, all canonical: the
    arithmetic of mkhe_tpu/ops/ntt_pallas.py::_inv_kernel(tail_done=True)
    (:175-225) with exact Shoup quotients, after a Barrett reduction of
    the input."""
    L, n = x.shape[-2], x.shape[-1]
    a = mm.barrett_reduce(x, q[:, None], bar[:, None])
    qq = q[:, None, None]
    h = TAIL_LANES
    while h < n:
        top, bot = _stage_view(a, h)
        v = mm.shoup_mul(bot, iwpack[:, None, n - 2 * h:n - h],
                         iwpack_sh[:, None, n - 2 * h:n - h], qq)
        a = torch.stack([mm.add_mod(top, v, qq), mm.sub_mod(top, v, qq)],
                        dim=-2).reshape(x.shape)
        h *= 2
    return mm.shoup_mul(a, untwist, untwist_sh, q[:, None])
