"""Negacyclic NTT / iNTT: the CUDA kernels, their build and launcher, launch
counters, and the plain PyTorch versions.

The kernels (csrc/ntt.cu) replace the TPU kernels
mkhe_tpu/ops/ntt_pallas.py::_fwd_kernel and ::_inv_kernel. On an H100
they are bound by integer multiplies and shared-memory traffic: one block
holds one polynomial in shared memory, and each of the logN stages reads
and writes the whole 128 KiB (N = 2^15).

`ntt` / `intt` dispatch on the tensor's device: a CPU tensor goes to the
plain version (`ntt_plain` / `intt_plain`, the int64 transliteration of
the JAX package's jnp path, mkhe_tpu/ops/ring.py:377-440); a CUDA tensor
launches the kernel or raises. There is no fallback from one to the other.

The build runs `nvcc` on first use, from csrc/*.cu alone, into
build/mkhe_tpu_torch/ at the repository root, and again whenever a source
is newer than the library. The library has a plain C interface and is
loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

import torch

from . import modmath as mm

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mkhe_tpu_torch"
LIB_PATH = BUILD_DIR / "libmkhe_ntt.so"
MAX_LOGN = 15   # one polynomial of 2^15 u32 fills 128 KiB of shared memory

# Kernel launches since the last reset_counters(); only a launch of the
# CUDA kernel counts, never a call of the plain version.
fwd_launches = 0
inv_launches = 0


def reset_counters() -> None:
    global fwd_launches, inv_launches
    fwd_launches = 0
    inv_launches = 0


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
    source. Returns the compiler's output (ptxas register and shared
    memory report) when it ran, else ''."""
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources in {CSRC}")
    newest = max(s.stat().st_mtime for s in sources)
    if LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= newest:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", str(tmp), *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, LIB_PATH)
    return res.stdout + res.stderr


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    build()
    lib = ctypes.CDLL(str(LIB_PATH))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mkhe_ntt_fwd.argtypes = [vp] * 6 + [ci, ci, ci, vp]
    lib.mkhe_ntt_fwd.restype = ci
    lib.mkhe_ntt_inv.argtypes = [vp] * 8 + [ci, ci, ci, vp]
    lib.mkhe_ntt_inv.restype = ci
    return lib


# ----------------------------------------------------------------------------
# Launchers
# ----------------------------------------------------------------------------

def _check(x, tables, consts):
    """Validate what the kernels take; returns (n_polys, L, logn)."""
    if x.dtype != torch.int64:
        raise TypeError(f"NTT input must be int64, got {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"NTT input must be (..., L, N), got {x.shape}")
    L, n = x.shape[-2], x.shape[-1]
    logn = n.bit_length() - 1
    if n != 1 << logn or not 1 <= logn <= MAX_LOGN:
        raise ValueError(f"N = {n}: the kernels take N = 2^logN, "
                         f"1 <= logN <= {MAX_LOGN}")
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


def _launch(fn, x, tables, consts):
    n_polys, L, logn = _check(x, tables, consts)
    out = torch.empty_like(x)
    if n_polys == 0:
        return out
    # The C entry point launches on the runtime's current device: make it
    # the tensor's device so pointers, stream and launch agree.
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(),
                 *[t.data_ptr() for t in (*tables, *consts)],
                 n_polys, L, logn, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
    return out


def _device_route(x) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU tensor (plain)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no NTT for device {x.device}")


def ntt(x, q, bar, psi, psi_sh):
    """Forward NTT of (..., L, N), any u32 input -> canonical, bit-reversed
    order. Kernel on a CUDA tensor, plain version on a CPU tensor."""
    global fwd_launches
    if not _device_route(x):
        _check(x, (psi, psi_sh), (q, bar))
        return ntt_plain(x, q, bar, psi, psi_sh)
    out = _launch(load().mkhe_ntt_fwd, x, (psi, psi_sh), (q, bar))
    fwd_launches += 1
    return out


def intt(x, q, bar, ipsi, ipsi_sh, ninv, ninv_sh):
    """Inverse NTT of (..., L, N), any u32 input (in particular the lazy
    < 8q inputs of the key-switch pipeline) -> canonical, standard order.
    Kernel on a CUDA tensor, plain version on a CPU tensor."""
    global inv_launches
    if not _device_route(x):
        _check(x, (ipsi, ipsi_sh), (q, bar, ninv, ninv_sh))
        return intt_plain(x, q, bar, ipsi, ipsi_sh, ninv, ninv_sh)
    out = _launch(load().mkhe_ntt_inv, x, (ipsi, ipsi_sh),
                  (q, bar, ninv, ninv_sh))
    inv_launches += 1
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
