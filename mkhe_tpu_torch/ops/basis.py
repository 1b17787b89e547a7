"""Exact RNS basis extension, ModDown, gadget decomposition and rescaling.

Port of mkhe_tpu/ops/basis.py (HPS basis extension with a float32
correction, as in the reference's FastBasisExtender):

  - mod_up: x in basis B -> x (+ a rare +-B) in basis D via
    y_i = x_i * (B/b_i)^-1 mod b_i; out_j = sum_i y_i * (B/b_i) - v*B
    (mod d_j), with v = floor(sum_i y_i / b_i) computed in float32;
  - mod_down: divide-and-round by P (the key-switch rescale);
  - decompose_digits / decompose_ntt: the KKLSS gadget digit expansion;
  - div_round_by_last_moduli: CKKS rescaling.

mod_up (and with it the digits of decompose_digits), mod_down and the
rescale run on the hand-written kernels of csrc/keyswitch.cu for a CUDA
tensor and their plain versions for a CPU tensor (ops/basis_cuda.py,
which also holds the tables). decompose_ntt on a CUDA tensor is one
launch of csrc/ntt.cu's decompose_ntt_kernel for the main path's digits
(two limbs at logN 14 or 15) wherever the ring's ntt would launch the
full forward kernel on them (`fuses`).

Every output here is canonical. Where the JAX package returns lazy
values (mod_up(lazy=True) < 4q), the canonical value is the same residue
and meets the same bound, so outputs agree bit for bit once reduced.
"""

from __future__ import annotations

import torch

from . import basis_cuda
from .basis_cuda import (ModUpTables, digit_tables, mod_down_tables,
                         mod_up_tables)
from .ring import Ring


def mod_up(x, src_ring: Ring, dst_ring: Ring, tables: ModUpTables
           ) -> torch.Tensor:
    """Convert (..., Ls, N) in basis src (any u32 values) to canonical
    (..., Ld, N) in basis dst. The lifted integer equals the input
    representative in [0, B) up to a rare +-B (see the module docstring).
    One launch of csrc/keyswitch.cu's basis kernel on a CUDA tensor, the
    plain version on a CPU tensor (basis_cuda.mod_up)."""
    return basis_cuda.mod_up(x, tables)


def mod_down(xq, xp, ring_q: Ring, ring_p: Ring) -> torch.Tensor:
    """Divide-and-round by P: (xq, xp) in basis QP -> round(x/P) in basis
    Q: (xq - ModUp_PtoQ(xp)) * P^-1 mod q, canonical; one launch on a CUDA
    tensor (basis_cuda.mod_down)."""
    return basis_cuda.mod_down(
        xq, xp, mod_down_tables(ring_q.moduli, ring_p.moduli, ring_q.device))


# ----------------------------------------------------------------------------
# Gadget decomposition (KKLSS / RNS-CRT gadget with gamma grouping)
# ----------------------------------------------------------------------------

def decompose_digits(x, src_ring: Ring, dst_ring: Ring, alpha: int
                     ) -> torch.Tensor:
    """Decompose coeff-domain (..., Ls, N) in the source basis (Q for
    CKKS, R = Q ++ QMul for BFV) into gadget digits (..., beta, Ld, N),
    beta = ceil(Ls/alpha), each in the full destination basis (QP),
    coefficient domain. For alpha == 1 digit d is the raw limb-d residue
    broadcast to every target limb (a view; values may exceed the target
    modulus and are reduced by the NTT that follows). For alpha > 1 all
    digits come from one launch of the basis kernel on a CUDA tensor
    (basis_cuda.decompose)."""
    ls = x.shape[-2]
    if alpha == 1:
        return x[..., :, None, :].expand(
            *x.shape[:-2], ls, dst_ring.nlimbs, x.shape[-1])
    return basis_cuda.decompose(x, digit_tables(
        src_ring.moduli, dst_ring.moduli, alpha, dst_ring.device))


def fuses(device: torch.device, dst_ring: Ring, alpha: int) -> bool:
    """Whether decompose_ntt takes basis_cuda.decompose_ntt's one launch:
    on a CUDA tensor, with the shape its kernel takes (digits of two limbs
    at a logN of basis_cuda.DECOMPOSE_NTT_LOGNS), into a ring whose ntt is
    the full forward kernel (Ring.full_forward)."""
    return (device.type == "cuda" and alpha == 2
            and dst_ring.logn in basis_cuda.DECOMPOSE_NTT_LOGNS
            and dst_ring.full_forward())


def decompose_ntt(x, src_ring: Ring, dst_ring: Ring, alpha: int
                  ) -> torch.Tensor:
    """Gadget decomposition + forward NTT into the dst basis: coeff-domain
    (..., Ls, N) -> canonical NTT-domain digits (..., beta, Ld, N). One
    launch where `fuses` says so, else dst_ring.ntt of decompose_digits
    (the CPU route, other digit widths or logN, a sharded ring, the split
    NTT); the same values either way."""
    if fuses(x.device, dst_ring, alpha):
        return basis_cuda.decompose_ntt(x, digit_tables(
            src_ring.moduli, dst_ring.moduli, alpha, dst_ring.device),
            dst_ring)
    return dst_ring.ntt(decompose_digits(x, src_ring, dst_ring, alpha))


# ----------------------------------------------------------------------------
# CKKS rescaling: exact divide-and-round by the last nb moduli
# ----------------------------------------------------------------------------

def div_round_by_last_moduli(x, ring_q: Ring, nb: int) -> torch.Tensor:
    """round(x / (q_{L-nb+1} * ... * q_L)) on canonical (..., L, N)
    coeff-domain polys; returns (..., L-nb, N). Lattigo's
    DivRoundByLastModulusMany, as used by Rescale: one launch of
    csrc/keyswitch.cu's rescale kernel on a CUDA tensor, the plain version
    on a CPU tensor (basis_cuda.rescale)."""
    return basis_cuda.rescale(x, ring_q, nb)
