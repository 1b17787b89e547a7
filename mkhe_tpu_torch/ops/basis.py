"""Exact RNS basis extension, ModDown, gadget decomposition and rescaling.

Port of mkhe_tpu/ops/basis.py (HPS basis extension with a float32
correction, as in the reference's FastBasisExtender):

  - mod_up: x in basis B -> x (+ a rare +-B) in basis D via
    y_i = x_i * (B/b_i)^-1 mod b_i; out_j = sum_i y_i * (B/b_i) - v*B
    (mod d_j), with v = floor(sum_i y_i / b_i) computed in float32;
  - mod_down: divide-and-round by P (the key-switch rescale);
  - decompose_digits / decompose_ntt: the KKLSS gadget digit expansion;
  - div_round_by_last_moduli: CKKS rescaling.

Every output here is canonical. Where the JAX package returns lazy
values (mod_up(lazy=True) < 4q), the canonical value is the same residue
and meets the same bound, so outputs agree bit for bit once reduced.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from . import modmath as mm
from .ring import Ring


@dataclasses.dataclass(frozen=True)
class ModUpTables:
    """Tables for exact base conversion from src basis B to dst basis D."""
    src_moduli: Tuple[int, ...]
    dst_moduli: Tuple[int, ...]
    qhat_inv_mont: torch.Tensor   # (Ls,) (B/b_i)^-1 mod b_i, Montgomery
    qhat_dst_mont: torch.Tensor   # (Ls, Ld) B/b_i mod d_j, Montgomery
    vq_dst: torch.Tensor          # (Ld, Ls+1) v*B mod d_j for v = 0..Ls
    inv_b_f32: torch.Tensor       # (Ls,) float32 1/b_i


@functools.lru_cache(maxsize=None)
def mod_up_tables(src: Tuple[int, ...], dst: Tuple[int, ...],
                  device: torch.device) -> ModUpTables:
    B = 1
    for b in src:
        B *= b
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
        inv_b_f32=torch.from_numpy(inv_b).to(device))


def mod_up(x, src_ring: Ring, dst_ring: Ring, tables: ModUpTables
           ) -> torch.Tensor:
    """Convert (..., Ls, N) in basis src (any u32 values) to canonical
    (..., Ld, N) in basis dst. The lifted integer equals the input
    representative in [0, B) up to a rare +-B (see the module docstring).

    One exact path covers every Ls, including the JAX package's Ls = 2
    Shoup fast path (basis.py:116-131), which yields the same residues."""
    ls = len(tables.src_moduli)
    y = mm.mont_mul(x, tables.qhat_inv_mont[:, None], src_ring.q[:, None],
                    src_ring.r_inv[:, None])                  # canonical
    # v = floor(sum_i y_i / b_i) in float32. The terms are added left to
    # right one at a time: the order is part of the result (an off-by-one
    # v shifts the output by B), and separate multiply and add ops keep
    # the compiler from contracting them into an FMA.
    yf = y.to(torch.float32) * tables.inv_b_f32[:, None]
    vf = yf[..., 0, :]
    for i in range(1, ls):
        vf = vf + yf[..., i, :]
    v = torch.floor(vf).to(torch.int64).clamp(0, ls)[..., None, :]
    dq = dst_ring.q[:, None]
    r = mm.mul_accum(((y[..., i:i + 1, :], tables.qhat_dst_mont[i][:, None])
                      for i in range(ls)), dq, dst_ring.r_inv[:, None])
    corr = torch.zeros_like(r)
    for vi in range(1, ls + 1):
        corr = torch.where(v == vi, tables.vq_dst[:, vi:vi + 1], corr)
    return mm.sub_mod(r, corr, dq)


@functools.lru_cache(maxsize=None)
def mod_down_tables(qm: Tuple[int, ...], pm: Tuple[int, ...],
                    device: torch.device) -> torch.Tensor:
    """(Lq,) P^-1 mod q_j in Montgomery form."""
    P = 1
    for p in pm:
        P *= p
    return torch.tensor([mm.to_mont_host(pow(P % q, -1, q), q) for q in qm],
                        dtype=torch.int64, device=device)


def mod_down(xq, xp, ring_q: Ring, ring_p: Ring) -> torch.Tensor:
    """Divide-and-round by P: canonical (xq, xp) in basis QP -> round(x/P)
    in basis Q: (xq - ModUp_PtoQ(xp)) * P^-1 mod q."""
    conv = mod_up(xp, ring_p, ring_q,
                  mod_up_tables(ring_p.moduli, ring_q.moduli, ring_q.device))
    pinv = mod_down_tables(ring_q.moduli, ring_p.moduli, ring_q.device)
    return ring_q.mul_scalar_mont(ring_q.sub(xq, conv), pinv)


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
    modulus and are reduced by the NTT that follows)."""
    ls = x.shape[-2]
    if alpha == 1:
        return x[..., :, None, :].expand(
            *x.shape[:-2], ls, dst_ring.nlimbs, x.shape[-1])
    outs = []
    for lo in range(0, ls, alpha):
        hi = min(lo + alpha, ls)
        t = mod_up_tables(src_ring.moduli[lo:hi], dst_ring.moduli,
                          dst_ring.device)
        outs.append(mod_up(x[..., lo:hi, :], src_ring.take(lo, hi),
                           dst_ring, t))
    return torch.stack(outs, dim=-3)


def decompose_ntt(x, src_ring: Ring, dst_ring: Ring, alpha: int
                  ) -> torch.Tensor:
    """Gadget decomposition + forward NTT into the dst basis: coeff-domain
    (..., Ls, N) -> canonical NTT-domain digits (..., beta, Ld, N)."""
    return dst_ring.ntt(decompose_digits(x, src_ring, dst_ring, alpha))


# ----------------------------------------------------------------------------
# CKKS rescaling: exact divide-and-round by the last nb moduli
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rescale_consts(moduli: Tuple[int, ...], nb: int, device: torch.device):
    """For each of the nb dropped limbs (from the top): (half = q_last//2,
    half mod q_j for the remaining j, q_last^-1 mod q_j in Montgomery)."""
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


def div_round_by_last_moduli(x, ring_q: Ring, nb: int) -> torch.Tensor:
    """round(x / (q_{L-nb+1} * ... * q_L)) on canonical (..., L, N)
    coeff-domain polys; returns (..., L-nb, N). Lattigo's
    DivRoundByLastModulusMany, as used by Rescale."""
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
