"""BFV integer slot encoder (port of mkhe_tpu/mkbfv/encoder.py; lattigo
bfv.Encoder's EncodeInt/DecodeInt as used at mkbfv/encryptor.go:39,
decryptor.go:54).

Slots live in the NTT domain of the plaintext ring Z_t[X]/(X^N+1), in the
bit-reversed rotation-group order of the rest of the framework; the
transforms mod t run on ring_t, on the params' device.

Encode: slots -> poly m mod t -> round(Q*m/t) mod each q_j, using q_j | Q:
round(Q*m/t) = (h - s) * t^-1 (mod q_j), h = t >> 1, s = (Q*m + h) mod t.
Decode: round(t*c/Q) mod t by the native C++ exact CRT (mkhe_tpu_torch/
native, as mkhe_tpu/mkbfv/encoder.py:84-86) -> forward NTT mod t -> slots,
centered.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import native
from ..ops.ring import _brv_vec
from .params import Parameters


@functools.lru_cache(maxsize=None)
def _slot_order(logn: int) -> np.ndarray:
    """Value index c (column c, row 0) sits at the NTT slot evaluating at
    psi^(5^c); value N/2 + c (row 1) at psi^(-5^c): the Galois element
    5^k cycles columns and 2N-1 swaps rows (lattigo's BFV slot layout)."""
    n = 1 << logn
    slot_of_exp = np.empty(2 * n, np.int64)
    slot_of_exp[2 * _brv_vec(logn) + 1] = np.arange(n)
    e = np.empty(n // 2, np.int64)
    cur = 1
    for c in range(n // 2):
        e[c] = cur
        cur = cur * 5 % (2 * n)
    return np.concatenate([slot_of_exp[e], slot_of_exp[2 * n - e]])


@functools.lru_cache(maxsize=None)
def _scaleup_consts(q_moduli, t: int, device):
    """(Q mod t, t^-1 mod q_j as an (Lq, 1) tensor)."""
    tinv = torch.tensor([pow(t % q, -1, q) for q in q_moduli],
                        dtype=torch.int64, device=device)
    return math.prod(q_moduli) % t, tinv[:, None]


def encode(params: Parameters, values) -> torch.Tensor:
    """int slot values (up to N) -> plaintext (Lq, N) int64 on the params'
    device, scaled by Q/t."""
    t, n = params.t, params.n
    vals = np.zeros(n, np.int64)
    v = np.asarray(values, np.int64)
    vals[:v.shape[0]] = np.mod(v, t)
    slots = np.empty(n, np.int64)
    slots[_slot_order(params.logn)] = vals
    m = params.ring_t.intt(torch.from_numpy(slots[None]).to(params.device))
    qmodt, tinv = _scaleup_consts(params.rlwe.q_moduli, t, params.device)
    h = t >> 1
    diff = h - (qmodt * m + h) % t                     # in (-t, t)
    q = params.ring_q.q[:, None]
    return (diff % q) * tinv % q


def decode(params: Parameters, poly) -> np.ndarray:
    """Decrypted (Lq, N) plaintext (tensor or uint32 array) -> int64 slot
    values (N,), centered, exact."""
    t = params.t
    poly = (poly.cpu().numpy() if isinstance(poly, torch.Tensor)
            else np.asarray(poly))
    moduli = params.rlwe.q_moduli[:poly.shape[0]]
    m = native.bfv_decode_scale(poly, moduli, t).astype(np.int64)
    slots = params.ring_t.ntt(torch.from_numpy(m[None]).to(params.device))
    out = slots[0].cpu().numpy()[_slot_order(params.logn)]
    return np.where(out > t // 2, out - t, out)
