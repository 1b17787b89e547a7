"""Carry the JAX package's state across as numpy arrays.

Each function takes what mkhe_tpu holds (np.asarray of its jax arrays,
uint32) and builds the port's object on a given device, so that both
packages can compute the same thing from the same state. Nothing here
imports JAX: the caller converts with np.asarray.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import numpy as np
import torch

from . import mkckks, mkrlwe
from .config import get_device


def tensor(a, device=None) -> torch.Tensor:
    """uint32 (or any integer) array -> int64 tensor on the device."""
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(
        get_device(device))


def rlwe_parameters(logn: int, q_moduli: Sequence[int],
                    p_moduli: Sequence[int], gamma: int, sigma: float,
                    crs: Mapping[int, np.ndarray], crs_seed: int = 0,
                    device=None) -> mkrlwe.Parameters:
    """mkrlwe Parameters with the given CRS (idx -> (beta, Lqp, N) NTT +
    Montgomery), e.g. the JAX package's params.crs."""
    return mkrlwe.params.build_parameters(
        int(logn), tuple(int(q) for q in q_moduli),
        tuple(int(p) for p in p_moduli), int(gamma), float(sigma),
        crs_seed, device,
        crs={int(i): tensor(a, device) for i, a in crs.items()})


def ckks_parameters(rlwe: mkrlwe.Parameters, logslots: int, scale: float
                    ) -> mkckks.Parameters:
    return mkckks.Parameters(rlwe=rlwe, logslots=int(logslots),
                             scale=float(scale))


def secret_key(pid: str, data, device=None) -> mkrlwe.SecretKey:
    return mkrlwe.SecretKey(id=pid, data=tensor(data, device))


def public_key(pid: str, data, device=None) -> mkrlwe.PublicKey:
    return mkrlwe.PublicKey(id=pid, data=tensor(data, device))


def relinearization_key(pid: str, b, d, v, device=None
                        ) -> mkrlwe.RelinearizationKey:
    return mkrlwe.RelinearizationKey(id=pid, b=tensor(b, device),
                                     d=tensor(d, device),
                                     v=tensor(v, device))


def secret_key_set(keys: Mapping[str, np.ndarray], device=None
                   ) -> mkrlwe.SecretKeySet:
    out = mkrlwe.SecretKeySet()
    for pid, data in keys.items():
        out.add(secret_key(pid, data, device))
    return out


def public_key_set(keys: Mapping[str, np.ndarray], device=None
                   ) -> mkrlwe.PublicKeySet:
    out = mkrlwe.PublicKeySet()
    for pid, data in keys.items():
        out.add(public_key(pid, data, device))
    return out


def relinearization_key_set(keys: Mapping[str, Tuple], device=None
                            ) -> mkrlwe.RelinearizationKeySet:
    """keys: id -> (b, d, v)."""
    out = mkrlwe.RelinearizationKeySet()
    for pid, (b, d, v) in keys.items():
        out.add(relinearization_key(pid, b, d, v, device))
    return out


def rlwe_ciphertext(ids: Sequence[str], data, device=None
                    ) -> mkrlwe.Ciphertext:
    return mkrlwe.Ciphertext(ids=tuple(ids), data=tensor(data, device))


def ckks_ciphertext(ids: Sequence[str], data, scale: float, device=None
                    ) -> mkckks.Ciphertext:
    return mkckks.Ciphertext(ct=rlwe_ciphertext(ids, data, device),
                             scale=float(scale))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor of u32 values -> numpy uint32 (the JAX layout)."""
    return t.cpu().numpy().astype(np.uint32)

