"""Multi-key ciphertext elements (port of mkhe_tpu/mkrlwe/elements.py).

A multi-key ciphertext is an int64 (k+1, L, N) tensor with a sorted tuple
of party ids: data[0] is the '0' component, data[1 + i] belongs to
ids[i]. Coefficient domain unless stated otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Ciphertext:
    ids: Tuple[str, ...]
    data: torch.Tensor  # (k+1, L, N), coefficient domain

    @property
    def level(self) -> int:
        return self.data.shape[-2] - 1


def union_ids(a: Tuple[str, ...], b: Tuple[str, ...]) -> Tuple[str, ...]:
    return tuple(sorted(set(a) | set(b)))


def drop_level(ct: Ciphertext, levels: int) -> Ciphertext:
    """Truncate the top `levels` limbs (reference DropLevel)."""
    if levels <= 0:
        return ct
    return Ciphertext(ids=ct.ids,
                      data=ct.data[..., :ct.level + 1 - levels, :])


@dataclasses.dataclass(frozen=True)
class HoistedCiphertext:
    """Gadget decomposition of each party polynomial, NTT domain:
    digits (k, beta, Lqp, N)."""
    ids: Tuple[str, ...]
    digits: torch.Tensor
