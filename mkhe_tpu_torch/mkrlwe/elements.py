"""Multi-key ciphertext elements (port of mkhe_tpu/mkrlwe/elements.py).

A multi-key ciphertext is an int64 (k+1, L, N) tensor with a sorted tuple
of party ids: data[0] is the '0' component, data[1 + i] belongs to
ids[i]. Coefficient domain unless stated otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..utils.profiling import span


@dataclasses.dataclass(frozen=True)
class Ciphertext:
    ids: Tuple[str, ...]
    data: torch.Tensor  # (k+1, L, N), coefficient domain

    @property
    def level(self) -> int:
        return self.data.shape[-2] - 1

    @property
    def c0(self) -> torch.Tensor:
        return self.data[0]

    def party(self, pid: str) -> torch.Tensor:
        return self.data[1 + self.ids.index(pid)]


def new_ciphertext(params, ids: Tuple[str, ...], level: int) -> Ciphertext:
    """A zero ciphertext over the sorted ids at level, on params' device."""
    ids = tuple(sorted(ids))
    return Ciphertext(ids=ids, data=torch.zeros(
        (len(ids) + 1, level + 1, params.n), dtype=torch.int64,
        device=params.device))


def union_ids(a: Tuple[str, ...], b: Tuple[str, ...]) -> Tuple[str, ...]:
    return tuple(sorted(set(a) | set(b)))


def _union_combine(ring, ct0: Ciphertext, ct1: Ciphertext, op, lone_b
                   ) -> Ciphertext:
    """ct0 op ct1 over the union of their party ids (the add / sub of
    mkckks/evaluator.go:200-304): op(ring, a, b) on c0 and on each party
    both hold, a party of ct0 alone keeps its row, and one of ct1 alone
    becomes lone_b(ring, b)."""
    ids = union_ids(ct0.ids, ct1.ids)
    out = [op(ring, ct0.c0, ct1.c0)]
    for pid in ids:
        if pid not in ct1.ids:
            out.append(ct0.party(pid))
        elif pid not in ct0.ids:
            out.append(lone_b(ring, ct1.party(pid)))
        else:
            out.append(op(ring, ct0.party(pid), ct1.party(pid)))
    return Ciphertext(ids=ids, data=torch.stack(out))


_batches = {"calls": 0, "pairs": 0}


def stack_batch(cts0, cts1, shared=lambda c: c.ids,
                message="batch must share the id tuple"):
    """The two sides of a batched mult of B pairs, checked and stacked
    behind the party axis, (k+1, B, L, N) each, so that every launch of
    the mult covers B times the rows of one. A side is a list of
    Ciphertexts, or of a scheme's ciphertexts that hold one as `.ct`
    (CKKS); the sides are equally long and not empty, and the members of
    each agree on `shared(c)` (else ValueError(message)). L is the lower
    side's limb count: the other side is dropped to that level, as a
    single mult does. Counts the call and its pairs (batch_counters)."""
    if len(cts0) != len(cts1) or not cts0:
        raise ValueError("need equal-length non-empty batches")
    for side in (cts0, cts1):
        if any(shared(c) != shared(side[0]) for c in side):
            raise ValueError(message)
    data = [[getattr(c, "ct", c).data for c in side] for side in (cts0, cts1)]
    limbs = min(side[0].shape[-2] for side in data)
    with span("batch.stack"):
        out = tuple(torch.stack([d[..., :limbs, :] for d in side], dim=1)
                    for side in data)
    _batches["calls"] += 1
    _batches["pairs"] += len(cts0)
    return out


def split_batch(data: torch.Tensor, ids: Tuple[str, ...]) -> list:
    """The inverse of stack_batch: the B Ciphertexts over ids of a batched
    result (k+1, B, L, N), each a contiguous (k+1, L, N) tensor."""
    with span("batch.split"):
        return [Ciphertext(ids=ids, data=d)
                for d in data.movedim(1, 0).contiguous()]


def batch_counters() -> dict:
    """Batched mults (`calls`) and their pairs (`pairs`) stacked since the
    last reset_batch_counters()."""
    return dict(_batches)


def reset_batch_counters() -> None:
    _batches.update(calls=0, pairs=0)


def pad_ciphertext(ct: Ciphertext, ids: Tuple[str, ...]) -> Ciphertext:
    """Zero-pad to the union with ids (reference PadCiphertext,
    mkrlwe/elements.go:91-105); ct itself if nothing is added."""
    new_ids = union_ids(ct.ids, ids)
    if new_ids == ct.ids:
        return ct
    out = ct.data.new_zeros((len(new_ids) + 1, *ct.data.shape[1:]))
    out[0] = ct.data[0]
    for i, pid in enumerate(ct.ids):
        out[1 + new_ids.index(pid)] = ct.data[1 + i]
    return Ciphertext(ids=new_ids, data=out)


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
