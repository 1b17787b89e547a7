"""Key types and per-id registries (port of mkhe_tpu/mkrlwe/keys.py).

Storage conventions, the JAX package's:
  - secret keys, switching keys, CRS: NTT domain, Montgomery form
  - switching keys: (beta, Lq+Lp, N)
  - public keys: (2, Lq+Lp, N) NTT + Montgomery, pk = (-a s + e, a)
  - relinearization keys: v in NTT + Montgomery; b and d in NTT +
    DOUBLE-Montgomery (value * 2^64 mod q), so the x/y aggregation of
    keyswitch._aggregate_keys lands directly in Montgomery form;
  - rotation and conjugation keys: switching-key shaped, NTT + Montgomery.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SecretKey:
    id: str
    data: torch.Tensor  # (Lq+Lp, N)


@dataclasses.dataclass(frozen=True)
class PublicKey:
    id: str
    data: torch.Tensor  # (2, Lq+Lp, N)


@dataclasses.dataclass(frozen=True)
class SwitchingKey:
    data: torch.Tensor  # (beta, Lq+Lp, N)
    id: str = ""


@dataclasses.dataclass(frozen=True)
class RelinearizationKey:
    """KKLSS triple (b, d, v), each switching-key shaped."""
    b: torch.Tensor
    d: torch.Tensor
    v: torch.Tensor
    id: str = ""


@dataclasses.dataclass(frozen=True)
class RotationKey:
    data: torch.Tensor  # (beta, Lq+Lp, N)
    id: str = ""
    rot_idx: int = 0


@dataclasses.dataclass(frozen=True)
class ConjugationKey:
    data: torch.Tensor  # (beta, Lq+Lp, N)
    id: str = ""


class KeySet:
    """Generic id -> key registry (the reference's *Set types)."""

    def __init__(self):
        self.value: Dict[str, object] = {}

    def add(self, key):
        self.value[key.id] = key

    def get(self, pid: str):
        if pid not in self.value:
            raise KeyError(f"no key for id {pid!r}")
        return self.value[pid]

    def delete(self, pid: str):
        self.value.pop(pid, None)

    def ids(self) -> Tuple[str, ...]:
        return tuple(sorted(self.value))


class SecretKeySet(KeySet):
    pass


class PublicKeySet(KeySet):
    pass


class _StackedKeySet(KeySet):
    """A KeySet whose stacks over ids are memoised; add and delete drop
    them, so a key added or deleted later is never shadowed (the JAX
    package's RotationKeySet never drops its stacks)."""

    def __init__(self):
        super().__init__()
        self._cache = {}

    def add(self, key):
        self._store(key)
        self._cache.clear()

    def delete(self, pid: str):
        super().delete(pid)
        self._cache.clear()

    def _store(self, key):
        super().add(key)

    def _memo(self, key, make):
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]


class RelinearizationKeySet(_StackedKeySet):
    def stacked(self, ids: Tuple[str, ...]):
        """(b, d, v) stacked over ids, each (k, beta, Lqp, N); memoized so
        repeated evaluator calls reuse the tensors."""
        return self._memo(ids, lambda: tuple(
            torch.stack([getattr(self.get(i), f) for i in ids])
            for f in ("b", "d", "v")))


class RotationKeySet(_StackedKeySet):
    """id -> rot_idx -> RotationKey."""

    def _store(self, key: RotationKey):
        self.value.setdefault(key.id, {})[key.rot_idx] = key

    def get(self, pid: str, rot_idx: int) -> RotationKey:
        if not self.has(pid, rot_idx):
            raise KeyError(f"no rotation key for id {pid!r}, rotation "
                           f"{rot_idx}")
        return self.value[pid][rot_idx]

    def has(self, pid: str, rot_idx: int) -> bool:
        return pid in self.value and rot_idx in self.value[pid]

    def stacked(self, ids: Tuple[str, ...], rot_idx: int) -> torch.Tensor:
        """(k, beta, Lqp, N) stacked over ids, memoised."""
        return self._memo((ids, rot_idx), lambda: torch.stack(
            [self.get(i, rot_idx).data for i in ids]))


class ConjugationKeySet(_StackedKeySet):
    def stacked(self, ids: Tuple[str, ...]) -> torch.Tensor:
        """(k, beta, Lqp, N) stacked over ids, memoised."""
        return self._memo(ids, lambda: torch.stack(
            [self.get(i).data for i in ids]))
