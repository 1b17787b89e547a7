"""Key types and per-id registries (port of mkhe_tpu/mkrlwe/keys.py).

Storage conventions, the JAX package's:
  - secret keys, switching keys, CRS: NTT domain, Montgomery form
  - switching keys: (beta, Lq+Lp, N)
  - public keys: (2, Lq+Lp, N) NTT + Montgomery, pk = (-a s + e, a)
  - relinearization keys: v in NTT + Montgomery; b and d in NTT +
    DOUBLE-Montgomery (value * 2^64 mod q), so the x/y aggregation of
    keyswitch._aggregate_keys lands directly in Montgomery form.
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


class SecretKeySet(KeySet):
    pass


class PublicKeySet(KeySet):
    pass


class RelinearizationKeySet(KeySet):
    def __init__(self):
        super().__init__()
        self._cache = {}

    def add(self, key):
        super().add(key)
        self._cache.clear()

    def stacked(self, ids: Tuple[str, ...]):
        """(b, d, v) stacked over ids, each (k, beta, Lqp, N); memoized so
        repeated evaluator calls reuse the tensors."""
        if ids not in self._cache:
            self._cache[ids] = tuple(
                torch.stack([getattr(self.get(i), f) for i in ids])
                for f in ("b", "d", "v"))
        return self._cache[ids]
