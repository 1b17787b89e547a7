"""Party id sets (port of mkhe_tpu/mkrlwe/idset.py, pure Python).

The framework passes sorted tuples of ids; this class gives the
reference's set API (mkrlwe/idset.go) on top.
"""

from __future__ import annotations

from typing import Iterable, Tuple

_RESERVED = 'id "0" is reserved (idset.go:13-15)'


class IDSet:
    def __init__(self, ids: Iterable[str] = ()):
        vals = set(ids)
        if "0" in vals:
            raise ValueError(_RESERVED)
        self.value = vals

    def has(self, v: str) -> bool:
        return v in self.value

    def add(self, v: str) -> None:
        if v == "0":
            raise ValueError(_RESERVED)
        self.value.add(v)

    def remove(self, v: str) -> None:
        self.value.discard(v)

    def size(self) -> int:
        return len(self.value)

    def union(self, other: "IDSet") -> "IDSet":
        return IDSet(self.value | other.value)

    def intersection(self, other: "IDSet") -> "IDSet":
        return IDSet(self.value & other.value)

    def copy(self) -> "IDSet":
        return IDSet(self.value)

    def as_tuple(self) -> Tuple[str, ...]:
        return tuple(sorted(self.value))

    def __iter__(self):
        return iter(sorted(self.value))

    def __len__(self):
        return len(self.value)

    def __contains__(self, v):
        return v in self.value
