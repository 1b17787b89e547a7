"""CKKS ciphertext (multi-key ciphertext + scale) and complex message
(port of mkhe_tpu/mkckks/elements.py)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..mkrlwe.elements import Ciphertext as RlweCiphertext


@dataclasses.dataclass(frozen=True)
class Ciphertext:
    ct: RlweCiphertext
    scale: float

    @property
    def ids(self) -> Tuple[str, ...]:
        return self.ct.ids

    @property
    def level(self) -> int:
        return self.ct.level


@dataclasses.dataclass
class Message:
    value: np.ndarray  # complex128 (slots,)
