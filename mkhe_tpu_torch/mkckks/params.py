"""Multi-key CKKS parameters (port of mkhe_tpu/mkckks/params.py).

The presets are the JAX package's, prime for prime: each of the
reference's 47-60-bit primes is a pair of < 2^29 NTT primes, at the
reference's ring degree, slot count, scale and total modulus size.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
from typing import Tuple

from .. import config
from .. import mkrlwe
from ..ops.primes import ntt_primes


@dataclasses.dataclass(frozen=True, eq=False)
class Parameters:
    rlwe: mkrlwe.Parameters
    logslots: int
    scale: float

    @property
    def logn(self) -> int:
        return self.rlwe.logn

    @property
    def n(self) -> int:
        return self.rlwe.n

    @property
    def slots(self) -> int:
        return 1 << self.logslots

    @property
    def max_level(self) -> int:
        return self.rlwe.max_level

    def add_crs(self, idx: int) -> "Parameters":
        return dataclasses.replace(self, rlwe=mkrlwe.add_crs(self.rlwe, idx))


def _distinct(*groups):
    seen = set()
    for g in groups:
        for q in g:
            if q in seen:
                raise ValueError("prime collision across groups")
            seen.add(q)


def select_moduli(logn: int, q0_bits: float, level_bits: float,
                  levels: int, q0_count: int = 2,
                  limbs_per_level: int = 2, p_bits: float = 28.4,
                  p_count: int = 2):
    """(q_moduli, p_moduli) as mkhe_tpu.mkckks.params.select_moduli
    chooses them."""
    q0 = ntt_primes(logn, q0_bits, q0_count)
    if limbs_per_level == 2:
        # Balance each level's prime pair so its product stays ~ scale:
        # choose pairs from an oversized pool, closest product first.
        pool = list(ntt_primes(logn, level_bits,
                               4 * levels * limbs_per_level + 16))
        target = 2.0 ** (2 * level_bits)
        pairs = []
        for _ in range(levels):
            best = None
            for i in range(len(pool)):
                for j in range(i + 1, len(pool)):
                    err = abs(pool[i] * pool[j] / target - 1.0)
                    if best is None or err < best[0]:
                        best = (err, i, j)
            _, i, j = best
            pairs.append((pool[i], pool[j]))
            pool = [p for k, p in enumerate(pool) if k not in (i, j)]
        lv = tuple(p for pair in pairs for p in pair)
    else:
        lv = ntt_primes(logn, level_bits, levels * limbs_per_level)
    # avoid collisions when size classes coincide: skip past earlier draws
    skip = 0
    if abs(p_bits - level_bits) < 0.3:
        skip += (4 * levels * limbs_per_level + 16
                 if limbs_per_level == 2 else levels * limbs_per_level)
    if abs(p_bits - q0_bits) < 0.3:
        skip += q0_count
    p = ntt_primes(logn, p_bits, p_count, skip=skip)
    _distinct(q0, lv, p)
    return tuple(q0) + tuple(lv), tuple(p)


def new_parameters(logn: int, logslots: int, q0_bits: float,
                   level_bits: float, levels: int, scale: float,
                   gamma: int = 2, q0_count: int = 2,
                   limbs_per_level: int = 2,
                   p_bits: float = 28.4, p_count: int = 2,
                   extra_crs=(), unsafe_skip_noise_guard: bool = False,
                   device=None) -> Parameters:
    """q0_count primes ~q0_bits for the base modulus, `levels` rescaling
    levels of limbs_per_level primes each (product ~ scale), and p_count
    special primes; alpha = p_count // gamma limbs per gadget digit.
    extra_crs and unsafe_skip_noise_guard go to mkrlwe.new_parameters."""
    q_moduli, p = select_moduli(logn, q0_bits, level_bits, levels,
                                q0_count, limbs_per_level, p_bits,
                                p_count)
    rl = mkrlwe.new_parameters(
        logn, q_moduli, p, gamma=gamma, extra_crs=extra_crs,
        unsafe_skip_noise_guard=unsafe_skip_noise_guard, device=device)
    return Parameters(rlwe=rl, logslots=logslots, scale=scale)


def from_literal(doc, device=None) -> Parameters:
    """Parameters from a reference-style ParametersLiteral JSON document
    (a path or a dict; the schema of the reference's `-params` flag,
    mkrlwe/mkrlwe_test.go:18,56-60), with mkhe_tpu.mkckks.from_literal's
    prime selection:

        {"LogN": 14, "LogSlots": 13, "Q": [primes...], "P": [primes...],
         "Scale": 2^52, "Gamma": 2}

    Q / P entries may be ints, hex strings or bit sizes (floats < 64).
    Each 64-bit modulus maps to a pair of ~half-width u32 NTT primes whose
    product is within ~1e-3 of it (a triple above ~57.8 bits: limbs stay
    below 2^29); total modulus size, scale and level budget are kept."""
    if isinstance(doc, str):
        with open(doc) as f:
            doc = json.load(f)
    logn = int(doc["LogN"])
    logslots = int(doc.get("LogSlots", logn - 1))
    scale = float(doc.get("Scale", 2.0 ** 40))
    gamma = int(doc.get("Gamma", 2))

    def bits_of(entry) -> float:
        if isinstance(entry, str):
            return math.log2(int(entry, 0))
        if isinstance(entry, float) and entry < 64:
            return entry
        return math.log2(int(entry))

    used = set()

    def split(bits: float, parts: int) -> Tuple[int, ...]:
        """`parts` distinct u32 NTT primes with product ~ 2^bits."""
        pool = [p for p in ntt_primes(logn, bits / parts, 24 + 2 * parts)
                if p not in used]
        target = 2.0 ** bits
        if parts == 1:
            best = min(pool, key=lambda p: abs(p / target - 1.0))
            used.add(best)
            return (best,)
        best = None
        for i in range(len(pool)):
            for j in range(i + 1, len(pool)):
                base = pool[i] * pool[j]
                if parts == 2:
                    err = abs(base / target - 1.0)
                    if best is None or err < best[0]:
                        best = (err, (pool[i], pool[j]))
                else:
                    for k in range(j + 1, len(pool)):
                        err = abs(base * pool[k] / target - 1.0)
                        if best is None or err < best[0]:
                            best = (err, (pool[i], pool[j], pool[k]))
        used.update(best[1])
        return best[1]

    def to_limbs(entries) -> Tuple[int, ...]:
        out = []
        for b in map(bits_of, entries):
            out.extend(split(b, 1 if b <= 28.9 else 2 if b <= 57.8 else 3))
        return tuple(out)

    q_moduli = to_limbs(doc["Q"])
    p_moduli = to_limbs(doc["P"])
    rl = mkrlwe.new_parameters(logn, q_moduli, p_moduli, gamma=gamma,
                               device=device)
    return Parameters(rlwe=rl, logslots=logslots, scale=scale)


# -- presets (equivalents of the reference parameter sets) -------------------

def PN15QP880(device=None) -> Parameters:
    """logN=15, 14 levels: q0 ~58b + 13 x ~54b (27b pairs), P ~114b in
    four limbs (alpha = 2, beta = 14), scale 2^54
    (reference: mkckks/mkckks_test.go:51-72)."""
    return _preset("PN15QP880", config.get_device(device))


def PN14QP439(device=None) -> Parameters:
    """logN=14, q0 ~58b + 5 x ~52b (26b pairs), scale 2^52
    (reference: mkckks/mkckks_test.go:73-91)."""
    return _preset("PN14QP439", config.get_device(device))


def PN14QP433_CNN(device=None) -> Parameters:
    """logN=14, q0 ~57b + 6 x ~47b (23.5b pairs), scale 2^47
    (reference: cnn/cnn_test.go:80-97)."""
    return _preset("PN14QP433_CNN", config.get_device(device))


_PRESETS = {
    "PN15QP880": dict(logn=15, logslots=14, q0_bits=28.9, level_bits=27.0,
                      levels=13, scale=2.0 ** 54, p_bits=28.4, p_count=4),
    "PN14QP439": dict(logn=14, logslots=13, q0_bits=28.9, level_bits=26.0,
                      levels=5, scale=2.0 ** 52, p_bits=28.4, p_count=4),
    "PN14QP433_CNN": dict(logn=14, logslots=13, q0_bits=28.4,
                          level_bits=23.5, levels=6, scale=2.0 ** 47,
                          p_bits=23.5, p_count=4),
}


@functools.lru_cache(maxsize=None)
def _preset(name: str, device) -> Parameters:
    return new_parameters(**_PRESETS[name], device=device)
