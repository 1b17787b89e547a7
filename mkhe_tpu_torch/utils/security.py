"""RLWE security from the Homomorphic Encryption Standard (port of
mkhe_tpu/utils/security.py, pure Python).

Given (logN, total modulus bits), the largest standard security level the
parameters admit, per the HE Standard v1.1 tables (homomorphicencryption.org,
Table 1, ternary secret, error stddev 3.2), the tables lattigo validates
its published parameter sets (PN14QP439, PN15QP880) against.
"""

from __future__ import annotations

import math
from typing import Tuple

# max log2(QP) for security in {128, 192, 256} bits, ternary secrets
_TERNARY_MAX_LOGQP = {
    10: (27, 19, 14),
    11: (54, 37, 27),
    12: (109, 75, 57),
    13: (218, 152, 118),
    14: (438, 305, 237),
    15: (881, 611, 476),
    16: (1772, 1228, 953),
    17: (3576, 2463, 1907),
}

_LEVELS = (128, 192, 256)


def max_logqp(logn: int, security: int = 128) -> int:
    """Maximum total modulus bits (log2 of Q*P) for the ring degree and
    security level, ternary secrets."""
    if logn not in _TERNARY_MAX_LOGQP:
        raise ValueError(f"no standard entry for logN={logn}")
    if security not in _LEVELS:
        raise ValueError(f"security must be one of {_LEVELS}")
    return _TERNARY_MAX_LOGQP[logn][_LEVELS.index(security)]


def logqp(q_moduli, p_moduli=()) -> float:
    """Total log2 of the modulus chain."""
    return sum(math.log2(q) for q in tuple(q_moduli) + tuple(p_moduli))


def security_bits(logn: int, total_logqp: float) -> int:
    """Largest standard level (128 / 192 / 256) the parameters admit, or 0
    if not even 128. The table is a step function over logN; above logN 17
    the 2^17 row is scaled linearly in N (conservative)."""
    if logn not in _TERNARY_MAX_LOGQP:
        scale = (1 << logn) / (1 << 17)
        row = tuple(int(b * scale) for b in _TERNARY_MAX_LOGQP[17])
    else:
        row = _TERNARY_MAX_LOGQP[logn]
    out = 0
    for lvl, cap in zip(_LEVELS, row):
        if total_logqp <= cap:
            out = max(out, lvl)
    return out


def check_security(logn: int, q_moduli, p_moduli=(), minimum: int = 128
                   ) -> Tuple[int, float]:
    """(security level, total logQP); raises if below `minimum`."""
    total = logqp(q_moduli, p_moduli)
    lvl = security_bits(logn, total)
    if lvl < minimum:
        cap = (max_logqp(logn, minimum) if logn in _TERNARY_MAX_LOGQP
               else "n/a")
        raise ValueError(
            f"parameters below {minimum}-bit security: logN={logn}, "
            f"logQP={total:.1f} > standard cap {cap}")
    return lvl, total
