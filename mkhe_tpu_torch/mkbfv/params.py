"""Multi-key BFV parameters with the double RNS basis Q, QMul, R = Q*QMul
(port of mkhe_tpu/mkbfv/params.py).

len(Q) == len(QMul); tensor products are computed in the extended basis R
(twice the limbs: Q limbs, then QMul limbs) and quantized by t/QMul back
to Q. The plaintext modulus T = 65537 is NTT-friendly for logN <= 15, so
the slot encoder runs the ring machinery over T, on the params' device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

from .. import config
from .. import mkrlwe
from ..ops.primes import ntt_primes
from ..ops.ring import Ring


@dataclasses.dataclass(frozen=True, eq=False)
class Parameters:
    rlwe: mkrlwe.Parameters       # over Q, P (carries the CRS)
    qmul_moduli: Tuple[int, ...]
    t: int

    @property
    def logn(self) -> int:
        return self.rlwe.logn

    @property
    def n(self) -> int:
        return self.rlwe.n

    @property
    def max_level(self) -> int:
        return self.rlwe.max_level

    @property
    def device(self):
        return self.rlwe.device

    @property
    def ring_q(self) -> Ring:
        return self.rlwe.ring_q

    @property
    def ring_qmul(self) -> Ring:
        return Ring.create(self.qmul_moduli, self.logn, self.device)

    @functools.cached_property
    def ring_r(self) -> Ring:
        """R = Q ++ QMul (limb order: Q limbs, then QMul limbs)."""
        return self.ring_q.concat(self.ring_qmul)

    @property
    def ring_t(self) -> Ring:
        return Ring.create((self.t,), self.logn, self.device)


def new_parameters(logn: int, q_moduli, qmul_moduli, p_moduli,
                   t: int = 65537, gamma: int = 2, device=None
                   ) -> Parameters:
    if len(q_moduli) != len(qmul_moduli):
        raise ValueError("Q and QMul must have equal length "
                         "(mkbfv/params.go:38-40)")
    alpha = max(1, len(p_moduli) // gamma)
    if len(q_moduli) % alpha:
        raise ValueError("limb count must be a multiple of alpha (digit "
                         "blocks must not straddle the Q/QMul boundary "
                         "of R)")
    rl = mkrlwe.new_parameters(logn, tuple(q_moduli), tuple(p_moduli),
                               gamma=gamma, device=device)
    return Parameters(rlwe=rl, qmul_moduli=tuple(int(q) for q in qmul_moduli),
                      t=int(t))


def preset_moduli(name: str):
    """(logn, q_moduli, qmul_moduli, p_moduli) of a preset, as
    mkhe_tpu.mkbfv.params chooses them."""
    logn, bits, count = _PRESETS[name]
    return (logn, ntt_primes(logn, bits, count),
            ntt_primes(logn, bits, count, skip=count),
            ntt_primes(logn, 28.4, 4))


def PN15QP880(device=None) -> Parameters:
    """logN=15: Q = QMul ~ 764 bits each (28 x ~27.3b limbs), P ~114b in
    four limbs (alpha 2, beta 14), T = 65537
    (reference: mkbfv/mkbfv_test.go:28-75)."""
    return _preset("PN15QP880", config.get_device(device))


def PN14QP439(device=None) -> Parameters:
    """logN=14: Q = QMul ~ 319 bits (12 x ~26.6b limbs), P ~114b, T = 65537
    (reference: mkbfv/mkbfv_test.go:77-108)."""
    return _preset("PN14QP439", config.get_device(device))


_PRESETS = {"PN15QP880": (15, 27.3, 28), "PN14QP439": (14, 26.6, 12)}


@functools.lru_cache(maxsize=None)
def _preset(name: str, device) -> Parameters:
    logn, q, qmul, p = preset_moduli(name)
    return new_parameters(logn, q, qmul, p, device=device)
