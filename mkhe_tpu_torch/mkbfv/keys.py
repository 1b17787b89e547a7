"""BFV relinearization keys (port of mkhe_tpu/mkbfv/keys.py).

The reference stores a pair of mkrlwe relinearization keys, one per half
of the double basis R. Here the pair is fused, as in the JAX package: b
and d are (2*beta, Lq+Lp, N) switching-key vectors (the first beta digits
decompose over the Q half of R, the last beta over the QMul half), and v
is the shared (beta, Lq+Lp, N) vector of the final Q-basis fixup products
(mkbfv/keyswitch.go:230-250). b and d are NTT + DOUBLE-Montgomery, v NTT +
Montgomery, the forms of mkrlwe's keys, so mkrlwe's containers (with
RelinearizationKeySet.stacked) hold them as they are.
"""

from ..mkrlwe.keys import RelinearizationKey, RelinearizationKeySet

__all__ = ["RelinearizationKey", "RelinearizationKeySet"]
