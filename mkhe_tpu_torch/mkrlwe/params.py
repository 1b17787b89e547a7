"""Multi-key RLWE parameters with common reference strings (CRS).

Port of mkhe_tpu/mkrlwe/params.py. A CRS is a uniform (beta, Lq+Lp, N)
polynomial vector, NTT domain by fiat, stored in Montgomery form. Each is
drawn, as in the JAX package, under the threefry key
fold_in(key(crs_seed), idx) (ops/threefry.py), on the parameters' device,
so that both packages build the same CRS from the same crs_seed.

new_parameters draws the JAX package's index set, all of it at
construction (default_crs_indices): 0 (public and relinearization keys),
-1 (the relinearization u), -2 (conjugation), -3 and -4 (the MKBFV
relinearization key), every power of two below N/2 (rotations) and the
caller's extra_crs. Nothing is drawn later, so a fused capture (fuse.py)
never builds a CRS; add_crs adds one more index by hand. At PN15QP880
each CRS is 14 x 32 x 2^15 int64, 117 MB, and the 19 default ones take
2.23 GB of the device.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, Tuple

import torch

from .. import config
from ..ops import modmath as mm
from ..ops import sampling, threefry
from ..ops.ring import Ring
from ..utils import security


def default_crs_indices(logn: int, extra_crs=()) -> Tuple[int, ...]:
    """The CRS indices new_parameters draws, the JAX package's rule
    (mkhe_tpu/mkrlwe/params.py:178-180): 0, -1, -2, -3, -4, then 2^i for
    i < logN - 1, then extra_crs."""
    return ((0, -1, -2, -3, -4) + tuple(1 << i for i in range(logn - 1))
            + tuple(int(i) for i in extra_crs))


@dataclasses.dataclass(frozen=True, eq=False)
class Parameters:
    logn: int
    q_moduli: Tuple[int, ...]
    p_moduli: Tuple[int, ...]
    gamma: int
    sigma: float
    crs_seed: int
    device: torch.device
    ring_q: Ring
    ring_p: Ring
    ring_qp: Ring
    crs: Dict[int, torch.Tensor]   # idx -> (beta, Lq+Lp, N) NTT + Mont
    pmodq_mont: torch.Tensor       # (Lq,) P mod q_j, Montgomery form
    # level-sliced rings and index tensors, memoized; init=False, so that
    # dataclasses.replace (add_crs, with_dist) starts from an empty memo
    # rather than hand the new object the old one's rings
    _rings: dict = dataclasses.field(default_factory=dict, init=False,
                                     compare=False, repr=False)

    # -- derived sizes ------------------------------------------------------

    @property
    def n(self) -> int:
        return 1 << self.logn

    @property
    def qcount(self) -> int:
        return len(self.q_moduli)

    @property
    def pcount(self) -> int:
        return len(self.p_moduli)

    @property
    def max_level(self) -> int:
        return self.qcount - 1

    @property
    def alpha(self) -> int:
        """Limbs per gadget digit (params.Alpha(), mkrlwe/params.go:63-65)."""
        return max(1, self.pcount // self.gamma)

    def beta(self, level: int) -> int:
        """Digit count at a given level (params.Beta, mkrlwe/params.go:67)."""
        return -(-(level + 1) // self.alpha)

    # -- level-sliced rings (memoized: the QP ring is a concatenation) ------

    def ring_q_at(self, level: int) -> Ring:
        if level == self.max_level:
            return self.ring_q
        key = ("q", level)
        if key not in self._rings:
            self._rings[key] = self.ring_q.take(0, level + 1)
        return self._rings[key]

    def ring_qp_at(self, level: int) -> Ring:
        if level == self.max_level:
            return self.ring_qp
        key = ("qp", level)
        if key not in self._rings:
            self._rings[key] = self.ring_q_at(level).concat(self.ring_p)
        return self._rings[key]

    def qp_limb_index(self, level: int) -> torch.Tensor:
        """Indices into the full (Lq+Lp) limb axis selecting the level's Q
        limbs plus all P limbs (for slicing CRS and switching keys);
        memoized, so that a captured CUDA graph copies nothing from the
        host (fuse.py)."""
        key = ("qp_index", level)
        if key not in self._rings:
            self._rings[key] = torch.cat([
                torch.arange(level + 1),
                torch.arange(self.qcount, self.qcount + self.pcount)]
            ).to(self.device)
        return self._rings[key]

    def with_dist(self, group, n_shards: int) -> "Parameters":
        """These parameters with all three rings coefficient-sharded over
        `group` (Ring.with_dist), so that every NTT inside the evaluator's
        functions runs the sharded transform on local chunks; the
        level-sliced rings made from them carry the same setting."""
        ring_q = self.ring_q.with_dist(group, n_shards)
        ring_p = self.ring_p.with_dist(group, n_shards)
        return dataclasses.replace(self, ring_q=ring_q, ring_p=ring_p,
                                   ring_qp=ring_q.concat(ring_p))

    def crs_at(self, idx: int, level: int) -> torch.Tensor:
        """CRS for index idx, sliced to (beta(level), level+1+Lp, N)."""
        a = self.crs[idx]
        if level == self.max_level:
            return a
        return a[:self.beta(level)][:, self.qp_limb_index(level), :]


def gen_crs(ring_qp: Ring, beta: int, seed: int, idx: int) -> torch.Tensor:
    """The CRS at idx: uniform under fold_in(key(seed), idx), both taken
    mod 2^32, in Montgomery form (mkhe_tpu/mkrlwe/params.py:101-120)."""
    key = threefry.fold_in(threefry.key(seed), idx)
    return ring_qp.to_mont(sampling.uniform(key, ring_qp, beta))


def build_parameters(logn: int, q_moduli, p_moduli, gamma: int,
                     sigma: float, crs_seed: int, device,
                     crs: Dict[int, torch.Tensor] | None = None,
                     extra_crs=()) -> Parameters:
    """Assemble Parameters from moduli; draws the default CRS set and
    extra_crs unless a CRS dict is given (convert.py passes the JAX
    package's)."""
    device = config.get_device(device)
    ring_q = Ring.create(q_moduli, logn, device)
    ring_p = Ring.create(p_moduli, logn, device)
    ring_qp = ring_q.concat(ring_p)
    P = math.prod(p_moduli)
    pmodq = torch.tensor([mm.to_mont_host(P % q, q) for q in q_moduli],
                         dtype=torch.int64, device=device)
    if crs is None:
        beta_max = -(-len(q_moduli) // max(1, len(p_moduli) // gamma))
        crs = {idx: gen_crs(ring_qp, beta_max, crs_seed, idx)
               for idx in default_crs_indices(logn, extra_crs)}
    return Parameters(
        logn=logn, q_moduli=tuple(q_moduli), p_moduli=tuple(p_moduli),
        gamma=gamma, sigma=sigma, crs_seed=crs_seed, device=device,
        ring_q=ring_q, ring_p=ring_p, ring_qp=ring_qp, crs=crs,
        pmodq_mont=pmodq)


def add_crs(params: Parameters, idx: int) -> Parameters:
    """Parameters extended with the CRS at idx (params.AddCRS,
    mkrlwe/params.go:77-99); the same object if it is there already."""
    if idx in params.crs:
        return params
    crs = dict(params.crs)
    crs[idx] = gen_crs(params.ring_qp, params.beta(params.max_level),
                       params.crs_seed, idx)
    return dataclasses.replace(params, crs=crs)


def new_parameters(logn: int, q_moduli, p_moduli, gamma: int,
                   sigma: float = 3.2, crs_seed: int = 0x6d6b6865,
                   extra_crs=(), unsafe_skip_noise_guard: bool = False,
                   device=None) -> Parameters:
    """mkhe_tpu.mkrlwe.new_parameters: the HE-Standard security warning
    and the KKLSS noise guard (unsafe_skip_noise_guard=True builds what it
    rejects, to show that such a mult is destroyed), then rings and the
    default CRS set plus extra_crs."""
    if logn >= 10:
        total = security.logqp(q_moduli, p_moduli)
        if security.security_bits(logn, total) < 128:
            warnings.warn(
                f"parameters are below 128-bit HE-Standard security: "
                f"logN={logn}, logQP={total:.1f}", stacklevel=2)

    # KKLSS needs P comparable to B^2 (B = max gadget digit modulus): the
    # t-path noise of MulAndRelin scales as B^2/P, and an excess beyond
    # ~2^40 destroys the plaintext.
    alpha = max(1, len(p_moduli) // gamma)
    max_digit_bits = max(
        sum(math.log2(q) for q in q_moduli[d0:d0 + alpha])
        for d0 in range(0, len(q_moduli), alpha))
    p_bits_total = sum(math.log2(p) for p in p_moduli)
    if 2 * max_digit_bits > p_bits_total + 40 and not unsafe_skip_noise_guard:
        raise ValueError(
            f"gadget digit too large: B ~ 2^{max_digit_bits:.0f} but "
            f"P ~ 2^{p_bits_total:.0f}; the KKLSS t-path noise B^2/P "
            "would swamp the plaintext (choose smaller "
            "alpha = PCount/gamma)")
    return build_parameters(logn, tuple(q_moduli), tuple(p_moduli), gamma,
                            sigma, crs_seed, device, extra_crs=extra_crs)
