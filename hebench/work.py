"""The work a request needs, counted from the algorithm at the cell's shapes.

Frozen with the benchmark: nothing here is read from the program. Every
count is in coefficients of N words, and bytes are counted at 4 bytes a
coefficient (every modulus is below 2^30), so a request reads the same work
however the program stores or fuses it.

An inventory is a list of calls:

    ("ntt" | "intt", polys, limbs)             one negacyclic transform
    ("mod_up", coeffs_in, coeffs_out)          digits of a gadget decomposition
    ("mod_down", polys, limbs_q, limbs_p)      divide-and-round by P
    ("mul_accum", coeffs_a, coeffs_b, coeffs_out)   a key contraction; a and
                                               b count their distinct words

and `reads` maps each input and output the request must touch at least
once (ciphertexts, keys, CRS, plaintexts) to its coefficient count. The
steps follow the evaluator's (keyswitch.go:122-332 of SNUCP/MKHE-KKLSS);
each request kind (kinds/<kind>.py) builds its own inventory from them
in `inventory(cfg, moduli)`.
"""

from __future__ import annotations

import dataclasses

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
WORD = 4                    # bytes a coefficient


@dataclasses.dataclass
class Work:
    """A request's inventory, built step by step."""
    logn: int
    lp: int
    alpha: int
    calls: list = dataclasses.field(default_factory=list)
    reads: dict = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return 1 << self.logn

    def beta(self, limbs: int) -> int:
        return -(-limbs // self.alpha)

    @classmethod
    def of(cls, cfg: dict, moduli) -> "Work":
        """An empty inventory at a configuration's parameters and moduli."""
        lp = len(moduli[1])
        return cls(logn=cfg["logn"], lp=lp, alpha=max(1, lp // cfg["gamma"]))

    def read(self, name: str, coeffs: int) -> None:
        """An input or output of the request; the largest slice counts."""
        self.reads[name] = max(self.reads.get(name, 0), coeffs)

    # -- key switching steps ---------------------------------------------

    def hoist(self, p: int, limbs: int) -> None:
        """Gadget digits of p party polys, then their NTT over QP."""
        b, lqp = self.beta(limbs), limbs + self.lp
        if self.alpha > 1:
            self.calls.append(("mod_up", p * limbs, p * b * lqp))
        self.calls.append(("ntt", p * b, lqp))

    def switch(self, r: int, p: int, limbs: int) -> None:
        """r key switches of one hoisted p-party ciphertext (rotations):
        the parties' sum against the keys, the CRS products, one iNTT and
        one ModDown."""
        b, lqp = self.beta(limbs), limbs + self.lp
        self.calls += [("mul_accum", p * b * lqp, r * p * b * lqp, r * lqp),
                       ("mul_accum", p * b * lqp, r * b * lqp, r * p * lqp),
                       ("intt", r * (p + 1), lqp),
                       ("mod_down", r * (p + 1), limbs, self.lp)]

    def relin(self, p0: int, p1: int, p: int, limbs: int, square: bool,
              pairs: int = 1) -> None:
        """The KKLSS mult of `pairs` products (a lazily relinearized sum
        when pairs > 1) from hoisted digits: x / y aggregation, tensor
        terms, the external products, ModDown, the re-decomposition of t,
        the v-sum and the u products."""
        b, lqp = self.beta(limbs), limbs + self.lp
        for _ in range(pairs):
            self.calls += [("mul_accum", p0 * b * lqp, p0 * b * lqp, b * lqp),
                           ("mul_accum", p1 * b * lqp, p1 * b * lqp, b * lqp),
                           ("ntt", p0 + 1, limbs)]
            if not square:
                self.calls.append(("ntt", p1 + 1, limbs))
            if pairs > 1:
                self.calls += [
                    ("mul_accum", p1 * b * lqp, b * lqp, p1 * lqp),
                    ("mul_accum", p0 * b * lqp, b * lqp, p0 * lqp)]
        self.calls.append(("intt", p + 1, limbs))
        if pairs == 1:
            self.calls += [("mul_accum", p1 * b * lqp, b * lqp, p1 * lqp),
                           ("mul_accum", p0 * b * lqp, b * lqp, p0 * lqp),
                           ("intt", p1 + p0, lqp),
                           ("mod_down", p1 + p0, limbs, self.lp)]
        else:
            self.calls += [("intt", p1, lqp), ("mod_down", p1, limbs, self.lp),
                           ("intt", p0, lqp), ("mod_down", p0, limbs, self.lp)]
        self.hoist(p0, limbs)
        self.calls.append(("mul_accum", p0 * b * lqp, p0 * b * lqp, lqp))
        if pairs > 1:
            self.calls += [("intt", 1, lqp), ("mod_down", 1, limbs, self.lp)]
        self.calls.append(("mul_accum", p0 * b * lqp, b * lqp, p0 * lqp))
        if pairs > 1:
            self.calls += [("intt", p0, lqp), ("mod_down", p0, limbs, self.lp)]
        else:
            self.calls += [("intt", p0 + 1, lqp),
                           ("mod_down", p0 + 1, limbs, self.lp)]

    def relin_keys(self, ids0, ids1, limbs: int) -> None:
        """The d and v keys of ct0's parties, the b keys of ct1's and the
        CRS u, at the level."""
        size = self.beta(limbs) * (limbs + self.lp)
        for part, ids in (("d", ids0), ("v", ids0), ("b", ids1)):
            for pid in ids:
                self.read(f"rlk.{part}.{pid}", size)
        self.read("crs.u", size)

    def rotation_keys(self, parties, idx: int, limbs: int) -> None:
        size = self.beta(limbs) * (limbs + self.lp)
        for pid in parties:
            self.read(f"rtk.{idx}.{pid}", size)
        self.read(f"crs.{idx}", size)

    def ptmul(self, p: int, limbs: int) -> None:
        self.calls += [("ntt", 1, limbs), ("ntt", p + 1, limbs),
                       ("intt", p + 1, limbs)]

    # -- totals --------------------------------------------------------------

    def ntt_coeffs(self) -> int:
        """Words every transform reads and writes, plus one twiddle table a
        limb of each direction (L2 keeps the tables between launches)."""
        ntts = [c for c in self.calls if c[0] in ("ntt", "intt")]
        words = sum(2 * p * l for _, p, l in ntts)
        for kind in ("ntt", "intt"):
            words += max((l for k, _, l in ntts if k == kind), default=0)
        return words

    def ks_coeffs(self) -> int:
        """Words the key-switching steps read and write."""
        words = 0
        for call in self.calls:
            if call[0] == "mod_up":
                words += call[1] + call[2]
            elif call[0] == "mod_down":
                _, p, lq, lp = call
                words += p * (2 * lq + lp)
            elif call[0] == "mul_accum":
                words += sum(call[1:])
        return words

    def seconds(self, coeffs: int) -> float:
        """Least time of `coeffs` words at the HBM rate."""
        return coeffs * self.n * WORD / HBM_BYTES_PER_S


def rotation_steps(idx: int, slots: int, crs) -> list:
    """One key switch if idx has a CRS, else its power-of-two steps."""
    idx %= slots
    if idx == 0:
        return []
    if idx in crs:
        return [idx]
    return [1 << b for b in range(idx.bit_length()) if idx >> b & 1]


