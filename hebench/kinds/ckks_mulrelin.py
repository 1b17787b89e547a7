"""ckks_mulrelin: one `Evaluator.mul_relin_new(ct0, ct1, rlk)` a request
at the top level, then the rescale. ct0 is the sum and ct1 the running
difference of the parties' fresh encryptions
(mkckks_benchmark_test.go:11-84 of SNUCP/MKHE-KKLSS)."""

from hebench import work as W
from hebench.parties import CkksOp
from hebench.reference.ckks import rescale


def inventory(cfg: dict, moduli) -> W.Work:
    """ct0 x ct1 at the top level, both over all parties, not hoisted,
    then the rescale."""
    w = W.Work.of(cfg, moduli)
    k, limbs = cfg["parties"], len(moduli[0])
    w.hoist(k, limbs)
    w.hoist(k, limbs)
    w.relin(k, k, k, limbs, square=False)
    w.relin_keys(range(k), range(k), limbs)
    w.read("ct0", (k + 1) * limbs)
    w.read("ct1", (k + 1) * limbs)
    _, level = rescale(cfg["scale"] ** 2, limbs - 1, moduli[0], cfg["scale"])
    w.read("out", (k + 1) * (level + 1))
    return w


class State(CkksOp):
    def __init__(self, cfg, mix, seeds, device, root):
        super().__init__(cfg, mix, seeds, device, root)
        self.work = inventory(dict(cfg["params"], parties=cfg["parties"]),
                              self.moduli)

    def operands(self, m):
        cts = self.parties_encrypt(m)
        ct0 = ct1 = cts[0]
        for c in cts[1:]:
            ct0 = self.ev.add_new(ct0, c)
            ct1 = self.ev.sub_new(ct1, c)
        return ct0, ct1

    def call(self, operands):
        return self.ev.mul_relin_new(*operands, self.rlk)

    def expected(self, m):
        k = len(self.users)
        return m[:k].sum(0) * (m[0] - m[1:k].sum(0))
