"""ckks_ptmul: one `Evaluator.mul_ptxt_new(ct, pt, scale)` a request at
the top level, then the rescale: ct is the sum of the parties' fresh
encryptions, pt a plaintext encoded at set-up."""

from hebench import work as W
from hebench.parties import CkksOp
from hebench.reference.ckks import rescale


def inventory(cfg: dict, moduli) -> W.Work:
    """ct x pt at the top level, then the rescale."""
    w = W.Work.of(cfg, moduli)
    k, limbs = cfg["parties"], len(moduli[0])
    w.ptmul(k, limbs)
    w.read("ct", (k + 1) * limbs)
    w.read("pt", limbs)
    _, level = rescale(cfg["scale"] ** 2, limbs - 1, moduli[0], cfg["scale"])
    w.read("out", (k + 1) * (level + 1))
    return w


class State(CkksOp):
    plaintexts = 1

    def __init__(self, cfg, mix, seeds, device, root):
        super().__init__(cfg, mix, seeds, device, root)
        self.work = inventory(dict(cfg["params"], parties=cfg["parties"]),
                              self.moduli)

    def operands(self, m):
        ct, *rest = self.parties_encrypt(m)
        for c in rest:
            ct = self.ev.add_new(ct, c)
        return ct, self.encode(m[len(self.users)])

    def call(self, operands):
        return self.ev.mul_ptxt_new(*operands, self.scale)

    def expected(self, m):
        k = len(self.users)
        return m[:k].sum(0) * m[k]
