"""ckks_mulrelin_batched: one `Evaluator.mul_relin_batched_new(cts0, cts1,
rlk)` of B distinct pairs a request at the top level, then the rescale,
with B the configuration's `batch`: a server that queues the parties'
mult requests and evaluates B of them in one call. Each pair is built as
ckks_mulrelin builds its one: ct0 the sum and ct1 the running difference
of the parties' fresh encryptions (mkckks_benchmark_test.go:11-84 of
SNUCP/MKHE-KKLSS). The mix's `pool` counts batches, so the pool holds
pool x B pairs."""

from hebench import work as W
from hebench.parties import WRONG_LOG2, CkksOp
from hebench.reference.ckks import rescale


def inventory(cfg: dict, moduli) -> W.Work:
    """B times ckks_mulrelin's steps (two hoists and one relin of ct0 x
    ct1 over all parties, then the rescale); the relinearization keys and
    the CRS read once for the batch, and each pair's ct0, ct1 and output
    under names of their own."""
    w = W.Work.of(cfg, moduli)
    k, limbs = cfg["parties"], len(moduli[0])
    _, level = rescale(cfg["scale"] ** 2, limbs - 1, moduli[0], cfg["scale"])
    for b in range(cfg["batch"]):
        w.hoist(k, limbs)
        w.hoist(k, limbs)
        w.relin(k, k, k, limbs, square=False)
        w.read(f"ct0.{b}", (k + 1) * limbs)
        w.read(f"ct1.{b}", (k + 1) * limbs)
        w.read(f"out.{b}", (k + 1) * (level + 1))
    w.relin_keys(range(k), range(k), limbs)
    return w


class State(CkksOp):
    """CkksOp over pool x B single pairs, whose messages lie in batch
    order: pair b of batch j is entry j B + b."""

    def __init__(self, cfg, mix, seeds, device, root):
        b = cfg["batch"]
        super().__init__(cfg, dict(mix, pool=mix["pool"] * b), seeds, device,
                         root)
        self.batches = [tuple(zip(*self.pool[j:j + b]))
                        for j in range(0, len(self.pool), b)]
        self.work = inventory(dict(cfg["params"], parties=cfg["parties"],
                                   batch=b), self.moduli)

    def operands(self, m):
        cts = self.parties_encrypt(m)
        ct0 = ct1 = cts[0]
        for c in cts[1:]:
            ct0 = self.ev.add_new(ct0, c)
            ct1 = self.ev.sub_new(ct1, c)
        return ct0, ct1

    def request(self, i: int):
        return self.call(self.batches[i % len(self.batches)])

    def call(self, operands):
        return self.ev.mul_relin_batched_new(*operands, self.rlk)

    def expected(self, m):
        k = len(self.users)
        return m[:k].sum(0) * (m[0] - m[1:k].sum(0))

    def judge(self, kept, control=None) -> dict:
        """CkksOp's judge over every pair of every kept request: the worst
        max_err_log2 of all of them, and their not_small summed. A request
        that does not return a list of B outputs reads as wrong."""
        b = self.cfg["batch"]
        pairs = []
        for i, outs in kept:
            if not isinstance(outs, list) or len(outs) != b:
                return {"max_err_log2": WRONG_LOG2, "not_small": 0}
            j = i % (len(self.messages) // b) * b
            pairs += [(j + p, out) for p, out in enumerate(outs)]
        return super().judge(pairs, control)
