"""bfv_mulrelin: one `mkbfv.Evaluator.mul_relin_new(ct0, ct1, rlk)` a
request at the top level (MulRelinNew, mkbfv/mkbfv_bench_test.go:10-64 of
SNUCP/MKHE-KKLSS): ct0 is lifted to R = Q QMul, ct1 rescaled by QMul/Q
into R, the tensor product taken over R and quantized by t/QMul back to
Q, then relinearized over QP, with the split NTT at its default (off).
ct0 is the sum and ct1 the running difference of the parties' fresh
encryptions; each party's message is uniform over Z_t in every slot.

Set-up from the seed alone: the parties' ternary secrets and the
messages from one torch.Generator on the device (parties.ternary), the
program's public and relinearization keys made from those secrets by its
KeyGenerator, the encryptions by its Encryptor. The judge decrypts the
kept outputs with the same secrets through reference/bfv.py and compares
every slot with the exact product mod t."""

from __future__ import annotations

import math

import torch

from hebench import work as W
from hebench.parties import WRONG_LOG2, ternary
from hebench.reference import bfv as ref_bfv


def inventory(cfg: dict, moduli) -> W.Work:
    """ct0 x ct1 at the top level over all parties: the three Q <-> QMul
    conversions of the operands, the 2 beta gadget digits of both over R
    (extended to QP, then their NTT), the x / y aggregations over 2 beta
    digits, the tensor's NTTs over R and the quantize (iNTT over R,
    ModDown by QMul), the z1 / t external products and their ModDown, the
    re-decomposition of t over Q (beta digits), the v-sum, the u
    products and the last ModDown. `double_basis` marks the conversions:
    the three mod_ups and the quantize's ModDown. moduli: (Q, QMul, P)."""
    q, _, p = moduli
    k, lq, lp = cfg["parties"], len(q), len(p)
    lr, lqp = 2 * lq, lq + len(p)
    w = W.Work(logn=cfg["logn"], lp=lp, alpha=max(1, lp // cfg["gamma"]))
    b, b2 = w.beta(lq), w.beta(lr)

    def digits(polys, limbs, beta):
        if w.alpha > 1:
            w.calls.append(("mod_up", polys * limbs, polys * beta * lqp))
        w.calls.append(("ntt", polys * beta, lqp))

    convert = ("mod_up", (k + 1) * lq, (k + 1) * lq)
    quantize = ("mod_down", k + 1, lq, lq)
    w.calls += [convert] * 3
    digits(k, lr, b2)
    digits(k, lr, b2)
    w.calls += [("mul_accum", k * b2 * lqp, k * b2 * lqp, b2 * lqp)] * 2
    w.calls += [("ntt", k + 1, lr)] * 2 + [("intt", k + 1, lr), quantize]
    w.calls += [("mul_accum", k * b2 * lqp, b2 * lqp, k * lqp)] * 2
    w.calls += [("intt", 2 * k, lqp), ("mod_down", 2 * k, lq, lp)]
    digits(k, lq, b)
    w.calls += [("mul_accum", k * b * lqp, k * b * lqp, lqp),
                ("mul_accum", k * b * lqp, b * lqp, k * lqp),
                ("intt", k + 1, lqp), ("mod_down", k + 1, lq, lp)]
    w.double_basis = [convert] * 3 + [quantize]
    for name in ("ct0", "ct1", "out"):
        w.read(name, (k + 1) * lq)
    for pid in range(k):
        w.read(f"rlk.b.{pid}", b2 * lqp)
        w.read(f"rlk.d.{pid}", b2 * lqp)
        w.read(f"rlk.v.{pid}", b * lqp)
    w.read("crs.u", b * lqp)
    return w


def parameters(cfg: dict, device):
    """The program's parameters: mkbfv.new_parameters over the program's
    own prime search at the configuration's numbers (at PN15QP880 the
    moduli of its mkbfv.PN15QP880 recipe)."""
    from mkhe_tpu_torch import mkbfv
    from mkhe_tpu_torch.ops.primes import ntt_primes
    p = cfg["params"]
    return mkbfv.new_parameters(
        p["logn"], ntt_primes(p["logn"], p["q_bits"], p["q_count"]),
        ntt_primes(p["logn"], p["q_bits"], p["q_count"],
                   skip=p["q_count"]),
        ntt_primes(p["logn"], p["p_bits"], p["p_count"]), t=p["t"],
        gamma=p["gamma"], device=device)


def check_moduli(params, cfg: dict, moduli) -> None:
    """Raise unless the program's logN, moduli, t and alpha are the ones
    the reference works out from the configuration's numbers."""
    p, rp = cfg["params"], params.rlwe
    got = (params.logn, tuple(rp.q_moduli), tuple(params.qmul_moduli),
           tuple(rp.p_moduli), params.t, rp.alpha)
    want = (p["logn"], *moduli, p["t"],
            max(1, p["p_count"] // p["gamma"]))
    if got != want:
        raise ValueError(f"the program's BFV parameters {got} are not the "
                         f"configuration's {want}")


class State:
    def __init__(self, cfg, mix, seeds, device, root):
        from mkhe_tpu_torch import mkbfv, mkrlwe
        from mkhe_tpu_torch.mkrlwe.keygen import _secret_key_core
        self.device = torch.device(device)
        p = cfg["params"]
        self.t = int(p["t"])
        self.moduli = ref_bfv.bfv_moduli(**p)
        self.params = parameters(cfg, self.device)
        check_moduli(self.params, cfg, self.moduli)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seeds["inputs"])
        k, n = cfg["parties"], self.params.n
        self.users = tuple(f"user{i}" for i in range(k))
        sec = ternary(gen, (2, k, n), self.device)
        self.secrets = sec[0]
        rp = self.params.rlwe
        kgen = mkbfv.KeyGenerator(self.params, seed=seeds["keygen"])
        pks, self.rlk = {}, mkbfv.RelinearizationKeySet()
        for i, uid in enumerate(self.users):
            sk = mkrlwe.SecretKey(id=uid, data=_secret_key_core(rp, sec[0, i]))
            r = mkrlwe.SecretKey(id=uid, data=_secret_key_core(rp, sec[1, i]))
            pks[uid] = kgen.gen_public_key(sk)
            self.rlk.add(kgen.gen_relinearization_key_bfv(sk, r))
        enc = mkbfv.Encryptor(self.params, seed=seeds["encrypt"])
        self.ev = ev = mkbfv.Evaluator(self.params)
        self.messages = torch.randint(0, self.t, (mix["pool"], k, n),
                                      generator=gen,
                                      device=self.device).cpu()
        self.pool = []
        for m in self.messages:
            cts = [enc.encrypt_msg(m[i].numpy(), pks[uid])
                   for i, uid in enumerate(self.users)]
            ct0 = ct1 = cts[0]
            for c in cts[1:]:
                ct0, ct1 = ev.add_new(ct0, c), ev.sub_new(ct1, c)
            self.pool.append((ct0, ct1))
        self.work = inventory(dict(p, parties=k), self.moduli)

    def request(self, i: int):
        return self.ev.mul_relin_new(*self.pool[i % len(self.pool)],
                                     self.rlk)

    def expected(self, m: torch.Tensor, dtype=torch.int64) -> torch.Tensor:
        """(sum_i m_i) (m_0 - sum_{i>=1} m_i) mod t, centered, computed in
        dtype (int64: exact)."""
        a = m.to(dtype)
        prod = torch.remainder(a.sum(0) * (a[0] - a[1:].sum(0)), self.t)
        return ref_bfv.centered(prod.round().to(torch.int64), self.t)

    def judge(self, kept, control=None) -> dict:
        """wrong_slots: slots of the kept outputs that differ from the
        exact product mod t (the control: that product computed in
        `control`, a lower precision, in the program's place); noise_log2:
        log2 of the largest |noise| over Q / (2t) (a noiseless result, as
        the control's, reads one unit)."""
        t, q = self.t, self.moduli[0]
        wrong, worst = 0, -math.inf
        for i, out in kept:
            m = self.messages[i % len(self.messages)]
            want = self.expected(m)
            if control is not None:
                got = self.expected(m, control)
                noise = -(math.log2(math.prod(q)) - math.log2(2 * t))
            elif (tuple(out.ids) != tuple(sorted(self.users))
                  or tuple(out.data.shape[-2:]) != (len(q), want.shape[0])):
                got, noise = None, WRONG_LOG2
            else:
                got, noise = ref_bfv.open_ciphertext(
                    out.data, self.secrets_of(out.ids), q, t)
            wrong += want.numel() if got is None else int((got != want).sum())
            worst = max(worst, noise)
        return {"wrong_slots": wrong, "noise_log2": worst}

    def secrets_of(self, ids) -> torch.Tensor:
        return self.secrets[[self.users.index(u) for u in ids]]

    def release(self) -> None:
        """Drop the program's state; what the judge needs stays."""
        keep = {"device", "t", "moduli", "users", "secrets", "messages",
                "work"}
        for name in [k for k in self.__dict__ if k not in keep]:
            del self.__dict__[name]
