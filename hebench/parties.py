"""The set-up that request kinds over the multi-key CKKS scheme share:
parameters, the parties' secrets and keys, the encryptor and evaluator,
and the reference's opening of an output.

A cell's state is built from the seed alone: the parties' ternary secrets
and the kind's messages or images come from one torch.Generator on the
device, in a few large draws; the program's KeyGenerator and Encryptor
take their own seeds from the same SeedSequence. The program gets the
secrets as inputs (`SecretKey` built from them) and derives its keys and
ciphertexts itself; the reference judges the outputs with the same
secrets and messages.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from .reference import ckks as ref_ckks
from .reference.primes import ckks_moduli

WRONG_LOG2 = 999.0   # the log2 error of an output that does not decrypt


def ternary(gen: torch.Generator, shape, device) -> torch.Tensor:
    """{-1, 0, 1} with P(0) = 1/2, as the scheme's secrets."""
    b = torch.randint(0, 4, shape, generator=gen, device=device)
    return torch.where(b == 2, 1, torch.where(b == 3, -1, 0))


class CkksParties:
    """Parameters, secrets, public and relinearization keys of the
    parties `party_ids()` names, an Encryptor and an Evaluator. A kind
    subclasses it and adds `request`, `judge` and `work`."""

    def __init__(self, cfg: dict, mix: dict, seeds, device, root: Path):
        from mkhe_tpu_torch import mkckks, mkrlwe
        from mkhe_tpu_torch.mkrlwe.keygen import _secret_key_core
        self.cfg, self.device = cfg, torch.device(device)
        p = cfg["params"]
        self.scale = float(p["scale"])
        self.moduli = ckks_moduli(**p)
        self.params = mkckks.new_parameters(**p, device=self.device)
        self.extra_crs()
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seeds["inputs"])
        self.users = self.party_ids()
        n, self.slots = self.params.n, self.params.slots
        sec = ternary(self.gen, (2, len(self.users), n), self.device)
        self.secrets = sec[0]
        rp = self.params.rlwe
        self.kgen = mkrlwe.KeyGenerator(rp, seed=seeds["keygen"])
        self.sks, self.pks = [], {}
        self.rlk = mkrlwe.RelinearizationKeySet()
        for i, uid in enumerate(self.users):
            sk = mkrlwe.SecretKey(id=uid, data=_secret_key_core(rp, sec[0, i]))
            r = mkrlwe.SecretKey(id=uid, data=_secret_key_core(rp, sec[1, i]))
            self.sks.append(sk)
            self.pks[uid] = self.kgen.gen_public_key(sk)
            self.rlk.add(self.kgen.gen_relinearization_key(sk, r))
        self.enc = mkckks.Encryptor(self.params, seed=seeds["encrypt"])
        self.ev = mkckks.Evaluator(self.params)
        self.mkckks = mkckks

    def party_ids(self) -> tuple:
        return tuple(f"user{i}" for i in range(self.cfg["parties"]))

    def extra_crs(self) -> None:
        """Add the CRS a kind needs beyond the default set."""

    def encrypt(self, values: np.ndarray, uid: str):
        return self.enc.encrypt_msg(self.mkckks.Message(value=values),
                                    self.pks[uid])

    def encode(self, values: np.ndarray) -> torch.Tensor:
        pt = self.enc.encode_msg(self.mkckks.Message(value=values))
        return torch.from_numpy(pt.astype(np.int64)).to(self.device)

    def secrets_of(self, ids) -> torch.Tensor:
        return self.secrets[[self.users.index(u) for u in ids]]

    def open(self, out, scale: float, level: int):
        """Slots of an output, or None where its parties or level are not
        the ones the reference expects; and the count of coefficients
        that do not decrypt to small values."""
        if tuple(out.ct.ids) != tuple(sorted(self.users)) \
                or out.ct.data.shape[-2] != level + 1:
            return None, 0
        return ref_ckks.open_ciphertext(
            out.ct.data, self.secrets_of(out.ct.ids), self.moduli[0], scale,
            self.slots)

    def release(self) -> None:
        """Drop the program's state; what the judge needs stays."""
        keep = {"cfg", "device", "scale", "moduli", "slots", "users",
                "secrets", "messages", "images", "weights", "work"}
        for name in [k for k in self.__dict__ if k not in keep]:
            del self.__dict__[name]


class CkksOp(CkksParties):
    """One evaluator op a request on pool entries whose operands are
    encrypted under every party. The traffic mix gives `pool` (operand
    sets) and `message` (slot values uniform in it, real and imaginary,
    divided by the party count). A kind gives `plaintexts` (extra
    messages an entry draws beside the parties'), `operands(m)` (a pool
    entry from its messages), `call(operands)` and `expected(m)` (the
    float64 result, or in m's lower precision for a control), and may
    override `out_scale_level()`."""

    plaintexts = 0

    def __init__(self, cfg, mix, seeds, device, root):
        super().__init__(cfg, mix, seeds, device, root)
        k, lo, hi = len(self.users), *mix["message"]
        u = torch.rand((mix["pool"], k + self.plaintexts, 2, self.slots),
                       generator=self.gen, dtype=torch.float64,
                       device=self.device).cpu().numpy()
        u = lo + (hi - lo) * u
        msg = u[:, :, 0] + 1j * u[:, :, 1]
        msg[:, :k] /= k
        self.messages = msg
        self.pool = [self.operands(m) for m in msg]

    def parties_encrypt(self, m: np.ndarray) -> list:
        """Party i's encryption of m[i], for each party."""
        return [self.encrypt(m[i], uid) for i, uid in enumerate(self.users)]

    def request(self, i: int):
        return self.call(self.pool[i % len(self.pool)])

    def judge(self, kept, control=None) -> dict:
        """max_err_log2: log2 of the largest slot error over the kept
        requests against the float64 result (the control: the result
        computed in `control`, a lower precision, in the program's
        place); not_small: coefficients that did not decrypt to small
        values."""
        scale, level = self.out_scale_level()
        err, bad = 0.0, 0
        for i, out in kept:
            m = self.messages[i % len(self.messages)]
            want = self.expected(m)
            if control is not None:
                got = self.expected(m.astype(control))
            else:
                got, nb = self.open(out, scale, level)
                if got is None:
                    return {"max_err_log2": WRONG_LOG2, "not_small": 0}
                bad += nb
                got = got.cpu().numpy()
            err = max(err, float(np.abs(got - want).max()))
        log2 = WRONG_LOG2 if bad else (math.log2(err) if err else -math.inf)
        return {"max_err_log2": log2, "not_small": bad}

    def out_scale_level(self):
        """Scale and level of the output: by default a product of two
        top-level operands at the scale, after the scheme's rescale."""
        return ref_ckks.rescale(self.scale * self.scale,
                                len(self.moduli[0]) - 1, self.moduli[0],
                                self.scale)
