"""cnn: one encrypted inference of the two-party CNN a request
(models/cnn.py of the system under test; cnn/cnn.go:10-96 of
SNUCP/MKHE-KKLSS), on pool entries of synthetic images encrypted under
dataOwner, against the model's weights (read by path) encrypted under
modelOwner. The traffic mix's `mode` is `staged` (models.cnn._pipeline,
the layer functions run eagerly) or `fused` (build_fused_inference, one
CUDA graph captured at set-up and replayed); `pool` is the number of
images. Encryption and decryption stay outside the request."""

import math

import numpy as np
import torch

from hebench import work as W
from hebench.parties import CkksParties
from hebench.reference import cnn as ref_cnn
from hebench.reference.ckks import rescale

WRONG = 1e9   # the logit error of an output that does not decrypt


def extra_rots(lo: dict) -> tuple:
    """Rotation indices the layout needs beyond the powers of two
    (cnn/cnn_test.go:185-189)."""
    slots, block = 8 * lo["quad"], lo["image"] // 2
    rots = {block, block + 1,
            *(i * lo["gap"] for i in range(1, lo["quad"] // lo["gap"])),
            *(slots - (1 << i) for i in range(4))}
    pows = {1 << i for i in range(15)}
    return tuple(sorted(r for r in rots if r not in pows))


def inventory(cfg: dict, moduli) -> W.Work:
    """One inference: the hoistings of the image and model ciphertexts,
    the convolution's hoisted rotations and lazy product sum, the square,
    fc1's diagonals, the square and fc2."""
    lo, q = cfg["layout"], moduli[0]
    w = W.Work.of(cfg, moduli)
    scale, top = cfg["scale"], len(q) - 1
    slots = 1 << cfg["logslots"]
    n_diag = lo["quad"] // lo["gap"]
    crs = {1 << i for i in range(cfg["logn"] - 1)} | set(extra_rots(lo))
    both, data, model = ("data", "model"), ("data",), ("model",)

    def rot(p, limbs, idx, parties):
        for step in W.rotation_steps(idx, slots, crs):
            w.hoist(p, limbs)
            w.switch(1, p, limbs)
            w.rotation_keys(parties, step, limbs)

    def mul(s, l, s2=scale):
        return rescale(s * s2, l, q, scale)

    L = top + 1
    w.read("image", 2 * L)
    for name, count in (("kernel", 4), ("fc1", n_diag), ("fc2", 1),
                        ("b1", 1), ("b2", 1)):
        for i in range(count):
            w.read(f"{name}.{i}", 2 * L)
    for _ in range(1 + 4 + n_diag):                # h_img, h_k, h_fc1
        w.hoist(1, L)
    # convolution
    w.switch(3, 1, L)
    for idx in (1, lo["image"] // 2, lo["image"] // 2 + 1):
        w.rotation_keys(data, idx, L)
    for _ in range(3):
        w.hoist(1, L)
    w.relin(1, 1, 2, L, square=False, pairs=4)
    w.relin_keys(data, model, L)
    s, l = mul(scale, top)
    for idx in (2 * lo["quad"], lo["quad"]):
        rot(2, l + 1, idx, both)
    # square
    w.hoist(2, l + 1)
    w.relin(2, 2, 2, l + 1, square=True)
    w.relin_keys(both, both, l + 1)
    s, l = mul(s, l, s)
    # fc1
    w.hoist(2, l + 1)
    w.switch(n_diag - 1, 2, l + 1)
    for i in range(1, n_diag):
        w.rotation_keys(both, i * lo["gap"], l + 1)
    for _ in range(n_diag - 1):
        w.hoist(2, l + 1)
    w.relin(2, 1, 2, l + 1, square=False, pairs=n_diag)
    w.relin_keys(both, model, l + 1)
    s, l = mul(s, l)
    for i in range(int(math.log2(lo["gap"]))):
        rot(2, l + 1, 1 << i, both)
    s = max(s, scale)
    # square
    w.hoist(2, l + 1)
    w.relin(2, 2, 2, l + 1, square=True)
    w.relin_keys(both, both, l + 1)
    s, l = mul(s, l, s)
    # fc2: mask, replicate, x fc2, fold over the units, + b2
    w.ptmul(2, l + 1)
    w.read("mask", l + 1)
    s, l = mul(s, l)
    for i in range(4):
        rot(2, l + 1, -(1 << i), both)
    w.hoist(2, l + 1)
    w.hoist(1, L)
    w.relin(2, 1, 2, l + 1, square=False)
    w.relin_keys(both, model, l + 1)
    s, l = mul(s, l)
    for i in range(int(math.log2(lo["fc_units"]))):
        rot(2, l + 1, lo["gap"] * (1 << i), both)
    w.read("out", 3 * (l + 1))
    return w


class State(CkksParties):
    def party_ids(self):
        return ("dataOwner", "modelOwner")

    def extra_crs(self) -> None:
        from mkhe_tpu_torch.models import cnn
        self.layout = cnn.Layout(**self.cfg["layout"])
        for idx in self.layout.extra_rots:
            self.params = self.params.add_crs(idx)

    def __init__(self, cfg, mix, seeds, device, root):
        super().__init__(cfg, mix, seeds, device, root)
        from mkhe_tpu_torch import mkrlwe
        from mkhe_tpu_torch.mkrlwe import keyswitch as ksw
        from mkhe_tpu_torch.models import cnn
        lo, slots = self.layout, self.params.slots
        rots = list(lo.extra_rots) + [1 << i for i in
                                      range(self.params.logn - 1)]
        self.rtk = mkrlwe.RotationKeySet()
        for sk in self.sks:
            for r in rots:
                self.rtk.add(self.kgen.gen_rotation_key(r, sk))
        with np.load(root / cfg["weights"]) as w:
            self.weights = tuple(w[k] for k in ("kernels", "fc1", "fc2", "b1",
                                                 "b2"))
        kernels, fc1, fc2, b1, b2 = self.weights
        model = "modelOwner"
        self.model = ([self.encrypt(v, model) for v in
                       cnn.pack_kernels(kernels, slots, lo)],
                      [self.encrypt(v, model) for v in
                       cnn.pack_fc1(fc1, slots, lo)],
                      self.encrypt(cnn.pack_fc2(fc2, slots, lo), model),
                      self.encrypt(cnn.pack_b1(b1, slots, lo), model),
                      self.encrypt(cnn.pack_b2(b2, slots, lo), model))
        self.pt_mask = self.encode(cnn.mask_vector(slots, lo))
        for r in rots:
            self.rtk.stacked(self.users, r)
            ksw.rotation_tables(self.params.rlwe, r)
        self.images = torch.rand((mix["pool"], lo.image, lo.image),
                                 generator=self.gen, dtype=torch.float64,
                                 device=self.device).cpu().numpy()
        self.pool = [self.encrypt(cnn.pack_image(img, slots, lo), "dataOwner")
                     for img in self.images]
        self.cnn = cnn
        self.fused = None
        if mix["mode"] == "fused":
            self.fused = cnn.build_fused_inference(
                self.params, self.rlk, self.rtk, self.pool[0], *self.model,
                self.pt_mask, layout=lo)
        self.work = inventory(dict(cfg["params"], layout=cfg["layout"]),
                              self.moduli)

    def request(self, i: int):
        ct = self.pool[i % len(self.pool)]
        if self.fused is not None:
            fn, args = self.fused
            return fn(args[0], args[1], (ct,) + tuple(args[2][1:]))
        return self.cnn._pipeline(self.ev, self.rlk, self.rtk, ct,
                                  *self.model, self.pt_mask, self.scale,
                                  self.layout)

    def judge(self, kept, control=None) -> dict:
        """max_logit_err: the largest logit error over the kept requests
        against the float64 forward pass (the control: the forward pass
        in `control`, a lower precision, in the program's place);
        not_small as for CkksOp."""
        lo = self.cfg["layout"]
        scale, level = ref_cnn.output_scale_level(
            self.moduli[0], self.scale, len(self.moduli[0]) - 1)
        err, bad = 0.0, 0
        for i, out in kept:
            img = self.images[i % len(self.images)]
            want = ref_cnn.plain_forward(img, *self.weights, lo)
            if control is not None:
                got = ref_cnn.plain_forward(img, *self.weights, lo,
                                            dtype=control)
            else:
                z, nb = self.open(out, scale, level)
                if z is None:
                    return {"max_logit_err": WRONG, "not_small": 0}
                bad += nb
                got = z[:lo["classes"]].real.cpu().numpy()
            err = max(err, float(np.abs(np.asarray(got, np.float64)
                                        - want).max()))
        return {"max_logit_err": WRONG if bad else err, "not_small": bad}
