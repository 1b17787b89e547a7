"""Multi-key CKKS evaluator (port of mkhe_tpu/mkckks/evaluator.py): add/sub
with id-set union and scale alignment, MultByConst, DropLevel, Rescale,
HoistedForm, MulRelin (+hoisted), the lazily relinearized inner product
MulRelinSum, MulPtxt, Rotate (+hoisted, one or many indices, with the
power-of-two fallback), Conjugate and the batched MulRelin. PyTorch runs
eagerly, so the JAX package's jitted cores become direct calls, its vmap
of the batched MulRelin a batch axis through the same core; fuse.py
captures a pipeline of these calls as one CUDA graph.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from .. import mkrlwe
from ..mkrlwe import keyswitch as ksw
from ..mkrlwe.elements import (Ciphertext as RCt, _union_combine,
                               split_batch, stack_batch, union_ids)
from ..ops import basis
from ..ops import modmath as mm
from ..utils.profiling import span
from .params import Parameters
from .elements import Ciphertext


@functools.lru_cache(maxsize=None)
def _mont_scalar(x: int, moduli, device: torch.device) -> torch.Tensor:
    """Evaluator._mont_scalar, made once per (x, moduli, device) and kept:
    a captured CUDA graph (fuse.py) reads it by address, and inside a
    capture a tensor made from host values would be a host-to-device
    copy."""
    return torch.tensor([mm.to_mont_host(x % q, q) for q in moduli],
                        dtype=torch.int64, device=device)


class Evaluator:
    def __init__(self, params: Parameters):
        self.params = params

    # -- helpers ------------------------------------------------------------

    def _align_levels(self, ct0: Ciphertext, ct1: Ciphertext):
        level = min(ct0.level, ct1.level)
        return (self.drop_level(ct0, ct0.level - level),
                self.drop_level(ct1, ct1.level - level), level)

    def _align_scales(self, ct0: Ciphertext, ct1: Ciphertext):
        """Scale alignment by an integer MultByConst (evaluateInPlace,
        mkckks/evaluator.go:200-304)."""
        s0, s1 = ct0.scale, ct1.scale
        if s1 > s0 and math.floor(s1 / s0) > 1:
            ct0 = self.mult_by_const_new(ct0, math.floor(s1 / s0))
        elif s0 > s1 and math.floor(s0 / s1) > 1:
            ct1 = self.mult_by_const_new(ct1, math.floor(s0 / s1))
        return ct0, ct1

    def _combine(self, ct0: Ciphertext, ct1: Ciphertext, op, lone_b):
        ct0, ct1 = self._align_scales(ct0, ct1)
        ct0, ct1, level = self._align_levels(ct0, ct1)
        return Ciphertext(ct=_union_combine(self.params.rlwe.ring_q_at(level),
                                            ct0.ct, ct1.ct, op, lone_b),
                          scale=max(ct0.scale, ct1.scale))

    # -- add / sub ----------------------------------------------------------

    def add_new(self, ct0: Ciphertext, ct1: Ciphertext) -> Ciphertext:
        return self._combine(ct0, ct1, lambda r, x, y: r.add(x, y),
                             lambda r, y: y)

    def sub_new(self, ct0: Ciphertext, ct1: Ciphertext) -> Ciphertext:
        return self._combine(ct0, ct1, lambda r, x, y: r.sub(x, y),
                             lambda r, y: r.neg(y))

    # -- constants ----------------------------------------------------------

    def mult_by_const_new(self, ct: Ciphertext, const) -> Ciphertext:
        """Multiply by a scalar constant (MultByConst,
        mkckks/evaluator.go:117-198): data * (sr + si X^(N/2)), X^(N/2)
        being the image of i. Integer-valued constants keep the scale;
        fractional ones are scaled by q_level."""
        c = complex(const)
        level = ct.level
        scale = 1.0
        if (c.real != int(c.real)) or (c.imag != int(c.imag)):
            scale = float(self.params.rlwe.q_moduli[level])
        sr = int(round(c.real * scale))
        si = int(round(c.imag * scale))
        ring = self.params.rlwe.ring_q_at(level)
        data = ct.ct.data
        out = None
        if sr:
            out = ring.mul_scalar_mont(data, self._mont_scalar(sr, ring))
        if si:
            h = data.shape[-1] // 2   # X^(N/2) * a, negacyclic
            rolled = torch.cat([ring.neg(data[..., h:]), data[..., :h]],
                               dim=-1)
            term = ring.mul_scalar_mont(rolled, self._mont_scalar(si, ring))
            out = term if out is None else ring.add(out, term)
        return Ciphertext(ct=RCt(ids=ct.ids, data=data if out is None
                                 else out), scale=ct.scale * scale)

    @staticmethod
    def _mont_scalar(x: int, ring) -> torch.Tensor:
        """x mod q_i in Montgomery form, per limb: (L,) on the device."""
        return _mont_scalar(x, ring.moduli, ring.device)

    # -- level / scale management ------------------------------------------

    def drop_level(self, ct: Ciphertext, levels: int) -> Ciphertext:
        if levels <= 0:
            return ct
        return Ciphertext(ct=mkrlwe.drop_level(ct.ct, levels),
                          scale=ct.scale)

    def rescale(self, ct: Ciphertext, min_scale: Optional[float] = None
                ) -> Ciphertext:
        """Divide by trailing moduli until the scale ~ min_scale
        (Rescale, mkckks/evaluator.go:359-398)."""
        scale, nb = self._rescale_count(ct.scale, ct.level, min_scale)
        if nb == 0:
            return ct
        with span("ckks.rescale"):
            data = basis.div_round_by_last_moduli(
                ct.ct.data, self.params.rlwe.ring_q_at(ct.level), nb)
        return Ciphertext(ct=RCt(ids=ct.ids, data=data), scale=scale)

    def _rescale_count(self, scale: float, level: int,
                       min_scale: Optional[float] = None):
        """(scale after, moduli to divide by) of rescale at that level."""
        if min_scale is None:
            min_scale = self.params.scale
        q = self.params.rlwe.q_moduli
        nb = 0
        while (level - nb >= 1
               and scale / q[level - nb] >= min_scale / 2):
            scale /= q[level - nb]
            nb += 1
        return scale, nb

    # -- multiplication -----------------------------------------------------

    def hoisted_form(self, ct: Ciphertext) -> mkrlwe.HoistedCiphertext:
        with span("ksw.decompose"):
            return ksw.hoisted_form(self.params.rlwe, ct.ct)

    def mul_relin_new(self, ct0: Ciphertext, ct1: Ciphertext, rlk_set
                      ) -> Ciphertext:
        with span("ckks.mul_relin"):
            rp = self.params.rlwe
            with span("ksw.decompose"):
                h0 = ksw.hoisted_form(rp, ct0.ct)
                h1 = h0 if ct0 is ct1 else ksw.hoisted_form(rp, ct1.ct)
            return self._mul_relin_hoisted(ct0, ct1, h0, h1, rlk_set)

    def mul_relin_hoisted_new(self, ct0: Ciphertext, ct1: Ciphertext,
                              h0, h1, rlk_set) -> Ciphertext:
        with span("ckks.mul_relin"):
            return self._mul_relin_hoisted(ct0, ct1, h0, h1, rlk_set)

    def _mul_relin_hoisted(self, ct0: Ciphertext, ct1: Ciphertext, h0, h1,
                           rlk_set) -> Ciphertext:
        square = ct0 is ct1 or (ct0.ct.data is ct1.ct.data
                                and ct0.ids == ct1.ids)
        ct0a, ct1a, level = self._align_levels(ct0, ct1)
        rlk = rlk_set.stacked(union_ids(ct0.ids, ct1.ids))
        out = ksw.mul_and_relin(self.params.rlwe, ct0a.ct, ct1a.ct, rlk,
                                level, h0, h1,
                                square=square and h0 is h1)
        return self.rescale(Ciphertext(ct=out, scale=ct0.scale * ct1.scale))

    def mul_relin_batched_new(self, cts0, cts1, rlk_set) -> list:
        """Batched MulRelin for serving (mkhe_tpu/mkckks/evaluator.py:
        319-358): B pairs that share (ids, level, scale) on each side go
        through one mult + relin + rescale with the batch behind the
        party axis, (k+1, B, L, N), so each NTT launch covers B times the
        polynomials of one mult. Returns a list of Ciphertexts, each
        bit-identical to mul_relin_new on its pair."""
        with span("ckks.mul_relin"):
            cts0, cts1 = list(cts0), list(cts1)
            data0, data1 = stack_batch(
                cts0, cts1, lambda c: (c.ids, c.level, c.scale),
                "batch must share (ids, level, scale); split the batch")
            level = data0.shape[-2] - 1
            ids = union_ids(cts0[0].ids, cts1[0].ids)
            # the rescale amount, once for the batch (one scale)
            scale, nb = self._rescale_count(cts0[0].scale * cts1[0].scale,
                                            level)
            rp = self.params.rlwe
            out = ksw.mul_and_relin(rp, RCt(ids=cts0[0].ids, data=data0),
                                    RCt(ids=cts1[0].ids, data=data1),
                                    rlk_set.stacked(ids), level).data
            if nb:
                with span("ckks.rescale"):
                    out = basis.div_round_by_last_moduli(
                        out, rp.ring_q_at(level), nb)
            return [Ciphertext(ct=ct, scale=scale)
                    for ct in split_batch(out, ids)]

    def mul_relin_sum_new(self, pairs, rlk_set) -> Ciphertext:
        """Inner product sum_i a_i * b_i with lazy relinearization
        (ksw.mul_and_relin_sum): one deferred ModDown / t-path for the
        whole sum instead of one per term, then one rescale. pairs: (ct0,
        ct1) or (ct0, ct1, h0, h1), all with the same product scale."""
        with span("ckks.mul_relin"):
            pairs = [p if len(p) == 4 else (p[0], p[1], None, None)
                     for p in pairs]
            level = min(min(p[0].level, p[1].level) for p in pairs)
            scale = pairs[0][0].scale * pairs[0][1].scale
            rpairs = []
            for c0, c1, h0, h1 in pairs:
                if c0.scale * c1.scale != scale:
                    raise ValueError("pairs must share the product scale")
                c0a, c1a, _ = self._align_levels(c0, c1)
                rpairs.append((mkrlwe.drop_level(c0a.ct, c0a.level - level),
                               mkrlwe.drop_level(c1a.ct, c1a.level - level),
                               h0, h1))
            rlk = rlk_set.stacked(union_ids(rpairs[0][0].ids,
                                            rpairs[0][1].ids))
            out = ksw.mul_and_relin_sum(self.params.rlwe, rpairs, rlk, level)
            return self.rescale(Ciphertext(ct=out, scale=scale))

    def mul_ptxt_new(self, ct: Ciphertext, pt, pt_scale: float
                     ) -> Ciphertext:
        """Multiply by an encoded plaintext (MulPtxtNew,
        mkckks/evaluator.go:465-481), then rescale. pt: (Lq, N)
        coefficient domain, a tensor or Encryptor.encode_msg's uint32
        array (copied to the device on every call: pass a tensor where it
        is reused, and a tensor on the params' device to a captured
        pipeline, fuse.py)."""
        with span("ckks.mul_ptxt"):
            level = ct.level
            ring = self.params.rlwe.ring_q_at(level)
            if not isinstance(pt, torch.Tensor):
                pt = torch.from_numpy(np.asarray(pt).astype(np.int64))
            pt = pt[..., :level + 1, :].to(ring.device)
            pm = ring.to_mont(ring.ntt(pt))
            data = ring.intt(ring.mul_mont(ring.ntt(ct.ct.data), pm[None]))
            return self.rescale(Ciphertext(ct=RCt(ids=ct.ids, data=data),
                                           scale=ct.scale * pt_scale))

    # -- rotations ----------------------------------------------------------

    def _rotate(self, ct: Ciphertext, rot_idx: int, rtk_set, h
                ) -> Ciphertext:
        out = ksw.rotate(self.params.rlwe, ct.ct, rot_idx,
                         rtk_set.stacked(ct.ids, rot_idx), h)
        return Ciphertext(ct=out, scale=ct.scale)

    def _normalize_rot(self, rot_idx: int) -> int:
        return rot_idx % (self.params.n // 2)

    def rotate_new(self, ct: Ciphertext, rot_idx: int, rtk_set
                   ) -> Ciphertext:
        """Rotate the slots left by rot_idx: in one key switch if rot_idx
        has a CRS, else by its power-of-two steps (ksw.rotation_steps,
        which raises KeyError if one of them has no CRS either)."""
        with span("ckks.rotate"):
            for k in ksw.rotation_steps(self.params.rlwe, rot_idx):
                ct = self._rotate(ct, k, rtk_set, None)
        return ct

    def _check_crs(self, rot_idx: int) -> None:
        if rot_idx not in self.params.rlwe.crs:
            raise KeyError(f"no CRS for rotation {rot_idx}: a hoisted "
                           "rotation needs it (the reference panics too, "
                           "evaluator.go:615)")

    def rotate_hoisted_new(self, ct: Ciphertext, rot_idx: int, h, rtk_set
                           ) -> Ciphertext:
        rot_idx = self._normalize_rot(rot_idx)
        if rot_idx == 0:
            return ct
        self._check_crs(rot_idx)
        with span("ckks.rotate"):
            return self._rotate(ct, rot_idx, rtk_set, h)

    def rotate_hoisted_many_new(self, ct: Ciphertext, rot_idxs, h,
                                rtk_set) -> list:
        """All R rotations of one hoisted ciphertext in one batched pass
        (ksw.rotate_hoisted_batched), bit-identical to R
        rotate_hoisted_new calls (the CNN's FC1, cnn/cnn.go:42-71)."""
        idxs = tuple(self._normalize_rot(r) for r in rot_idxs)
        if any(i == 0 for i in idxs):
            raise ValueError("rotation by 0 is the identity; drop it")
        for i in idxs:
            self._check_crs(i)
        with span("ckks.rotate"):
            rtk_multi = torch.stack([rtk_set.stacked(ct.ids, i)
                                     for i in idxs])
            data = ksw.rotate_hoisted_batched(self.params.rlwe, ct.ct, idxs,
                                              rtk_multi, h)
        return [Ciphertext(ct=RCt(ids=ct.ids, data=data[r]),
                           scale=ct.scale) for r in range(len(idxs))]

    def conjugate_new(self, ct: Ciphertext, cjk_set) -> Ciphertext:
        out = ksw.conjugate(self.params.rlwe, ct.ct, cjk_set.stacked(ct.ids))
        return Ciphertext(ct=out, scale=ct.scale)
