"""Multi-key CKKS evaluator (port of mkhe_tpu/mkckks/evaluator.py:155-288):
add/sub with id-set union, DropLevel, Rescale, HoistedForm and MulRelin
(+hoisted). PyTorch runs eagerly, so the JAX package's jitted cores become
direct calls.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import mkrlwe
from ..mkrlwe import keyswitch as ksw
from ..mkrlwe.elements import Ciphertext as RCt, union_ids
from ..ops import basis
from .params import Parameters
from .elements import Ciphertext


class Evaluator:
    def __init__(self, params: Parameters):
        self.params = params

    # -- helpers ------------------------------------------------------------

    @staticmethod
    def _index_maps(ids_out, ids_a, ids_b):
        map_a = [0] + [1 + ids_a.index(i) if i in ids_a else -1
                       for i in ids_out]
        map_b = [0] + [1 + ids_b.index(i) if i in ids_b else -1
                       for i in ids_out]
        return map_a, map_b

    def _align_levels(self, ct0: Ciphertext, ct1: Ciphertext):
        level = min(ct0.level, ct1.level)
        return (self.drop_level(ct0, ct0.level - level),
                self.drop_level(ct1, ct1.level - level), level)

    def _align_scales(self, ct0: Ciphertext, ct1: Ciphertext):
        """The JAX package aligns unequal scales with an integer
        MultByConst (evaluateInPlace, mkckks/evaluator.go:200-304)."""
        s0, s1 = ct0.scale, ct1.scale
        if math.floor(max(s0, s1) / min(s0, s1)) > 1:
            raise NotImplementedError(
                "aligning unequal scales needs mult_by_const_new, not yet "
                "ported (ROADMAP.md A.8, mult_by_const)")
        return ct0, ct1

    def _combine(self, ct0: Ciphertext, ct1: Ciphertext, op, lone_b):
        ct0, ct1 = self._align_scales(ct0, ct1)
        ct0, ct1, level = self._align_levels(ct0, ct1)
        ids = union_ids(ct0.ids, ct1.ids)
        ring = self.params.rlwe.ring_q_at(level)
        a, b = ct0.ct.data, ct1.ct.data
        out = []
        for ia, ib in zip(*self._index_maps(ids, ct0.ids, ct1.ids)):
            if ia >= 0 and ib >= 0:
                out.append(op(ring, a[ia], b[ib]))
            elif ia >= 0:
                out.append(a[ia])
            else:
                out.append(lone_b(ring, b[ib]))
        return Ciphertext(ct=RCt(ids=ids, data=torch.stack(out)),
                          scale=max(ct0.scale, ct1.scale))

    # -- add / sub ----------------------------------------------------------

    def add_new(self, ct0: Ciphertext, ct1: Ciphertext) -> Ciphertext:
        return self._combine(ct0, ct1, lambda r, x, y: r.add(x, y),
                             lambda r, y: y)

    def sub_new(self, ct0: Ciphertext, ct1: Ciphertext) -> Ciphertext:
        return self._combine(ct0, ct1, lambda r, x, y: r.sub(x, y),
                             lambda r, y: r.neg(y))

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
        if min_scale is None:
            min_scale = self.params.scale
        q = self.params.rlwe.q_moduli
        scale = ct.scale
        nb = 0
        level = ct.level
        while (level - nb >= 1
               and scale / q[level - nb] >= min_scale / 2):
            scale /= q[level - nb]
            nb += 1
        if nb == 0:
            return ct
        data = basis.div_round_by_last_moduli(
            ct.ct.data, self.params.rlwe.ring_q_at(level), nb)
        return Ciphertext(ct=RCt(ids=ct.ids, data=data), scale=scale)

    # -- multiplication -----------------------------------------------------

    def hoisted_form(self, ct: Ciphertext) -> mkrlwe.HoistedCiphertext:
        return ksw.hoisted_form(self.params.rlwe, ct.ct)

    def mul_relin_new(self, ct0: Ciphertext, ct1: Ciphertext, rlk_set
                      ) -> Ciphertext:
        if ct0 is ct1:
            h = self.hoisted_form(ct0)
            return self.mul_relin_hoisted_new(ct0, ct1, h, h, rlk_set)
        return self.mul_relin_hoisted_new(
            ct0, ct1, self.hoisted_form(ct0), self.hoisted_form(ct1),
            rlk_set)

    def mul_relin_hoisted_new(self, ct0: Ciphertext, ct1: Ciphertext,
                              h0, h1, rlk_set) -> Ciphertext:
        square = ct0 is ct1 or (ct0.ct.data is ct1.ct.data
                                and ct0.ids == ct1.ids)
        ct0a, ct1a, level = self._align_levels(ct0, ct1)
        rlk = rlk_set.stacked(union_ids(ct0.ids, ct1.ids))
        out = ksw.mul_and_relin(self.params.rlwe, ct0a.ct, ct1a.ct, rlk,
                                level, h0, h1,
                                square=square and h0 is h1)
        return self.rescale(Ciphertext(ct=out, scale=ct0.scale * ct1.scale))
