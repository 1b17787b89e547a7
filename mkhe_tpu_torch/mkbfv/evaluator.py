"""Multi-key BFV evaluator (port of mkhe_tpu/mkbfv/evaluator.py): add/sub
with id-set union, MulRelin, its batched and its hoisted form, and the
slot rotation and conjugation on the CKKS rotation core (mkrlwe.keyswitch).
PyTorch runs eagerly, so the JAX package's jitted cores become direct
calls, and the batched MulRelin's vmap a batch axis through the same
core."""

from __future__ import annotations

from ..mkrlwe import keyswitch as ksw
from ..mkrlwe.elements import (Ciphertext, _union_combine, split_batch,
                               stack_batch, union_ids)
from ..utils.profiling import span
from .params import Parameters
from .keys import RelinearizationKeySet
from . import basis as bfv_basis
from . import keyswitch as bfv_ksw


class Evaluator:
    def __init__(self, params: Parameters):
        self.params = params

    def add_new(self, ct0: Ciphertext, ct1: Ciphertext) -> Ciphertext:
        return _union_combine(self.params.ring_q, ct0, ct1,
                              lambda r, x, y: r.add(x, y), lambda r, y: y)

    def sub_new(self, ct0: Ciphertext, ct1: Ciphertext) -> Ciphertext:
        return _union_combine(self.params.ring_q, ct0, ct1,
                              lambda r, x, y: r.sub(x, y),
                              lambda r, y: r.neg(y))

    def mul_relin_new(self, ct0: Ciphertext, ct1: Ciphertext,
                      rlk_set: RelinearizationKeySet) -> Ciphertext:
        """Lift operand 0 to R, rescale operand 1 by QMul/Q into R
        (evaluator.go:118-137), then MulAndRelinBFV."""
        with span("bfv.mul_relin"):
            return self._mul_relin(ct0.ids, ct1.ids, ct0.data, ct1.data,
                                   rlk_set)

    def _mul_relin(self, ids0, ids1, data0, data1, rlk_set) -> Ciphertext:
        p = self.params
        rlk = rlk_set.stacked(union_ids(ids0, ids1))
        ct0r = Ciphertext(ids=ids0, data=bfv_basis.mod_up_q_to_r(p, data0))
        ct1r = Ciphertext(ids=ids1,
                          data=bfv_basis.rescale_q_to_r(p, data1))
        return bfv_ksw.mul_and_relin_bfv(p, ct0r, ct1r, rlk)

    def mul_relin_batched_new(self, cts0, cts1,
                              rlk_set: RelinearizationKeySet) -> list:
        """Batched MulRelin for serving (mkhe_tpu/mkbfv/evaluator.py:
        96-116): B pairs whose sides share their id tuples go through one
        mult + relin with the batch behind the party axis, (k+1, B, Lq,
        N), so each NTT launch covers B times the polynomials of one
        mult. Returns a list of Ciphertexts, each bit-identical to
        mul_relin_new on its pair."""
        with span("bfv.mul_relin"):
            cts0, cts1 = list(cts0), list(cts1)
            data0, data1 = stack_batch(cts0, cts1)
            out = self._mul_relin(cts0[0].ids, cts1[0].ids, data0, data1,
                                  rlk_set)
            return split_batch(out.data, out.ids)

    def hoisted_form(self, ct: Ciphertext) -> bfv_ksw.HoistedCiphertext:
        """Both double-basis forms of ct and their decompositions, so that
        repeated multiplications skip them (evaluator.go:118-144)."""
        return bfv_ksw.hoist(self.params, ct)

    def mul_relin_hoisted_new(self, h0: bfv_ksw.HoistedCiphertext,
                              h1: bfv_ksw.HoistedCiphertext,
                              rlk_set: RelinearizationKeySet) -> Ciphertext:
        """MulAndRelinBFVHoisted (keyswitch_hoisted.go:39-207): multiply
        two hoisted forms."""
        with span("bfv.mul_relin"):
            rlk = rlk_set.stacked(union_ids(h0.ids, h1.ids))
            return bfv_ksw.mul_and_relin_bfv(
                self.params, Ciphertext(ids=h0.ids, data=h0.lift),
                Ciphertext(ids=h1.ids, data=h1.resc), rlk,
                dec0=h0.dec_lift, dec1=h1.dec_resc)

    def rotate_new(self, ct: Ciphertext, rot_idx: int, rtk_set
                   ) -> Ciphertext:
        """Rotate the columns of both slot rows (two rows of N/2) left by
        rot_idx (mkhe_tpu/mkbfv/evaluator.py:133-153); ct itself at 0.
        Steps and KeyError as the CKKS rotate_new (ksw.rotation_steps)."""
        rp = self.params.rlwe
        for k in ksw.rotation_steps(rp, rot_idx):
            ct = ksw.rotate(rp, ct, k, rtk_set.stacked(ct.ids, k))
        return ct

    def conjugate_new(self, ct: Ciphertext, cjk_set) -> Ciphertext:
        """Swap the two slot rows (the Galois element 2N - 1)."""
        return ksw.conjugate(self.params.rlwe, ct, cjk_set.stacked(ct.ids))
