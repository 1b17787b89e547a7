"""Coefficient-sharded multi-key multiplication (port of
mkhe_tpu/parallel/coeff_mul.py).

The latency axis of one large mult: the N coefficients are split over the
ranks of a mesh dimension, and every rank runs the whole KKLSS
mult + relin on its chunk. Every step is coefficient-local (the gadget
decomposition and ModDown contract over limbs, the digit products and the
tensor terms are pointwise) except the NTTs, which rings with a dist
setting (Ring.with_dist) run as log2(C) chunk exchanges and the local
stages on the NTT kernels (dist_ntt.py). So the rank runs the port's own
keyswitch.mul_and_relin on Parameters.with_dist and its chunks, and the
result is the matching chunk of the unsharded mult, bit for bit.

The JAX package jits one SPMD program per configuration; the port runs
eagerly, and only the ranks' twiddle tables are cached
(dist_ntt._rank_tables).
"""

from __future__ import annotations

from ..mkrlwe import keyswitch as ksw
from ..mkrlwe.elements import Ciphertext
from ..mkrlwe.params import Parameters
from .mesh import block, placements


def chunk(x, mesh, axis: str = "coeff"):
    """This rank's coefficient chunk (last axis) of a full tensor x."""
    return block(x, mesh, placements(mesh, **{axis: -1}))


def mul_and_relin_sharded(params: Parameters, ct0: Ciphertext,
                          ct1: Ciphertext, rlk_stacked, level: int,
                          mesh, axis: str = "coeff") -> Ciphertext:
    """KKLSS mult + relin with the coefficient axis split over the mesh
    dimension `axis`. ct0, ct1 and the stacked relin keys (b, d, v) are
    this rank's chunks (`chunk`: the last axis, N / C coefficients);
    params holds the full CRS, whose u this function cuts to the chunk.
    Every rank of the dimension calls it together; it returns this rank's
    chunk of ksw.mul_and_relin's result."""
    params_d = params.with_dist(mesh.get_group(axis),
                                mesh.size(mesh.mesh_dim_names.index(axis)))
    u_key = chunk(params.crs_at(-1, level), mesh, axis).contiguous()
    return ksw.mul_and_relin(params_d, ct0, ct1, rlk_stacked, level,
                             u_key=u_key)
