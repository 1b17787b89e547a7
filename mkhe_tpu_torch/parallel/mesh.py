"""The ranks' mesh and the placement of ciphertexts and keys on it (port of
mkhe_tpu/parallel/mesh.py).

The parallel axes of the workload and how they map onto a
torch.distributed DeviceMesh with dimensions ("rns", "coeff"):

  - "rns":   the RNS limb axis. Pointwise ops, NTT stages and digit
             products are limb-independent; only the base conversions
             (mod_up / mod_down) contract over limbs;
  - "coeff": the N coefficients. Pointwise ops are local; the NTT's first
             log2(C) stages exchange chunks (dist_ntt.py);
  - party:   the ciphertext components and key rows, independent until the
             sums into x, y and c0 (party_mul.py), on a mesh of its own.

The JAX package places whole arrays and lets GSPMD propagate the sharding
through the evaluator. The port has no GSPMD: a placement here is a tuple
of DTensor placements, one per mesh dimension, and `block` cuts out this
rank's block of a full tensor by it. The arithmetic then runs on plain
local tensors (dist_ntt, coeff_mul, party_mul); DTensor is not used in it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Placement, Replicate, Shard

from . import comm


def make_mesh(n_devices: Optional[int] = None, rns: int = 1,
              coeff: Optional[int] = None) -> DeviceMesh:
    """A ("rns", "coeff") mesh over the ranks of the initialised default
    process group (every rank calls it). Its device type is where the
    group's transport moves data: "cuda" for NCCL, "cpu" for gloo
    (comm.py)."""
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if coeff is None:
        coeff = n // rns
    if rns * coeff != n or n != world:
        raise ValueError(f"a {rns} x {coeff} mesh over {world} ranks")
    return mesh_of((rns, coeff), ("rns", "coeff"))


def mesh_of(shape: Sequence[int], names: Sequence[str]) -> DeviceMesh:
    """A mesh of the given shape and dimension names over all ranks of the
    default group, rank order row-major (make_mesh's, and the party
    axis's)."""
    device_type = "cuda" if comm.transport(None) == "nccl" else "cpu"
    ranks = torch.arange(dist.get_world_size()).reshape(*shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(names))


def ciphertext_sharding(mesh: DeviceMesh) -> tuple:
    """(k+1, L, N): limbs over "rns", coefficients over "coeff"."""
    return placements(mesh, rns=1, coeff=2)


def key_sharding(mesh: DeviceMesh) -> tuple:
    """(beta, Lqp, N): limbs over "rns", coefficients over "coeff"."""
    return placements(mesh, rns=1, coeff=2)


def stacked_key_sharding(mesh: DeviceMesh) -> tuple:
    """(k, beta, Lqp, N): limbs over "rns", coefficients over "coeff"."""
    return placements(mesh, rns=2, coeff=3)


def placements(mesh: DeviceMesh, **dims) -> tuple:
    """One placement per mesh dimension: Shard(dims[name]) for the named
    ones (tensor axis dims[name]), Replicate() for the rest; e.g.
    placements(mesh, coeff=-1) for coefficient chunks alone."""
    return tuple(Shard(dims[n]) if n in dims else Replicate()
                 for n in mesh.mesh_dim_names)


def block(x: torch.Tensor, mesh: DeviceMesh,
          spec: Sequence[Placement]) -> torch.Tensor:
    """This rank's block of the full tensor x under the placements `spec`
    (one per mesh dimension): a view, each sharded axis cut into equal
    parts in mesh order. Raises if an axis does not divide."""
    for i, p in enumerate(spec):
        if not isinstance(p, Shard):
            continue
        ax = p.dim % x.dim()
        parts = mesh.size(i)
        if x.shape[ax] % parts:
            raise ValueError(f"axis {ax} of {tuple(x.shape)} does not "
                             f"split into {parts}")
        per = x.shape[ax] // parts
        x = x.narrow(ax, mesh.get_local_rank(i) * per, per)
    return x


def shard_ciphertext(ct, mesh: DeviceMesh):
    """This rank's block of a (scheme or rlwe) ciphertext."""
    sh = ciphertext_sharding(mesh)
    if hasattr(ct, "ct"):  # mkckks.Ciphertext wraps the rlwe ciphertext
        inner = dataclasses.replace(ct.ct, data=block(ct.ct.data, mesh, sh))
        return dataclasses.replace(ct, ct=inner)
    return dataclasses.replace(ct, data=block(ct.data, mesh, sh))


def shard_rlk_stacked(stacked, mesh: DeviceMesh):
    """This rank's blocks of stacked (k, beta, Lqp, N) keys."""
    sh = stacked_key_sharding(mesh)
    return tuple(block(a, mesh, sh) for a in stacked)


def shard_params(rp, mesh: DeviceMesh):
    """rp with this rank's block of every CRS (the largest resident key
    material)."""
    sh = key_sharding(mesh)
    return dataclasses.replace(
        rp, crs={k: block(v, mesh, sh) for k, v in rp.crs.items()})
