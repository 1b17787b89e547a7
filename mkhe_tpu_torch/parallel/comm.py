"""The collectives of the parallel tier, over torch.distributed.

Two are needed (the JAX package's jax.lax.psum and ppermute inside
shard_map): a sum over a group's ranks and a pairwise exchange with the
rank i ^ dist. The transport follows the group's backend, chosen here and
nowhere else:

  - NCCL: the collectives run on the device tensors themselves
    (all_reduce, and batch_isend_irecv for the exchange);
  - gloo: on host copies (gloo has no CUDA send / recv), copied back to
    the caller's device.

Any other backend raises, and nothing falls back from one transport to the
other. A collective cannot be recorded into a CUDA graph: inside a capture
(fuse.py) these functions raise instead.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def transport(group) -> str:
    """'nccl' or 'gloo', the group's backend; raises for another."""
    backend = str(dist.get_backend(group))
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"the parallel tier runs over NCCL or gloo, not "
                         f"{backend!r}")
    return backend


def _buffer(x: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of x where the group's transport wants it."""
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a collective cannot be captured in a CUDA "
                           "graph: run the sharded paths eagerly")
    if transport(group) == "nccl":
        if not x.is_cuda:
            raise ValueError("NCCL moves CUDA tensors only")
        return x.clone(memory_format=torch.contiguous_format)
    return x.to("cpu", copy=True).contiguous()


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of x over the group's ranks (int64; the caller keeps the sum
    in range and reduces it), on x's device."""
    buf = _buffer(x, group)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(x.device)


def exchange(x: torch.Tensor, peer: int, group) -> torch.Tensor:
    """Send x to the group's rank `peer` and receive that rank's tensor of
    the same shape (ppermute with the pairs (i, i ^ dist)), on x's
    device."""
    send = _buffer(x, group)
    recv = torch.empty_like(send)
    other = dist.get_global_rank(group, peer)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, other, group),
            dist.P2POp(dist.irecv, recv, other, group)]):
        req.wait()
    return recv.to(x.device)


def all_gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors x (equal shapes), concatenated along axis 0 in
    rank order, on x's device."""
    buf = _buffer(x, group)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts).to(x.device)
