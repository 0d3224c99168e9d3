"""Data parallelism across processes (port of ``axcnn/parallel/mesh.py``).

The reference runs one program over a 1-D ``data`` mesh of every chip and
``lax.pmean``-s inside the step. The port runs one process per card (a
rank), each holding the whole train state, built from the same seed, and
its shard of the global batch; ``torch.distributed`` carries the averages:
NCCL for CUDA tensors, Gloo for CPU tensors, chosen by the device as
everywhere in the port. With one rank nothing here issues a collective, as
the reference builds no mesh for one device.

Not ported, by design: ``replicate_to_mesh``, ``shard_batch`` and the
``shard_*_step`` wrappers (each process already holds its state and its
shard), and the hierarchical ``(dcn, data)`` mesh: NCCL picks its own
topology across the cards of a host, and the card's machines have no DCN
(the training loop refuses ``runtime.dcn_slices > 1`` with that reason).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors


def init_distributed(device, *, rank: int | None = None, world_size: int | None = None,
                     coordinator: str | None = None, backend: str | None = None) -> int:
    """Join the process group; returns the world size. ``rank``,
    ``world_size`` and ``coordinator`` (``host:port`` of rank 0) come from
    the caller, else from the standard ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` environment of a launcher. The
    backend follows ``device`` (NCCL on the card, Gloo on the CPU) unless
    ``backend`` names one."""
    env = os.environ
    rank = int(env["RANK"]) if rank is None else rank
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    if coordinator is None:
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", rank=rank,
                            world_size=world_size)
    return world_size


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    """This process's rank; 0 outside a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of ranks; 1 outside a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def data_group():
    """The group the step averages over: every rank, or None with one rank
    (the reference's ``axis_name``: None builds no collective)."""
    return dist.group.WORLD if world_size() > 1 else None


def _all_reduce_(tensors, group, op, divisor: int | None = None) -> None:
    """Reduce ``tensors`` in place across ``group``, one collective for each
    (device, dtype) among them: each set is flattened into one buffer,
    reduced, then copied back (into any strides)."""
    sets: dict = {}
    for t in tensors:
        sets.setdefault((t.device, t.dtype), []).append(t)
    for ts in sets.values():
        flat = _flatten_dense_tensors(ts)
        dist.all_reduce(flat, op=op, group=group)
        if divisor is not None:
            flat.div_(divisor)
        for t, reduced in zip(ts, _unflatten_dense_tensors(flat, ts)):
            t.copy_(reduced)


def all_reduce_mean_(tensors, group) -> None:
    """Average ``tensors`` in place over ``group`` (the reference's
    ``lax.pmean``: the sum over ranks, then divided by their number); no-op
    for ``group=None``."""
    if group is not None:
        _all_reduce_(list(tensors), group, dist.ReduceOp.SUM, dist.get_world_size(group))


def all_reduce_sum_(tensors, group, divisor: int | None = None) -> None:
    """Sum ``tensors`` in place over ``group`` (``lax.psum``), then divide
    by ``divisor`` when given; no-op for ``group=None``."""
    if group is not None:
        _all_reduce_(list(tensors), group, dist.ReduceOp.SUM, divisor)


def all_reduce_max(value: int, device, group) -> int:
    """The largest of the ranks' ``value``s (``value`` for ``group=None``)."""
    if group is None:
        return value
    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())


def barrier(device, group) -> None:
    """Return once every rank of ``group`` has reached this point and the
    work it queued before has run."""
    all_reduce_max(0, device, group)


class _AllReduceMean(torch.autograd.Function):
    """``lax.pmean`` as an autograd op: its transpose is the same mean of
    the cotangent over the ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        all_reduce_mean_([y], group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        all_reduce_mean_([g], ctx.group)
        return g, None


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The differentiable mean of ``x`` over ``group`` (``x`` itself for
    ``group=None``)."""
    return x if group is None else _AllReduceMean.apply(x, group)


def check_replicas_agree(tensors, what: str, group) -> None:
    """Raise unless every rank of ``group`` holds the same ``tensors``: a
    position-weighted float64 checksum, its largest and smallest over the
    ranks in one all-reduce."""
    if group is None:
        return
    tensors = list(tensors)
    sums = torch.stack([t.detach().double().sum() for t in tensors])
    weights = torch.arange(1, len(tensors) + 1, dtype=torch.float64, device=sums.device)
    local = (sums * weights).sum()
    both = torch.stack([local, -local])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
    hi, lo = both[0].item(), -both[1].item()
    if hi != lo:
        raise RuntimeError(f"the ranks disagree on {what}: checksums from {lo!r} to {hi!r} "
                           "(built from other seeds or checkpoints?)")
