"""Spatial partitioning: image H split across ranks (port of
``axcnn/parallel/spatial.py``).

The reference runs its plain global-batch step (``axis_name=None``) on a 2-D
``(data, spatial)`` mesh and lets GSPMD insert the halo exchanges and the
reductions. Torch has no such partitioner, so the port writes each
collective and its transpose by hand; the step is still numerically the
one-rank step on the same global batch (one mixup draw, global BN
statistics, global DropBlock masks and counts).

The grid: ``D x S`` ranks, one a card. Rank ``r`` is data index
``d = r // S`` and spatial index ``s = r % S`` (spatial is the minor axis, as
in the reference's ``order_spatial_devices``), so a spatial row is ``S``
consecutive ranks; under a launcher that numbers ranks host by host, a row
stays on one host when ``S`` divides the host's card count, which is
required. Rank ``(d, s)`` holds rows ``[s*H/S, (s+1)*H/S)`` of data shard
``d`` of the batch at every layer.

The shard rule: ``H % (32*S) == 0`` and ``H / (32*S) >= 2``, so every shard
has an even number of rows at each stride-2 input (H, H/2, ..., H/16) and at
least the two halo rows SK's dilation-2 conv needs at stage 4. The
reference pads uneven shards under GSPMD; the port refuses them.

A windowed op (kernel ``k_eff`` rows after dilation, stride, top padding
``pad_beg``) needs ``pad_beg`` rows from the rank above and
``k_eff - stride - pad_beg`` rows from the rank below (``halo_rows``), with
the op's padding value at the global border; after the exchange it runs
with no padding along H. ``SpatialContext.halo`` is the exchange, a
``torch.autograd.Function``: its forward brings in the neighbours' edge
rows, its backward sends each halo row's gradient back and adds it into the
owner's edge row. Pooled values are sums over the row (``sum_rows``, whose
transpose is the same sum of the cotangents). The split between a shard's
computation and the collective is kept so that the ops can be tested on
shards cut from one tensor in one process.

What spans data shards is regathered over the column: gradient
accumulation's micro-batch ``i`` is rows ``[i*M, (i+1)*M)`` of the global
batch (``M = N / A``), so each data rank takes its ``M / D`` rows of every
micro-batch (``micro_batches``); the int8 conv's per-tensor scale is a max
over the global batch (``max_all``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist


def order_spatial_ranks(world: int, spatial: int, local_world: int | None = None) -> np.ndarray:
    """The ``(data, spatial)`` grid of ranks, ``grid[d, s] = d * S + s``.
    Raises unless ``spatial`` divides ``world`` and, when the ranks span
    hosts of ``local_world`` ranks each, ``spatial`` divides
    ``local_world`` (the reference's messages)."""
    if spatial < 1:
        raise ValueError(f"spatial must be >= 1, got {spatial}")
    if world % spatial:
        raise ValueError(f"{world} devices not divisible by spatial={spatial}")
    if local_world is not None and local_world < world and local_world % spatial:
        raise ValueError(
            f"spatial={spatial} must divide the per-host device count ({local_world}) so "
            "halo neighbors stay on-host rows")
    return np.arange(world).reshape(world // spatial, spatial)


def check_shard_rows(h: int, spatial: int) -> None:
    """Refuse an image height the port cannot split into ``spatial`` shards:
    ``H % (32 * S) == 0`` and ``H / (32 * S) >= 2``."""
    if spatial > 1 and (h % (32 * spatial) or h // (32 * spatial) < 2):
        raise ValueError(
            f"spatial_partitions={spatial} needs an image size H with H % (32*S) == 0 and "
            f"H / (32*S) >= 2 (even shards at every stride-2 layer, and the two halo rows of "
            f"SK's dilated conv at stage 4), got H={h}")


def halo_rows(k_eff: int, stride: int, pad_beg: int) -> tuple[int, int]:
    """The rows a windowed op needs from the rank above and from the rank
    below: ``(pad_beg, k_eff - stride - pad_beg)``, the second at least 0
    (a 1x1 or 2x2 window at stride 2 reads none)."""
    return pad_beg, max(k_eff - stride - pad_beg, 0)


def _memory_format(x: torch.Tensor):
    return (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
            else torch.contiguous_format)


def _gather(t: torch.Tensor, group, parts: int) -> list[torch.Tensor]:
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(parts)]
    dist.all_gather(out, t, group=group)
    return out


class _Halo(torch.autograd.Function):
    """Forward: ``x`` with ``above`` rows of the previous rank of the row on
    top and ``below`` rows of the next one under it, ``fill`` at the
    global border. Backward: the halo rows' gradient goes back to its owner
    and is added into the owner's edge rows. One all-gather over the row each
    way, of the edge rows only."""

    @staticmethod
    def forward(ctx, x, above, below, fill, sp):
        ctx.above, ctx.below, ctx.sp = above, below, sp
        h = x.shape[2]
        if above > h or below > h:
            raise ValueError(f"a shard of {h} rows cannot give {above} / {below} halo rows")
        # my last `above` rows are the next rank's top halo; my first `below`
        # rows are the previous rank's bottom halo
        send = torch.cat([x[:, :, h - above:], x[:, :, :below]], dim=2)
        got = _gather(send, sp.row_group, sp.parts)
        s, n, c, w = sp.index, x.shape[0], x.shape[1], x.shape[3]
        top = got[s - 1][:, :, :above] if s > 0 else x.new_full((n, c, above, w), fill)
        bottom = (got[s + 1][:, :, above:] if s < sp.parts - 1
                  else x.new_full((n, c, below, w), fill))
        return torch.cat([top, x, bottom], dim=2).contiguous(memory_format=_memory_format(x))

    @staticmethod
    def backward(ctx, g):
        above, below, sp = ctx.above, ctx.below, ctx.sp
        h = g.shape[2] - above - below
        send = torch.cat([g[:, :, :above], g[:, :, above + h:]], dim=2)
        got = _gather(send, sp.row_group, sp.parts)
        dx = g[:, :, above:above + h].clone(memory_format=_memory_format(g))
        s = sp.index
        if s < sp.parts - 1 and above:  # the next rank's top halo is my last rows
            dx[:, :, h - above:] += got[s + 1][:, :, :above]
        if s > 0 and below:  # the previous rank's bottom halo is my first rows
            dx[:, :, :below] += got[s - 1][:, :, above:]
        return dx, None, None, None, None


class _RowSum(torch.autograd.Function):
    """The sum of ``x`` over the spatial row; its transpose is the same sum
    of the cotangents (every rank of the row used the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


@dataclasses.dataclass(frozen=True, eq=False)
class SpatialContext:
    """This rank's place in the ``(data, spatial)`` grid and the groups its
    collectives run over: ``row_group`` (the ``S`` ranks of its data index:
    halos and pooled sums) and ``column_group`` (the ``D`` ranks of its
    spatial index: the DropBlock counts past the fused line, mixup's mirror,
    the eval's sums; None when ``D == 1``)."""
    index: int  # s
    parts: int  # S
    data_index: int  # d
    data_parts: int  # D
    row_group: object
    column_group: object = None

    def rows(self, h_local: int) -> tuple[int, int]:
        """This shard's first global row and the global H."""
        return self.index * h_local, self.parts * h_local

    def slice_rows(self, images: torch.Tensor) -> torch.Tensor:
        """This shard's rows of a full-H NHWC batch."""
        h = images.shape[1]
        if h % self.parts:
            raise ValueError(f"H={h} does not split into {self.parts} shards")
        hs = h // self.parts
        return images[:, self.index * hs:(self.index + 1) * hs]

    def halo(self, x: torch.Tensor, above: int, below: int, fill: float = 0.0):
        """``x`` (this shard, NCHW) with its neighbours' halo rows (module
        docstring)."""
        if above == 0 and below == 0:
            return x
        return _Halo.apply(x, above, below, fill, self)

    def sum_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The differentiable sum of ``x`` over the row; without a gradient
        a plain all-reduce."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _RowSum.apply(x, self.row_group)
        y = x.clone()
        dist.all_reduce(y, group=self.row_group)
        return y

    def global_counts(self, counts: torch.Tensor) -> torch.Tensor:
        """The DropBlock keep counts of the global batch: this data shard's
        per-sample counts of its window, summed over the row, then the
        ``D`` shards' gathered over the column in data order. Only a site
        whose global map is past the fused line needs it: within the line
        each rank counts the global batch itself (``axcnn_torch.ops.dropblock``)."""
        counts = counts.clone()
        dist.all_reduce(counts, group=self.row_group)
        if self.column_group is None:
            return counts
        return torch.cat(_gather(counts, self.column_group, self.data_parts))

    def micro_batches(self, *tensors: torch.Tensor, steps: int) -> list[tuple]:
        """This rank's part of each of ``steps`` micro-batches of the global
        batch, whose data shard ``d`` the ``tensors`` are (``n`` rows each, a
        multiple of ``steps``): micro-batch ``i`` is global rows ``[i*M,
        (i+1)*M)`` with ``M = n*D / steps``, of which data rank ``d`` takes
        rows ``[d*M/D, (d+1)*M/D)``. One all-gather over the column per
        tensor, then slices; with ``D == 1`` slices alone."""
        m = tensors[0].shape[0] // steps  # this rank's rows of each micro-batch: M / D
        if self.column_group is not None:
            tensors = [torch.cat(_gather(t, self.column_group, self.data_parts))
                       for t in tensors]
        firsts = [(i * self.data_parts + self.data_index) * m for i in range(steps)]
        return [tuple(t[f:f + m] for t in tensors) for f in firsts]

    def max_all(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``t`` over every rank of the grid: over the
        row, then over the column."""
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.row_group)
        if self.column_group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.column_group)
        return t

    def mirror(self, *tensors: torch.Tensor) -> list[torch.Tensor]:
        """Each tensor as held by rank ``(D - 1 - d, s)``: mixup pairs the
        global batch with its reverse, so data shard ``d`` mixes with the
        reversed shard ``D - 1 - d``. One all-gather over the column per
        tensor; with ``D == 1`` the tensors themselves."""
        if self.column_group is None:
            return list(tensors)
        partner = self.data_parts - 1 - self.data_index
        return [_gather(t, self.column_group, self.data_parts)[partner] for t in tensors]


def make_spatial_context(spatial: int, *, local_world: int | None = None) -> SpatialContext:
    """Build this rank's context inside an initialised process group of
    ``D * S`` ranks. Every rank creates every row and column group, in one
    order, as ``torch.distributed.new_group`` requires."""
    world, rank = dist.get_world_size(), dist.get_rank()
    grid = order_spatial_ranks(world, spatial, local_world)
    d, s = divmod(rank, spatial)
    rows = [dist.new_group(ranks=row.tolist()) for row in grid]
    columns = [dist.new_group(ranks=col.tolist()) for col in grid.T] if len(grid) > 1 else None
    return SpatialContext(index=s, parts=spatial, data_index=d, data_parts=len(grid),
                          row_group=rows[d], column_group=columns and columns[s])
