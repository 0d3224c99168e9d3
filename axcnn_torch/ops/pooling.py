"""Pooling primitives (port of ``axcnn/ops/pooling.py``), NCHW.

TF 'SAME' pads ``(pad_total//2, pad_total - pad_total//2)``: the stem's
3x3/2 max pool on 112x112 pads (0, 1), not the (1, 1) of
``nn.MaxPool2d(padding=1)``, so the padding is applied explicitly.

Under spatial partitioning (``spatial``, a
``axcnn_torch.parallel.spatial.SpatialContext``, rows of H split across
ranks): the max pool takes its halo rows (-inf at the image's border; the
global H's SAME padding decides how many) and pads only W
(``max_pool_on_halo``); the ResNet-D 2x2/2 average pool is row-local on the
even shards the shard rule guarantees; the global average pool sums each
shard's part, divided by the global H*W, over the row (``sum_rows``), so
every rank of the row holds the same pooled values.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from axcnn_torch.parallel.spatial import halo_rows


def _same_pads(size, kernel, stride):
    out = -(-size // stride)  # ceil
    pad_total = max((out - 1) * stride + kernel - size, 0)
    pad_beg = pad_total // 2
    return (pad_beg, pad_total - pad_beg)


def _same_pad_2d(x, window, stride, value):
    ph = _same_pads(x.shape[2], window, stride)
    pw = _same_pads(x.shape[3], window, stride)
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


def max_pool_halo(h_global, *, window=3, stride=2):
    """The max pool's halo rows from the shard above and below, for an
    image of ``h_global`` rows."""
    return halo_rows(window, stride, _same_pads(h_global, window, stride)[0])


def max_pool_on_halo(xh, *, window=3, stride=2):
    """The max pool on a shard that carries its halo rows: SAME padding
    along W only."""
    pw = _same_pads(xh.shape[3], window, stride)
    return F.max_pool2d(F.pad(xh, (pw[0], pw[1], 0, 0), value=float("-inf")), window, stride)


def max_pool_same(x, *, window=3, stride=2, spatial=None):
    """TF 'SAME' max pool (the reference stem's 3x3/2 pool)."""
    if spatial is not None:
        _, h_global = spatial.rows(x.shape[2])
        xh = spatial.halo(x, *max_pool_halo(h_global, window=window, stride=stride),
                          fill=float("-inf"))
        return max_pool_on_halo(xh, window=window, stride=stride)
    return F.max_pool2d(_same_pad_2d(x, window, stride, float("-inf")),
                        window, stride)


def avg_pool_same(x, *, window=2, stride=2):
    """TF 'SAME' average pool in fp32, cast back: each window is divided by
    its unpadded element count (the ResNet-D shortcut's 2x2/2 pool)."""
    x32 = x.float()
    summed = F.avg_pool2d(_same_pad_2d(x32, window, stride, 0.0), window,
                          stride, divisor_override=1)
    ones = torch.ones((1, 1) + x.shape[2:], dtype=torch.float32, device=x.device)
    counts = F.avg_pool2d(_same_pad_2d(ones, window, stride, 0.0), window,
                          stride, divisor_override=1)
    return (summed / counts).to(x.dtype)


class _GlobalAvgPool(torch.autograd.Function):
    """``x.float().mean((2, 3)).to(x.dtype)`` whose backward writes the
    gradient in the input's memory format. Autograd's own backward of the
    mean is NCHW-dense whatever the input's layout, so a channels_last
    consumer (the DropBlock apply before the head) had to copy it. The
    gradient is autograd's bit for bit: the cotangent cast to the mean's
    type, divided by H*W with the same op, cast back, broadcast. With a
    ``count`` (a shard's part of a spatially split image) it is
    ``x.float().sum((2, 3)) / count`` in fp32 instead, and the cotangent is
    divided by ``count``."""

    @staticmethod
    def forward(ctx, x, count=None):
        x32 = x.float()
        ctx.shape, ctx.dtype, ctx.acc, ctx.count = x.shape, x.dtype, x32.dtype, count
        ctx.memory_format = (torch.channels_last
                             if x.is_contiguous(memory_format=torch.channels_last)
                             else torch.contiguous_format)
        if count is not None:
            return x32.sum(dim=(2, 3)) / count
        return x32.mean(dim=(2, 3)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        n, c, h, w = ctx.shape
        dx = torch.empty(ctx.shape, dtype=ctx.dtype, device=g.device,
                         memory_format=ctx.memory_format)
        count = h * w if ctx.count is None else ctx.count
        return dx.copy_((g.to(ctx.acc) / count).to(ctx.dtype)[:, :, None, None]
                        .expand(n, c, h, w)), None


def global_avg_pool_part(x, count):
    """A shard's part of the global average pool: its fp32 sum over H, W
    divided by the image's ``count = H * W``; the parts of a row add up to
    the mean."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GlobalAvgPool.apply(x, count)
    return x.float().sum(dim=(2, 3)) / count


def global_avg_pool(x, spatial=None):
    """Mean over H, W in fp32, cast back to the input dtype: (N, C). Its
    gradient keeps the input's memory format. Where no gradient is recorded
    (serving, eval) it is the plain mean, without the Function's host cost.
    With ``spatial`` the mean of the whole image, summed over the row."""
    if spatial is not None:
        _, h_global = spatial.rows(x.shape[2])
        part = global_avg_pool_part(x, h_global * x.shape[3])
        return spatial.sum_rows(part).to(x.dtype)
    if torch.is_grad_enabled() and x.requires_grad:
        return _GlobalAvgPool.apply(x)
    return x.float().mean(dim=(2, 3)).to(x.dtype)
