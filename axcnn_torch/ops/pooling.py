"""Pooling primitives (port of ``axcnn/ops/pooling.py``), NCHW.

TF 'SAME' pads ``(pad_total//2, pad_total - pad_total//2)``: the stem's
3x3/2 max pool on 112x112 pads (0, 1), not the (1, 1) of
``nn.MaxPool2d(padding=1)``, so the padding is applied explicitly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _same_pads(size, kernel, stride):
    out = -(-size // stride)  # ceil
    pad_total = max((out - 1) * stride + kernel - size, 0)
    pad_beg = pad_total // 2
    return (pad_beg, pad_total - pad_beg)


def _same_pad_2d(x, window, stride, value):
    ph = _same_pads(x.shape[2], window, stride)
    pw = _same_pads(x.shape[3], window, stride)
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


def max_pool_same(x, *, window=3, stride=2):
    """TF 'SAME' max pool (the reference stem's 3x3/2 pool)."""
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
    type, divided by H*W with the same op, cast back, broadcast."""

    @staticmethod
    def forward(ctx, x):
        x32 = x.float()
        ctx.shape, ctx.dtype, ctx.acc = x.shape, x.dtype, x32.dtype
        ctx.memory_format = (torch.channels_last
                             if x.is_contiguous(memory_format=torch.channels_last)
                             else torch.contiguous_format)
        return x32.mean(dim=(2, 3)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        n, c, h, w = ctx.shape
        dx = torch.empty(ctx.shape, dtype=ctx.dtype, device=g.device,
                         memory_format=ctx.memory_format)
        return dx.copy_((g.to(ctx.acc) / (h * w)).to(ctx.dtype)[:, :, None, None]
                        .expand(n, c, h, w))


def global_avg_pool(x):
    """Mean over H, W in fp32, cast back to the input dtype: (N, C). Its
    gradient keeps the input's memory format. Where no gradient is recorded
    (serving, eval) it is the plain mean, without the Function's host cost."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GlobalAvgPool.apply(x)
    return x.float().mean(dim=(2, 3)).to(x.dtype)
