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


def global_avg_pool(x):
    """Mean over H, W in fp32, cast back to the input dtype: (N, C)."""
    return x.float().mean(dim=(2, 3)).to(x.dtype)
