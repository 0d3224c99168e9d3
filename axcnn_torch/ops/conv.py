"""Convolution and dense primitives (port of ``axcnn/ops/conv.py``).

TF ``fixed_padding``: the reference pads every conv explicitly by
``(eff-1)//2, eff-1-(eff-1)//2`` with ``eff = dilation*(k-1)+1``. For every
odd kernel, the dilation-2 SK branch included, ``eff-1`` is even, so the
padding is symmetric and ``F.conv2d(padding=(eff-1)//2)`` reproduces it for
any stride.

Conv weights are OIHW, dense weights ``(out, in)``; both are stored fp32 and
cast to the compute dtype at use.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# std of a standard normal truncated at +-2 sigma
_TRUNC_STD = 0.87962566103423978


def fixed_pad_amounts(kernel_size: int, dilation: int = 1):
    eff = dilation * (kernel_size - 1) + 1
    pad_total = eff - 1
    pad_beg = pad_total // 2
    return (pad_beg, pad_total - pad_beg)


def he_normal_(w: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """He (fan-in, scale 2) normal truncated at 2 sigma, std-corrected — the
    reference's ``he_normal``."""
    fan_in = w[0].numel()  # OIHW: I*kh*kw; (out, in): in
    std = (2.0 / fan_in) ** 0.5
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return w.mul_(std / _TRUNC_STD)


def conv2d_fixed_padding(x, w, *, stride=1, dilation=1, compute_dtype=None):
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    else:
        w = w.to(x.dtype)
    beg, end = fixed_pad_amounts(w.shape[-1], dilation)
    if beg != end:
        raise ValueError(f"even kernel size {w.shape[-1]} needs asymmetric "
                         "fixed padding, which no model here uses")
    return F.conv2d(x, w, stride=stride, padding=beg, dilation=dilation)


class Conv(nn.Module):
    """Bias-free k x k conv with TF fixed padding (reference ``conv_init`` /
    ``conv_apply``)."""

    def __init__(self, kernel_size: int, in_ch: int, out_ch: int, *,
                 stride: int = 1, dilation: int = 1):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch, kernel_size, kernel_size))

    def reset_parameters(self, generator: torch.Generator | None):
        he_normal_(self.weight, generator)

    def forward(self, x, compute_dtype=None):
        return conv2d_fixed_padding(x, self.weight, stride=self.stride,
                                    dilation=self.dilation,
                                    compute_dtype=compute_dtype)


class Dense(nn.Module):
    """``y = x W^T + b`` with a normal(0, ``std``) weight and a zero bias
    (reference ``dense_init`` for the head, and the SE/SK FCs)."""

    def __init__(self, in_ch: int, out_ch: int, *, std: float, bias: bool = True):
        super().__init__()
        self.std = std
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def reset_parameters(self, generator: torch.Generator | None):
        with torch.no_grad():
            self.weight.normal_(0.0, self.std, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x, compute_dtype=None):
        dtype = x.dtype if compute_dtype is None else compute_dtype
        b = None if self.bias is None else self.bias.to(dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype), b)
