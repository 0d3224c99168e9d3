"""Convolution and dense primitives (port of ``axcnn/ops/conv.py``).

TF ``fixed_padding``: the reference pads every conv explicitly by
``(eff-1)//2, eff-1-(eff-1)//2`` with ``eff = dilation*(k-1)+1``. For every
odd kernel, the dilation-2 SK branch included, ``eff-1`` is even, so the
padding is symmetric and ``F.conv2d(padding=(eff-1)//2)`` reproduces it for
any stride.

Conv weights are OIHW, dense weights ``(out, in)``; both are stored fp32 and
cast to the compute dtype at use.

``quantize=True`` (``Policy.quantize_conv``, serving only) runs a conv
through ``dynamic_int8_conv``, the reference's ``_dynamic_int8_conv``: a
per-tensor activation scale ``max|x| / 127`` and per-output-channel weight
scales, computed from the compute-dtype tensors in fp32 on every call;
round half to even into int8; the conv accumulated exactly in int32;
``acc * (sx * sw)`` in fp32, cast to the compute dtype. The device decides
how the int32 accumulators are made. On the card: the int8 patch matrix
(one contiguous copy of a strided view of the zero-padded channels_last
input; none for a 1x1 conv at stride 1) times the int8 weight matrix
through ``torch._int_mm`` (cuBLASLt's s8 x s8 -> s32), the counterpart of
the reference's ``lax.conv_general_dilated(preferred_element_type=int32)``,
which it also leaves to its compiler. On the CPU: the plain version, the
same integers through ``F.conv2d`` in float64, where every partial sum is an
integer below 2^31 and so exact; the two agree bit for bit.
``INT8_MM_CALLS`` counts the card route's products.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# std of a standard normal truncated at +-2 sigma
_TRUNC_STD = 0.87962566103423978
INT8_MM_CALLS = 0


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


def quantize_int8(x, w):
    """The reference's dynamic symmetric quantization of an NCHW input and
    an OIHW weight: ``(xq, sx, wq, sw)`` with int8 ``xq``/``wq``, the fp32
    per-tensor scale ``sx`` (0-d) and per-output-channel scales ``sw``."""
    xf, wf = x.to(torch.float32), w.to(torch.float32)
    sx = torch.clamp_min(xf.abs().amax(), 1e-12) / 127.0
    sw = torch.clamp_min(wf.abs().amax(dim=(1, 2, 3)), 1e-12) / 127.0
    xq = torch.round(xf / sx).to(torch.int8)  # max-abs scaling: already in range
    wq = torch.round(wf / sw[:, None, None, None]).to(torch.int8)
    return xq, sx, wq, sw


def int8_conv_acc_reference(xq, wq, *, stride, dilation, padding):
    """Plain version: the int8 conv's int32 accumulators through ``F.conv2d``
    in float64, exact (every partial sum is an integer below 2^31)."""
    acc = F.conv2d(xq.double(), wq.double(), stride=stride, padding=padding,
                   dilation=dilation)
    return acc.to(torch.int32)


def int8_gemm_operands(xq, wq, *, stride, dilation, padding):
    """The card route's operands: the int8 patch matrix ``a`` (M, K) of the
    zero-padded channels_last input (K in (kh, kw, C) order) and the weight
    matrix ``b`` (N, K), so that the accumulators are ``(a @ b.T)[:m, :o]``
    viewed as (n, ho, wo, o). M is padded past 16, K (the stem's 27
    included) and N to multiples of 8, with zeros, which change no sum
    (``torch._int_mm``'s shape rules)."""
    n, c, h, w = xq.shape
    o, _, kh, kw = wq.shape
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    m, k = n * ho * wo, kh * kw * c
    mp, kp, op = max(m, 17), -(-k // 8) * 8, -(-o // 8) * 8
    x = xq.permute(0, 2, 3, 1)  # NHWC; a view of a channels_last tensor
    if (kh, kw, stride, mp, kp) == (1, 1, 1, m, k) and x.is_contiguous():
        a = x.reshape(m, k)
    else:
        if padding:
            xp = x.new_zeros((n, h + 2 * padding, w + 2 * padding, c))
            xp[:, padding:padding + h, padding:padding + w] = x
        else:
            xp = x.contiguous()
        sn, sh, sw, sc = xp.stride()
        patches = xp.as_strided((n, ho, wo, kh, kw, c),
                                (sn, stride * sh, stride * sw, dilation * sh, dilation * sw, sc))
        a = xp.new_empty((mp, kp)) if (mp, kp) == (m, k) else xp.new_zeros((mp, kp))
        a[:m].view(n, ho, wo, kp)[..., :k].view(n, ho, wo, kh, kw, c).copy_(patches)
    b = wq.new_zeros((op, kp))
    b[:o, :k] = wq.permute(0, 2, 3, 1).reshape(o, k)
    return a, b, (n, ho, wo, m, o)


def int8_conv_acc_cuda(xq, wq, *, stride, dilation, padding):
    """The int8 conv's int32 accumulators on the card: ``torch._int_mm``
    (cuBLASLt, s8 x s8 -> s32) of ``int8_gemm_operands``."""
    global INT8_MM_CALLS
    if xq.device.type != "cuda" or wq.device != xq.device:
        raise ValueError(f"int8_conv_acc_cuda needs CUDA tensors, got {xq.device}, "
                         f"{wq.device}")
    a, b, (n, ho, wo, m, o) = int8_gemm_operands(xq, wq, stride=stride, dilation=dilation,
                                                 padding=padding)
    acc = torch._int_mm(a, b.t())
    INT8_MM_CALLS += 1
    return acc[:m, :o].view(n, ho, wo, o).permute(0, 3, 1, 2)


def dynamic_int8_conv(x, w, *, stride, dilation, padding, out_dtype):
    """The reference's ``_dynamic_int8_conv`` on NCHW ``x`` and OIHW ``w``
    (module docstring); the device picks how the accumulators are made."""
    xq, sx, wq, sw = quantize_int8(x, w)
    acc_fn = int8_conv_acc_reference if x.device.type == "cpu" else int8_conv_acc_cuda
    acc = acc_fn(xq, wq, stride=stride, dilation=dilation, padding=padding)
    return (acc.to(torch.float32) * (sx * sw)[:, None, None]).to(out_dtype)


def conv2d_fixed_padding(x, w, *, stride=1, dilation=1, compute_dtype=None,
                         quantize=False):
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    else:
        w = w.to(x.dtype)
    beg, end = fixed_pad_amounts(w.shape[-1], dilation)
    if beg != end:
        raise ValueError(f"even kernel size {w.shape[-1]} needs asymmetric "
                         "fixed padding, which no model here uses")
    if quantize:
        return dynamic_int8_conv(x, w, stride=stride, dilation=dilation, padding=beg,
                                 out_dtype=x.dtype)
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

    def forward(self, x, compute_dtype=None, quantize=False):
        return conv2d_fixed_padding(x, self.weight, stride=self.stride,
                                    dilation=self.dilation,
                                    compute_dtype=compute_dtype, quantize=quantize)


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
