"""Anti-alias BlurPool (port of ``axcnn/ops/blurpool.py``), NCHW.

The arguments pick the route, as the reference's own dispatch does
(``axcnn/pallas/blurpool.py`` ``blurpool_supported``): 3x3 with stride 2
takes the hand-written kernels' route, where the device decides: a CPU
tensor takes their plain PyTorch version, which autograd differentiates; a
CUDA tensor takes the kernels through ``BlurPool3S2`` (forward kernel,
backward kernel as its gradient), which raise on what they do not take.
Where no gradient is asked for (serving, evaluation, a KD teacher, a
``torch.export`` trace), the forward is the custom op
``axcnn::blur_pool3_s2``: the same kernel on a CUDA tensor and the same
plain version on a CPU one, in a form a traced program keeps.
Every other filter size (1-7) and stride takes the general version on both
devices, the reference's XLA form: a depthwise conv with the normalised
binomial filter and TF fixed padding, in full fp32 for fp32 tensors (TF32
off around each cuDNN call, the counterpart of ``Precision.HIGHEST``).
``kernels.blurpool.ROUTES["general"]`` counts its calls. There is no
fallback and no switch.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from axcnn_torch.kernels import blurpool as kblur
from axcnn_torch.ops.conv import fixed_pad_amounts


def _binomial(filter_size: int) -> np.ndarray:
    """The row of Pascal's triangle with ``filter_size`` entries."""
    if filter_size < 1 or filter_size > 7:
        raise ValueError(f"anti_alias_filter_size must be in [1,7], got {filter_size}")
    a = np.array([1.0])
    for _ in range(filter_size - 1):
        a = np.convolve(a, [1.0, 1.0])
    return a


def blur_kernel(filter_size: int = 3) -> np.ndarray:
    """Normalized 2-D binomial kernel, e.g. size 3 -> outer([1,2,1])/16."""
    a = _binomial(filter_size)
    k2d = np.outer(a, a)
    return (k2d / k2d.sum()).astype(np.float32)


def blur_pool(x, *, stride: int = 2, filter_size: int = 3):
    """Depthwise binomial blur + stride-``stride`` subsample."""
    if (filter_size, stride) != (3, 2):
        return blur_pool_general(x, stride=stride, filter_size=filter_size)
    if not (torch.is_grad_enabled() and x.requires_grad):
        return torch.ops.axcnn.blur_pool3_s2(x)
    if x.device.type == "cpu":
        return kblur.blur_pool_reference(x)
    return kblur.BlurPool3S2.apply(x)


@contextlib.contextmanager
def _full_fp32(t: torch.Tensor):
    """cuDNN without TF32 around an fp32 CUDA call (its default runs fp32
    convolutions in TF32); a no-op elsewhere."""
    if not (t.is_cuda and t.dtype == torch.float32):
        yield
        return
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


class _DepthwiseBlur(torch.autograd.Function):
    """``conv2d(x, w, stride, padding, groups=C)`` and its input gradient,
    each under ``_full_fp32``. The filter is a constant: no weight gradient."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(w)
        ctx.shape, ctx.stride, ctx.padding = x.shape, stride, padding
        with _full_fp32(x):
            return F.conv2d(x, w, stride=stride, padding=padding, groups=x.shape[1])

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        with _full_fp32(g):
            dx = torch.nn.grad.conv2d_input(ctx.shape, w, g, stride=ctx.stride,
                                            padding=ctx.padding, groups=w.shape[0])
        return dx, None, None, None


def blur_pool_general(x, *, stride: int, filter_size: int):
    """The reference's XLA BlurPool for any filter size in [1, 7] and any
    stride: a depthwise conv in ``x``'s dtype with the padding
    ``fixed_pad_amounts(filter_size)`` (asymmetric for even sizes)."""
    c = x.shape[1]
    k = torch.from_numpy(blur_kernel(filter_size)).to(x.device, x.dtype)
    w = k.expand(c, 1, filter_size, filter_size).contiguous()
    beg, end = fixed_pad_amounts(filter_size)
    kblur.ROUTES["general"] += 1
    if beg != end:
        x = F.pad(x, (beg, end, beg, end))
        beg = 0
    return _DepthwiseBlur.apply(x, w, stride, beg)


def blur_pool_general_reference(x, *, stride: int, filter_size: int):
    """The plain version of ``blur_pool_general``, with no conv: the
    separable binomial as shifted adds in fp32 (rows, then columns), cast
    back once, so no cuDNN or TF32 choice enters it."""
    a = _binomial(filter_size)
    a = (a / a.sum()).tolist()
    beg, end = fixed_pad_amounts(filter_size)
    t = F.pad(x.float(), (beg, end, beg, end))
    ho = (t.shape[-2] - filter_size) // stride + 1
    wo = (t.shape[-1] - filter_size) // stride + 1
    rows = sum(a[i] * t[..., i:i + stride * (ho - 1) + 1:stride, :] for i in range(filter_size))
    y = sum(a[j] * rows[..., j:j + stride * (wo - 1) + 1:stride] for j in range(filter_size))
    return y.to(x.dtype)
