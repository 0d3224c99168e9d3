"""BlurPool 3x3/2, forward and backward: the CUDA kernels' wrappers, their
plain versions, and the ``torch.autograd.Function`` that joins them.

The kernels (``axcnn_torch/csrc/blurpool.cu``) replace the TPU kernels
``axcnn/pallas/blurpool.py:blur_pool_pallas`` and ``blur_pool_pallas_bwd``,
and ``BlurPool3S2`` replaces their custom VJP ``blur_pool_pallas_grad``.
They take fp32 or bf16 NCHW tensors in ``torch.channels_last`` memory
(physically NHWC, C contiguous), any H and W, sum in fp32 and return the
input dtype; the forward's output extent is ``ceil(H/2) x ceil(W/2)``.

``blur_pool_reference`` and ``blur_pool_bwd_reference`` are the plain
PyTorch versions: shifted adds in fp32 in the kernels' order, with no conv,
so no cuDNN or TF32 choice enters them. ``LAUNCHES`` and ``BWD_LAUNCHES``
count the two kernels' launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

LAUNCHES = 0
BWD_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_blur_args(stride: int, filter_size: int) -> None:
    if (filter_size, stride) != (3, 2):
        raise NotImplementedError(
            f"BlurPool is ported for filter_size=3, stride=2 only (got "
            f"filter_size={filter_size}, stride={stride})")


def _blur3_s2_rows(x: torch.Tensor) -> torch.Tensor:
    """Blur [1,2,1]/4 with stride 2 along dim -2, zero padding (1, 1):
    ``t[i] = (x[2i-1] + 2 x[2i] + x[2i+1]) / 4``."""
    if x.shape[-2] % 2:
        x = F.pad(x, (0, 0, 0, 1))
    e, o = x[..., 0::2, :], x[..., 1::2, :]
    o_prev = F.pad(o, (0, 0, 1, 0))[..., :-1, :]
    return (o_prev + 2.0 * e + o) * 0.25


def blur_pool_reference(x: torch.Tensor, *, stride: int = 2,
                        filter_size: int = 3) -> torch.Tensor:
    """Plain PyTorch BlurPool 3x3/2 on NCHW, in fp32, cast back once."""
    check_blur_args(stride, filter_size)
    t = _blur3_s2_rows(x.float())
    y = _blur3_s2_rows(t.transpose(-1, -2)).transpose(-1, -2)
    return y.to(x.dtype)


def _blur3_s2_rows_bwd(g: torch.Tensor, n: int) -> torch.Tensor:
    """Transpose of ``_blur3_s2_rows`` along dim -2 for an input of extent
    ``n``: ``dx[2i] = g[i] / 2``, ``dx[2i+1] = (g[i] + g[i+1]) / 4`` with
    ``g[ceil(n/2)] = 0``; an odd ``n`` drops the padded last position."""
    g_next = F.pad(g, (0, 0, 0, 1))[..., 1:, :]
    e, o = 0.5 * g, 0.25 * (g + g_next)
    return torch.stack([e, o], dim=-2).flatten(-3, -2)[..., :n, :]


def blur_pool_bwd_reference(g: torch.Tensor, in_hw) -> torch.Tensor:
    """Plain PyTorch BlurPool 3x3/2 backward on NCHW: the cotangent of the
    output -> that of an input of spatial extent ``in_hw``. In fp32, columns
    first, then rows (the Pallas kernel's order), cast back once."""
    h, w = in_hw
    t = _blur3_s2_rows_bwd(g.float().transpose(-1, -2), w).transpose(-1, -2)
    return _blur3_s2_rows_bwd(t, h).to(g.dtype)


def _kernel(name: str):
    """A C entry point, on the library that ``load_library`` caches."""
    from axcnn_torch.kernels.build import load_library

    fn = getattr(load_library(), name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_nchw(fn: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{fn} needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{fn} takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{fn} takes NCHW, got shape {tuple(x.shape)}")


def blur_pool_cuda(x: torch.Tensor, *, stride: int = 2,
                   filter_size: int = 3) -> torch.Tensor:
    """Launch the CUDA kernel on ``x``; raise on anything it does not take."""
    global LAUNCHES
    _check_cuda_nchw("blur_pool_cuda", x)
    check_blur_args(stride, filter_size)
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("blur_pool_cuda needs a channels_last-contiguous input")
    n, c, h, w = x.shape
    y = torch.empty((n, c, (h + 1) // 2, (w + 1) // 2), dtype=x.dtype,
                    device=x.device, memory_format=torch.channels_last)
    if x.numel() == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel("axcnn_blur_pool3_s2")(x.data_ptr(), y.data_ptr(),
                                         _DTYPE_CODES[x.dtype], n, h, w, c, stream)
    if err != 0:
        raise RuntimeError(f"axcnn_blur_pool3_s2 failed: CUDA error {err}")
    LAUNCHES += 1
    return y


def blur_pool_bwd_cuda(g: torch.Tensor, in_hw) -> torch.Tensor:
    """Launch the backward kernel: cotangent ``g`` (N, C, ceil(H/2),
    ceil(W/2)) -> (N, C, H, W) for ``in_hw = (H, W)``. ``g`` may come in
    any memory format (autograd does not keep channels_last); it is made
    channels_last-contiguous first. Launches on the current stream of the
    calling thread, which for autograd is its backward thread."""
    global BWD_LAUNCHES
    _check_cuda_nchw("blur_pool_bwd_cuda", g)
    h, w = in_hw
    n, c, ho, wo = g.shape
    if (ho, wo) != ((h + 1) // 2, (w + 1) // 2):
        raise ValueError(f"gradient extent {(ho, wo)} does not match an input "
                         f"of {(h, w)}")
    g = g.contiguous(memory_format=torch.channels_last)
    dx = torch.empty((n, c, h, w), dtype=g.dtype, device=g.device,
                     memory_format=torch.channels_last)
    if dx.numel() == 0:
        return dx
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = _kernel("axcnn_blur_pool3_s2_bwd")(g.data_ptr(), dx.data_ptr(),
                                             _DTYPE_CODES[g.dtype], n, h, w, c,
                                             stream)
    if err != 0:
        raise RuntimeError(f"axcnn_blur_pool3_s2_bwd failed: CUDA error {err}")
    BWD_LAUNCHES += 1
    return dx


class BlurPool3S2(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient (the
    counterpart of the reference's ``blur_pool_pallas_grad``). The filter is
    a constant, so nothing but the input's extent is saved."""

    @staticmethod
    def forward(ctx, x):
        ctx.in_hw = tuple(x.shape[-2:])
        return blur_pool_cuda(x)

    @staticmethod
    def backward(ctx, g):
        return blur_pool_bwd_cuda(g, ctx.in_hw)
