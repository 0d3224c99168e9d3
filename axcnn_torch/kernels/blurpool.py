"""BlurPool 3x3/2 forward: the CUDA kernel's wrapper and its plain version.

The kernel (``axcnn_torch/csrc/blurpool.cu``) replaces the TPU kernel
``axcnn/pallas/blurpool.py:blur_pool_pallas``. It takes fp32 or bf16 NCHW
tensors in ``torch.channels_last`` memory (physically NHWC, C contiguous),
any H and W, sums in fp32 and returns the input dtype, with output extent
``ceil(H/2) x ceil(W/2)``.

``blur_pool_reference`` is the plain PyTorch version of the same function:
even/odd shifted adds in fp32 in the kernel's order, with no conv, so no
cuDNN or TF32 choice enters it. ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

LAUNCHES = 0

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


def _kernel():
    """The C entry point, on the library that ``load_library`` caches."""
    from axcnn_torch.kernels.build import load_library

    fn = load_library().axcnn_blur_pool3_s2
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def blur_pool_cuda(x: torch.Tensor, *, stride: int = 2,
                   filter_size: int = 3) -> torch.Tensor:
    """Launch the CUDA kernel on ``x``; raise on anything it does not take."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"blur_pool_cuda needs a CUDA tensor, got {x.device}")
    check_blur_args(stride, filter_size)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"blur_pool_cuda takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"blur_pool_cuda takes NCHW, got shape {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("blur_pool_cuda needs a channels_last-contiguous input")
    n, c, h, w = x.shape
    y = torch.empty((n, c, (h + 1) // 2, (w + 1) // 2), dtype=x.dtype,
                    device=x.device, memory_format=torch.channels_last)
    if x.numel() == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x.data_ptr(), y.data_ptr(), _DTYPE_CODES[x.dtype],
                    n, h, w, c, stream)
    if err != 0:
        raise RuntimeError(f"axcnn_blur_pool3_s2 failed: CUDA error {err}")
    LAUNCHES += 1
    return y
