"""DropBlock keep-mask: the CUDA kernel's wrapper and its plain version.

The kernel (``axcnn_torch/csrc/dropblock.cu``) replaces the TPU kernel
``axcnn/pallas/dropblock.py:dropblock_mask_pallas``. From per-sample int32
seeds and a drop rate ``gamma`` it returns the (N, H, W) fp32 keep-mask and
the (N,) fp32 per-sample keep counts. A pixel's uniform comes from the top
24 bits of a stateless hash of (seed, pixel index), MurmurHash3's fmix32
applied twice; block centres are drawn in the valid region and expanded by a
separable ``bs``-tap max, as in the reference.

``dropblock_mask_reference`` computes the same hash with torch integer ops,
so kernel and plain version agree bit for bit. Given ``uniforms`` it uses
those instead: the hook through which the CPU tests hand in the reference's
own random draws. ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

LAUNCHES = 0
MAX_HW = 16384  # kMaxHW of dropblock.cu: two H x W byte maps in shared memory

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2**32 for int64 ``a`` in [0, 2**32): the product is split
    into 16-bit halves of ``a`` so no partial product leaves int64."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on int64 tensors holding uint32."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_uniforms(seeds: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N,) int32 seeds -> (N, H, W) fp32 uniforms in [0, 1), exactly as the
    kernel draws them: ``fmix32(fmix32(seed) ^ pixel) >> 8`` times 2**-24."""
    key = _fmix32(seeds.to(torch.int64) & _M32)
    pix = torch.arange(h * w, dtype=torch.int64, device=seeds.device)
    bits = _fmix32(key[:, None] ^ pix[None, :])
    return ((bits >> 8).to(torch.float32) * 2.0 ** -24).view(-1, h, w)


def check_mask_args(h: int, w: int, block_size: int) -> None:
    if h * w > MAX_HW:
        raise ValueError(f"the DropBlock mask kernel takes H*W <= {MAX_HW}, "
                         f"got {h}x{w}")
    if not 1 <= block_size <= min(h, w):
        raise ValueError(f"block_size must be in [1, min(H, W)], got "
                         f"{block_size} for {h}x{w}")


def dropblock_mask_reference(seeds: torch.Tensor, gamma, h: int, w: int,
                             block_size: int, uniforms: torch.Tensor | None = None):
    """Plain PyTorch keep-mask: ``(mask (N, H, W) fp32, counts (N,) fp32)``.
    ``gamma`` is a float (fp32 on the host); ``uniforms`` (N, H, W), when
    given, replace the hashed draws."""
    check_mask_args(h, w, block_size)
    bs = block_size
    half0, half1 = (bs - 1) // 2, bs // 2
    u = hash_uniforms(seeds, h, w) if uniforms is None else uniforms.float()
    row = torch.arange(h, device=u.device)[:, None]
    col = torch.arange(w, device=u.device)[None, :]
    valid = (row >= half0) & (row < h - half1) & (col >= half0) & (col < w - half1)
    centres = ((u < torch.tensor(gamma, dtype=torch.float32)) & valid).float()
    # separable max over offsets -half1..half0, each a window centred as
    # reduce_window's with padding (half0, half1)
    hit = F.max_pool2d(F.pad(centres[:, None], (0, 0, half0, half1)), (bs, 1), 1)
    hit = F.max_pool2d(F.pad(hit, (half0, half1, 0, 0)), (1, bs), 1)[:, 0]
    mask = 1.0 - hit
    return mask, mask.sum(dim=(1, 2))


def _kernel():
    from axcnn_torch.kernels.build import load_library

    fn = load_library().axcnn_dropblock_mask
    fn.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dropblock_mask_cuda(seeds: torch.Tensor, gamma, h: int, w: int,
                        block_size: int):
    """Launch the mask kernel; raise on anything it does not take. It
    launches for any ``gamma``, 0 included (then nothing is dropped)."""
    global LAUNCHES
    if seeds.device.type != "cuda":
        raise ValueError(f"dropblock_mask_cuda needs CUDA seeds, got {seeds.device}")
    if seeds.dtype != torch.int32 or seeds.dim() != 1:
        raise TypeError(f"seeds must be (N,) int32, got {seeds.dtype} "
                        f"{tuple(seeds.shape)}")
    check_mask_args(h, w, block_size)
    seeds = seeds.contiguous()
    n = seeds.shape[0]
    mask = torch.empty((n, h, w), dtype=torch.float32, device=seeds.device)
    counts = torch.empty((n,), dtype=torch.float32, device=seeds.device)
    if n == 0:
        return mask, counts
    stream = torch.cuda.current_stream(seeds.device).cuda_stream
    err = _kernel()(seeds.data_ptr(), float(gamma), mask.data_ptr(),
                    counts.data_ptr(), n, h, w, block_size, stream)
    if err != 0:
        raise RuntimeError(f"axcnn_dropblock_mask failed: CUDA error {err}")
    LAUNCHES += 1
    return mask, counts
