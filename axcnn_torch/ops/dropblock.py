"""DropBlock (port of ``axcnn/ops/dropblock.py`` and the wrapper
``dropblock_pallas`` of ``axcnn/pallas/dropblock.py``), NCHW.

One spatial keep-mask per sample, shared across channels (the reference's
default). The drop rate, block size and rescale are the reference's:

    bs    = min(block_size, H, W)
    gamma = (1 - kp) / bs^2 * (H*W) / max((H-bs+1)*(W-bs+1), 1)
    y     = (x.float() * mask * (x.numel() / (max(sum(counts), 1) * C))).to(x.dtype)

with gamma and the keep-prob schedule computed on the host in fp32, in the
reference's order of operations. The device decides the mask's route: a CPU
tensor takes ``dropblock_mask_reference``, a CUDA tensor the mask kernel.
The apply stays in PyTorch. In eval DropBlock is the identity.
"""

from __future__ import annotations

import numpy as np
import torch

from axcnn_torch.kernels.dropblock import dropblock_mask_cuda, dropblock_mask_reference


def dropblock_keep_prob(progress, final_keep_prob: float) -> np.float32:
    """Linear 1.0 -> final_keep_prob schedule over progress in [0, 1]."""
    p = np.clip(np.float32(progress), np.float32(0.0), np.float32(1.0))
    return np.float32(1.0) - p * np.float32(1.0 - final_keep_prob)


def dropblock_gamma(keep_prob, bs: int, h: int, w: int) -> np.float32:
    """The per-pixel block-centre rate, in fp32 as the reference takes it."""
    kp = np.float32(keep_prob)
    area = np.float32((h * w) / max((h - bs + 1) * (w - bs + 1), 1))
    return ((np.float32(1.0) - kp) / np.float32(bs * bs)) * area


def sample_seeds(rng: np.random.Generator, n: int) -> np.ndarray:
    """Per-sample int32 seeds of the mask hash, as the reference draws
    per-sample seeds for its TPU kernel."""
    return rng.integers(-2 ** 31, 2 ** 31, size=n, dtype=np.int32)


def dropblock(x, seeds, *, keep_prob, block_size: int = 7, train: bool,
              uniforms=None):
    """``seeds``: (N,) int32 (numpy or tensor). ``uniforms`` (N, H, W), only
    on the plain path, replace the hashed draws (the tests' hook)."""
    if not train:
        return x
    n, c, h, w = x.shape
    bs = min(block_size, h, w)
    gamma = float(dropblock_gamma(keep_prob, bs, h, w))
    seeds = torch.as_tensor(seeds, dtype=torch.int32).to(x.device, non_blocking=True)
    if x.device.type == "cpu":
        mask, counts = dropblock_mask_reference(seeds, gamma, h, w, bs, uniforms)
    elif uniforms is not None:
        raise ValueError("uniforms are taken on the plain (CPU) path only")
    else:
        mask, counts = dropblock_mask_cuda(seeds, gamma, h, w, bs)
    total_keep = torch.clamp_min(counts.sum(), 1.0) * c
    numel = torch.full((), float(x.numel()), dtype=torch.float32, device=x.device)
    scale = numel / total_keep
    return (x.float() * mask[:, None] * scale).to(x.dtype)
