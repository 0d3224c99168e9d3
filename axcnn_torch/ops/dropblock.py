"""DropBlock (port of ``axcnn/ops/dropblock.py`` and the wrapper
``dropblock_pallas`` of ``axcnn/pallas/dropblock.py``), NCHW.

One spatial keep-mask per sample, shared across channels (the reference's
default). The drop rate, block size and rescale are the reference's:

    bs    = min(block_size, H, W)
    gamma = (1 - kp) / bs^2 * (H*W) / max((H-bs+1)*(W-bs+1), 1)
    y     = (x.float() * mask * (x.numel() / (max(sum(counts), 1) * C))).to(x.dtype)

with gamma and the keep-prob schedule computed on the host in fp32, in the
reference's order of operations. The device decides the route: a CPU tensor
takes the plain versions (``dropblock_mask_reference``, then
``dropblock_apply_reference`` under autograd). A CUDA tensor whose map
``fused_route`` takes (H*W <= 16,384 pixels: every preset's site) takes the
fused kernel through ``DropBlockFused``: one cooperative launch draws the
mask and applies it; a larger map takes the mask kernel, then the apply
kernel through ``DropBlockApply``. Either way the backward is the apply
kernel in backward order. On the card a preset's site's device work is the
seeds' copy and one launch each way. In eval DropBlock is the identity.

Under spatial partitioning (``spatial``, a
``axcnn_torch.parallel.spatial.SpatialContext``) the site is the global
program's: ``seeds`` are the global batch's (``D * N``), ``bs`` and
``gamma`` come from the global H, the mask is the window of the global mask
that this rank's rows of its samples are (no halo: the hash is stateless),
and the scale is ``numel_global / (max(sum of the global batch's counts, 1)
* C)`` (not data parallelism's per-shard scale). Every rank holds the
global batch's seeds, so where ``fused_route`` takes the global map (every
preset's site) each rank counts every global sample over its whole map
itself, with no collective: on the card the fused kernel with this rank's
window, through ``DropBlockFusedWindow`` (one launch), on the CPU its plain
version. Past
the line the route is the windowed mask of this data shard's samples, the
window counts summed over the row and the data shards' gathered over the
column (``SpatialContext.global_counts``), then the apply with those
counts. Either way the backward is the apply kernel with the global counts.
"""

from __future__ import annotations

import numpy as np
import torch

from axcnn_torch.kernels.dropblock import (DropBlockApply, DropBlockFused, DropBlockFusedWindow,
                                           dropblock_apply_reference,
                                           dropblock_fused_window_reference, dropblock_mask_cuda,
                                           dropblock_mask_reference, fused_route)


def _spatial_dropblock(x, seeds, keep_prob, block_size, uniforms, spatial):
    """The global program's site on this rank's rows (module docstring);
    ``seeds`` and ``uniforms`` are the global batch's."""
    n, _, h, w = x.shape
    if seeds.shape[0] != n * spatial.data_parts:
        raise ValueError(f"seeds must be the global batch's {n * spatial.data_parts}, got "
                         f"{seeds.shape[0]}")
    row0, hg = spatial.rows(h)
    bs = min(block_size, hg, w)
    gamma = float(dropblock_gamma(keep_prob, bs, hg, w))
    first = spatial.data_index * n
    numel = x.numel() * spatial.parts * spatial.data_parts
    on_cpu = x.device.type == "cpu"
    if uniforms is not None and not on_cpu:
        raise ValueError("uniforms are taken on the plain (CPU) path only")
    if fused_route(hg, w):
        window = dict(row0=row0, h_global=hg, first=first, numel=numel)
        if on_cpu:
            return dropblock_fused_window_reference(x, seeds, gamma, bs, uniforms=uniforms,
                                                    **window)[0]
        return DropBlockFusedWindow.apply(x, seeds, gamma, bs, *window.values())
    mine, window = seeds[first:first + n], dict(row0=row0, h_global=hg)
    if on_cpu:
        mask, counts = dropblock_mask_reference(
            mine, gamma, h, w, bs, None if uniforms is None else uniforms[first:first + n],
            **window)
    else:
        mask, counts = dropblock_mask_cuda(mine, gamma, h, w, bs, **window)
    counts = spatial.global_counts(counts)
    if on_cpu:
        return dropblock_apply_reference(x, mask, counts, numel)
    return DropBlockApply.apply(x, mask, counts, numel)


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
              uniforms=None, spatial=None):
    """``seeds``: (N,) int32 (numpy or tensor). ``uniforms`` (N, H, W), only
    on the plain path, replace the hashed draws (the tests' hook). Under
    ``spatial`` both are the global batch's: (D * N,) seeds, uniforms of
    the whole maps, (D * N, H_global, W)."""
    if not train:
        return x
    seeds = torch.as_tensor(seeds, dtype=torch.int32).to(x.device, non_blocking=True)
    if spatial is not None:
        return _spatial_dropblock(x, seeds, keep_prob, block_size, uniforms, spatial)
    _, _, h, w = x.shape
    bs = min(block_size, h, w)
    gamma = float(dropblock_gamma(keep_prob, bs, h, w))
    if x.device.type == "cpu":
        mask, counts = dropblock_mask_reference(seeds, gamma, h, w, bs, uniforms)
        return dropblock_apply_reference(x, mask, counts)
    if uniforms is not None:
        raise ValueError("uniforms are taken on the plain (CPU) path only")
    if fused_route(h, w):
        return DropBlockFused.apply(x, seeds, gamma, bs)
    mask, counts = dropblock_mask_cuda(seeds, gamma, h, w, bs)
    return DropBlockApply.apply(x, mask, counts)
