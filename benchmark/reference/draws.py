"""The recipe's random draws, worked out again from the root seed.

A frozen copy of the rules the program states for its draws, so the
reference takes no draw from the program: named integer streams (a root
seed folded with the step, then a blake2s hash of the site's name, through
numpy's ``SeedSequence``), a data-parallel rank's fold, mixup's Beta
lambda, DropBlock's per-sample int32 seeds, its keep-probability schedule
and drop rate, and the stateless hash that turns a seed and a pixel index
into a uniform (MurmurHash3's fmix32 twice, the top 24 bits).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.nn.functional as F


def _stable_hash(name: str) -> int:
    return int.from_bytes(hashlib.blake2s(name.encode()).digest()[:4], "little")


def _fold(key: int, data: int) -> int:
    return int(np.random.SeedSequence([key, data]).generate_state(1, np.uint64)[0])


class Stream:
    """Named integer keys derived from one root seed."""

    def __init__(self, key: int):
        self.key = int(key)

    def key_of(self, name: str) -> int:
        return _fold(self.key, _stable_hash(name))

    def numpy(self, name: str) -> np.random.Generator:
        return np.random.default_rng(self.key_of(name))

    def fold_step(self, step: int) -> "Stream":
        return Stream(_fold(self.key, int(step)))

    def fold_shard(self, rank: int) -> "Stream":
        return Stream(self.key_of("shard")).fold_step(rank)


def mixup_lambda(stream: Stream, alpha: float) -> np.float32:
    return np.float32(stream.numpy("mixup").beta(alpha, alpha))


def site_seeds(stream: Stream, site: str, n: int) -> np.ndarray:
    return stream.numpy(site).integers(-2 ** 31, 2 ** 31, size=n, dtype=np.int32)


def keep_prob(progress, final: float) -> np.float32:
    p = np.clip(np.float32(progress), np.float32(0.0), np.float32(1.0))
    return np.float32(1.0) - p * np.float32(1.0 - final)


def drop_rate(kp, bs: int, h: int, w: int) -> np.float32:
    area = np.float32((h * w) / max((h - bs + 1) * (w - bs + 1), 1))
    return ((np.float32(1.0) - np.float32(kp)) / np.float32(bs * bs)) * area


_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def uniforms(seeds: np.ndarray, h: int, w: int, device) -> torch.Tensor:
    """(N,) int32 seeds -> (N, H, W) fp32 uniforms in [0, 1)."""
    s = torch.as_tensor(seeds, dtype=torch.int64, device=device) & _M32
    pix = torch.arange(h * w, dtype=torch.int64, device=device)
    bits = _fmix32(_fmix32(s)[:, None] ^ pix[None, :])
    return ((bits >> 8).to(torch.float32) * 2.0 ** -24).view(-1, h, w)


def keep_mask(seeds: np.ndarray, rate, h: int, w: int, bs: int, device) -> torch.Tensor:
    """(N, H, W) fp32 keep-mask: block centres drawn where the uniform is
    below ``rate`` inside the valid region, each grown to a ``bs`` x ``bs``
    block (offsets ``-(bs // 2) .. (bs - 1) // 2`` from its centre)."""
    u = uniforms(seeds, h, w, device)
    lo, hi = (bs - 1) // 2, bs // 2
    rows = torch.arange(h, device=device)[:, None]
    cols = torch.arange(w, device=device)[None, :]
    valid = (rows >= lo) & (rows < h - hi) & (cols >= lo) & (cols < w - hi)
    centres = ((u < torch.tensor(float(rate), dtype=torch.float32)) & valid).float()
    grown = F.max_pool2d(F.pad(centres[:, None], (lo, hi, lo, hi)), bs, 1)[:, 0]
    return 1.0 - grown
