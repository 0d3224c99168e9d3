"""Learning-rate schedules (port of ``axcnn/train/schedules.py``).

Linear warmup, then cosine, step or constant. ``lr(step)`` is a host
function of the integer step, computed in fp32 in the reference's order of
operations; the step hands the result to the optimizer as a float.
"""

from __future__ import annotations

import math

import numpy as np


def make_lr_schedule(*, base_lr: float, total_steps: int, warmup_steps: int = 0,
                     decay_type: str = "cosine", boundaries=(0.3, 0.6, 0.8),
                     decay_rate: float = 0.1, end_lr: float = 0.0):
    """Returns ``lr(step) -> np.float32``."""
    if decay_type not in ("cosine", "step", "constant"):
        raise ValueError(f"unknown decay_type {decay_type!r}")
    total_steps = max(int(total_steps), 1)
    warmup_steps = min(int(warmup_steps), total_steps)
    f32 = np.float32

    def lr(step) -> np.float32:
        step = f32(step)
        if step < warmup_steps:
            return f32(base_lr) * step / f32(max(warmup_steps, 1))
        progress = (step - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1))
        progress = np.clip(progress, f32(0.0), f32(1.0))
        if decay_type == "cosine":
            return f32(end_lr) + f32(base_lr - end_lr) * f32(0.5) * (
                f32(1.0) + np.cos(f32(math.pi) * progress))
        if decay_type == "step":
            k = f32(sum(progress >= f32(b) for b in boundaries))
            return f32(base_lr) * np.power(f32(decay_rate), k)
        return f32(base_lr)

    return lr


def scale_lr_for_batch(base_lr_per_256: float, global_batch_size: int) -> float:
    """The reference's linear-scaling rule: lr = base * batch/256."""
    return base_lr_per_256 * global_batch_size / 256.0
