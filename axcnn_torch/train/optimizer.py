"""Momentum SGD with masked weight decay (port of
``axcnn/train/optimizer.py``).

TF semantics, all in fp32 on fp32 master parameters:

    g <- g + wd * p     (decayed parameters only; ``losses.decay_mask``)
    v <- m * v + g
    p <- p - lr * v

Parameters, velocity and gradients are updated in place, with PyTorch's
multi-tensor (``_foreach``) ops: a few launches per step instead of several
per parameter.
"""

from __future__ import annotations

import torch


def momentum_init(params: dict) -> dict:
    return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}


@torch.no_grad()
def momentum_update(params: dict, grads: dict, velocity: dict, *, lr: float,
                    momentum: float = 0.9, weight_decay: float = 0.0,
                    mask: dict | None = None) -> None:
    """Update ``params`` and ``velocity`` (dicts by name) in place; ``grads``
    is consumed. ``mask[name]`` is True where weight decay applies."""
    names = list(params)
    if weight_decay:
        decayed = [k for k in names if mask[k]]
        torch._foreach_add_([grads[k] for k in decayed],
                            [params[k] for k in decayed], alpha=weight_decay)
    v = [velocity[k] for k in names]
    torch._foreach_mul_(v, momentum)
    torch._foreach_add_(v, [grads[k] for k in names])
    torch._foreach_add_([params[k] for k in names], v, alpha=-lr)
