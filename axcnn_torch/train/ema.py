"""Exponential moving average of the parameters (port of
``axcnn/train/ema.py``).

The decay ramps as TF's ``num_updates`` does, as the reference's train step
uses it: ``d = min(decay, (1 + t) / (10 + t))``, computed on the host in
fp32, with ``t`` the step BEFORE its increment. Only parameters are
averaged; the BN moving statistics are not.
"""

from __future__ import annotations

import numpy as np
import torch


def ema_init(params: dict) -> dict:
    return {k: p.detach().float().clone() for k, p in params.items()}


@torch.no_grad()
def ema_update(ema: dict, params: dict, *, step: int, decay: float = 0.9999) -> None:
    """``e <- e * d + p * (1 - d)`` in place, for every name of ``ema``."""
    t = np.float32(step)
    d = min(np.float32(decay), (np.float32(1.0) + t) / (np.float32(10.0) + t))
    names = list(ema)
    e = [ema[k] for k in names]
    torch._foreach_mul_(e, float(d))
    torch._foreach_add_(e, [params[k] for k in names], alpha=float(np.float32(1.0) - d))
