"""Batch normalization, eval mode (port of ``axcnn/ops/norm.py``).

Eval uses the moving statistics: scale and shift are folded in fp32 and the
result is cast back to the input dtype, as in the reference. ``F.batch_norm``
is not used: on bf16 inputs it would normalize in another precision. The
train branch (batch statistics, TF-style moving update with momentum 0.997
and the biased variance) comes with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

BN_EPS = 1e-5


def bn_eval(x, gamma, beta, mean, var, eps: float = BN_EPS):
    """Normalize channel dim 1 of ``x`` with moving statistics."""
    scale = gamma.float() * torch.rsqrt(var + eps)
    shift = beta.float() - mean * scale
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (x.float() * scale.view(shape) + shift.view(shape)).to(x.dtype)


class BatchNorm(nn.Module):
    """Parameters ``weight``/``bias`` (the reference's gamma/beta) and fp32
    buffers ``running_mean``/``running_var`` (its model-state mean/var)."""

    def __init__(self, num_ch: int, *, zero_gamma: bool = False):
        super().__init__()
        self.zero_gamma = zero_gamma
        self.weight = nn.Parameter(torch.empty(num_ch))
        self.bias = nn.Parameter(torch.empty(num_ch))
        self.register_buffer("running_mean", torch.empty(num_ch))
        self.register_buffer("running_var", torch.empty(num_ch))

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            self.weight.fill_(0.0 if self.zero_gamma else 1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x, *, train: bool = False):
        if train:
            raise NotImplementedError(
                "train-mode BatchNorm is not ported yet (ROADMAP.md Queue A "
                "item 5)")
        return bn_eval(x, self.weight, self.bias, self.running_mean,
                       self.running_var)
