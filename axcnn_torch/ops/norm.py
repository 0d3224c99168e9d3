"""Batch normalization with TF semantics (port of ``axcnn/ops/norm.py``).

Eval uses the moving statistics. Train uses the batch statistics, in fp32:
the biased ``E[x^2] - E[x]^2`` clamped at 0; the gradient flows through the
mean and the variance; the moving statistics are updated in place, outside
autograd, as ``moving * m + batch * (1 - m)`` with ``m = bn_momentum``
(0.997) and the biased variance. ``F.batch_norm`` / ``nn.BatchNorm2d`` are
not used: they update with momentum ``1 - m`` and the unbiased variance, and
on bf16 inputs they would normalize in another precision. Either way scale
and shift are folded in fp32 and the result is cast back to the input dtype,
as in the reference.
"""

from __future__ import annotations

import torch
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.997


def _channel_view(x, v):
    return v.view((1, -1) + (1,) * (x.dim() - 2))


def bn_eval(x, gamma, beta, mean, var, eps: float = BN_EPS):
    """Normalize channel dim 1 of ``x`` with moving statistics."""
    scale = gamma.float() * torch.rsqrt(var + eps)
    shift = beta.float() - mean * scale
    return (x.float() * _channel_view(x, scale) + _channel_view(x, shift)).to(x.dtype)


def bn_train(x, gamma, beta, moving_mean, moving_var, *,
             momentum: float = BN_MOMENTUM, eps: float = BN_EPS):
    """Normalize channel dim 1 of ``x`` with its batch statistics (over every
    other dim) and update ``moving_mean``/``moving_var`` in place."""
    x32 = x.float()
    dims = (0,) + tuple(range(2, x.dim()))
    mean = x32.mean(dim=dims)
    mean2 = x32.square().mean(dim=dims)
    var = torch.clamp_min(mean2 - mean.square(), 0.0)
    with torch.no_grad():
        moving_mean.copy_(moving_mean * momentum + mean * (1.0 - momentum))
        moving_var.copy_(moving_var * momentum + var * (1.0 - momentum))
    scale = gamma.float() * torch.rsqrt(var + eps)
    shift = beta.float() - mean * scale
    return (x32 * _channel_view(x, scale) + _channel_view(x, shift)).to(x.dtype)


class BatchNorm(nn.Module):
    """Parameters ``weight``/``bias`` (the reference's gamma/beta) and fp32
    buffers ``running_mean``/``running_var`` (its model-state mean/var)."""

    def __init__(self, num_ch: int, *, zero_gamma: bool = False,
                 momentum: float = BN_MOMENTUM):
        super().__init__()
        self.zero_gamma = zero_gamma
        self.momentum = momentum
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
            return bn_train(x, self.weight, self.bias, self.running_mean,
                            self.running_var, momentum=self.momentum)
        return bn_eval(x, self.weight, self.bias, self.running_mean,
                       self.running_var)
