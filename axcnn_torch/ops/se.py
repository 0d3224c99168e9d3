"""Squeeze-and-Excitation (port of ``axcnn/ops/se.py``).

GAP -> FC(C->C/r) -> ReLU -> FC(C/r->C) -> sigmoid, in fp32; the gate is cast
to the activation dtype before the channel-wise multiply.
"""

from __future__ import annotations

import torch
from torch import nn

from axcnn_torch.ops.conv import Dense
from axcnn_torch.ops.pooling import global_avg_pool


class SE(nn.Module):
    """``fc1``/``fc2`` hold the reference's ``w1, b1`` / ``w2, b2``."""

    def __init__(self, num_ch: int, *, ratio: int = 16):
        super().__init__()
        mid = max(num_ch // ratio, 1)
        self.fc1 = Dense(num_ch, mid, std=(2.0 / num_ch) ** 0.5)
        self.fc2 = Dense(mid, num_ch, std=(1.0 / mid) ** 0.5)

    def forward(self, x):
        z = global_avg_pool(x).float()  # (N, C)
        h = torch.relu(self.fc1(z))
        gate = torch.sigmoid(self.fc2(h)).to(x.dtype)
        return x * gate[:, :, None, None]
