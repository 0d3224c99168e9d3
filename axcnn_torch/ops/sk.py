"""Selective-Kernel unit (port of ``axcnn/ops/sk.py``).

Two branches, a 3x3 and a 3x3 with dilation 2, each conv -> BN -> ReLU;
``z = ReLU(BN(FC(GAP(u))))`` on the (N, d) vector with ``u`` the branch sum
(in train mode that BN takes its statistics over N alone); a per-branch
softmax attention in fp32, cast to ``u``'s dtype, mixes the branches. The
reference's merged 5x5 form (``sk_merged_conv``) is not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from axcnn_torch.ops.conv import Conv, Dense
from axcnn_torch.ops.norm import BN_MOMENTUM, BatchNorm
from axcnn_torch.ops.pooling import global_avg_pool

NUM_BRANCHES = 2


class SK(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, *, stride: int = 1,
                 ratio: int = 16, min_dim: int = 32,
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        d = max(out_ch // ratio, min_dim)
        self.out_ch = out_ch
        for b in range(NUM_BRANCHES):
            self.add_module(f"conv{b}", Conv(3, in_ch, out_ch, stride=stride,
                                             dilation=b + 1))
            self.add_module(f"bn{b}", BatchNorm(out_ch, momentum=bn_momentum))
        self.fc_z = Dense(out_ch, d, std=(2.0 / out_ch) ** 0.5, bias=False)
        self.bn_z = BatchNorm(d, momentum=bn_momentum)
        self.fc_select = Dense(d, NUM_BRANCHES * out_ch, std=(1.0 / d) ** 0.5)

    def forward(self, x, compute_dtype=None, *, train: bool = False, group=None):
        """``group``: the process group train-mode BN averages its statistics
        over (None: this rank's batch alone)."""
        branches = [
            torch.relu(getattr(self, f"bn{b}")(
                getattr(self, f"conv{b}")(x, compute_dtype), train=train, group=group))
            for b in range(NUM_BRANCHES)]
        u = branches[0] + branches[1]
        z = self.fc_z(global_avg_pool(u).float())  # (N, d)
        z = torch.relu(self.bn_z(z, train=train, group=group))
        logits = self.fc_select(z).view(-1, NUM_BRANCHES, self.out_ch)
        attn = torch.softmax(logits, dim=1).to(u.dtype)  # (N, B, C)
        return (branches[0] * attn[:, 0, :, None, None]
                + branches[1] * attn[:, 1, :, None, None])
