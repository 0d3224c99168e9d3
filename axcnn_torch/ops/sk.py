"""Selective-Kernel unit (port of ``axcnn/ops/sk.py``).

Two branches, a 3x3 and a 3x3 with dilation 2, each conv -> BN -> ReLU;
``z = ReLU(BN(FC(GAP(u))))`` on the (N, d) vector with ``u`` the branch sum
(in train mode that BN takes its statistics over N alone); a per-branch
softmax attention in fp32, cast to ``u``'s dtype, mixes the branches.

``merged=True`` (the reference's ``sk_merged_conv``) computes both branch
convs as one 5x5 conv with 2C outputs: on each forward the dense 3x3 weight
is embedded at taps ``[1:4, 1:4]`` and the dilation-2 one at ``[::2, ::2]``
of a zero 5x5 (``merged_sk_weight``), and the output's channels are split.
With TF fixed padding (2 on each side for all three) it is tap for tap the
two convs at any stride. The parameters, and so the checkpoint names, stay
those of the two-conv form; the gradients reach both through the embedding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from axcnn_torch.ops.conv import Conv, Dense, conv2d_fixed_padding
from axcnn_torch.ops.norm import BN_MOMENTUM, BatchNorm
from axcnn_torch.ops.pooling import global_avg_pool

NUM_BRANCHES = 2


def merged_sk_weight(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """Both branches' OIHW 3x3 weights in one (2C, I, 5, 5) weight (the
    reference's ``_merged_sk_kernel``, OIHW): ``w0`` at taps [1:4, 1:4],
    the dilation-2 ``w1`` at taps [::2, ::2], zeros elsewhere."""
    five1 = w1.new_zeros(w1.shape[:2] + (5, 5))
    five1[..., ::2, ::2] = w1
    return torch.cat([F.pad(w0, (1, 1, 1, 1)), five1])


class SK(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, *, stride: int = 1,
                 ratio: int = 16, min_dim: int = 32,
                 bn_momentum: float = BN_MOMENTUM, merged: bool = False):
        super().__init__()
        d = max(out_ch // ratio, min_dim)
        self.out_ch, self.stride, self.merged = out_ch, stride, merged
        for b in range(NUM_BRANCHES):
            self.add_module(f"conv{b}", Conv(3, in_ch, out_ch, stride=stride,
                                             dilation=b + 1))
            self.add_module(f"bn{b}", BatchNorm(out_ch, momentum=bn_momentum))
        self.fc_z = Dense(out_ch, d, std=(2.0 / out_ch) ** 0.5, bias=False)
        self.bn_z = BatchNorm(d, momentum=bn_momentum)
        self.fc_select = Dense(d, NUM_BRANCHES * out_ch, std=(1.0 / d) ** 0.5)

    def forward(self, x, compute_dtype=None, *, train: bool = False, group=None,
                quantize: bool = False, spatial=None):
        """``group``: the process group train-mode BN averages its statistics
        over (None: this rank's batch alone). ``quantize``: the branch convs
        (or the merged one) through the dynamic int8 conv. ``spatial``: the
        convs take their halo rows (two for the dilated branch and the
        merged 5x5) and the pooled ``u`` is the whole image's, so the
        attention is the same on every rank of the spatial row."""
        if self.merged:
            h2 = conv2d_fixed_padding(x, merged_sk_weight(self.conv0.weight, self.conv1.weight),
                                      stride=self.stride, compute_dtype=compute_dtype,
                                      quantize=quantize, spatial=spatial)
            raw = [h2[:, :self.out_ch], h2[:, self.out_ch:]]
        else:
            raw = [getattr(self, f"conv{b}")(x, compute_dtype, quantize, spatial)
                   for b in range(NUM_BRANCHES)]
        branches = [torch.relu(getattr(self, f"bn{b}")(raw[b], train=train, group=group))
                    for b in range(NUM_BRANCHES)]
        u = branches[0] + branches[1]
        z = self.fc_z(global_avg_pool(u, spatial).float())  # (N, d)
        z = torch.relu(self.bn_z(z, train=train, group=group))
        logits = self.fc_select(z).view(-1, NUM_BRANCHES, self.out_ch)
        attn = torch.softmax(logits, dim=1).to(u.dtype)  # (N, B, C)
        return (branches[0] * attn[:, 0, :, None, None]
                + branches[1] * attn[:, 1, :, None, None])
