"""Assembled ResNet v1 bottleneck family, eval mode (port of
``axcnn/models/resnet.py``).

ResNet-50/101/152 with the assembly knobs the serving path uses: ResNet-D
stem and shortcut, SE, SK, BlurPool ``sconv|proj|max``, zero-gamma and
``width_multiplier``. Module and parameter names follow the reference's
param tree (``stem.conv0``, ``stage2.block0.sk.fc_z``, ``head``), so
``axcnn_torch.ckpt.convert`` maps one onto the other by rule.

Not ported yet, and refused with ``NotImplementedError`` (ROADMAP.md):
train mode (batch-stat BN, DropBlock), Big-Little stages (``bl_alpha``),
``scan_blocks`` (a JAX compile-time lever) and the merged SK 5x5 conv.
In eval, DropBlock is the identity and ``remat`` has no effect, as in the
reference.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from axcnn_torch.core.dtypes import DEFAULT_POLICY, Policy
from axcnn_torch.ops.blurpool import blur_pool
from axcnn_torch.ops.conv import Conv, Dense
from axcnn_torch.ops.norm import BatchNorm
from axcnn_torch.ops.pooling import avg_pool_same, global_avg_pool, max_pool_same
from axcnn_torch.ops.se import SE
from axcnn_torch.ops.sk import SK

RESNET_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
_STAGE_FILTERS = (64, 128, 256, 512)
_EXPANSION = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Same fields, defaults and validation as the reference's
    ``ModelConfig`` (tests/test_torch_config.py pins them)."""
    resnet_size: int = 50
    num_classes: int = 1000
    use_resnet_d: bool = False
    use_se_block: bool = False
    use_sk_block: bool = False
    sk_merged_conv: bool = False
    se_ratio: int = 16
    anti_alias_type: str = "none"  # none | sconv | proj | max
    anti_alias_filter_size: int = 3
    use_dropblock: bool = False
    dropblock_block_size: int = 7
    dropblock_keep_prob: float = 0.9
    dropblock_stages: Sequence[int] = (3, 4)  # 1-indexed
    zero_gamma: bool = False
    bn_momentum: float = 0.997
    bl_alpha: int = 0  # Big-Little: 0 disables
    bl_beta: int = 0
    width_multiplier: float = 1.0
    remat: str = "none"
    scan_blocks: bool = False

    def __post_init__(self):
        if self.resnet_size not in RESNET_BLOCKS:
            raise ValueError(f"resnet_size must be one of {sorted(RESNET_BLOCKS)}")
        if self.anti_alias_type not in ("none", "sconv", "proj", "max"):
            raise ValueError(f"bad anti_alias_type {self.anti_alias_type!r}")
        if (self.bl_alpha > 0) != (self.bl_beta > 0):
            raise ValueError("bl_alpha and bl_beta must be set together")
        if self.remat not in ("none", "conv", "conv_nocse", "blocks"):
            raise ValueError(
                f"remat must be none|conv|conv_nocse|blocks, got {self.remat!r}")

    @property
    def use_bl(self) -> bool:
        return self.bl_alpha > 0 and self.bl_beta > 0

    @property
    def blocks(self):
        return RESNET_BLOCKS[self.resnet_size]

    def stage_filters(self, stage_idx: int) -> int:
        return int(_STAGE_FILTERS[stage_idx] * self.width_multiplier)


def _check_ported(cfg: ModelConfig) -> None:
    missing = [name for name, on in (
        ("Big-Little stages (bl_alpha/bl_beta)", cfg.use_bl),
        ("scan_blocks", cfg.scan_blocks),
        ("sk_merged_conv", cfg.sk_merged_conv),
        ("anti_alias_filter_size != 3",
         cfg.anti_alias_type != "none" and cfg.anti_alias_filter_size != 3),
    ) if on]
    if missing:
        raise NotImplementedError(
            f"not ported to axcnn_torch yet: {', '.join(missing)} (ROADMAP.md "
            "Queue A)")


class Stem(nn.Module):
    """ResNet-D deep stem 3x3/2 (32) -> 3x3 (32) -> 3x3 (64), or the 7x7/2
    stem; then the 3x3/2 SAME max pool, or for ``anti_alias_type='max'`` a
    dense 3x3/1 max pool followed by BlurPool."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.blur_max = cfg.anti_alias_type == "max"
        widths = [(3, 32), (32, 32), (32, 64)] if cfg.use_resnet_d else [(3, 64)]
        self.depth = len(widths)
        for i, (cin, cout) in enumerate(widths):
            k = 3 if cfg.use_resnet_d else 7
            self.add_module(f"conv{i}", Conv(k, cin, cout, stride=2 if i == 0 else 1))
            self.add_module(f"bn{i}", BatchNorm(cout))

    def forward(self, x, compute_dtype):
        for i in range(self.depth):
            x = getattr(self, f"conv{i}")(x, compute_dtype)
            x = torch.relu(getattr(self, f"bn{i}")(x))
        if self.blur_max:
            return blur_pool(max_pool_same(x, window=3, stride=1))
        return max_pool_same(x, window=3, stride=2)


class Block(nn.Module):
    """Bottleneck: 1x1 -> 3x3 (or SK) [-> BlurPool] -> 1x1 -> BN [-> SE],
    plus the shortcut. With anti-aliasing, a stride-2 block moves its stride
    from the mid conv into a BlurPool after it."""

    def __init__(self, cfg: ModelConfig, in_ch: int, filters: int, *,
                 stride: int, has_proj: bool):
        super().__init__()
        out_ch = filters * _EXPANSION
        aa = cfg.anti_alias_type != "none"
        self.stride = stride
        self.blur_mid = aa and stride > 1
        # shortcut downsample: ResNet-D avg pool, or BlurPool for proj/max
        self.short_pool = None
        if has_proj and stride > 1:
            if cfg.use_resnet_d:
                self.short_pool = "avg"
            elif cfg.anti_alias_type in ("proj", "max"):
                self.short_pool = "blur"
        if has_proj:
            proj_stride = stride if (stride > 1 and self.short_pool is None) else 1
            self.proj_conv = Conv(1, in_ch, out_ch, stride=proj_stride)
            self.proj_bn = BatchNorm(out_ch)

        mid_stride = 1 if self.blur_mid else stride
        self.conv1 = Conv(1, in_ch, filters)
        self.bn1 = BatchNorm(filters)
        if cfg.use_sk_block:
            self.sk = SK(filters, filters, stride=mid_stride)
        else:
            self.conv2 = Conv(3, filters, filters, stride=mid_stride)
            self.bn2 = BatchNorm(filters)
        self.conv3 = Conv(1, filters, out_ch)
        self.bn3 = BatchNorm(out_ch, zero_gamma=cfg.zero_gamma)
        if cfg.use_se_block:
            self.se = SE(out_ch, ratio=cfg.se_ratio)

    def _shortcut(self, x, cd):
        if not hasattr(self, "proj_conv"):
            return x
        if self.short_pool == "avg":
            x = avg_pool_same(x, window=self.stride, stride=self.stride)
        elif self.short_pool == "blur":
            x = blur_pool(x, stride=self.stride)
        return self.proj_bn(self.proj_conv(x, cd))

    def forward(self, x, compute_dtype):
        cd = compute_dtype
        shortcut = self._shortcut(x, cd)
        h = torch.relu(self.bn1(self.conv1(x, cd)))
        if hasattr(self, "sk"):
            h = self.sk(h, cd)
        else:
            h = torch.relu(self.bn2(self.conv2(h, cd)))
        if self.blur_mid:
            h = blur_pool(h, stride=self.stride)
        h = self.bn3(self.conv3(h, cd))
        if hasattr(self, "se"):
            h = self.se(h)
        return torch.relu(h + shortcut.to(h.dtype))


class ResNet(nn.Module):
    """The configured model. Parameters are initialised from ``generator``
    (the reference's distributions; the draws differ from ``jax.random``)."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.stem = Stem(cfg)
        in_ch = 64
        for s in range(4):
            filters = cfg.stage_filters(s)
            stage = nn.ModuleDict()
            for b in range(cfg.blocks[s]):
                # first block of each stage projects (and strides if s > 0)
                stage[f"block{b}"] = Block(cfg, in_ch, filters,
                                           stride=2 if (s > 0 and b == 0) else 1,
                                           has_proj=b == 0)
                in_ch = filters * _EXPANSION
            self.add_module(f"stage{s + 1}", stage)
        self.head = Dense(in_ch, cfg.num_classes, std=0.01)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, images, *, train: bool = False,
                policy: Policy = DEFAULT_POLICY):
        """NHWC float images -> fp32 logits (N, num_classes)."""
        if train:
            raise NotImplementedError(
                "the training forward is not ported yet (ROADMAP.md Queue A "
                "item 5)")
        cd = policy.compute_dtype
        # NHWC -> NCHW view: the memory stays NHWC, i.e. channels_last
        x = policy.cast_to_compute(images).permute(0, 3, 1, 2)
        x = self.stem(x, cd)
        for s in range(4):
            for block in getattr(self, f"stage{s + 1}").values():
                x = block(x, cd)
        pooled = global_avg_pool(x)  # (N, C), in the compute dtype
        return self.head(pooled, compute_dtype=torch.float32).float()
