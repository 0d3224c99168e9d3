"""Assembled ResNet v1 bottleneck family (port of ``axcnn/models/resnet.py``).

ResNet-50/101/152 with the assembly knobs: ResNet-D stem and shortcut, SE,
SK (two convs, or ``sk_merged_conv``'s one 5x5), BlurPool ``sconv|proj|max``
with any ``anti_alias_filter_size`` in 1-7, DropBlock after every block of
``dropblock_stages`` in training, zero-gamma, ``width_multiplier`` and
Big-Little stages. The train forward uses batch-statistic BN everywhere
(averaged over a process group when given: sync-BN) and updates the moving
statistics in place. Module and parameter names follow the reference's
param tree (``stem.conv0``, ``stage2.block0.sk.fc_z``,
``stage2.big.block0.conv1``, ``head``), so ``axcnn_torch.ckpt.convert``
maps one onto the other by rule.

Big-Little (``bl_alpha``, ``bl_beta``; bL-Net) replaces stages 2-3 with a
``BLStage``: the stage's stride-2 projection block (``entry``, input
resolution R down to S), then a ``big`` branch of n-1 full-width blocks one
octave below S (its first block strides S -> S/2 and projects) and a
``little`` branch of ``max(1, n // beta)`` blocks at S and width
``max(filters // alpha, 16)`` followed by a 1x1 conv and BN
(``little_proj``, ``little_proj_bn``, no zero-gamma) up to the stage width;
the merge upsamples ``big`` to S by nearest neighbour with half-pixel
centres (``jax.image.resize``'s ``nearest``: ``F.interpolate``'s
``nearest-exact``, not ``nearest``, whenever S is odd), adds ``little`` and
applies ReLU. DropBlock sits at such a stage's output
(``dropblock/stage{s}/out``), not after its blocks.

``remat="blocks"`` in training runs the reference's regions, the stem and
each residual block (a BL stage's blocks included; its projection and
merge are not), under ``torch.utils.checkpoint`` (non-reentrant): their
activations are recomputed in the backward. DropBlock stays outside the
regions, so it is not replayed; the replay leaves the BN moving statistics
alone (``ops.norm.replaying``), so they are updated once. ``remat="conv"``
/ ``"conv_nocse"`` are XLA name policies with no torch counterpart, and
refused in training with that reason.

``scan_blocks`` (a JAX compile-time lever with stacked weights) is refused
with ``NotImplementedError`` (ROADMAP.md Queue A item 11). In eval,
DropBlock is the identity and ``remat`` has no effect, as in the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from axcnn_torch.core.dtypes import DEFAULT_POLICY, Policy
from axcnn_torch.core.rng import RngStream
from axcnn_torch.ops.blurpool import blur_pool
from axcnn_torch.ops.dropblock import dropblock, dropblock_keep_prob, sample_seeds
from axcnn_torch.ops.conv import Conv, Dense
from axcnn_torch.ops.norm import BatchNorm, replaying
from axcnn_torch.ops.pooling import avg_pool_same, global_avg_pool, max_pool_same
from axcnn_torch.ops.se import SE
from axcnn_torch.ops.sk import SK

RESNET_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
_STAGE_FILTERS = (64, 128, 256, 512)
_EXPANSION = 4
_BL_STAGES = (1, 2)  # 0-indexed stages that get the Big-Little branches


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
    if cfg.scan_blocks:
        raise NotImplementedError(
            "axcnn_torch does not take scan_blocks, a JAX compile-time lever (lax.scan "
            "over stacked block weights) with no torch counterpart (ROADMAP.md Queue A "
            "item 11)")


class Stem(nn.Module):
    """ResNet-D deep stem 3x3/2 (32) -> 3x3 (32) -> 3x3 (64), or the 7x7/2
    stem; then the 3x3/2 SAME max pool, or for ``anti_alias_type='max'`` a
    dense 3x3/1 max pool followed by BlurPool."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.blur_max = cfg.anti_alias_type == "max"
        self.filter_size = cfg.anti_alias_filter_size
        widths = [(3, 32), (32, 32), (32, 64)] if cfg.use_resnet_d else [(3, 64)]
        self.depth = len(widths)
        for i, (cin, cout) in enumerate(widths):
            k = 3 if cfg.use_resnet_d else 7
            self.add_module(f"conv{i}", Conv(k, cin, cout, stride=2 if i == 0 else 1))
            self.add_module(f"bn{i}", BatchNorm(cout, momentum=cfg.bn_momentum))

    def forward(self, x, compute_dtype, train: bool = False, group=None, quantize=False):
        for i in range(self.depth):
            x = getattr(self, f"conv{i}")(x, compute_dtype, quantize)
            x = torch.relu(getattr(self, f"bn{i}")(x, train=train, group=group))
        if self.blur_max:
            return blur_pool(max_pool_same(x, window=3, stride=1), stride=2,
                             filter_size=self.filter_size)
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
        self.filter_size = cfg.anti_alias_filter_size
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
            self.proj_bn = BatchNorm(out_ch, momentum=cfg.bn_momentum)

        mid_stride = 1 if self.blur_mid else stride
        self.conv1 = Conv(1, in_ch, filters)
        m = cfg.bn_momentum
        self.bn1 = BatchNorm(filters, momentum=m)
        if cfg.use_sk_block:
            self.sk = SK(filters, filters, stride=mid_stride, bn_momentum=m,
                         merged=cfg.sk_merged_conv)
        else:
            self.conv2 = Conv(3, filters, filters, stride=mid_stride)
            self.bn2 = BatchNorm(filters, momentum=m)
        self.conv3 = Conv(1, filters, out_ch)
        self.bn3 = BatchNorm(out_ch, zero_gamma=cfg.zero_gamma, momentum=m)
        if cfg.use_se_block:
            self.se = SE(out_ch, ratio=cfg.se_ratio)

    def _shortcut(self, x, cd, train, group, qc):
        if not hasattr(self, "proj_conv"):
            return x
        if self.short_pool == "avg":
            x = avg_pool_same(x, window=self.stride, stride=self.stride)
        elif self.short_pool == "blur":
            x = blur_pool(x, stride=self.stride, filter_size=self.filter_size)
        return self.proj_bn(self.proj_conv(x, cd, qc), train=train, group=group)

    def forward(self, x, compute_dtype, train: bool = False, group=None, quantize=False):
        cd, qc = compute_dtype, quantize
        shortcut = self._shortcut(x, cd, train, group, qc)
        h = torch.relu(self.bn1(self.conv1(x, cd, qc), train=train, group=group))
        if hasattr(self, "sk"):
            h = self.sk(h, cd, train=train, group=group, quantize=qc)
        else:
            h = torch.relu(self.bn2(self.conv2(h, cd, qc), train=train, group=group))
        if self.blur_mid:
            h = blur_pool(h, stride=self.stride, filter_size=self.filter_size)
        h = self.bn3(self.conv3(h, cd, qc), train=train, group=group)
        if hasattr(self, "se"):
            h = self.se(h)
        return torch.relu(h + shortcut.to(h.dtype))


class BLStage(nn.Module):
    """A Big-Little stage (the reference's ``_bl_stage_init`` /
    ``_bl_stage_apply``): ``entry``, the ``big`` and ``little`` branches,
    ``little_proj`` and ``little_proj_bn``, then the merge (module
    docstring)."""

    def __init__(self, cfg: ModelConfig, in_ch: int, filters: int, n_blocks: int):
        super().__init__()
        out_ch = filters * _EXPANSION
        little_filters = max(filters // max(cfg.bl_alpha, 1), 16)
        self.entry = Block(cfg, in_ch, filters, stride=2, has_proj=True)
        self.big = nn.ModuleDict({
            f"block{b}": Block(cfg, out_ch, filters, stride=2 if b == 0 else 1, has_proj=b == 0)
            for b in range(max(n_blocks - 1, 1))})
        self.little = nn.ModuleDict()
        ch = out_ch
        for b in range(max(1, n_blocks // max(cfg.bl_beta, 1))):
            self.little[f"block{b}"] = Block(cfg, ch, little_filters, stride=1, has_proj=b == 0)
            ch = little_filters * _EXPANSION
        self.little_proj = Conv(1, ch, out_ch)
        self.little_proj_bn = BatchNorm(out_ch, momentum=cfg.bn_momentum)

    def forward(self, x, compute_dtype, train: bool = False, group=None, quantize=False, *,
                remat: bool = False):
        args = (compute_dtype, train, group, quantize)
        x = _region(self.entry, x, *args, remat=remat)
        big = x
        for block in self.big.values():
            big = _region(block, big, *args, remat=remat)
        little = x
        for block in self.little.values():
            little = _region(block, little, *args, remat=remat)
        little = self.little_proj_bn(self.little_proj(little, compute_dtype, quantize),
                                     train=train, group=group)
        big_up = F.interpolate(big, size=little.shape[-2:], mode="nearest-exact")
        return torch.relu(big_up + little)


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
            if cfg.use_bl and s in _BL_STAGES:
                self.add_module(f"stage{s + 1}", BLStage(cfg, in_ch, filters, cfg.blocks[s]))
                in_ch = filters * _EXPANSION
                continue
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
                policy: Policy = DEFAULT_POLICY, rng: RngStream | None = None,
                progress: float = 1.0, dropblock_uniforms: dict | None = None,
                group=None):
        """NHWC float images -> fp32 logits (N, num_classes).

        ``train=True`` normalizes with batch statistics and updates the BN
        moving statistics in place; with a process ``group`` (sync-BN) the
        statistics are those of the batch over every rank of it.
        ``progress`` in [0, 1] drives the DropBlock keep-prob schedule;
        ``rng`` (the step's stream) seeds each DropBlock site by its name,
        ``dropblock/stage{s}/block{b}``, and is required when training with
        DropBlock; a Big-Little stage's site is ``dropblock/stage{s}/out``.
        ``dropblock_uniforms`` maps site names to (N, H, W) uniforms for the
        plain path (tests)."""
        cfg = self.cfg
        if train and cfg.remat in ("conv", "conv_nocse"):
            raise NotImplementedError(
                f"remat={cfg.remat!r} is an XLA name policy (save only the tagged conv "
                "outputs and BN statistics, recompute the rest) with no torch counterpart; "
                "remat='blocks' is the port's memory lever (ROADMAP.md Queue A item 11)")
        remat = train and cfg.remat == "blocks"
        use_db = train and cfg.use_dropblock
        if use_db and rng is None:
            raise ValueError("training with DropBlock requires rng")
        kp = dropblock_keep_prob(progress, cfg.dropblock_keep_prob)
        uniforms = dropblock_uniforms or {}
        args = (policy.compute_dtype, train, group, policy.quantize_conv)
        # NHWC -> NCHW view: the memory stays NHWC, i.e. channels_last
        x = policy.cast_to_compute(images).permute(0, 3, 1, 2)
        x = _region(self.stem, x, *args, remat=remat)
        def drop(x, site):
            return dropblock(x, sample_seeds(rng.numpy(site), x.shape[0]), keep_prob=kp,
                             block_size=cfg.dropblock_block_size, train=True,
                             uniforms=uniforms.get(site))

        for s in range(4):
            sname = f"stage{s + 1}"
            stage = getattr(self, sname)
            db_here = use_db and s + 1 in cfg.dropblock_stages
            if isinstance(stage, BLStage):
                x = stage(x, *args, remat=remat)
                if db_here:
                    x = drop(x, f"dropblock/{sname}/out")
                continue
            for b, block in enumerate(stage.values()):
                x = _region(block, x, *args, remat=remat)
                if db_here:
                    x = drop(x, f"dropblock/{sname}/block{b}")
        pooled = global_avg_pool(x)  # (N, C), in the compute dtype
        # the head computes in fp32 at least (a float64 policy keeps float64)
        head_dtype = torch.promote_types(pooled.dtype, torch.float32)
        return self.head(pooled, compute_dtype=head_dtype).float()


def _replay_contexts():
    # (around the first forward, around the replay in the backward)
    return contextlib.nullcontext(), replaying()


def _region(module, x, *args, remat: bool):
    """``module(x, *args)``; with ``remat``, under a non-reentrant
    checkpoint whose replay runs inside ``replaying()``. Nothing in a region
    draws from torch's generators, so their state is not saved."""
    if not remat:
        return module(x, *args)
    return checkpoint(module, x, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=_replay_contexts)
