"""TF1-checkpoint importer: the reference's ``Saver`` checkpoints -> the
port's ``state_dict`` (port of ``axcnn/ckpt/tf_import.py``).

The reference's published checkpoints were written by TensorFlow's
TF-official ResNet builder, whose variables are auto-numbered in creation
order under one scope:

    resnet_model/conv2d[_N]/kernel                                   (HWIO)
    resnet_model/batch_normalization[_N]/{gamma,beta,moving_mean,moving_variance}
    resnet_model/dense[_N]/{kernel,bias}                             (in, out)

and EMA shadows ``<var>/ExponentialMovingAverage`` of the trainable ones.
:func:`expected_tf_names` generates those names by walking the port's model
in the reference's creation order (the stem; each block's ``proj_conv``,
``proj_bn``, ``conv1``, ``bn1``, ``conv2``, ``bn2`` or SK's ``conv0``,
``bn0``, ``conv1``, ``bn1``, ``fc_z``, ``bn_z``, ``fc_select``, then
``conv3``, ``bn3``, SE; a Big-Little stage's ``entry``, ``big``,
``little``, ``little_proj``, ``little_proj_bn``; the head), and
:func:`import_tf_checkpoint` joins on the names and checks shapes. It reads
the checkpoint with :class:`axcnn_torch.ckpt.tf_bundle.BundleReader`, so
no TensorFlow is needed.
"""

from __future__ import annotations

import numpy as np
import torch

from axcnn_torch.ckpt.convert import _to_torch_layout
from axcnn_torch.ckpt.tf_bundle import BundleReader
from axcnn_torch.models.resnet import BLStage, ModelConfig, ResNet

SCOPE = "resnet_model"
EMA_SUFFIX = "/ExponentialMovingAverage"
_BLOCK_ORDER = ("proj_conv", "proj_bn", "conv1", "bn1", "conv2", "bn2", "sk", "conv3", "bn3",
                "se")
_BN_STATE = ("running_mean", "running_var")


class _Namer:
    """TF's auto-numbering: first use bare, then _1, _2, ..."""

    def __init__(self):
        self._counts = {}

    def next(self, base: str) -> str:
        n = self._counts.get(base, 0)
        self._counts[base] = n + 1
        return f"{SCOPE}/{base}" if n == 0 else f"{SCOPE}/{base}_{n}"


def expected_tf_names(cfg: ModelConfig) -> list[tuple[str, str, tuple]]:
    """``[(tf_name, port state_dict key, TF shape)]`` for every variable of
    ``ResNet(cfg)``, in the reference's creation order; conv kernels are
    HWIO and dense kernels (in, out), as TF stores them."""
    with torch.device("meta"):
        model = ResNet(cfg)
    namer = _Namer()
    out = []

    def conv(key, m):
        o, i, kh, kw = m.weight.shape
        out.append((f"{namer.next('conv2d')}/kernel", f"{key}.weight", (kh, kw, i, o)))

    def bn(key, m):
        name = namer.next("batch_normalization")
        c = (m.weight.shape[0],)
        out.extend([(f"{name}/gamma", f"{key}.weight", c), (f"{name}/beta", f"{key}.bias", c),
                    (f"{name}/moving_mean", f"{key}.running_mean", c),
                    (f"{name}/moving_variance", f"{key}.running_var", c)])

    def dense(key, m):
        name = namer.next("dense")
        o, i = m.weight.shape
        out.append((f"{name}/kernel", f"{key}.weight", (i, o)))
        if m.bias is not None:
            out.append((f"{name}/bias", f"{key}.bias", (o,)))

    def block(key, b):
        for part in _BLOCK_ORDER:
            if not hasattr(b, part):
                continue
            m, k = getattr(b, part), f"{key}.{part}"
            if part == "sk":
                for i in range(2):
                    conv(f"{k}.conv{i}", getattr(m, f"conv{i}"))
                    bn(f"{k}.bn{i}", getattr(m, f"bn{i}"))
                dense(f"{k}.fc_z", m.fc_z)
                bn(f"{k}.bn_z", m.bn_z)
                dense(f"{k}.fc_select", m.fc_select)
            elif part == "se":
                dense(f"{k}.fc1", m.fc1)
                dense(f"{k}.fc2", m.fc2)
            elif "conv" in part:
                conv(k, m)
            else:
                bn(k, m)

    for i in range(model.stem.depth):
        conv(f"stem.conv{i}", getattr(model.stem, f"conv{i}"))
        bn(f"stem.bn{i}", getattr(model.stem, f"bn{i}"))
    for s in range(1, 5):
        stage = getattr(model, f"stage{s}")
        if isinstance(stage, BLStage):
            block(f"stage{s}.entry", stage.entry)
            for branch in ("big", "little"):
                for name, b in getattr(stage, branch).items():
                    block(f"stage{s}.{branch}.{name}", b)
            conv(f"stage{s}.little_proj", stage.little_proj)
            bn(f"stage{s}.little_proj_bn", stage.little_proj_bn)
            continue
        for name, b in stage.items():
            block(f"stage{s}.{name}", b)
    dense("head", model.head)
    return out


def import_tf_checkpoint(ckpt_path: str, cfg: ModelConfig, state_dict: dict, *,
                         use_ema: bool = False, strict: bool = True):
    """``(state_dict, missing)``: a copy of ``state_dict`` (the port's names,
    e.g. ``ResNet(cfg).state_dict()``) with every variable found in the TF
    checkpoint at ``ckpt_path`` (a prefix, or a directory with a
    ``checkpoint`` file), in the port's layouts (OIHW, (out, in)) and each
    entry's dtype. ``use_ema=True`` reads the ``<var>/ExponentialMovingAverage``
    shadows of the trainable variables where the checkpoint has them (BN
    moving statistics have none). ``ValueError`` on a variable found under
    another shape; ``KeyError`` on missing variables when ``strict``, else
    they keep their values and their TF names are returned in ``missing``."""
    reader = BundleReader(ckpt_path)
    shapes = reader.get_variable_to_shape_map()
    new = {k: v.clone() for k, v in state_dict.items()}
    missing = []
    for tf_name, key, shape in expected_tf_names(cfg):
        lookup = tf_name
        if use_ema and not key.endswith(_BN_STATE) and tf_name + EMA_SUFFIX in shapes:
            lookup = tf_name + EMA_SUFFIX
        if lookup not in shapes:
            missing.append(tf_name)
            continue
        value = reader.get_tensor(lookup)
        if tuple(value.shape) != shape:
            raise ValueError(
                f"shape mismatch for {tf_name}: ckpt {value.shape} vs ours {shape}")
        new[key] = torch.from_numpy(np.ascontiguousarray(_to_torch_layout(value))).to(
            new[key].dtype)
    if missing and strict:
        raise KeyError(
            f"{len(missing)} variables not found in {ckpt_path}, e.g. {missing[:5]}")
    return new, missing
