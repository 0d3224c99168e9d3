"""Carry weights between the JAX reference's trees and the port's state_dict.

The reference keeps ``(params, state)`` as nested dicts (``stem/conv0/w``,
``stage2/block0/bn3/gamma``; state ``.../bn3/mean``); the port's module tree
uses the same names, so the mapping is by rule on the leaf:

============================  ==========================  =================
reference leaf                port key                    layout
============================  ==========================  =================
``<conv>/w`` (4-D, HWIO)      ``<conv>.weight``           OIHW
``<dense>/w`` (2-D, in x out) ``<dense>.weight``          (out, in)
``<dense>/b``                 ``<dense>.bias``
``se/w1 b1 w2 b2``            ``se.fc1|fc2.weight|bias``  (out, in)
``<bn>/gamma beta``           ``<bn>.weight|bias``
state ``<bn>/mean var``       ``<bn>.running_mean|var``
============================  ==========================  =================

Only the unrolled reference layout is taken (``scan_blocks=False``; convert
with ``axcnn.models.resnet.params_from_scan`` first). Arrays are numpy.

The whole training state crosses too (``train_state_from_axcnn`` and
``train_state_to_axcnn``): step, parameters, BN statistics, and the
velocity and EMA trees, which have the parameters' shape and take the same
leaf rule.
"""

from __future__ import annotations

import numpy as np
import torch

_SE = {"w1": ("fc1", "weight"), "b1": ("fc1", "bias"),
       "w2": ("fc2", "weight"), "b2": ("fc2", "bias")}
_SE_INV = {v: k for k, v in _SE.items()}
_BN_PARAM = {"gamma": "weight", "beta": "bias"}
_BN_STATE = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def _to_torch_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if a.ndim == 2:
        return a.T  # (in, out) -> (out, in)
    return a


def _from_torch_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    if a.ndim == 2:
        return a.T
    return a


def _param_key(path) -> str:
    *mods, leaf = path
    if leaf in _BN_PARAM:
        return ".".join(mods + [_BN_PARAM[leaf]])
    if mods and mods[-1] == "se" and leaf in _SE:
        return ".".join(mods + list(_SE[leaf]))
    if leaf in ("w", "b"):
        return ".".join(mods + ["weight" if leaf == "w" else "bias"])
    raise ValueError(f"unknown reference param leaf {'/'.join(path)}")


def _expected_shapes(cfg) -> dict:
    from axcnn_torch.models.resnet import ResNet

    with torch.device("meta"):
        model = ResNet(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def tree_to_state_dict(params, state) -> dict:
    """Reference ``(params, state)`` trees of any module (the model, a block,
    an SK unit) -> that module's ``state_dict`` (fp32 tensors)."""
    sd = {}
    for path, a in _flatten(params):
        sd[_param_key(path)] = _to_torch_layout(a)
    for path, a in _flatten(state):
        *mods, leaf = path
        if leaf not in _BN_STATE:
            raise ValueError(f"unknown reference state leaf {'/'.join(path)}")
        sd[".".join(mods + [_BN_STATE[leaf]])] = a
    return {k: torch.tensor(v) for k, v in sd.items()}


def from_axcnn(params, state, cfg) -> dict:
    """Reference ``(params, state)`` trees -> the port's ``state_dict`` for
    ``ResNet(cfg)`` (fp32 tensors). Raises on any missing, extra or
    mis-shaped entry."""
    sd = tree_to_state_dict(params, state)
    want = _expected_shapes(cfg)
    got = {k: tuple(v.shape) for k, v in sd.items()}
    if got != want:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        shape = sorted(k for k in set(want) & set(got) if want[k] != got[k])
        raise ValueError(f"tree does not match the model: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}, mis-shaped {shape[:5]}")
    return sd


def bn_modules(state_dict) -> set:
    """The BatchNorm modules of a full ``state_dict`` (those with buffers)."""
    return {k[: -len(".running_mean")] for k in state_dict
            if k.endswith(".running_mean")}


def _reference_path(key: str, bn_mods) -> tuple[bool, list]:
    """A port key -> (is model state, the reference's path to the leaf)."""
    *mods, leaf = key.split(".")
    if ".".join(mods) in bn_mods:
        if leaf in ("running_mean", "running_var"):
            return True, mods + [leaf[len("running_"):]]
        return False, mods + ["gamma" if leaf == "weight" else "beta"]
    if len(mods) >= 2 and mods[-2] == "se":
        return False, mods[:-1] + [_SE_INV[(mods[-1], leaf)]]
    return False, mods + ["w" if leaf == "weight" else "b"]


def reference_paths(state_dict) -> dict:
    """``{port key: 'stage2/block0/bn3/gamma'}``: the reference's leaf path of
    every entry of a full ``state_dict``. A BN scale and a conv kernel share
    the torch name ``weight``; here they are ``gamma`` and ``w``."""
    bn_mods = bn_modules(state_dict)
    return {k: "/".join(_reference_path(k, bn_mods)[1]) for k in state_dict}


def to_axcnn(state_dict, bn_mods=None) -> tuple[dict, dict]:
    """The port's ``state_dict`` -> reference ``(params, state)`` trees of
    numpy arrays (the inverse of :func:`from_axcnn`). A dict of parameters
    alone (velocity, EMA) has no BN buffers to tell the BN modules by, so it
    needs ``bn_mods`` from the model's full ``state_dict``."""
    if bn_mods is None:
        bn_mods = bn_modules(state_dict)
    params, state = {}, {}

    def put(tree, path, value):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = value

    for key, t in state_dict.items():
        a = t.detach().cpu().float().numpy()
        is_state, path = _reference_path(key, bn_mods)
        put(state if is_state else params, path, _from_torch_layout(a))
    return params, state


def train_state_from_axcnn(jstate, cfg, *, device="cpu"):
    """The reference's ``TrainState`` (step, params, model_state, velocity,
    ema; numpy or jax arrays) -> the port's ``TrainState`` on ``device``.
    Velocity and EMA are parameter-shaped trees and take the same leaf rule."""
    from axcnn_torch.models.resnet import ResNet
    from axcnn_torch.train.train_step import TrainState

    model = ResNet(cfg)
    model.load_state_dict(from_axcnn(jstate.params, jstate.model_state, cfg))
    model = model.to(device, memory_format=torch.channels_last)
    names = [k for k, _ in model.named_parameters()]

    def params_like(tree):
        if tree is None:
            return None
        sd = tree_to_state_dict(tree, {})
        if sorted(sd) != sorted(names):
            raise ValueError("tree does not match the model's parameters")
        return {k: sd[k].to(device).contiguous(memory_format=_format(p))
                for k, p in model.named_parameters()}

    return TrainState(model=model, step=int(np.asarray(jstate.step)),
                      velocity=params_like(jstate.velocity),
                      ema=params_like(jstate.ema))


def _format(p):
    return torch.channels_last if p.dim() == 4 else torch.contiguous_format


def train_state_to_axcnn(state) -> dict:
    """The port's ``TrainState`` -> the reference's fields as numpy trees:
    ``{"step", "params", "model_state", "velocity", "ema"}``, ready for
    ``axcnn.train.train_step.TrainState(**d)``."""
    full = state.model.state_dict()
    bn_mods = bn_modules(full)
    params, model_state = to_axcnn(full)

    def tree(d):
        return None if d is None else to_axcnn(d, bn_mods)[0]

    return {"step": np.int32(state.step), "params": params,
            "model_state": model_state, "velocity": tree(state.velocity),
            "ema": tree(state.ema)}
