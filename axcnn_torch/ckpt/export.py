"""Serving export (port of ``axcnn/ckpt/export.py``).

The reference serializes its jitted serving function to StableHLO; the port
writes a ``torch.export`` program of the same function, uint8 NHWC images
-> fp32 logits (``normalize_device``, then the model's eval forward under
the policy), at a fixed batch as the reference's is, traced on the device it
will serve on. An export directory holds:

    serving.pt2  -- the ``torch.export`` program (``torch.export.save``)
    weights.pt   -- the served weights (the EMA ones when trained with EMA)
                    and the BN statistics, by the program's parameter names
    config.json  -- the ModelConfig, batch and image size, the compute dtype,
                    ``quantized_int8`` and the device the program was traced on

Under the int8 policy the quantization is part of the program, as in the
reference. BlurPool 3x3/2 is the custom op ``axcnn::blur_pool3_s2``
(``axcnn_torch.kernels.blurpool``) in the program, so the device the
program runs on picks its implementation: the kernel on the card.

Unlike the reference's StableHLO, which loads without ``axcnn``, this
program needs ``axcnn_torch`` installed where it is loaded: the custom op
must be registered before the program deserializes, and ``load_serving``
imports the module that registers it. A program traced on the card holds
device constants (``normalize_device``'s mean and std) and the card's int8
route, one traced on the CPU the plain routes, so ``load_serving`` serves
it on the device type it was traced on and refuses another.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch
from torch import nn

from axcnn_torch.core.dtypes import DEFAULT_POLICY, Policy
from axcnn_torch.data.preprocessing import normalize_device
from axcnn_torch.kernels import blurpool as _registers_axcnn_ops  # noqa: F401
from axcnn_torch.models.resnet import ModelConfig

SERVING_FILE, WEIGHTS_FILE, CONFIG_FILE = "serving.pt2", "weights.pt", "config.json"


class ServingModule(nn.Module):
    """uint8 NHWC images -> fp32 logits of ``model`` under ``policy``."""

    def __init__(self, model: nn.Module, policy: Policy, mean=None, std=None):
        super().__init__()
        self.model, self.policy, self.mean, self.std = model, policy, mean, std

    def forward(self, images_u8):
        x = normalize_device(images_u8, self.mean, self.std)
        return self.model(x, policy=self.policy)


def export_serving(path: str, cfg: ModelConfig, model: nn.Module, *, batch_size: int = 8,
                   image_size: int = 224, policy: Policy = DEFAULT_POLICY,
                   mean=None, std=None) -> str:
    """Write a serving export of ``model`` (its weights as they are: load the
    EMA ones first to serve those) on the device ``model`` lives on;
    returns the directory."""
    if model.cfg != cfg:
        raise ValueError("export_serving: the model was built for another ModelConfig")
    os.makedirs(path, exist_ok=True)
    device = next(model.parameters()).device
    serving = ServingModule(model, policy, mean, std).eval()
    example = torch.zeros((batch_size, image_size, image_size, 3), dtype=torch.uint8,
                          device=device)
    with torch.no_grad():
        program = torch.export.export(serving, (example,))
    torch.export.save(program, os.path.join(path, SERVING_FILE))
    torch.save({k: v.detach() for k, v in serving.state_dict().items()},
               os.path.join(path, WEIGHTS_FILE))
    meta = {
        "model_config": dataclasses.asdict(cfg),
        "batch_size": batch_size,
        "image_size": image_size,
        "compute_dtype": str(policy.compute_dtype).removeprefix("torch."),
        # the quantization is inside the program; recorded for provenance
        "quantized_int8": bool(policy.quantize_conv),
        "device": device.type,
    }
    with open(os.path.join(path, CONFIG_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return path


def load_serving(path: str, device=None):
    """Reload an export on ``device`` (default: the CUDA card; ``"cpu"`` for
    the host); returns ``(fn(images_u8) -> fp32 logits, meta)``. ``fn``
    takes a uint8 NHWC tensor or array of the export's batch size."""
    with open(os.path.join(path, CONFIG_FILE)) as f:
        meta = json.load(f)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_serving: no CUDA device; pass device='cpu' to serve "
                           "an export traced on the CPU")
    if device.type != meta["device"]:
        raise ValueError(f"the export in {path} was traced on {meta['device']}; export "
                         f"it again on {device.type} to serve it there")
    module = torch.export.load(os.path.join(path, SERVING_FILE)).module()
    weights = torch.load(os.path.join(path, WEIGHTS_FILE), map_location=device,
                         weights_only=True)
    module.load_state_dict(weights)
    module.to(device)

    def fn(images_u8):
        with torch.inference_mode():
            return module(torch.as_tensor(images_u8).to(device))

    return fn, meta
