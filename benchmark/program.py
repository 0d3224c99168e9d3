"""The system under test, built from ``axcnn_torch``'s own entry points: the
model, the train state and step of ``train/train_step.py``, the serving
forward ``eval_logits``. The parameters are the benchmark's
(``weights.make_params``), copied into the model on the device.
"""

from __future__ import annotations

import torch

from axcnn_torch.core.dtypes import BF16_POLICY, DEFAULT_POLICY, INT8_SERVING_POLICY
from axcnn_torch.models.resnet import ModelConfig, ResNet
from axcnn_torch.train.ema import ema_init
from axcnn_torch.train.optimizer import momentum_init
from axcnn_torch.train.schedules import make_lr_schedule, scale_lr_for_batch
from axcnn_torch.train.train_step import TrainState, eval_logits, make_train_step
from benchmark.weights import make_params

POLICIES = {"fp32": DEFAULT_POLICY, "bf16": BF16_POLICY, "int8": INT8_SERVING_POLICY}


def model_config(config: dict) -> ModelConfig:
    m = dict(config["model"])
    m["dropblock_stages"] = tuple(m["dropblock_stages"])
    return ModelConfig(**m)


def build_state(config: dict, seed: int, device, *, use_ema: bool) -> TrainState:
    """The model on ``device`` (channels_last) holding the benchmark's
    parameters for ``seed``, moving statistics at 0 and 1, zero momentum,
    and the EMA as a copy of the parameters."""
    cfg = model_config(config)
    with torch.device("meta"):
        model = ResNet(cfg)
    model = model.to_empty(device=device)
    params = make_params({k: tuple(p.shape) for k, p in model.named_parameters()}, seed, device)
    with torch.no_grad():
        names = [k for k, _ in model.named_parameters()]
        torch._foreach_copy_([p for _, p in model.named_parameters()], [params[k] for k in names])
        for name, b in model.named_buffers():
            b.fill_(0.0 if name.endswith("running_mean") else 1.0)
    del params
    model = model.to(memory_format=torch.channels_last).eval()
    p = dict(model.named_parameters())
    return TrainState(model=model, ema=ema_init(p) if use_ema else None,
                      velocity=momentum_init(p))


def lr_schedule(config: dict):
    """The recipe's schedule: linear warmup, then its decay, over its epochs
    of its training set at its global batch."""
    r = config["train"]
    per_epoch = r["train_examples"] // r["global_batch"]
    return make_lr_schedule(base_lr=scale_lr_for_batch(r["base_lr"], r["global_batch"]),
                            total_steps=per_epoch * r["train_epochs"],
                            warmup_steps=int(r["lr_warmup_epochs"] * per_epoch),
                            decay_type=r["lr_decay_type"])


def train_step_fn(config: dict, traffic: dict, group=None):
    """``make_train_step`` with the recipe's settings and learning rate;
    DropBlock's keep-probability ramp runs over ``dropblock_ramp_steps``
    steps (so from there on it is at its final value)."""
    r = config["train"]
    return make_train_step(
        model_config(config), lr_schedule=lr_schedule(config),
        total_steps=traffic["dropblock_ramp_steps"], policy=POLICIES[config["dtype"]],
        label_smoothing=r["label_smoothing"], mixup_alpha=r["mixup_alpha"],
        weight_decay=r["weight_decay"], momentum=r["momentum"], use_ema=r["use_ema"],
        ema_decay=r["ema_decay"], group=group)


def serve_fn(state: TrainState, dtype: str):
    policy = POLICIES[dtype]
    return lambda images_u8: eval_logits(state, images_u8, policy=policy)
