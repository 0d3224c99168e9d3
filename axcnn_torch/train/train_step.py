"""Evaluation step (port of the eval half of ``axcnn/train/train_step.py``).

``make_eval_step`` with the EMA swap (BASELINE config 3), ``topk_correct``
and ``pad_batch``. The training step (mixup, losses, SGD, EMA and BN updates)
comes with the training slice (ROADMAP.md Queue A item 5).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import functional_call

from axcnn_torch.core.dtypes import DEFAULT_POLICY, Policy
from axcnn_torch.data.preprocessing import normalize_device
from axcnn_torch.models.resnet import ModelConfig, ResNet


@dataclasses.dataclass
class TrainState:
    model: ResNet  # parameters + BN moving statistics (buffers)
    ema: dict | None  # EMA shadow of the parameters, by name; None when off


def create_train_state(cfg: ModelConfig, *, generator: torch.Generator,
                       device, use_ema: bool = True) -> TrainState:
    """Random-init the model on the host from ``generator``, then move it to
    ``device`` with channels_last weights. The EMA starts as a copy of the
    parameters, as in the reference."""
    model = ResNet(cfg, generator=generator).to(
        device, memory_format=torch.channels_last).eval()
    ema = ({k: p.detach().clone() for k, p in model.named_parameters()}
           if use_ema else None)
    return TrainState(model=model, ema=ema)


def load_ema(state: TrainState) -> None:
    """Copy the EMA weights into the model, once, for serving. Serving never
    updates them, so its forwards need no per-call swap; ``make_eval_step``
    keeps both sets live and swaps per call instead."""
    if state.ema is None:
        return
    result = state.model.load_state_dict(state.ema, strict=False)
    assert not result.unexpected_keys, result.unexpected_keys


def eval_logits(state: TrainState, images_u8, *, policy: Policy = DEFAULT_POLICY,
                use_ema: bool = False, mean_rgb=None, stddev_rgb=None):
    """uint8 NHWC batch -> fp32 logits, with the EMA weights swapped in when
    ``use_ema`` (the reference's EMA-swap scaffold)."""
    x = normalize_device(images_u8, mean_rgb, stddev_rgb)
    with torch.inference_mode():
        if use_ema and state.ema is not None:
            return functional_call(state.model, state.ema, (x,),
                                   {"policy": policy})
        return state.model(x, policy=policy)


def topk_correct(logits, labels, ks=(1, 5)):
    """Returns {f'top{k}': count of correct} (sums, not means)."""
    out = {}
    for k in ks:
        kk = min(k, logits.shape[-1])  # few-class datasets: top-5 of 3 classes
        topk = torch.topk(logits, kk, dim=-1).indices
        correct = (topk == labels[:, None]).any(dim=-1)
        out[f"top{k}"] = correct.float().sum()
    return out


def make_eval_step(cfg: ModelConfig, *, policy: Policy = DEFAULT_POLICY,
                   use_ema: bool = False, mean_rgb=None, stddev_rgb=None):
    """Builds ``eval_step(state, batch) -> metrics`` (sums + count, so the
    caller aggregates exactly over uneven final batches). ``cfg`` is the
    model config the state was built from."""

    def eval_step(state: TrainState, batch):
        if state.model.cfg != cfg:
            raise ValueError("eval_step built for another model config")
        logits = eval_logits(state, batch["images"], policy=policy,
                             use_ema=use_ema, mean_rgb=mean_rgb,
                             stddev_rgb=stddev_rgb)
        labels = batch["labels"]
        # padded rows carry label -1: never correct, and masked out of loss/count
        valid = (labels >= 0).float()
        metrics = topk_correct(logits, labels)
        metrics["count"] = valid.sum()
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(1, labels.clamp(min=0)[:, None])[:, 0]
        metrics["loss_sum"] = (nll * valid).sum()
        return metrics

    return eval_step


def pad_batch(batch, batch_size: int):
    """Pad a short final eval batch to ``batch_size`` (labels -> -1)."""
    images, labels = batch["images"], batch["labels"]
    pad = batch_size - labels.shape[0]
    if pad == 0:
        return batch
    return {
        "images": torch.cat([images, images.new_zeros((pad,) + images.shape[1:])]),
        "labels": torch.cat([labels, labels.new_full((pad,), -1)]),
    }
