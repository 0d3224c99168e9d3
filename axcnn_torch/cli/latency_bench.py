"""Serving latency by batch on one CUDA card: the assembled and the vanilla
ResNet-50, uint8 NHWC in, fp32 logits out (``scripts/latency_bench.py``).

    python -m axcnn_torch.cli.latency_bench [--batches 1,4,8,16,32,64,128] [--dtypes bf16,int8]

The served function is the port's serving forward, ``eval_logits``: the
images normalized on the device (``normalize_device``), the eval forward
under the policy (``bf16``: ``BF16_POLICY``; ``int8``:
``INT8_SERVING_POLICY``, the reference's post-training int8), fp32 logits.
The models are the reference script's, 1000 classes, random weights from
seed 0. Per batch, after ``WARMUP`` calls: ``sync_ms``, ``TIMED`` calls each
ending in a host read of one logit (what a synchronous server sees), and
``pipelined_ms`` / ``pipelined_img_s``, ``TIMED`` calls issued back to back
and one read at the end (a server with two or more requests in flight).
One JSON line a row, with ``model``, ``dtype`` and ``card`` (the
``nvidia-smi`` name and power limit). Every key of the reference's rows is
filled.

``--cpu`` runs it on the host (the tests, at ``--width`` and
``--image_size`` below the defaults); without it and without a card it exits
1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from axcnn_torch.cli.profile_step import SEED, measurement_device
from axcnn_torch.core.dtypes import policy_from_name
from axcnn_torch.models.resnet import ModelConfig, ResNet
from axcnn_torch.train.train_step import TrainState, eval_logits

WARMUP = 5
TIMED = 30
MODELS = {  # the reference script's model kwargs, beside resnet_size=50, num_classes=1000
    "assembled": dict(use_resnet_d=True, use_se_block=True, use_sk_block=True,
                      anti_alias_type="sconv"),
    "vanilla": {},
}


def model_config(name: str, width: float = 1.0) -> ModelConfig:
    return ModelConfig(resnet_size=50, num_classes=1000, width_multiplier=width, **MODELS[name])


def served_state(cfg, device):
    """The served model, random weights from ``SEED``, in eval mode on
    ``device`` (channels_last)."""
    model = ResNet(cfg, generator=torch.Generator().manual_seed(SEED))
    return TrainState(model=model.to(device, memory_format=torch.channels_last).eval(), ema=None)


def serve_fn(state, dtype: str):
    """uint8 NHWC -> fp32 logits, the port's serving forward under ``dtype``."""
    policy = policy_from_name(dtype)
    return lambda u8: eval_logits(state, u8, policy=policy)


def measure(serve, batch: int, device, image_size: int = 224, warmup: int = WARMUP,
            timed: int = TIMED) -> dict:
    u8 = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (batch, image_size, image_size, 3), dtype=np.uint8)).to(device)
    for _ in range(warmup):
        out = serve(u8)
    assert torch.isfinite(out).all()
    t0 = time.perf_counter()
    for _ in range(timed):
        serve(u8)[0, 0].item()
    sync_ms = (time.perf_counter() - t0) / timed * 1e3
    t0 = time.perf_counter()
    for _ in range(timed):
        out = serve(u8)
    out[0, 0].item()
    pipelined_ms = (time.perf_counter() - t0) / timed * 1e3
    return {"batch": batch, "sync_ms": sync_ms, "pipelined_ms": pipelined_ms,
            "pipelined_img_s": batch / pipelined_ms * 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="1,4,8,16,32,64,128")
    ap.add_argument("--dtypes", default="bf16",
                    help="comma list: bf16 and/or int8 (PTQ serving policy)")
    ap.add_argument("--models", default="assembled,vanilla", help="comma list: assembled, vanilla")
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--timed", type=int, default=TIMED)
    ap.add_argument("--width", type=float, default=1.0, help="width multiplier (tests)")
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU (tests)")
    args = ap.parse_args(argv)
    picked = measurement_device(args.cpu, "latency_bench")
    if picked is None:
        return 1
    device, card = picked
    for name in args.models.split(","):
        state = served_state(model_config(name, args.width), device)
        for dtype in args.dtypes.split(","):
            serve = serve_fn(state, dtype)
            for b in [int(x) for x in args.batches.split(",")]:
                row = measure(serve, b, device, args.image_size, args.warmup, args.timed)
                print(json.dumps({**row, "model": name, "dtype": dtype, "card": card}),
                      flush=True)
        del state
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
