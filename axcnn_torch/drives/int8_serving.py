"""int8 serving of a trained model against bf16 (port of
``scripts/int8_serving_drive.py``).

Restores the production-constants drive's kept pretrain
(``axcnn_torch.drives.convergence_full``: ``<root>/pre_ckpt``, the
10-class assembled R50 of ``drive_model_config``, its head and width as
the checkpoint records them) and its held-out set (``<root>/pre/rec``),
then measures on the card:

1. the held-out top-1 under ``BF16_POLICY`` and ``INT8_SERVING_POLICY``,
   with the raw and with the EMA weights;
2. the top-1 agreement and the largest |logit| difference between the two
   policies on the EMA weights, batch by batch at batch 64 (the last batch
   unpadded: int8's per-tensor activation scale depends on the batch);
3. served img/s of a 1000-class assembled R50 (no DropBlock) at 224x224,
   batches 32, 128 and 256, under each policy: 5 warm-up forwards, then 30
   timed, each run ending in a host read of a logit.

The reference asserts no bar; ``check`` asserts that every summary value
is there and finite.

    python -m axcnn_torch.drives.int8_serving [root]     # on the card

Options: ``--warmup_iters``, ``--iters`` (the served forwards),
``--batch`` (the eval's), ``--image_size``, ``--width`` (the served
model's), ``--cpu`` and ``--no-check``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import numpy as np
import torch

from axcnn_torch.core.dtypes import BF16_POLICY, INT8_SERVING_POLICY
from axcnn_torch.data.datasets import DatasetInfo
from axcnn_torch.drives import common
from axcnn_torch.drives.convergence_full import DEFAULT_ROOT, N_EVAL, N_TRAIN, drive_model_config
from axcnn_torch.models.resnet import ModelConfig, ResNet
from axcnn_torch.train.train_step import TrainState, eval_logits

BATCH = 64
IMAGE = 224
SERVE_BATCHES = (32, 128, 256)
WARMUP_ITERS, ITERS = 5, 30
POLICIES = (("bf16", BF16_POLICY), ("int8", INT8_SERVING_POLICY))
OK_LINE = None  # the reference prints none
# the reference's summary (scripts/int8_serving_drive.py:69, 104-105, 134)
SUMMARY_KEYS = (*(f"top1_{p}_{e}" for p, _ in POLICIES for e in ("raw", "ema")),
                "top1_agreement_pct", "max_logit_dev",
                *(f"infer_{p}_b{b}" for p, _ in POLICIES for b in SERVE_BATCHES))


def serve_model_config(width: float = 1.0) -> ModelConfig:
    return ModelConfig(resnet_size=50, num_classes=1000, use_resnet_d=True,
                       use_se_block=True, use_sk_block=True, anti_alias_type="sconv",
                       width_multiplier=width)


def check(summary: dict) -> None:
    """The reference asserts no bar: every summary value present and finite."""
    missing = common.missing_keys(summary, SUMMARY_KEYS)
    assert not missing, f"summary lacks {missing}: {summary}"
    bad = [k for k in SUMMARY_KEYS if not math.isfinite(summary[k])]
    assert not bad, f"summary values not finite: {bad}: {summary}"


def _agreement(cfg, state, data_dir, info, *, batch, image_size, device) -> tuple:
    """(top-1 agreement %, max |logit dev|) of bf16 and int8 on the EMA
    weights over the eval split, batch by batch as the loader yields them."""
    loader = common.native_loader(data_dir, info, batch=batch, image_size=image_size,
                                  train=False)
    agree = total = 0
    max_dev = 0.0
    for b in loader:
        u8 = torch.from_numpy(np.asarray(b["images"])).to(device)
        a, q = (eval_logits(state, u8, policy=policy, use_ema=True, mean_rgb=info.mean_rgb,
                            stddev_rgb=info.stddev_rgb).float().cpu()
                for _, policy in POLICIES)
        agree += int((a.argmax(-1) == q.argmax(-1)).sum())
        total += len(b["labels"])
        max_dev = max(max_dev, float((a - q).abs().max()))
    return 100.0 * agree / total, max_dev


def _served(policy, state, *, batch, image_size, device, warmup, iters) -> float:
    """img/s of ``state``'s forward at ``batch`` under ``policy``."""
    rng = np.random.default_rng(0)
    u8 = torch.from_numpy(rng.integers(0, 256, (batch, image_size, image_size, 3),
                                       dtype=np.uint8)).to(device)
    for _ in range(warmup):
        out = eval_logits(state, u8, policy=policy)
    float(out[0, 0])
    t0 = time.perf_counter()
    for _ in range(iters):
        out = eval_logits(state, u8, policy=policy)
    float(out[0, 0])
    return batch / ((time.perf_counter() - t0) / iters)


def run(root: str = DEFAULT_ROOT, *, batch: int = BATCH, image_size: int = IMAGE,
        width: float = 1.0, warmup_iters: int = WARMUP_ITERS, iters: int = ITERS, device=None,
        check_bars: bool = True, log=print) -> dict:
    device = common.resolve_device(device)
    pre_dir = os.path.join(root, "pre", "rec")
    restored = common.restore_state(os.path.join(root, "pre_ckpt"), device=device)
    if restored is None:
        raise SystemExit(f"no cached drive state under {root} — run "
                         "python -m axcnn_torch.drives.convergence_full first")
    cfg, state = restored
    want = dataclasses.replace(drive_model_config(cfg.width_multiplier),
                               num_classes=cfg.num_classes)
    if cfg != want:
        raise ValueError(f"{root}/pre_ckpt holds another model than the drive's: {cfg}")
    info = DatasetInfo("drive", num_classes=cfg.num_classes,
                       num_train=N_TRAIN * cfg.num_classes, num_eval=N_EVAL * cfg.num_classes,
                       train_prefix="train", eval_prefix="validation")
    log(f"restored drive state at step {state.step}")
    size = dict(batch=batch, image_size=image_size, device=device)

    results = {}
    # 1. accuracy under each policy
    for pname, policy in POLICIES:
        for ename, use_ema in (("raw", False), ("ema", True)):
            m = common.evaluate_split(cfg, state, pre_dir, info, use_ema=use_ema,
                                      policy=policy, **size)
            results[f"top1_{pname}_{ename}"] = m["top1"]
            log(f"eval[{pname}/{ename}]: top1={m['top1']:.2f}% loss={m['loss']:.4f} "
                f"n={m['count']:.0f}")

    # 2. top-1 agreement between the two policies (EMA weights)
    agree, max_dev = _agreement(cfg, state, pre_dir, info, **size)
    results.update(top1_agreement_pct=agree, max_logit_dev=max_dev)
    log(f"top-1 agreement bf16 vs int8: {agree:.2f}%; max |logit dev| {max_dev:.3f}")
    del state

    # 3. serving throughput, 1000-class assembled R50
    serve = TrainState(model=ResNet(serve_model_config(width),
                                    generator=torch.Generator().manual_seed(0)).to(
        device, memory_format=torch.channels_last).eval(), ema=None)
    for pname, policy in POLICIES:
        for b in SERVE_BATCHES:
            key = f"infer_{pname}_b{b}"
            results[key] = _served(policy, serve, batch=b, image_size=image_size,
                                   device=device, warmup=warmup_iters, iters=iters)
            log(f"{key}: {results[key]:.1f} img/s ({b / results[key] * 1e3:.2f} ms)")
    results.update(serve_iters=[warmup_iters, iters])
    log(json.dumps(results))
    if check_bars:
        check(results)
    return results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("root", nargs="?", default=DEFAULT_ROOT)
    common.add_size_args(p, steps=None, batch=BATCH, image_size=IMAGE)
    p.add_argument("--warmup_iters", type=int, default=WARMUP_ITERS)
    p.add_argument("--iters", type=int, default=ITERS)
    a = p.parse_args(argv)
    return run(a.root, batch=a.batch, image_size=a.image_size, width=a.width,
               warmup_iters=a.warmup_iters, iters=a.iters, device="cpu" if a.cpu else None,
               check_bars=a.check)


if __name__ == "__main__":
    main()
