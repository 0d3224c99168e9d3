"""The training run loop on one device (port of ``axcnn/train/loop.py``).

The reference's step accounting, LR schedule (linear batch scaling, warmup
in epochs), log cadence and eval cadence: the EMA-swapped eval runs every
``epochs_between_evals`` epochs and at the last step, and ``stop_threshold``
stops early. The host side is the reference's own jax-free code: the
loaders of ``axcnn.data.pipeline`` and ``axcnn.utils.logging``'s
``MetricLogger`` (``<model_dir>/metrics.jsonl``) and ``Throughput``. Each
batch is copied to the device from pinned memory, ``non_blocking``.

Refused with ``NotImplementedError`` until ported (ROADMAP.md): checkpoint
save and restore, eval-only, warm start, KD, gradient accumulation, more than
one device, spatial partitioning, device AutoAugment, data echo, export, the
hang watchdog and profiling. A run writes no checkpoint, and says so once on
stderr.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from axcnn.data.datasets import DatasetInfo, get_dataset
from axcnn.data.pipeline import MultiProducerLoader, SyntheticLoader, TFRecordImageLoader
from axcnn.utils.logging import MetricLogger, Throughput
from axcnn_torch.core.dtypes import policy_from_name, set_fp32_precision
from axcnn_torch.train.schedules import make_lr_schedule, scale_lr_for_batch
from axcnn_torch.train.train_step import (
    create_train_state, make_eval_step, make_train_step, pad_batch)
from axcnn_torch.utils.config import Config, resolve_preprocessing

# (what, is it asked for) -- each refused until ported
UNPORTED = (
    ("checkpoint saves (runtime.save_checkpoint_steps)",
     lambda c: c.runtime.save_checkpoint_steps > 0),
    ("runtime.eval_only", lambda c: c.runtime.eval_only),
    ("warm start (train.pretrained_checkpoint)",
     lambda c: bool(c.train.pretrained_checkpoint)),
    ("knowledge distillation (train.kd_teacher_checkpoint)",
     lambda c: bool(c.train.kd_teacher_checkpoint)),
    ("train.grad_accum_steps > 1", lambda c: c.train.grad_accum_steps > 1),
    ("runtime.num_devices > 1", lambda c: c.runtime.num_devices > 1),
    ("runtime.spatial_partitions > 1", lambda c: c.runtime.spatial_partitions > 1),
    ("runtime.dcn_slices > 1", lambda c: c.runtime.dcn_slices > 1),
    ("data.autoaugment_device", lambda c: c.data.autoaugment_device),
    ("data.echo_factor > 1", lambda c: c.data.echo_factor > 1),
    ("runtime.export_dir", lambda c: bool(c.runtime.export_dir)),
    ("runtime.hang_watchdog_s > 0", lambda c: c.runtime.hang_watchdog_s > 0),
    ("runtime.profile_steps", lambda c: c.runtime.profile_steps > 0),
    ("runtime.eval_imagenet_c", lambda c: c.runtime.eval_imagenet_c),
)


def check_ported(cfg: Config) -> None:
    asked = [what for what, on in UNPORTED if on(cfg)]
    if asked:
        raise NotImplementedError(
            f"not ported to axcnn_torch yet: {', '.join(asked)} (ROADMAP.md "
            "Queue A items 7-10)")


def resolve_device(platform: str) -> torch.device:
    """``""`` or ``gpu`` -> the CUDA device, and exit with a message when
    there is none; ``cpu`` -> the host. Nothing falls back to the CPU."""
    if platform in ("", "gpu", "cuda"):
        if not torch.cuda.is_available():
            raise SystemExit("error: no CUDA device; pass --runtime.platform=cpu "
                             "to run on the host CPU")
        return torch.device("cuda")
    if platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"runtime.platform must be '', 'gpu' or 'cpu', got {platform!r}")


def _dataset_info(cfg: Config) -> DatasetInfo:
    if cfg.data.dataset_name == "custom":
        d = cfg.data
        if min(d.num_classes, d.num_train_examples, d.num_eval_examples) <= 0:
            raise ValueError(
                "dataset_name='custom' needs --data.num_classes, "
                "--data.num_train_examples and --data.num_eval_examples "
                f"(got {d.num_classes}/{d.num_train_examples}/"
                f"{d.num_eval_examples})")
        return DatasetInfo("custom", d.num_classes, d.num_train_examples,
                           d.num_eval_examples, label_offset=d.label_offset)
    return get_dataset(cfg.data.dataset_name)


def _make_loaders(cfg: Config, info: DatasetInfo):
    bs = cfg.train.batch_size
    if cfg.data.use_synthetic_data:
        kw = dict(batch_size=bs, image_size=cfg.data.image_size,
                  num_classes=cfg.model.num_classes)
        return (SyntheticLoader(seed=cfg.train.seed, **kw),
                SyntheticLoader(seed=cfg.train.seed + 1, num_batches=4, **kw))
    common = dict(image_size=cfg.data.image_size, resize_min=cfg.data.resize_min,
                  dct_method=cfg.data.dct_method, num_workers=cfg.data.num_workers,
                  use_native=cfg.data.loader == "cpp")
    train_kw = dict(batch_size=bs, train=True, seed=cfg.train.seed,
                    autoaugment_type=cfg.data.autoaugment_type,
                    shuffle_buffer=cfg.data.shuffle_buffer, **common)
    if cfg.data.num_producers > 1:
        train_loader = MultiProducerLoader(
            cfg.data.data_dir, info, num_producers=cfg.data.num_producers,
            **train_kw)
    else:
        train_loader = TFRecordImageLoader(cfg.data.data_dir, info, **train_kw)
    eval_loader = TFRecordImageLoader(cfg.data.data_dir, info, batch_size=bs,
                                      train=False, drop_remainder=False, **common)
    return train_loader, eval_loader


def to_device(batch, device: torch.device, batch_size: int | None = None):
    """Host numpy batch -> torch tensors on ``device`` (padded to
    ``batch_size`` first when given), copied from pinned memory."""
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    if batch_size is not None:
        out = pad_batch(out, batch_size)
    if device.type == "cuda":
        out = {k: v.pin_memory().to(device, non_blocking=True) for k, v in out.items()}
    return out


def evaluate(eval_step, state, eval_loader, *, batch_size: int, device):
    """Full eval pass: {'top1': %, 'top5': %, 'loss': mean, 'count': N}."""
    totals = {}
    for batch in eval_loader:
        m = eval_step(state, to_device(batch, device, batch_size))
        for k, v in m.items():
            totals[k] = totals.get(k, 0.0) + float(v)
    count = max(totals.get("count", 0.0), 1.0)
    return {"top1": totals.get("top1", 0.0) / count * 100.0,
            "top5": totals.get("top5", 0.0) / count * 100.0,
            "loss": totals.get("loss_sum", 0.0) / count,
            "count": count}


def run(cfg: Config):
    """Train (and periodically evaluate) per the config on one device;
    returns the last eval's metrics."""
    check_ported(cfg)
    device = resolve_device(cfg.runtime.platform)
    info = _dataset_info(cfg)
    model = cfg.model
    if model.num_classes != info.num_classes:
        # dataset wins (the reference derives num_classes from data_config)
        model = dataclasses.replace(model, num_classes=info.num_classes)
    cfg = Config(model=model, data=resolve_preprocessing(cfg.data),
                 train=cfg.train, runtime=cfg.runtime)
    policy = policy_from_name(cfg.train.dtype)
    set_fp32_precision(policy)
    print("axcnn_torch: checkpoints are not ported yet (ROADMAP.md Queue A "
          "item 7); this run writes none and restores none", file=sys.stderr)
    logger = MetricLogger(cfg.runtime.model_dir, tensorboard=cfg.runtime.tensorboard)

    if cfg.train.train_steps > 0:
        total_steps = cfg.train.train_steps
        steps_per_epoch = total_steps
    else:
        steps_per_epoch = max(info.num_train // cfg.train.batch_size, 1)
        total_steps = steps_per_epoch * cfg.train.train_epochs
    lr_schedule = make_lr_schedule(
        base_lr=scale_lr_for_batch(cfg.train.base_lr, cfg.train.batch_size),
        total_steps=total_steps,
        warmup_steps=int(cfg.train.lr_warmup_epochs * steps_per_epoch),
        decay_type=cfg.train.lr_decay_type)
    norm = dict(mean_rgb=info.mean_rgb, stddev_rgb=info.stddev_rgb)
    train_step = make_train_step(
        cfg.model, lr_schedule=lr_schedule, total_steps=total_steps, policy=policy,
        label_smoothing=cfg.train.label_smoothing, mixup_alpha=cfg.data.mixup_alpha,
        mixup_symmetric=cfg.data.mixup_symmetric,
        weight_decay=cfg.train.weight_decay, momentum=cfg.train.momentum,
        use_ema=cfg.train.use_ema, ema_decay=cfg.train.ema_decay, **norm)
    eval_step = make_eval_step(cfg.model, policy=policy, use_ema=cfg.train.use_ema,
                               **norm)
    state = create_train_state(cfg.model,
                               generator=torch.Generator().manual_seed(cfg.train.seed),
                               device=device, use_ema=cfg.train.use_ema)
    train_loader, eval_loader = _make_loaders(cfg, info)

    root_seed = cfg.train.seed + 1
    throughput = Throughput(cfg.train.batch_size)
    eval_metrics = {}
    train_iter = iter(train_loader)
    step = state.step
    while step < total_steps:
        batch = to_device(next(train_iter), device)
        state, metrics = train_step(state, batch, root_seed)
        step += 1
        ips = throughput.tick()
        if step % cfg.train.log_every == 0 or step == total_steps:
            logger.log("train", step, epoch=step / steps_per_epoch,
                       images_per_sec=ips or 0.0,
                       **{k: float(v) for k, v in metrics.items()})
        if (step % (steps_per_epoch * cfg.train.epochs_between_evals) == 0
                or step == total_steps):
            eval_metrics = evaluate(eval_step, state, eval_loader,
                                    batch_size=cfg.train.batch_size, device=device)
            logger.log("eval", step, **eval_metrics)
            if cfg.train.stop_threshold and eval_metrics["top1"] >= cfg.train.stop_threshold:
                logger.log("early_stop", step, top1=eval_metrics["top1"])
                break
    logger.close()
    return eval_metrics
