"""ImageNet-C robustness evaluation, mCE (port of ``axcnn/eval/imagenet_c.py``).

Protocol (Hendrycks & Dietterich 2019, as the reference uses it): for each of
the 15 corruptions and each severity 1-5 found on disk, the top-1 error on
the corrupted validation set; a corruption's CE is its mean error over the
severities divided by AlexNet's published error; mCE is the mean CE.

Layout: ``<data_dir>/<corruption>/<severity>/validation-*`` TFRecord shards
(ImageNet's Example schema), as ``axcnn_torch.data.build_imagenet_c`` writes
them. The images are evaluated as STORED: the loader runs with
``resize_min == image_size``, which passes an image already at that size
through untouched, where the clean eval's resize-then-crop would resample
the corrupted pixels and shift mCE.

The run restores ``<model_dir>/checkpoints`` when it exists, else warm-
starts from ``train.pretrained_checkpoint``, else serves the seeded init;
it evaluates with the port's eval step (the EMA weights under
``train.use_ema``), on the card unless ``runtime.platform=cpu``, and logs
one ``imagenet_c`` line per (corruption, severity) and one ``mce`` line to
``<model_dir>/metrics.jsonl``. In a process group of several ranks (the
CLI starts one a card) each rank reads its shard of every set and the eval
sums over the ranks; rank 0 logs. Spatial partitioning is refused, as in
the reference. The head takes the dataset's 1,001 classes, as the training
loop's does (the reference's evaluator keeps ``model.num_classes`` as given,
so a 1,001-way checkpoint does not restore there under a 1,000-way preset).
"""

from __future__ import annotations

import dataclasses
import os

import torch

CORRUPTIONS = (
    "gaussian_noise", "shot_noise", "impulse_noise",
    "defocus_blur", "glass_blur", "motion_blur", "zoom_blur",
    "snow", "frost", "fog", "brightness",
    "contrast", "elastic_transform", "pixelate", "jpeg_compression",
)

# AlexNet top-1 error rates used as mCE normalizers (published constants).
ALEXNET_ERR = {
    "gaussian_noise": 0.886428, "shot_noise": 0.894468,
    "impulse_noise": 0.922640, "defocus_blur": 0.819880,
    "glass_blur": 0.826268, "motion_blur": 0.785948, "zoom_blur": 0.798360,
    "snow": 0.866816, "frost": 0.826572, "fog": 0.819324,
    "brightness": 0.564592, "contrast": 0.853204,
    "elastic_transform": 0.646056, "pixelate": 0.717840,
    "jpeg_compression": 0.606500,
}


def compute_mce(per_corruption_err: dict, *, alexnet_err=None) -> dict:
    """per_corruption_err: {corruption: mean top-1 error in [0,1] over
    severities}. Returns {'mce': %, 'ce/<corruption>': %}."""
    alexnet_err = alexnet_err or ALEXNET_ERR
    ces = {}
    for c, err in per_corruption_err.items():
        ces[f"ce/{c}"] = err / alexnet_err[c] * 100.0
    mce = sum(ces.values()) / len(ces) if ces else 0.0
    return {"mce": mce, **ces}


def run_imagenet_c(cfg, *, local_rank: int = 0) -> dict:
    """The mCE evaluation a Config asks for (``runtime.eval_imagenet_c``);
    returns ``compute_mce``'s dict. In a process group, one rank of it on
    card ``local_rank``."""
    from axcnn_torch.ckpt.checkpoint import CheckpointManager
    from axcnn_torch.core.dtypes import policy_from_name, set_fp32_precision
    from axcnn_torch.data.datasets import get_dataset
    from axcnn_torch.data.pipeline import TFRecordImageLoader
    from axcnn_torch.parallel import mesh
    from axcnn_torch.train.loop import _warm_start, evaluate, resolve_device
    from axcnn_torch.train.train_step import create_train_state, make_eval_step
    from axcnn_torch.utils.logging import MetricLogger

    if cfg.runtime.spatial_partitions > 1:
        raise ValueError(
            "mCE evaluation does not support spatial partitioning (224^2 "
            "stored pixels never motivate it); run with "
            "--runtime.spatial_partitions=1")
    device = resolve_device(cfg.runtime.platform, local_rank)
    group, rank, world = mesh.data_group(), mesh.rank(), mesh.world_size()
    if cfg.train.batch_size % world:
        raise ValueError(f"global batch {cfg.train.batch_size} not divisible by "
                         f"{world} data-parallel ranks")
    local_batch = cfg.train.batch_size // world
    info = get_dataset("imagenet_c")
    model_cfg = dataclasses.replace(cfg.model, num_classes=info.num_classes)
    policy = policy_from_name(cfg.train.dtype)
    set_fp32_precision(policy)
    lead = rank == 0
    logger = MetricLogger(cfg.runtime.model_dir if lead else None, quiet=not lead)

    state = create_train_state(model_cfg, generator=torch.Generator().manual_seed(cfg.train.seed),
                               device=device, use_ema=cfg.train.use_ema)
    ckpt_dir = os.path.join(cfg.runtime.model_dir, "checkpoints")
    if os.path.isdir(ckpt_dir):
        mgr = CheckpointManager(ckpt_dir)
        restored = mgr.restore(state)
        if restored is not None:
            state = restored[0]
        mgr.close()
    elif cfg.train.pretrained_checkpoint:
        state = _warm_start(state, dataclasses.replace(cfg, model=model_cfg))
    eval_step = make_eval_step(model_cfg, policy=policy, use_ema=cfg.train.use_ema,
                               group=group, mean_rgb=info.mean_rgb, stddev_rgb=info.stddev_rgb)

    per_corruption = {}
    for corruption in CORRUPTIONS:
        errs = []
        for severity in range(1, 6):
            d = os.path.join(cfg.data.data_dir, corruption, str(severity))
            if not os.path.isdir(d):
                continue
            loader = TFRecordImageLoader(
                d, info, batch_size=local_batch, train=False,
                image_size=cfg.data.image_size,
                resize_min=cfg.data.image_size,  # evaluate the stored pixels
                drop_remainder=False, num_workers=cfg.data.num_workers,
                host_id=rank, num_hosts=world)
            m = evaluate(eval_step, state, loader, batch_size=local_batch, device=device,
                         prefetch=cfg.data.prefetch, group=group)
            errs.append(1.0 - m["top1"] / 100.0)
            logger.log("imagenet_c", state.step, corruption=corruption, severity=severity,
                       top1=m["top1"], count=m["count"])
        if errs:
            per_corruption[corruption] = sum(errs) / len(errs)

    result = compute_mce(per_corruption)
    logger.log("mce", state.step, **result)
    logger.close()
    return result
