"""Long-horizon convergence drive with the production constants (port of
``scripts/convergence_drive_full.py``).

- Pretrain: config 4 with ``bn_momentum=0.997`` (``drive_model_config``)
  and ``ema_decay=0.9999`` with its ramp, on 10 classes (5 hues x
  horizontal/vertical stripes: colour and orientation both needed), 2,400
  train and 600 held-out images, 1,500 steps, batch 64, 224x224, bf16, base
  LR 0.05, the native loader with AutoAugment v0, mixup, label smoothing,
  the DropBlock schedule. Held-out eval with the raw and the EMA weights.
  The state is kept as a port checkpoint under ``<root>/pre_ckpt``; a rerun
  (and ``axcnn_torch.drives.ablation``) restores it.
- Fine-tune: 4 unseen hue x orientation classes, 120 steps each at LR 0.01:
  warm (the pretrained EMA body and BN statistics, a fresh head, seed 3)
  against cold (from scratch, seed 4).

Bars (``check``): pretrain raw top-1 >= 90, EMA >= raw - 1, warm >= 85,
warm >= cold + 5.

    python -m axcnn_torch.drives.convergence_full [root]     # on the card

Options as ``axcnn_torch.drives.convergence``'s, plus ``--ft_steps``,
``--num_hues`` and the image counts a class; a restored pretrain must have
the steps asked for.
"""

from __future__ import annotations

import argparse
import json
import dataclasses
import os
import tempfile

import torch

from axcnn_torch.ckpt.checkpoint import load_weights
from axcnn_torch.drives import common
from axcnn_torch.drives.data import STRIPE_HUES, make_set
from axcnn_torch.models.resnet import ModelConfig
from axcnn_torch.train.ema import ema_init
from axcnn_torch.train.schedules import make_lr_schedule
from axcnn_torch.train.train_step import create_train_state, make_train_step

BATCH = 64
IMAGE = 224
STEPS = 1500
FT_STEPS = 120
N_TRAIN, N_EVAL = 240, 60
FT_N_TRAIN, FT_N_EVAL = 150, 50
# unseen hues; h/v orientations survive random flips, diagonals would not
FT_CLASSES = [("cyan_h", (0, 1, 1), "h"), ("cyan_v", (0, 1, 1), "v"),
              ("white_h", (1, 1, 1), "h"), ("white_v", (1, 1, 1), "v")]
DEFAULT_ROOT = os.path.join(tempfile.gettempdir(), "axcnn_torch_convergence_full")
OK_LINE = "CONVERGENCE DRIVE (production constants) OK"
# the reference's summary (scripts/convergence_drive_full.py:246-247)
SUMMARY_KEYS = tuple(f"{leg}/{m}" for leg in ("pretrain_raw", "pretrain_ema", "ft_warm", "ft_cold")
                     for m in ("top1", "loss"))


def drive_model_config(width: float = 1.0) -> ModelConfig:
    """The one pretrain config of every drive that restores
    ``<root>/pre_ckpt`` (``axcnn_torch.drives.ablation`` imports it)."""
    return ModelConfig(resnet_size=50, num_classes=10, use_resnet_d=True,
                       use_se_block=True, use_sk_block=True, anti_alias_type="sconv",
                       use_dropblock=True, dropblock_keep_prob=0.9, zero_gamma=True,
                       bn_momentum=0.997, width_multiplier=width)  # production constant


def pretrain_classes(num_hues: int = len(STRIPE_HUES)) -> list:
    return [(f"{h}_{o}", STRIPE_HUES[h], o) for h in list(STRIPE_HUES)[:num_hues]
            for o in ("h", "v")]


def check(summary: dict) -> None:
    """The reference's bars; ``AssertionError`` with the summary on a miss."""
    raw1, ema1 = summary["pretrain_raw"]["top1"], summary["pretrain_ema"]["top1"]
    warm1, cold1 = summary["ft_warm"]["top1"], summary["ft_cold"]["top1"]
    assert raw1 >= 90.0, f"pretrain raw top-1 {raw1} < 90: {summary}"
    assert ema1 >= raw1 - 1.0, f"EMA lags raw with production decay: {ema1} vs {raw1}: {summary}"
    assert warm1 >= 85.0, f"warm fine-tune top-1 {warm1} < 85: {summary}"
    assert warm1 >= cold1 + 5.0, (
        f"warm-start benefit not demonstrated: warm {warm1} vs cold {cold1}: {summary}")


def train(cfg, data_dir, info, steps, *, base_lr, seed, device, batch=BATCH, image_size=IMAGE,
          init_state=None, label="", log=print):
    """The reference's ``_train``: the production recipe from ``init_state``
    (else a fresh state from ``seed``) with step stream ``seed + 1``.
    Returns (state, the step loop's record)."""
    loader = common.native_loader(data_dir, info, batch=batch, image_size=image_size,
                                  train=True, autoaugment_type="v0", seed=seed)
    step_fn = make_train_step(
        cfg, lr_schedule=make_lr_schedule(base_lr=base_lr, total_steps=steps,
                                          warmup_steps=max(steps // 15, 10)),
        total_steps=steps, policy=common.POLICY, label_smoothing=0.1, mixup_alpha=0.2,
        weight_decay=1e-4, use_ema=True, ema_decay=0.9999,
        mean_rgb=info.mean_rgb, stddev_rgb=info.stddev_rgb)
    state = init_state if init_state is not None else create_train_state(
        cfg, generator=torch.Generator().manual_seed(seed), device=device, use_ema=True)
    return common.run_steps(step_fn, state, loader, steps, root_seed=seed + 1, device=device,
                            label=label, log_every=250, log=log)


def run(root: str = DEFAULT_ROOT, *, steps: int = STEPS, ft_steps: int = FT_STEPS,
        batch: int = BATCH, image_size: int = IMAGE, width: float = 1.0,
        num_hues: int = len(STRIPE_HUES), n_train: int = N_TRAIN, n_eval: int = N_EVAL,
        ft_n_train: int = FT_N_TRAIN, ft_n_eval: int = FT_N_EVAL, device=None,
        check_bars: bool = True, log=print) -> dict:
    device = common.resolve_device(device)
    os.makedirs(root, exist_ok=True)
    size = dict(batch=batch, image_size=image_size)
    pre_dir, pre_info = make_set(os.path.join(root, "pre"), pretrain_classes(num_hues),
                                 n_train=n_train, n_eval=n_eval, seed=0)
    cfg = dataclasses.replace(drive_model_config(width), num_classes=2 * num_hues)
    state, pre_record = common.cached_train(
        os.path.join(root, "pre_ckpt"), cfg, steps, use_ema=True, device=device,
        label="pretrain", log=log, train_fn=lambda: train(
            cfg, pre_dir, pre_info, steps, base_lr=0.05, seed=0, device=device,
            label="pretrain", log=log, **size))
    summary = {}
    for name, use_ema in (("raw", False), ("ema", True)):
        m = common.evaluate_split(cfg, state, pre_dir, pre_info, use_ema=use_ema,
                                  device=device, **size)
        summary[f"pretrain_{name}"] = m
        log(f"pretrain eval[{name}] (held-out): top1={m['top1']:.2f}% "
            f"loss={m['loss']:.4f} count={m['count']:.0f}")

    ft_dir, ft_info = make_set(os.path.join(root, "ft"), FT_CLASSES,
                               n_train=ft_n_train, n_eval=ft_n_eval, seed=1)
    ft_cfg = dataclasses.replace(cfg, num_classes=len(FT_CLASSES))
    # warm leg: the pretrained EMA body and BN statistics, a fresh head
    warm0 = create_train_state(ft_cfg, generator=torch.Generator().manual_seed(9),
                               device=device, use_ema=True)
    src = state.ema if state.ema is not None else dict(state.model.named_parameters())
    load_weights(warm0.model, src, dict(state.model.named_buffers()),
                 "the pretrained state", skip=("head.",))
    warm0.ema = ema_init(dict(warm0.model.named_parameters()))
    del state
    records = {"pretrain": pre_record}
    warm, records["warm"] = train(ft_cfg, ft_dir, ft_info, ft_steps, base_lr=0.01, seed=3,
                                  device=device, init_state=warm0, label="warm", log=log, **size)
    summary["ft_warm"] = common.evaluate_split(ft_cfg, warm, ft_dir, ft_info, use_ema=False,
                                               device=device, **size)
    del warm, warm0
    # cold control: the same budget from scratch
    cold, records["cold"] = train(ft_cfg, ft_dir, ft_info, ft_steps, base_lr=0.01, seed=4,
                                  device=device, label="cold", log=log, **size)
    summary["ft_cold"] = common.evaluate_split(ft_cfg, cold, ft_dir, ft_info, use_ema=False,
                                               device=device, **size)
    summary.update(train=records, native_loader=True)
    log(json.dumps(summary))
    if check_bars:
        check(summary)
        log(OK_LINE)
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("root", nargs="?", default=DEFAULT_ROOT)
    common.add_size_args(p, steps=STEPS, batch=BATCH, image_size=IMAGE)
    p.add_argument("--ft_steps", type=int, default=FT_STEPS)
    p.add_argument("--num_hues", type=int, default=len(STRIPE_HUES),
                   help="pretrain classes: 2 orientations of each of the first hues")
    p.add_argument("--n_train", type=int, default=N_TRAIN)
    p.add_argument("--n_eval", type=int, default=N_EVAL)
    p.add_argument("--ft_n_train", type=int, default=FT_N_TRAIN)
    p.add_argument("--ft_n_eval", type=int, default=FT_N_EVAL)
    a = p.parse_args(argv)
    return run(a.root, steps=a.steps, ft_steps=a.ft_steps, batch=a.batch,
               image_size=a.image_size, width=a.width, num_hues=a.num_hues,
               n_train=a.n_train, n_eval=a.n_eval, ft_n_train=a.ft_n_train,
               ft_n_eval=a.ft_n_eval, device="cpu" if a.cpu else None, check_bars=a.check)


if __name__ == "__main__":
    main()
