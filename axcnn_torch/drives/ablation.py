"""Assembled-vs-vanilla ablation drive (port of ``scripts/ablation_drive.py``).

Both recipes on the 10-class set of ``axcnn_torch.drives.convergence_full``
with the same budget (1,500 steps, batch 64, 224x224, bf16):

- assembled: the full config-4 stack, restored from that drive's
  ``<root>/pre_ckpt`` (trained here, and kept there, when absent);
- vanilla: the plain ResNet-50, flip and crop only, no label smoothing,
  mixup, EMA, DropBlock or zero-gamma (kept under ``<root>/vanilla_ckpt``).

Each is evaluated on the held-out split and on an ImageNet-C copy of it
(``axcnn_torch.data.build_imagenet_c``: all 15 corruptions at severities 2
and 4, evaluated on the stored pixels), built once under
``<root>/imagenet_c`` while the vanilla leg trains. Relative mCE normalises
by the vanilla model's errors, each clamped at one wrong answer, so vanilla
is 100 by construction. Bars (``check``): assembled clean top-1 >= vanilla
- 1, assembled mean corruption error < vanilla's, relative mCE < 100.

    python -m axcnn_torch.drives.ablation [root]     # on the card

Options as ``axcnn_torch.drives.convergence_full``'s, plus
``--corruptions`` and ``--severities``.
"""

from __future__ import annotations

import argparse
import json
import concurrent.futures
import dataclasses
import os
import time

import torch

from axcnn_torch.data.build_imagenet_c import build_corrupted_set
from axcnn_torch.drives import common
from axcnn_torch.drives.convergence_full import (BATCH, DEFAULT_ROOT, IMAGE, N_EVAL, N_TRAIN,
                                                 STEPS, drive_model_config, pretrain_classes)
from axcnn_torch.drives.data import STRIPE_HUES, make_set
from axcnn_torch.eval.imagenet_c import CORRUPTIONS, compute_mce
from axcnn_torch.models.resnet import ModelConfig
from axcnn_torch.train.schedules import make_lr_schedule
from axcnn_torch.train.train_step import create_train_state, make_train_step

SEVERITIES = (2, 4)
C_WORKERS = 2  # processes building the corrupted set: one a held-out shard
OK_LINE = "ABLATION DRIVE OK: assembled beats vanilla on robustness"
# the reference's summary (scripts/ablation_drive.py:201-208)
SUMMARY_KEYS = ("clean_top1_assembled_ema", "clean_top1_vanilla", "mean_corruption_err_assembled",
                "mean_corruption_err_vanilla", "relative_mce_assembled_vs_vanilla",
                "per_corruption_ce")


def vanilla_model_config(num_classes: int = 10, width: float = 1.0) -> ModelConfig:
    """The reference's baseline row: a plain ResNet-50, everything else off."""
    cfg = ModelConfig(resnet_size=50, num_classes=num_classes, bn_momentum=0.997,
                      width_multiplier=width)
    assert not (cfg.use_resnet_d or cfg.use_se_block or cfg.use_sk_block
                or cfg.use_dropblock or cfg.zero_gamma)
    assert cfg.anti_alias_type in (None, "none")
    return cfg


def train_leg(cfg, data_dir, info, steps, *, assembled: bool, seed: int, device,
              batch=BATCH, image_size=IMAGE, label="", log=print):
    """One recipe from scratch; returns (state, the step loop's record)."""
    loader = common.native_loader(data_dir, info, batch=batch, image_size=image_size,
                                  train=True, autoaugment_type="v0" if assembled else "none",
                                  seed=seed)
    step_fn = make_train_step(
        cfg, lr_schedule=make_lr_schedule(base_lr=0.05, total_steps=steps,
                                          warmup_steps=steps // 15),
        total_steps=steps, policy=common.POLICY,
        label_smoothing=0.1 if assembled else 0.0, mixup_alpha=0.2 if assembled else 0.0,
        weight_decay=1e-4, use_ema=assembled, ema_decay=0.9999,
        mean_rgb=info.mean_rgb, stddev_rgb=info.stddev_rgb)
    state = create_train_state(cfg, generator=torch.Generator().manual_seed(seed),
                               device=device, use_ema=assembled)
    return common.run_steps(step_fn, state, loader, steps, root_seed=seed + 1, device=device,
                            label=label, log_every=300, log=log)


def summarize(clean_asm: dict, clean_van: dict, asm_err: dict, van_err: dict,
              n_eval: int) -> dict:
    """The reference's summary. Relative mCE takes the vanilla model as the
    normaliser (AlexNet's role in the published protocol), each error
    clamped at one wrong answer so that a perfect vanilla row cannot blow
    it up."""
    norm = {c: max(e, 1.0 / n_eval) for c, e in van_err.items()}
    rel = compute_mce(asm_err, alexnet_err=norm)
    return {
        "clean_top1_assembled_ema": clean_asm["top1"],
        "clean_top1_vanilla": clean_van["top1"],
        "mean_corruption_err_assembled": sum(asm_err.values()) / len(asm_err),
        "mean_corruption_err_vanilla": sum(van_err.values()) / len(van_err),
        "relative_mce_assembled_vs_vanilla": rel["mce"],
        "per_corruption_ce": {c: rel[f"ce/{c}"] for c in asm_err},
    }


def check(summary: dict) -> None:
    """The reference's bars; ``AssertionError`` with the summary on a miss."""
    asm, van = summary["clean_top1_assembled_ema"], summary["clean_top1_vanilla"]
    mean_asm = summary["mean_corruption_err_assembled"]
    mean_van = summary["mean_corruption_err_vanilla"]
    rel = summary["relative_mce_assembled_vs_vanilla"]
    assert asm >= van - 1.0, (
        f"assembled clean top-1 {asm} materially below vanilla {van}: {summary}")
    assert mean_asm < mean_van, (
        f"assembled NOT more robust: mean err {mean_asm:.4f} vs vanilla {mean_van:.4f}: "
        f"{summary}")
    assert rel < 100.0, f"relative mCE {rel:.1f} >= 100: {summary}"


def corruption_errors(cfg, state, c_root, info, *, use_ema, corruptions, severities, device,
                      batch, image_size, label, log=print) -> dict:
    """{corruption: mean top-1 error over ``severities``}, on stored pixels."""
    per = {}
    for name in corruptions:
        errs = []
        for sev in severities:
            m = common.evaluate_split(cfg, state, os.path.join(c_root, name, str(sev)), info,
                                      use_ema=use_ema, batch=batch, image_size=image_size,
                                      resize_min=image_size, device=device)
            errs.append(1.0 - m["top1"] / 100.0)
        per[name] = sum(errs) / len(errs)
        log(f"[{label}] {name}: err@{tuple(severities)}={[round(e, 3) for e in errs]}")
    return per


def run(root: str = DEFAULT_ROOT, *, steps: int = STEPS, batch: int = BATCH,
        image_size: int = IMAGE, width: float = 1.0, num_hues: int = len(STRIPE_HUES),
        n_train: int = N_TRAIN, n_eval: int = N_EVAL, corruptions=CORRUPTIONS,
        severities=SEVERITIES, device=None, check_bars: bool = True, log=print) -> dict:
    """Both legs, the corrupted set, the evals; returns the summary (the
    reference's keys, and ``train``: each trained leg's record, None when
    restored; ``imagenet_c_seconds``: the corrupted set's build)."""
    device = common.resolve_device(device)
    os.makedirs(root, exist_ok=True)
    size = dict(batch=batch, image_size=image_size)
    corruptions, severities = list(corruptions), list(severities)
    data_dir, info = make_set(os.path.join(root, "pre"), pretrain_classes(num_hues),
                              n_train=n_train, n_eval=n_eval, seed=0)

    # the corrupted copy of the held-out split, built (once) beside the legs
    c_root = os.path.join(root, "imagenet_c")
    marker = os.path.join(c_root, "ok-" + "-".join(map(str, severities)) + (
        "" if corruptions == list(CORRUPTIONS) else "-" + "-".join(corruptions)))
    build = None
    if not os.path.exists(marker):
        def build_c():
            t0 = time.time()
            n = build_corrupted_set(data_dir, c_root, prefix="validation",
                                    image_size=image_size,
                                    resize_min=common.resize_min_for(image_size),
                                    corruptions=corruptions, severities=severities,
                                    num_workers=C_WORKERS, progress=lambda _: None)
            open(marker, "w").close()
            return n, time.time() - t0

        pool = concurrent.futures.ThreadPoolExecutor(1)
        build = pool.submit(build_c)
        pool.shutdown(wait=False)

    asm_cfg = dataclasses.replace(drive_model_config(width), num_classes=2 * num_hues)
    asm_state, asm_record = common.cached_train(
        os.path.join(root, "pre_ckpt"), asm_cfg, steps, use_ema=True, device=device,
        label="assembled", log=log, train_fn=lambda: train_leg(
            asm_cfg, data_dir, info, steps, assembled=True, seed=0, device=device,
            label="assembled", log=log, **size))
    van_cfg = vanilla_model_config(2 * num_hues, width)
    van_state, van_record = common.cached_train(
        os.path.join(root, "vanilla_ckpt"), van_cfg, steps, use_ema=False, device=device,
        label="vanilla", log=log, train_fn=lambda: train_leg(
            van_cfg, data_dir, info, steps, assembled=False, seed=0, device=device,
            label="vanilla", log=log, **size))
    build_seconds = None
    if build is not None:
        n, build_seconds = build.result()
        log(f"generated {n} corrupted examples in {build_seconds:.0f}s")

    clean_asm = common.evaluate_split(asm_cfg, asm_state, data_dir, info, use_ema=True,
                                      device=device, **size)
    clean_van = common.evaluate_split(van_cfg, van_state, data_dir, info, use_ema=False,
                                      device=device, **size)
    log(f"clean top-1: assembled(EMA)={clean_asm['top1']:.2f}% "
        f"vanilla={clean_van['top1']:.2f}%")
    kw = dict(corruptions=corruptions, severities=severities, device=device, log=log, **size)
    van_err = corruption_errors(van_cfg, van_state, c_root, info, use_ema=False,
                                label="vanilla", **kw)
    asm_err = corruption_errors(asm_cfg, asm_state, c_root, info, use_ema=True,
                                label="assembled", **kw)
    summary = summarize(clean_asm, clean_van, asm_err, van_err, info.num_eval)
    summary.update(train={"assembled": asm_record, "vanilla": van_record},
                   imagenet_c_seconds=build_seconds, native_loader=True)
    log(json.dumps(summary))
    if check_bars:
        check(summary)
        log(f"{OK_LINE} (relative mCE {summary['relative_mce_assembled_vs_vanilla']:.1f} < 100)")
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("root", nargs="?", default=DEFAULT_ROOT)
    common.add_size_args(p, steps=STEPS, batch=BATCH, image_size=IMAGE)
    p.add_argument("--num_hues", type=int, default=len(STRIPE_HUES))
    p.add_argument("--n_train", type=int, default=N_TRAIN)
    p.add_argument("--n_eval", type=int, default=N_EVAL)
    p.add_argument("--corruptions", default=",".join(CORRUPTIONS))
    p.add_argument("--severities", default=",".join(map(str, SEVERITIES)))
    a = p.parse_args(argv)
    return run(a.root, steps=a.steps, batch=a.batch, image_size=a.image_size, width=a.width,
               num_hues=a.num_hues, n_train=a.n_train, n_eval=a.n_eval,
               corruptions=[c for c in a.corruptions.split(",") if c],
               severities=[int(s) for s in a.severities.split(",") if s],
               device="cpu" if a.cpu else None, check_bars=a.check)


if __name__ == "__main__":
    main()
