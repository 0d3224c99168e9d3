"""BASELINE config-5 drive: Assemble-ResNet-152 distilled from an
Assemble-ResNet-50 teacher, trained through the literal training CLI (port
of ``scripts/kd_drive.py``).

1. Teacher: ``python -m axcnn_torch.cli.main_classification
   --config=assemble_resnet50`` on the 50-class set of the scale drive
   (``axcnn_torch.drives.data.make_scale_set``: 120 train and 24 held-out
   images a class, clean labels), 2,500 steps, batch 64, echo 2, the native
   loader.
2. Students, ``--config=assemble_resnet152_kd`` on a 12-per-class subset of
   it whose train labels carry 40% uniform label noise (``make_subset``),
   600 steps each, the same seed and data: ``control`` (LR 0.1),
   ``kd`` (LR 0.1 with ``--train.kd_teacher_checkpoint``, T 1, alpha 1) and
   ``control_lr0.2`` (the control at its own best LR). The teacher's KL term
   is the only difference between ``control`` and ``kd``.
3. Epilogue: the KD student's checkpoint restored through
   ``CheckpointManager`` and evaluated with its raw and its EMA weights.

Every CLI run is one card (``--runtime.num_devices=1``); its output goes to
``<model_dir>/cli.log``. A teacher or student whose checkpoints exist is not
trained again. Each leg's logged training loss (the CLI's ``metrics.jsonl``
records) is printed and kept in the summary (``train_loss``). Bars
(``check``): teacher top-1 >= 90 (asserted before the students); the KD
student beats the best control on held-out top-1 and on eval loss; its EMA
top-1 >= raw - 1.

    python -m axcnn_torch.drives.kd [student_steps] [root] [n_subset] [base_lr] [noise_frac]

Options: ``--teacher_steps``, ``--batch``, ``--image_size``, ``--width``,
the full set's images a class (``--n_train``, ``--n_eval``) and its
directory (``--scale_root``), ``--cpu`` and ``--no-check``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from axcnn_torch.drives import common
from axcnn_torch.drives.data import SCALE_ROOT, make_scale_set, make_subset

TEACHER_STEPS = 2500
STUDENT_STEPS = 600
BATCH = 64
IMAGE = 224
N_SUBSET = 12
# kd_sweep measured LR 0.2 past the R152's stability edge WITH the KL term:
# both legs run at 0.1, and a second control at its own best LR, 0.2
BASE_LR = 0.1
# the controlled stand-in for the label ambiguity KD exists for
NOISE_FRAC = 0.4
N_TRAIN, N_EVAL = 120, 24
DEFAULT_ROOT = os.path.join(tempfile.gettempdir(), "axcnn_torch_kd")
OK_LINE = "KD DRIVE (config 5: R152 student + R50 teacher, literal CLI) OK"
# the reference's summary at its default LR (scripts/kd_drive.py:250-260)
SUMMARY_KEYS = ("teacher_top1", "student_steps", "n_subset", "noise_frac", "base_lr",
                "control_top1", "kd_top1", "control_lr0.2_top1", "control_loss", "kd_loss",
                "control_lr0.2_loss", "kd_raw_top1", "kd_ema_top1")


def check_teacher(teacher_top1: float, detail) -> None:
    assert teacher_top1 >= 90.0, f"teacher too weak to distill from: {detail}"


def check(summary: dict) -> None:
    """The reference's bars; ``AssertionError`` with the summary on a miss.
    KD must beat every control (each at its own LR) on each metric."""
    check_teacher(summary["teacher_top1"], summary)
    controls = [k[:-len("_top1")] for k in summary
                if k.startswith("control") and k.endswith("_top1")]
    best_top1 = max(summary[f"{c}_top1"] for c in controls)
    best_loss = min(summary[f"{c}_loss"] for c in controls)
    assert summary["kd_top1"] > best_top1, f"KD did not beat the best control: {summary}"
    assert summary["kd_loss"] < best_loss, \
        f"KD eval loss not better than the best control: {summary}"
    assert summary["kd_ema_top1"] >= summary["kd_raw_top1"] - 1.0, f"EMA lags raw: {summary}"


def run(student_steps: int = STUDENT_STEPS, root: str = DEFAULT_ROOT, n_subset: int = N_SUBSET,
        base_lr: float = BASE_LR, noise_frac: float = NOISE_FRAC, *,
        teacher_steps: int = TEACHER_STEPS, batch: int = BATCH, image_size: int = IMAGE,
        width: float = 1.0, n_train: int = N_TRAIN, n_eval: int = N_EVAL,
        scale_root: str = SCALE_ROOT, device=None, check_bars: bool = True,
        log=print) -> dict:
    """The teacher, the three students and the epilogue; returns the
    summary (the reference's keys; ``train_loss`` and ``seconds`` by leg,
    seconds None for a leg found trained)."""
    device = common.resolve_device(device)
    os.makedirs(root, exist_ok=True)
    data_dir, info = make_scale_set(scale_root, n_train=n_train, n_eval=n_eval, seed=0, log=log)
    sub_dir, sub_info = make_subset(scale_root, root, n_subset, noise_frac=noise_frac,
                                    n_train=n_train, n_eval=n_eval)
    run_flags = [f"--train.batch_size={batch}",
                 *common.cli_run_flags(device, width=width, image_size=image_size,
                                       full_size=IMAGE)]
    seconds, losses = {}, {}

    teacher_dir = os.path.join(root, "teacher")
    teacher_ckpt = os.path.join(teacher_dir, "checkpoints")
    seconds["teacher"] = None
    if not os.path.isdir(teacher_ckpt):
        seconds["teacher"] = common.cli(
            ["--config=assemble_resnet50", *common.cli_data_flags(data_dir, info),
             *run_flags,
             f"--runtime.model_dir={teacher_dir}", f"--train.train_steps={teacher_steps}",
             # train_steps > 0: warmup epochs are fractions of the run, and
             # the one eval comes at its end
             "--train.lr_warmup_epochs=0.07",
             "--train.base_lr=0.2",  # per 256, scaled to 0.05 at batch 64
             ], "teacher", teacher_dir, log)
    tm = common.last_eval(teacher_dir)
    losses["teacher"] = common.train_losses(teacher_dir)
    log(f"[teacher] held-out top1={tm['top1']:.2f} top5={tm['top5']:.2f} loss={tm['loss']:.4f}")
    if check_bars:
        check_teacher(tm["top1"], tm)

    common_flags = ["--config=assemble_resnet152_kd", *common.cli_data_flags(sub_dir, sub_info),
                    *run_flags,
                    f"--train.train_steps={student_steps}", "--train.lr_warmup_epochs=0.07"]
    kd_flags = [f"--train.kd_teacher_checkpoint={teacher_ckpt}",
                "--train.kd_temp=1.0", "--train.kd_alpha=1.0"]
    leg_defs = [("control", base_lr, []), ("kd", base_lr, kd_flags)]
    if base_lr != 0.2:
        leg_defs.append(("control_lr0.2", 0.2, []))
    legs, leg_dirs = {}, {}
    suffix = f"_{student_steps}_sub{n_subset}" + (f"_noise{noise_frac}" if noise_frac else "")
    for tag, lr, extra in leg_defs:
        mdir = os.path.join(root, f"student_{tag}{suffix}" + (f"_lr{lr}" if lr != 0.2 else ""))
        seconds[tag] = None
        if not os.path.isdir(os.path.join(mdir, "checkpoints")):
            seconds[tag] = common.cli([*common_flags, f"--train.base_lr={lr}",
                                f"--runtime.model_dir={mdir}", *extra], tag, mdir, log)
        legs[tag] = common.last_eval(mdir)
        leg_dirs[tag] = mdir
        losses[tag] = common.train_losses(mdir)
        log(f"[student/{tag}] held-out top1={legs[tag]['top1']:.2f} "
            f"top5={legs[tag]['top5']:.2f} loss={legs[tag]['loss']:.4f}")
    log(f"[train_loss] {json.dumps(losses)}")

    # epilogue: raw against EMA on the KD student (the CLI evaluates the EMA
    # only)
    mcfg, state = common.restore_state(os.path.join(leg_dirs["kd"], "checkpoints"),
                                       device=device)
    raw_ema = {}
    for name, use_ema in (("raw", False), ("ema", True)):
        raw_ema[name] = common.evaluate_split(mcfg, state, data_dir, info, use_ema=use_ema,
                                              batch=batch, image_size=image_size, device=device)
        log(f"[student/kd {name}] top1={raw_ema[name]['top1']:.2f} "
            f"loss={raw_ema[name]['loss']:.4f}")
    summary = {
        "teacher_top1": tm["top1"],
        "student_steps": student_steps,
        "n_subset": n_subset,
        "noise_frac": noise_frac,
        "base_lr": base_lr,
        **{f"{t}_top1": m["top1"] for t, m in legs.items()},
        **{f"{t}_loss": m["loss"] for t, m in legs.items()},
        "kd_raw_top1": raw_ema["raw"]["top1"],
        "kd_ema_top1": raw_ema["ema"]["top1"],
        "teacher_steps": teacher_steps,
        "train_loss": losses,
        "seconds": seconds,
        "native_loader": True,
    }
    log(json.dumps(summary))
    if check_bars:
        check(summary)
        log(OK_LINE)
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("student_steps", nargs="?", type=int, default=STUDENT_STEPS)
    p.add_argument("root", nargs="?", default=DEFAULT_ROOT)
    p.add_argument("n_subset", nargs="?", type=int, default=N_SUBSET)
    p.add_argument("base_lr", nargs="?", type=float, default=BASE_LR)
    p.add_argument("noise_frac", nargs="?", type=float, default=NOISE_FRAC)
    common.add_size_args(p, steps=None, batch=BATCH, image_size=IMAGE)
    p.add_argument("--teacher_steps", type=int, default=TEACHER_STEPS)
    p.add_argument("--n_train", type=int, default=N_TRAIN)
    p.add_argument("--n_eval", type=int, default=N_EVAL)
    p.add_argument("--scale_root", default=SCALE_ROOT)
    a = p.parse_args(argv)
    return run(a.student_steps, a.root, a.n_subset, a.base_lr, a.noise_frac,
               teacher_steps=a.teacher_steps, batch=a.batch, image_size=a.image_size,
               width=a.width, n_train=a.n_train, n_eval=a.n_eval, scale_root=a.scale_root,
               device="cpu" if a.cpu else None, check_bars=a.check)


if __name__ == "__main__":
    main()
