"""The KD sweep behind the KD drive's learning rate (port of
``scripts/kd_sweep.py``).

The reference's KD student at LR 0.2 (T 1, alpha 1) trailed its control
(42.2 against 84.0 held-out top-1) while the teacher was healthy
(``kd_probe``). Its hypothesis: the additive CE + KL term doubles the
logit gradient's scale and pushes the R152 student past its stability edge
at that LR. Three legs tell the causes apart:

- ``half_lr``: alpha 1, T 1, LR 0.1 (the same pull at half the scale);
- ``alpha.3``: alpha 0.3, T 1, LR 0.2 (a weaker pull at the full LR);
- ``temp2``: alpha 1, T 2, LR 0.2 (softer targets, the same gradient).

Each leg is ``--config=assemble_resnet152_kd`` through the literal training
CLI on the clean 12-per-class subset of the 50-class set (no label noise:
not the KD drive's noisy subset), batch 64, the KD drive's teacher
(``<root>/teacher/checkpoints``), one card; it writes to
``<root>/sweep_<tag>_<steps>`` and is skipped when that holds
``checkpoints/``. Prints ``{tag: {top1, loss, kd_temp, kd_alpha,
base_lr}}``; the sweep has no bars.

    python -m axcnn_torch.drives.kd_sweep [student_steps] [root]   # after axcnn_torch.drives.kd

Options: ``--batch``, ``--image_size``, ``--width``, the full set's images
a class (``--n_train``, ``--n_eval``) and its directory (``--scale_root``),
``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import os

from axcnn_torch.drives import common
from axcnn_torch.drives.data import SCALE_ROOT, make_scale_set, make_subset
from axcnn_torch.drives.kd import DEFAULT_ROOT, N_EVAL, N_SUBSET, N_TRAIN

STUDENT_STEPS = 600
BATCH = 64
IMAGE = 224
LEGS = (
    ("half_lr", dict(kd_temp=1.0, kd_alpha=1.0, base_lr=0.1)),
    ("alpha.3", dict(kd_temp=1.0, kd_alpha=0.3, base_lr=0.2)),
    ("temp2", dict(kd_temp=2.0, kd_alpha=1.0, base_lr=0.2)),
)


def run(student_steps: int = STUDENT_STEPS, root: str = DEFAULT_ROOT, *, batch: int = BATCH,
        image_size: int = IMAGE, width: float = 1.0, n_train: int = N_TRAIN,
        n_eval: int = N_EVAL, scale_root: str = SCALE_ROOT, device=None, log=print) -> dict:
    """The three legs; returns ``{tag: {top1, loss, kd_temp, kd_alpha,
    base_lr}}``. Exits with a message when the KD drive's teacher is not
    under ``root``."""
    device = common.resolve_device(device)
    teacher_ckpt = os.path.join(root, "teacher", "checkpoints")
    if not os.path.isdir(teacher_ckpt):
        raise SystemExit(f"error: no teacher under {teacher_ckpt}; run "
                         f"python -m axcnn_torch.drives.kd with this root first")
    make_scale_set(scale_root, n_train=n_train, n_eval=n_eval, seed=0, log=log)
    sub_dir, sub_info = make_subset(scale_root, root, N_SUBSET, n_train=n_train, n_eval=n_eval)
    sflags = common.cli_data_flags(sub_dir, sub_info)
    run_flags = common.cli_run_flags(device, width=width, image_size=image_size,
                                     full_size=IMAGE)
    out = {}
    for tag, hp in LEGS:
        mdir = os.path.join(root, f"sweep_{tag}_{student_steps}")
        if not os.path.isdir(os.path.join(mdir, "checkpoints")):
            common.cli(["--config=assemble_resnet152_kd", *sflags,
                        f"--train.batch_size={batch}",
                        f"--train.train_steps={student_steps}",
                        "--train.lr_warmup_epochs=0.07",
                        f"--train.base_lr={hp['base_lr']}",
                        f"--train.kd_teacher_checkpoint={teacher_ckpt}",
                        f"--train.kd_temp={hp['kd_temp']}",
                        f"--train.kd_alpha={hp['kd_alpha']}",
                        f"--runtime.model_dir={mdir}", *run_flags], tag, mdir, log)
        m = common.last_eval(mdir)
        out[tag] = {"top1": m["top1"], "loss": m["loss"], **hp}
        log(f"[sweep/{tag}] top1={m['top1']:.2f} loss={m['loss']:.4f}")
    log(json.dumps(out))
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("student_steps", nargs="?", type=int, default=STUDENT_STEPS)
    p.add_argument("root", nargs="?", default=DEFAULT_ROOT)
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--image_size", type=int, default=IMAGE)
    p.add_argument("--width", type=float, default=1.0, help="width multiplier")
    p.add_argument("--n_train", type=int, default=N_TRAIN)
    p.add_argument("--n_eval", type=int, default=N_EVAL)
    p.add_argument("--scale_root", default=SCALE_ROOT)
    p.add_argument("--cpu", action="store_true", help="run on the host CPU")
    a = p.parse_args(argv)
    return run(a.student_steps, a.root, batch=a.batch, image_size=a.image_size, width=a.width,
               n_train=a.n_train, n_eval=a.n_eval, scale_root=a.scale_root,
               device="cpu" if a.cpu else None)


if __name__ == "__main__":
    main()
