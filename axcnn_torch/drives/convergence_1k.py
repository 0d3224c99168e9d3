"""1001-way convergence drive: the ImageNet head's geometry, through the
literal training CLI (port of ``scripts/convergence_drive_1k.py``).

- 1,000 classes = 10 foreground hues x 10 background hues x 10 patterns
  (``drives/data.py`` ``make_set_1k``): 24 train and 3 held-out generated
  JPEGs a class, seed 0, labels stored 0..999; 16 train and 4 validation
  shards.
- ``python -m axcnn_torch.cli.main_classification --config=assemble_resnet50``
  with ``--data.num_classes=1001 --data.label_offset=1`` (class 0 the
  unused background, as ImageNet's head), the preset's production
  constants, the native loader with AutoAugment v0, echo x4, batch 64,
  10,000 steps, base LR 0.2 a 256 images, warm-up 0.05 of the run, a
  checkpoint every 1,000 steps and the hang watchdog at 600 s. On the
  watchdog's exit code (42) the CLI runs again and resumes from its last
  checkpoint; a run whose own final eval is logged is not run again.
- Epilogue: the checkpoint restored with its ``model_config.json`` and
  evaluated on the held-out split with the raw and the EMA weights (top-1
  and top-5); the median ``images_per_sec`` of the run's ``metrics.jsonl``.

Bars (``check``): raw and EMA top-1 >= 80, raw and EMA top-5 >= 95, EMA >=
raw - 2 below three EMA time constants (``steps * (1 - 0.9999)``), EMA >=
raw from three on.

    python -m axcnn_torch.drives.convergence_1k [steps] [root] [n_per_class] \
        [-- extra CLI flags]

Options: ``--n_eval`` (held-out images a class), ``--batch``,
``--image_size``, ``--width``, ``--cpu`` and ``--no-check``. Flags after
``--`` go to the CLI after the literal list, e.g.
``-- --train.seed=7 --runtime.keep_checkpoint_max=11`` for another seed
with every 1,000-step checkpoint kept; such a run has a model directory of
its own. The summary's ``curve`` holds raw and EMA at every kept
checkpoint; its last point is the summary's own numbers.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile

import numpy as np

from axcnn_torch.ckpt.checkpoint import CheckpointManager
from axcnn_torch.data.datasets import DatasetInfo
from axcnn_torch.drives import common
from axcnn_torch.drives.data import N_EVAL_1K, N_TRAIN_1K, classes_1k, make_set_1k

BATCH = 64
IMAGE = 224
ECHO = 4
STEPS = 10_000
N_TRAIN, N_EVAL = N_TRAIN_1K, N_EVAL_1K  # a class
TOP1_BAR = 80.0
TOP5_BAR = 95.0
EMA_LAG_TOL = 2.0  # below three EMA time constants only
DEFAULT_ROOT = os.path.join(tempfile.gettempdir(), "axcnn_torch_drive_1k")
OK_LINE = "1001-WAY CONVERGENCE DRIVE (contract head geometry, literal CLI) OK"
# the reference's summary (scripts/convergence_drive_1k.py:317-322)
METRICS = tuple(f"{n}_{k}" for n in ("raw", "ema") for k in ("top1", "top5", "loss"))
SUMMARY_KEYS = ("steps", "echo", "batch", "median_img_per_sec", *METRICS)


def dataset_info(n_train: int, n_eval: int) -> DatasetInfo:
    """The set as the 1001-way head reads it (images in all, not a class)."""
    return DatasetInfo("drive1k", 1001, n_train, n_eval, label_offset=1,
                       train_prefix="train", eval_prefix="validation")


def cli_flags(data_dir: str, model_dir: str, steps: int, n_train: int, n_eval: int,
              batch: int = BATCH) -> list:
    """The reference's literal flag list (images in all, not a class)."""
    return ["--config=assemble_resnet50",
            "--data.dataset_name=custom",
            f"--data.data_dir={data_dir}",
            "--data.num_classes=1001",      # 1000 + the background class 0
            "--data.label_offset=1",        # ImageNet's head geometry
            f"--data.num_train_examples={n_train}",
            f"--data.num_eval_examples={n_eval}",
            "--data.loader=cpp",
            f"--data.echo_factor={ECHO}",
            "--data.num_workers=4",
            f"--runtime.model_dir={model_dir}",
            "--runtime.save_checkpoint_steps=1000",
            "--runtime.hang_watchdog_s=600",  # a hang exits 42, and cli() reruns
            f"--train.batch_size={batch}",
            f"--train.train_steps={steps}",
            "--train.lr_warmup_epochs=0.05",
            "--train.base_lr=0.2",          # per 256; 0.05 at batch 64
            ]


def model_dir_for(root: str, steps: int, n_per_class: int, extra_flags=()) -> str:
    """The run's directory: ``run_<steps>[_n<n>]``, and a digest of the
    extra flags when there are any, so ``train_complete`` never takes one
    run for another."""
    name = f"run_{steps}" + (f"_n{n_per_class}" if n_per_class != N_TRAIN else "")
    if extra_flags:
        name += "_x" + hashlib.sha1("\n".join(extra_flags).encode()).hexdigest()[:10]
    return os.path.join(root, name)


def evaluate_checkpoints(model_dir, data_dir, info, *, batch: int, image_size: int, device,
                         log=print) -> list:
    """Raw and EMA top-1, top-5 and loss at every kept checkpoint, oldest
    first: [{'step', 'raw_top1', ..., 'ema_loss', 'count'}, ...] (the
    run's own evals are of the EMA only)."""
    directory = os.path.join(model_dir, "checkpoints")
    curve = []
    for step in CheckpointManager(directory).all_steps():
        mcfg, state = common.restore_state(directory, device=device, step=step)
        point, evals = {"step": step}, {}
        for name, use_ema in (("raw", False), ("ema", True)):
            evals[name] = common.evaluate_split(mcfg, state, data_dir, info, use_ema=use_ema,
                                                batch=batch, image_size=image_size,
                                                device=device)
        point.update({f"{n}_{k}": m[k] for n, m in evals.items()
                      for k in ("top1", "top5", "loss")}, count=evals["ema"]["count"])
        log(f"[1k curve] {json.dumps(point)}")
        curve.append(point)
    return curve


def median_images_per_sec(model_dir: str) -> float:
    ips = [r["images_per_sec"] for r in common.records(model_dir, "train")
           if r.get("images_per_sec")]
    return float(np.median(ips)) if ips else 0.0


def check(summary: dict) -> None:
    """The reference's bars; ``AssertionError`` with the summary on a miss.
    The EMA may trail raw by ``EMA_LAG_TOL`` only while the run is shorter
    than three time constants of the 0.9999 decay."""
    raw1, ema1 = summary["raw_top1"], summary["ema_top1"]
    assert raw1 >= TOP1_BAR, f"raw top-1 {raw1} < {TOP1_BAR} on 1001-way: {summary}"
    assert ema1 >= TOP1_BAR, f"EMA top-1 {ema1} < {TOP1_BAR} on 1001-way: {summary}"
    assert summary["raw_top5"] >= TOP5_BAR, f"raw top-5 < {TOP5_BAR}: {summary}"
    assert summary["ema_top5"] >= TOP5_BAR, f"EMA top-5 < {TOP5_BAR}: {summary}"
    steps = summary["steps"]
    time_constants = steps * (1.0 - 0.9999) if steps else 0.0
    ema_tol = EMA_LAG_TOL if time_constants < 3.0 else 0.0
    assert ema1 >= raw1 - ema_tol, (f"EMA vs raw at {time_constants:.1f} time constants: "
                                    f"{ema1} vs {raw1} (tol {ema_tol}): {summary}")


def run(steps: int = STEPS, root: str = DEFAULT_ROOT, n_per_class: int = N_TRAIN, *,
        n_eval: int = N_EVAL, batch: int = BATCH, image_size: int = IMAGE, width: float = 1.0,
        device=None, check_bars: bool = True, extra_flags=(), log=print) -> dict:
    """The drive; ``extra_flags`` go to the CLI after the literal list and
    the run's own flags."""
    device = common.resolve_device(device)
    extra_flags = list(extra_flags)
    os.makedirs(root, exist_ok=True)
    data_dir = make_set_1k(root, n_per_class, n_eval, seed=0, log=log)
    n_train, n_eval_all = n_per_class * classes_1k(), n_eval * classes_1k()
    model_dir = model_dir_for(root, steps, n_per_class, extra_flags)
    seconds = None
    if not common.train_complete(model_dir, steps):
        seconds = common.cli(
            [*cli_flags(data_dir, model_dir, steps, n_train, n_eval_all, batch),
             *common.cli_run_flags(device, width=width, image_size=image_size,
                                   full_size=IMAGE),
             *extra_flags],
            "1k", model_dir, log, retries=2)
    ev = common.last_eval(model_dir)
    med_ips = median_images_per_sec(model_dir)
    log(f"[1k ema] held-out top1={ev['top1']:.2f} top5={ev['top5']:.2f} "
        f"loss={ev['loss']:.4f}  (median {med_ips:.0f} img/s end-to-end, echo x{ECHO})")

    # raw against EMA on each kept state, the last one the run's result
    curve = evaluate_checkpoints(model_dir, data_dir, dataset_info(n_train, n_eval_all),
                                 batch=batch, image_size=image_size, device=device, log=log)
    last = curve[-1]
    summary = {
        "steps": steps, "echo": ECHO, "batch": batch, "median_img_per_sec": med_ips,
        **{k: last[k] for k in METRICS}, "eval_count": last["count"],
        "cli_eval": ev, "train_loss": common.train_losses(model_dir), "seconds": seconds,
        "native_loader": True, "extra_flags": extra_flags, "curve": curve,
    }
    log(json.dumps(summary))
    if check_bars:
        check(summary)
        log(OK_LINE)
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("steps", nargs="?", type=int, default=STEPS)
    p.add_argument("root", nargs="?", default=DEFAULT_ROOT)
    p.add_argument("n_per_class", nargs="?", type=int, default=N_TRAIN,
                   help="train images a class")
    common.add_size_args(p, steps=None, batch=BATCH, image_size=IMAGE)
    p.add_argument("--n_eval", type=int, default=N_EVAL, help="held-out images a class")
    argv = list(sys.argv[1:] if argv is None else argv)
    cut = argv.index("--") if "--" in argv else len(argv)
    a = p.parse_args(argv[:cut])
    return run(a.steps, a.root, a.n_per_class, n_eval=a.n_eval, batch=a.batch,
               image_size=a.image_size, width=a.width, device="cpu" if a.cpu else None,
               check_bars=a.check, extra_flags=argv[cut + 1:])


if __name__ == "__main__":
    main()
