"""What the library drives share: the device, the native loader they all
require, the step loop, the held-out eval and the training CLI's runs."""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from axcnn_torch.ckpt.checkpoint import CheckpointManager
from axcnn_torch.core.dtypes import BF16_POLICY
from axcnn_torch.data import cpp_loader
from axcnn_torch.data.pipeline import DevicePrefetch, EchoIterator, TFRecordImageLoader
from axcnn_torch.models.resnet import ModelConfig
from axcnn_torch.train.loop import evaluate
from axcnn_torch.train.train_step import create_train_state, make_eval_step
from axcnn_torch.utils.watchdog import HANG_EXIT_CODE

POLICY = BF16_POLICY  # every drive trains and evaluates in bf16, as the reference's


def resolve_device(device=None) -> torch.device:
    """None: the CUDA card, and exit with a message when there is none;
    otherwise ``device`` as given (``"cpu"`` for the host). Nothing falls
    back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("error: no CUDA device; pass --cpu to run on the host CPU")
        return torch.device("cuda", 0)
    device = torch.device(device)
    return torch.device("cuda", 0) if device.type == "cuda" and device.index is None else device


def resize_min_for(image_size: int) -> int:
    """The eval geometry's shorter side: 256 at 224, as in the reference,
    and in the same ratio at the small sizes of a test."""
    return image_size * 256 // 224


def native_loader(data_dir, info, *, batch: int, image_size: int, train: bool,
                  autoaugment_type: str = "none", seed: int = 0,
                  resize_min: int | None = None,
                  drop_remainder: bool | None = None) -> TFRecordImageLoader:
    """The C++ loader (AutoAugment in its threads); raises when it is not
    the path that decodes, never falls back to the Python one. A failed
    build of ``cpp/`` raises with the build's stderr. The last partial
    batch is dropped in training (``drop_remainder`` None) and kept in an
    eval, unless ``drop_remainder`` says otherwise."""
    loader = TFRecordImageLoader(
        data_dir, info, batch_size=batch, train=train, image_size=image_size,
        resize_min=resize_min_for(image_size) if resize_min is None else resize_min,
        autoaugment_type=autoaugment_type, seed=seed, num_workers=os.cpu_count() or 4,
        use_native=True, drop_remainder=train if drop_remainder is None else drop_remainder)
    want = cpp_loader.AA_POLICIES[autoaugment_type] if train else -1
    if not loader.native_active or loader._aa_policy != want:
        raise RuntimeError(f"the native loader is not the decode path (native "
                           f"{loader.native_active}, AutoAugment policy {loader._aa_policy}, "
                           f"wanted {want})")
    return loader


def run_steps(step_fn, state, loader, steps: int, *, root_seed: int, device, label: str,
              log_every: int, echo: int = 1, log=print) -> tuple:
    """``steps`` steps of ``step_fn`` on ``loader``'s batches through a
    ``DevicePrefetch`` of 2, each batch fed to ``echo`` consecutive steps
    (``EchoIterator`` above the prefetch; step 1 trains on the first
    batch). Logs steps 1, every ``log_every``-th and the last (each a host
    sync on the loss). Returns (state, record): the logged losses, the wall
    seconds, the median gap between steps on the host's clock (the step
    rate once the queue of launches is full) and whether every step's loss
    was finite."""
    prefetch = DevicePrefetch(iter(loader), device=device, size=2)
    it = EchoIterator(prefetch, echo) if echo > 1 else prefetch
    losses, stamps, logged = [], [], []
    try:
        t0 = time.perf_counter()
        for step in range(1, steps + 1):
            state, m = step_fn(state, next(it), root_seed)
            losses.append(m["loss"])
            stamps.append(time.perf_counter())
            if step % log_every == 0 or step in (1, steps):
                loss = float(m["loss"])
                logged.append([step, loss])
                log(f"[{label}] step {step:4d}: loss={loss:.4f} "
                    f"train_top1={float(m['train_top1']):.3f} lr={float(m['lr']):.4f}")
        all_losses = torch.stack(losses).float().cpu()  # waits for the last step
        wall = time.perf_counter() - t0
    finally:
        prefetch.close()
    gaps = np.diff(stamps)
    record = {"steps": steps, "seconds": wall, "logged_loss": logged,
              "median_step_ms": float(np.median(gaps)) * 1e3 if len(gaps) else None,
              "all_finite": bool(torch.isfinite(all_losses).all())}
    log(f"[{label}] {steps} steps in {wall:.1f}s")
    return state, record


def evaluate_split(cfg, state, data_dir, info, *, use_ema: bool, batch: int, image_size: int,
                   device, resize_min: int | None = None, policy=POLICY) -> dict:
    """The EMA-swapped (``use_ema``) or raw eval of ``info``'s eval split
    under ``policy``: {'top1': %, 'top5': %, 'loss', 'count'}."""
    eval_step = make_eval_step(cfg, policy=policy, use_ema=use_ema,
                               mean_rgb=info.mean_rgb, stddev_rgb=info.stddev_rgb)
    loader = native_loader(data_dir, info, batch=batch, image_size=image_size, train=False,
                           resize_min=resize_min)
    return evaluate(eval_step, state, loader, batch_size=batch, device=device)


def cached_train(directory: str, cfg, steps: int, *, use_ema: bool, device, train_fn,
                 label: str, log=print):
    """The trained state kept in ``directory`` (a port checkpoint and its
    ``model_config.json``), else ``train_fn()``'s, saved there. A kept
    state must have been trained for ``steps`` steps under ``cfg``: another
    one raises ``ValueError`` rather than stand in for it. Returns (state,
    the step loop's record, or None when the state was restored)."""
    mgr = CheckpointManager(directory, max_to_keep=1)
    want = json.loads(json.dumps(dataclasses.asdict(cfg), default=str))
    if mgr.latest_step() is not None:
        if mgr.model_config() != want:
            raise ValueError(f"{directory} holds a state of another model config: "
                             f"{mgr.model_config()} (wanted {want})")
        state = create_train_state(cfg, generator=torch.Generator().manual_seed(0),
                                   device=device, use_ema=use_ema)
        state = mgr.restore(state)[0]
        if state.step != steps:
            raise ValueError(f"{directory} holds a state trained for {state.step} steps, "
                             f"not {steps}: use another root")
        log(f"[{label}] restored cached state at step {state.step}")
        return state, None
    state, record = train_fn()
    mgr = CheckpointManager(directory, max_to_keep=1, model_config=want)
    mgr.save(state, force=True)
    mgr.close()
    return state, record


def restore_state(directory: str, *, device, step: int | None = None):
    """(the ``ModelConfig`` its ``model_config.json`` records, the train
    state with its EMA) of checkpoint ``step`` in ``directory`` (default:
    the latest); None when there is none."""
    mgr = CheckpointManager(directory)
    try:
        if mgr.latest_step() is None:
            return None
        cfg = ModelConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                             for k, v in mgr.model_config().items()})
        state = create_train_state(cfg, generator=torch.Generator().manual_seed(0),
                                   device=device, use_ema=True)
        return cfg, mgr.restore(state, step=step)[0]
    finally:
        mgr.close()


# -- the training CLI's runs (the drives that go through the literal CLI) ----------

def cli_command(args) -> list:
    return [sys.executable, "-m", "axcnn_torch.cli.main_classification", *args]


def recipe_command(recipe: str, args) -> list:
    """A recipe of ``axcnn_torch.cli.recipes`` on ``args``."""
    return [sys.executable, "-m", "axcnn_torch.cli.recipes", recipe, *args]


def predict_command(args) -> list:
    return [sys.executable, "-m", "axcnn_torch.cli.predict", *args]


def run_logged(cmd, tag: str, log_path: str, log=print, retries: int = 0) -> float:
    """Run ``cmd``, its output into ``log_path``. On the hang watchdog's
    exit code (42) run it again, up to ``retries`` times: the loop resumes
    from its last checkpoint. Returns its seconds, the retries included;
    raises with the log's tail on any other failure."""
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    t0 = time.time()
    with open(log_path, "w") as out:
        for attempt in range(retries + 1):
            log(f"[{tag}] $ {' '.join(cmd)}")
            t1 = time.time()
            r = subprocess.run(cmd, stdout=out, stderr=subprocess.STDOUT)
            log(f"[{tag}] exit={r.returncode} in {time.time() - t1:.0f}s")
            if r.returncode != HANG_EXIT_CODE or attempt == retries:
                break
            log(f"[{tag}] hang detected (exit {HANG_EXIT_CODE}); retry {attempt + 1}/{retries} "
                "resumes from checkpoint")
    if r.returncode:
        with open(log_path) as f:
            raise RuntimeError(f"{tag} failed (exit {r.returncode}):\n{f.read()[-6000:]}")
    return time.time() - t0


def cli(args, tag: str, model_dir: str, log=print, retries: int = 0) -> float:
    """``run_logged`` of the training CLI on ``args``, its output into
    ``<model_dir>/cli.log``."""
    return run_logged(cli_command(args), tag, os.path.join(model_dir, "cli.log"), log, retries)


def predict(args, tag: str, log=print) -> list:
    """``axcnn_torch.cli.predict`` on ``args``: its JSON lines, one per
    image; raises with its stderr on a non-zero exit."""
    cmd = predict_command(args)
    log(f"[{tag}] $ {' '.join(cmd)}")
    t0 = time.time()
    r = subprocess.run(cmd, capture_output=True, text=True)
    log(f"[{tag}] exit={r.returncode} in {time.time() - t0:.0f}s")
    if r.returncode:
        raise RuntimeError(f"{tag} failed (exit {r.returncode}):\n{r.stderr[-6000:]}")
    return [json.loads(line) for line in r.stdout.splitlines() if line.startswith("{")]


def cli_size_flags(*, width: float, image_size: int, full_size: int) -> list:
    """The model and data flags of a drive's cut: the width and the image
    size where they are cut."""
    flags = []
    if width != 1.0:
        flags.append(f"--model.width_multiplier={width}")
    if image_size != full_size:
        flags += [f"--data.image_size={image_size}",
                  f"--data.resize_min={resize_min_for(image_size)}"]
    return flags


def cli_run_flags(device, *, width: float, image_size: int, full_size: int) -> list:
    """The CLI flags of a drive's size and device: one card (or the host
    CPU), and ``cli_size_flags``."""
    flags = ["--runtime.num_devices=1"]
    if device.type == "cpu":
        flags.append("--runtime.platform=cpu")
    return flags + cli_size_flags(width=width, image_size=image_size, full_size=full_size)


def cli_data_flags(data_dir, info) -> list:
    """A generated set's flags, echo 2 (the reference's literal lists)."""
    return [
        "--data.dataset_name=custom",
        f"--data.data_dir={data_dir}",
        f"--data.num_classes={info.num_classes}",
        f"--data.num_train_examples={info.num_train}",
        f"--data.num_eval_examples={info.num_eval}",
        "--data.loader=cpp",
        "--data.echo_factor=2",
        "--data.num_workers=4",
    ]


def records(model_dir: str, tag: str) -> list:
    """The ``tag`` records of a CLI run's ``metrics.jsonl``."""
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r.get("tag") == tag]


def last_eval(model_dir: str) -> dict:
    evals = records(model_dir, "eval")
    assert evals, f"no eval record in {model_dir}"
    return evals[-1]


def train_complete(model_dir: str, steps: int) -> bool:
    """True once the run's own final eval is logged (the loop evaluates at
    its last step); a bare ``checkpoints/`` is not completion: a run cut
    short resumes from its last checkpoint when the CLI runs again."""
    if not os.path.exists(os.path.join(model_dir, "metrics.jsonl")):
        return False
    return any(r.get("step", 0) >= steps for r in records(model_dir, "eval"))


def train_final_eval(model_dir: str, steps: int) -> dict:
    """The training run's own final eval: the first eval record at a step
    >= ``steps``. ``last_eval`` would read a later ``eval_only`` run's
    record appended to the same ``metrics.jsonl``."""
    for r in records(model_dir, "eval"):
        if r.get("step", 0) >= steps:
            return r
    raise AssertionError(f"no final training eval in {model_dir}")


def train_losses(model_dir: str) -> list:
    """The run's logged training losses, as [step, loss]."""
    return [[r["step"], r["loss"]] for r in records(model_dir, "train")]


def add_size_args(parser, *, steps: int, batch: int, image_size: int) -> None:
    """The options every drive takes, with the reference's constants as
    defaults: ``--steps``, ``--batch``, ``--image_size``, ``--width``, and
    ``--cpu`` (the host CPU instead of the card) and ``--no-check`` (print
    the summary without asserting the bars); no ``--steps`` when ``steps``
    is None."""
    if steps is not None:
        parser.add_argument("--steps", type=int, default=steps)
    parser.add_argument("--batch", type=int, default=batch)
    parser.add_argument("--image_size", type=int, default=image_size)
    parser.add_argument("--width", type=float, default=1.0, help="width multiplier")
    parser.add_argument("--cpu", action="store_true", help="run on the host CPU")
    parser.add_argument("--no-check", dest="check", action="store_false",
                        help="do not assert the bars")


def missing_keys(summary: dict, keys) -> list:
    """The key paths of ``keys`` (``"raw/top1"``: key ``top1`` under
    ``raw``) that ``summary`` lacks."""
    missing = []
    for path in keys:
        node = summary
        for part in path.split("/"):
            if not isinstance(node, dict) or part not in node:
                missing.append(path)
                break
            node = node[part]
    return missing
