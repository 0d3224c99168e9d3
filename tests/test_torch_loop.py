"""The port's run loop, ``axcnn_torch.train.loop``, on the CPU: checkpoint
cadence and exact resume, eval-only, SIGTERM, the hang watchdog, profiling
and warm start.

The runs use the assembled preset at width 0.125, 64x64, batch 8, fp32, on
user-built TFRecords of 24 training JPEGs (3 batches an epoch, so a 4-step
run crosses an epoch) through the reference's host loader. A run of 4 steps
that saves every 2 is interrupted by deleting its step-4 checkpoint; the
same command then restores step 2, the loader's position with it, and
must end bit for bit where the uninterrupted run ended.
"""

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from axcnn_torch.ckpt.checkpoint import CheckpointManager
from axcnn_torch.cli import main_classification as tcli
from axcnn_torch.train import loop
from axcnn_torch.train.train_step import create_train_state
from axcnn_torch.utils.config import parse_cli

REPO = Path(__file__).resolve().parent.parent
MODEL = ["--config=assemble_resnet50", "--model.width_multiplier=0.125",
         "--train.batch_size=8", "--train.dtype=fp32", "--train.log_every=1",
         "--runtime.platform=cpu"]


@pytest.fixture(autouse=True)
def _restore_tf32_flags():
    """The fp32 policy turns TF32 off process-wide; undo it after each test."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _records(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _watchdogs():
    return [t for t in threading.enumerate() if t.name == "hang-watchdog"]


@pytest.fixture(scope="module")
def data_args(tmp_path_factory):
    from axcnn.data.build_tfrecords import write_shards

    tmp = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    items = {"train": [], "validation": []}
    for label, name in enumerate(("a", "b")):
        for i in range(16):
            p = str(tmp / f"{name}{i}.jpg")
            Image.fromarray(rng.integers(0, 256, (72, 90, 3), dtype=np.uint8)).save(p)
            items["train" if i < 12 else "validation"].append((p, label, name))
    write_shards(items["train"], str(tmp / "rec"), "train", 2)
    write_shards(items["validation"], str(tmp / "rec"), "validation", 1)
    return ["--data.dataset_name=custom", f"--data.data_dir={tmp / 'rec'}",
            "--data.num_classes=2", "--data.num_train_examples=24",
            "--data.num_eval_examples=8", "--data.image_size=64", "--data.resize_min=72",
            "--data.num_workers=2"]


def _run_argv(data_args, model_dir, *extra):
    return [*MODEL, *data_args, "--train.train_steps=4",
            "--runtime.save_checkpoint_steps=2", f"--runtime.model_dir={model_dir}", *extra]


@pytest.fixture(scope="module")
def first_run(data_args, tmp_path_factory):
    """4 steps, a checkpoint every 2, the watchdog armed, steps 1-2 traced."""
    model_dir = str(tmp_path_factory.mktemp("first"))
    metrics = tcli.main(_run_argv(data_args, model_dir, "--runtime.hang_watchdog_s=120",
                                  "--runtime.profile_steps=2"))
    assert not _watchdogs()
    return model_dir, metrics


def test_checkpoints_every_save_step_and_at_the_end(first_run):
    model_dir, _ = first_run
    mgr = CheckpointManager(os.path.join(model_dir, "checkpoints"))
    assert mgr.all_steps() == [2, 4]
    assert mgr.model_config()["width_multiplier"] == 0.125
    assert mgr.model_config()["num_classes"] == 2  # the dataset's head
    raw = mgr.load(2)
    assert (raw["loader_epoch"], raw["loader_batches"], raw["rng_seed"]) == (0, 2, 42)
    raw = mgr.load(4)
    assert (raw["loader_epoch"], raw["loader_batches"]) == (1, 1)  # 3 batches an epoch
    tags = [r["tag"] for r in _records(model_dir)]
    assert tags == ["train"] * 4 + ["eval"]


def test_profile_writes_a_trace(first_run):
    traces = os.listdir(os.path.join(first_run[0], "profile"))
    assert traces == ["trace_to_step3.json"]
    with open(os.path.join(first_run[0], "profile", traces[0])) as f:
        assert json.load(f)["traceEvents"]


def test_resume_is_bit_exact(first_run, data_args, tmp_path):
    """Interrupted after step 2 (its step-4 checkpoint deleted), the same
    command restores step 2 and the loader's position and ends where the
    uninterrupted run ended: every parameter, BN buffer, velocity and EMA
    tensor, and the losses logged at steps 3-4."""
    model_dir = str(tmp_path / "resumed")
    shutil.copytree(first_run[0], model_dir, ignore=shutil.ignore_patterns("profile"))
    os.remove(os.path.join(model_dir, "checkpoints", "4.pt"))
    n_before = len(_records(model_dir))
    tcli.main(_run_argv(data_args, model_dir, "--runtime.hang_watchdog_s=120",
                        "--runtime.profile_steps=2"))
    new = _records(model_dir)[n_before:]
    assert new[0]["tag"] == "restore" and new[0]["step"] == 2 and new[0]["epoch"] == 0
    first = {r["step"]: r for r in _records(first_run[0]) if r["tag"] == "train"}
    resumed = {r["step"]: r for r in new if r["tag"] == "train"}
    assert sorted(resumed) == [3, 4]
    for s in (3, 4):
        for k in ("loss", "lr", "train_top1", "mixup_lam"):
            assert resumed[s][k] == first[s][k], (s, k)
    want = CheckpointManager(os.path.join(first_run[0], "checkpoints")).load(4)
    got = CheckpointManager(os.path.join(model_dir, "checkpoints")).load(4)
    for field in ("params", "model_state", "velocity", "ema"):
        assert list(got[field]) == list(want[field])
        for k in want[field]:
            assert torch.equal(got[field][k], want[field][k]), (field, k)
    for k in ("step", "loader_epoch", "loader_batches", "rng_seed"):
        assert got[k] == want[k]


@pytest.mark.parametrize("watchdog", [0, 120])
def test_eval_only(first_run, data_args, tmp_path, watchdog):
    """Evaluates the restored step-4 state (the run's last eval, again),
    trains nothing, writes no checkpoint, and leaves no watchdog thread."""
    model_dir = str(tmp_path / "eval")
    shutil.copytree(first_run[0], model_dir)
    n_before = len(_records(model_dir))
    metrics = tcli.main(_run_argv(data_args, model_dir, "--runtime.eval_only",
                                  f"--runtime.hang_watchdog_s={watchdog}"))
    assert metrics == first_run[1]
    new = _records(model_dir)[n_before:]
    assert [(r["tag"], r["step"]) for r in new] == [("restore", 4), ("eval", 4)]
    assert CheckpointManager(os.path.join(model_dir, "checkpoints")).all_steps() == [2, 4]
    assert not _watchdogs()


def test_sigterm_saves_and_exits_clean(tmp_path):
    """SIGTERM mid-run: the CLI finishes the step in flight, saves the
    consumed position, logs ``preempt_save`` and exits 0; the checkpoint
    restores at a step strictly inside the run."""
    model_dir = str(tmp_path / "run")
    metrics = os.path.join(model_dir, "metrics.jsonl")
    proc = subprocess.Popen(
        [sys.executable, "-m", "axcnn_torch.cli.main_classification", *MODEL,
         "--data.use_synthetic_data", "--data.image_size=64", "--train.train_steps=500",
         f"--runtime.model_dir={model_dir}"],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=open(tmp_path / "stderr", "w"))
    try:
        deadline = time.time() + 240
        while not (os.path.exists(metrics) and '"tag": "train"' in Path(metrics).read_text()):
            assert proc.poll() is None, (tmp_path / "stderr").read_text()
            assert time.time() < deadline, "worker never reached a train step"
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == 0, (tmp_path / "stderr").read_text()
    saves = [r for r in _records(model_dir) if r["tag"] == "preempt_save"]
    assert len(saves) == 1 and 0 < saves[0]["step"] < 500
    mgr = CheckpointManager(os.path.join(model_dir, "checkpoints"))
    assert mgr.all_steps() == [saves[0]["step"]]
    cfg = dataclasses.replace(parse_cli(MODEL).model, num_classes=1001)  # ImageNet's head
    state = create_train_state(cfg, generator=torch.Generator(), device="cpu")
    assert mgr.restore(state)[0].step == saves[0]["step"]


def test_sigterm_handler_and_watchdog_restored_after_an_exception(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("eval exploded")

    monkeypatch.setattr(loop, "evaluate", boom)
    prev = signal.getsignal(signal.SIGTERM)
    with pytest.raises(RuntimeError, match="eval exploded"):
        tcli.main([*MODEL, "--data.use_synthetic_data", "--data.image_size=32",
                   "--train.train_steps=1", "--runtime.hang_watchdog_s=120",
                   f"--runtime.model_dir={tmp_path}"])
    assert signal.getsignal(signal.SIGTERM) is prev
    assert not _watchdogs()


# ---------------------------------------------------------------------------
# warm start
# ---------------------------------------------------------------------------

def _fine_tune_cfg(ckpt_dir, *extra):
    return parse_cli([*MODEL, "--data.use_synthetic_data", "--data.image_size=64",
                      "--model.num_classes=5", f"--train.pretrained_checkpoint={ckpt_dir}",
                      *extra])


def test_warm_start_loads_the_body_and_keeps_the_head(first_run):
    """The pretrained EMA for every parameter but the head, the BN
    statistics, the EMA restarted from the loaded parameters, the velocity
    left at zero."""
    ckpt_dir = os.path.join(first_run[0], "checkpoints")
    cfg = _fine_tune_cfg(ckpt_dir)
    state = create_train_state(cfg.model, generator=torch.Generator().manual_seed(1),
                               device="cpu", use_ema=True)
    head = {k: p.clone() for k, p in state.model.named_parameters() if k.startswith("head.")}
    state = loop._warm_start(state, cfg)
    raw = CheckpointManager(ckpt_dir).load()
    params = dict(state.model.named_parameters())
    for k, p in params.items():
        want = head[k] if k.startswith("head.") else raw["ema"][k]
        assert torch.equal(p, want), k
    for k, b in state.model.named_buffers():
        assert torch.equal(b, raw["model_state"][k]), k
    for k, e in state.ema.items():
        assert torch.equal(e, params[k]) and e.data_ptr() != params[k].data_ptr(), k
        assert e.stride() == params[k].stride()
    assert all(not v.any() for v in state.velocity.values())


def test_warm_start_with_the_head_and_its_refusals(first_run, tmp_path):
    ckpt_dir = os.path.join(first_run[0], "checkpoints")
    cfg = _fine_tune_cfg(ckpt_dir, "--model.num_classes=2",
                         "--train.warm_start_exclude_head=false")
    state = create_train_state(cfg.model, generator=torch.Generator(), device="cpu")
    state = loop._warm_start(state, cfg)
    raw = CheckpointManager(ckpt_dir).load()
    assert torch.equal(state.model.head.weight, raw["ema"]["head.weight"])
    wide = _fine_tune_cfg(ckpt_dir, "--model.width_multiplier=0.25")
    with pytest.raises(ValueError, match="pretrained checkpoint .*4.pt does not match"):
        loop._warm_start(create_train_state(wide.model, generator=torch.Generator(),
                                            device="cpu"), wide)
    missing = _fine_tune_cfg(str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        loop._warm_start(create_train_state(missing.model, generator=torch.Generator(),
                                            device="cpu"), missing)


def test_fine_tune_preset_trains_from_a_pretrained_run(first_run, tmp_path):
    """``--config=finetune_fgvc`` (101-way Food-101 head) warm-starts from the
    2-way run and trains through the CLI."""
    metrics = tcli.main([
        "--config=finetune_fgvc", "--model.width_multiplier=0.125",
        "--data.use_synthetic_data", "--data.image_size=64", "--train.batch_size=8",
        "--train.train_steps=1", "--train.dtype=fp32", "--runtime.platform=cpu",
        f"--train.pretrained_checkpoint={first_run[0]}/checkpoints",
        f"--runtime.model_dir={tmp_path}"])
    assert metrics["count"] == 32 and np.isfinite(metrics["loss"])
    assert CheckpointManager(str(tmp_path / "checkpoints")).model_config()["num_classes"] == 101


def test_kd_run_through_the_cli(first_run, tmp_path):
    """``--train.kd_teacher_checkpoint`` with ``--train.grad_accum_steps=2``:
    the 2-way teacher of the first run distils into an SE-less student."""
    metrics = tcli.main([
        *MODEL, "--data.use_synthetic_data", "--data.image_size=64",
        "--data.dataset_name=custom", "--data.num_classes=2",
        "--data.num_train_examples=8", "--data.num_eval_examples=8",
        "--model.use_se_block=false", "--train.train_steps=2",
        "--train.grad_accum_steps=2", "--train.kd_temp=2",
        f"--train.kd_teacher_checkpoint={first_run[0]}/checkpoints",
        f"--runtime.model_dir={tmp_path}"])
    train = [r for r in _records(str(tmp_path)) if r["tag"] == "train"]
    assert [r["step"] for r in train] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in train) and metrics["count"] == 32
