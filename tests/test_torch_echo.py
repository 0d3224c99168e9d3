"""Data echo in the port's run loop (``--data.echo_factor``), on the CPU: the
counterparts of the reference's ``tests/test_loop.py::TestDataEchoing``.

The runs use the assembled preset at width 0.125, batch 8, fp32 (as
tests/test_torch_loop.py), 32x32: a run echoes each batch twice and pulls
half as many from the loader; saves wait for the end of an echo group, so a
run interrupted there and resumed ends bit for bit where an uninterrupted
run ends; and the steps on one echoed batch still draw their own mixup and
DropBlock randomness.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from axcnn_torch.ckpt.checkpoint import CheckpointManager
from axcnn_torch.cli import main_classification as tcli
from axcnn_torch.data.pipeline import EchoIterator
from axcnn_torch.train import loop
import torch_inprocess

capped_threads = torch_inprocess.capped_threads

MODEL = ["--config=assemble_resnet50", "--model.width_multiplier=0.125",
         "--train.batch_size=8", "--train.dtype=fp32", "--train.log_every=1",
         "--runtime.platform=cpu", "--data.echo_factor=2"]


@pytest.fixture(autouse=True)
def _restore_tf32_flags():
    """The fp32 policy turns TF32 off process-wide; undo it after each test."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _train_records(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return {r["step"]: r for r in map(json.loads, f) if r["tag"] == "train"}


def test_echo_trains_and_logs(tmp_path, monkeypatch):
    """echo_factor=2: the loop runs every step of its budget and pulls half
    as many fresh batches."""
    fresh = []

    class Counting(EchoIterator):
        def __next__(self):
            fresh.append(self.at_boundary)
            return super().__next__()

    monkeypatch.setattr(loop, "EchoIterator", Counting)
    metrics = tcli.main([*MODEL, "--data.use_synthetic_data", "--data.image_size=32",
                         "--train.train_steps=4", f"--runtime.model_dir={tmp_path}"])
    assert metrics["count"] > 0
    assert sorted(_train_records(str(tmp_path))) == [1, 2, 3, 4]
    assert fresh == [True, False, True, False]


def test_echo_resume_matches_uninterrupted(tmp_path):
    """Saves wait for the echo group's end: ``save_checkpoint_steps=3`` with
    echo x2 over 8 steps writes steps 4 (not 3), 6 and 8. Interrupted after
    step 4 (its later checkpoints deleted), the same command restores step 4
    and logs the uninterrupted run's losses at steps 5-8 and ends in its
    state, bit for bit."""
    from axcnn.data.build_tfrecords import write_shards

    rng = np.random.default_rng(1)
    items = {"train": [], "validation": []}
    for label in range(2):
        for i in range(10):
            p = str(tmp_path / f"c{label}_{i}.jpg")
            Image.fromarray(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)).save(p)
            items["train" if i < 8 else "validation"].append((p, label, str(label)))
    rec = str(tmp_path / "rec")
    write_shards(items["train"], rec, "train", 2)
    write_shards(items["validation"], rec, "validation", 1)
    argv = [*MODEL, "--data.dataset_name=custom", f"--data.data_dir={rec}",
            "--data.image_size=32", "--data.resize_min=32", "--data.num_classes=2",
            "--data.num_train_examples=16", "--data.num_eval_examples=4",
            "--data.num_workers=2", "--train.train_steps=8",
            "--runtime.save_checkpoint_steps=3"]

    full, resumed = str(tmp_path / "full"), str(tmp_path / "resumed")
    tcli.main([*argv, f"--runtime.model_dir={full}"])
    assert CheckpointManager(os.path.join(full, "checkpoints")).all_steps() == [4, 6, 8]
    shutil.copytree(full, resumed)
    for step in (6, 8):
        os.remove(os.path.join(resumed, "checkpoints", f"{step}.pt"))
    os.remove(os.path.join(resumed, "metrics.jsonl"))
    tcli.main([*argv, f"--runtime.model_dir={resumed}"])
    want, got = _train_records(full), _train_records(resumed)
    assert sorted(got) == [5, 6, 7, 8]
    for s in got:
        assert got[s]["loss"] == want[s]["loss"], s
    a = CheckpointManager(os.path.join(full, "checkpoints")).load(8)
    b = CheckpointManager(os.path.join(resumed, "checkpoints")).load(8)
    assert (a["loader_epoch"], a["loader_batches"]) == (b["loader_epoch"], b["loader_batches"])
    for field in ("params", "model_state", "velocity", "ema"):
        for k, t in a[field].items():
            assert torch.equal(b[field][k], t), (field, k)


def test_echoed_steps_are_not_identical_replays():
    """The step's streams fold the step index, so two steps on the same
    batch draw other mixup and DropBlock randomness."""
    from axcnn_torch.models.resnet import ModelConfig
    from axcnn_torch.train.schedules import make_lr_schedule
    from axcnn_torch.train.train_step import create_train_state, make_train_step

    cfg = ModelConfig(num_classes=5, width_multiplier=0.125, use_dropblock=True,
                      dropblock_keep_prob=0.8)
    step = make_train_step(cfg, lr_schedule=make_lr_schedule(base_lr=0.1, total_steps=10,
                                                             warmup_steps=0),
                           total_steps=10, mixup_alpha=0.2, use_ema=False)
    state = create_train_state(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                               use_ema=False)
    rng = np.random.default_rng(0)
    batch = {"images": torch.from_numpy(rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)),
             "labels": torch.from_numpy(rng.integers(0, 5, 4).astype(np.int64))}
    state, m1 = step(state, batch, 1)  # step 0 -> 1
    _, m2 = step(state, batch, 1)  # step 1 on the same batch
    assert float(m1["loss"]) != float(m2["loss"])
    assert m1["mixup_lam"] != m2["mixup_lam"]
