"""The KD drive's diagnostics (``axcnn_torch/drives/kd_probe.py`` and
``kd_sweep.py``) against the reference's ``scripts/kd_probe.py`` and
``scripts/kd_sweep.py``, on the CPU:

- the probe's statistics against the reference's formulas (its
  ``report``, written here in ``jnp``) on seeded fp32 logits, the logits'
  standard deviation with ddof 0; its mixed batch against the reference's;
- the sweep's three legs' flags and results against the reference's
  ``main`` (its runner, generators and eval reader stubbed);
- a toy probe over a toy-width teacher checkpoint, and a toy sweep at one
  step a leg (its CLI legs in this process).

At full width both run on the card (``chip_smoke.py`` phase
``kd_diag_cut``, and at their full budgets after the KD drive's teacher).
"""

import dataclasses
import importlib
import json
import math
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import axcnn.data.datasets as ref_datasets
from axcnn_torch.ckpt.checkpoint import CheckpointManager
from axcnn_torch.drives import common, data, kd_probe, kd_sweep
from axcnn_torch.drives.convergence_scale import model_config
from axcnn_torch.train.train_step import create_train_state

import torch_inprocess

capped_threads = torch_inprocess.capped_threads

REPO = pathlib.Path(__file__).resolve().parents[1]
# the reference scripts set these at import (a persistent compile cache)
_JAX_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")


def _ref_report(lg, labels):
    """``scripts/kd_probe.py:64-74``'s statistics."""
    p = jax.nn.softmax(lg.astype(jnp.float32), -1)
    return {"top1": float(jnp.mean((jnp.argmax(lg, -1) == labels).astype(jnp.float32))),
            "mean_maxp": float(jnp.mean(jnp.max(p, -1))),
            "mean_entropy": float(jnp.mean(-jnp.sum(p * jnp.log(p + 1e-9), -1))),
            "logit_std": float(jnp.mean(jnp.std(lg.astype(jnp.float32), -1)))}


@pytest.mark.parametrize("rows,classes,scale", [(64, 50, 3.0), (7, 4, 1.0), (16, 50, 20.0)])
def test_probe_stats_match_reference(rows, classes, scale):
    rng = np.random.default_rng(rows)
    logits = (rng.standard_normal((rows, classes)) * scale).astype(np.float32)
    labels = rng.integers(0, classes, rows).astype(np.int32)
    labels[: rows // 2] = logits[: rows // 2].argmax(-1)  # some right, some wrong
    got = kd_probe.stats(torch.from_numpy(logits), torch.from_numpy(labels).long())
    want = _ref_report(jnp.asarray(logits), jnp.asarray(labels))
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6 * max(1.0, abs(want[k])), (k, got[k], want[k])
    if classes == 4:  # ddof 1 would be sqrt(4 / 3) ~ 15% larger
        ddof1 = float(torch.std(torch.from_numpy(logits), -1, correction=1).mean())
        assert abs(ddof1 - want["logit_std"]) > 0.1 * want["logit_std"]


def test_mixed_batch_matches_reference():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (5, 6, 7, 3), dtype=np.uint8)
    got = kd_probe.mixed(torch.from_numpy(images)).numpy()
    img = jnp.asarray(images, jnp.float32)
    want = 0.7 * img + (1 - 0.7) * img[::-1]  # scripts/kd_probe.py:99-101
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    assert got.dtype == np.float32 and kd_probe.MIX_LAM == 0.7


@pytest.fixture(scope="module")
def ref_sweep():
    saved = {k: getattr(jax.config, k) for k in _JAX_KEYS}
    scripts = str(REPO / "scripts")
    sys.path.insert(0, scripts)
    try:
        yield importlib.import_module("kd_sweep")
    finally:
        sys.path.remove(scripts)
        for k, v in saved.items():
            jax.config.update(k, v)


RESULT = {"top1": 83.8, "top5": 99.0, "loss": 1.23456, "count": 1200.0}


def test_sweep_legs_match_reference(ref_sweep, monkeypatch, tmp_path):
    info = dict(name="kd_rec_sub12", num_classes=50, num_train=600, num_eval=1200,
                train_prefix="train", eval_prefix="validation")
    ref_calls, ref_root = [], "/tmp/axcnn_kd"
    with monkeypatch.context() as m:
        m.setattr(ref_sweep, "cli", lambda args, tag: ref_calls.append((tag, list(args))))
        m.setattr(ref_sweep, "make_set", lambda *a, **k: None)
        m.setattr(ref_sweep, "make_subset", lambda full_root, root, n: (
            os.path.join(root, f"rec_sub{n}"), ref_datasets.DatasetInfo(**info)))
        m.setattr(ref_sweep, "last_eval", lambda model_dir: dict(RESULT))
        m.setattr(ref_sweep.os.path, "isdir", lambda p: False)
        m.setattr(sys, "argv", ["kd_sweep.py", "600"])
        ref_sweep.main()
    root = str(tmp_path / "kd")
    os.makedirs(os.path.join(root, "teacher", "checkpoints"))
    calls, subsets = [], []

    def make_subset(full_root, out_root, n, **kw):
        subsets.append((n, kw))
        return os.path.join(out_root, f"rec_sub{n}"), data.DatasetInfo(**info)

    monkeypatch.setattr(kd_sweep, "make_scale_set", lambda *a, **k: None)
    monkeypatch.setattr(kd_sweep, "make_subset", make_subset)
    monkeypatch.setattr(common, "cli", lambda args, tag, model_dir, log=print: calls.append(
        (tag, list(args))))
    monkeypatch.setattr(common, "last_eval", lambda model_dir: dict(RESULT))
    out = kd_sweep.run(600, root, device="cuda", log=lambda _: None)
    # the clean subset: no label noise
    assert subsets == [(12, {"n_train": 120, "n_eval": 24})]
    assert [t for t, _ in calls] == [t for t, _ in ref_calls] == ["half_lr", "alpha.3", "temp2"]
    for (_, got), (_, want) in zip(calls, ref_calls):
        assert got == [a.replace(ref_root, root) for a in want] + ["--runtime.num_devices=1"]
    assert {t: {**r, "top1": round(r["top1"], 2), "loss": round(r["loss"], 4)}
            for t, r in out.items()} == json.loads(json.dumps(_ref_out(ref_sweep)))


def _ref_out(ref_sweep):
    legs = {"half_lr": (1.0, 1.0, 0.1), "alpha.3": (1.0, 0.3, 0.2), "temp2": (2.0, 1.0, 0.2)}
    assert [(t, (h["kd_temp"], h["kd_alpha"], h["base_lr"])) for t, h in kd_sweep.LEGS] == \
        list(legs.items())
    return {t: {"top1": 83.8, "loss": 1.2346, "kd_temp": T, "kd_alpha": a, "base_lr": lr}
            for t, (T, a, lr) in legs.items()}


def test_sweep_exits_without_the_teacher(tmp_path):
    with pytest.raises(SystemExit, match="no teacher under .*drives.kd"):
        kd_sweep.main(["2", str(tmp_path), "--cpu"])
    assert os.listdir(tmp_path) == []


# -- toy runs ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kd_root(tmp_path_factory):
    """A KD drive root with an untrained toy-width teacher (the assembled
    R50 at width 0.125, 50 classes, its ``model_config.json``), and the
    50-class set at 12 train (the sweep's subset takes 12) and 1 held-out
    image a class."""
    root = tmp_path_factory.mktemp("kd")
    cfg = model_config(0.125)
    state = create_train_state(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                               use_ema=True)
    mgr = CheckpointManager(str(root / "teacher" / "checkpoints"),
                            model_config=json.loads(json.dumps(dataclasses.asdict(cfg))))
    mgr.save(state, force=True)
    mgr.close()
    data.make_scale_set(str(root / "scale"), n_train=12, n_eval=1, seed=0, log=lambda _: None)
    return root


SIZES = ["--n_train=12", "--n_eval=1"]


def test_toy_probe(kd_root, capsys):
    summary = kd_probe.main([str(kd_root), "--cpu", "--no-check", "--batch=4", *SIZES,
                             f"--scale_root={kd_root / 'scale'}"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
    assert list(summary) == ["eval/clean", "eval/clean2", "train/aug0", "train/aug1",
                             "train/mixup0.7 (vs label_a)"]
    for s in summary.values():
        assert sorted(s) == ["logit_std", "mean_entropy", "mean_maxp", "top1"]
        assert all(math.isfinite(v) for v in s.values())
        assert 0.0 <= s["top1"] <= 1.0 and 0.0 < s["mean_maxp"] <= 1.0
    with pytest.raises(AssertionError, match="teacher broken"):
        kd_probe.check({"eval/clean2": {"top1": 0.9}})
    kd_probe.check({"eval/clean2": {"top1": 0.91}})


def test_toy_sweep(kd_root, capsys, monkeypatch):
    """One step a leg, width 0.125, 32x32, b16 (four eval batches); the
    CLI legs in this process; a leg with its checkpoints is not run
    again."""
    monkeypatch.setattr(common.subprocess, "run", torch_inprocess.run)
    argv = ["1", str(kd_root), "--cpu", "--batch=16", "--width=0.125", "--image_size=32", *SIZES,
            f"--scale_root={kd_root / 'scale'}"]
    out = kd_sweep.main(argv)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert list(out) == ["half_lr", "alpha.3", "temp2"]
    for tag, hp in kd_sweep.LEGS:
        assert out[tag] == {**out[tag], **hp}
        assert math.isfinite(out[tag]["top1"]) and math.isfinite(out[tag]["loss"])
        losses = common.train_losses(str(kd_root / f"sweep_{tag}_1"))
        assert losses and all(math.isfinite(v) for _, v in losses)
    assert os.path.exists(kd_root / "rec_sub12" / "ok-12-1")
    calls = []
    monkeypatch.setattr(common, "cli", lambda *a, **k: calls.append(a))
    assert kd_sweep.main(argv) == out and calls == []
