"""The port's training entry point, ``axcnn_torch.cli.main_classification``,
on the CPU, against the reference's ``axcnn.cli.main_classification``.

Both run the assembled preset at the size of tests/test_torch_train_step.py
(width 0.125, 64x64, batch 8) for 2 steps on synthetic data; the port's
metrics log must carry the reference's tags and metric keys. Every option
the port does not have yet is refused, and without CUDA the default
platform exits non-zero: nothing runs on the CPU unless asked. Checkpoints,
resume, eval-only, warm start and KD are in tests/test_torch_loop.py.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from axcnn_torch.cli import main_classification as tcli
from axcnn_torch.train.loop import REFUSED, UNPORTED, check_ported
from axcnn_torch.utils.config import parse_cli

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--config=assemble_resnet50", "--data.use_synthetic_data",
         "--train.train_steps=2", "--train.batch_size=8", "--data.image_size=64",
         "--model.width_multiplier=0.125", "--train.log_every=1",
         "--runtime.num_devices=1"]


@pytest.fixture(autouse=True)
def _restore_tf32_flags():
    """The fp32 policy turns TF32 off process-wide; undo it after each test."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _records(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _shape(records):
    """[(tag, sorted metric keys)] in log order, without the timestamps."""
    return [(r["tag"], sorted(set(r) - {"time"})) for r in records]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    model_dir = str(tmp_path_factory.mktemp("port"))
    metrics = tcli.main([*SMALL, "--runtime.platform=cpu", "--train.dtype=fp32",
                         f"--runtime.model_dir={model_dir}"])
    return metrics, _records(model_dir)


def test_cli_trains_on_cpu_and_logs_finite_losses(port_run):
    metrics, records = port_run
    train = [r for r in records if r["tag"] == "train"]
    assert [r["step"] for r in train] == [1, 2]
    assert all(torch.isfinite(torch.tensor(r["loss"])) for r in train)
    assert train[0]["lr"] == 0.0  # warmup starts at 0
    assert set(metrics) == {"top1", "top5", "loss", "count"}
    assert metrics["count"] == 4 * 8  # the synthetic eval set: 4 batches


def test_cli_log_has_the_reference_tags_and_keys(port_run, tmp_path):
    """The reference's loop on the same command writes the same records:
    one ``train`` record per step with the same metric keys, then ``eval``."""
    from axcnn.cli import main_classification as jcli

    model_dir = str(tmp_path / "jax")
    jcli.main([*SMALL, "--train.dtype=fp32", f"--runtime.model_dir={model_dir}"])
    assert _shape(port_run[1]) == _shape(_records(model_dir))


@pytest.mark.parametrize("producers", [1, 2])
def test_cli_trains_on_tfrecords(producers, tmp_path):
    """``dataset_name=custom`` on user-built TFRecords: the reference's host
    loaders (one producer, or the multi-producer loader) feed the port's
    loop; the eval counts every validation record once."""
    import numpy as np
    from PIL import Image

    from axcnn.data.build_tfrecords import write_shards

    rng = np.random.default_rng(0)
    items = {"train": [], "validation": []}
    for label, name in enumerate(("a", "b")):
        for i in range(6):
            p = str(tmp_path / f"{name}{i}.jpg")
            Image.fromarray(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)).save(p)
            items["train" if i < 4 else "validation"].append((p, label, name))
    rec = str(tmp_path / "rec")
    write_shards(items["train"], rec, "train", 2)
    write_shards(items["validation"], rec, "validation", 1)
    model_dir = str(tmp_path / "run")
    metrics = tcli.main([
        "--config=assemble_resnet50", "--model.width_multiplier=0.125",
        "--data.dataset_name=custom", f"--data.data_dir={rec}", "--data.num_classes=2",
        "--data.num_train_examples=8", "--data.num_eval_examples=4",
        "--data.image_size=32", "--data.resize_min=32", "--data.num_workers=2",
        f"--data.num_producers={producers}", "--train.batch_size=4",
        "--train.train_steps=2", "--runtime.platform=cpu",
        f"--runtime.model_dir={model_dir}"])
    assert metrics["count"] == 4
    assert [r["tag"] for r in _records(model_dir)] == ["train", "eval"]


# one command-line flag for each entry of the loop's lists of refusals
REFUSED_FLAGS = {
    "runtime.spatial_partitions > 1": "--runtime.spatial_partitions=2",
    "runtime.dcn_slices > 1": "--runtime.dcn_slices=2",
}
# options that were refused until ported; the loop now takes each
PORTED_FLAGS = {
    "data.autoaugment_device": "--data.autoaugment_device",
    "runtime.export_dir": "--runtime.export_dir=/nonexistent",
    "runtime.eval_imagenet_c": "--runtime.eval_imagenet_c",
}


def test_every_refusal_has_a_flag():
    assert set(REFUSED_FLAGS) == {what for what, _, _ in UNPORTED + REFUSED}


@pytest.mark.parametrize("what", sorted(REFUSED_FLAGS))
def test_unported_option_is_refused(what, tmp_path):
    """Not ported yet: the ROADMAP item; refused by design (``REFUSED``):
    the reason, which names its ROADMAP item too."""
    with pytest.raises(NotImplementedError, match="ROADMAP") as err:
        tcli.main([*SMALL, "--runtime.platform=cpu", REFUSED_FLAGS[what],
                   f"--runtime.model_dir={tmp_path}"])
    if what in {w for w, _, _ in UNPORTED}:
        item = {w: i for w, i, _ in UNPORTED}[what]
        assert f"{what} (item {item})" in str(err.value)
    else:
        why = {w: r for w, r, _ in REFUSED}[what]
        assert str(err.value) == f"axcnn_torch does not take {what}: {why}"
        assert "not ported" not in str(err.value)
    assert not os.listdir(tmp_path)  # refused before anything ran


@pytest.mark.parametrize("what", sorted(PORTED_FLAGS))
def test_ported_option_is_not_refused(what):
    """Options once refused until ported now pass the loop's check; only
    spatial partitioning is left unported."""
    cfg = parse_cli([*SMALL, "--runtime.platform=cpu", PORTED_FLAGS[what]])
    check_ported(cfg)
    assert [w for w, _, _ in UNPORTED] == ["runtime.spatial_partitions > 1"]


def test_unknown_platform_is_refused(tmp_path):
    with pytest.raises(ValueError, match="runtime.platform"):
        tcli.main([*SMALL, "--runtime.platform=tpu", f"--runtime.model_dir={tmp_path}"])


@pytest.mark.parametrize("platform", ["", "gpu"])
def test_default_platform_without_cuda_exits_nonzero(platform, tmp_path):
    """The card is the default: with no CUDA device the run stops with a
    message and a non-zero exit code instead of training on the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m", "axcnn_torch.cli.main_classification", *SMALL,
         f"--runtime.platform={platform}", f"--runtime.model_dir={tmp_path}"],
        cwd=REPO, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "metrics.jsonl").exists()
