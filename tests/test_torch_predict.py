"""The port's serving entry point, ``axcnn_torch.cli.predict``, on the CPU.

Runs the assembled preset at width 0.125 and 64x64 on two generated JPEGs
and checks the output contract the reference CLI has: one JSON line per
image with five [class, prob] pairs, probabilities descending. Each test
points ``--runtime.model_dir`` at an empty directory, so predict serves the
seeded random init; serving a checkpoint is in tests/test_torch_ckpt.py.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from axcnn_torch.cli import predict

SMALL = ["--config=assemble_resnet50", "--model.width_multiplier=0.125",
         "--data.image_size=64"]


@pytest.fixture
def small(tmp_path):
    """SMALL, reading checkpoints from an empty directory."""
    return [*SMALL, f"--runtime.model_dir={tmp_path / 'empty'}"]


@pytest.fixture
def jpegs(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate([(80, 96), (120, 70)]):
        p = tmp_path / f"img{i}.jpg"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    return paths


@pytest.fixture(autouse=True)
def _restore_tf32_flags():
    """The fp32 policy turns TF32 off process-wide; undo it after each test."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_predict_cpu_prints_top5_per_image(jpegs, small, capsys, dtype):
    rc = predict.main([*(f"--image={p}" for p in jpegs), *small, "--cpu",
                       f"--train.dtype={dtype}"])
    assert rc == 0
    lines = _lines(capsys)
    assert [line["image"] for line in lines] == jpegs
    for line in lines:
        top5 = line["top5"]
        assert len(top5) == 5
        classes = [c for c, _ in top5]
        probs = [p for _, p in top5]
        assert len(set(classes)) == 5
        assert all(isinstance(c, int) and 0 <= c < 1001 for c in classes)
        assert probs == sorted(probs, reverse=True) and 0 < sum(probs) <= 1.0 + 1e-4


def test_predict_labels_file(jpegs, small, capsys, tmp_path):
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(f"class_{i}" for i in range(1001)))
    assert predict.main([f"--image={jpegs[0]}", *small, "--cpu",
                         f"--labels={labels}"]) == 0
    (line,) = _lines(capsys)
    assert all(c.startswith("class_") for c, _ in line["top5"])


def test_predict_fp32_turns_tf32_off(jpegs, small, capsys):
    torch.backends.cudnn.allow_tf32 = True
    assert predict.main([f"--image={jpegs[0]}", *small, "--cpu",
                         "--train.dtype=fp32"]) == 0
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_predict_without_cuda_refuses_to_run_on_cpu(jpegs, small, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert predict.main([f"--image={jpegs[0]}", *small]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "--cpu" in out.err


def test_predict_usage_and_unported_export(jpegs):
    assert predict.main([]) == 2
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        predict.main([f"--image={jpegs[0]}", "--export=/nonexistent"])
