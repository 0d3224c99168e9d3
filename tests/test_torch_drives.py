"""The convergence drives of the port (``axcnn_torch/drives``) against the
reference's scripts (``scripts/convergence_drive.py``,
``convergence_drive_full.py``, ``convergence_drive_scale.py``,
``ablation_drive.py``, ``kd_drive.py``), on the CPU:

- each generator writes the reference's JPEG bytes and TFRecord records
  for the same seed and sizes (``make_subset``'s noisy labels included);
- the drives' model configs equal the reference's, field for field;
- the ablation's relative-mCE summary is the reference's computation;
- each ``check`` passes the reference's recorded summaries
  (``docs/CONVERGENCE.md``) and fails just past each bar;
- each drive runs end to end through its entry point at a toy size (width
  0.125, small images, 2-3 steps a leg, ``--no-check``), the native loader
  included, and prints a summary with the reference's keys.

The drives themselves, at full width and their full budgets, run on the
card (``chip_smoke.py`` phases ``drive_convergence`` and ``drives_cut``).
"""

import dataclasses
import importlib
import io
import json
import math
import os
import pathlib
import sys

import jax
import numpy as np
import pytest
from PIL import Image

from axcnn.eval.imagenet_c import compute_mce as ref_compute_mce
from axcnn.models.resnet import ModelConfig as RefModelConfig
from axcnn_torch.data import cpp_loader
from axcnn_torch.data.tfrecord import TFRecordReader, list_shards, parse_example
from axcnn_torch.drives import ablation, common, convergence, convergence_full, data, kd
import torch_inprocess

capped_threads = torch_inprocess.capped_threads

REPO = pathlib.Path(__file__).resolve().parents[1]
# the reference scripts set these at import (a persistent compile cache)
_JAX_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture(scope="module")
def ref():
    """The reference's drive scripts as modules, with the jax settings they
    change at import restored."""
    saved = {k: getattr(jax.config, k) for k in _JAX_KEYS}
    scripts = str(REPO / "scripts")
    sys.path.insert(0, scripts)
    try:
        yield {name: importlib.import_module(name) for name in (
            "convergence_drive", "convergence_drive_full", "convergence_drive_scale",
            "kd_drive")}
    finally:
        sys.path.remove(scripts)
        for k, v in saved.items():
            jax.config.update(k, v)


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = pathlib.Path(p).read_bytes()
    return out


def _same_files(port_root, ref_root):
    port, refd = _tree(port_root), _tree(ref_root)
    assert sorted(port) == sorted(refd)
    bad = [k for k in port if port[k] != refd[k]]
    assert not bad, bad[:5]
    return port


def _same_info(port_info, ref_info):
    assert dataclasses.asdict(port_info) == dataclasses.asdict(ref_info)


# -- the generators ------------------------------------------------------------

def test_make_dataset_matches_reference(tmp_path, ref):
    out, info = data.make_dataset(str(tmp_path / "p"), n_per_class=2)
    r_out, r_info = ref["convergence_drive"].make_dataset(str(tmp_path / "r"), n_per_class=2)
    files = _same_files(tmp_path / "p", tmp_path / "r")
    assert len([k for k in files if k.endswith(".jpg")]) == 8
    assert len(list_shards(out, "train")) == 4
    _same_info(info, r_info)


@pytest.mark.parametrize("which", ["pretrain", "finetune"])
def test_make_set_matches_reference(tmp_path, ref, which):
    r = ref["convergence_drive_full"]
    if which == "pretrain":
        classes = convergence_full.pretrain_classes()
        assert classes == [(f"{h}_{o}", r.HUES[h], o) for h in r.HUES for o in ("h", "v")]
        seed = 0
    else:
        classes, seed = convergence_full.FT_CLASSES, 1
    out, info = data.make_set(str(tmp_path / "p"), classes, n_train=3, n_eval=1, seed=seed)
    r_out, r_info = r.make_set(str(tmp_path / "r"), classes, n_train=3, n_eval=1, seed=seed)
    _same_files(tmp_path / "p", tmp_path / "r")
    _same_info(info, r_info)
    # the marker: a second call returns the shards it wrote, generating nothing
    first = tmp_path / "p" / "raw" / classes[0][0] / "0.jpg"
    first.unlink()
    again = data.make_set(str(tmp_path / "p"), classes, n_train=3, n_eval=1, seed=seed)
    assert again == (out, info) and not first.exists()


def test_make_scale_set_matches_reference(tmp_path, ref):
    r = ref["convergence_drive_scale"]
    assert data.SCALE_HUES == r.HUES and data.PATTERNS == r.PATTERNS
    out, info = data.make_scale_set(str(tmp_path / "p"), n_train=2, n_eval=1, seed=0,
                                    log=lambda _: None)
    r_out, r_info = r.make_set(str(tmp_path / "r"), n_train=2, n_eval=1, seed=0)
    files = _same_files(tmp_path / "p", tmp_path / "r")
    assert len([k for k in files if k.endswith(".jpg")]) == 150
    _same_info(info, r_info)


def _full_set_stub(root, n_subset):
    """The raw tree ``make_subset`` reads from the 50-class set: the first
    ``n_subset`` images of each class and the held-out 120-143, as tiny
    JPEGs of a colour per file."""
    rng = np.random.default_rng(5)
    for h in data.SCALE_HUES:
        for k in data.PATTERNS:
            d = os.path.join(root, "raw", f"{h}_{k}")
            os.makedirs(d)
            for i in [*range(n_subset), *range(120, 144)]:
                buf = io.BytesIO()
                Image.fromarray(np.full((4, 4, 3), rng.integers(0, 256, 3), np.uint8)).save(
                    buf, "JPEG")
                pathlib.Path(d, f"{i}.jpg").write_bytes(buf.getvalue())


def _labels(directory, prefix):
    return [int(parse_example(p)["image/class/label"][0])
            for s in list_shards(directory, prefix) for p in TFRecordReader(s)]


@pytest.mark.parametrize("noise_frac", [0.0, 0.4])
def test_make_subset_matches_reference(tmp_path, ref, noise_frac):
    full = str(tmp_path / "full")
    _full_set_stub(full, 3)
    out, info = data.make_subset(full, str(tmp_path / "p"), 3, noise_frac=noise_frac)
    r_out, r_info = ref["kd_drive"].make_subset(full, str(tmp_path / "r"), 3,
                                                noise_frac=noise_frac)
    assert os.path.basename(out) == os.path.basename(r_out)
    for prefix in ("train", "validation"):
        shards, r_shards = list_shards(out, prefix), list_shards(r_out, prefix)
        assert [pathlib.Path(s).read_bytes() for s in shards] == \
            [pathlib.Path(s).read_bytes() for s in r_shards]
    _same_info(info, r_info)
    # the noisy labels: round(noise_frac * 150) of them wrong, never the true one
    true = {}
    for s in list_shards(out, "train"):
        for p in TFRecordReader(s):
            f = parse_example(p)
            name = bytes(f["image/class/text"][0]).decode()
            true_label = list(data.SCALE_HUES).index(name.split("_")[0]) * 5 + \
                data.PATTERNS.index(name.split("_")[1])
            true.setdefault("pairs", []).append((int(f["image/class/label"][0]), true_label))
    wrong = sum(lab != t for lab, t in true["pairs"])
    assert wrong == round(noise_frac * 150)
    assert sorted(_labels(out, "validation")) == sorted(np.repeat(np.arange(50), 24).tolist())


# -- configs and the mCE summary -------------------------------------------------

def _same_fields(port_cfg, ref_cfg):
    for f in dataclasses.fields(ref_cfg):
        got, want = getattr(port_cfg, f.name), getattr(ref_cfg, f.name)
        assert (tuple(got) if isinstance(got, (list, tuple)) else got) == \
            (tuple(want) if isinstance(want, (list, tuple)) else want), f.name


def test_model_configs_match_reference(ref):
    assembled = dict(resnet_size=50, use_resnet_d=True, use_se_block=True, use_sk_block=True,
                     anti_alias_type="sconv", use_dropblock=True, dropblock_keep_prob=0.9,
                     zero_gamma=True)
    # scripts/convergence_drive_full.py:172-182
    _same_fields(convergence_full.drive_model_config(),
                 ref["convergence_drive_full"].drive_model_config())
    # its fine-tune config (:222-226)
    _same_fields(dataclasses.replace(convergence_full.drive_model_config(), num_classes=4),
                 RefModelConfig(num_classes=4, bn_momentum=0.997, **assembled))
    # scripts/ablation_drive.py:157-158, with its asserts on the flags
    _same_fields(ablation.vanilla_model_config(),
                 RefModelConfig(resnet_size=50, num_classes=10, bn_momentum=0.997))
    # scripts/convergence_drive.py:80-84
    _same_fields(convergence.model_config(), RefModelConfig(num_classes=4, bn_momentum=0.9,
                                                            **assembled))


@pytest.mark.parametrize("seed", [0, 1])
def test_relative_mce_matches_reference(seed):
    rng = np.random.default_rng(seed)
    names = list(ablation.CORRUPTIONS)
    asm = {c: float(rng.uniform(0, 0.5)) for c in names}
    van = {c: float(rng.uniform(0, 0.9)) for c in names}
    van[names[0]] = 0.0  # a perfect vanilla row: the clamp
    n_eval = 600
    got = ablation.summarize({"top1": 97.5}, {"top1": 98.0}, asm, van, n_eval)
    # scripts/ablation_drive.py:192-208, unrounded
    norm = {c: max(e, 1.0 / n_eval) for c, e in van.items()}
    rel = ref_compute_mce(asm, alexnet_err=norm)
    want = {"clean_top1_assembled_ema": 97.5, "clean_top1_vanilla": 98.0,
            "mean_corruption_err_assembled": sum(asm.values()) / len(asm),
            "mean_corruption_err_vanilla": sum(van.values()) / len(van),
            "relative_mce_assembled_vs_vanilla": rel["mce"],
            "per_corruption_ce": {c: rel[f"ce/{c}"] for c in names}}
    assert got == want
    assert list(got) == list(ablation.SUMMARY_KEYS)


# -- the bars ----------------------------------------------------------------------

def _changed(summary, changes):
    """A copy of ``summary`` with each ``{"a/b": value}`` set."""
    out = json.loads(json.dumps(summary))
    for path, value in changes.items():
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node[p]
        node[last] = value
    return out


# the reference's recorded summaries (docs/CONVERGENCE.md)
RECORDED = {
    "convergence": {"raw": {"top1": 100.0, "top5": 100.0, "loss": 0.2284, "count": 256},
                    "ema": {"top1": 100.0, "top5": 100.0, "loss": 0.1913, "count": 256}},
    "convergence_full": {"pretrain_raw": {"top1": 100.0, "loss": 0.1397},
                         "pretrain_ema": {"top1": 100.0, "loss": 0.1477},
                         "ft_warm": {"top1": 100.0, "loss": 0.20},
                         "ft_cold": {"top1": 48.0, "loss": 1.05}},
    "ablation": {"clean_top1_assembled_ema": 100.0, "clean_top1_vanilla": 100.0,
                 "mean_corruption_err_assembled": 0.032, "mean_corruption_err_vanilla": 0.221,
                 "relative_mce_assembled_vs_vanilla": 12.1, "per_corruption_ce": {}},
    "kd": {"teacher_top1": 100.0, "student_steps": 600, "n_subset": 12, "noise_frac": 0.4,
           "base_lr": 0.1, "control_top1": 50.5, "kd_top1": 78.67, "control_lr0.2_top1": 21.5,
           "control_loss": 3.2004, "kd_loss": 3.0291, "control_lr0.2_loss": 3.6883,
           "kd_raw_top1": 78.25, "kd_ema_top1": 78.67},
}
DRIVES = {"convergence": convergence, "convergence_full": convergence_full,
          "ablation": ablation, "kd": kd}
# (drive, changes that sit exactly on the bars: pass, changes just past one: fail)
BARS = [
    ("convergence", {"raw/top1": 90.0, "ema/top1": 89.0}, {"raw/top1": 89.99, "ema/top1": 95.0}),
    ("convergence", {"raw/top1": 95.0, "ema/top1": 94.0}, {"raw/top1": 95.0, "ema/top1": 93.99}),
    ("convergence_full", {"pretrain_raw/top1": 90.0, "pretrain_ema/top1": 90.0},
     {"pretrain_raw/top1": 89.99, "pretrain_ema/top1": 90.0}),
    ("convergence_full", {"pretrain_raw/top1": 95.0, "pretrain_ema/top1": 94.0},
     {"pretrain_raw/top1": 95.0, "pretrain_ema/top1": 93.99}),
    ("convergence_full", {"ft_warm/top1": 85.0, "ft_cold/top1": 50.0},
     {"ft_warm/top1": 84.99, "ft_cold/top1": 50.0}),
    ("convergence_full", {"ft_warm/top1": 95.0, "ft_cold/top1": 90.0},
     {"ft_warm/top1": 95.0, "ft_cold/top1": 90.01}),
    ("ablation", {"clean_top1_assembled_ema": 99.0}, {"clean_top1_assembled_ema": 98.99}),
    ("ablation", {"mean_corruption_err_assembled": 0.2209},
     {"mean_corruption_err_assembled": 0.221}),
    ("ablation", {"relative_mce_assembled_vs_vanilla": 99.99},
     {"relative_mce_assembled_vs_vanilla": 100.0}),
    ("kd", {"teacher_top1": 90.0}, {"teacher_top1": 89.99}),
    ("kd", {"kd_top1": 50.51, "kd_ema_top1": 50.51, "kd_raw_top1": 50.51},
     {"kd_top1": 50.5, "kd_ema_top1": 50.5, "kd_raw_top1": 50.5}),
    ("kd", {"control_lr0.2_top1": 78.66}, {"control_lr0.2_top1": 78.67}),
    ("kd", {"kd_loss": 3.2003}, {"kd_loss": 3.2004}),
    ("kd", {"control_lr0.2_loss": 3.0292}, {"control_lr0.2_loss": 3.0291}),
    ("kd", {"kd_ema_top1": 77.25}, {"kd_ema_top1": 77.24}),
]


@pytest.mark.parametrize("name", sorted(RECORDED))
def test_check_passes_the_recorded_summary(name):
    DRIVES[name].check(RECORDED[name])
    assert not common.missing_keys(RECORDED[name], DRIVES[name].SUMMARY_KEYS)


@pytest.mark.parametrize("name,at,past", BARS)
def test_check_holds_each_bar(name, at, past):
    drive = DRIVES[name]
    drive.check(_changed(RECORDED[name], at))
    with pytest.raises(AssertionError):
        drive.check(_changed(RECORDED[name], past))


# -- the drives end to end, at a toy size ------------------------------------------

TOY = ["--cpu", "--no-check", "--batch=4", "--image_size=64", "--width=0.125"]


def _finite(summary, keys):
    for path in keys:
        node = summary
        for part in path.split("/"):
            node = node[part]
        assert isinstance(node, (int, float)) and math.isfinite(node), (path, node)


def _quiet(capsys):
    """The drive's last output line: its JSON summary (no OK line when the
    bars are not asserted)."""
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_toy_convergence(tmp_path, capsys):
    summary = convergence.main([str(tmp_path), *TOY, "--steps=3", "--n_per_class=2"])
    assert _quiet(capsys) == json.loads(json.dumps(summary))
    assert not common.missing_keys(summary, convergence.SUMMARY_KEYS)
    _finite(summary, convergence.SUMMARY_KEYS)
    assert summary["raw"]["count"] == summary["ema"]["count"] == 8
    assert summary["native_loader"] and summary["train"]["all_finite"]
    assert [s for s, _ in summary["train"]["logged_loss"]] == [1, 3]


def test_toy_convergence_full(tmp_path, capsys):
    argv = [str(tmp_path), *TOY, "--steps=3", "--ft_steps=2", "--num_hues=1", "--n_train=4",
            "--n_eval=2", "--ft_n_train=2", "--ft_n_eval=1"]
    summary = convergence_full.main(argv)
    _quiet(capsys)
    assert not common.missing_keys(summary, convergence_full.SUMMARY_KEYS)
    _finite(summary, convergence_full.SUMMARY_KEYS)
    assert summary["pretrain_raw"]["count"] == 4 and summary["ft_warm"]["count"] == 4
    assert all(summary["train"][leg]["all_finite"] for leg in ("pretrain", "warm", "cold"))
    # a rerun restores the kept pretrain instead of training it again
    again = convergence_full.main(argv)
    assert again["train"]["pretrain"] is None
    assert again["pretrain_raw"] == summary["pretrain_raw"]
    # and refuses a kept state of another length
    with pytest.raises(ValueError, match="trained for 3 steps"):
        convergence_full.main([*argv, "--steps=4"])


def test_toy_ablation(tmp_path, capsys):
    """Without a kept pretrain the ablation trains its assembled leg too."""
    summary = ablation.main([str(tmp_path), *TOY, "--steps=3", "--num_hues=1", "--n_train=4",
                             "--n_eval=2", "--corruptions=gaussian_noise,fog",
                             "--severities=2"])
    _quiet(capsys)
    assert not common.missing_keys(summary, ablation.SUMMARY_KEYS)
    _finite(summary, [k for k in ablation.SUMMARY_KEYS if k != "per_corruption_ce"])
    assert sorted(summary["per_corruption_ce"]) == ["fog", "gaussian_noise"]
    assert summary["train"]["assembled"]["all_finite"]
    assert summary["train"]["vanilla"]["all_finite"]
    assert os.path.exists(tmp_path / "imagenet_c" / "ok-2-gaussian_noise-fog")


def test_toy_kd_through_the_cli(tmp_path, capsys, monkeypatch):
    """Every leg is the training CLI on one device; only the KD leg gets
    the teacher."""
    commands = []
    real = common.cli_command

    def recording(args):
        commands.append(list(args))
        return real(args)

    monkeypatch.setattr(common, "cli_command", recording)
    summary = kd.main(["2", str(tmp_path / "kd"), "2", *TOY, "--batch=8", "--image_size=32",
                       "--teacher_steps=2", "--n_train=2", "--n_eval=1",
                       f"--scale_root={tmp_path / 'scale'}"])
    _quiet(capsys)
    assert not common.missing_keys(summary, kd.SUMMARY_KEYS)
    _finite(summary, kd.SUMMARY_KEYS)
    assert len(commands) == 4  # the teacher, control, kd, control_lr0.2
    tags = ["teacher", "control", "kd", "control_lr0.2"]
    for tag, args in zip(tags, commands):
        teacher = [a for a in args if a.startswith("--train.kd_teacher_checkpoint=")]
        assert bool(teacher) == (tag == "kd"), (tag, args)
        assert "--runtime.num_devices=1" in args
        assert "--data.loader=cpp" in args
    assert sorted(summary["train_loss"]) == sorted(tags)
    for tag in tags:
        assert summary["train_loss"][tag] and all(
            math.isfinite(loss) for _, loss in summary["train_loss"][tag])


# -- no fallback -------------------------------------------------------------------

def test_failed_loader_build_raises_with_its_stderr(tmp_path, monkeypatch):
    """A native loader that does not build stops the drive with the
    compiler's message; no drive falls back to the Python decoder."""
    (tmp_path / "include").mkdir()
    (tmp_path / "include" / "jpeglib.h").write_text("#error no libjpeg headers on this host\n")
    monkeypatch.setattr(cpp_loader, "_LIB", None)
    monkeypatch.setattr(cpp_loader, "_INCLUDE", str(tmp_path / "include"))
    monkeypatch.setattr(cpp_loader, "_SO_PATH", str(tmp_path / "build" / "libaxcnn_loader.so"))
    out, info = data.make_dataset(str(tmp_path / "d"), n_per_class=1)
    with pytest.raises(RuntimeError, match=r"(?s)build failed.*no libjpeg headers on this host"):
        common.native_loader(out, info, batch=2, image_size=32, train=True,
                             autoaugment_type="v0")


def test_no_card_no_fallback(monkeypatch):
    monkeypatch.setattr(common.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        common.resolve_device(None)
    assert common.resolve_device("cpu").type == "cpu"
