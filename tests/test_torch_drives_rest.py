"""The later convergence drives of the port (``axcnn_torch/drives``:
``convergence_scale``, ``finetune``, ``convergence_1k``, ``bl``,
``int8_serving``) against the reference's scripts
(``scripts/convergence_drive_scale.py``, ``finetune_drive.py``,
``convergence_drive_1k.py``, ``bl_drive.py``, ``int8_serving_drive.py``),
on the CPU:

- each generator writes the reference's JPEG bytes and TFRecord records
  for the same seed and sizes (the 1k set on a 2 x 2 x 2 subset of its
  classes, patched into both modules), and the 1k set's patterns and
  images are the reference's draw for draw;
- the drives' model configs, ``run()`` configs and CLI flag lists equal the
  reference's;
- each ``check`` passes the reference's recorded summary
  (``docs/CONVERGENCE.md``, ``docs/DESIGN.md``) and fails just past each
  bar;
- each drive runs end to end through its entry point at a toy size (width
  0.125, 32-64 px, 2-3 steps, ``--no-check``), the CLI legs as
  subprocesses, and exits with a message, not on the CPU, when no card is
  there;
- the training loader raises on a set that cannot fill one batch.

The drives at full width run on the card (``chip_smoke.py`` phase
``drives_cut_more``, and at their full budgets in calls of their own).
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
import torch
from PIL import Image

import axcnn.data.datasets as ref_datasets
import axcnn.train.loop as ref_loop
from axcnn.models.resnet import ModelConfig as RefModelConfig
from axcnn_torch.data.datasets import DatasetInfo
from axcnn_torch.data.pipeline import TFRecordImageLoader
from axcnn_torch.data.tfrecord import TFRecordReader, TFRecordWriter, list_shards, make_example
from axcnn_torch.data.tfrecord import parse_example
from axcnn_torch.drives import (acceptance, bl, common, convergence_1k, convergence_full,
                                convergence_scale, data, finetune, int8_serving, kd_probe,
                                kd_sweep)
from axcnn_torch.train.train_step import create_train_state
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
            "convergence_drive_scale", "finetune_drive", "convergence_drive_1k", "bl_drive")}
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


def _same_fields(port_cfg, ref_cfg):
    for f in dataclasses.fields(ref_cfg):
        got, want = getattr(port_cfg, f.name), getattr(ref_cfg, f.name)
        assert (tuple(got) if isinstance(got, (list, tuple)) else got) == \
            (tuple(want) if isinstance(want, (list, tuple)) else want), f.name


# -- the generators ------------------------------------------------------------

@pytest.mark.parametrize("which", ["color", "texture"])
def test_finetune_sets_match_reference(tmp_path, ref, which):
    port_fn = getattr(data, f"make_{which}_dataset")
    ref_fn = getattr(ref["finetune_drive"], f"make_{which}_dataset")
    got = port_fn(str(tmp_path / "p"), n=2)
    want = ref_fn(str(tmp_path / "r"), n=2)
    files = _same_files(tmp_path / "p", tmp_path / "r")
    assert got[1:] == want[1:] == ((4, 8) if which == "color" else (3, 6))
    assert len([k for k in files if k.endswith(".jpg")]) == got[2]
    assert len(list_shards(got[0], "train")) == 4


def test_1k_constants_match_reference(ref):
    r = ref["convergence_drive_1k"]
    assert data.HUES_1K == r.HUES and data.PATTERNS_1K == r.PATTERNS
    assert data.classes_1k() == 1000
    assert (convergence_1k.N_TRAIN, convergence_1k.N_EVAL, convergence_1k.ECHO,
            convergence_1k.BATCH, convergence_1k.IMAGE) == (r.N_TRAIN, r.N_EVAL, r.ECHO,
                                                            r.BATCH, r.IMAGE)
    assert (convergence_1k.TOP1_BAR, convergence_1k.TOP5_BAR, convergence_1k.EMA_LAG_TOL) == \
        (r.TOP1_BAR, r.TOP5_BAR, r.EMA_LAG_TOL)
    s = ref["convergence_drive_scale"]
    assert (convergence_scale.BATCH, convergence_scale.IMAGE, convergence_scale.STEPS,
            convergence_scale.ECHO) == (s.BATCH, s.IMAGE, s.STEPS, s.ECHO)
    b = ref["bl_drive"]
    assert (bl.BATCH, bl.STEPS, bl.ACC_BAR) == (b.BATCH, b.STEPS, b.ACC_BAR)
    f = ref["finetune_drive"]
    assert (finetune.STEPS, finetune.BATCH) == (f.STEPS, f.BATCH)


@pytest.mark.parametrize("kind", data.PATTERNS_1K)
def test_1k_pattern_and_image_match_reference(ref, kind):
    """Each of the ten patterns draws what the reference draws, and the
    image over it is the reference's, for several seeds (a small canvas)."""
    r = ref["convergence_drive_1k"]
    fg, bg = data.HUES_1K["orange"], data.HUES_1K["spring"]
    for seed in range(4):
        port_rng, ref_rng = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(data._pattern_mask(port_rng, kind, 64, 80),
                                      r._pattern_mask(ref_rng, kind, 64, 80))
        np.testing.assert_array_equal(data._image_1k(port_rng, fg, bg, kind, 48, 56),
                                      r._image(ref_rng, fg, bg, kind, 48, 56))
        assert port_rng.integers(1 << 30) == ref_rng.integers(1 << 30)  # same draws left


def test_make_set_1k_matches_reference(tmp_path, ref, monkeypatch):
    """On 2 x 2 hues x 2 patterns (patched into both modules, and read by
    the port's generator when called): the same JPEGs, shards and
    directories; a larger set over the same raw tree keeps the JPEGs there
    and draws only the new ones, as the reference does."""
    r = ref["convergence_drive_1k"]
    hues = {k: data.HUES_1K[k] for k in ("red", "white")}
    patterns = ("diag", "waves")
    monkeypatch.setattr(data, "HUES_1K", hues)
    monkeypatch.setattr(data, "PATTERNS_1K", patterns)
    monkeypatch.setattr(r, "HUES", hues)
    monkeypatch.setattr(r, "PATTERNS", patterns)
    assert data.classes_1k() == 8
    for n_train, n_eval in ((2, 1), (3, 1)):
        out = data.make_set_1k(str(tmp_path / "p"), n_train, n_eval, seed=0, log=lambda _: None)
        want = r.make_set_1k(str(tmp_path / "r"), n_train, n_eval, seed=0)
        assert os.path.relpath(out, tmp_path / "p") == os.path.relpath(want, tmp_path / "r") \
            == f"rec_{n_train}_{n_eval}"
    files = _same_files(tmp_path / "p", tmp_path / "r")
    assert len([k for k in files if k.endswith(".jpg")]) == 8 * 4
    labels = [int(parse_example(p)["image/class/label"][0])
              for s in list_shards(str(tmp_path / "p" / "rec_3_1"), "validation")
              for p in TFRecordReader(s)]
    assert sorted(labels) == list(range(8))  # stored 0..N-1; the CLI adds no offset
    assert len(list_shards(out, "train")) == 16 and len(list_shards(out, "validation")) == 4
    # the marker: a rerun generates nothing
    first = tmp_path / "p" / "raw" / "red_red_diag" / "0.jpg"
    first.unlink()
    assert data.make_set_1k(str(tmp_path / "p"), 3, 1, seed=0) == out and not first.exists()


# -- configs and flags -----------------------------------------------------------

ASSEMBLED = dict(resnet_size=50, use_resnet_d=True, use_se_block=True, use_sk_block=True,
                 anti_alias_type="sconv", use_dropblock=True, dropblock_keep_prob=0.9,
                 zero_gamma=True)


def test_model_configs_match_reference():
    # scripts/convergence_drive_scale.py:155-160
    _same_fields(convergence_scale.model_config(),
                 RefModelConfig(num_classes=50, bn_momentum=0.997, **ASSEMBLED))
    # scripts/finetune_drive.py:98-102
    _same_fields(finetune.model_config(3), RefModelConfig(num_classes=3, bn_momentum=0.9,
                                                          **ASSEMBLED))
    # scripts/int8_serving_drive.py:110-112
    _same_fields(int8_serving.serve_model_config(), RefModelConfig(
        resnet_size=50, num_classes=1000, use_resnet_d=True, use_se_block=True,
        use_sk_block=True, anti_alias_type="sconv"))


@pytest.mark.parametrize("preset,overrides", [("bl_resnet50", {}),
                                              ("bl_resnet50", dict(bl_alpha=0, bl_beta=0)),
                                              ("assemble_resnet50", {})])
def test_bl_probe_configs_match_reference(preset, overrides):
    """scripts/bl_drive.py:94-96: the preset's model with the set's head."""
    want = dataclasses.replace(importlib.import_module(f"axcnn.configs.{preset}")
                               .get_config().model, num_classes=50, **overrides)
    _same_fields(bl.probe_config(preset, 50, **overrides), want)


def test_finetune_run_config_matches_reference(ref, tmp_path, monkeypatch):
    """The config the reference's ``_run`` hands its ``run()``, field for
    field, and the dataset it registers."""
    captured = []
    monkeypatch.setattr(ref_loop, "run", captured.append)
    monkeypatch.setattr(ref_datasets, "DATASETS", dict(ref_datasets.DATASETS))
    for pretrained in ("", "/x/run_a/checkpoints"):
        ref["finetune_drive"]._run("/d/rec", 3, 192, "/m", pretrained=pretrained)
        got = finetune.run_config("/d/rec", 3, 192, "/m", pretrained=pretrained,
                                  device=torch.device("cuda", 0))
        want = captured[-1]
        for part in ("model", "data", "train", "runtime"):
            _same_fields(getattr(got, part), getattr(want, part))
        from axcnn_torch.data.datasets import DATASETS
        assert dataclasses.asdict(DATASETS["drive3"]) == \
            dataclasses.asdict(ref_datasets.DATASETS["drive3"])
    assert finetune.run_config("/d", 4, 8, "/m", device=torch.device("cpu")).runtime.platform \
        == "cpu"


class _Stop(Exception):
    pass


def _ref_cli_flags(module, monkeypatch, argv, make_set_name, make_set_result):
    """The flag list a reference drive's ``main`` hands its ``cli``, with
    its generator stubbed out."""
    flags = []

    def cli(args, tag, retries=2):
        flags.extend(args)
        raise _Stop

    monkeypatch.setattr(module, make_set_name, lambda *a, **k: make_set_result)
    monkeypatch.setattr(module, "cli", cli)
    monkeypatch.setattr(sys, "argv", argv)
    with pytest.raises(_Stop):
        module.main()
    return flags


def test_1k_flags_match_reference(ref, tmp_path, monkeypatch):
    root = str(tmp_path)
    want = _ref_cli_flags(ref["convergence_drive_1k"], monkeypatch, ["x", "10000", root],
                          "make_set_1k", "/d/rec")
    got = convergence_1k.cli_flags("/d/rec", os.path.join(root, "run_10000"), 10_000,
                                   24_000, 3_000)
    assert got == want


def test_bl_flags_match_reference(ref, tmp_path, monkeypatch):
    root = str(tmp_path)
    info = ref_datasets.DatasetInfo("drive50", num_classes=50, num_train=6000, num_eval=1200,
                                    train_prefix="train", eval_prefix="validation")
    want = _ref_cli_flags(ref["bl_drive"], monkeypatch, ["x", root], "make_set",
                          ("/s/rec", info))
    got = bl.cli_flags("/s/rec", DatasetInfo(**dataclasses.asdict(info)),
                       os.path.join(root, "bl_resnet50"), bl.STEPS)
    assert got == want


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


# the reference's recorded results (docs/CONVERGENCE.md; the int8 drive's
# from docs/DESIGN.md, its img/s as the TPU's order of magnitude)
RECORDED = {
    "convergence_scale": {"raw": {"top1": 100.0, "top5": 100.0, "loss": 0.3693},
                          "ema": {"top1": 100.0, "top5": 100.0, "loss": 0.3464}},
    "finetune": {"pretrain_a": {"top1": 100.0, "top5": 100.0, "loss": 0.1},
                 "finetune_warm": {"top1": 100.0, "top5": 100.0, "loss": 0.1},
                 "finetune_cold": {"top1": 100.0, "top5": 100.0, "loss": 0.1}},
    "convergence_1k": {"steps": 10_000, "echo": 4, "batch": 64, "median_img_per_sec": 364.0,
                       "raw_top1": 93.2, "raw_top5": 100.0, "raw_loss": 0.9635,
                       "ema_top1": 91.63, "ema_top5": 100.0, "ema_loss": 1.0591},
    "bl": {"bl_top1": 100.0, "bl_top5": 100.0, "bl_step_ms": 30.03, "resnet_d_step_ms": 30.44,
           "assembled_step_ms": 43.87, "bl_img_per_sec": 2131.5, "bl_vs_resnet_d": 1.01,
           "bl_vs_assembled": 1.46},
    "int8_serving": {"top1_bf16_raw": 100.0, "top1_bf16_ema": 100.0, "top1_int8_raw": 100.0,
                     "top1_int8_ema": 100.0, "top1_agreement_pct": 100.0,
                     "max_logit_dev": 0.2, **{f"infer_{p}_b{b}": 5000.0 for p in ("bf16", "int8")
                                               for b in (32, 128, 256)}},
}
DRIVES = {"convergence_scale": convergence_scale, "finetune": finetune,
          "convergence_1k": convergence_1k, "bl": bl, "int8_serving": int8_serving}
# (drive, changes that sit exactly on the bars: pass, changes just past one: fail)
BARS = [
    ("convergence_scale", {"ema/top1": 85.0, "raw/top1": 86.0},
     {"ema/top1": 84.99, "raw/top1": 85.0}),
    ("convergence_scale", {"ema/top1": 94.0, "raw/top1": 95.0},
     {"ema/top1": 93.99, "raw/top1": 95.0}),
    ("convergence_scale", {"ema/top5": 95.0}, {"ema/top5": 94.99}),
    ("finetune", {"pretrain_a/top1": 90.0}, {"pretrain_a/top1": 89.99}),
    ("finetune", {"finetune_warm/top1": 90.0, "finetune_cold/top1": 0.0},
     {"finetune_warm/top1": 89.99, "finetune_cold/top1": 100.0}),
    ("convergence_1k", {"raw_top1": 80.0, "ema_top1": 80.0},
     {"raw_top1": 79.99, "ema_top1": 80.0}),
    ("convergence_1k", {"raw_top1": 80.0, "ema_top1": 80.0},
     {"raw_top1": 80.0, "ema_top1": 79.99}),
    ("convergence_1k", {"raw_top5": 95.0}, {"raw_top5": 94.99}),
    ("convergence_1k", {"ema_top5": 95.0}, {"ema_top5": 94.99}),
    # 10,000 steps: one time constant, EMA may trail raw by 2
    ("convergence_1k", {"raw_top1": 93.0, "ema_top1": 91.0},
     {"raw_top1": 93.0, "ema_top1": 90.99}),
    # three time constants: EMA must not trail raw. In the reference's float
    # arithmetic 30,000 * (1 - 0.9999) is 2.99999999999967, below 3: the
    # tolerance drops to 0 from 30,001 steps
    ("convergence_1k", {"steps": 30_000, "raw_top1": 93.0, "ema_top1": 91.0},
     {"steps": 30_000, "raw_top1": 93.0, "ema_top1": 90.99}),
    ("convergence_1k", {"steps": 30_001, "raw_top1": 93.0, "ema_top1": 93.0},
     {"steps": 30_001, "raw_top1": 93.0, "ema_top1": 92.99}),
    ("bl", {"bl_top1": 85.0}, {"bl_top1": 84.99}),
    ("bl", {"bl_step_ms": 30.43}, {"bl_step_ms": 30.44}),
    ("int8_serving", {"max_logit_dev": 0.0}, {"max_logit_dev": float("nan")}),
    ("int8_serving", {"infer_int8_b256": 1.0}, {"infer_int8_b256": float("inf")}),
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


def test_int8_check_wants_every_key():
    """No bar of the reference's: a missing value fails, nothing else."""
    summary = dict(RECORDED["int8_serving"], top1_int8_ema=0.0, top1_agreement_pct=0.0)
    int8_serving.check(summary)
    del summary["infer_bf16_b128"]
    with pytest.raises(AssertionError, match="infer_bf16_b128"):
        int8_serving.check(summary)


# -- the drives end to end, at a toy size ------------------------------------------

TOY = ["--cpu", "--no-check", "--batch=4", "--width=0.125"]


@pytest.fixture(scope="module")
def scale_root(tmp_path_factory):
    """The 50-class set at 2 train and 1 held-out images a class."""
    root = str(tmp_path_factory.mktemp("scale"))
    data.make_scale_set(root, n_train=2, n_eval=1, seed=0, log=lambda _: None)
    return root


def _finite(summary, keys):
    for path in keys:
        node = summary
        for part in path.split("/"):
            node = node[part]
        assert isinstance(node, (int, float)) and math.isfinite(node), (path, node)


def _last_line(capsys):
    """The drive's last output line: its JSON summary (no OK line when the
    bars are not asserted)."""
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_toy_convergence_scale(scale_root, capsys):
    summary = convergence_scale.main([scale_root, *TOY, "--image_size=64", "--steps=3",
                                      "--n_train=2", "--n_eval=1"])
    assert _last_line(capsys) == json.loads(json.dumps(summary))
    assert not common.missing_keys(summary, convergence_scale.SUMMARY_KEYS)
    _finite(summary, convergence_scale.SUMMARY_KEYS)
    assert summary["raw"]["count"] == summary["ema"]["count"] == 50
    assert summary["echo"] == 2 and summary["train"]["all_finite"]
    assert [s for s, _ in summary["train"]["logged_loss"]] == [1, 3]


def test_toy_finetune_through_run(tmp_path, capsys):
    """Three ``run()`` calls; the warm one starts from A's checkpoint."""
    summary = finetune.main([str(tmp_path), *TOY, "--image_size=64", "--steps=2",
                             "--n_per_class=2"])
    _last_line(capsys)
    assert not common.missing_keys(summary, finetune.SUMMARY_KEYS)
    _finite(summary, finetune.SUMMARY_KEYS)
    assert summary["pretrain_a"]["count"] == 8 and summary["finetune_warm"]["count"] == 6
    for run_dir in ("run_a", "run_b_ft", "run_b_cold"):
        assert os.path.isdir(tmp_path / run_dir / "checkpoints")
        assert all(math.isfinite(v) for _, v in common.train_losses(str(tmp_path / run_dir)))


def test_toy_1k_through_the_cli(tmp_path, capsys, monkeypatch):
    """The 1001-way head with label offset 1 on a 2 x 2 x 2 class subset;
    the CLI leg is the literal CLI, run again on the watchdog's exit code."""
    monkeypatch.setattr(data, "HUES_1K", {k: data.HUES_1K[k] for k in ("red", "blue")})
    monkeypatch.setattr(data, "PATTERNS_1K", ("hstripe", "rings"))
    commands = []
    real = common.cli_command

    def recording(args):
        commands.append(list(args))
        return real(args)

    monkeypatch.setattr(common, "cli_command", recording)
    summary = convergence_1k.main(["3", str(tmp_path), "2", "--n_eval=1", *TOY,
                                   "--image_size=32"])
    _last_line(capsys)
    assert not common.missing_keys(summary, convergence_1k.SUMMARY_KEYS)
    _finite(summary, convergence_1k.SUMMARY_KEYS)
    assert len(commands) == 1
    args = commands[0]
    assert args[:17] == convergence_1k.cli_flags(str(tmp_path / "rec_2_1"),
                                                 str(tmp_path / "run_3_n2"), 3, 16, 8, 4)
    assert "--runtime.num_devices=1" in args and "--runtime.platform=cpu" in args
    assert summary["eval_count"] == summary["cli_eval"]["count"] == 8
    assert common.train_complete(str(tmp_path / "run_3_n2"), 3)
    # a complete run is not run again
    again = convergence_1k.main(["3", str(tmp_path), "2", "--n_eval=1", *TOY, "--image_size=32"])
    assert len(commands) == 1 and again["seconds"] is None
    assert again["raw_top1"] == summary["raw_top1"]


def test_toy_bl_through_the_cli(tmp_path, scale_root, capsys, monkeypatch):
    commands = []
    real = common.cli_command

    def recording(args):
        commands.append(list(args))
        return real(args)

    monkeypatch.setattr(common, "cli_command", recording)
    summary = bl.main([str(tmp_path), *TOY, "--image_size=32", "--steps=2", "--n_train=2",
                       "--n_eval=1", f"--scale_root={scale_root}", "--probe_steps=1"])
    _last_line(capsys)
    assert not common.missing_keys(summary, bl.SUMMARY_KEYS)
    _finite(summary, bl.SUMMARY_KEYS)
    assert len(commands) == 1 and commands[0][0] == "--config=bl_resnet50"
    assert "--data.echo_factor=2" in commands[0] and "--data.loader=cpp" in commands[0]
    assert summary["train_loss"] and all(math.isfinite(v) for _, v in summary["train_loss"])


def test_cli_reruns_on_the_hang_exit_code(tmp_path, monkeypatch):
    """Exit 42 (the watchdog's) runs the command again, up to ``retries``
    times; another failure raises with the log's tail."""
    script = tmp_path / "flaky.py"
    script.write_text("import os, sys\n"
                      "p = sys.argv[1]\n"
                      "n = int(open(p).read()) if os.path.exists(p) else 0\n"
                      "open(p, 'w').write(str(n + 1))\n"
                      "print('attempt', n + 1)\n"
                      "sys.exit(42 if n + 1 < int(sys.argv[2]) else int(sys.argv[3]))\n")
    monkeypatch.setattr(common, "cli_command", lambda args: [sys.executable, str(script), *args])
    count = tmp_path / "count"
    common.cli([str(count), "3", "0"], "t", str(tmp_path / "m"), log=lambda _: None, retries=2)
    assert count.read_text() == "3"
    count.unlink()
    with pytest.raises(RuntimeError, match=r"(?s)exit 42.*attempt 2"):
        common.cli([str(count), "9", "0"], "t", str(tmp_path / "m"), log=lambda _: None,
                   retries=1)
    count.unlink()
    with pytest.raises(RuntimeError, match="exit 3"):
        common.cli([str(count), "1", "3"], "t", str(tmp_path / "m"), log=lambda _: None,
                   retries=2)
    assert count.read_text() == "1"


def test_toy_int8_serving(tmp_path, capsys):
    """On a toy ``convergence_full`` root: its pretrain kept by
    ``cached_train``, the int8 drive's measurements; an empty root exits
    with the reference's message."""
    root = str(tmp_path / "full")
    pre_dir, info = data.make_set(os.path.join(root, "pre"), convergence_full.pretrain_classes(1),
                                  n_train=4, n_eval=2, seed=0)
    cfg = dataclasses.replace(convergence_full.drive_model_config(0.125), num_classes=2)
    common.cached_train(
        os.path.join(root, "pre_ckpt"), cfg, 2, use_ema=True, device="cpu", label="pre",
        log=lambda _: None, train_fn=lambda: convergence_full.train(
            cfg, pre_dir, info, 2, base_lr=0.05, seed=0, device="cpu", batch=4, image_size=32,
            log=lambda _: None))
    # its check (every value there and finite) asserted; the served model at
    # the pretrain's width and 32 px, batches 32, 128 and 256
    summary = int8_serving.main([root, "--cpu", "--batch=4", "--width=0.125",
                                 "--image_size=32", "--warmup_iters=1", "--iters=1"])
    assert _last_line(capsys) == json.loads(json.dumps(summary))
    _finite(summary, int8_serving.SUMMARY_KEYS)
    assert 0.0 <= summary["top1_agreement_pct"] <= 100.0
    # a kept state of another model is refused
    other = str(tmp_path / "other")
    os.makedirs(os.path.join(other, "pre"))
    os.symlink(pre_dir, os.path.join(other, "pre", "rec"))
    common.cached_train(os.path.join(other, "pre_ckpt"), dataclasses.replace(cfg, zero_gamma=False),
                        0, use_ema=True, device="cpu", label="pre", log=lambda _: None,
                        train_fn=lambda: (create_train_state(
                            dataclasses.replace(cfg, zero_gamma=False),
                            generator=torch.Generator(), device="cpu"), None))
    with pytest.raises(ValueError, match="another model than the drive's"):
        int8_serving.main([other, "--cpu"])
    with pytest.raises(SystemExit, match="no cached drive state under .*convergence_full first"):
        int8_serving.main([str(tmp_path / "empty"), "--cpu"])


# the acceptance drive and the KD diagnostics, whose bars are not in RECORDED
NO_CARD_DRIVES = {**DRIVES, "acceptance": acceptance, "kd_probe": kd_probe, "kd_sweep": kd_sweep}


@pytest.mark.parametrize("name", sorted(NO_CARD_DRIVES))
def test_no_card_no_fallback(name, tmp_path, monkeypatch):
    """Without ``--cpu`` and without a card each drive exits with a message
    before it generates or trains anything."""
    monkeypatch.setattr(common.torch.cuda, "is_available", lambda: False)
    argv = [str(tmp_path)]
    if name in ("convergence_1k", "kd_sweep"):  # [steps] [root]
        argv = ["3", str(tmp_path)]
    with pytest.raises(SystemExit, match="no CUDA device"):
        NO_CARD_DRIVES[name].main(argv)
    assert os.listdir(tmp_path) == []


# -- the loader repair -------------------------------------------------------------

@pytest.mark.parametrize("records", [3, 4])
def test_train_loader_raises_on_a_set_below_one_batch(tmp_path, records):
    """The reference's loader waits forever on such a set (it scans empty
    epochs); the port's raises, naming the count and the batch."""
    os.makedirs(tmp_path / "rec")
    with TFRecordWriter(str(tmp_path / "rec" / "train-00000-of-00001")) as w:
        for i in range(records):
            buf = io.BytesIO()
            Image.fromarray(np.full((8, 8, 3), 40 * i, np.uint8)).save(buf, "JPEG")
            w.write(make_example({"image/encoded": [buf.getvalue()],
                                  "image/class/label": [i % 2]}))
    info = DatasetInfo("tiny", 2, records, records)
    loader = TFRecordImageLoader(str(tmp_path / "rec"), info, batch_size=4, train=True,
                                 image_size=8, resize_min=8, num_workers=1)
    if records < 4:
        with pytest.raises(ValueError, match="3 training record.*one batch of 4"):
            next(iter(loader))
    else:
        it = iter(loader)
        assert [next(it)["labels"].shape for _ in range(3)] == [(4,)] * 3  # three epochs


# -- chip_smoke.py's drives_cut_more, rehearsed where it runs without a card ---------

def test_chip_smoke_cut_more_sets_and_launches():
    """Every cut training set fills a batch of 64 (a smaller one would stop
    the loader), and the launch arithmetic gives what an H100 counted on the
    phase's legs: a step 3 + 3 BlurPool and 9 + 9 DropBlock launches, 3
    BlurPool forwards an eval batch, none for ``bl_resnet50``."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(REPO))
    sets = cs._cut_more_sets()
    assert sets == {"scale": 600, "finetune_colors": 88, "finetune_textures": 66, "1k": 1000}
    assert min(sets.values()) >= cs.DRIVE_BATCH
    got = {k: (v["fwd"], v["bwd"], v["fused"], v["apply_bwd"], v["mask"], v["apply"])
           for k, v in cs._cut_more_launches().items()}
    assert got == {"scale": (72, 60, 180, 180, 0, 0),  # 20 steps, 2 x 2 eval batches
                   "finetune": (63, 45, 135, 135, 0, 0),  # 3 x 5 steps, 2 + 2 + 2 batches
                   "1k_cli": (78, 30, 90, 90, 0, 0),  # 10 steps, 16 eval batches
                   "1k": (96, 0, 0, 0, 0, 0),  # raw and EMA, 16 batches each
                   "bl_cli": (0, 0, 0, 0, 0, 0),
                   "bl": (30, 30, 90, 90, 0, 0),  # the assembled probe, 5 + 5 steps
                   "int8": (162, 0, 0, 0, 0, 0)}  # (4 + 2) x 2 eval batches + 2 x 3 x 7
