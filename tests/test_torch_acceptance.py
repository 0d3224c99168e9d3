"""The recipes (``axcnn_torch/cli/recipes.py``) and the BASELINE acceptance
drive (``axcnn_torch/drives/acceptance.py``) against the reference's
``scripts/*.sh`` and ``scripts/acceptance_drive.py``, on the CPU:

- each recipe hands the training CLI the argv its script hands
  ``python -m axcnn.cli.main_classification`` (the script run under bash
  with a ``python`` that prints its arguments), and a missing positional
  exits 1 in both;
- the drive's commands, leg by leg, are the reference's (its ``main`` run
  with its generator, runner and eval readers stubbed), up to the
  substitutions the drive's docstring lists, at the full size and at a cut;
- each bar holds at its edge and fails just past it, and the reference's
  recorded run (docs/PARITY.md) passes;
- ``train_final_eval`` reads the training's final eval where ``last_eval``
  reads a later ``eval_only`` record; the probe images; the CLI takes a
  repeated flag's last occurrence, as the reference's does;
- the whole drive runs at a toy size through its entry point (its CLI legs
  in this process, config 5 on one rank, the export without its trace);
- ``chip_smoke.py``'s launch arithmetic for ``acceptance_cut`` and
  ``kd_diag_cut``.

The drive at full width runs on the card (``chip_smoke.py`` phase
``acceptance_cut``, and at its full budget in a call of its own).
"""

import importlib
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import pytest
import torch

import axcnn.data.datasets as ref_datasets
from axcnn.utils.config import parse_cli as ref_parse_cli
from axcnn_torch.ckpt import export
from axcnn_torch.cli import main_classification, recipes
from axcnn_torch.data.datasets import DatasetInfo
from axcnn_torch.drives import acceptance, common
from axcnn_torch.train import loop
from axcnn_torch.utils.config import parse_cli

import torch_inprocess

capped_threads = torch_inprocess.capped_threads

REPO = pathlib.Path(__file__).resolve().parents[1]
# the reference scripts set these at import (a persistent compile cache)
_JAX_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
REF_SCALE_ROOT = "/tmp/axcnn_convergence_scale"  # the reference's, a string here only


@pytest.fixture(scope="module")
def ref_drive():
    """The reference's ``scripts/acceptance_drive.py`` as a module, with the
    jax settings the scripts change at import restored."""
    saved = {k: getattr(jax.config, k) for k in _JAX_KEYS}
    scripts = str(REPO / "scripts")
    sys.path.insert(0, scripts)
    try:
        yield importlib.import_module("acceptance_drive")
    finally:
        sys.path.remove(scripts)
        for k, v in saved.items():
            jax.config.update(k, v)


# -- the recipes -----------------------------------------------------------------

# recipe: (its positionals, flags passed through)
RECIPE_ARGS = {
    "train_assemble_from_scratch": (["/data/rec", "/runs/a b"],
                                    ["--train.train_steps=5", "--data.dataset_name=custom"]),
    "eval": (["/data/rec", "/runs/a"], ["--train.use_ema", "--train.batch_size=256"]),
    "train_vanilla_from_scratch": (["/data/rec", "/runs/v"], []),
    "train_assemble_resnet152_kd": (["/data/rec", "/runs/kd", "/runs/a/checkpoints"],
                                    ["--train.grad_accum_steps=8"]),
    "finetune_fgvc": (["food101", "/data/food", "/runs/ft", "/runs/a/checkpoints"],
                      ["--train.batch_size=64"]),
    "eval_imagenet_c": (["/data/imagenet_c", "/runs/a"], ["--train.batch_size=128"]),
}


def _script_argv(tmp_path, recipe, args):
    """(exit code, the arguments ``scripts/<recipe>.sh`` gives ``python``):
    the script under bash with a ``python`` first on PATH that prints each
    argument on a line of its own."""
    shim = tmp_path / "bin" / "python"
    if not shim.exists():
        shim.parent.mkdir()
        shim.write_text('#!/bin/sh\nfor a in "$@"; do printf "%s\\n" "$a"; done\n')
        shim.chmod(0o755)
    r = subprocess.run(["bash", str(REPO / "scripts" / f"{recipe}.sh"), *args],
                       capture_output=True, text=True,
                       env=dict(os.environ, PATH=f"{shim.parent}:{os.environ['PATH']}"))
    return r.returncode, r.stdout.splitlines()


@pytest.mark.parametrize("recipe", sorted(RECIPE_ARGS))
def test_recipe_argv_is_the_scripts(tmp_path, recipe, monkeypatch, capsys):
    positionals, flags = RECIPE_ARGS[recipe]
    code, got = _script_argv(tmp_path, recipe, [*positionals, *flags])
    assert code == 0
    want = [a.replace("axcnn_torch.cli.", "axcnn.cli.") for a in
            ["-m", "axcnn_torch.cli.main_classification",
             *recipes.recipe_argv(recipe, [*positionals, *flags])]]
    assert got == want
    # the entry point hands that argv to the CLI in this process
    seen = []
    monkeypatch.setattr(main_classification, "main", seen.append)
    recipes.main([recipe, *positionals, *flags])
    assert seen == [want[2:]]
    # a missing positional, and an empty one: exit 1 with the usage line
    for short in (positionals[:-1], [*positionals[:-1], ""]):
        code, _ = _script_argv(tmp_path, recipe, short)
        assert code == 1
        with pytest.raises(SystemExit) as e:
            recipes.main([recipe, *short])
        assert e.value.code == 1
        assert capsys.readouterr().err.strip() == recipes.usage(recipe)


def test_recipes_name_each_script():
    assert sorted(recipes.RECIPES) == sorted(p.stem for p in (REPO / "scripts").glob("*.sh"))
    with pytest.raises(SystemExit) as e:
        recipes.main(["no_such_recipe", "/d", "/m"])
    assert e.value.code == 1


def test_last_flag_wins_as_in_the_reference():
    """Config 5 passes ``--data.echo_factor=2`` then ``=1``; config 4's
    recipe call ends with a second ``--data.dataset_name=custom``."""
    argv = ["--config=assemble_resnet152_kd", "--data.dataset_name=imagenet",
            "--data.echo_factor=2", "--train.batch_size=64", "--data.echo_factor=1",
            "--data.dataset_name=custom", "--train.batch_size=16"]
    got, want = parse_cli(argv), ref_parse_cli(argv)
    assert (got.data.echo_factor, got.data.dataset_name, got.train.batch_size) == (1, "custom", 16)
    assert (want.data.echo_factor, want.data.dataset_name, want.train.batch_size) == (1, "custom",
                                                                                       16)


# -- the drive's command lines against the reference's -------------------------------

EVAL = {"top1": 99.0, "top5": 100.0, "loss": 0.1, "count": 1200.0, "step": 900}
PROBE_WANT = [acceptance.class_label(h, p) for h, p in acceptance.PROBE_CLASSES]


def _top5(label):
    return [[label, 0.96], [label + 1, 0.01], [label + 2, 0.01], [label + 3, 0.01],
            [label + 4, 0.01]]


def _predict_lines(args):
    """Well-formed, right predictions for a predict command's images."""
    images = [a for a in args if a.startswith("--image=")]
    if len(images) == 1:  # the export's probe
        return [{"image": images[0], "top5": _top5(0)}]
    return [{"image": i, "top5": _top5(w)} for i, w in zip(images, PROBE_WANT)]


def _ref_commands(ref_drive, monkeypatch, root):
    """The reference's legs, in order, as (tag, command)."""
    info = ref_datasets.DatasetInfo("drive50", num_classes=50, num_train=6000, num_eval=1200,
                                    train_prefix="train", eval_prefix="validation")
    for d in ("config4_assembled/export", "config5_kd_virtual8"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    (pathlib.Path(root) / "config4_assembled" / "export" / "serving").write_text("")
    (pathlib.Path(root) / "config5_kd_virtual8" / "metrics.jsonl").write_text(
        json.dumps({"tag": "train", "step": 3, "loss": 4.0}) + "\n")
    commands = []

    def run_cmd(cmd, tag, env_extra=None, capture=False, retries=2):
        commands.append((tag, list(cmd)))
        if capture:
            return "\n".join(json.dumps(r) for r in _predict_lines(cmd)) + "\n"

    monkeypatch.setattr(ref_drive, "make_set", lambda *a, **k: ("/data/rec", info))
    monkeypatch.setattr(ref_drive, "run_cmd", run_cmd)
    monkeypatch.setattr(ref_drive, "training_done", lambda *a, **k: False)
    monkeypatch.setattr(ref_drive, "train_final_eval", lambda *a, **k: dict(EVAL))
    monkeypatch.setattr(ref_drive, "last_eval", lambda *a, **k: dict(EVAL))
    monkeypatch.setattr(sys, "argv", ["acceptance_drive.py", root])
    ref_drive.main()
    return commands


def _port_commands(monkeypatch, root, scale_root, **kw):
    """The port's legs, in order, as (tag, command), and its summary."""
    info = DatasetInfo("drive50", num_classes=50, num_train=6000, num_eval=1200,
                       train_prefix="train", eval_prefix="validation")
    os.makedirs(os.path.join(root, "config4_assembled", "export"))
    (pathlib.Path(root) / "config4_assembled" / "export" / "serving").write_text("")
    commands = []

    def run_logged(cmd, tag, log_path, log=print, retries=0):
        assert retries == 2 and log_path.endswith(f"{tag}.log")
        commands.append((tag, list(cmd)))
        return 1.0

    def predict(args, tag, log=print):
        commands.append((tag, common.predict_command(args)))
        return _predict_lines(args)

    monkeypatch.setattr(acceptance, "make_scale_set", lambda *a, **k: ("/data/rec", info))
    monkeypatch.setattr(common, "run_logged", run_logged)
    monkeypatch.setattr(common, "predict", predict)
    monkeypatch.setattr(common, "train_complete", lambda *a, **k: False)
    monkeypatch.setattr(common, "train_final_eval", lambda *a, **k: dict(EVAL))
    monkeypatch.setattr(common, "last_eval", lambda *a, **k: dict(EVAL))
    monkeypatch.setattr(common, "train_losses", lambda *a, **k: [[3, 4.0]])
    summary = acceptance.run(root, scale_root=scale_root, log=lambda _: None, **kw)
    return commands, summary


CARD_LEGS = ("config4", "config3", "config2-setup", "config2", "config1-setup")


def _substituted(ref_cmds, ref_root, root, scale_root, *, device, width=1.0, image_size=224,
                 steps=900, batch=64, n_train=120, n_eval=24, kd_ranks=8):
    """The reference's legs under the substitutions of the drive's
    docstring."""
    run_flags = common.cli_run_flags(torch.device(device), width=width, image_size=image_size,
                                     full_size=224)
    size_flags = common.cli_size_flags(width=width, image_size=image_size, full_size=224)
    probes = {"/121.jpg": f"/{acceptance.probe_index(n_train, n_eval, 1)}.jpg",
              "/130.jpg": f"/{acceptance.probe_index(n_train, n_eval, 10)}.jpg"}
    out = []
    for tag, cmd in ref_cmds:
        if cmd[0] == "bash":
            cmd = [sys.executable, "-m", "axcnn_torch.cli.recipes",
                   pathlib.Path(cmd[1]).stem, *cmd[2:]]
        new = []
        for a in cmd:
            a = a.replace("axcnn.cli.", "axcnn_torch.cli.").replace(ref_root, root)
            a = a.replace(REF_SCALE_ROOT, scale_root)
            a = {"--train.batch_size=64": f"--train.batch_size={batch}",
                 "--train.train_steps=900": f"--train.train_steps={steps}",
                 "--runtime.num_devices=8": f"--runtime.num_devices={kd_ranks}"}.get(a, a)
            for old, probe in probes.items():
                a = a.replace(old, probe) if a.startswith("--image=") else a
            new.append(a)
        if tag in CARD_LEGS:
            new += run_flags
        elif tag == "config1":
            new += size_flags
        elif tag == "config4-export" and device == "cpu":
            new.append("--cpu")
        elif tag == "config5":
            new += common.cli_size_flags(width=width, image_size=64, full_size=64)
        out.append((tag, new))
    return out


CUTS = {"full": dict(device="cuda"),
        "cut": dict(device="cpu", width=0.25, image_size=64, steps=3, batch=8, n_train=12,
                    n_eval=2, kd_ranks=2)}


@pytest.mark.parametrize("cut", sorted(CUTS))
def test_commands_match_reference(ref_drive, monkeypatch, tmp_path, cut):
    ref_root, root = str(tmp_path / "ref"), str(tmp_path / "port")
    scale_root = str(tmp_path / "scale")
    with monkeypatch.context() as m:
        ref_cmds = _ref_commands(ref_drive, m, ref_root)
    kw = CUTS[cut]
    got, summary = _port_commands(monkeypatch, root, scale_root, **kw)
    want = _substituted(ref_cmds, ref_root, root, scale_root, **kw)
    assert [t for t, _ in got] == [t for t, _ in want] == list(
        ("config4", "config4-export", "config3", "config2-setup", "config2", "config1-setup",
         "config1", "config5"))
    for (tag, g), (_, w) in zip(got, want):
        assert g == w, tag
    assert not common.missing_keys(summary, acceptance.SUMMARY_KEYS)
    assert summary["config1"]["predict_correct"] == "5/5"


def test_summary_keys_are_the_references():
    """The summary keys the reference's ``main`` builds (its source)."""
    src = (REPO / "scripts" / "acceptance_drive.py").read_text()
    for path in acceptance.SUMMARY_KEYS:
        assert f'"{path.split("/")[1]}"' in src, path


# -- the bars ------------------------------------------------------------------------

def _recorded():
    """The reference's recorded run (docs/PARITY.md, round 4)."""
    return {"config4": {"top1": 99.17, "top5": 100.0, "loss": 0.3, "export_top1_ok": True,
                        "export_top5": _top5(0), "export_files": 3},
            "config3": {"top1": 99.17, "count": 1200},
            "config2": {"top1": 97.75, "count": 1200},
            "config1": {"predict_correct": "5/5", "train_top1": 99.0,
                        "top5": [_top5(w) for w in PROBE_WANT], "want": list(PROBE_WANT)},
            "config5": {"steps": 1, "finite": True, "eval_count": 1200,
                        "on_chip_evidence": "axcnn_torch/drives/kd.py"},
            "held_out": 1200}


def _changed(summary, changes):
    out = json.loads(json.dumps(summary))
    for path, value in changes.items():
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node[p]
        node[last] = value
    return out


def _probs(*ps, label=0):
    return [[label + i, p] for i, p in enumerate(ps)]


# (changes that sit exactly on a bar: pass, changes just past it: fail)
BARS = [
    ({"config4/top1": 85.0, "config3/top1": 85.0}, {"config4/top1": 84.99, "config3/top1": 84.99}),
    ({"config4/export_files": 1}, {"config4/export_files": 0}),
    ({"config4/export_top1_ok": True}, {"config4/export_top1_ok": False}),
    ({"config4/top1": 99.0, "config3/top1": 98.5}, {"config4/top1": 99.0, "config3/top1": 98.49}),
    ({"config4/top1": 99.0, "config3/top1": 99.5}, {"config4/top1": 99.0, "config3/top1": 99.51}),
    ({"config3/count": 1200}, {"config3/count": 1199}),
    ({"config2/top1": 85.0}, {"config2/top1": 84.99}),
    ({"config2/count": 1200}, {"config2/count": 1201}),
    ({"config1/train_top1": 85.0}, {"config1/train_top1": 84.99}),
    ({"config1/top5/0": _probs(0.3, 0.05, 0.05, 0.05, 0.05)},
     {"config1/top5/0": _probs(0.29, 0.05, 0.05, 0.05, 0.05)}),
    ({"config1/top5/0": _probs(0.9, 0.1, 0.0001, 0.0, 0.0)},
     {"config1/top5/0": _probs(0.9, 0.1, 0.0002, 0.0, 0.0)}),
    ({"config1/top5/0": _probs(1.0, 0.0, 0.0, 0.0, 0.0)},
     {"config1/top5/0": _probs(0.9, 0.1, 0.0, 0.0, -0.00001)}),
    ({"config1/top5/0": _probs(0.5, 0.2, 0.2, 0.05, 0.05)},
     {"config1/top5/0": _probs(0.5, 0.2, 0.05, 0.2, 0.05)}),
    ({"config1/top5/4": _top5(PROBE_WANT[4])}, {"config1/top5/4": _top5(PROBE_WANT[4] + 1)}),
    ({"config5/steps": 1}, {"config5/steps": 0}),
    ({"config5/finite": True}, {"config5/finite": False}),
]


def test_check_passes_the_recorded_run():
    acceptance.check(_recorded())
    assert not common.missing_keys(_recorded(), acceptance.SUMMARY_KEYS)


@pytest.mark.parametrize("at,past", BARS)
def test_check_holds_each_bar(at, past):
    def changed(changes):
        out = _recorded()
        for path, value in changes.items():
            if path.startswith("config1/top5/"):
                out["config1"]["top5"][int(path.rsplit("/", 1)[1])] = value
            else:
                out = _changed(out, {path: value})
        return out

    acceptance.check(changed(at))
    with pytest.raises(AssertionError):
        acceptance.check(changed(past))


def test_train_final_eval_against_last_eval(ref_drive, tmp_path):
    """A rerun appends config 3's eval_only record after config 4's final
    eval: the training's own eval is the first at its last step."""
    recs = [{"tag": "train", "step": 450, "loss": 1.0},
            {"tag": "eval", "step": 450, "top1": 80.0},
            {"tag": "train", "step": 900, "loss": 0.5},
            {"tag": "eval", "step": 900, "top1": 99.17},
            {"tag": "eval", "step": 900, "top1": 98.5}]
    (tmp_path / "metrics.jsonl").write_text("".join(json.dumps(r) + "\n" for r in recs))
    d = str(tmp_path)
    assert common.train_final_eval(d, 900) == ref_drive.train_final_eval(d, 900) == recs[3]
    assert common.last_eval(d) == ref_drive.last_eval(d) == recs[4]
    assert common.train_complete(d, 900) == ref_drive.training_done(d, 900) is True
    with pytest.raises(AssertionError, match="no final training eval"):
        common.train_final_eval(d, 901)
    assert common.train_complete(d, 901) == ref_drive.training_done(d, 901) is False


@pytest.mark.parametrize("n_train,n_eval,want", [(120, 24, (121, 130)), (12, 2, (13, 13)),
                                                  (2, 1, (2, 2)), (20, 11, (21, 30))])
def test_probe_indices_lie_in_the_held_out_split(n_train, n_eval, want):
    got = tuple(acceptance.probe_index(n_train, n_eval, k) for k in (1, 10))
    assert got == want
    assert all(n_train <= i < n_train + n_eval for i in got)


def test_probe_labels_are_the_references(ref_drive):
    hue_idx = {h: i for i, h in enumerate(ref_drive.HUES)}
    pat_idx = {p: i for i, p in enumerate(ref_drive.PATTERNS)}
    assert PROBE_WANT == [hue_idx[h] * len(ref_drive.PATTERNS) + pat_idx[p]
                          for h, p in acceptance.PROBE_CLASSES] == [0, 7, 13, 24, 26]
    assert (acceptance.ACC_BAR, acceptance.BATCH, acceptance.STEPS) == (
        ref_drive.ACC_BAR, ref_drive.BATCH, ref_drive.TRAIN_STEPS)


# -- the drive end to end, at a toy size ---------------------------------------------


def _eager_export(path, cfg, model, *, batch_size=8, image_size=224, policy=None, mean=None,
                  std=None):
    """``export_serving`` without its ``torch.export`` trace: the serving
    module saved whole."""
    os.makedirs(path, exist_ok=True)
    torch.save(export.ServingModule(model, policy, mean, std).eval(),
               os.path.join(path, "serving_module.pt"))
    with open(os.path.join(path, export.CONFIG_FILE), "w") as f:
        json.dump({"batch_size": batch_size, "image_size": image_size}, f)
    return path


def _eager_load(path, device=None):
    """``load_serving`` of an ``_eager_export``."""
    module = torch.load(os.path.join(path, "serving_module.pt"), weights_only=False)
    with open(os.path.join(path, export.CONFIG_FILE)) as f:
        meta = json.load(f)

    def fn(images_u8):
        with torch.inference_mode():
            return module(torch.as_tensor(images_u8))

    return fn, meta


def test_toy_drive(tmp_path, capsys, monkeypatch):
    """Every leg at width 0.125 and 32x32 (config 5 at 64x64), 2 steps, 2
    train and 1 held-out image a class; the CLI legs in this process. For
    Tier-1's minutes under parallel workers, config 5 runs on one rank (its
    Gloo ranks and their eval: ``tests/test_torch_parallel.py``, and 8 ranks
    in ``chip_smoke.py`` ``acceptance_cut``) and config 4's export is the
    serving module saved whole (the ``torch.export`` trace and reload,
    ~20 s here: ``tests/test_torch_export.py``, and on the card)."""
    monkeypatch.setattr(common.subprocess, "run", torch_inprocess.run)
    monkeypatch.setattr(loop, "export_serving", _eager_export)
    monkeypatch.setattr(export, "load_serving", _eager_load)
    root, scale = tmp_path / "acc", tmp_path / "scale"
    summary = acceptance.main([str(root), "--cpu", "--no-check", "--batch=4", "--width=0.125",
                               "--image_size=32", "--steps=2", "--n_train=2", "--n_eval=1",
                               f"--scale_root={scale}", "--kd_ranks=1"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        json.loads(json.dumps(summary))
    assert not common.missing_keys(summary, acceptance.SUMMARY_KEYS)
    for leg, keys in (("config4", ("top1", "top5", "loss")), ("config3", ("top1", "top1_diff")),
                      ("config2", ("top1",)), ("config1", ("train_top1",))):
        assert all(math.isfinite(summary[leg][k]) for k in keys), (leg, summary[leg])
    assert summary["config3"]["count"] == summary["config2"]["count"] == \
        summary["config5"]["eval_count"] == summary["held_out"] == 50
    assert summary["config4"]["export_files"] > 0 and len(summary["config4"]["export_top5"]) == 5
    assert len(summary["config1"]["top5"]) == 5 and summary["config5"]["finite"]
    assert all(0.0 <= p <= 1.0 for t in summary["config1"]["top5"] for _, p in t)
    assert all(os.path.exists(root / d / f"{d_tag}.log") for d, d_tag in (
        ("config4_assembled", "config4"), ("config4_assembled", "config3"),
        ("config2_resnetd_blurpool", "config2"), ("config5_kd_virtual8", "config5")))
    # config 3's record follows config 4's own final eval in the same file
    dir4 = str(root / "config4_assembled")
    assert common.train_final_eval(dir4, 2)["top1"] == summary["config4"]["top1"]
    assert common.last_eval(dir4)["count"] == 50


# -- chip_smoke.py's acceptance_cut and kd_diag_cut, rehearsed without a card ---------

def test_chip_smoke_accept_launches():
    """A card leg's step is 3 + 3 BlurPool and 9 + 9 DropBlock launches
    (ResNet-D with BlurPool: 3 + 3, none of DropBlock), an eval batch or a
    served forward 3 BlurPool forwards; an R152 KD step 6 + 3 and 39 + 39."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(REPO))
    got = {k: (v["fwd"], v["bwd"], v["fused"], v["apply_bwd"], v["mask"], v["apply"])
           for k, v in cs._accept_launches().items()}
    sweep = (24, 9, 117, 117, 0, 0)  # 3 steps, 2 eval batches
    assert got == {"config4": (36, 30, 90, 90, 0, 0),  # 10 steps, 2 eval batches
                   "config4-export": (3, 0, 0, 0, 0, 0), "config3": (3, 0, 0, 0, 0, 0),
                   "config2-setup": (36, 30, 0, 0, 0, 0), "config2": (3, 0, 0, 0, 0, 0),
                   "config1-setup": (0,) * 6, "config1": (0,) * 6, "config5": (0,) * 6,
                   "kd_probe": (15, 0, 0, 0, 0, 0), "sweep_half_lr": sweep,
                   "sweep_alpha.3": sweep, "sweep_temp2": sweep}
    assert cs.ACCEPT_LEGS == tuple(k for k in got if not k.startswith(("kd_", "sweep_")))
