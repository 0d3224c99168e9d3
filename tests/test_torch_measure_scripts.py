"""The port's measurement modules (``axcnn_torch/cli/{latency_bench,
remat_bench,capacity_probe,loader_bench,echo_bench}.py``) against the
reference's scripts (``scripts/*.py``), on the CPU at a small size:
assembled R50 at width 0.125, 64x64, batches of 2-8, ``--cpu``.

- Each module's flag defaults and constants are the reference script's,
  read from the script's source with ``ast`` (its ``add_argument`` calls,
  module constants and the configs its functions build), since the scripts
  build their parsers inside ``main()``.
- Each module's rows carry its keys, with finite values.
- latency: the served function agrees with the reference's
  ``resnet_apply(normalize_device(u8), train=False)`` on the same weights.
- loader: both packages' ``make_data`` write the same bytes, and the port's
  loader with ``decode_batch`` stubbed hands the decoder the same records,
  labels and seeds, in the same order, as the reference's.
- remat: ``--modes=conv`` is refused before any row.
- capacity: the student's and teacher's configs, KD and schedule constants
  equal the reference's.
- echo: factor k gives k steps for each host batch.
- Without ``--cpu`` on a machine with no card each exits 1; none imports
  ``jax``, ``axcnn``, ``bench`` or ``scripts``.
"""

import ast
import dataclasses
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from axcnn_torch.cli import (capacity_probe, echo_bench, latency_bench, loader_bench,
                             remat_bench)
import torch_inprocess

capped_threads = torch_inprocess.capped_threads

REPO = pathlib.Path(__file__).resolve().parents[1]
MODULES = {"latency_bench": latency_bench, "remat_bench": remat_bench,
           "capacity_probe": capacity_probe, "loader_bench": loader_bench,
           "echo_bench": echo_bench}
SMALL = ["--cpu", "--width=0.125", "--image_size=64"]


def _source(path):
    return ast.parse((REPO / path).read_text(), filename=path)


def _flag_defaults(tree):
    """``{flag: default}`` of every ``add_argument("--flag", default=...)``."""
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            if "default" in kw:
                try:
                    out[node.args[0].value] = ast.literal_eval(kw["default"])
                except ValueError:  # a name: read by the test that needs it
                    out[node.args[0].value] = ast.unparse(kw["default"])
    return out


def _constants(tree):
    """Module-level ``NAME = literal`` assignments."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


def _call_kwargs(tree, name):
    """The literal keywords of every call to ``name`` (a function or an
    attribute of that name), in source order."""
    calls = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Name) and f.id == name) or \
                    (isinstance(f, ast.Attribute) and f.attr == name):
                kw = {}
                for k in node.keywords:
                    if k.arg is not None:
                        try:
                            kw[k.arg] = ast.literal_eval(k.value)
                        except ValueError:
                            pass
                calls.append((node.lineno, kw))
    return [kw for _, kw in sorted(calls, key=lambda c: c[0])]


def _rows(capsys, module, argv):
    assert module.main(argv) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert rows
    for row in rows:
        assert row["card"] == "cpu"
    return rows


def _finite(row, keys):
    for k in keys:
        assert isinstance(row[k], (int, float)) and math.isfinite(row[k]) and row[k] > 0, (k, row)


# -- flag defaults and constants -----------------------------------------------

def test_defaults_are_the_reference_scripts():
    for name in ("latency_bench", "remat_bench", "capacity_probe", "loader_bench"):
        ref = _flag_defaults(_source(f"scripts/{name}.py"))
        port = _flag_defaults(_source(f"axcnn_torch/cli/{name}.py"))
        for flag, want in ref.items():
            if (name, flag) == ("remat_bench", "--modes"):  # conv: no torch meaning
                assert port[flag].split(",") == [m for m in want.split(",") if m != "conv"]
            elif flag == "--data_dir":  # the same name in the host's temporary directory
                assert port[flag] == "DATA_DIR"
                assert loader_bench.DATA_DIR == os.path.join(tempfile.gettempdir(),
                                                             os.path.basename(want))
            else:
                assert port[flag] == want, (name, flag)
    for name in ("latency_bench", "remat_bench"):
        ref = _constants(_source(f"scripts/{name}.py"))
        assert (MODULES[name].WARMUP, MODULES[name].TIMED) == (ref["WARMUP"], ref["TIMED"])
    echo, bench = _constants(_source("scripts/echo_bench.py")), _constants(_source("bench.py"))
    assert (echo_bench.FACTORS, echo_bench.TIMED) == (echo["FACTORS"], echo["TIMED"])
    assert (echo_bench.BATCH, echo_bench.WARMUP, echo_bench.N_IMAGES) == (
        bench["BATCH"], bench["WARMUP"], bench["N_BENCH_IMAGES"])
    assert os.path.basename(echo_bench.DATA_DIR) == os.path.basename(bench["BENCH_DATA"])
    loops = [ast.literal_eval(n.iter) for n in ast.walk(_source("scripts/loader_bench.py"))
             if isinstance(n, ast.For) and isinstance(n.iter, ast.Tuple)]
    assert loader_bench.WORKERS in loops


def test_step_constants_are_the_reference_scripts():
    """remat's and echo's model and schedule (``remat_bench.py``,
    ``bench.py``) and capacity's student, teacher, KD and schedule
    (``capacity_probe.py:31-35``)."""
    from axcnn.models.resnet import ModelConfig as JModelConfig

    remat = _source("scripts/remat_bench.py")
    cfg_kw = _call_kwargs(remat, "ModelConfig")[0]
    for mode in ("none", "blocks"):
        want = JModelConfig(**{**cfg_kw, "remat": mode})
        assert dataclasses.asdict(remat_bench.model_config(mode)) == dataclasses.asdict(want)
    assert remat_bench.SCHEDULE == _call_kwargs(remat, "make_lr_schedule")[0]
    step_kw = _call_kwargs(remat, "make_train_step")[0]
    assert step_kw == dict(total_steps=1000, label_smoothing=0.1, mixup_alpha=0.2,
                           weight_decay=1e-4, use_ema=True)
    bench = _source("bench.py")
    assert dataclasses.asdict(remat_bench.model_config("none")) == dataclasses.asdict(
        JModelConfig(**_call_kwargs(bench, "ModelConfig")[0]))
    assert remat_bench.SCHEDULE == _call_kwargs(bench, "make_lr_schedule")[0]

    cap = _source("scripts/capacity_probe.py")
    common = _call_kwargs(cap, "dict")[0]
    assert capacity_probe.COMMON == common
    for mode in ("none", "blocks"):
        student, teacher = capacity_probe.configs(mode)
        assert dataclasses.asdict(student) == dataclasses.asdict(
            JModelConfig(resnet_size=152, remat=mode, **common))
        assert dataclasses.asdict(teacher) == dataclasses.asdict(
            JModelConfig(resnet_size=50, **common))
    step_kw = _call_kwargs(cap, "make_train_step")[0]
    assert capacity_probe.KD == {k: step_kw[k] for k in ("kd_temp", "kd_alpha")}
    assert capacity_probe.SCHEDULE == _call_kwargs(cap, "make_lr_schedule")[0]

    lat = _source("scripts/latency_bench.py")
    assert latency_bench.MODELS["assembled"] == _call_kwargs(lat, "dict")[0]
    assert latency_bench.MODELS["vanilla"] == {}
    assert _call_kwargs(lat, "ModelConfig")[0] == dict(resnet_size=50, num_classes=1000)


# -- the modules' rows -----------------------------------------------------------

def test_latency_rows(capsys):
    rows = _rows(capsys, latency_bench, SMALL + ["--batches=1,2", "--dtypes=bf16,int8",
                                                 "--warmup=1", "--timed=2"])
    assert [(r["model"], r["dtype"], r["batch"]) for r in rows] == [
        (m, d, b) for m in ("assembled", "vanilla") for d in ("bf16", "int8") for b in (1, 2)]
    for r in rows:
        assert set(r) == {"batch", "sync_ms", "pipelined_ms", "pipelined_img_s", "model",
                          "dtype", "card"}
        _finite(r, ("sync_ms", "pipelined_ms", "pipelined_img_s"))


def test_latency_serves_the_reference_forward():
    """fp32, TF32 off: the served logits against the reference's
    ``resnet_apply(normalize_device(u8), train=False)`` on the reference's
    init carried over, to rtol 1e-4 with atol 1e-4 of the largest logit
    (``tests/test_torch_model.py``'s bound: fp32 sums reassociated)."""
    import jax

    from axcnn.data.preprocessing import normalize_device as j_normalize
    from axcnn.models.resnet import ModelConfig as JModelConfig
    from axcnn.models.resnet import resnet_apply, resnet_init
    from axcnn_torch.ckpt.convert import from_axcnn
    from axcnn_torch.core.dtypes import DEFAULT_POLICY, set_fp32_precision

    set_fp32_precision(DEFAULT_POLICY)
    cfg = latency_bench.model_config("assembled", 0.125)
    jcfg = JModelConfig(**dataclasses.asdict(cfg))
    params, state = resnet_init(jax.random.key(0), jcfg)
    served = latency_bench.served_state(cfg, torch.device("cpu"))
    served.model.load_state_dict(from_axcnn(params, state, cfg))
    u8 = np.random.default_rng(3).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    got = latency_bench.serve_fn(served, "fp32")(torch.from_numpy(u8)).numpy()
    want, _ = resnet_apply(params, state, j_normalize(u8), cfg=jcfg, train=False)
    assert got.shape == (2, 1000) and got.dtype == np.float32
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_remat_rows_and_conv_refused(capsys):
    rows = _rows(capsys, remat_bench, SMALL + ["--batches=2", "--modes=none,blocks",
                                               "--warmup=1", "--timed=1"])
    assert [r["mode"] for r in rows] == ["none", "blocks"]
    for r in rows:
        assert set(r) == {"mode", "batch", "ms", "img_s", "gflop", "model_gflop", "gb",
                          "tflops", "mfu", "gbps", "hbm_util", "loss", "peak_gib", "card"}
        _finite(r, ("ms", "img_s", "gflop", "model_gflop", "gb", "tflops", "mfu", "gbps",
                    "hbm_util", "loss"))
        assert r["peak_gib"] is None  # no device memory on the host
        assert r["mfu"] == r["tflops"] / 989.0 and r["hbm_util"] == r["gbps"] / 3350.0
    # the executed step's FLOPs: blocks adds its replay, the forward of the stem
    # and every residual block (the whole forward's but the head's)
    none, blocks = rows
    cfg = remat_bench.model_config("none", 0.125)
    with torch.device("meta"):
        from axcnn_torch.models.resnet import ResNet

        head = 2 * 2 * ResNet(cfg).head.weight.numel()  # its matmul at batch 2
    from axcnn_torch.cli.profile_step import forward_gflops

    replay = forward_gflops(cfg, 64) * 2 - head / 1e9
    assert none["gflop"] == none["model_gflop"] == blocks["model_gflop"]
    assert blocks["gflop"] - none["gflop"] == pytest.approx(replay, rel=1e-12)
    assert remat_bench.main(SMALL + ["--modes=none,conv"]) == 1
    captured = capsys.readouterr()
    assert not captured.out and "no torch counterpart" in captured.err


def test_capacity_rows(capsys):
    rows = _rows(capsys, capacity_probe, SMALL + ["--batches=2", "--modes=blocks"])
    assert len(rows) == 1 and set(rows[0]) == {
        "mode", "batch", "loss", "peak_allocated_gib", "peak_reserved_gib", "card_gib",
        "fits_card", "oom", "card"}
    assert rows[0]["oom"] is False and math.isfinite(rows[0]["loss"])


def test_capacity_reports_out_of_memory_as_its_answer(monkeypatch):
    def oom(*a, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(capacity_probe, "_step", oom)
    row = capacity_probe.probe("none", 512, torch.device("cpu"))
    assert row == {"mode": "none", "batch": 512, "fits_card": False, "oom": True}
    monkeypatch.setattr(capacity_probe, "_step", lambda *a: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        capacity_probe.probe("none", 512, torch.device("cpu"))


# -- the loader --------------------------------------------------------------------

def _reference_script(name):
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def small_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("loader_bench")
    loader_bench.make_data(str(root / "port"), 64)
    return root


def test_make_data_writes_the_reference_bytes(small_set):
    _reference_script("loader_bench").make_data(str(small_set / "reference"), 64)
    names = sorted(os.listdir(small_set / "port"))
    assert names == sorted(os.listdir(small_set / "reference"))
    assert len([n for n in names if n.startswith("train-")]) == 4
    for n in names:
        assert (small_set / "port" / n).read_bytes() == (small_set / "reference" / n).read_bytes()


def _recorded_stream(cpp_loader, make_loader, batches, monkeypatch):
    """(payload bytes, seed) of each record the stubbed ``decode_batch`` got."""
    got = []

    def recording(payloads, *, image_size, seeds, **kw):
        got.extend(zip((bytes(p) for p in payloads), (int(s) for s in seeds)))
        n = len(payloads)
        return (np.zeros((n, image_size, image_size, 3), np.uint8), np.zeros((n,), np.int32), n)

    monkeypatch.setattr(cpp_loader, "get_lib", lambda: None)  # no decoder is built
    monkeypatch.setattr(cpp_loader, "decode_batch", recording)
    it = iter(make_loader())
    for _ in range(batches):
        assert next(it)["labels"].shape == (8,)
    return got


def test_stubbed_loader_hands_over_the_reference_records(small_set, monkeypatch):
    """Ten batches of 8 (past the first epoch of 64): the same records, labels
    and seeds in the same order."""
    from axcnn.data import cpp_loader as j_cpp
    from axcnn.data.pipeline import TFRecordImageLoader as JLoader
    from axcnn_torch.data import cpp_loader as t_cpp
    from axcnn_torch.data.tfrecord import parse_example

    from axcnn.data.datasets import DatasetInfo

    data = str(small_set / "port")
    info = DatasetInfo("bench", 1000, 64, 64, train_prefix="train", eval_prefix="train")
    want = _recorded_stream(j_cpp, lambda: JLoader(
        data, info, batch_size=8, train=True, image_size=224, autoaugment_type="v0", seed=1,
        num_workers=4, use_native=True), 10, monkeypatch)
    got = _recorded_stream(t_cpp, lambda: loader_bench.loader(data, 64, 8, 4), 10, monkeypatch)
    assert len(got) == len(want) == 80
    assert got == want
    labels = [int(parse_example(p)["image/class/label"][0]) for p, _ in got]
    assert len(set(p for p, _ in got[:64])) == 64 and 0 <= min(labels) and max(labels) < 1000


def test_loader_rows(small_set, capsys):
    rows = _rows(capsys, loader_bench, ["--cpu", f"--data_dir={small_set / 'port'}",
                                        "--n_images=64", "--batch=8", "--batches=2",
                                        "--image_size=64"])
    (row,) = rows
    keys = ["stub_producer_ips", "stub_with_marshal_ips", "framing_stream_ips",
            "seed_us_per_record", *[f"real_ips_workers{k}" for k in (1, 2, 4)],
            "serial_us_per_record", "multiproducer_stub_ips_p2", "consumer_us_per_record"]
    _finite(row, keys)
    for k in ("decode_us_per_record_1core", "projected_scaling_limit_cores",
              "consumer_scaling_limit_cores_vs_decode"):
        assert math.isfinite(row[k])
    assert row["host_cores"] == os.cpu_count()
    assert row["affinity_cores"] == len(os.sched_getaffinity(0))
    assert not any(k.startswith("real_to_card") for k in row)  # --cpu: no card term


# -- echo --------------------------------------------------------------------------

def test_echo_rows_take_k_steps_a_host_batch(small_set, capsys):
    rows = _rows(capsys, echo_bench, SMALL + [f"--data_dir={small_set / 'port'}",
                                              "--n_images=64", "--batch=4", "--factors=2,3",
                                              "--aa=host,device", "--warmup=1", "--timed=2",
                                              "--windows=2"])
    assert [(r["aa"], r["factor"]) for r in rows] == [
        (aa, k) for aa in ("host", "device") for k in (2, 3)]
    for r in rows:
        k = r["factor"]
        assert set(r) == {"aa", "factor", f"echo{k}", "windows_img_s", "steps", "host_batches",
                          "host_cores", "affinity_cores", "card"}
        _finite(r, (f"echo{k}",))
        assert r[f"echo{k}"] == max(r["windows_img_s"]) and len(r["windows_img_s"]) == 2
        assert r["steps"] == 5 and r["host_batches"] == -(-5 // k)


# -- the card, and what the modules import -----------------------------------------

@pytest.mark.parametrize("name", sorted(MODULES))
def test_without_a_card_each_exits_1(name, capsys, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    argv = [f"--data_dir={tmp_path}"] if name in ("loader_bench", "echo_bench") else []
    assert MODULES[name].main(argv) == 1
    captured = capsys.readouterr()
    assert not captured.out and "no CUDA device" in captured.err
    assert not os.listdir(tmp_path)  # it stopped before making any data


def test_modules_import_no_reference_code():
    """Neither ``jax``, ``axcnn``, ``bench`` nor ``scripts`` by name in the
    source, nor in ``sys.modules`` after importing the five modules."""
    for name in MODULES:
        for node in ast.walk(_source(f"axcnn_torch/cli/{name}.py")):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & {"jax", "jaxlib", "axcnn", "bench", "scripts"}, (name, tops)
    code = ("import sys\n" + "".join(f"import axcnn_torch.cli.{n}\n" for n in MODULES)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'axcnn', 'bench', 'scripts')]\nassert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)
