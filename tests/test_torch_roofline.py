"""The port's roofline instruments (``axcnn_torch/cli/{calibrate_roofline,
profile_roofline,analyze_profile,opt_experiments}.py``) against the
reference's (``scripts/{calibrate_roofline,analyze_profile,
opt_experiments}.py``) and XLA's cost model, on the CPU at a small size.

- calibration: the reference's and the port's probes, both timed by one
  fake clock, give the same GB/s and TFLOP/s;
- the per-op accountant's bytes equal XLA's ``bytes accessed`` and, for
  convolutions and matmuls, its FLOPs equal XLA's ``flops``, as integers;
  a sum is within XLA's 4-byte init scalar; a padded stride-2 conv's FLOPs
  exceed XLA's by exactly its padding taps, counted by the reference's
  ``_valid_pairs``;
- the join attributes a written trace's device events to the innermost
  range that holds their launch (nested ranges, a driver-API launch, a
  second thread, a kernel outside every range);
- a tiny train step and serving forward through ``profile_roofline``: the
  table's FLOPs equal ``FlopCounterMode``'s and ``forward_gflops``'s, every
  dispatched op is recorded once, remat's replay is counted apart;
- the hand-written kernels' accounting hook adds no launch and changes no
  argument; ``opt_experiments`` has the reference's rows.
"""

import ast
import functools
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from axcnn_torch.cli import analyze_profile, calibrate_roofline, opt_experiments
from axcnn_torch.cli import profile_roofline as pr
from axcnn_torch.cli.profile_step import forward_gflops, preset_model
from axcnn_torch.kernels import blurpool as kblur
from axcnn_torch.kernels import build
import torch_inprocess

capped_threads = torch_inprocess.capped_threads

REPO = pathlib.Path(__file__).resolve().parents[1]
MODULES = {"calibrate_roofline": calibrate_roofline, "profile_roofline": pr,
           "analyze_profile": analyze_profile, "opt_experiments": opt_experiments}
SMALL = ["--cpu", "--width=0.125", "--image_size=64"]


def _reference_script(name):
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rows(capsys, module, argv):
    assert module.main(argv) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert rows and all(r["card"] == "cpu" for r in rows)
    return rows


# -- calibration ---------------------------------------------------------------------

def test_calibration_matches_the_reference_on_one_fake_clock(monkeypatch):
    now = [0.0]

    def perf_counter():
        now[0] += 1.0
        return now[0]

    clock = types.SimpleNamespace(perf_counter=perf_counter)
    ref = _reference_script("calibrate_roofline")
    monkeypatch.setattr(ref, "time", clock)
    monkeypatch.setattr(calibrate_roofline, "time", clock)
    got = (calibrate_roofline.measure_hbm_gbps(elems=4096, iters=3, repeats=1, device="cpu"),
           calibrate_roofline.measure_matmul_tflops(n=64, iters=2, repeats=1, device="cpu"))
    want = (ref.measure_hbm_gbps(elems=4096, iters=3, repeats=1),
            ref.measure_matmul_tflops(n=64, iters=2, repeats=1))
    assert got[0] == pytest.approx(want[0], rel=1e-12)
    assert got[1] == pytest.approx(want[1], rel=1e-12)
    assert got[0] == calibrate_roofline.stream_bytes(4096, 3) / 1e9
    assert got[1] == calibrate_roofline.gemm_flops(64, 2) / 1e12


def test_calibration_defaults_are_the_reference_scripts():
    import inspect

    ref = _reference_script("calibrate_roofline")
    for name in ("measure_hbm_gbps", "measure_matmul_tflops", "_best_of"):
        want = {k: p.default for k, p in inspect.signature(getattr(ref, name)).parameters.items()}
        got = {k: p.default for k, p in
               inspect.signature(getattr(calibrate_roofline, name)).parameters.items()}
        assert {k: got[k] for k in want} == want, name


def test_calibration_row(capsys, monkeypatch):
    for name, small in (("measure_hbm_gbps", dict(elems=4096, iters=3, repeats=1)),
                        ("measure_matmul_tflops", dict(n=64, iters=2, repeats=1))):
        monkeypatch.setattr(calibrate_roofline, name,
                            functools.partial(getattr(calibrate_roofline, name), **small))
    (row,) = _rows(capsys, calibrate_roofline, ["--cpu"])
    assert row["hbm_fraction_of_spec"] == row["measured_hbm_gbps"] / 3350.0
    assert row["tensor_core_fraction_of_spec"] == row["measured_tflops_bf16"] / 989.0
    assert row["measured_hbm_gbps"] > 0 and row["measured_tflops_bf16"] > 0
    assert row["smi_before"] is None and row["smi_after"] is None  # no card


# -- per-op parity with XLA's cost model ------------------------------------------------

def _xla_cost(f, *args):
    cost = jax.jit(f).lower(*args).cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    return int(cost.get("flops", 0)), int(cost["bytes accessed"])


def _conv_jax(padding, stride=1, groups=1, dilation=1):
    return lambda x, w: jax.lax.conv_general_dilated(
        x, w, (stride, stride), padding, rhs_dilation=(dilation, dilation),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups)


def _conv_torch(padding, stride=1, groups=1, dilation=1):
    return lambda x, w: F.conv2d(x, w, stride=stride, padding=padding, groups=groups,
                                 dilation=dilation)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _oihw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1)))


# (name, input shapes (the reference's layouts), jax fn, torch fn, torch operands from numpy,
#  the FLOPs compared)
CASES = {
    "conv1x1": ([(2, 16, 16, 8), (1, 1, 8, 16)], _conv_jax("VALID"), _conv_torch(0),
                (_nchw, _oihw), True),
    "conv3x3_prepadded": ([(2, 18, 18, 8), (3, 3, 8, 16)], _conv_jax("VALID"), _conv_torch(0),
                          (_nchw, _oihw), True),
    "sk_grouped3x3": ([(2, 16, 16, 8), (3, 3, 2, 16)], _conv_jax("VALID", groups=4),
                      _conv_torch(0, groups=4), (_nchw, _oihw), True),
    "sk_dilated3x3": ([(2, 16, 16, 8), (3, 3, 8, 8)], _conv_jax("VALID", dilation=2),
                      _conv_torch(0, dilation=2), (_nchw, _oihw), True),
    "head_matmul": ([(4, 64), (64, 10)], lambda a, b: a @ b, lambda a, b: a @ b,
                    (torch.from_numpy, torch.from_numpy), True),
    "add": ([(4, 32), (4, 32)], lambda a, b: a + b, lambda a, b: a + b,
            (torch.from_numpy, torch.from_numpy), False),
}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _account(fn, *args):
    accountant = pr.RooflineAccountant()
    with torch.no_grad(), accountant:
        fn(*args)
    return accountant.ops


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_op_counts_equal_xla_cost_model(case, dtype):
    shapes, jf, tf, to_torch, flops_too = CASES[case]
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want_flops, want_bytes = _xla_cost(jf, *[jnp.asarray(a, jdt) for a in arrays])
    (rec,) = _account(tf, *[conv(a).to(tdt) for conv, a in zip(to_torch, arrays)])
    assert rec["bytes"] == want_bytes
    if flops_too:
        assert rec["flops"] == want_flops > 0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cast_bytes_equal_xla(dtype):
    jdt, tdt = DTYPES[dtype]
    other_j, other_t = (jnp.float32, torch.float32) if dtype == "bf16" else (jnp.bfloat16,
                                                                            torch.bfloat16)
    a = np.random.default_rng(1).standard_normal((4, 32)).astype(np.float32)
    _, want = _xla_cost(lambda x: x.astype(other_j), jnp.asarray(a, jdt))
    (rec,) = _account(lambda x: x.to(other_t), torch.from_numpy(a).to(tdt))
    assert rec["op"] == "aten._to_copy.default" and rec["bytes"] == want


@pytest.mark.parametrize("axis", [None, 0])
def test_sum_bytes_within_xla_init_scalar(axis):
    a = np.random.default_rng(2).standard_normal((4, 32)).astype(np.float32)
    _, want = _xla_cost(lambda x: x.sum(axis=axis), jnp.asarray(a))
    (rec,) = _account(lambda x: x.sum() if axis is None else x.sum(axis), torch.from_numpy(a))
    assert 0 <= want - rec["bytes"] <= 4


def test_padded_stride2_conv_counts_its_padding_taps():
    """The one convention that differs: ``flop_registry`` counts every tap of
    a padded window, XLA only those that land on the input
    (``scripts/analyze_profile.py`` ``_valid_pairs``)."""
    from axcnn_torch.ops.conv import fixed_pad_amounts

    valid_pairs = _reference_script("analyze_profile")._valid_pairs
    n, size, cin, cout, k, s = 2, 16, 8, 16, 3, 2
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, size, size, cin)).astype(np.float32)
    w = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    want, _ = _xla_cost(_conv_jax("SAME", stride=s), jnp.asarray(x), jnp.asarray(w))
    pad = fixed_pad_amounts(k)[0]
    (rec,) = _account(_conv_torch(pad, stride=s), _nchw(x), _oihw(w))
    out = -(-size // s)
    pad_lo = max((out - 1) * s + k - size, 0) // 2  # SAME's padding before
    valid = valid_pairs(size, k, s, pad_lo, 1, 1, out) ** 2
    assert valid < (out * k) ** 2  # the window does cross the border
    assert rec["flops"] - want == 2 * n * cout * cin * ((out * k) ** 2 - valid)


# -- the join ----------------------------------------------------------------------------

def _trace_fixture():
    def x(cat, name, tid, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur,
                "args": args}

    return [
        x("user_annotation", "roofline#0", 1, 0.0, 100.0),
        x("user_annotation", "roofline#1", 1, 10.0, 40.0),  # nested in #0
        x("cuda_runtime", "cudaLaunchKernel", 1, 20.0, 2.0, correlation=11),
        x("cuda_runtime", "cudaMemsetAsync", 1, 30.0, 1.0, correlation=14),
        x("cuda_driver", "cuLaunchKernelEx", 1, 60.0, 2.0, correlation=12),  # in #0 only
        x("cuda_runtime", "cudaLaunchKernel", 1, 200.0, 2.0, correlation=15),  # in no range
        x("user_annotation", "roofline#2", 2, 300.0, 50.0),  # the autograd engine's thread
        x("cuda_runtime", "cudaLaunchKernel", 2, 310.0, 2.0, correlation=13),
        x("gpu_user_annotation", "roofline#0", 7, 1000.0, 100.0),  # the device's copy: ignored
        x("kernel", "void at::native::elementwise_kernel<128, 2, f>", 7, 1000.0, 10.0,
          correlation=11),
        x("gpu_memset", "Memset (Device)", 7, 1012.0, 2.0, correlation=14),
        x("kernel", "sm90_xmma_gemm_bf16", 7, 1020.0, 20.0, correlation=12),
        x("kernel", "void at::native::reduce_kernel<512, 1>", 7, 1050.0, 6.0, correlation=13),
        x("kernel", "void at::native::vectorized_elementwise_kernel<4>", 7, 1060.0, 4.0,
          correlation=15),
    ]


def _table():
    ops = [{"i": 0, "op": "aten.mm.default", "inputs": ["bf16[64,64]", "bf16[64,64]"],
            "args": [], "flops": 2 * 64 ** 3, "bytes": 3 * 64 * 64 * 2, "replay": False,
            "kernel": False},
           {"i": 1, "op": "aten.add.Tensor", "inputs": ["bf16[1000]", "bf16[1000]"], "args": [],
            "flops": 0, "bytes": 6000, "replay": False, "kernel": False},
           {"i": 2, "op": "aten.sum.dim_IntList", "inputs": ["f32[1000]"],
            "args": ["dim=[0]"], "flops": 0, "bytes": 4004, "replay": True, "kernel": False}]
    return {"device": "cuda", "steps": 1, "card": "test", "wall_ms": 1.0, "ops": ops}


def test_join_attributes_each_device_event_to_its_innermost_range():
    events = _trace_fixture()
    devs = analyze_profile.device_events(events)
    assert [(ts, i) for _, ts, _, i in devs] == [(1000.0, 1), (1012.0, 1), (1020.0, 0),
                                                 (1050.0, 2), (1060.0, None)]
    got = analyze_profile.join(events, _table(), top=5)
    rows = {r["op"].split("(")[0]: r for r in got["top_ops"]}
    assert [r["op"].split("(")[0] for r in got["top_ops"]] == [
        "aten.mm.default", "aten.add.Tensor", "aten.sum.dim_IntList"]
    mm, add, red = rows["aten.mm.default"], rows["aten.add.Tensor"], rows["aten.sum.dim_IntList"]
    assert (mm["count"], mm["ms"], mm["cat"]) == (1, 0.02, "convolutions and GEMMs")
    assert (add["count"], add["ms"]) == (2, 0.012)  # the kernel and the memset
    assert (red["count"], red["ms"], red["cat"]) == (1, 0.006, "reductions")
    assert add["gbps"] == pytest.approx(6000 / 1e9 / 12e-6)
    assert mm["bound_by"] == "bytes" and mm["ideal_ms"] == pytest.approx(
        max(3 * 64 * 64 * 2 / 3.35e12, 2 * 64 ** 3 / 989e12) * 1e3)
    assert mm["share_of_bound"] == pytest.approx(mm["ideal_ms"] / mm["ms"])
    assert mm["tfs"] == pytest.approx(2 * 64 ** 3 / 1e12 / 20e-6)
    ideal = sum(r["ideal_ms"] for r in got["top_ops"])
    assert got["sum_per_op_ideal_ms"] == pytest.approx(ideal)
    assert got["total_traced_ms_per_step"] == pytest.approx(0.042)
    assert got["per_op_roofline_fraction"] == pytest.approx(ideal / 0.042)
    assert got["unattributed_ms"] == pytest.approx(0.004)
    assert got["device_busy_ms_per_step"] == pytest.approx(0.042)  # 10+2+20+6+4 µs, apart
    assert got["unattributed_share"] == pytest.approx(0.004 / 0.042)
    cats = got["categories"]
    assert cats["elementwise_kernel<128, 2>"]["gb"] == pytest.approx(6000 / 1e9)
    assert cats["convolutions and GEMMs"]["gb"] == pytest.approx(3 * 64 * 64 * 2 / 1e9)
    assert cats["reductions"]["launches"] == 1 and cats["memcpy and memset"]["gb"] == 0
    assert cats["convolutions and GEMMs"]["gflop"] == 2 * 64 ** 3 / 1e9
    assert cats["convolutions and GEMMs"]["ideal_ms"] == pytest.approx(mm["ideal_ms"])
    keys = analyze_profile.step_keys(got["totals"], 1e-3)
    assert keys["train_gflop_per_step"] == 2 * 64 ** 3 / 1e9 == keys["model_gflop_per_step"]
    assert keys["gbytes_per_step"] == (3 * 64 * 64 * 2 + 6000 + 4004) / 1e9
    assert keys["mfu"] == pytest.approx(2 * 64 ** 3 / 1e-3 / 989e12)
    calibrated = analyze_profile.join(events, _table(), calibration={
        "measured_hbm_gbps": 0.4, "measured_tflops_bf16": 500.0})
    flagged = {r["op"].split("(")[0]: r["above_hbm_wall"] for r in calibrated["top_ops"]}
    assert flagged == {"aten.mm.default": True, "aten.add.Tensor": True,
                       "aten.sum.dim_IntList": True}
    assert calibrated["top_ops"][1]["share_of_stream"] == pytest.approx(add["gbps"] / 0.4)


def test_analyze_reads_the_saved_files(tmp_path, capsys):
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": _trace_fixture()}))
    (tmp_path / "ops.json").write_text(json.dumps(_table()))
    (tmp_path / "cal.json").write_text(json.dumps(
        {"measured_hbm_gbps": 3000.0, "measured_tflops_bf16": 700.0, "card": "test"}) + "\n")
    assert analyze_profile.main([f"--trace={tmp_path / 'trace.json'}",
                                 f"--ops={tmp_path / 'ops.json'}",
                                 f"--calibration={tmp_path / 'cal.json'}"]) == 0
    (row,) = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    want = analyze_profile.join(analyze_profile.load_trace(tmp_path / "trace.json"), _table(),
                                calibration={"measured_hbm_gbps": 3000.0,
                                             "measured_tflops_bf16": 700.0})
    assert row["top_ops"] == want["top_ops"] and row["card"] == "test"
    assert row["model_gflop_per_step"] == 2 * 64 ** 3 / 1e9
    assert row["fraction_of_achievable"] == pytest.approx(
        max(2 * 64 ** 3 / 700e12, row["gbytes_per_step"] / 3000) / 1e-3)


# -- the accountant on the port's steps ------------------------------------------------

class _Dispatched(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _small(mode="train", remat="none"):
    cfg = preset_model("assemble_resnet50", width_multiplier=0.125, remat=remat)
    return cfg, pr.runner(mode, cfg, torch.device("cpu"), 2, 64)


def test_train_step_records_every_op_once():
    _, (enqueue, wait) = _small()
    wait(enqueue())
    seen, accountant = _Dispatched(), pr.RooflineAccountant()
    with seen, accountant:
        wait(enqueue())
    assert [r["op"] for r in accountant.ops] == seen.ops
    assert [r["i"] for r in accountant.ops] == list(range(len(seen.ops)))
    assert not any(r["kernel"] for r in accountant.ops)  # the CPU takes the plain versions
    assert build.ACCOUNTANT is None


@pytest.fixture
def one_warmup(monkeypatch):
    monkeypatch.setattr(pr, "WARMUP", 1)


def test_train_step_profile(capsys, tmp_path, one_warmup):
    (row,) = _rows(capsys, pr, SMALL + ["--batch=2", "--untraced=1", "--steps=1", "--top=10",
                                        f"--trace_out={tmp_path}"])
    assert row["train_gflop_per_step"] == row["flop_counter_gflop_per_step"] > 0
    assert row["model_gflop_per_step"] == row["train_gflop_per_step"]
    for k in ("gbytes_per_step", "step_ms", "tflops", "mfu", "hbm_gbps", "speed_of_light_ms",
              "fraction_of_speed_of_light", "device_busy_ms_per_step", "plain_busy_ms",
              "images_per_sec"):
        assert math.isfinite(row[k]) and row[k] > 0, k
    assert row["mfu"] == row["tflops"] / 989.0
    assert len(row["top_ops"]) == 10 and row["top_ops"][0]["ms"] >= row["top_ops"][-1]["ms"]
    assert 0 <= row["unattributed_share"] < 0.05
    assert row["kernels"] == {}
    assert analyze_profile.main([f"--trace={tmp_path / 'trace.json'}",
                                 f"--ops={tmp_path / 'ops.json'}", "--top=10"]) == 0
    (offline,) = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    for k in ("top_ops", "categories", "unattributed_ms", "train_gflop_per_step", "mfu"):
        assert offline[k] == row[k], k


def test_serve_forward_counts_the_forward_flops(capsys, one_warmup):
    (row,) = _rows(capsys, pr, SMALL + ["--mode=serve", "--batch=2", "--untraced=1",
                                        "--steps=1"])
    cfg = preset_model("assemble_resnet50", width_multiplier=0.125)
    assert row["train_gflop_per_step"] == pytest.approx(forward_gflops(cfg, 64) * 2, rel=1e-12)


def test_remat_replay_is_counted_apart():
    """``blocks`` replays the stem and every residual block in the backward:
    their forward FLOPs, i.e. the forward's but the head's."""
    cfg, (enqueue, wait) = _small(remat="blocks")
    counted = pr.count_step(enqueue, wait)
    with torch.device("meta"):
        from axcnn_torch.models.resnet import ResNet

        model = ResNet(cfg)
    head = 2 * 2 * model.head.weight.numel()  # its matmul at batch 2
    replay = forward_gflops(cfg, 64) * 2 * 1e9 - head
    assert counted["flops"] - counted["model_flops"] == pytest.approx(replay, rel=1e-12)
    _, (enqueue, wait) = _small()
    plain = pr.count_step(enqueue, wait)
    assert plain["flops"] == plain["model_flops"] == counted["model_flops"]


# -- the hand-written kernels' hook ----------------------------------------------------

def _fake_launch(monkeypatch):
    """Lets ``blur_pool_cuda`` run its launch on a CPU tensor: the device
    check, the stream and the C entry point are stand-ins; returns the list
    of the entry point's calls."""
    calls = []
    monkeypatch.setattr(kblur, "LAUNCHES", kblur.LAUNCHES)  # the counts are put back after
    monkeypatch.setattr(kblur, "ROUTES", dict(kblur.ROUTES))
    monkeypatch.setattr(kblur, "_check_cuda_nchw", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(kblur, "entry",
                        lambda name, argtypes: lambda *args: calls.append((name, args[:-1])) or 0)
    return calls


def test_kernel_hook_records_bytes_and_adds_no_launch(monkeypatch):
    calls = _fake_launch(monkeypatch)
    x = torch.randn(2, 8, 9, 10).contiguous(memory_format=torch.channels_last)
    launches = kblur.LAUNCHES
    y0 = kblur.blur_pool_cuda(x)
    accountant = pr.RooflineAccountant()
    with accountant:
        y1 = kblur.blur_pool_cuda(x)
    assert kblur.LAUNCHES == launches + 2 and len(calls) == 2
    assert calls[0][0] == calls[1][0] == "axcnn_blur_pool3_s2"
    assert calls[0][1][2:] == calls[1][1][2:] and y0.shape == y1.shape
    (rec,) = [r for r in accountant.ops if r["kernel"]]
    assert rec["op"] == "kernel::blur_pool3_s2_fwd" and rec["flops"] == 0
    assert rec["bytes"] == x.nbytes + y1.nbytes == 2 * 8 * (9 * 10 + 5 * 5) * 4
    assert pr.kernel_summary(accountant.ops, 1) == {
        "blur_pool3_s2_fwd": {"launches": 1, "bytes": [rec["bytes"]]}}
    assert build.ACCOUNTANT is None


def test_kernel_inside_a_recorded_op_carries_its_bytes():
    """A custom op whose implementation launches a kernel (the serving
    BlurPool's form): the kernel's record takes the bytes, the op none."""
    fn_calls = []

    @torch.library.custom_op("roofline_test::launches", mutates_args=())
    def launches(x: torch.Tensor) -> torch.Tensor:
        y = torch.empty_like(x)
        assert build.launch("fake", (x,), (y,), lambda *a: fn_calls.append(a) or 0, 7) == 0
        return y

    x = torch.randn(4, 16)
    accountant = pr.RooflineAccountant()
    with accountant:
        launches(x)
    op, kernel = [r for r in accountant.ops if r["op"] != "aten.empty_like.default"]
    assert op["op"] == "roofline_test.launches.default" and op["bytes"] == 0
    assert kernel["op"] == "kernel::fake" and kernel["bytes"] == 2 * x.nbytes
    assert kernel["i"] == op["i"] + 1 and fn_calls == [(7,)]
    assert build.launch("fake", (x,), (x,), lambda *a: 5) == 5  # no accountant: the call alone


def test_op_bytes_rules():
    """Views move nothing, an in-place op reads and writes its buffer, an
    overwrite and an ``out=`` only write, a broadcast input counts its
    distinct elements, two views of one storage count it once."""
    a, b = torch.randn(64, 32), torch.randn(32)

    def one(fn, *args):  # the views it takes move nothing
        return sum(r["bytes"] for r in _account(fn, *args))

    assert one(lambda t: t.view(32, 64), a) == 0
    assert one(lambda t: t.t(), a) == 0
    assert one(lambda t: t.mul_(2.0), a) == 2 * a.nbytes
    assert one(lambda t, u: t.copy_(u), a, a.flip(0).contiguous()) == 2 * a.nbytes
    assert one(lambda t: t.zero_(), a) == a.nbytes
    assert one(lambda t, u: t + u, a, b) == a.nbytes + b.nbytes + a.nbytes
    assert one(lambda t: t[:, :16] + t[:, 16:], a) == a.nbytes + a.nbytes // 2
    assert one(lambda t: torch.zeros_like(t), a) == a.nbytes
    assert one(lambda t: torch.empty_like(t), a) == 0
    out = torch.empty(64, 32)
    assert one(lambda t, o: torch.add(t, 1.0, out=o), a, out) == 2 * a.nbytes
    ts = [torch.randn(8) for _ in range(3)]
    assert one(lambda t: torch._foreach_mul_(t, 2.0), ts) == 2 * 3 * 8 * 4


# -- opt_experiments -----------------------------------------------------------------------

def _source(path):
    return ast.parse((REPO / path).read_text(), filename=path)


def test_opt_experiments_rows_have_the_reference_keys(capsys, monkeypatch):
    tree = _source("scripts/opt_experiments.py")
    step = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
                and n.name == "time_step")
    ret = [n.value for n in ast.walk(step) if isinstance(n, ast.Return)
           and isinstance(n.value, ast.Dict)]
    ref_keys = {k.value for k in ret[-1].keys} - {"compile_s"}  # no torch meaning (docstring)
    cfg_call = next(n for n in ast.walk(step) if isinstance(n, ast.Call)
                    and getattr(n.func, "id", None) == "ModelConfig")
    literal = {k.arg: k.value.value for k in cfg_call.keywords if isinstance(k.value, ast.Constant)}
    got = opt_experiments.model_config(152, True)
    for k, v in literal.items():
        assert getattr(got, k) == v, k
    assert (got.resnet_size, got.sk_merged_conv) == (152, True)
    sched = next(n for n in ast.walk(step) if isinstance(n, ast.Call)
                 and getattr(n.func, "id", None) == "make_lr_schedule")
    assert opt_experiments.SCHEDULE == {k.arg: ast.literal_eval(k.value) for k in sched.keywords}
    monkeypatch.setattr(opt_experiments, "WARM", 0)
    monkeypatch.setattr(opt_experiments, "TIMED", 1)
    monkeypatch.setattr(opt_experiments, "SK_BATCH", 2)
    monkeypatch.setattr(opt_experiments, "R152_BATCH", 2)
    rows = _rows(capsys, opt_experiments, ["--cpu", "--width=0.125", "--image_size=32",
                                           "--batches=2"])
    assert [r["case"] for r in rows] == ["batch_2", "sk_merged_b2", "unrolled_r152_b2"]
    for r in rows:
        assert ref_keys <= set(r) and {"gflop", "tflops", "mfu"} <= set(r)
        for k in ref_keys | {"gflop", "tflops", "mfu"}:
            assert math.isfinite(r[k]) and r[k] > 0, (r["case"], k)
        assert r["mfu"] == r["tflops"] / 989.0
    assert rows[1]["gflop"] > rows[0]["gflop"]  # the merged 5x5 conv's zero taps


# -- the card, and what the modules import ------------------------------------------------

@pytest.mark.parametrize("name", ["calibrate_roofline", "profile_roofline", "opt_experiments"])
def test_without_a_card_each_exits_1(name, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert MODULES[name].main([]) == 1
    captured = capsys.readouterr()
    assert not captured.out and "no CUDA device" in captured.err


def test_modules_import_no_reference_code():
    """Neither ``jax``, ``axcnn``, ``bench`` nor ``scripts`` by name in the
    source, nor in ``sys.modules`` after importing the four modules."""
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
