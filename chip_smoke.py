"""Smoke test of the PyTorch port (axcnn_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
drives the port's serving path through its normal entry point and checks it:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles axcnn_torch/csrc/*.cu with nvcc (sm_90a);
3. kernel: the BlurPool kernel against its plain PyTorch version on the card
   at the serving path's shapes, fp32 and bf16, and both timed at batch 128
   on inputs read from device memory, not from the L2 cache;
4. serve: ``axcnn_torch.cli.predict.main`` with --config=assemble_resnet50
   (full width, 1001 classes, 224x224, bf16) on 1, 8 and 32 generated JPEGs;
   every request must print a well-formed top-5 line per image and launch
   the kernel exactly 3 times (the stride-2 block of stages 2-4);
5. parity: a seeded full-width assembled R50 with perturbed BN, on the card
   through the kernel against the CPU through the plain version;
6. throughput: served images/s at batch 128 in bf16.

Every phase prints one JSON line; any failure raises and exits non-zero.
The last two lines are the kernels' summary and the result line.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from axcnn_torch.kernels import blurpool as kblur

SLICE_SHAPES = [(32, 56, 56, 128), (32, 28, 28, 256), (32, 14, 14, 512)]
CHECK_SHAPES = SLICE_SHAPES + [(8, 112, 112, 64), (3, 15, 17, 96)]
TIME_BATCH = 128
L2_FLUSH_BYTES = 256 << 20  # timing inputs cycle through at least this much (H100 L2: 50 MB)
SEED = 0


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def device_phase():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)
    return smi.splitlines()[0]


def build_phase():
    from axcnn_torch.kernels.build import load_library

    t0 = time.perf_counter()
    lib = load_library()
    emit("build", seconds=time.perf_counter() - t0, library=os.path.relpath(lib._name))


def _nchw_input(shape, dtype, gen):
    n, h, w, c = shape
    x = torch.randn((n, h, w, c), generator=gen, device="cuda").to(dtype)
    return x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last


def _bf16_ulp(v):
    """Spacing of bf16 numbers at |v| (8 significant bits)."""
    e = torch.floor(torch.log2(v.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _time_ms(fn, xs, iters=50):
    """Mean ms per call, cycling through the inputs ``xs``."""
    for x in xs[:3]:
        fn(x)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(xs[i % len(xs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    max_err = 0.0
    for shape in CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = _nchw_input(shape, dtype, gen)
            got = kblur.blur_pool_cuda(x)
            want = kblur.blur_pool_reference(x)
            torch.cuda.synchronize()
            assert got.shape == want.shape and got.dtype == dtype
            assert got.is_contiguous(memory_format=torch.channels_last)
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            max_err = max(max_err, err)
            if dtype == torch.float32:
                ok, tol = err <= 1e-6, "max abs err <= 1e-6"
            else:
                ok, tol = bool((diff <= _bf16_ulp(want)).all()), "<= 1 bf16 ulp"
            emit("kernel_check", shape_nhwc=list(shape), dtype=str(dtype),
                 max_abs_err=err, n_differ=int((diff > 0).sum()),
                 numel=got.numel(), tolerance=tol, ok=ok)
            if not ok:
                raise AssertionError(f"BlurPool kernel disagrees at {shape} {dtype}")

    kernel_ms = plain_ms = 0.0
    for n, h, w, c in SLICE_SHAPES:
        shape = (TIME_BATCH, h, w, c)
        x = _nchw_input(shape, torch.bfloat16, gen)
        # cycle through copies whose sum exceeds the L2 cache several times
        # over, so each call reads its input from device memory
        xs = [x] + [x.clone() for _ in range(-(-L2_FLUSH_BYTES // x.nbytes) - 1)]
        # plain, kernel, kernel, plain: the two orders bracket any drift
        p1 = _time_ms(kblur.blur_pool_reference, xs)
        k1 = _time_ms(kblur.blur_pool_cuda, xs)
        k2 = _time_ms(kblur.blur_pool_cuda, xs)
        p2 = _time_ms(kblur.blur_pool_reference, xs)
        k, p = (k1 + k2) / 2, (p1 + p2) / 2
        nbytes = x.nbytes + x.nbytes // 4  # ~ in + out, each once
        emit("kernel_time", shape_nhwc=list(shape), dtype="bf16", kernel_us=k * 1e3,
             plain_us=p * 1e3, kernel_runs_us=[k1 * 1e3, k2 * 1e3],
             plain_runs_us=[p1 * 1e3, p2 * 1e3], rotating_inputs=len(xs),
             kernel_gb_per_s=nbytes / (k * 1e-3) / 1e9)
        del xs
        kernel_ms += k
        plain_ms += p
    return max_err, kernel_ms, plain_ms


def _write_jpegs(directory, count):
    from PIL import Image

    rng = np.random.default_rng(SEED)
    paths = []
    for i in range(count):
        h, w = int(rng.integers(200, 400)), int(rng.integers(200, 400))
        p = os.path.join(directory, f"img{i}.jpg")
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    return paths


def serve_phase():
    from axcnn_torch.cli import predict

    with tempfile.TemporaryDirectory() as tmp:
        paths = _write_jpegs(tmp, 32)
        kblur.LAUNCHES = 0
        for n in (1, 8, 32):
            before = kblur.LAUNCHES
            out, err = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = predict.main([*(f"--image={p}" for p in paths[:n]),
                                   "--config=assemble_resnet50"])
            seconds = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"predict exited {rc}: {err.getvalue()}")
            lines = [json.loads(line) for line in out.getvalue().splitlines()]
            assert [line["image"] for line in lines] == paths[:n], lines
            for line in lines:
                top5 = line["top5"]
                probs = [p for _, p in top5]
                assert len(top5) == 5 and len({c for c, _ in top5}) == 5, line
                assert all(isinstance(c, int) and 0 <= c < 1001 for c, _ in top5), line
                assert probs == sorted(probs, reverse=True) and sum(probs) <= 1 + 1e-4
            launched = kblur.LAUNCHES - before
            emit("serve", images=n, lines=len(lines), launches=launched,
                 seconds=seconds, first=lines[0])
            if launched != 3:
                raise AssertionError(f"expected 3 BlurPool launches, got {launched}")
        return kblur.LAUNCHES


def _assembled_cfg():
    from axcnn_torch.utils.config import load_preset

    return dataclasses.replace(load_preset("assemble_resnet50").model, num_classes=1001)


def _perturb_bn(model, seed):
    from axcnn_torch.ops.norm import BatchNorm

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, BatchNorm):
                c = m.weight.numel()
                lo, hi = (0.1, 0.3) if name.endswith("bn3") else (0.5, 1.5)
                m.weight.copy_(torch.from_numpy(rng.uniform(lo, hi, c)))
                m.bias.copy_(torch.from_numpy(0.1 * rng.standard_normal(c)))
                m.running_mean.copy_(torch.from_numpy(0.1 * rng.standard_normal(c)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))


def parity_phase():
    from axcnn_torch.core.dtypes import BF16_POLICY, DEFAULT_POLICY, set_fp32_precision
    from axcnn_torch.data.preprocessing import normalize_device
    from axcnn_torch.models.resnet import ResNet

    set_fp32_precision(DEFAULT_POLICY)
    model = ResNet(_assembled_cfg(), generator=torch.Generator().manual_seed(SEED))
    _perturb_bn(model, SEED)
    model.eval()
    u8 = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (2, 224, 224, 3), dtype=np.uint8))
    with torch.inference_mode():
        ref = model(normalize_device(u8)).numpy()
    model.to("cuda", memory_format=torch.channels_last)
    x = normalize_device(u8.cuda())
    before = kblur.LAUNCHES
    with torch.inference_mode():
        fp32 = model(x).cpu().numpy()
        bf16 = model(x, policy=BF16_POLICY).cpu().numpy()
        launched = kblur.LAUNCHES - before
    assert np.isfinite(fp32).all() and np.isfinite(bf16).all()
    rel = lambda a: float(np.linalg.norm(a - ref) / np.linalg.norm(ref))  # noqa: E731
    e32, e16 = rel(fp32), rel(bf16)
    ok = e32 <= 1e-3 and e16 <= 5e-2 and launched == 6
    emit("parity", batch=2, logits_shape=list(fp32.shape), ref_norm=float(np.linalg.norm(ref)),
         fp32_rel_l2=e32, fp32_tol=1e-3, bf16_rel_l2=e16, bf16_tol=5e-2,
         kernel_launches=launched, top1_agree_bf16=bool((bf16.argmax(1) == ref.argmax(1)).all()),
         ok=ok)
    if not ok:
        raise AssertionError("card-vs-CPU logits parity failed")


def throughput_phase(smi):
    from axcnn_torch.core.dtypes import BF16_POLICY
    from axcnn_torch.train.train_step import create_train_state, eval_logits, load_ema

    # the model predict serves: the preset's EMA weights, loaded once
    state = create_train_state(_assembled_cfg(), generator=torch.Generator().manual_seed(SEED),
                               device="cuda", use_ema=True)
    load_ema(state)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for batch, iters in ((TIME_BATCH, 20), (1, 50)):
        u8 = torch.randint(0, 256, (batch, 224, 224, 3), generator=gen, device="cuda",
                           dtype=torch.uint8)
        fwd = lambda: eval_logits(state, u8, policy=BF16_POLICY)  # noqa: E731
        for _ in range(3):
            fwd()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            logits = fwd()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
        assert torch.isfinite(logits).all() and logits.shape == (batch, 1001)
        emit("throughput", model="assemble_resnet50", batch=batch, dtype="bf16",
             img_per_s=batch / dt, ms_per_batch=dt * 1e3, iters=iters, card=smi)


def main():
    smi = device_phase()
    build_phase()
    max_err, kernel_ms, plain_ms = kernel_phase()
    launches = serve_phase()
    parity_phase()
    throughput_phase(smi)
    print(json.dumps({"kernels": [{
        "name": "blur_pool3_s2_fwd", "route": "cuda",
        "source": "axcnn_torch/csrc/blurpool.cu",
        "replaces": "axcnn/pallas/blurpool.py:73",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
