"""Smoke test of the PyTorch port (axcnn_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
drives the port's serving and training paths through their normal entry
points and checks them:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles axcnn_torch/csrc/*.cu with nvcc (sm_90a), one nvcc per
   source, in parallel;
3. kernel_check: each hand-written kernel against its plain PyTorch version
   on the card, bit for bit: the BlurPool forward and backward at the
   paths' shapes and odd extents, fp32 and bf16, the BlurPool autograd
   Function against autograd through the plain forward, and the DropBlock
   mask at 14x14 and 7x7 (bs 7) and 15x17 (bs 5) for three drop rates;
4. kernel_time: each kernel and its plain version at batch 128, the BlurPool
   kernels on inputs rotated through 256 MB so they read device memory;
5. serve: ``axcnn_torch.cli.predict.main`` with --config=assemble_resnet50
   (full width, 1001 classes, 224x224, bf16) on 1, 8 and 32 generated JPEGs;
   every request must print a well-formed top-5 line per image and launch
   the forward kernel exactly 3 times (the stride-2 block of stages 2-4);
6. parity: a seeded full-width assembled R50 with perturbed BN, on the card
   through the kernel against the CPU through the plain version;
7. throughput: served images/s at batch 128 in bf16;
8. train: ``axcnn_torch.cli.main_classification.main`` with the assembled
   preset at full width, batch 128, bf16, on synthetic data; every logged
   loss finite, the kernels launched 3 + 3 + 9 times per step (plus the
   end-of-run eval's forwards); step time, images/s and peak memory;
9. train_parity: one full-width train step in fp32 (TF32 off), batch 4,
   with DropBlock and mixup active, on the card through the kernels against
   the CPU through the plain versions, from the same state and seeds;
10. checkpoint: a full-width assembled R50 state after 3 b128 bf16 steps is
    saved and restored into a fresh state; every tensor must come back bit
    for bit with the fresh state's strides; save and restore seconds, MB;
11. resume: the training CLI at full width, b128, bf16, 5 steps with a
    checkpoint at step 5, the hang watchdog armed and steps 1-2 profiled,
    then the same command to 10 steps: it must log ``restore`` at step 5,
    only finite losses, 3 + 3 + 9 launches per step, and a trace;
12. serve_ckpt: ``predict`` on what the resumed run saved; its top-5 lines
    must equal those of the restored state's own EMA ``eval_logits``;
13. kd: the training CLI with ``--config=assemble_resnet152_kd`` at full
    width, the resumed R50 run as the teacher, global batch 1024 as 8
    micro-batches of 128, bf16, 3 steps; finite losses, the launches per
    step (per micro-batch: the student's 3 forward and 3 backward BlurPool
    launches, the teacher's 3 forward launches, 39 DropBlock masks), step
    time, images/s and peak memory.

Every phase prints one JSON line; any failure raises and exits non-zero.
The last two lines are the kernels' summary and the result line.
"""

import contextlib
import dataclasses
import glob
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
from axcnn_torch.kernels import dropblock as kdrop

SLICE_SHAPES = [(32, 56, 56, 128), (32, 28, 28, 256), (32, 14, 14, 512)]
CHECK_SHAPES = SLICE_SHAPES + [(8, 112, 112, 64), (3, 15, 17, 96)]
# BlurPool backward: the forward INPUT extents (gradients are half-size)
BWD_CHECK_SHAPES = SLICE_SHAPES + [(3, 15, 17, 96), (2, 8, 9, 8)]
# DropBlock sites of the assembled R50 at 224x224: (H, W, block size)
MASK_SHAPES = [(14, 14, 7), (7, 7, 7), (15, 17, 5)]
MASK_TIME_SHAPES = MASK_SHAPES[:2]
GAMMAS = (0.0, 0.02, 0.1)
TIME_BATCH = 128
TRAIN_STEPS = 20
RESUME_STEPS = (5, 10)  # the first run's steps, then the resumed run's end
KD_BATCH, KD_ACCUM, KD_STEPS = 1024, 8, 3
L2_FLUSH_BYTES = 256 << 20  # timing inputs cycle through at least this much (H100 L2: 50 MB)
SLEEP_CYCLES = 200_000_000  # ~0.1 s at the H100's clock: longer than enqueueing 50 calls
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
    """Mean device ms per call, cycling through the inputs ``xs``. A sleep
    kernel queued first holds the card while the host enqueues every call,
    so the calls run back to back and the events time the device, not the
    host's launch overhead."""
    for x in xs[:3]:
        fn(x)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for i in range(iters):
        fn(xs[i % len(xs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _check_equal(kernel, shape, case, got, want):
    """Emit one kernel_check line; raise unless ``got`` equals ``want``.
    ``case`` names the dtype or the drop rate checked."""
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.float() - want.float()).abs()
    err = diff.max().item() if diff.numel() else 0.0
    ok = bool(torch.equal(got, want))
    emit("kernel_check", kernel=kernel, shape=list(shape), case=str(case),
         max_abs_err=err, n_differ=int((diff > 0).sum()), numel=got.numel(),
         tolerance="bit-exact", ok=ok)
    if not ok:
        raise AssertionError(f"{kernel} disagrees with its plain version at {shape} {case}")
    return err


def _expected_drop_fraction(h, w, bs, gamma):
    """E[dropped share]: pixel p is dropped with probability 1-(1-gamma)^k(p),
    k(p) the number of valid centres whose block covers p."""
    half0, half1 = (bs - 1) // 2, bs // 2
    valid = np.zeros((h, w))
    valid[half0:h - half1, half0:w - half1] = 1
    k = np.array([[valid[max(r - half0, 0):r + half1 + 1,
                         max(c - half0, 0):c + half1 + 1].sum()
                   for c in range(w)] for r in range(h)])
    return float((1 - (1 - gamma) ** k).mean())


def _seeds(n, gen):
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)


def kernel_check_phase():
    """Each kernel against its plain version; returns max abs error by kernel."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {"fwd": 0.0, "bwd": 0.0, "mask": 0.0}
    for shape in CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = _nchw_input(shape, dtype, gen)
            got = kblur.blur_pool_cuda(x)
            torch.cuda.synchronize()
            assert got.is_contiguous(memory_format=torch.channels_last)
            errs["fwd"] = max(errs["fwd"], _check_equal(
                "blur_pool3_s2_fwd", shape, dtype, got, kblur.blur_pool_reference(x)))
    for n, h, w, c in BWD_CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            g = _nchw_input((n, (h + 1) // 2, (w + 1) // 2, c), dtype, gen)
            got = kblur.blur_pool_bwd_cuda(g, (h, w))
            torch.cuda.synchronize()
            want = kblur.blur_pool_bwd_reference(g, (h, w))
            errs["bwd"] = max(errs["bwd"], _check_equal(
                "blur_pool3_s2_bwd", (n, h, w, c), dtype, got, want))
            # the autograd Function against autograd through the plain forward
            x = _nchw_input((n, h, w, c), dtype, gen).requires_grad_()
            kblur.BlurPool3S2.apply(x).backward(g)
            x2 = x.detach().clone().requires_grad_()
            kblur.blur_pool_reference(x2).backward(g)
            torch.cuda.synchronize()
            _check_equal("BlurPool3S2.backward", (n, h, w, c), dtype, x.grad, x2.grad)
    for h, w, bs in MASK_SHAPES:
        for gamma in GAMMAS:
            seeds = _seeds(TIME_BATCH, gen)
            mask, counts = kdrop.dropblock_mask_cuda(seeds, gamma, h, w, bs)
            torch.cuda.synchronize()
            want_m, want_c = kdrop.dropblock_mask_reference(seeds, gamma, h, w, bs)
            shape = (TIME_BATCH, h, w, bs)
            errs["mask"] = max(errs["mask"], _check_equal(
                "dropblock_mask", shape, "gamma=%g" % gamma, mask, want_m),
                _check_equal("dropblock_mask.counts", shape, "gamma=%g" % gamma,
                             counts, want_c))
            emit("mask_stats", hw_bs=[h, w, bs], gamma=gamma, samples=TIME_BATCH,
                 drop_fraction=1 - mask.mean().item(),
                 expected=_expected_drop_fraction(h, w, bs, gamma))
    return errs


def _time_pair(kernel, plain, xs):
    """plain, kernel, kernel, plain: the two orders bracket any drift."""
    p1 = _time_ms(plain, xs)
    k1 = _time_ms(kernel, xs)
    k2 = _time_ms(kernel, xs)
    p2 = _time_ms(plain, xs)
    return (k1 + k2) / 2, (p1 + p2) / 2, [k1, k2], [p1, p2]


def _rotating(x):
    # copies whose sum exceeds the L2 cache several times over, so each call
    # reads its input from device memory
    return [x] + [x.clone() for _ in range(-(-L2_FLUSH_BYTES // x.nbytes) - 1)]


def kernel_time_phase():
    """Each kernel and its plain version at batch 128, bf16; total ms per
    step's worth of shapes, by kernel."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    totals = {k: [0.0, 0.0] for k in ("fwd", "bwd", "mask")}
    for n, h, w, c in SLICE_SHAPES:
        for kind in ("fwd", "bwd"):
            if kind == "fwd":
                shape = (TIME_BATCH, h, w, c)
                kernel, plain = kblur.blur_pool_cuda, kblur.blur_pool_reference
                nbytes_of = lambda x: x.nbytes + x.nbytes // 4  # noqa: E731
            else:
                shape = (TIME_BATCH, (h + 1) // 2, (w + 1) // 2, c)
                kernel = lambda g, hw=(h, w): kblur.blur_pool_bwd_cuda(g, hw)  # noqa: E731
                plain = lambda g, hw=(h, w): kblur.blur_pool_bwd_reference(g, hw)  # noqa: E731
                nbytes_of = lambda g: g.nbytes * 5  # noqa: E731
            xs = _rotating(_nchw_input(shape, torch.bfloat16, gen))
            k, p, ks, ps = _time_pair(kernel, plain, xs)
            emit("kernel_time", kernel=kind, shape_nhwc=list(shape), dtype="bf16",
                 kernel_us=k * 1e3, plain_us=p * 1e3, kernel_runs_us=[v * 1e3 for v in ks],
                 plain_runs_us=[v * 1e3 for v in ps], rotating_inputs=len(xs),
                 kernel_gb_per_s=nbytes_of(xs[0]) / (k * 1e-3) / 1e9)
            del xs
            totals[kind][0] += k
            totals[kind][1] += p
    for h, w, bs in MASK_TIME_SHAPES:
        # the mask kernel reads 512 bytes of seeds: there is no L2 to flush
        seeds = [_seeds(TIME_BATCH, gen) for _ in range(16)]
        k, p, ks, ps = _time_pair(
            lambda sd: kdrop.dropblock_mask_cuda(sd, 0.02, h, w, bs),
            lambda sd: kdrop.dropblock_mask_reference(sd, 0.02, h, w, bs), seeds)
        emit("kernel_time", kernel="mask", shape=[TIME_BATCH, h, w, bs], gamma=0.02,
             kernel_us=k * 1e3, plain_us=p * 1e3, kernel_runs_us=[v * 1e3 for v in ks],
             plain_runs_us=[v * 1e3 for v in ps])
        totals["mask"][0] += k
        totals["mask"][1] += p
    return totals


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


def _zero_counts():
    kblur.LAUNCHES = kblur.BWD_LAUNCHES = kdrop.LAUNCHES = 0


def _counts():
    return {"fwd": kblur.LAUNCHES, "bwd": kblur.BWD_LAUNCHES, "mask": kdrop.LAUNCHES}


def serve_phase():
    from axcnn_torch.cli import predict

    with tempfile.TemporaryDirectory() as tmp:
        paths = _write_jpegs(tmp, 32)
        # a model_dir of its own, without checkpoints: the seeded random init
        model_dir = os.path.join(tmp, "no_checkpoints")
        _zero_counts()
        for n in (1, 8, 32):
            before = kblur.LAUNCHES
            out, err = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = predict.main([*(f"--image={p}" for p in paths[:n]),
                                   "--config=assemble_resnet50",
                                   f"--runtime.model_dir={model_dir}"])
            seconds = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"predict exited {rc}: {err.getvalue()}")
            if "random init" not in err.getvalue():
                raise AssertionError(f"predict did not serve the random init: {err.getvalue()}")
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
        if kblur.BWD_LAUNCHES or kdrop.LAUNCHES:
            raise AssertionError(f"serving launched training kernels: {_counts()}")
        return _counts()


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


def _run_cli(argv):
    """``main_classification.main(argv)`` with the kernel counts zeroed just
    before; returns (metrics, counts, seconds, peak bytes, records)."""
    from axcnn_torch.cli import main_classification

    model_dir = next(a.split("=", 1)[1] for a in argv if a.startswith("--runtime.model_dir="))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, err = io.StringIO(), io.StringIO()
    _zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        metrics = main_classification.main(argv)
    seconds = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return metrics, counts, seconds, peak, records


def _step_walls(train):
    """log_every=1: each record follows a host sync on the step's loss, so
    the gaps between records are CUDA-synchronized step walls."""
    return np.diff([r["time"] for r in train])


def train_phase(smi):
    """The training CLI at full width, b128, bf16, on synthetic data."""
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--config=assemble_resnet50", "--data.use_synthetic_data",
                f"--train.train_steps={TRAIN_STEPS}", f"--train.batch_size={TIME_BATCH}",
                "--train.log_every=1", f"--runtime.model_dir={tmp}"]
        metrics, counts, seconds, peak, records = _run_cli(argv)
    train = [r for r in records if r["tag"] == "train"]
    losses = [r["loss"] for r in train]
    assert [r["step"] for r in train] == list(range(1, TRAIN_STEPS + 1)), records
    assert all(np.isfinite(losses)), losses
    assert metrics["count"] == 4 * TIME_BATCH, metrics  # the synthetic eval set
    walls = _step_walls(train)
    step_s = float(walls.mean())
    eval_batches = 4
    want = {"fwd": 3 * TRAIN_STEPS + 3 * eval_batches, "bwd": 3 * TRAIN_STEPS,
            "mask": 9 * TRAIN_STEPS}
    emit("train", model="assemble_resnet50", batch=TIME_BATCH, dtype="bf16",
         steps=TRAIN_STEPS, first_loss=losses[0], last_loss=losses[-1],
         mean_step_ms=step_s * 1e3, step_ms_min=float(walls.min()) * 1e3,
         step_ms_max=float(walls.max()) * 1e3, train_img_per_s=TIME_BATCH / step_s,
         max_memory_allocated_gib=peak / 2 ** 30, launches=counts, expected=want,
         eval=metrics, seconds=seconds, card=smi)
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    return counts


def _state_copy(state, device):
    """A copy of a train state on ``device`` (channels_last weights)."""
    import copy

    new = copy.deepcopy(state)
    new.model.to(device, memory_format=torch.channels_last)
    new.velocity = {k: v.to(device) for k, v in new.velocity.items()}
    new.ema = {k: v.to(device) for k, v in new.ema.items()}
    return new


def _update_errors(old, new, ref):
    """Per-parameter relative L2 of the update ``new - old`` against
    ``ref - old``, in float64."""
    errs = {}
    for k, p0 in old.items():
        want = (ref[k] - p0).double()
        errs[k] = float(((new[k] - p0).double() - want).norm() / want.norm().clamp_min(1e-30))
    return errs


def train_parity_phase():
    """One full-width train step, fp32 with TF32 off, batch 4, DropBlock and
    mixup active, from one state, batch and seeds: on the card through the
    kernels, on the CPU through the plain versions, and on the CPU in
    float64 (every fp32 cast of the port re-pointed to float64). At batch 4
    fp32 rounding flips ReLU and max-pool ties, so two fp32 runs differ by
    ~1e-2 per leaf whatever their device; the check is that the card's fp32
    step is as near the float64 step as the CPU's own fp32 step is."""
    from axcnn_torch.core.dtypes import DEFAULT_POLICY, Policy, set_fp32_precision
    from axcnn_torch.train.schedules import make_lr_schedule
    from axcnn_torch.train.train_step import create_train_state, make_train_step

    set_fp32_precision(DEFAULT_POLICY)
    n, step, total = 4, 5, 10
    cfg = _assembled_cfg()
    cpu = create_train_state(cfg, generator=torch.Generator().manual_seed(SEED),
                             device="cpu", use_ema=True)
    _perturb_bn(cpu.model, SEED)
    cpu.step = step  # keep-prob 0.95: DropBlock drops
    card, cpu64 = _state_copy(cpu, "cuda"), _state_copy(cpu, "cpu")
    cpu64.model.double()
    cpu64.velocity = {k: v.double() for k, v in cpu64.velocity.items()}
    cpu64.ema = {k: v.double() for k, v in cpu64.ema.items()}
    kw = dict(lr_schedule=make_lr_schedule(base_lr=0.1 * n / 256, total_steps=total,
                                           warmup_steps=2),
              total_steps=total, label_smoothing=0.1, mixup_alpha=0.2)
    train_step = make_train_step(cfg, **kw)
    rng = np.random.default_rng(SEED)
    batch = {"images": torch.from_numpy(rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)),
             "labels": torch.from_numpy(rng.integers(0, 1001, n).astype(np.int64))}
    old = {k: p.detach().clone() for k, p in cpu.model.named_parameters()}

    _zero_counts()
    card, m_card = train_step(card, {k: v.cuda() for k, v in batch.items()}, SEED + 1)
    torch.cuda.synchronize()
    launched = _counts()
    cpu, m_cpu = train_step(cpu, batch, SEED + 1)
    to_float = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        step64 = make_train_step(cfg, policy=Policy(torch.float64, torch.float64), **kw)
        cpu64, m_64 = step64(cpu64, batch, SEED + 1)
    finally:
        torch.Tensor.float = to_float

    params = lambda st: {k: p.detach().cpu() for k, p in st.model.named_parameters()}  # noqa: E731
    ref = params(cpu64)
    e_card = _update_errors(old, params(card), ref)
    e_cpu = _update_errors(old, params(cpu), ref)
    e_pair = _update_errors(old, params(card), params(cpu))
    med = lambda e: float(np.median(list(e.values())))  # noqa: E731
    loss_rel = abs(m_card["loss"].item() - m_64["loss"].item()) / abs(m_64["loss"].item())
    tol = dict(loss_rel=1e-4, median_vs_cpu_fp32=3.0, worst_vs_cpu_fp32=3.0)
    ok = (loss_rel <= tol["loss_rel"]
          and med(e_card) <= tol["median_vs_cpu_fp32"] * med(e_cpu)
          and max(e_card.values()) <= tol["worst_vs_cpu_fp32"] * max(e_cpu.values())
          and launched == {"fwd": 3, "bwd": 3, "mask": 9})
    emit("train_parity", batch=n, step=step, dtype="fp32", tf32=False,
         loss_card=m_card["loss"].item(), loss_cpu=m_cpu["loss"].item(),
         loss_fp64=m_64["loss"].item(), loss_rel_card_vs_fp64=loss_rel,
         mixup_lam=m_cpu["mixup_lam"],
         card_vs_fp64={"median": med(e_card), "worst": max(e_card.values()),
                       "worst_leaf": max(e_card, key=e_card.get)},
         cpu_fp32_vs_fp64={"median": med(e_cpu), "worst": max(e_cpu.values())},
         card_vs_cpu_fp32={"median": med(e_pair), "worst": max(e_pair.values())},
         leaves=len(e_card), tolerance=tol, launches_per_step=launched, ok=ok)
    if not ok:
        raise AssertionError("card-vs-CPU train step parity failed")


def _state_tensors(state):
    return {"model": state.model.state_dict(), "velocity": state.velocity,
            "ema": state.ema}


def checkpoint_phase(smi, tmp):
    """A full-width assembled R50 state after 3 b128 bf16 train steps, saved
    and restored into a fresh state: bit for bit, in the fresh strides."""
    from axcnn_torch.ckpt.checkpoint import CheckpointManager
    from axcnn_torch.core.dtypes import BF16_POLICY
    from axcnn_torch.train.schedules import make_lr_schedule
    from axcnn_torch.train.train_step import create_train_state, make_train_step

    cfg = _assembled_cfg()
    state = create_train_state(cfg, generator=torch.Generator().manual_seed(SEED),
                               device="cuda", use_ema=True)
    step = make_train_step(cfg, lr_schedule=make_lr_schedule(
        base_lr=0.05, total_steps=10, warmup_steps=0), total_steps=10,
        policy=BF16_POLICY, label_smoothing=0.1, mixup_alpha=0.2)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = {"images": torch.randint(0, 256, (TIME_BATCH, 224, 224, 3), generator=gen,
                                     device="cuda", dtype=torch.uint8),
             "labels": torch.randint(0, 1001, (TIME_BATCH,), generator=gen, device="cuda")}
    _zero_counts()
    for _ in range(3):
        state, metrics = step(state, batch, SEED + 1)
    torch.cuda.synchronize()
    counts = _counts()
    mgr = CheckpointManager(os.path.join(tmp, "ckpt"), max_to_keep=1)
    t0 = time.perf_counter()
    mgr.save(state)
    save_s = time.perf_counter() - t0
    fresh = create_train_state(cfg, generator=torch.Generator().manual_seed(SEED + 9),
                               device="cuda", use_ema=True)
    strides = {f: {k: t.stride() for k, t in d.items()}
               for f, d in _state_tensors(fresh).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored, _, _ = mgr.restore(fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    n, bad = 0, []
    for field, want in _state_tensors(state).items():
        got = _state_tensors(restored)[field]
        for k, t in want.items():
            n += 1
            if not (torch.equal(got[k], t) and got[k].stride() == strides[field][k]
                    and got[k].device == t.device):
                bad.append(f"{field}/{k}")
    ok = not bad and restored.step == 3 and counts == {"fwd": 9, "bwd": 9, "mask": 27}
    emit("checkpoint", model="assemble_resnet50", steps=3, batch=TIME_BATCH, dtype="bf16",
         loss=metrics["loss"].item(), tensors=n, differ=bad[:5],
         file_mb=os.path.getsize(mgr.path(3)) / 1e6, save_s=save_s, restore_s=restore_s,
         launches=counts, card=smi, ok=ok)
    if not ok:
        raise AssertionError(f"checkpoint round trip failed: {bad[:5]} {counts}")
    return counts


def _resume_argv(model_dir, steps):
    return ["--config=assemble_resnet50", "--data.use_synthetic_data",
            f"--train.train_steps={steps}", f"--train.batch_size={TIME_BATCH}",
            "--train.log_every=1", f"--runtime.save_checkpoint_steps={RESUME_STEPS[0]}",
            "--runtime.hang_watchdog_s=300", "--runtime.profile_steps=2",
            f"--runtime.model_dir={model_dir}"]


def resume_phase(smi, model_dir):
    """The CLI for 5 steps, then the same command to 10: the second run
    restores step 5 and trains 6-10 through the kernels."""
    first, second = RESUME_STEPS
    eval_fwd = 3 * 4  # the end-of-run eval: 4 synthetic batches
    runs = []
    for start, end in ((0, first), (first, second)):
        metrics, counts, seconds, peak, records = _run_cli(_resume_argv(model_dir, end))
        n = end - start
        want = {"fwd": 3 * n + eval_fwd, "bwd": 3 * n, "mask": 9 * n}
        new = records[sum(len(r["records"]) for r in runs):]
        train = [r for r in new if r["tag"] == "train"]
        runs.append(dict(records=new, counts=counts, want=want, seconds=seconds,
                         steps=[r["step"] for r in train],
                         losses=[r["loss"] for r in train], walls=_step_walls(train)))
    r1, r2 = runs
    restore = [r for r in r2["records"] if r["tag"] == "restore"]
    traces = glob.glob(os.path.join(model_dir, "profile", "*.json"))
    ok = (r1["steps"] == list(range(1, first + 1))
          and r2["steps"] == list(range(first + 1, second + 1))
          and [r["step"] for r in restore] == [first]
          and all(np.isfinite(r1["losses"] + r2["losses"]))
          and all(r["counts"] == r["want"] for r in runs) and bool(traces))
    emit("resume", model="assemble_resnet50", batch=TIME_BATCH, dtype="bf16",
         restored_at=[r["step"] for r in restore], losses=r1["losses"] + r2["losses"],
         launches=[r["counts"] for r in runs], expected=[r["want"] for r in runs],
         resumed_mean_step_ms=float(r2["walls"].mean()) * 1e3,
         seconds=[r["seconds"] for r in runs], traces=[os.path.basename(t) for t in traces],
         checkpoints=sorted(os.listdir(os.path.join(model_dir, "checkpoints"))),
         card=smi, ok=ok)
    if not ok:
        raise AssertionError("resume phase failed")
    return r2["counts"]


def _predict_lines(logits, paths):
    """predict's output lines for fp32 ``logits``, computed as it does."""
    e = np.exp(logits - logits.max(axis=-1, keepdims=True))
    probs = e / e.sum(axis=-1, keepdims=True)
    return [{"image": p, "top5": [[int(i), round(float(pr[i]), 5)]
                                  for i in np.argsort(pr)[::-1][:5]]}
            for p, pr in zip(paths, probs)]


def serve_ckpt_phase(model_dir, tmp):
    """``predict`` on the resumed run's checkpoint against the restored EMA
    state's own ``eval_logits`` on the same decoded batch."""
    from axcnn.data.datasets import get_dataset
    from axcnn.data.preprocessing import preprocess_eval
    from axcnn_torch.ckpt.checkpoint import CheckpointManager
    from axcnn_torch.cli import predict
    from axcnn_torch.core.dtypes import BF16_POLICY
    from axcnn_torch.train.train_step import create_train_state, eval_logits

    paths = _write_jpegs(tmp, 8)
    out, err = io.StringIO(), io.StringIO()
    _zero_counts()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = predict.main([*(f"--image={p}" for p in paths), "--config=assemble_resnet50",
                           f"--runtime.model_dir={model_dir}"])
    counts = _counts()
    if rc != 0:
        raise AssertionError(f"predict exited {rc}: {err.getvalue()}")
    got = [json.loads(line) for line in out.getvalue().splitlines()]
    state = create_train_state(_assembled_cfg(), generator=torch.Generator(),
                               device="cuda", use_ema=True)
    state, _, _ = CheckpointManager(os.path.join(model_dir, "checkpoints")).restore(state)
    u8 = np.stack([preprocess_eval(open(p, "rb").read(), image_size=224, resize_min=256)
                   for p in paths])
    info = get_dataset("imagenet")
    logits = eval_logits(state, torch.from_numpy(u8).cuda(), policy=BF16_POLICY, use_ema=True,
                         mean_rgb=info.mean_rgb, stddev_rgb=info.stddev_rgb)
    want = _predict_lines(logits.cpu().numpy(), paths)
    ok = (got == want and "random init" not in err.getvalue()
          and counts == {"fwd": 3, "bwd": 0, "mask": 0})
    emit("serve_ckpt", images=len(paths), step=state.step, launches=counts,
         top5_equal=got == want, first=got[0], want_first=want[0], ok=ok)
    if not ok:
        raise AssertionError("serving the checkpoint disagrees with its restored state")
    return counts


def kd_phase(smi, teacher_dir, model_dir):
    """Assemble-ResNet-152 distilled from the resumed R50 run, global batch
    1024 as 8 micro-batches of 128, bf16, through the CLI."""
    argv = ["--config=assemble_resnet152_kd", "--data.use_synthetic_data",
            f"--train.batch_size={KD_BATCH}", f"--train.grad_accum_steps={KD_ACCUM}",
            f"--train.train_steps={KD_STEPS}", "--train.log_every=1",
            f"--train.kd_teacher_checkpoint={teacher_dir}/checkpoints",
            f"--runtime.model_dir={model_dir}"]
    metrics, counts, seconds, peak, records = _run_cli(argv)
    train = [r for r in records if r["tag"] == "train"]
    losses = [r["loss"] for r in train]
    walls = _step_walls(train)
    step_s = float(walls.mean())
    micro = KD_STEPS * KD_ACCUM
    want = {"fwd": micro * (3 + 3) + 3 * 4, "bwd": micro * 3, "mask": micro * 39}
    ok = ([r["step"] for r in train] == list(range(1, KD_STEPS + 1))
          and all(np.isfinite(losses)) and counts == want
          and metrics["count"] == 4 * KD_BATCH)
    emit("kd", model="assemble_resnet152_kd", teacher="assemble_resnet50",
         batch=KD_BATCH, grad_accum_steps=KD_ACCUM, micro_batch=KD_BATCH // KD_ACCUM,
         dtype="bf16", steps=KD_STEPS, losses=losses, step_ms=[w * 1e3 for w in walls],
         mean_step_ms=step_s * 1e3, train_img_per_s=KD_BATCH / step_s,
         max_memory_allocated_gib=peak / 2 ** 30, launches=counts, expected=want,
         eval=metrics, seconds=seconds, card=smi, ok=ok)
    if not ok:
        raise AssertionError(f"KD phase failed: launches {counts}, expected {want}")
    return counts


KERNELS = (  # (key, name, source, the TPU kernel it replaces)
    ("fwd", "blur_pool3_s2_fwd", "axcnn_torch/csrc/blurpool.cu",
     "axcnn/pallas/blurpool.py:73"),
    ("bwd", "blur_pool3_s2_bwd", "axcnn_torch/csrc/blurpool.cu",
     "axcnn/pallas/blurpool.py:123"),
    ("mask", "dropblock_mask", "axcnn_torch/csrc/dropblock.cu",
     "axcnn/pallas/dropblock.py:100"),
)


def main():
    smi = device_phase()
    build_phase()
    errs = kernel_check_phase()
    times = kernel_time_phase()
    paths = {"serve": serve_phase()}
    parity_phase()
    throughput_phase(smi)
    paths["train"] = train_phase(smi)
    train_parity_phase()
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "resume")
        paths["checkpoint"] = checkpoint_phase(smi, tmp)
        paths["resume"] = resume_phase(smi, run_dir)
        paths["serve_ckpt"] = serve_ckpt_phase(run_dir, tmp)
        paths["kd"] = kd_phase(smi, run_dir, os.path.join(tmp, "kd"))
    for key, name, *_ in KERNELS:
        if not any(counts[key] for counts in paths.values()):
            raise AssertionError(f"{name} was never launched on the main paths")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(counts[key] for counts in paths.values()),
        "launches_by_path": {path: counts[key] for path, counts in paths.items()},
        "max_abs_err": errs[key], "ms": times[key][0], "plain_ms": times[key][1]}
        for key, name, source, replaces in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
