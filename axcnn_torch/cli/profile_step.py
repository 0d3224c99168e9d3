"""Step walls and device-time breakdown of the train step on one CUDA card.

    python -m axcnn_torch.cli.profile_step --what=step       # the R50 step
    python -m axcnn_torch.cli.profile_step --what=dropblock  # its DropBlock sites
    python -m axcnn_torch.cli.profile_step --what=kd         # the R152 KD step
    python -m axcnn_torch.cli.profile_step --what=remat      # the R50 step, remat=blocks
    python -m axcnn_torch.cli.profile_step --what=dp --ranks=2  # the R50 step on 2 cards
    python -m axcnn_torch.cli.profile_step --what=spatial --ranks=2 --image_size=448
                                                             # H split over 2 cards
    python -m axcnn_torch.cli.profile_step --what=spatial --ranks=2 --image_size=448 \
        --remat=blocks --grad_accum_steps=2                  # ... with its memory levers
    python -m axcnn_torch.cli.profile_step --what=bl         # bl_resnet50 and its ablation
    python -m axcnn_torch.cli.profile_step --what=flops      # their forward FLOPs (no card)
    python -m axcnn_torch.cli.profile_step --what=crc        # the host's CRC32C rates (no card)
    python -m axcnn_torch.cli.profile_step --what=kd_ranks   # a KD run on CPU ranks (no card)

``step``: ``assemble_resnet50`` at full width, 1001 classes, batch 128, bf16,
random uint8 images on the card, the train step as ``make_train_step``
builds it (mixup 0.2, label smoothing 0.1); ``remat``: the same step with
``model.remat=blocks``; ``dp``: the same step data-parallel, one rank a
card over NCCL, batch 128 a rank (rank 0 measures; every rank runs the
same steps); ``spatial``: the same step with each image's H split over
``--ranks`` cards (``axcnn_torch.parallel.spatial``; one data shard, the
batch's images at full H on every rank, rank 0 measures), with
``--remat=blocks`` and ``--grad_accum_steps=A`` (the batch of 128 as A
micro-batches) if asked: the same step with and without remat splits off
the replay's cost. ``--image_size`` (224 by default) sets the images' side
for ``step``, ``remat``, ``dp`` and ``spatial``. ``dropblock``: the R50 step's
nine DropBlock sites alone (6 at 14x14x1024 and 3 at 7x7x2048, batch 128,
bf16, channels_last), each run forward and then backward through
``axcnn_torch.ops.dropblock.dropblock``; one repetition is one step's worth.
``kd``: ``assemble_resnet152_kd`` (R152 student, batch 1024 as 8
micro-batches of 128, bf16) with a seeded ``assemble_resnet50`` teacher.
``bl``: the ``bl_resnet50`` preset's step (Big-Little, alpha 2, beta 4) at
batch 128, then in the same process its ablation (``bl_alpha = bl_beta =
0``: the same recipe on plain stages), each measured as ``step`` is, with
the forward GFLOPs of one image of each (``flops``: those alone, counted
by ``torch.utils.flop_counter.FlopCounterMode`` on the meta device, so
with no card; convolutions and matmuls only). ``crc``: the MB/s of
``data.tfrecord.crc32c`` (numpy lanes) and of the byte loop it replaced
(``crc32c_bytewise``) on seeded bytes on the host CPU, with no card: the
lanes on 4 kB to 16 MB, each the best of 3 passes over at least 8 MB, the
byte loop on 1 MB. ``kd_ranks``: where the acceptance drive's config 5 spends
its time, on the host CPU with no card: its command (``main_classification
--config=assemble_resnet152_kd`` with a seeded ``assemble_resnet50``
teacher checkpoint, Gloo ranks, 64x64, 3 steps, then the eval) on
synthetic data, each step logged, as 8 ranks in bf16 and in fp32 and as 2
ranks (b16), and as 1 rank on the 2 images one of 8 ranks takes, on one
thread (a rank's compute without the collectives); per variant the
seconds from the launch to the first step's record (start-up: interpreters,
imports, models, the teacher's restore, the first step), between the
first and the last step's records (2 steps), to the eval's record and to
the exit.

After three warm-up steps, ``--untraced`` steps are timed one by one on the
host clock: the wall until the step's loss reached the host (a synchronize
for ``dropblock``) and the part of it the host spent enqueueing; then one
``torch.profiler`` window of ``--steps`` steps (0: none). Prints one JSON
line: the untraced walls' median, minimum, mean and maximum, and per step
of the window its wall, the device busy time (the union of the device
events' intervals), the idle share (1 - busy / wall; the profiler lengthens
the wall, so it overstates an untraced share), the device events, and
device time by category and by the 12 largest kernels (``dp`` and
``spatial``: and rank 0's peak allocated memory). The categories are
matched on the kernel's name, so a copy or a cast counts as elementwise.
Needs a CUDA card; measures whichever ``axcnn_torch`` is first on the path.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 128
SEED = 0
# the assembled R50's DropBlock sites at 224x224: (H, W, C, sites per step)
DROPBLOCK_SITES = ((14, 14, 1024, 6), (7, 7, 2048, 3))
CATEGORIES = (  # (category, substrings of a device event's name); the first match wins
    ("hand-written kernels", ("blur3_s2", "dropblock_")),
    ("NCCL collectives", ("nccl",)),
    ("elementwise_kernel<128, 2>", ("elementwise_kernel<128, 2,",)),
    ("other elementwise, copies and casts", ("elementwise_kernel", "elementwise")),
    ("reductions", ("reduce_kernel", "Reduce", "reduce")),
    ("optimizer and EMA (_foreach)", ("multi_tensor_apply",)),
    ("memcpy and memset", ("Memcpy", "Memset")),
    ("convolutions and GEMMs", ("cudnn", "xmma", "gemm", "cutlass", "conv", "sm90", "dgrad",
                                "wgrad", "implicit")),
)


def device_events(prof) -> list:
    """The device events (kernels, copies, sets) of a ``torch.profiler``
    window, as ``FunctionEvent``s. The spans that annotations draw on the
    device timeline (ProcessGroupNCCL's ``nccl:all_reduce`` over its kernel)
    are left out: the kernels under them are counted already."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not (getattr(e, "is_user_annotation", False) or e.name.startswith("nccl:"))]


def category(name: str) -> str:
    return next((cat for cat, keys in CATEGORIES if any(k in name for k in keys)), "other")


def busy_us(spans) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, -float("inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def breakdown(spans, steps: int, wall_s: float) -> dict:
    """Per-step totals of a window of ``steps`` steps: ``spans`` holds each
    device event's ``(name, start µs, end µs)``."""
    spans = list(spans)
    by_cat, by_name = {}, {}
    for name, start, end in spans:
        by_cat[category(name)] = by_cat.get(category(name), 0.0) + end - start
        by_name[name] = by_name.get(name, 0.0) + end - start
    busy_ms = busy_us((start, end) for _, start, end in spans) / 1e3 / steps
    wall_ms = wall_s * 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "steps": steps, "wall_ms": wall_ms, "busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / wall_ms, "device_events": len(spans) / steps,
        "by_category_ms": {k: v / 1e3 / steps for k, v in sorted(by_cat.items(),
                                                                  key=lambda kv: -kv[1])},
        "by_category_share": {k: v / 1e3 / steps / busy_ms for k, v in by_cat.items()},
        "top_kernels_ms": [[name[:160], v / 1e3 / steps] for name, v in top],
    }


def _stats(values) -> dict:
    v = np.asarray(values) * 1e3
    return {"median": float(np.median(v)), "min": float(v.min()), "mean": float(v.mean()),
            "max": float(v.max())}


def untraced_steps(enqueue, wait, untraced: int, warmup: int = 3) -> dict:
    """``warmup`` steps, then ``untraced`` steps each timed to the end of its
    ``wait``: the walls' and the host enqueues' statistics in ms."""
    for _ in range(warmup):
        wait(enqueue())
    walls, enqueues = [], []
    for _ in range(untraced):
        t0 = time.perf_counter()
        pending = enqueue()
        t1 = time.perf_counter()
        wait(pending)
        walls.append(time.perf_counter() - t0)
        enqueues.append(t1 - t0)
    return {"untraced_steps": untraced, "untraced_wall_ms": _stats(walls),
            "untraced_enqueue_ms": _stats(enqueues)} if untraced else {}


def _measure(enqueue, wait, untraced: int, steps: int) -> dict:
    """``enqueue()`` runs one step and returns what ``wait`` needs to block
    until the step is done."""
    from torch.profiler import ProfilerActivity, profile

    result = untraced_steps(enqueue, wait, untraced)
    if steps:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                wait(enqueue())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        result.update(breakdown(((e.name, e.time_range.start, e.time_range.end)
                                 for e in device_events(prof)), steps, wall))
    return result


def _wait_loss(metrics):
    metrics["loss"].item()  # the host waits for the step, as the loop's log does


def preset_model(name: str, **changes):
    """A preset's ``ModelConfig`` with ImageNet's 1001-way head."""
    import dataclasses

    from axcnn_torch.utils.config import load_preset

    return dataclasses.replace(load_preset(name).model, num_classes=1001, **changes)


def forward_gflops(cfg, image_size: int = 224) -> float:
    """GFLOPs of one image's eval forward through ``ResNet(cfg)``, as
    ``FlopCounterMode`` counts them (convolutions and matmuls), on the meta
    device."""
    from torch.utils.flop_counter import FlopCounterMode

    from axcnn_torch.models.resnet import ResNet

    with torch.device("meta"):
        model = ResNet(cfg).eval()
        images = torch.empty(1, image_size, image_size, 3)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(images)
    return counter.get_total_flops() / 1e9


def _bl_models():
    bl = preset_model("bl_resnet50")
    return {"bl": bl, "ablation": preset_model("bl_resnet50", bl_alpha=0, bl_beta=0)}


SCHEDULE = dict(base_lr=0.05, total_steps=100, warmup_steps=0)


def _step_runner(cfg, *, kd: bool = False, group=None, spatial=None, image_size: int = 224,
                 grad_accum_steps: int = 1, device="cuda", batch_size: int = BATCH,
                 schedule=SCHEDULE, teacher_cfg=None, batches=None, **step_kw):
    """``(enqueue, wait)`` for ``_measure``: ``enqueue()`` runs one bf16 train
    step of ``cfg`` (mixup 0.2, label smoothing 0.1, the learning rate of
    ``schedule``) on ``device`` and returns its metrics. The step takes a
    seeded random uint8 batch of ``batch_size`` images resident on the
    device, or, with ``batches``, the next batch of that iterator.
    ``teacher_cfg`` adds a seeded frozen teacher (``step_kw`` then carries
    ``kd_temp`` and ``kd_alpha``); ``kd``: the KD preset's (R50 teacher,
    batch 1024 as 8 micro-batches)."""
    from axcnn_torch.core.dtypes import BF16_POLICY
    from axcnn_torch.models.resnet import ResNet
    from axcnn_torch.train.schedules import make_lr_schedule
    from axcnn_torch.train.train_step import create_train_state, make_train_step
    from axcnn_torch.utils.config import load_preset

    kw = dict(policy=BF16_POLICY, label_smoothing=0.1, mixup_alpha=0.2,
              grad_accum_steps=grad_accum_steps)
    if kd:
        preset = load_preset("assemble_resnet152_kd")
        teacher_cfg = preset_model("assemble_resnet50")
        kw.update(kd_temp=preset.train.kd_temp, kd_alpha=preset.train.kd_alpha,
                  grad_accum_steps=8)
        batch_size = 8 * BATCH
    if teacher_cfg is not None:
        teacher = ResNet(teacher_cfg, generator=torch.Generator().manual_seed(SEED + 1))
        kw["teacher"] = teacher.to(device, memory_format=torch.channels_last).eval() \
            .requires_grad_(False)
    kw.update(step_kw)
    state = create_train_state(cfg, generator=torch.Generator().manual_seed(SEED),
                               device=device, use_ema=True)
    step = make_train_step(cfg, lr_schedule=make_lr_schedule(**schedule),
                           total_steps=schedule["total_steps"], group=group, spatial=spatial,
                           **kw)
    if batches is None:
        gen = torch.Generator(device=device).manual_seed(SEED)
        shape = (batch_size, image_size, image_size, 3)
        batches = itertools.repeat({
            "images": torch.randint(0, 256, shape, generator=gen, device=device,
                                    dtype=torch.uint8),
            "labels": torch.randint(0, cfg.num_classes, (batch_size,), generator=gen,
                                    device=device)})
    box = [state]

    def enqueue():
        box[0], metrics = step(box[0], next(batches), SEED + 1)
        return metrics

    return enqueue, _wait_loss


def chained_s(enqueue, wait, steps: int):
    """``(seconds, the last step's result)`` for ``steps`` steps enqueued
    back to back and one wait for the last: the reference scripts' chained
    timing, ending in one fetch."""
    t0 = time.perf_counter()
    for _ in range(steps):
        pending = enqueue()
    wait(pending)
    return time.perf_counter() - t0, pending


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.splitlines()[0]


def measurement_device(cpu: bool, prog: str):
    """``(device, card)`` for a measurement module: the CPU when asked
    (``card`` is then ``"cpu"``), else the card; ``None`` with a message
    when there is no card (the module exits 1, never falling back)."""
    if cpu:
        return torch.device("cpu"), "cpu"
    if not torch.cuda.is_available():
        print(f"{prog}: no CUDA device (--cpu runs on the host)", file=sys.stderr)
        return None
    return torch.device("cuda", torch.cuda.current_device()), card_line()


def _dropblock_runner():
    from axcnn_torch.ops.dropblock import dropblock

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    sites = []
    for h, w, c, count in DROPBLOCK_SITES:
        for _ in range(count):
            x = torch.randn(BATCH, h, w, c, generator=gen, device="cuda").to(torch.bfloat16)
            g = torch.randn(BATCH, h, w, c, generator=gen, device="cuda").to(torch.bfloat16)
            sites.append((x.permute(0, 3, 1, 2).requires_grad_(), g.permute(0, 3, 1, 2)))

    def enqueue():
        for x, g in sites:
            seeds = rng.integers(-2 ** 31, 2 ** 31, BATCH, dtype=np.int32)
            y = dropblock(x, seeds, keep_prob=0.9, block_size=7, train=True)
            torch.autograd.grad(y, x, g)

    return enqueue, lambda _: torch.cuda.synchronize()


def _dp_rank(rank: int, world: int, coordinator: str, untraced: int, steps: int,
             image_size: int, spatial: bool, remat: str, grad_accum_steps: int,
             results) -> None:
    """One rank of ``--what=dp`` (or ``spatial``: the H of every image split
    over the ranks) on card ``rank``; rank 0 hands back its measurement."""
    from axcnn_torch.parallel import mesh
    from axcnn_torch.parallel.spatial import make_spatial_context

    mesh.init_distributed(torch.device("cuda", rank), rank=rank, world_size=world,
                          coordinator=coordinator)
    try:
        ctx = make_spatial_context(world) if spatial else None
        torch.cuda.reset_peak_memory_stats(rank)
        result = _measure(*_step_runner(preset_model("assemble_resnet50", remat=remat),
                                        group=mesh.data_group(), spatial=ctx,
                                        image_size=image_size,
                                        grad_accum_steps=grad_accum_steps), untraced, steps)
        result["peak_gib"] = torch.cuda.max_memory_allocated(rank) / 2 ** 30
    finally:
        mesh.shutdown()
    if rank == 0:
        results.put(result)


def _measure_dp(ranks: int, untraced: int, steps: int, image_size: int,
                spatial: bool = False, remat: str = "none", grad_accum_steps: int = 1) -> dict:
    import torch.multiprocessing as mp

    from axcnn_torch.cli.main_classification import _free_port

    if torch.cuda.device_count() < ranks:
        raise SystemExit(f"profile_step: --what=dp|spatial needs {ranks} cards, "
                         f"{torch.cuda.device_count()} visible")
    results = mp.get_context("spawn").SimpleQueue()
    mp.start_processes(_dp_rank, nprocs=ranks, start_method="spawn",
                       args=(ranks, f"127.0.0.1:{_free_port()}", untraced, steps, image_size,
                             spatial, remat, grad_accum_steps, results))
    return {"ranks": ranks, "image_size": image_size, "remat": remat,
            "grad_accum_steps": grad_accum_steps, **results.get()}


def crc_rates() -> dict:
    """``--what=crc``: MB/s of the CRC32C lanes by input size and of the
    byte loop, on the host CPU (module docstring)."""
    from axcnn_torch.data.tfrecord import crc32c, crc32c_bytewise

    data = np.random.default_rng(SEED).integers(0, 256, 16 << 20, dtype=np.uint8).tobytes()
    t0 = time.perf_counter()
    want = crc32c_bytewise(data[:1 << 20])
    bytewise = (1 << 20) / 1e6 / (time.perf_counter() - t0)
    assert crc32c(data[:1 << 20]) == want
    lanes = {}
    for n in (4 << 10, 64 << 10, 1 << 20, 16 << 20):
        reps = max(1, (8 << 20) // n)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(reps):
                crc32c(data[:n])
            best = min(best, time.perf_counter() - t0)
        lanes[n] = n * reps / 1e6 / best
    return {"bytewise_mb_per_s": bytewise, "lanes_mb_per_s": lanes,
            "speedup": {n: r / bytewise for n, r in lanes.items()}}


KD_RANKS_VARIANTS = (("8 ranks bf16", 8, "bf16"), ("8 ranks fp32", 8, "fp32"),
                     ("2 ranks bf16", 2, "bf16"), ("1 rank bf16", 1, "bf16"))


def kd_ranks_times() -> list:
    """``--what=kd_ranks``: config 5's command on CPU ranks, timed from its
    log's records (module docstring): one row a variant."""
    import dataclasses
    import os
    import tempfile

    from axcnn_torch.ckpt.checkpoint import CheckpointManager
    from axcnn_torch.drives import common
    from axcnn_torch.train.loop import _dataset_info
    from axcnn_torch.train.train_step import create_train_state
    from axcnn_torch.utils.config import load_preset

    teacher = dataclasses.replace(  # the head run() gives the student: the dataset's
        load_preset("assemble_resnet50").model,
        num_classes=_dataset_info(load_preset("assemble_resnet152_kd")).num_classes)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        teacher_dir = os.path.join(tmp, "teacher")
        mgr = CheckpointManager(teacher_dir, model_config=dataclasses.asdict(teacher))
        mgr.save(create_train_state(teacher, generator=torch.Generator().manual_seed(SEED),
                                    device="cpu", use_ema=True), force=True)
        mgr.close()
        for name, ranks, dtype in KD_RANKS_VARIANTS:
            model_dir = os.path.join(tmp, f"run_{len(rows)}")
            argv = ["--config=assemble_resnet152_kd", "--data.use_synthetic_data",
                    f"--train.kd_teacher_checkpoint={teacher_dir}",
                    f"--runtime.model_dir={model_dir}", f"--runtime.num_devices={ranks}",
                    "--runtime.platform=cpu", "--data.image_size=64",
                    f"--train.batch_size={16 if ranks > 1 else 2}", "--train.train_steps=3",
                    "--train.lr_warmup_epochs=0.4", "--data.echo_factor=1",
                    f"--train.dtype={dtype}", "--train.log_every=1"]
            env = {**os.environ, **({"OMP_NUM_THREADS": "1"} if ranks == 1 else {})}
            t0 = time.time()
            r = subprocess.run(common.cli_command(argv), env=env, capture_output=True, text=True)
            t_exit = time.time()
            if r.returncode:
                raise RuntimeError(f"kd_ranks {name}: exit {r.returncode}\n{r.stderr[-3000:]}")
            train = common.records(model_dir, "train")
            t_eval = common.last_eval(model_dir)["time"]
            rows.append({"variant": name, "ranks": ranks, "dtype": dtype,
                         "startup_and_step1_s": train[0]["time"] - t0,
                         "steps_2_3_s": train[-1]["time"] - train[0]["time"],
                         "eval_s": t_eval - train[-1]["time"], "exit_s": t_exit - t_eval,
                         "total_s": t_exit - t0, "losses": [x["loss"] for x in train]})
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--what", choices=("step", "dropblock", "kd", "remat", "dp", "spatial",
                                           "bl", "flops", "crc", "kd_ranks"), default="step")
    parser.add_argument("--ranks", type=int, default=2, help="cards for --what=dp|spatial")
    parser.add_argument("--image_size", type=int, default=224,
                        help="the images' side for --what=step|remat|dp|spatial")
    parser.add_argument("--remat", choices=("none", "blocks"), default="none",
                        help="model.remat for --what=dp|spatial")
    parser.add_argument("--grad_accum_steps", type=int, default=1,
                        help="micro-batches of the batch for --what=dp|spatial")
    parser.add_argument("--steps", type=int, default=3, help="steps in the traced window")
    parser.add_argument("--untraced", type=int, default=20, help="steps timed untraced")
    parser.add_argument("--label", default="", help="a name for the tree measured")
    args = parser.parse_args(argv)
    if args.what == "flops":
        print(json.dumps({"profile": "flops", "label": args.label, "image_size": 224,
                          "forward_gflops_per_image": {k: forward_gflops(c) for k, c in
                                                       _bl_models().items()}}), flush=True)
        return 0
    if args.what == "crc":
        print(json.dumps({"profile": "crc", "label": args.label, "host": "cpu", **crc_rates()}),
              flush=True)
        return 0
    if args.what == "kd_ranks":
        print(json.dumps({"profile": "kd_ranks", "label": args.label, "host": "cpu",
                          "rows": kd_ranks_times()}), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    if args.what in ("dp", "spatial"):
        result = _measure_dp(args.ranks, args.untraced, args.steps, args.image_size,
                             spatial=args.what == "spatial", remat=args.remat,
                             grad_accum_steps=args.grad_accum_steps)
    elif args.what == "bl":
        result = {}
        for name, cfg in _bl_models().items():
            result[name] = {"forward_gflops_per_image": forward_gflops(cfg),
                            **_measure(*_step_runner(cfg), args.untraced, args.steps)}
            torch.cuda.empty_cache()
    else:
        if args.what == "dropblock":
            runner = _dropblock_runner()
        elif args.what == "kd":
            runner = _step_runner(preset_model("assemble_resnet152_kd"), kd=True)
        else:
            runner = _step_runner(preset_model(
                "assemble_resnet50", remat="blocks" if args.what == "remat" else "none"),
                image_size=args.image_size)
        result = _measure(*runner, args.untraced, args.steps)
    print(json.dumps({"profile": args.what, "label": args.label, "dtype": "bf16",
                      "card": card, **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
