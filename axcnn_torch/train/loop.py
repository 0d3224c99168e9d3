"""The training run loop on one device (port of ``axcnn/train/loop.py``).

The reference's step accounting, LR schedule (linear batch scaling, warmup
in epochs), log cadence and eval cadence: the EMA-swapped eval runs every
``epochs_between_evals`` epochs and at the last step, and ``stop_threshold``
stops early. The host side is the reference's own jax-free code: the
loaders of ``axcnn.data.pipeline``, ``axcnn.utils.logging``'s
``MetricLogger`` (``<model_dir>/metrics.jsonl``) and ``Throughput``, and
``axcnn.utils.watchdog``. Each batch is copied to the device from pinned
memory, ``non_blocking``.

As in the reference: checkpoints under ``<model_dir>/checkpoints`` every
``save_checkpoint_steps``, at each eval and at the end, and the run resumes
from the latest one with the loader's position; ``eval_only``; SIGTERM
finishes the step in flight, saves and returns; the hang watchdog;
``profile_steps``; warm start from ``pretrained_checkpoint``; the KD teacher
from ``kd_teacher_checkpoint``; gradient accumulation.

Refused with ``NotImplementedError`` until ported (ROADMAP.md): more than
one device, spatial partitioning, DCN slices, device AutoAugment, data
echo, export and ImageNet-C.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading

import numpy as np
import torch

from axcnn.data.datasets import DatasetInfo, get_dataset
from axcnn.data.pipeline import MultiProducerLoader, SyntheticLoader, TFRecordImageLoader
from axcnn.utils.logging import MetricLogger, Throughput
from axcnn.utils.watchdog import HangWatchdog, exit_after
from axcnn_torch.ckpt.checkpoint import CheckpointManager, load_weights, model_from_payload
from axcnn_torch.core.dtypes import policy_from_name, set_fp32_precision
from axcnn_torch.models.resnet import ModelConfig
from axcnn_torch.train.ema import ema_init
from axcnn_torch.train.schedules import make_lr_schedule, scale_lr_for_batch
from axcnn_torch.train.train_step import (
    TrainState, create_train_state, make_eval_step, make_train_step, pad_batch)
from axcnn_torch.utils.config import Config, resolve_preprocessing

# (what, its ROADMAP.md Queue A item, is it asked for) -- each refused until ported
UNPORTED = (
    ("runtime.num_devices > 1", 8, lambda c: c.runtime.num_devices > 1),
    ("runtime.spatial_partitions > 1", 11, lambda c: c.runtime.spatial_partitions > 1),
    ("runtime.dcn_slices > 1", 8, lambda c: c.runtime.dcn_slices > 1),
    ("data.autoaugment_device", 10, lambda c: c.data.autoaugment_device),
    ("data.echo_factor > 1", 10, lambda c: c.data.echo_factor > 1),
    ("runtime.export_dir", 10, lambda c: bool(c.runtime.export_dir)),
    ("runtime.eval_imagenet_c", 10, lambda c: c.runtime.eval_imagenet_c),
)


def check_ported(cfg: Config) -> None:
    asked = [f"{what} (item {item})" for what, item, on in UNPORTED if on(cfg)]
    if asked:
        raise NotImplementedError(
            f"not ported to axcnn_torch yet: {', '.join(asked)} (ROADMAP.md "
            "Queue A)")


def resolve_device(platform: str) -> torch.device:
    """``""`` or ``gpu`` -> the CUDA device, and exit with a message when
    there is none; ``cpu`` -> the host. Nothing falls back to the CPU."""
    if platform in ("", "gpu", "cuda"):
        if not torch.cuda.is_available():
            raise SystemExit("error: no CUDA device; pass --runtime.platform=cpu "
                             "to run on the host CPU")
        return torch.device("cuda")
    if platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"runtime.platform must be '', 'gpu' or 'cpu', got {platform!r}")


def _dataset_info(cfg: Config) -> DatasetInfo:
    if cfg.data.dataset_name == "custom":
        d = cfg.data
        if min(d.num_classes, d.num_train_examples, d.num_eval_examples) <= 0:
            raise ValueError(
                "dataset_name='custom' needs --data.num_classes, "
                "--data.num_train_examples and --data.num_eval_examples "
                f"(got {d.num_classes}/{d.num_train_examples}/"
                f"{d.num_eval_examples})")
        return DatasetInfo("custom", d.num_classes, d.num_train_examples,
                           d.num_eval_examples, label_offset=d.label_offset)
    return get_dataset(cfg.data.dataset_name)


def _make_loaders(cfg: Config, info: DatasetInfo):
    bs = cfg.train.batch_size
    if cfg.data.use_synthetic_data:
        kw = dict(batch_size=bs, image_size=cfg.data.image_size,
                  num_classes=cfg.model.num_classes)
        return (SyntheticLoader(seed=cfg.train.seed, **kw),
                SyntheticLoader(seed=cfg.train.seed + 1, num_batches=4, **kw))
    common = dict(image_size=cfg.data.image_size, resize_min=cfg.data.resize_min,
                  dct_method=cfg.data.dct_method, num_workers=cfg.data.num_workers,
                  use_native=cfg.data.loader == "cpp")
    train_kw = dict(batch_size=bs, train=True, seed=cfg.train.seed,
                    autoaugment_type=cfg.data.autoaugment_type,
                    shuffle_buffer=cfg.data.shuffle_buffer, **common)
    if cfg.data.num_producers > 1:
        train_loader = MultiProducerLoader(
            cfg.data.data_dir, info, num_producers=cfg.data.num_producers,
            **train_kw)
    else:
        train_loader = TFRecordImageLoader(cfg.data.data_dir, info, **train_kw)
    eval_loader = TFRecordImageLoader(cfg.data.data_dir, info, batch_size=bs,
                                      train=False, drop_remainder=False, **common)
    return train_loader, eval_loader


def to_device(batch, device: torch.device, batch_size: int | None = None):
    """Host numpy batch -> torch tensors on ``device`` (padded to
    ``batch_size`` first when given), copied from pinned memory."""
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    if batch_size is not None:
        out = pad_batch(out, batch_size)
    if device.type == "cuda":
        out = {k: v.pin_memory().to(device, non_blocking=True) for k, v in out.items()}
    return out


def _teacher_model_config(cfg: Config, meta: dict | None) -> ModelConfig:
    """The KD teacher's architecture: the checkpoint's ``model_config.json``
    sidecar when there is one, else the student's; the explicit
    ``train.kd_teacher_*`` flags override either. A head that differs from
    the student's raises ``ValueError``."""
    if meta is not None:
        fields = {f.name for f in dataclasses.fields(ModelConfig)}
        base = ModelConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                              for k, v in meta.items() if k in fields})
        if base.num_classes != cfg.model.num_classes:
            raise ValueError(
                f"KD teacher checkpoint has a {base.num_classes}-way head but "
                f"the student is {cfg.model.num_classes}-way: teacher and "
                "student logits must align for the KL loss")
    else:
        base = cfg.model

    def tri(raw: str, field: str):
        if raw == "":
            return {}
        low = raw.lower()
        if low not in ("true", "false", "1", "0", "yes", "no", "on", "off"):
            raise ValueError(
                f"train.kd_teacher_{field} must be ''/true/false, got {raw!r}")
        return {field: low in ("true", "1", "yes", "on")}

    t = cfg.train
    over = {}
    if t.kd_teacher_resnet_size:
        over["resnet_size"] = t.kd_teacher_resnet_size
    over.update(tri(t.kd_teacher_use_resnet_d, "use_resnet_d"))
    over.update(tri(t.kd_teacher_use_se_block, "use_se_block"))
    over.update(tri(t.kd_teacher_use_sk_block, "use_sk_block"))
    if t.kd_teacher_anti_alias_type != "inherit":
        over["anti_alias_type"] = t.kd_teacher_anti_alias_type
    return dataclasses.replace(base, **over)


def _load_teacher(cfg: Config, device):
    """The frozen KD teacher (a ``ResNet`` in eval mode, channels_last on
    ``device``, no gradients) from ``train.kd_teacher_checkpoint``, with its
    EMA weights when the checkpoint has them; None without the flag."""
    if not cfg.train.kd_teacher_checkpoint:
        return None
    mgr = CheckpointManager(cfg.train.kd_teacher_checkpoint)
    t_cfg = _teacher_model_config(cfg, mgr.model_config())
    raw = mgr.load(device=device)
    if raw is None:
        raise FileNotFoundError(
            f"no teacher checkpoint in {cfg.train.kd_teacher_checkpoint}")
    teacher = model_from_payload(raw, t_cfg, device=device, use_ema=True,
                                 where=f"KD teacher checkpoint {mgr.path(raw['step'])}")
    return teacher.requires_grad_(False)


def _warm_start(state: TrainState, cfg: Config) -> TrainState:
    """Fine-tune init from ``train.pretrained_checkpoint``: its EMA (else its
    parameters), except the head when ``warm_start_exclude_head``, and its BN
    statistics. The EMA restarts from the loaded parameters; the velocity
    stays zero."""
    if not cfg.train.pretrained_checkpoint:
        return state
    mgr = CheckpointManager(cfg.train.pretrained_checkpoint)
    model = state.model
    raw = mgr.load(device=next(model.parameters()).device)
    if raw is None:
        raise FileNotFoundError(f"no checkpoint in {cfg.train.pretrained_checkpoint}")
    load_weights(model, raw.get("ema") or raw["params"], raw["model_state"],
                 f"pretrained checkpoint {mgr.path(raw['step'])}",
                 skip=("head.",) if cfg.train.warm_start_exclude_head else ())
    if state.ema is not None:
        state.ema = ema_init(dict(model.named_parameters()))
    return state


def evaluate(eval_step, state, eval_loader, *, batch_size: int, device,
             on_batch=None):
    """Full eval pass: {'top1': %, 'top5': %, 'loss': mean, 'count': N}.
    ``on_batch`` runs after each batch's metrics reach the host (the hang
    watchdog's beat: a whole eval may outlast its deadline)."""
    totals = {}
    for batch in eval_loader:
        m = eval_step(state, to_device(batch, device, batch_size))
        m = {k: float(v) for k, v in m.items()}
        if on_batch is not None:
            on_batch()
        for k, v in m.items():
            totals[k] = totals.get(k, 0.0) + float(v)
    count = max(totals.get("count", 0.0), 1.0)
    return {"top1": totals.get("top1", 0.0) / count * 100.0,
            "top5": totals.get("top5", 0.0) / count * 100.0,
            "loss": totals.get("loss_sum", 0.0) / count,
            "count": count}


def run(cfg: Config):
    """Train (and periodically evaluate) per the config on one device;
    returns the last eval's metrics (the eval's, with ``eval_only``)."""
    check_ported(cfg)
    device = resolve_device(cfg.runtime.platform)
    info = _dataset_info(cfg)
    model = cfg.model
    if model.num_classes != info.num_classes:
        # dataset wins (the reference derives num_classes from data_config)
        model = dataclasses.replace(model, num_classes=info.num_classes)
    cfg = Config(model=model, data=resolve_preprocessing(cfg.data),
                 train=cfg.train, runtime=cfg.runtime)
    policy = policy_from_name(cfg.train.dtype)
    set_fp32_precision(policy)
    logger = MetricLogger(cfg.runtime.model_dir, tensorboard=cfg.runtime.tensorboard)

    if cfg.train.train_steps > 0:
        total_steps = cfg.train.train_steps
        steps_per_epoch = total_steps
    else:
        steps_per_epoch = max(info.num_train // cfg.train.batch_size, 1)
        total_steps = steps_per_epoch * cfg.train.train_epochs
    lr_schedule = make_lr_schedule(
        base_lr=scale_lr_for_batch(cfg.train.base_lr, cfg.train.batch_size),
        total_steps=total_steps,
        warmup_steps=int(cfg.train.lr_warmup_epochs * steps_per_epoch),
        decay_type=cfg.train.lr_decay_type)
    norm = dict(mean_rgb=info.mean_rgb, stddev_rgb=info.stddev_rgb)
    train_step = make_train_step(
        cfg.model, lr_schedule=lr_schedule, total_steps=total_steps, policy=policy,
        label_smoothing=cfg.train.label_smoothing, mixup_alpha=cfg.data.mixup_alpha,
        mixup_symmetric=cfg.data.mixup_symmetric,
        weight_decay=cfg.train.weight_decay, momentum=cfg.train.momentum,
        use_ema=cfg.train.use_ema, ema_decay=cfg.train.ema_decay,
        teacher=_load_teacher(cfg, device), kd_temp=cfg.train.kd_temp,
        kd_alpha=cfg.train.kd_alpha, grad_accum_steps=cfg.train.grad_accum_steps,
        **norm)
    eval_step = make_eval_step(cfg.model, policy=policy, use_ema=cfg.train.use_ema,
                               **norm)
    state = create_train_state(cfg.model,
                               generator=torch.Generator().manual_seed(cfg.train.seed),
                               device=device, use_ema=cfg.train.use_ema)
    state = _warm_start(state, cfg)
    train_loader, eval_loader = _make_loaders(cfg, info)

    ckpt = CheckpointManager(os.path.join(cfg.runtime.model_dir, "checkpoints"),
                             max_to_keep=cfg.runtime.keep_checkpoint_max,
                             model_config=dataclasses.asdict(cfg.model))
    restored = ckpt.restore(state)
    if restored is not None:
        state, loader_state, _ = restored
        train_loader.state = loader_state
        logger.log("restore", state.step, epoch=loader_state.epoch)

    def make_watchdog(step_of):
        """The hang watchdog: on its deadline, log ``hang_detected`` from a
        bounded side thread, then exit 42 (``axcnn.utils.watchdog``)."""
        if cfg.runtime.hang_watchdog_s <= 0:
            return None

        def on_hang(stalled_s):
            exit_after(lambda: logger.log(
                "hang_detected", step_of(), jsonl_only=True,
                stalled_s=round(stalled_s, 1), timeout_s=cfg.runtime.hang_watchdog_s))

        return HangWatchdog(cfg.runtime.hang_watchdog_s, on_hang=on_hang).start()

    eval_kw = dict(batch_size=cfg.train.batch_size, device=device)
    if cfg.runtime.eval_only:
        eval_step_no = state.step
        watchdog = make_watchdog(lambda: eval_step_no)
        try:
            metrics = evaluate(eval_step, state, eval_loader, **eval_kw,
                               on_batch=watchdog.beat if watchdog else None)
        finally:
            if watchdog is not None:
                watchdog.stop()
        logger.log("eval", eval_step_no, **metrics)
        logger.close()
        return metrics

    root_seed = cfg.train.seed + 1
    throughput = Throughput(cfg.train.batch_size)
    eval_metrics = {}
    step = state.step
    # no prefetch thread: the loader advances its state before each yield, so
    # after next() train_loader.state is the position the loop has consumed
    train_iter = iter(train_loader)
    # SIGTERM (the grace signal before a kill): finish the step in flight,
    # save the consumed position, return
    preempted = threading.Event()
    prev_sigterm = None
    if threading.current_thread() is threading.main_thread():
        prev_sigterm = signal.signal(signal.SIGTERM, lambda *_: preempted.set())
    profile_dir = os.path.join(cfg.runtime.model_dir, "profile")
    profiler = None
    profiled = False
    pending_save = pending_force = False
    watchdog = make_watchdog(lambda: step)

    def beat():
        if watchdog is not None:
            watchdog.beat()

    try:
        while step < total_steps:
            # trace steps 1..profile_steps: step 0 pays the one-time costs
            if cfg.runtime.profile_steps and not profiled and profiler is None and step > 0:
                profiler = _start_profiler(device)
            batch = to_device(next(train_iter), device)
            beat()  # the loader produced
            state, metrics = train_step(state, batch, root_seed)
            beat()  # the step was enqueued
            step += 1
            if profiler is not None and step >= cfg.runtime.profile_steps + 1:
                _stop_profiler(profiler, device, profile_dir, step)
                profiler, profiled = None, True
            ips = throughput.tick()
            if step % cfg.train.log_every == 0 or step == total_steps:
                m = {k: float(v) for k, v in metrics.items()}
                beat()  # the host fetched the step's results
                logger.log("train", step, epoch=step / steps_per_epoch,
                           images_per_sec=ips or 0.0, **m)
            if (cfg.runtime.save_checkpoint_steps
                    and step % cfg.runtime.save_checkpoint_steps == 0):
                pending_save = True
            stopping = False
            if (step % (steps_per_epoch * cfg.train.epochs_between_evals) == 0
                    or step == total_steps):
                eval_metrics = evaluate(eval_step, state, eval_loader, **eval_kw,
                                        on_batch=beat)
                logger.log("eval", step, **eval_metrics)
                beat()
                pending_force = True
                stopping = bool(cfg.train.stop_threshold
                                and eval_metrics["top1"] >= cfg.train.stop_threshold)
            preempt = preempted.is_set()
            if pending_save or pending_force or preempt:
                ckpt.save(state, loader_state=train_loader.state,
                          rng_seed=cfg.train.seed, force=pending_force or preempt)
                beat()  # a save is a long, legitimate pause
                pending_save = pending_force = False
                if preempt:
                    logger.log("preempt_save", step)
                    break
            if stopping:
                logger.log("early_stop", step, top1=eval_metrics["top1"])
                break
    finally:
        if profiler is not None:
            profiler.stop()
        if watchdog is not None:
            watchdog.stop()
        # an escaping exception must not leave SIGTERM pointing at an Event
        # that no loop reads
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
    ckpt.wait()
    ckpt.close()
    logger.close()
    return eval_metrics


def _start_profiler(device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, device, profile_dir: str, step: int) -> None:
    """Wait for the traced steps, stop, and write a Chrome trace under
    ``profile_dir``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(profile_dir, f"trace_to_step{step}.json"))
