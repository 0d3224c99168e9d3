"""The training run loop (port of ``axcnn/train/loop.py``).

The reference's step accounting, LR schedule (linear batch scaling, warmup
in epochs), log cadence and eval cadence: the EMA-swapped eval runs every
``epochs_between_evals`` epochs and at the last step, and ``stop_threshold``
stops early. The host side is the port's own copy of the reference's:
the loaders of ``axcnn_torch.data.pipeline``, ``axcnn_torch.utils.logging``'s
``MetricLogger`` (``<model_dir>/metrics.jsonl``) and ``Throughput``, and
``axcnn_torch.utils.watchdog``. A producer thread keeps ``data.prefetch``
batches in flight to the device (``device_prefetch``: pinned memory, a side
stream), for training and for eval. With ``data.echo_factor`` > 1 each
batch feeds that many consecutive steps (``EchoIterator``, above the
prefetch, so an echoed batch is already on the card); the step's own
streams still fold the step index, so echoed steps draw afresh.

As in the reference: checkpoints under ``<model_dir>/checkpoints`` every
``save_checkpoint_steps``, at each eval and at the end, and the run resumes
from the latest one with the position of the batch the loop consumed (the
prefetch runs ahead of it). Saves are asynchronous
(``axcnn_torch.ckpt.checkpoint``: the loop waits for a snapshot, a thread
writes) and deferred to the end of an echo group, where the consumed
position resumes the step and batch stream exactly; the run's last step and
an early stop save at once. ``eval_only``; SIGTERM finishes the step in
flight, saves at the group's end, waits for the write and returns (one
process only); the hang watchdog;
``profile_steps``; warm start from ``pretrained_checkpoint``; the KD teacher
from ``kd_teacher_checkpoint``; gradient accumulation; device AutoAugment
(``data.autoaugment_device`` with real data and an ``autoaugment_type``: the
loader then decodes and crops only); the serving export to
``runtime.export_dir`` at the end of the run and after an ``eval_only``
eval, from rank 0; and the int8 serving policy, with ``eval_only`` only.

Data parallelism: inside a process group of several ranks
(``axcnn_torch.parallel.mesh``; the CLI starts one rank per card), each rank
builds the same state from the seed, checks that the ranks agree on it,
reads its own shard of the input (``host_id=rank``, ``batch_size // world``)
and runs the data-parallel step; the eval sums over the ranks, which first
agree on their number of eval batches. Rank 0 alone logs and saves; every
rank waits at a barrier while it takes the save's snapshot. The LR and the
schedules stay functions of the global batch.

Spatial partitioning (``runtime.spatial_partitions = S > 1``;
``axcnn_torch.parallel.spatial``): the ``D * S`` ranks form the ``(data,
spatial)`` grid, rank ``r`` at ``(r // S, r % S)``; ``S`` must divide the
ranks and, across hosts, each host's ranks, and the image size must pass
the shard rule (``check_shard_rows``), as the reference refuses what it
cannot place. The two ranks of a data row read the same batch and augment
it alike (the loaders take ``host_id = d`` of ``D``: their seeds depend on
the record, not the rank), and each takes its rows inside the step. The
step is the global-batch step, the eval sums over the data column, and the
replicas' check, logging and saves are as with data parallelism. It takes
every option the one-rank step takes: Big-Little stages, remat, gradient
accumulation, device AutoAugment, a KD teacher (run on each rank's rows;
its architecture meets the shard rule with the student's image size, which
depends on H and S alone) and the int8 evaluation.

Refused with ``NotImplementedError`` until ported: what ``UNPORTED`` lists,
each with its ROADMAP.md Queue A item (nothing now); and, by design
(``REFUSED``), DCN slices and spatial partitioning with ImageNet-C.
ImageNet-C (``runtime.eval_imagenet_c``) is ``axcnn_torch.eval.imagenet_c``,
which the CLI runs instead of this loop.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import signal
import threading

import numpy as np
import torch

from axcnn_torch.ckpt.checkpoint import CheckpointManager, load_weights, model_from_payload
from axcnn_torch.ckpt.export import export_serving
from axcnn_torch.core.dtypes import policy_from_name, set_fp32_precision
from axcnn_torch.data.autoaugment_device import make_device_autoaugment
from axcnn_torch.data.datasets import DatasetInfo, get_dataset
from axcnn_torch.data.pipeline import (EchoIterator, MultiProducerLoader, SyntheticLoader,
                                       TFRecordImageLoader, device_prefetch)
from axcnn_torch.models.resnet import ModelConfig
from axcnn_torch.parallel import mesh
from axcnn_torch.parallel.spatial import check_shard_rows, make_spatial_context
from axcnn_torch.train.ema import ema_init
from axcnn_torch.train.schedules import make_lr_schedule, scale_lr_for_batch
from axcnn_torch.train.train_step import (
    TrainState, create_train_state, load_ema, make_eval_step, make_train_step, pad_batch)
from axcnn_torch.utils.config import Config, resolve_preprocessing
from axcnn_torch.utils.logging import MetricLogger, Throughput
from axcnn_torch.utils.watchdog import HangWatchdog, exit_after

def _spatial(c: Config) -> bool:
    return c.runtime.spatial_partitions > 1


# (what, its ROADMAP.md Queue A item, is it asked for) -- each refused until ported
UNPORTED = ()
# (what, why it is not ported, is it asked for) -- refused by design
REFUSED = (
    ("runtime.dcn_slices > 1",
     "the hierarchical (dcn, data) mesh follows TPU slices joined by a data-centre "
     "network; NCCL picks its own topology across a host's cards, and the H100 "
     "machines have no DCN (ROADMAP.md Queue A item 11)",
     lambda c: c.runtime.dcn_slices > 1),
    ("runtime.spatial_partitions > 1 with runtime.eval_imagenet_c",
     "the ImageNet-C sets store 224^2 pixels, which never motivate spatial "
     "partitioning; the reference refuses the same (axcnn/eval/imagenet_c.py) "
     "(ROADMAP.md Queue A item 11h)",
     lambda c: _spatial(c) and c.runtime.eval_imagenet_c),
)


def check_ported(cfg: Config) -> None:
    asked = [f"{what} (item {item})" for what, item, on in UNPORTED if on(cfg)]
    if asked:
        raise NotImplementedError(
            f"not ported to axcnn_torch yet: {', '.join(asked)} (ROADMAP.md "
            "Queue A)")
    for what, why, on in REFUSED:
        if on(cfg):
            raise NotImplementedError(f"axcnn_torch does not take {what}: {why}")


def resolve_device(platform: str, local_rank: int = 0) -> torch.device:
    """``""`` or ``gpu`` -> CUDA card ``local_rank``, and exit with a message
    when there is none; ``cpu`` -> the host. Nothing falls back to the CPU."""
    if platform in ("", "gpu", "cuda"):
        if not torch.cuda.is_available():
            raise SystemExit("error: no CUDA device; pass --runtime.platform=cpu "
                             "to run on the host CPU")
        return torch.device("cuda", local_rank)
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


def _make_loaders(cfg: Config, info: DatasetInfo, rank: int = 0, world: int = 1):
    """This rank's loaders: its share of the global batch from its shard
    files (``host_id=rank`` of ``world``; under spatial partitioning the data
    index and the number of data shards). The synthetic loader is the same
    on every rank, as in the reference."""
    bs = cfg.train.batch_size // world
    if cfg.data.use_synthetic_data:
        kw = dict(batch_size=bs, image_size=cfg.data.image_size,
                  num_classes=cfg.model.num_classes)
        return (SyntheticLoader(seed=cfg.train.seed, **kw),
                SyntheticLoader(seed=cfg.train.seed + 1, num_batches=4, **kw))
    common = dict(image_size=cfg.data.image_size, resize_min=cfg.data.resize_min,
                  dct_method=cfg.data.dct_method, num_workers=cfg.data.num_workers,
                  use_native=cfg.data.loader == "cpp", host_id=rank, num_hosts=world)
    # device AutoAugment: the host loader only decodes and crops
    host_aa = "none" if cfg.data.autoaugment_device else cfg.data.autoaugment_type
    train_kw = dict(batch_size=bs, train=True, seed=cfg.train.seed, autoaugment_type=host_aa,
                    shuffle_buffer=cfg.data.shuffle_buffer, **common)
    if cfg.data.num_producers > 1:
        train_loader = MultiProducerLoader(
            cfg.data.data_dir, info, num_producers=cfg.data.num_producers,
            **train_kw)  # seed, host_id and num_hosts pass through
    else:
        train_loader = TFRecordImageLoader(cfg.data.data_dir, info, **train_kw)
    eval_loader = TFRecordImageLoader(cfg.data.data_dir, info, batch_size=bs,
                                      train=False, drop_remainder=False, **common)
    return train_loader, eval_loader


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


def _eval_batches(eval_loader, batch_size: int, local: int | None, extra: int):
    """The eval loader's batches as CPU tensors, each padded to
    ``batch_size`` (labels -1), then ``extra`` all-padding batches: the
    ranks' shortfall from the largest number of batches among them
    (``local`` is this rank's), so that every rank calls the eval step's
    all-reduce equally often, even over uneven shards."""
    n, last = 0, None
    for b in eval_loader:
        last = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
        n += 1
        yield pad_batch(last, batch_size)
    if local is not None and n != local:
        # a mismatch would desynchronize the per-batch all-reduce: fail here
        raise RuntimeError(f"eval loader yielded {n} batches but num_batches() "
                           f"promised {local}")
    if extra:
        shape = (tuple(last["images"].shape[1:]) if last is not None
                 else (eval_loader.image_size, eval_loader.image_size, 3))
        empty = {"images": torch.zeros((batch_size,) + shape, dtype=torch.uint8),
                 "labels": torch.full((batch_size,), -1, dtype=torch.int32)}
        for _ in range(extra):
            yield empty


def evaluate(eval_step, state, eval_loader, *, batch_size: int, device, prefetch: int = 2,
             group=None, on_batch=None):
    """Full eval pass: {'top1': %, 'top5': %, 'loss': mean, 'count': N},
    over every rank's shard with a process ``group``. ``on_batch`` runs
    after each batch's metrics reach the host (the hang watchdog's beat: a
    whole eval may outlast its deadline)."""
    totals = {}
    local, extra = None, 0
    if group is not None and hasattr(eval_loader, "num_batches"):
        local = eval_loader.num_batches()
        extra = mesh.all_reduce_max(local, device, group) - local
    batches = device_prefetch(_eval_batches(eval_loader, batch_size, local, extra),
                              device=device, size=prefetch)
    try:
        for batch in batches:
            m = {k: float(v) for k, v in eval_step(state, batch).items()}
            if on_batch is not None:
                on_batch()
            for k, v in m.items():
                totals[k] = totals.get(k, 0.0) + v
    finally:
        batches.close()
    count = max(totals.get("count", 0.0), 1.0)
    return {"top1": totals.get("top1", 0.0) / count * 100.0,
            "top5": totals.get("top5", 0.0) / count * 100.0,
            "loss": totals.get("loss_sum", 0.0) / count,
            "count": count}


def run(cfg: Config, *, local_rank: int = 0):
    """Train (and periodically evaluate) per the config; returns the last
    eval's metrics (the eval's, with ``eval_only``). In a process group of
    several ranks (``mesh.init_distributed``), this is one rank of a
    data-parallel run on card ``local_rank``."""
    check_ported(cfg)
    device = resolve_device(cfg.runtime.platform, local_rank)
    group, rank, world = mesh.data_group(), mesh.rank(), mesh.world_size()
    if cfg.runtime.num_devices not in (0, world):
        raise ValueError(
            f"runtime.num_devices={cfg.runtime.num_devices} but this process group has "
            f"{world} rank(s): start the run through axcnn_torch.cli.main_classification, "
            "which starts one rank per card")
    spatial = None
    data_rank, data_world = rank, world
    if _spatial(cfg):
        check_shard_rows(cfg.data.image_size, cfg.runtime.spatial_partitions)
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        spatial = make_spatial_context(cfg.runtime.spatial_partitions, local_world=local)
        data_rank, data_world = spatial.data_index, spatial.data_parts
    if cfg.train.batch_size % data_world:
        raise ValueError(f"global batch {cfg.train.batch_size} not divisible by "
                         f"{data_world} data-parallel ranks")
    info = _dataset_info(cfg)
    model = cfg.model
    if model.num_classes != info.num_classes:
        # dataset wins (the reference derives num_classes from data_config)
        model = dataclasses.replace(model, num_classes=info.num_classes)
    cfg = Config(model=model, data=resolve_preprocessing(cfg.data),
                 train=cfg.train, runtime=cfg.runtime)
    policy = policy_from_name(cfg.train.dtype)
    if policy.quantize_conv and not cfg.runtime.eval_only:
        raise ValueError(
            "dtype=int8 is a serving-only post-training-quantization policy "
            "(the quantized conv is not differentiable); train in bf16/fp32 "
            "and pass --train.dtype=int8 with --runtime.eval_only or the "
            "predict CLI")
    set_fp32_precision(policy)
    lead = rank == 0  # rank 0 alone logs, saves, profiles and exports
    logger = MetricLogger(cfg.runtime.model_dir if lead else None, quiet=not lead,
                          tensorboard=cfg.runtime.tensorboard and lead)

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
    autoaugment_fn = None
    if cfg.data.autoaugment_device and not cfg.data.use_synthetic_data:
        autoaugment_fn = make_device_autoaugment(cfg.data.autoaugment_type,
                                                 num_groups=cfg.data.aa_num_groups)
    train_step = make_train_step(
        cfg.model, lr_schedule=lr_schedule, total_steps=total_steps, policy=policy,
        label_smoothing=cfg.train.label_smoothing, mixup_alpha=cfg.data.mixup_alpha,
        mixup_symmetric=cfg.data.mixup_symmetric, mixup_per_shard=cfg.data.mixup_per_shard,
        weight_decay=cfg.train.weight_decay, momentum=cfg.train.momentum,
        use_ema=cfg.train.use_ema, ema_decay=cfg.train.ema_decay,
        teacher=_load_teacher(cfg, device), kd_temp=cfg.train.kd_temp,
        kd_alpha=cfg.train.kd_alpha, grad_accum_steps=cfg.train.grad_accum_steps,
        group=group, autoaugment_fn=autoaugment_fn, spatial=spatial, **norm)
    eval_step = make_eval_step(cfg.model, policy=policy, use_ema=cfg.train.use_ema,
                               group=group, spatial=spatial, **norm)
    state = create_train_state(cfg.model,
                               generator=torch.Generator().manual_seed(cfg.train.seed),
                               device=device, use_ema=cfg.train.use_ema)
    state = _warm_start(state, cfg)
    train_loader, eval_loader = _make_loaders(cfg, info, data_rank, data_world)

    ckpt = CheckpointManager(os.path.join(cfg.runtime.model_dir, "checkpoints"),
                             max_to_keep=cfg.runtime.keep_checkpoint_max,
                             model_config=dataclasses.asdict(cfg.model) if lead else None)
    restored = ckpt.restore(state)
    if restored is not None:
        state, loader_state, _ = restored
        train_loader.state = loader_state
        logger.log("restore", state.step, epoch=loader_state.epoch)
    mesh.check_replicas_agree([*state.model.parameters(), *state.model.buffers()],
                              "the train state", group)

    def make_watchdog(step_of):
        """The hang watchdog: on its deadline, log ``hang_detected`` from a
        bounded side thread, then exit 42 (``axcnn_torch.utils.watchdog``)."""
        if cfg.runtime.hang_watchdog_s <= 0:
            return None

        def on_hang(stalled_s):
            exit_after(lambda: logger.log(
                "hang_detected", step_of(), jsonl_only=True,
                stalled_s=round(stalled_s, 1), timeout_s=cfg.runtime.hang_watchdog_s))

        return HangWatchdog(cfg.runtime.hang_watchdog_s, on_hang=on_hang).start()

    eval_kw = dict(batch_size=cfg.train.batch_size // data_world, device=device,
                   prefetch=cfg.data.prefetch, group=group)
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
        if lead:
            _maybe_export(cfg, state, policy, info, logger)
        logger.close()
        return metrics

    root_seed = cfg.train.seed + 1
    throughput = Throughput(cfg.train.batch_size)
    eval_metrics = {}
    step = state.step
    # the prefetch runs up to data.prefetch + 1 batches ahead of the loop, so
    # a save records its consumed_state, not train_loader.state
    prefetch = device_prefetch(iter(train_loader), device=device, size=cfg.data.prefetch,
                               state_fn=lambda: train_loader.state)
    train_iter = prefetch
    if cfg.data.echo_factor > 1:
        train_iter = EchoIterator(prefetch, cfg.data.echo_factor)
    # SIGTERM (the grace signal before a kill): finish the step in flight,
    # save the consumed position, return. One process only: with several
    # ranks only the signalled one would stop, and the others would wait at
    # its next collective
    preempted = threading.Event()
    prev_sigterm = None
    if world == 1 and threading.current_thread() is threading.main_thread():
        prev_sigterm = signal.signal(signal.SIGTERM, lambda *_: preempted.set())
    profile_dir = os.path.join(cfg.runtime.model_dir, "profile")
    profiler = None
    profiled = not lead
    pending_save = pending_force = pending_preempt = False
    watchdog = make_watchdog(lambda: step)

    def beat():
        if watchdog is not None:
            watchdog.beat()

    try:
        while step < total_steps:
            # trace steps 1..profile_steps: step 0 pays the one-time costs
            if cfg.runtime.profile_steps and not profiled and profiler is None and step > 0:
                profiler = _start_profiler(device)
            batch = next(train_iter)
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
            pending_preempt = pending_preempt or preempted.is_set()
            # a save waits for the end of the echo group: consumed_state
            # counts fresh batches, so only there does it resume exactly; the
            # run's last step and an early stop save at once
            aligned = getattr(train_iter, "at_boundary", True)
            if ((pending_save or pending_force or pending_preempt)
                    and (aligned or step == total_steps or stopping)):
                if lead:
                    ckpt.save(state, loader_state=train_iter.consumed_state,
                              rng_seed=cfg.train.seed, force=pending_force or pending_preempt)
                # the ranks leave together once rank 0 has its snapshot; its
                # writer runs on, and is joined by the next save or the end
                mesh.barrier(device, group)
                beat()
                pending_save = pending_force = False
                if pending_preempt:
                    # the write may outlast the watchdog's deadline: disarm it
                    # before waiting, so the preemption still exits 0
                    if watchdog is not None:
                        watchdog.stop()
                    ckpt.wait()
                    logger.log("preempt_save", step)
                    break
            if stopping:
                logger.log("early_stop", step, top1=eval_metrics["top1"])
                break
    finally:
        prefetch.close()
        if profiler is not None:
            profiler.stop()
        if watchdog is not None:
            watchdog.stop()
        # an escaping exception must not leave SIGTERM pointing at an Event
        # that no loop reads
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
    if lead:
        _maybe_export(cfg, state, policy, info, logger)
    ckpt.wait()
    ckpt.close()
    logger.close()
    return eval_metrics


def _maybe_export(cfg: Config, state: TrainState, policy, info: DatasetInfo, logger) -> None:
    """The serving export of the run's EMA weights (its parameters without
    EMA) to ``runtime.export_dir``, on the run's device; a copy of the model
    takes the weights, so the state is left as it is."""
    if not cfg.runtime.export_dir:
        return
    model = copy.deepcopy(state.model)
    if cfg.train.use_ema and state.ema is not None:
        load_ema(TrainState(model=model, ema=state.ema))
    export_serving(cfg.runtime.export_dir, cfg.model, model, image_size=cfg.data.image_size,
                   policy=policy, mean=info.mean_rgb, std=info.stddev_rgb)
    logger.log("export", state.step, path=cfg.runtime.export_dir)


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
