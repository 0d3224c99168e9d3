"""Train/eval entry point (port of ``axcnn/cli/main_classification.py``).

Usage, with the reference's argv grammar and presets:

    python -m axcnn_torch.cli.main_classification --config=assemble_resnet50 \\
        --data.use_synthetic_data --train.train_steps=20 --train.batch_size=128

    # on the host CPU, at a small size:
    ... --runtime.platform=cpu --model.width_multiplier=0.125 \\
        --data.image_size=64 --train.batch_size=8

    # checkpoints every 1000 steps; rerunning the same command resumes from
    # the latest one, with the data stream's position:
    ... --runtime.model_dir=/tmp/run1 --runtime.save_checkpoint_steps=1000

    # evaluate what a run saved:
    ... --runtime.model_dir=/tmp/run1 --runtime.eval_only

    # fine-tune (warm start, a new head):
    ... --config=finetune_fgvc --train.pretrained_checkpoint=/tmp/run1/checkpoints

    # distil into Assemble-ResNet-152; batch 1024 as 8 micro-batches:
    ... --config=assemble_resnet152_kd --train.grad_accum_steps=8 \\
        --train.kd_teacher_checkpoint=/tmp/run1/checkpoints

    # AutoAugment on the card instead of in the loader (real data only):
    ... --data.data_dir=/data/imagenet --data.autoaugment_device=true

    # evaluate in int8 (int8 convs, bf16 elsewhere) and write a serving export:
    ... --runtime.model_dir=/tmp/run1 --runtime.eval_only --train.dtype=int8 \\
        --runtime.export_dir=/tmp/run1/export_int8

    # spatial partitioning: image H split over 2 cards (a 448x448 fine-tune),
    # D x 2 ranks for D data shards:
    ... --config=finetune_fgvc --data.image_size=448 --runtime.spatial_partitions=2 \\
        --runtime.num_devices=2
    # ... with every option of the one-card step, e.g. the memory levers:
    ... --model.remat=blocks --train.grad_accum_steps=2 --data.autoaugment_device

    # ImageNet-C mCE of what a run saved (axcnn_torch.data.build_imagenet_c
    # writes the corrupted sets):
    ... --runtime.model_dir=/tmp/run1 --runtime.eval_imagenet_c \\
        --data.data_dir=/data/imagenet_c

``runtime.eval_imagenet_c`` runs ``axcnn_torch.eval.imagenet_c.run_imagenet_c``
in place of the training loop, on as many ranks. ``runtime.platform`` picks
the device: ``""`` or ``gpu`` is the CUDA card,
and the run exits non-zero with a message when there is none; ``cpu`` is the
host. The metrics go to ``<runtime.model_dir>/metrics.jsonl``. SIGTERM
finishes the step in flight, saves a checkpoint and exits 0 (one process).

Data parallelism: ``--runtime.num_devices=N`` trains on N cards, one process
(rank) each, started here with the ``spawn`` method and joined over NCCL;
``0``, the default, means every visible card, as in the reference. The same
command serves one card and N; ``--train.batch_size`` stays the global
batch. With ``--runtime.platform=cpu`` the N ranks run on the host over
Gloo. Under a launcher that sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` (``torchrun --nproc-per-node=N -m
axcnn_torch.cli.main_classification ...``), each process is one rank and
starts nothing. With ``--runtime.spatial_partitions=S`` the N ranks form
``N / S`` data shards of ``S`` ranks each, which split the images' H
(``axcnn_torch.parallel.spatial``); on the CPU N defaults to S. If a rank
fails, the run ends with a non-zero exit code and
that rank's traceback; the others are stopped. A rank that fails after
another (most often at a collective that the first failure broke) waits
``PEER_GRACE_S`` before it exits, so that the first failure, the cause, is
the one reported.
"""

from __future__ import annotations

import os
import socket
import sys
import time

PEER_GRACE_S = 10.0


def num_ranks(cfg) -> int:
    """The ranks ``runtime.num_devices`` asks for: on the card, 0 means
    every visible card and more than the visible cards is refused; on the
    CPU, 0 means one (``runtime.spatial_partitions`` with S > 1: S). The
    spatial partitions must divide them and the image size pass the shard
    rule, and the global batch must divide among the data shards."""
    import torch

    from axcnn_torch.parallel.spatial import check_shard_rows
    from axcnn_torch.train.loop import resolve_device

    n = cfg.runtime.num_devices
    spatial = max(cfg.runtime.spatial_partitions, 1)
    check_shard_rows(cfg.data.image_size, spatial)
    if n < 0:
        raise ValueError(f"runtime.num_devices must be >= 0, got {n}")
    if resolve_device(cfg.runtime.platform).type == "cpu":
        n = n or spatial
    else:
        cards = torch.cuda.device_count()
        if n > cards:
            raise ValueError(f"runtime.num_devices={n} but {cards} CUDA card(s) are visible")
        n = n or cards
    if n % spatial:
        raise ValueError(f"{n} devices not divisible by spatial={spatial}")
    if cfg.train.batch_size % (n // spatial):
        raise ValueError(f"global batch {cfg.train.batch_size} not divisible by "
                         f"{n // spatial} data-parallel ranks")
    return n


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, coordinator: str, argv, results, failed) -> None:
    """One spawned rank: card ``rank`` (or the host), the process group,
    the run; rank 0 hands its metrics back. ``failed`` is set by the first
    rank to fail."""
    import torch

    from axcnn_torch.parallel import mesh
    from axcnn_torch.train.loop import resolve_device
    from axcnn_torch.utils.config import parse_cli

    cfg = parse_cli(argv)
    device = resolve_device(cfg.runtime.platform, rank)
    if device.type == "cpu":
        # the host's cores shared out: ranks whose thread pools spin on every
        # core while they wait at a collective slow each other down; an
        # OMP_NUM_THREADS in the environment (a launcher's, a test's) caps it
        torch.set_num_threads(thread_share(world))
    mesh.init_distributed(device, rank=rank, world_size=world, coordinator=coordinator)
    try:
        metrics = _run(cfg, local_rank=rank)
    except BaseException:
        if failed.is_set():  # another rank failed first: let its error end the run
            time.sleep(PEER_GRACE_S)
        failed.set()
        raise
    finally:
        mesh.shutdown()
    if rank == 0:
        results.put(metrics)


def thread_share(world: int) -> int:
    """A CPU rank's intra-op threads: its share of the host's cores, capped
    by the first field of ``OMP_NUM_THREADS`` ('4', or '4,2': OpenMP's list
    a nesting level) where that is a positive integer."""
    share = max(1, (os.cpu_count() or 1) // world)
    try:
        cap = int(os.environ.get("OMP_NUM_THREADS", "").split(",")[0])
    except ValueError:
        return share
    return min(share, cap) if cap > 0 else share


def _run(cfg, *, local_rank: int = 0):
    """This process's part of the run: the mCE evaluation or the training
    loop."""
    if cfg.runtime.eval_imagenet_c:
        from axcnn_torch.eval.imagenet_c import run_imagenet_c

        return run_imagenet_c(cfg, local_rank=local_rank)
    from axcnn_torch.train.loop import run

    return run(cfg, local_rank=local_rank)


def main(argv=None):
    from axcnn_torch.parallel import mesh
    from axcnn_torch.train.loop import check_ported, resolve_device
    from axcnn_torch.utils.config import parse_cli

    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = parse_cli(argv)
    print(cfg.to_json(), file=sys.stderr)
    check_ported(cfg)  # before any rank starts
    if "WORLD_SIZE" in os.environ:  # one rank under a launcher
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        mesh.init_distributed(resolve_device(cfg.runtime.platform, local_rank))
        try:
            metrics = _run(cfg, local_rank=local_rank)
        finally:
            mesh.shutdown()
    elif (world := num_ranks(cfg)) > 1:
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        results = ctx.SimpleQueue()
        mp.start_processes(_rank_main, nprocs=world, start_method="spawn",
                           args=(world, f"127.0.0.1:{_free_port()}", argv, results,
                                 ctx.Event()))
        metrics = results.get()
    else:
        metrics = _run(cfg)
    print({k: round(v, 4) if isinstance(v, float) else v
           for k, v in (metrics or {}).items()})
    return metrics


if __name__ == "__main__":
    main()
