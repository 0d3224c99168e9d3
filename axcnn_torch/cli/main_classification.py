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

``runtime.platform`` picks the device: ``""`` or ``gpu`` is the CUDA card,
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
starts nothing. If a rank fails, the run ends with a non-zero exit code and
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
    CPU, 0 means one. The global batch must divide among them."""
    import torch

    from axcnn_torch.train.loop import resolve_device

    n = cfg.runtime.num_devices
    if n < 0:
        raise ValueError(f"runtime.num_devices must be >= 0, got {n}")
    if resolve_device(cfg.runtime.platform).type == "cpu":
        n = max(n, 1)
    else:
        cards = torch.cuda.device_count()
        if n > cards:
            raise ValueError(f"runtime.num_devices={n} but {cards} CUDA card(s) are visible")
        n = n or cards
    if cfg.train.batch_size % n:
        raise ValueError(f"global batch {cfg.train.batch_size} not divisible by {n} "
                         "data-parallel ranks")
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
    from axcnn_torch.train.loop import resolve_device, run
    from axcnn_torch.utils.config import parse_cli

    cfg = parse_cli(argv)
    device = resolve_device(cfg.runtime.platform, rank)
    if device.type == "cpu":
        # the host's cores shared out: ranks whose thread pools spin on every
        # core while they wait at a collective slow each other down
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh.init_distributed(device, rank=rank, world_size=world, coordinator=coordinator)
    try:
        metrics = run(cfg, local_rank=rank)
    except BaseException:
        if failed.is_set():  # another rank failed first: let its error end the run
            time.sleep(PEER_GRACE_S)
        failed.set()
        raise
    finally:
        mesh.shutdown()
    if rank == 0:
        results.put(metrics)


def main(argv=None):
    from axcnn_torch.parallel import mesh
    from axcnn_torch.train.loop import resolve_device, run
    from axcnn_torch.utils.config import parse_cli

    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = parse_cli(argv)
    print(cfg.to_json(), file=sys.stderr)
    if "WORLD_SIZE" in os.environ:  # one rank under a launcher
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        mesh.init_distributed(resolve_device(cfg.runtime.platform, local_rank))
        try:
            metrics = run(cfg, local_rank=local_rank)
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
        metrics = run(cfg)
    print({k: round(v, 4) if isinstance(v, float) else v
           for k, v in (metrics or {}).items()})
    return metrics


if __name__ == "__main__":
    main()
