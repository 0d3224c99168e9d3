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
finishes the step in flight, saves a checkpoint and exits 0.
"""

from __future__ import annotations

import sys


def main(argv=None):
    from axcnn_torch.train.loop import run
    from axcnn_torch.utils.config import parse_cli

    cfg = parse_cli(sys.argv[1:] if argv is None else argv)
    print(cfg.to_json(), file=sys.stderr)
    metrics = run(cfg)
    print({k: round(v, 4) if isinstance(v, float) else v
           for k, v in (metrics or {}).items()})
    return metrics


if __name__ == "__main__":
    main()
