"""Train/eval entry point (port of ``axcnn/cli/main_classification.py``).

Usage, with the reference's argv grammar and presets:

    python -m axcnn_torch.cli.main_classification --config=assemble_resnet50 \\
        --data.use_synthetic_data --train.train_steps=20 --train.batch_size=128

    # on the host CPU, at a small size:
    ... --runtime.platform=cpu --model.width_multiplier=0.125 \\
        --data.image_size=64 --train.batch_size=8

``runtime.platform`` picks the device: ``""`` or ``gpu`` is the CUDA card,
and the run exits non-zero with a message when there is none; ``cpu`` is the
host. The metrics go to ``<runtime.model_dir>/metrics.jsonl``.
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
