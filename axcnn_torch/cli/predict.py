"""Single-image / batch inference CLI (port of ``axcnn/cli/predict.py``).

Usage:
    python -m axcnn_torch.cli.predict --image=cat.jpg --config=assemble_resnet50

    # fp32 on the host CPU (BASELINE config 1):
    ... --train.dtype=fp32 --cpu

Runs on the CUDA device by default and refuses to start without one unless
``--cpu`` is given. Prints one JSON line per image:
``{"image": ..., "top5": [[class, prob], ...]}``.

Reading the reference's orbax checkpoints is not ported yet (ROADMAP.md Queue
A item 7): like the reference CLI when it finds no checkpoint, this warns and
serves a seeded random init. ``--export`` is not ported either.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    images, export_dir, labels_file, use_cpu, rest = [], None, None, False, []
    for a in argv:
        if a.startswith("--image="):
            images.append(a.split("=", 1)[1])
        elif a.startswith("--export="):
            export_dir = a.split("=", 1)[1]
        elif a.startswith("--labels="):
            labels_file = a.split("=", 1)[1]
        elif a == "--cpu":
            use_cpu = True
        else:
            rest.append(a)
    if not images:
        print("usage: predict --image=FILE [--image=FILE ...] "
              "[--config=... --runtime.model_dir=DIR] [--labels=FILE] [--cpu]",
              file=sys.stderr)
        return 2
    if export_dir:
        raise NotImplementedError(
            "--export is not ported to axcnn_torch yet (ROADMAP.md Queue A "
            "item 10)")

    import torch

    if not use_cpu and not torch.cuda.is_available():
        print("error: no CUDA device; pass --cpu to run on the host CPU",
              file=sys.stderr)
        return 1
    device = torch.device("cpu" if use_cpu else "cuda")

    from axcnn.data.datasets import DatasetInfo, get_dataset
    from axcnn.data.preprocessing import preprocess_eval
    from axcnn_torch.core.dtypes import policy_from_name, set_fp32_precision
    from axcnn_torch.train.train_step import create_train_state, eval_logits, load_ema
    from axcnn_torch.utils.config import parse_cli

    cfg = parse_cli(rest)
    size = cfg.data.image_size
    batch = np.stack([
        preprocess_eval(Path(p).read_bytes(), image_size=size,
                        resize_min=max(size * 256 // 224, size))
        for p in images
    ])
    if cfg.data.dataset_name == "custom":
        if cfg.data.num_classes <= 0:
            raise ValueError("dataset_name='custom' needs --data.num_classes")
        info = DatasetInfo("custom", cfg.data.num_classes,
                           max(cfg.data.num_train_examples, 0),
                           max(cfg.data.num_eval_examples, 0),
                           label_offset=cfg.data.label_offset)
    else:
        info = get_dataset(cfg.data.dataset_name)
    model_cfg = dataclasses.replace(cfg.model, num_classes=info.num_classes)
    policy = policy_from_name(cfg.train.dtype)
    set_fp32_precision(policy)

    print(f"warning: reading checkpoints ({cfg.runtime.model_dir}) is not "
          "ported yet; using random init (seed 0)", file=sys.stderr)
    state = create_train_state(model_cfg, generator=torch.Generator().manual_seed(0),
                               device=device, use_ema=cfg.train.use_ema)
    load_ema(state)
    logits = eval_logits(state, torch.from_numpy(batch).to(device), policy=policy,
                         mean_rgb=info.mean_rgb, stddev_rgb=info.stddev_rgb)
    logits = logits.cpu().numpy()

    class_names = None
    if labels_file:
        with open(labels_file) as f:
            class_names = [line.strip() for line in f]

    e = np.exp(logits - logits.max(axis=-1, keepdims=True))
    probs = e / e.sum(axis=-1, keepdims=True)
    for path, p in zip(images, probs):
        top = np.argsort(p)[::-1][:5]
        entries = [
            [class_names[i] if class_names and i < len(class_names) else int(i),
             round(float(p[i]), 5)]
            for i in top
        ]
        print(json.dumps({"image": path, "top5": entries}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
