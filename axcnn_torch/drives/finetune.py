"""Transfer-learning (warm-start) drive through the training loop's
``run()``, the one the CLI calls (port of ``scripts/finetune_drive.py``).

1. Pretrain config 4 (``bn_momentum=0.9``, ``ema_decay=0.99``) on 4 colour
   classes (A), 150 steps, batch 64, 224x224, bf16, base LR 0.05 at batch
   64, no warm-up, AutoAugment v0, mixup 0.2, the native loader, seed 3,
   with its checkpoints.
2. Fine-tune on 3 texture classes (B) that colour does not separate, with
   ``train.pretrained_checkpoint`` set to A's checkpoints (the head left
   out, 4 -> 3 classes), the same budget.
3. B from scratch with the same budget, reported beside the warm start.

Every run evaluates the train split at its last step (the sets have no
held-out split, as in the reference). Bars (``check``): A top-1 >= 90
(asserted before B), the warm fine-tune's top-1 >= 90; the cold run is not
barred.

    python -m axcnn_torch.drives.finetune [root]     # on the card

Options: ``--steps`` (a run's), ``--batch``, ``--image_size``,
``--width``, ``--n_per_class`` (images a class of each set), ``--cpu`` and
``--no-check``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from axcnn_torch.data import datasets
from axcnn_torch.drives import common
from axcnn_torch.drives.data import make_color_dataset, make_texture_dataset
from axcnn_torch.models.resnet import ModelConfig
from axcnn_torch.train.loop import run as train_run
from axcnn_torch.utils.config import Config, DataConfig, RuntimeConfig, TrainConfig

STEPS = 150
BATCH = 64
IMAGE = 224
N_PER_CLASS = 64
DEFAULT_ROOT = os.path.join(tempfile.gettempdir(), "axcnn_torch_finetune")
OK_LINE = "FINETUNE DRIVE OK"
# the three runs' eval metrics, by run
SUMMARY_KEYS = tuple(f"{leg}/{m}" for leg in ("pretrain_a", "finetune_warm", "finetune_cold")
                     for m in ("top1", "top5", "loss"))


def model_config(num_classes: int, width: float = 1.0) -> ModelConfig:
    return ModelConfig(resnet_size=50, num_classes=num_classes, use_resnet_d=True,
                       use_se_block=True, use_sk_block=True, anti_alias_type="sconv",
                       use_dropblock=True, dropblock_keep_prob=0.9, zero_gamma=True,
                       bn_momentum=0.9, width_multiplier=width)


def run_config(data_dir, num_classes, num_examples, model_dir, *, pretrained="",
               steps=STEPS, batch=BATCH, image_size=IMAGE, width=1.0, device) -> Config:
    """The reference's ``_run`` config, the set registered as
    ``drive<num_classes>`` (eval reads the train split)."""
    name = f"drive{num_classes}"
    datasets.DATASETS[name] = datasets.DatasetInfo(
        name, num_classes=num_classes, num_train=num_examples, num_eval=num_examples,
        train_prefix="train", eval_prefix="train")
    return Config(
        model=model_config(num_classes, width),
        data=DataConfig(dataset_name=name, data_dir=data_dir, image_size=image_size,
                        resize_min=common.resize_min_for(image_size),
                        autoaugment_type="v0", mixup_alpha=0.2,
                        num_workers=os.cpu_count() or 4, loader="cpp"),
        train=TrainConfig(batch_size=batch, train_steps=steps,
                          base_lr=0.05 * 256 / batch,  # undo the per-256 scaling
                          lr_warmup_epochs=0.0, label_smoothing=0.1,
                          use_ema=True, ema_decay=0.99, dtype="bf16",
                          seed=3, log_every=50, pretrained_checkpoint=pretrained),
        runtime=RuntimeConfig(model_dir=model_dir, num_devices=1,
                              platform="cpu" if device.type == "cpu" else ""),
    )


def check_pretrain(top1: float, detail) -> None:
    assert top1 >= 90.0, f"pretrain A top-1 {top1} < 90: {detail}"


def check(summary: dict) -> None:
    """The reference's bars; ``AssertionError`` with the summary on a miss."""
    check_pretrain(summary["pretrain_a"]["top1"], summary)
    assert summary["finetune_warm"]["top1"] >= 90.0, f"warm fine-tune top-1 < 90: {summary}"


def run(root: str = DEFAULT_ROOT, *, steps: int = STEPS, batch: int = BATCH,
        image_size: int = IMAGE, width: float = 1.0, n_per_class: int = N_PER_CLASS,
        device=None, check_bars: bool = True, log=print) -> dict:
    device = common.resolve_device(device)
    os.makedirs(root, exist_ok=True)
    a_dir, a_nc, a_n = make_color_dataset(os.path.join(root, "colors"), n=n_per_class)
    b_dir, b_nc, b_n = make_texture_dataset(os.path.join(root, "textures"), n=n_per_class)
    # run() builds its loaders with loader="cpp": hold it to the native path here
    common.native_loader(a_dir, datasets.DatasetInfo("colors", a_nc, a_n, a_n), batch=batch,
                         image_size=image_size, train=True, autoaugment_type="v0")
    size = dict(steps=steps, batch=batch, image_size=image_size, width=width, device=device)
    summary, seconds = {}, {}

    def leg(name, data_dir, nc, n, model_dir, pretrained=""):
        t0 = time.time()
        m = train_run(run_config(data_dir, nc, n, os.path.join(root, model_dir),
                                 pretrained=pretrained, **size))
        seconds[name] = time.time() - t0
        summary[name] = m
        return m

    m_a = leg("pretrain_a", a_dir, a_nc, a_n, "run_a")
    log(f"[pretrain A/colors] top1={m_a['top1']:.2f}% ({seconds['pretrain_a']:.0f}s)")
    if check_bars:
        check_pretrain(m_a["top1"], m_a)
    m_ft = leg("finetune_warm", b_dir, b_nc, b_n, "run_b_ft",
               pretrained=os.path.join(root, "run_a", "checkpoints"))
    log(f"[fine-tune B/textures, warm-start from A] top1={m_ft['top1']:.2f}% "
        f"({seconds['finetune_warm']:.0f}s)")
    m_cold = leg("finetune_cold", b_dir, b_nc, b_n, "run_b_cold")
    log(f"[cold-start B/textures, same budget] top1={m_cold['top1']:.2f}% "
        f"({seconds['finetune_cold']:.0f}s)")
    summary.update(steps=steps, batch=batch, image_size=image_size, seconds=seconds,
                   native_loader=True)
    log(json.dumps(summary))
    if check_bars:
        check(summary)
        log(f"{OK_LINE}  (warm {m_ft['top1']:.1f}% vs cold {m_cold['top1']:.1f}%)")
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("root", nargs="?", default=DEFAULT_ROOT)
    common.add_size_args(p, steps=STEPS, batch=BATCH, image_size=IMAGE)
    p.add_argument("--n_per_class", type=int, default=N_PER_CLASS)
    a = p.parse_args(argv)
    return run(a.root, steps=a.steps, batch=a.batch, image_size=a.image_size, width=a.width,
               n_per_class=a.n_per_class, device="cpu" if a.cpu else None,
               check_bars=a.check)


if __name__ == "__main__":
    main()
