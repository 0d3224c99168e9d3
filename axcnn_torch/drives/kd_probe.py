"""Is the KD drive's teacher healthy in the path the students train on?
(port of ``scripts/kd_probe.py``)

Loads the teacher as the training loop does (``loop._load_teacher``: its
EMA weights, eval mode) from ``<root>/teacher/checkpoints`` (the KD
drive's layout), with a default ``Config`` and the 50-class head, and
scores it under the train step's conditions (bf16, normalized images) on

1. two clean eval batches (the held-out split, the last partial batch
   dropped);
2. two train-augmented batches (the training loader with AutoAugment v0,
   seed 0: the stream the students see; the reference's loader call leaves
   AutoAugment at its default, none, though its comment names that
   stream);
3. one mixed batch, ``0.7 x + 0.3 x[::-1]`` on the raw images of the next
   train batch, scored against its first labels.

Each batch reports top-1, the mean max-softmax (fp32), the mean entropy
(``+1e-9`` inside the log) and the mean over rows of the logits'
population standard deviation. If (1) fails, loading the teacher through
the KD path is broken; if (1) holds and (2) or (3) collapse, the teacher
gives the students no signal. Bar (``check``): the second clean batch's
top-1 > 0.9.

    python -m axcnn_torch.drives.kd_probe [root]      # after axcnn_torch.drives.kd

Options: ``--batch``, the full set's images a class (``--n_train``,
``--n_eval``) and its directory (``--scale_root``), ``--cpu`` and
``--no-check``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from axcnn_torch.data.preprocessing import normalize_device
from axcnn_torch.drives import common
from axcnn_torch.drives.data import SCALE_CLASSES, SCALE_ROOT, make_scale_set
from axcnn_torch.drives.kd import DEFAULT_ROOT, N_EVAL, N_TRAIN
from axcnn_torch.train.loop import _load_teacher
from axcnn_torch.utils.config import Config

BATCH = 64
IMAGE = 224
MIX_LAM = 0.7
OK_LINE = "[probe] done"


def stats(logits: torch.Tensor, labels: torch.Tensor) -> dict:
    """Top-1, mean max-softmax, mean entropy and mean logit standard
    deviation (ddof 0) of a batch, in fp32."""
    lg = logits.float()
    p = torch.softmax(lg, -1)
    return {"top1": float((lg.argmax(-1) == labels).float().mean()),
            "mean_maxp": float(p.max(-1).values.mean()),
            "mean_entropy": float((-(p * torch.log(p + 1e-9)).sum(-1)).mean()),
            "logit_std": float(torch.std(lg, -1, correction=0).mean())}


def mixed(images_u8: torch.Tensor, lam: float = MIX_LAM) -> torch.Tensor:
    """``lam x + (1 - lam) x[::-1]`` in float on the raw images."""
    x = images_u8.float()
    return lam * x + (1 - lam) * x.flip(0)


def check(summary: dict) -> None:
    top1 = summary["eval/clean2"]["top1"]
    assert top1 > 0.9, f"teacher broken on clean eval through the KD load path: {summary}"


def run(root: str = DEFAULT_ROOT, *, batch: int = BATCH, n_train: int = N_TRAIN,
        n_eval: int = N_EVAL, scale_root: str = SCALE_ROOT, device=None,
        check_bars: bool = True, log=print) -> dict:
    """The five batches' statistics, by tag."""
    device = common.resolve_device(device)
    data_dir, info = make_scale_set(scale_root, n_train=n_train, n_eval=n_eval, seed=0,
                                    log=log)
    cfg = Config()
    cfg = dataclasses.replace(
        cfg,
        train=dataclasses.replace(cfg.train, kd_teacher_checkpoint=os.path.join(
            root, "teacher", "checkpoints")),
        model=dataclasses.replace(cfg.model, num_classes=SCALE_CLASSES))
    teacher = _load_teacher(cfg, device)
    log(f"[probe] teacher cfg: size={teacher.cfg.resnet_size} "
        f"classes={teacher.cfg.num_classes}")
    summary = {}

    def report(tag, images, labels):
        x = normalize_device(images.to(device), info.mean_rgb, info.stddev_rgb)
        with torch.inference_mode():
            logits = teacher(x, policy=common.POLICY)
        s = stats(logits, labels.to(device))
        summary[tag] = s
        log(f"[{tag}] top1={s['top1'] * 100:.1f} mean_maxp={s['mean_maxp']:.3f} "
            f"mean_entropy={s['mean_entropy']:.3f} logit_std={s['logit_std']:.2f}")

    def batches(loader, n):
        it = iter(loader)
        return [next(it) for _ in range(n)]

    def tensors(b):
        return torch.from_numpy(b["images"]), torch.from_numpy(b["labels"]).long()

    clean = common.native_loader(data_dir, info, batch=batch, image_size=IMAGE, train=False,
                                 drop_remainder=True)
    for tag, b in zip(("eval/clean", "eval/clean2"), batches(clean, 2)):
        report(tag, *tensors(b))
    train = common.native_loader(data_dir, info, batch=batch, image_size=IMAGE, train=True,
                                 autoaugment_type="v0", seed=0)
    *aug, mix = batches(train, 3)
    for i, b in enumerate(aug):
        report(f"train/aug{i}", *tensors(b))
    images, labels = tensors(mix)
    report(f"train/mixup{MIX_LAM} (vs label_a)", mixed(images), labels)
    log(json.dumps(summary))
    if check_bars:
        check(summary)
        log(OK_LINE)
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("root", nargs="?", default=DEFAULT_ROOT)
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--n_train", type=int, default=N_TRAIN)
    p.add_argument("--n_eval", type=int, default=N_EVAL)
    p.add_argument("--scale_root", default=SCALE_ROOT)
    p.add_argument("--cpu", action="store_true", help="run on the host CPU")
    p.add_argument("--no-check", dest="check", action="store_false",
                   help="do not assert the bar")
    a = p.parse_args(argv)
    return run(a.root, batch=a.batch, n_train=a.n_train, n_eval=a.n_eval,
               scale_root=a.scale_root, device="cpu" if a.cpu else None, check_bars=a.check)


if __name__ == "__main__":
    main()
