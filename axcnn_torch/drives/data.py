"""The convergence drives' generated datasets (the port's copies of the
reference's generators in ``scripts/``).

For the same seed and sizes each generator writes the same JPEG bytes and
the same TFRecord records as the reference's; the shards go through
``axcnn_torch.data.build_tfrecords.write_shards``. Every class factor
(hue, stripe orientation, pattern) survives the training augmentations:
random flip, RandomResizedCrop and AutoAugment v0.

- ``make_dataset``, ``CLASSES``: 4 colour-dominant classes
  (``scripts/convergence_drive.py``); eval reads the train split.
- ``STRIPE_HUES``, ``_striped``, ``make_set``: hue x stripe-orientation
  classes with a held-out split (``scripts/convergence_drive_full.py``,
  where the first is ``HUES``).
- ``SCALE_HUES``, ``PATTERNS``, ``_pattern_mask``, ``_image``,
  ``make_scale_set``: the 50-class set, 10 hues x 5 patterns
  (``scripts/convergence_drive_scale.py``, where they are ``HUES`` and
  ``make_set``).
- ``make_subset``: an n-per-class subset of the 50-class set with uniform
  label noise on its train split (``scripts/kd_drive.py``).
- ``make_color_dataset``, ``_texture``, ``make_texture_dataset``: 4 colour
  classes, then 3 texture classes that the colour statistics do not
  separate (``scripts/finetune_drive.py``); eval reads the train split.
- ``HUES_1K``, ``PATTERNS_1K``, ``_image_1k``, ``make_set_1k``: the 1,000
  foreground hue x background hue x pattern classes, labels stored 0..999
  (``scripts/convergence_drive_1k.py``, where they are ``HUES``,
  ``PATTERNS``, ``_image``). ``_pattern_mask`` draws the 1k set's ten
  patterns, the 50-class set's five among them with the same draws.

``make_set``, ``make_scale_set``, ``make_subset`` and ``make_set_1k`` leave
a marker file once their shards are written, and a rerun with the same
sizes returns the cached shards.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
from PIL import Image

from axcnn_torch.data.build_tfrecords import write_shards
from axcnn_torch.data.datasets import DatasetInfo

CLASSES = (("red", 0), ("green", 1), ("blue", 2), ("yellow", 3))

STRIPE_HUES = {"red": (1, 0, 0), "green": (0, 1, 0), "blue": (0, 0, 1),
               "yellow": (1, 1, 0), "magenta": (1, 0, 1)}

# 10 hues with distinct per-channel ratios: brightness/contrast ops scale the
# channels together, so the ratios survive AutoAugment
SCALE_HUES = {
    "red": (1.0, 0.0, 0.0), "green": (0.0, 1.0, 0.0), "blue": (0.0, 0.0, 1.0),
    "yellow": (1.0, 1.0, 0.0), "magenta": (1.0, 0.0, 1.0),
    "cyan": (0.0, 1.0, 1.0), "orange": (1.0, 0.5, 0.0),
    "purple": (0.5, 0.0, 1.0), "spring": (0.0, 1.0, 0.5),
    "white": (1.0, 1.0, 1.0),
}
PATTERNS = ("hstripe", "vstripe", "checker", "dots", "rings")
SCALE_CLASSES = len(SCALE_HUES) * len(PATTERNS)
# the 50-class set's shared home (the scale, KD and Big-Little drives)
SCALE_ROOT = os.path.join(tempfile.gettempdir(), "axcnn_torch_convergence_scale")

# the 1,000-class set: the same 10 hues as foreground and as background
HUES_1K = dict(SCALE_HUES)
PATTERNS_1K = ("hstripe", "vstripe", "checker", "dots", "rings",
               "diag", "dcheck", "squares", "grid", "waves")
# the 1k set at these sizes a class keeps the plain "rec" directory
N_TRAIN_1K, N_EVAL_1K = 24, 3


def make_dataset(root, n_per_class=64, classes=CLASSES):
    """Colour-dominant classes with textured noise, separable only through
    the full augmentation stack; 4 train shards, which the eval reads too.
    Returns (shard dir, DatasetInfo)."""
    rng = np.random.default_rng(0)
    items = []
    raw = os.path.join(root, "raw")
    for cls, label in classes:
        d = os.path.join(raw, cls)
        os.makedirs(d, exist_ok=True)
        for i in range(n_per_class):
            img = rng.integers(0, 90, (256, 320, 3)).astype(np.uint8)
            if cls == "red":
                img[..., 0] += 120
            elif cls == "green":
                img[..., 1] += 120
            elif cls == "blue":
                img[..., 2] += 120
            else:  # yellow
                img[..., 0] += 100
                img[..., 1] += 100
            path = os.path.join(d, f"{i}.jpg")
            Image.fromarray(img).save(path, "JPEG", quality=92)
            items.append((path, label, cls))
    out = os.path.join(root, "rec")
    write_shards(items, out, "train", 4)
    info = DatasetInfo(f"colors{len(classes)}", num_classes=len(classes),
                       num_train=len(classes) * n_per_class,
                       num_eval=len(classes) * n_per_class,
                       train_prefix="train", eval_prefix="train")
    return out, info


def _striped(rng, hue, orient, h=256, w=320, band=18):
    """Noisy striped image: bands of the hue alternating with dark."""
    img = rng.integers(0, 70, (h, w, 3)).astype(np.int16)
    yy, xx = np.mgrid[0:h, 0:w]
    if orient == "h":
        phase = yy
    elif orient == "v":
        phase = xx
    elif orient == "dl":  # diagonal, down-right
        phase = xx + yy
    else:  # "dr", diagonal, up-right
        phase = xx - yy
    on = ((phase // band) % 2).astype(bool)
    boost = rng.integers(90, 130)
    for c, active in enumerate(hue):
        if active:
            img[..., c] += np.where(on, boost, 0)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_set(root, classes, n_train, n_eval, seed):
    """``classes``: a list of (name, hue_rgb, orient). Writes 4 train and 2
    validation shards; returns (shard dir, DatasetInfo)."""
    rng = np.random.default_rng(seed)
    out = os.path.join(root, "rec")
    tag = "-".join(name for name, _, _ in classes)
    marker = os.path.join(out, f"ok-{tag}-{n_train}-{n_eval}")
    info = DatasetInfo(f"drive{len(classes)}", num_classes=len(classes),
                       num_train=n_train * len(classes),
                       num_eval=n_eval * len(classes),
                       train_prefix="train", eval_prefix="validation")
    if os.path.exists(marker):
        return out, info
    raw = os.path.join(root, "raw")
    items = {"train": [], "validation": []}
    for label, (name, hue, orient) in enumerate(classes):
        d = os.path.join(raw, name)
        os.makedirs(d, exist_ok=True)
        for i in range(n_train + n_eval):
            path = os.path.join(d, f"{i}.jpg")
            Image.fromarray(_striped(rng, hue, orient)).save(path, "JPEG", quality=92)
            split = "train" if i < n_train else "validation"
            items[split].append((path, label, name))
    write_shards(items["train"], out, "train", 4)
    write_shards(items["validation"], out, "validation", 2)
    open(marker, "w").close()
    return out, info


def _pattern_mask(rng, kind, h, w):
    """Boolean foreground mask; every pattern is flip- and crop-invariant
    and told apart by shape, not by absolute scale (the crop zooms)."""
    band = int(rng.integers(14, 24))
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "hstripe":
        return (yy // band) % 2 == 0
    if kind == "vstripe":
        return (xx // band) % 2 == 0
    if kind == "checker":
        return ((yy // band) + (xx // band)) % 2 == 0
    if kind == "dots":
        p = 2 * band
        r = band * 0.55
        return ((yy % p - p / 2) ** 2 + (xx % p - p / 2) ** 2) < r * r
    if kind == "rings":
        # concentric circles around a random centre (the class is the
        # pattern, not the centre)
        cy = int(rng.integers(h // 4, 3 * h // 4))
        cx = int(rng.integers(w // 4, 3 * w // 4))
        rad = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        return (rad // band) % 2 == 0
    if kind == "diag":
        # either diagonal direction an image: a flip maps one onto the other
        s = (yy + xx) if rng.integers(2) else (yy - xx)
        return (s // int(band * 1.5)) % 2 == 0
    if kind == "dcheck":
        # the checker turned 45 degrees (diamonds)
        b = int(band * 1.5)
        return (((yy + xx) // b) + ((yy - xx) // b)) % 2 == 0
    if kind == "squares":
        # concentric squares (Chebyshev rings) around a random centre
        cy = int(rng.integers(h // 4, 3 * h // 4))
        cx = int(rng.integers(w // 4, 3 * w // 4))
        rad = np.maximum(np.abs(yy - cy), np.abs(xx - cx))
        return (rad // band) % 2 == 0
    if kind == "grid":
        # a thin-line lattice
        p, t = 3 * band, max(6, band // 2)
        return (yy % p < t) | (xx % p < t)
    # waves: horizontal stripes displaced by a sine; a flip shifts the phase
    lam = 4 * band
    return ((yy + band * np.sin(2 * np.pi * xx / lam)).astype(np.int64)
            // band) % 2 == 0


def _image(rng, hue, kind, h=256, w=320):
    img = rng.integers(0, 70, (h, w, 3)).astype(np.int16)
    mask = _pattern_mask(rng, kind, h, w)
    boost = int(rng.integers(90, 130))
    for c, frac in enumerate(hue):
        if frac:
            img[..., c] += np.where(mask, int(boost * frac), 0)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_scale_set(root, n_train, n_eval, seed, log=print):
    """The 50 hue x pattern classes: ``n_train`` + ``n_eval`` images a class
    under ``<root>/raw/<hue>_<pattern>/<i>.jpg``, 8 train and 2 validation
    shards. Returns (shard dir, DatasetInfo)."""
    rng = np.random.default_rng(seed)
    out = os.path.join(root, "rec")
    marker = os.path.join(out, f"ok-50c-{n_train}-{n_eval}")
    info = DatasetInfo("drive50", num_classes=SCALE_CLASSES,
                       num_train=n_train * SCALE_CLASSES, num_eval=n_eval * SCALE_CLASSES,
                       train_prefix="train", eval_prefix="validation")
    if os.path.exists(marker):
        return out, info
    raw = os.path.join(root, "raw")
    items = {"train": [], "validation": []}
    label = 0
    t0 = time.time()
    for hname, hue in SCALE_HUES.items():
        for kind in PATTERNS:
            d = os.path.join(raw, f"{hname}_{kind}")
            os.makedirs(d, exist_ok=True)
            for i in range(n_train + n_eval):
                path = os.path.join(d, f"{i}.jpg")
                Image.fromarray(_image(rng, hue, kind)).save(path, "JPEG", quality=92)
                split = "train" if i < n_train else "validation"
                items[split].append((path, label, f"{hname}_{kind}"))
            label += 1
    log(f"[gen] {label} classes, {len(items['train'])} train / "
        f"{len(items['validation'])} eval in {time.time() - t0:.0f}s")
    write_shards(items["train"], out, "train", 8)
    write_shards(items["validation"], out, "validation", 2)
    open(marker, "w").close()
    return out, info


def make_subset(full_root, out_root, n_per_class, noise_frac=0.0, noise_seed=1, *,
                n_train=120, n_eval=24):
    """Subset shards from the raw images of the 50-class set under
    ``full_root`` (written by ``make_scale_set`` with ``n_train`` and
    ``n_eval`` a class), in its label order, so that a teacher's head
    indices mean the same classes: the first ``n_per_class`` images of each
    class for training, the full set's held-out images unchanged for
    validation. ``noise_frac`` of the train labels, chosen by
    ``noise_seed``, are replaced by a uniformly drawn wrong label; the
    validation labels stay true."""
    tag = f"rec_sub{n_per_class}" + (f"_noise{noise_frac}" if noise_frac else "")
    out = os.path.join(out_root, tag)
    info = DatasetInfo(f"kd_{tag}", num_classes=SCALE_CLASSES,
                       num_train=n_per_class * SCALE_CLASSES,
                       num_eval=n_eval * SCALE_CLASSES,
                       train_prefix="train", eval_prefix="validation")
    # the full set's sizes name the marker: another full set, another subset
    marker = os.path.join(out, f"ok-{n_train}-{n_eval}")
    if os.path.exists(marker):
        return out, info
    raw = os.path.join(full_root, "raw")
    items = {"train": [], "validation": []}
    label = 0
    for hname in SCALE_HUES:  # make_scale_set's label order
        for kind in PATTERNS:
            d = os.path.join(raw, f"{hname}_{kind}")
            for i in range(n_per_class):
                items["train"].append((os.path.join(d, f"{i}.jpg"), label, f"{hname}_{kind}"))
            for i in range(n_train, n_train + n_eval):
                items["validation"].append(
                    (os.path.join(d, f"{i}.jpg"), label, f"{hname}_{kind}"))
            label += 1
    if noise_frac:
        rng = np.random.default_rng(noise_seed)
        n = len(items["train"])
        noisy = set(rng.choice(n, size=int(round(noise_frac * n)), replace=False).tolist())
        noised = []
        for j, (path, lab, txt) in enumerate(items["train"]):
            if j in noisy:
                # a uniform WRONG label, never the true one
                lab = int((lab + rng.integers(1, SCALE_CLASSES)) % SCALE_CLASSES)
            noised.append((path, lab, txt))
        items["train"] = noised
    write_shards(items["train"], out, "train", 4)
    write_shards(items["validation"], out, "validation", 2)
    open(marker, "w").close()
    return out, info


def _texture(rng, kind):
    """One of 3 shape classes (h stripes, v stripes, checker) in a random
    colour: not separable by the colour statistics of the colour set."""
    img = rng.integers(0, 60, (256, 320, 3)).astype(np.uint8)
    c = rng.integers(100, 255, (3,), dtype=np.uint8)
    period = int(rng.integers(12, 28))
    yy, xx = np.mgrid[0:256, 0:320]
    if kind == "hstripe":
        m = (yy // period) % 2 == 0
    elif kind == "vstripe":
        m = (xx // period) % 2 == 0
    else:  # checker
        m = ((yy // period) + (xx // period)) % 2 == 0
    # widen before adding: a uint8 sum wraps before any clamp
    img[m] = np.minimum(img[m].astype(np.int32) + c.astype(np.int32), 255).astype(np.uint8)
    return img


def make_color_dataset(root, n=64):
    """4 colour classes, ``n`` images each, in 4 train shards. Returns
    (shard dir, number of classes, number of images)."""
    rng = np.random.default_rng(0)
    items = []
    for label, cls in enumerate(("red", "green", "blue", "yellow")):
        d = os.path.join(root, "raw", cls)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            img = rng.integers(0, 90, (256, 320, 3)).astype(np.uint8)
            for c in {"red": (0,), "green": (1,), "blue": (2,), "yellow": (0, 1)}[cls]:
                img[..., c] += 100
            p = os.path.join(d, f"{i}.jpg")
            Image.fromarray(img).save(p, "JPEG", quality=92)
            items.append((p, label, cls))
    out = os.path.join(root, "rec")
    write_shards(items, out, "train", 4)
    return out, 4, len(items)


def make_texture_dataset(root, n=64):
    """3 texture classes, ``n`` images each, in 4 train shards. Returns
    (shard dir, number of classes, number of images)."""
    rng = np.random.default_rng(1)
    items = []
    for label, kind in enumerate(("hstripe", "vstripe", "checker")):
        d = os.path.join(root, "raw", kind)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            p = os.path.join(d, f"{i}.jpg")
            Image.fromarray(_texture(rng, kind)).save(p, "JPEG", quality=92)
            items.append((p, label, kind))
    out = os.path.join(root, "rec")
    write_shards(items, out, "train", 4)
    return out, 3, len(items)


def _image_1k(rng, fg, bg, kind, h=256, w=320):
    """The pattern in the foreground hue over the background hue; the
    foreground's boost range lies above the background's."""
    img = rng.integers(0, 40, (h, w, 3)).astype(np.int16)
    mask = _pattern_mask(rng, kind, h, w)
    fg_boost = int(rng.integers(115, 146))
    bg_boost = int(rng.integers(55, 76))
    for c in range(3):
        img[..., c] += np.where(mask, int(fg_boost * fg[c]), int(bg_boost * bg[c]))
    return np.clip(img, 0, 255).astype(np.uint8)


def classes_1k() -> int:
    """The 1k set's classes: foreground x background hues x patterns."""
    return len(HUES_1K) ** 2 * len(PATTERNS_1K)


def make_set_1k(root, n_train, n_eval, seed, log=print):
    """The foreground x background x pattern classes of ``HUES_1K`` and
    ``PATTERNS_1K`` (read when called), stored labels 0..999 (the CLI runs
    them with ``--data.label_offset=1``): ``n_train`` + ``n_eval`` images a
    class under ``<root>/raw``, 16 train and 4 validation shards in
    ``<root>/rec`` at the sizes ``N_TRAIN_1K``, ``N_EVAL_1K``, else in
    ``<root>/rec_<n_train>_<n_eval>``. A JPEG already under ``raw`` is kept
    (and draws nothing). Returns the shard directory."""
    out = os.path.join(root, "rec" if (n_train, n_eval) == (N_TRAIN_1K, N_EVAL_1K)
                       else f"rec_{n_train}_{n_eval}")
    marker = os.path.join(out, f"ok-1k-{n_train}-{n_eval}")
    if os.path.exists(marker):
        return out
    rng = np.random.default_rng(seed)
    raw = os.path.join(root, "raw")
    items = {"train": [], "validation": []}
    label = 0
    t0 = time.time()
    hues = list(HUES_1K.items())
    for fname, fhue in hues:
        for bname, bhue in hues:
            for kind in PATTERNS_1K:
                name = f"{fname}_{bname}_{kind}"
                d = os.path.join(raw, name)
                os.makedirs(d, exist_ok=True)
                for i in range(n_train + n_eval):
                    path = os.path.join(d, f"{i}.jpg")
                    if not os.path.exists(path):
                        Image.fromarray(_image_1k(rng, fhue, bhue, kind)).save(
                            path, "JPEG", quality=92)
                    split = "train" if i < n_train else "validation"
                    items[split].append((path, label, name))
                label += 1
        log(f"[gen] fg={fname} done ({label} classes, {time.time() - t0:.0f}s)")
    log(f"[gen] {label} classes, {len(items['train'])} train / "
        f"{len(items['validation'])} eval in {time.time() - t0:.0f}s")
    write_shards(items["train"], out, "train", 16)
    write_shards(items["validation"], out, "validation", 4)
    open(marker, "w").close()
    return out
