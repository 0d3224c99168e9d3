"""Raw image folders → sharded TFRecords (the port's copy of
``axcnn/data/build_tfrecords.py``: the reference ``datasets/`` tooling,
SURVEY.md §2 item 11; Inception ``build_imagenet_data`` lineage).

It writes the reference's shards byte for byte (the same layouts, label
offsets and refusals, shuffle seed and shard names) through the port's own
``TFRecordWriter`` and dataset registry, so it needs neither JAX nor
TensorFlow.

Layout expected: ``root/<split>/<class_name>/*.jpg``. Classes are sorted
lexicographically. The label offset is derived from ``--dataset``: ImageNet
labels are 1-indexed (0 = background, matching the reference's 1001-way
head); every FGVC dataset has an exactly-N-way head and gets offset 0.

Usage:
    python -m axcnn_torch.data.build_tfrecords --input_dir=... --output_dir=... \
        --dataset=imagenet --split=train --num_shards=128
"""

from __future__ import annotations

import argparse
import os

from axcnn_torch.data.tfrecord import TFRecordWriter, make_example

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def collect_images(split_dir: str, *, label_offset: int = 1):
    classes = sorted(
        d for d in os.listdir(split_dir)
        if os.path.isdir(os.path.join(split_dir, d))
    )
    items = []
    for idx, cls in enumerate(classes):
        cdir = os.path.join(split_dir, cls)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(IMAGE_EXTS):
                items.append((os.path.join(cdir, fname), idx + label_offset, cls))
    return items, classes


def write_shards(items, output_dir: str, prefix: str, num_shards: int, *,
                 shuffle_seed: int | None = 0):
    os.makedirs(output_dir, exist_ok=True)
    if shuffle_seed is not None:
        import numpy as np

        rng = np.random.default_rng(shuffle_seed)
        items = list(items)
        rng.shuffle(items)
    per_shard = -(-len(items) // num_shards)
    n = 0
    for s in range(num_shards):
        path = os.path.join(output_dir, f"{prefix}-{s:05d}-of-{num_shards:05d}")
        with TFRecordWriter(path) as w:
            for fpath, label, cls in items[s * per_shard:(s + 1) * per_shard]:
                with open(fpath, "rb") as f:
                    data = f.read()
                w.write(make_example({
                    "image/encoded": [data],
                    "image/class/label": [label],
                    "image/class/text": [cls.encode()],
                    "image/filename": [os.path.basename(fpath).encode()],
                }))
                n += 1
    return n


def collect_food101(root: str, split: str):
    """Published Food-101 archive layout: ``images/<class>/<id>.jpg`` +
    ``meta/train.txt`` / ``meta/test.txt`` with ``<class>/<id>`` lines.

    The label<->class mapping comes from ``meta/classes.txt`` (part of the
    published archive) or, failing that, the UNION of both split files —
    never from one split's own entries, which would silently shift indices
    between train and test if a class is missing from either."""
    def read_lines(name):
        with open(os.path.join(root, "meta", name)) as f:
            return [ln.strip() for ln in f if ln.strip()]

    entries = read_lines("train.txt" if split == "train" else "test.txt")
    classes_file = os.path.join(root, "meta", "classes.txt")
    if os.path.exists(classes_file):
        classes = read_lines("classes.txt")
    else:
        both = entries + read_lines(
            "test.txt" if split == "train" else "train.txt")
        classes = sorted({e.split("/")[0] for e in both})
    index = {c: i for i, c in enumerate(classes)}
    items = [(os.path.join(root, "images", e + ".jpg"), index[e.split("/")[0]],
              e.split("/")[0]) for e in entries]
    return items, classes


def collect_cub200(root: str, split: str):
    """CUB-200-2011 layout: id-indexed ``images.txt`` /
    ``image_class_labels.txt`` (1-based labels) / ``train_test_split.txt``
    (1 = train), images under ``images/``."""
    def read_pairs(name):
        with open(os.path.join(root, name)) as f:
            return dict(ln.split(None, 1) for ln in
                        (l.strip() for l in f) if ln)

    paths = read_pairs("images.txt")
    labels = read_pairs("image_class_labels.txt")
    is_train = read_pairs("train_test_split.txt")
    classes = [c.strip().split(None, 1)[1]
               for c in open(os.path.join(root, "classes.txt"))
               if c.strip()]
    want = "1" if split == "train" else "0"
    items = []
    for img_id, rel in sorted(paths.items(), key=lambda kv: int(kv[0])):
        if is_train[img_id].strip() != want:
            continue
        label = int(labels[img_id]) - 1  # file is 1-based
        items.append((os.path.join(root, "images", rel.strip()), label,
                      classes[label]))
    return items, classes


def collect_imagenet_val(root: str, labels_file: str, *, base=None):
    """Flat ILSVRC validation layout: JPEGs in one directory + a labels file
    with one class index per line, aligned to the LEXICOGRAPHICALLY SORTED
    filenames (the devkit ground-truth convention).

    ``base``: 0 or 1 = the labels file's numbering base (the raw devkit file
    is 1-based). ``None`` assumes 0-based but REFUSES a file whose minimum
    label is >= 1: that is what an unconverted devkit file looks like, and on
    a subset missing the last class it would pass every downstream range
    check while silently shifting every label by one."""
    files = sorted(f for f in os.listdir(root)
                   if f.lower().endswith(IMAGE_EXTS))
    with open(labels_file) as f:
        labels = [int(ln) for ln in f if ln.strip()]
    if len(labels) != len(files):
        raise ValueError(
            f"{len(labels)} labels in {labels_file} but {len(files)} images "
            f"in {root}")
    if base is None:
        if labels and min(labels) >= 1:
            raise ValueError(
                f"no 0 label anywhere in {labels_file} (min={min(labels)}) — "
                "this looks like a 1-based devkit ground-truth file. Pass "
                "--val_labels_base=1 to convert it, or --val_labels_base=0 "
                "to assert the file really is 0-based")
        base = 0
    elif base not in (0, 1):
        raise ValueError(f"base must be 0 or 1, got {base}")
    if labels and min(labels) - base < 0:
        raise ValueError(
            f"label {min(labels)} in {labels_file} is negative under "
            f"base={base}")
    return [(os.path.join(root, fn), lab - base, str(lab - base))
            for fn, lab in zip(files, labels)]


def collect_stanford_cars(root: str, split: str):
    """Stanford Cars devkit layout: ``cars_train/`` + ``cars_test/`` image
    dirs, ``devkit/cars_meta.mat`` (196 class names), annotations in
    ``devkit/cars_train_annos.mat`` / ``cars_test_annos_withlabels.mat``
    (the with-labels test file ships separately and may sit at the archive
    root). All ``.mat`` class labels are 1-based."""
    import numpy as np
    from scipy.io import loadmat

    meta = loadmat(os.path.join(root, "devkit", "cars_meta.mat"),
                   squeeze_me=True)
    classes = [str(c) for c in meta["class_names"]]
    if split == "train":
        annos_path = os.path.join(root, "devkit", "cars_train_annos.mat")
        img_dir = os.path.join(root, "cars_train")
    else:
        img_dir = os.path.join(root, "cars_test")
        for annos_path in (
                os.path.join(root, "cars_test_annos_withlabels.mat"),
                os.path.join(root, "devkit",
                             "cars_test_annos_withlabels.mat")):
            if os.path.exists(annos_path):
                break
        else:
            raise FileNotFoundError(
                f"cars_test_annos_withlabels.mat not found at {root!r} or "
                "its devkit/ — the plain cars_test_annos.mat carries no "
                "labels and cannot build an eval split")
    annos = loadmat(annos_path, squeeze_me=True)["annotations"]
    items = []
    for a in np.atleast_1d(annos):
        label = int(a["class"]) - 1  # .mat labels are 1-based
        items.append((os.path.join(img_dir, str(a["fname"])), label,
                      classes[label]))
    return items, classes


def collect_oxford_flowers102(root: str, split: str):
    """Oxford Flowers-102 layout: ``jpg/image_XXXXX.jpg`` +
    ``imagelabels.mat`` (1-based labels for all 8,189 images, 1-indexed by
    image id) + ``setid.mat`` (``trnid``/``valid``/``tstid`` image-id
    lists). The published fine-tuning protocol trains on trn+val (2,040
    images) and evaluates on tst (6,149) — matching DatasetInfo. No class
    names are published; labels double as the text field."""
    import numpy as np
    from scipy.io import loadmat

    labels = np.atleast_1d(
        loadmat(os.path.join(root, "imagelabels.mat"),
                squeeze_me=True)["labels"])
    setid = loadmat(os.path.join(root, "setid.mat"), squeeze_me=True)
    if split == "train":
        ids = np.concatenate([np.atleast_1d(setid["trnid"]),
                              np.atleast_1d(setid["valid"])])
    else:
        ids = np.atleast_1d(setid["tstid"])
    classes = [f"class_{i:03d}" for i in range(1, 103)]
    items = []
    for i in ids:
        label = int(labels[int(i) - 1]) - 1  # both ids and labels 1-based
        items.append((os.path.join(root, "jpg", f"image_{int(i):05d}.jpg"),
                      label, classes[label]))
    return items, classes


def collect_fgvc_aircraft(root: str, split: str):
    """FGVC-Aircraft-2013b *variant* task layout: ``data/images/<id>.jpg``,
    ``data/variants.txt`` (100 class names, one per line),
    ``data/images_variant_trainval.txt`` / ``images_variant_test.txt``
    (``<image id> <variant>`` lines; variant names contain spaces). Accepts
    ``root`` as either the archive top (containing ``data/``) or the
    ``data/`` directory itself."""
    data = (root if os.path.isdir(os.path.join(root, "images"))
            else os.path.join(root, "data"))
    with open(os.path.join(data, "variants.txt")) as f:
        classes = [ln.strip() for ln in f if ln.strip()]
    index = {c: i for i, c in enumerate(classes)}
    name = ("images_variant_trainval.txt" if split == "train"
            else "images_variant_test.txt")
    items = []
    with open(os.path.join(data, name)) as f:
        for ln in f:
            ln = ln.strip()
            if not ln:
                continue
            img_id, variant = ln.split(None, 1)
            items.append((os.path.join(data, "images", img_id + ".jpg"),
                          index[variant], variant))
    return items, classes


def collect_oxford_iiit_pets(root: str, split: str):
    """Oxford-IIIT Pets layout: ``images/*.jpg`` +
    ``annotations/trainval.txt`` / ``test.txt`` with
    ``<image> <class-id> <species> <breed-id>`` lines (class ids 1-based,
    1..37). The breed name is the image-name prefix; the class id comes
    from the file itself, so indices cannot shift between splits."""
    name = "trainval.txt" if split == "train" else "test.txt"
    names: dict[int, str] = {}
    entries = []
    with open(os.path.join(root, "annotations", name)) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            img, cid = ln.split()[:2]
            cid = int(cid)
            names[cid] = img.rsplit("_", 1)[0]
            entries.append((img, cid))
    n = max(names)
    classes = [names.get(i, f"class_{i}") for i in range(1, n + 1)]
    items = [(os.path.join(root, "images", img + ".jpg"), cid - 1,
              classes[cid - 1]) for img, cid in entries]
    return items, classes


FGVC_LAYOUTS = {
    "food101": collect_food101,
    "cub200": collect_cub200,
    "stanford_cars": collect_stanford_cars,
    "oxford_flowers102": collect_oxford_flowers102,
    "fgvc_aircraft": collect_fgvc_aircraft,
    "oxford_iiit_pets": collect_oxford_iiit_pets,
}


def resolve_label_offset(dataset: str | None, explicit: int | None,
                         num_classes_found: int) -> int:
    """Offset from the registry (background class only for ImageNet-style
    heads); an explicit --label_offset overrides but is validated against the
    registry head size so out-of-range labels fail here, not inside training."""
    from axcnn_torch.data.datasets import get_dataset

    info = get_dataset(dataset) if dataset else None
    offset = explicit
    if offset is None:
        offset = info.label_offset if info else 0
    if info and num_classes_found + offset > info.num_classes:
        raise ValueError(
            f"{num_classes_found} classes + label_offset {offset} exceeds the "
            f"{info.num_classes}-way {info.name} head; labels would be "
            f"silently clipped inside the jitted loss")
    return offset


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--dataset", default=None,
                   help="registry name (axcnn_torch.data.datasets); derives the "
                        "label offset and validates the class count")
    p.add_argument("--split", default="train")
    p.add_argument("--prefix", default=None,
                   help="shard filename prefix (default: 'train'/'validation')")
    p.add_argument("--num_shards", type=int, default=128)
    p.add_argument("--label_offset", type=int, default=None,
                   help="override the registry-derived offset (default: "
                        "1 for ImageNet's 1001-way head, else 0)")
    p.add_argument("--layout", default="folders",
                   choices=("folders", *sorted(FGVC_LAYOUTS), "imagenet_val"),
                   help="on-disk source layout: 'folders' = "
                        "<input_dir>/<split>/<class>/*.jpg; 'food101' = the "
                        "published Food-101 archive (images/ + meta/*.txt); "
                        "'cub200' = CUB-200-2011 (images.txt etc.); "
                        "'stanford_cars' = devkit .mat annotations; "
                        "'oxford_flowers102' = imagelabels.mat + setid.mat; "
                        "'fgvc_aircraft' = images_variant_*.txt; "
                        "'oxford_iiit_pets' = annotations/*.txt; "
                        "'imagenet_val' = flat JPEG dir + --val_labels")
    p.add_argument("--val_labels", default="",
                   help="imagenet_val layout: ground-truth file, one class "
                        "index per line aligned to sorted filenames")
    p.add_argument("--val_labels_base", type=int, default=None,
                   choices=(0, 1),
                   help="numbering base of --val_labels (raw devkit files "
                        "are 1-based). Default: assume 0-based but refuse a "
                        "file with no 0 label anywhere")
    args = p.parse_args(argv)

    if (args.dataset is None and args.label_offset is None
            and args.layout in ("folders", "imagenet_val")):
        # round-1's CLI defaulted to offset 1; deriving it silently from
        # nothing would shift every ImageNet label by one with no error
        # anywhere downstream — make the choice explicit
        p.error("pass --dataset=<registry name> (derives the label offset) "
                "or an explicit --label_offset (ImageNet's 1001-way "
                "background-class head needs 1; exact-N-way heads need 0)")

    if args.layout == "folders":
        split_dir = os.path.join(args.input_dir, args.split)
        if not os.path.isdir(split_dir):
            p.error(f"--input_dir/--split: {split_dir!r} is not a directory "
                    "(expected layout: <input_dir>/<split>/<class_name>/*.jpg)")
        classes = sorted(d for d in os.listdir(split_dir)
                         if os.path.isdir(os.path.join(split_dir, d)))
        if not classes:
            p.error(f"no class subdirectories under {split_dir!r}")
        offset = resolve_label_offset(args.dataset, args.label_offset,
                                      len(classes))
        items, classes = collect_images(split_dir, label_offset=offset)
    else:
        if args.layout in FGVC_LAYOUTS:
            items, classes = FGVC_LAYOUTS[args.layout](args.input_dir,
                                                       args.split)
        else:  # imagenet_val
            if not args.val_labels:
                p.error("--layout=imagenet_val requires --val_labels")
            items = collect_imagenet_val(args.input_dir, args.val_labels,
                                         base=args.val_labels_base)
            classes = [str(i) for i in
                       range(1 + max((l for _, l, _ in items), default=-1))]
        offset = resolve_label_offset(args.dataset, args.label_offset,
                                      len(classes))
        if offset:
            items = [(path, label + offset, cls) for path, label, cls in items]
    # default shard prefix must be what the loader globs
    # (DatasetInfo.eval_prefix == 'validation'): the FGVC archives name their
    # eval split 'test', imagenet_val is an eval split by definition
    is_eval = (args.split.startswith("val") or args.layout == "imagenet_val"
               or (args.layout in FGVC_LAYOUTS and args.split != "train"))
    prefix = args.prefix or ("validation" if is_eval else args.split)
    n = write_shards(items, args.output_dir, prefix, args.num_shards,
                     shuffle_seed=0 if args.split == "train" else None)
    print(f"wrote {n} examples / {len(classes)} classes "
          f"(label_offset={offset}) to {args.output_dir}")


if __name__ == "__main__":
    main()
