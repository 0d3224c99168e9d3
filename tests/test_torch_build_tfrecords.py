"""The port's TFRecord builder (``axcnn_torch.data.build_tfrecords``)
against the reference's (``axcnn.data.build_tfrecords``), on the CPU.

Each source layout, generated small here, is built by both builders' CLIs
with the same flags: the shard files must be byte-identical (names and
bytes: the same records, label offsets, shuffle and shard split) and the
summary lines equal. Each refusal must be the same exception with the same
message. No tolerance: bytes are compared.
"""

import contextlib
import io
import os

import numpy as np
import pytest
from PIL import Image
from scipy.io import savemat

from axcnn.data import build_tfrecords as j_build
from axcnn_torch.data import build_tfrecords as t_build
import torch_inprocess

capped_threads = torch_inprocess.capped_threads


def _jpeg(path, seed):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)).save(path, "JPEG")


def _write(path, lines):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _folders(root):
    for c, cls in enumerate(("beagle", "cat", "zebra")):
        for i in range(3 + c):
            _jpeg(os.path.join(root, "train", cls, f"{cls}{i}.jpg"), 10 * c + i)
    _write(os.path.join(root, "train", "cat", "notes.txt"), ["not an image"])


def _food101(root, classes_file=True):
    classes = ["apple_pie", "bibimbap", "churros"]
    split = {"train": [], "test": []}
    for c, cls in enumerate(classes):
        for i in range(4):
            _jpeg(os.path.join(root, "images", cls, f"{100 + i}.jpg"), 10 * c + i)
            split["train" if i < 3 else "test"].append(f"{cls}/{100 + i}")
    for name, lines in split.items():
        _write(os.path.join(root, "meta", f"{name}.txt"), lines)
    if classes_file:
        _write(os.path.join(root, "meta", "classes.txt"), classes)


def _cub200(root):
    classes = ["001.Black_footed_Albatross", "002.Laysan_Albatross"]
    _write(os.path.join(root, "classes.txt"), [f"{i + 1} {c}" for i, c in enumerate(classes)])
    images, labels, split = [], [], []
    for k in range(1, 9):
        c = (k - 1) % 2
        rel = f"{classes[c]}/{classes[c].split('.')[1]}_{k:04d}.jpg"
        _jpeg(os.path.join(root, "images", rel), k)
        images.append(f"{k} {rel}")
        labels.append(f"{k} {c + 1}")
        split.append(f"{k} {int(k % 3 != 0)}")
    _write(os.path.join(root, "images.txt"), images)
    _write(os.path.join(root, "image_class_labels.txt"), labels)
    _write(os.path.join(root, "train_test_split.txt"), split)


def _annotations(items):
    annos = np.zeros(len(items), dtype=[("fname", "O"), ("class", "O")])
    for i, (fname, cls) in enumerate(items):
        annos[i] = (fname, np.uint8(cls))
    return {"annotations": annos}


def _stanford_cars(root, labelled_test=True):
    names = np.array(["AM General Hummer SUV 2000", "Acura RL Sedan 2012", "BMW M3 Coupe 2012"],
                     dtype=object)
    os.makedirs(os.path.join(root, "devkit"))
    savemat(os.path.join(root, "devkit", "cars_meta.mat"), {"class_names": names})
    for split, n in (("train", 6), ("test", 4)):
        items = [(f"{k + 1:05d}.jpg", k % 3 + 1) for k in range(n)]
        for k, (fname, _) in enumerate(items):
            _jpeg(os.path.join(root, f"cars_{split}", fname), 50 * len(split) + k)
        if split == "train":
            savemat(os.path.join(root, "devkit", "cars_train_annos.mat"), _annotations(items))
        elif labelled_test:
            savemat(os.path.join(root, "cars_test_annos_withlabels.mat"), _annotations(items))


def _oxford_flowers102(root):
    labels = np.array([3, 1, 102, 1, 3, 50, 2, 102, 7, 1], np.uint8)
    for i in range(len(labels)):
        _jpeg(os.path.join(root, "jpg", f"image_{i + 1:05d}.jpg"), i)
    savemat(os.path.join(root, "imagelabels.mat"), {"labels": labels[None, :]})
    savemat(os.path.join(root, "setid.mat"), {"trnid": np.array([[1, 4, 7]], np.uint16),
                                              "valid": np.array([[2, 5]], np.uint16),
                                              "tstid": np.array([[3, 6, 8, 9, 10]], np.uint16)})


def _fgvc_aircraft(root):
    data = os.path.join(root, "data")
    variants = ["707-320", "A300B4", "Cessna 172", "DHC-1"]
    _write(os.path.join(data, "variants.txt"), variants)
    for split, ids in (("trainval", range(1000, 1008)), ("test", range(2000, 2004))):
        lines = []
        for k, img in enumerate(ids):
            _jpeg(os.path.join(data, "images", f"{img:07d}.jpg"), img)
            lines.append(f"{img:07d} {variants[k % 4]}")
        _write(os.path.join(data, f"images_variant_{split}.txt"), lines)


def _oxford_iiit_pets(root):
    breeds = [("Abyssinian", 1, 1), ("american_bulldog", 2, 2), ("Bengal", 6, 1)]
    for split, n in (("trainval", 3), ("test", 1)):
        lines = ["#Image CLASS-ID SPECIES BREED ID"]
        for name, cid, species in breeds:
            for i in range(n):
                img = f"{name}_{100 + i + (10 if split == 'test' else 0)}"
                _jpeg(os.path.join(root, "images", img + ".jpg"), cid * 100 + i)
                lines.append(f"{img} {cid} {species} {i + 1}")
        _write(os.path.join(root, "annotations", f"{split}.txt"), lines)


def _imagenet_val(root, base=0):
    labels = [3, 0, 2, 2, 1, 0]
    for i in range(len(labels)):
        _jpeg(os.path.join(root, "val", f"ILSVRC2012_val_{i + 1:08d}.JPEG"), i)
    _write(os.path.join(root, "labels.txt"), [str(x + base) for x in labels])


def _build_both(tmp, argv):
    """Both builders' ``main(argv + --output_dir)``: their printed lines and
    shards must be equal, file for file and byte for byte."""
    got = {}
    for name, mod in (("reference", j_build), ("port", t_build)):
        out = tmp / f"out_{name}"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main([*argv, f"--output_dir={out}"])
        files = {f: (out / f).read_bytes() for f in sorted(os.listdir(out))}
        got[name] = (buf.getvalue().replace(str(out), "<out>"), files)
    assert got["port"][0] == got["reference"][0]
    assert got["port"][1].keys() == got["reference"][1].keys()
    for f, data in got["reference"][1].items():
        assert got["port"][1][f] == data, f
    return got["port"]


# (tree maker, flags), each split built with both builders
CASES = {
    "folders_imagenet": (_folders, ["--layout=folders", "--dataset=imagenet"]),
    "folders_offset0": (_folders, ["--layout=folders", "--label_offset=0"]),
    "food101": (_food101, ["--layout=food101", "--dataset=food101"]),
    "food101_no_classes_file": (lambda r: _food101(r, classes_file=False),
                                ["--layout=food101", "--dataset=food101"]),
    "cub200": (_cub200, ["--layout=cub200", "--dataset=cub200"]),
    "stanford_cars": (_stanford_cars, ["--layout=stanford_cars", "--dataset=stanford_cars"]),
    "oxford_flowers102": (_oxford_flowers102,
                          ["--layout=oxford_flowers102", "--dataset=oxford_flowers102"]),
    "fgvc_aircraft": (_fgvc_aircraft, ["--layout=fgvc_aircraft", "--dataset=fgvc_aircraft"]),
    "oxford_iiit_pets": (_oxford_iiit_pets,
                         ["--layout=oxford_iiit_pets", "--dataset=oxford_iiit_pets"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_shards_are_byte_identical(case, tmp_path):
    make, flags = CASES[case]
    root = tmp_path / "src"
    make(str(root))
    splits = ["train"] if case.startswith("folders") else ["train", "test"]
    for split in splits:
        line, files = _build_both(tmp_path / split, [*flags, f"--input_dir={root}",
                                                     f"--split={split}", "--num_shards=3"])
        prefix = "train" if split == "train" else "validation"
        assert sorted(files) == [f"{prefix}-{s:05d}-of-00003" for s in range(3)]
        assert sum(len(b) for b in files.values()) > 0 and line.startswith("wrote ")


@pytest.mark.parametrize("base", [0, 1])
def test_imagenet_val_shards_are_byte_identical(tmp_path, base):
    _imagenet_val(str(tmp_path / "src"), base=base)
    line, files = _build_both(tmp_path, [
        "--layout=imagenet_val", "--dataset=imagenet", f"--input_dir={tmp_path / 'src' / 'val'}",
        f"--val_labels={tmp_path / 'src' / 'labels.txt'}", f"--val_labels_base={base}",
        "--num_shards=2"])
    assert sorted(files) == ["validation-00000-of-00002", "validation-00001-of-00002"]
    assert "label_offset=1" in line


def _refusal(argv, exc):
    """Both builders refuse ``argv`` with the same ``exc`` and message
    (``SystemExit``: the same usage error on stderr)."""
    messages = []
    for mod in (j_build, t_build):
        err = io.StringIO()
        with pytest.raises(exc) as e, contextlib.redirect_stderr(err):
            mod.main(argv)
        messages.append((str(e.value), err.getvalue().splitlines()[-1:]))
    assert messages[0] == messages[1]
    return messages[0]


def test_refusals_match_reference(tmp_path):
    root, out = tmp_path / "src", f"--output_dir={tmp_path / 'out'}"
    _folders(str(root))
    msg = _refusal(["--layout=folders", f"--input_dir={root}", out], SystemExit)
    assert "--dataset=<registry name>" in msg[1][0]
    msg = _refusal(["--layout=folders", "--dataset=imagenet", "--split=val",
                    f"--input_dir={root}", out], SystemExit)
    assert "is not a directory" in msg[1][0]
    _refusal(["--layout=folders", "--dataset=oxford_iiit_pets", "--label_offset=36",
              f"--input_dir={root}", out], ValueError)
    _refusal(["--layout=imagenet_val", "--dataset=imagenet", f"--input_dir={root}", out],
             SystemExit)
    _imagenet_val(str(tmp_path / "val1"), base=1)
    msg = _refusal(["--layout=imagenet_val", "--dataset=imagenet",
                    f"--input_dir={tmp_path / 'val1' / 'val'}",
                    f"--val_labels={tmp_path / 'val1' / 'labels.txt'}", out], ValueError)
    assert "1-based devkit" in msg[0]
    _stanford_cars(str(tmp_path / "cars"), labelled_test=False)
    msg = _refusal(["--layout=stanford_cars", "--dataset=stanford_cars", "--split=test",
                    f"--input_dir={tmp_path / 'cars'}", out], FileNotFoundError)
    assert "cars_test_annos_withlabels.mat not found" in msg[0]
    assert not (tmp_path / "out").exists()
