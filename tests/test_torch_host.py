"""The port's own host side against ``axcnn``'s, on the CPU.

``axcnn_torch`` keeps its own copies of the host modules it uses (datasets,
preprocessing, TFRecords, AutoAugment, the C++ loader's bindings, the
loaders, metric logging, the watchdog), so it runs where ``axcnn`` is not
installed. Each copy must give what its original gives on the same seeded
inputs. An import guard then runs the port's CLIs, its TF1-checkpoint
import and its TFRecord builder in a process that refuses every import of
``axcnn``, ``jax`` and ``tensorflow``, and an AST scan finds no import of
``axcnn`` or ``jax`` in any file of the port or in ``chip_smoke.py``, and
none of ``tensorflow`` outside the opt-in TensorBoard writer of
``utils/logging.py``.
"""

import ast
import dataclasses
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from axcnn.data import autoaugment as j_aa
from axcnn.data import cpp_loader as j_cpp
from axcnn.data import datasets as j_datasets
from axcnn.data import pipeline as j_pipeline
from axcnn.data import preprocessing as j_pre
from axcnn.data import tfrecord as j_tfrecord
from axcnn.utils import logging as j_logging
from axcnn.utils import watchdog as j_watchdog
from axcnn_torch.data import autoaugment as t_aa
from axcnn_torch.data import cpp_loader as t_cpp
from axcnn_torch.data import datasets as t_datasets
from axcnn_torch.data import pipeline as t_pipeline
from axcnn_torch.data import preprocessing as t_pre
from axcnn_torch.data import tfrecord as t_tfrecord
from axcnn_torch.utils import logging as t_logging
from axcnn_torch.utils import watchdog as t_watchdog

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(str(p.relative_to(REPO)) for p in (REPO / "axcnn_torch").rglob("*.py")
                    if "build" not in p.relative_to(REPO).parts) + ["chip_smoke.py"]


def _jpeg(seed, h=72, w=90):
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, "JPEG")
    return buf.getvalue()


# -- preprocessing, datasets, AutoAugment ------------------------------------

def test_constants_match_reference():
    for name in ("IMAGE_SIZE", "RESIZE_MIN", "MEAN_RGB", "STDDEV_RGB"):
        np.testing.assert_array_equal(getattr(t_pre, name), getattr(j_pre, name))


@pytest.mark.parametrize("size,resize_min", [(224, 256), (64, 72), (72, 72)])
def test_preprocess_eval_matches_reference(size, resize_min):
    data = _jpeg(size, 72, 72) if size == resize_min else _jpeg(size)
    got = t_pre.preprocess_eval(data, image_size=size, resize_min=resize_min)
    want = j_pre.preprocess_eval(data, image_size=size, resize_min=resize_min)
    assert got.dtype == np.uint8 and got.shape == (size, size, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("policy", ["none", "v0"])
def test_preprocess_train_matches_reference(seed, policy):
    data = _jpeg(10 + seed)
    got = t_pre.preprocess_train(data, np.random.default_rng(seed), image_size=64,
                                 autoaugment_fn=t_aa.make_autoaugment(policy))
    want = j_pre.preprocess_train(data, np.random.default_rng(seed), image_size=64,
                                  autoaugment_fn=j_aa.make_autoaugment(policy))
    np.testing.assert_array_equal(got, want)


def test_decode_and_crop_match_reference():
    data = _jpeg(5)
    np.testing.assert_array_equal(t_pre.decode_jpeg(data), j_pre.decode_jpeg(data))
    for seed in range(4):
        assert (t_pre.distorted_bbox_crop(np.random.default_rng(seed), 90, 72)
                == j_pre.distorted_bbox_crop(np.random.default_rng(seed), 90, 72))


@pytest.mark.parametrize("name", sorted(j_datasets.DATASETS))
def test_dataset_info_matches_reference(name):
    assert (dataclasses.asdict(t_datasets.get_dataset(name))
            == dataclasses.asdict(j_datasets.get_dataset(name)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("policy", ["v0", "imagenet"])
def test_autoaugment_matches_reference(policy, seed):
    img = Image.fromarray(np.random.default_rng(seed).integers(
        0, 256, (48, 40, 3), dtype=np.uint8))
    got = t_aa.make_autoaugment(policy)(img, np.random.default_rng(seed))
    want = j_aa.make_autoaugment(policy)(img, np.random.default_rng(seed))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert t_aa.make_autoaugment("none") is None


def test_cpp_loader_bindings_match_reference():
    """The same tables and the same ``cpp/`` directory (``cpp/build.sh``)."""
    assert t_cpp.AA_POLICIES == j_cpp.AA_POLICIES and t_cpp.AA_OPS == j_cpp.AA_OPS
    assert t_cpp._ABI_VERSION == j_cpp._ABI_VERSION
    assert t_cpp._CPP_DIR == j_cpp._CPP_DIR == str(REPO / "cpp")
    assert t_cpp._SO_PATH == j_cpp._SO_PATH


# -- TFRecords and loaders ---------------------------------------------------

def test_tfrecord_codec_matches_reference(tmp_path):
    feats = {"image/encoded": [_jpeg(0)], "image/class/label": [3],
             "image/class/text": [b"cat"], "image/filename": [b"a.jpg"]}
    assert t_tfrecord.make_example(feats) == j_tfrecord.make_example(feats)
    path = str(tmp_path / "train-00000-of-00001")
    with t_tfrecord.TFRecordWriter(path) as w:
        w.write(t_tfrecord.make_example(feats))
    got = [t_tfrecord.parse_example(p) for p in t_tfrecord.TFRecordReader(path)]
    want = [j_tfrecord.parse_example(p) for p in j_tfrecord.TFRecordReader(path)]
    assert got == want and len(got) == 1
    assert t_tfrecord.count_records(path) == j_tfrecord.count_records(path) == 1
    assert t_tfrecord.crc32c(b"axcnn") == j_tfrecord.crc32c(b"axcnn")


def test_loader_state_matches_reference():
    s = t_pipeline.LoaderState(3, 11)
    assert t_pipeline.LoaderState._fields == j_pipeline.LoaderState._fields
    assert (s.epoch, s.batches_yielded) == (3, 11) and s == j_pipeline.LoaderState(3, 11)


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_loader_matches_reference(seed):
    kw = dict(batch_size=4, image_size=32, num_classes=10, seed=seed, num_batches=2)
    got, want = list(t_pipeline.SyntheticLoader(**kw)), list(j_pipeline.SyntheticLoader(**kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    from axcnn_torch.data.build_tfrecords import write_shards

    tmp = tmp_path_factory.mktemp("host_data")
    rng = np.random.default_rng(0)
    items = {"train": [], "validation": []}
    for label, name in enumerate(("a", "b")):
        for i in range(10):
            p = str(tmp / f"{name}{i}.jpg")
            Image.fromarray(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)).save(p)
            items["train" if i < 8 else "validation"].append((p, label, name))
    write_shards(items["train"], str(tmp / "rec"), "train", 2)
    write_shards(items["validation"], str(tmp / "rec"), "validation", 1)
    return str(tmp / "rec")


def _batches(loader, n):
    out = []
    for batch in loader:
        out.append((batch, loader.state))
        if len(out) == n:
            break
    if hasattr(loader, "close"):
        loader.close()
    return out


@pytest.mark.parametrize("case", ["train", "eval", "multi_producer", "resume"])
def test_tfrecord_loaders_match_reference(shards, case):
    """Train (v0 AutoAugment), eval, two producers, and a loader resumed
    from a position: the same batches and positions from both packages."""
    kw = dict(batch_size=4, image_size=32, resize_min=36, num_workers=2, seed=3)
    train = case != "eval"
    if train:
        kw["autoaugment_type"] = "v0"

    def make(pkg, dmod):
        info = dmod.DatasetInfo("tiny", 2, 16, 4)
        if case == "multi_producer":
            return pkg.MultiProducerLoader(shards, info, num_producers=2, train=True, **kw)
        loader = pkg.TFRecordImageLoader(shards, info, train=train, **kw)
        if case == "resume":
            loader.state = pkg.LoaderState(1, 2)
        return loader

    n = 5 if train else 1
    got = _batches(make(t_pipeline, t_datasets), n)
    want = _batches(make(j_pipeline, j_datasets), n)
    assert len(got) == len(want) == n
    for (g, gs), (w, ws) in zip(got, want):
        assert tuple(gs) == tuple(ws)
        np.testing.assert_array_equal(g["images"], w["images"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
        assert g["images"].shape == (4, 32, 32, 3) and g["images"].dtype == np.uint8


def test_echo_iterator_matches_reference():
    got = list(t_pipeline.EchoIterator(iter(range(3)), 2))
    assert got == list(j_pipeline.EchoIterator(iter(range(3)), 2)) == [0, 0, 1, 1, 2, 2]


# -- logging and the watchdog ------------------------------------------------

def test_metric_logger_line_matches_reference(tmp_path, capsys):
    lines = []
    for mod, name in ((t_logging, "port"), (j_logging, "ref")):
        log = mod.MetricLogger(str(tmp_path / name))
        log.log("train", 7, loss=np.float32(1.25), lr=0.1, note="x")
        log.close()
        lines.append(json.loads((tmp_path / name / "metrics.jsonl").read_text()))
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 and err[0] == err[1] == "[train] step=7 loss=1.25 lr=0.1 note=x"
    for line in lines:
        assert abs(line.pop("time") - time.time()) < 60
    assert lines[0] == lines[1] == {"tag": "train", "step": 7, "loss": 1.25, "lr": 0.1,
                                    "note": "x"}


def test_throughput_matches_reference():
    ticks = [mod.Throughput(8, window=2) for mod in (t_logging, j_logging)]
    assert [t.tick() for t in ticks] == [None, None]
    time.sleep(0.01)
    assert all(r > 0 for r in (t.tick() for t in ticks))


@pytest.mark.parametrize("mod", [t_watchdog, j_watchdog], ids=["port", "reference"])
def test_hang_watchdog_fires(mod):
    """Beats hold it off; a stall past the deadline fires ``on_hang`` once."""
    stalls = []
    dog = mod.HangWatchdog(0.2, on_hang=stalls.append, poll_s=0.02).start()
    for _ in range(8):
        time.sleep(0.05)
        dog.beat()
    assert not dog.fired and not stalls
    deadline = time.monotonic() + 5
    while not dog.fired and time.monotonic() < deadline:
        time.sleep(0.02)
    dog.stop()
    assert dog.fired and len(stalls) == 1 and stalls[0] > 0.2
    assert mod.HANG_EXIT_CODE == 42


# -- the port runs without axcnn, jax and tensorflow ---------------------------

_GUARD = """
import importlib.abc, importlib.machinery, sys

class _Refuse(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top == "axcnn" or top.startswith("jax"):
            raise ModuleNotFoundError(f"refused: {name}")
        if top == "tensorflow":
            # a spec with no origin, whose loading raises: torch._dynamo
            # probes tensorflow with find_spec and skips such a spec
            return importlib.machinery.ModuleSpec(name, self)
        return None

    def create_module(self, spec):
        raise ModuleNotFoundError(f"refused: {spec.name}")

    def exec_module(self, module):
        pass

sys.meta_path.insert(0, _Refuse())
"""

_CHECK = """
bad = [m for m in sys.modules
       if m.split(".")[0] in ("axcnn", "tensorflow") or m.startswith("jax")]
assert not bad, bad
print("ok")
"""

_CASES = {
    "import_all": """
import importlib, pkgutil
import axcnn_torch
mods = [m.name for m in pkgutil.walk_packages(axcnn_torch.__path__, "axcnn_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
assert len(mods) >= 38, mods
""",
    "predict": """
import contextlib, io, json, os, tempfile
import numpy as np
from PIL import Image
from axcnn_torch.cli import predict
tmp = tempfile.mkdtemp()
img = os.path.join(tmp, "x.jpg")
Image.fromarray(np.random.default_rng(0).integers(0, 256, (70, 80, 3), dtype=np.uint8)).save(img)
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = predict.main([f"--image={img}", "--config=assemble_resnet50", "--cpu",
                       "--model.width_multiplier=0.125", "--data.image_size=64",
                       f"--runtime.model_dir={tmp}/run"])
assert rc == 0, rc
line = json.loads(out.getvalue())
assert line["image"] == img and len(line["top5"]) == 5, line
""",
    "train": """
import json, os, tempfile
from axcnn_torch.cli import main_classification
tmp = tempfile.mkdtemp()
main_classification.main([
    "--config=assemble_resnet50", "--data.use_synthetic_data", "--train.train_steps=2",
    "--train.batch_size=4", "--train.log_every=1", "--data.image_size=64",
    "--model.width_multiplier=0.125", "--runtime.platform=cpu",
    "--runtime.save_checkpoint_steps=2", f"--runtime.model_dir={tmp}"])
recs = [json.loads(l) for l in open(os.path.join(tmp, "metrics.jsonl"))]
assert [r["step"] for r in recs if r["tag"] == "train"] == [1, 2], recs
assert os.path.exists(os.path.join(tmp, "checkpoints", "2.pt"))
""",
    "tf_import_and_build": """
import os, tempfile
import numpy as np, torch
from PIL import Image
import chip_smoke
from axcnn_torch.ckpt.tf_import import import_tf_checkpoint
from axcnn_torch.data import build_tfrecords
from axcnn_torch.data.tfrecord import count_records, list_shards
from axcnn_torch.models.resnet import ModelConfig, ResNet
tmp = tempfile.mkdtemp()
cfg = ModelConfig(use_resnet_d=True, use_se_block=True, use_sk_block=True,
                  anti_alias_type="sconv", width_multiplier=0.125, num_classes=10)
chip_smoke._write_tf_bundle(os.path.join(tmp, "model.ckpt-1"), chip_smoke._tf_values(cfg, 0))
open(os.path.join(tmp, "checkpoint"), "w").write('model_checkpoint_path: "model.ckpt-1"')
model = ResNet(cfg)
state_dict, missing = import_tf_checkpoint(tmp, cfg, model.state_dict(), use_ema=True)
assert not missing
model.load_state_dict(state_dict)
with torch.inference_mode():
    assert torch.isfinite(model.eval()(torch.zeros(1, 32, 32, 3))).all()
for c in ("a", "b"):
    os.makedirs(os.path.join(tmp, "src", "train", c))
    for i in range(3):
        Image.fromarray(np.full((8, 8, 3), i, np.uint8)).save(
            os.path.join(tmp, "src", "train", c, f"{i}.jpg"))
build_tfrecords.main([f"--input_dir={tmp}/src", f"--output_dir={tmp}/rec", "--num_shards=2",
                      "--dataset=food101"])
assert sum(count_records(p) for p in list_shards(f"{tmp}/rec", "train")) == 6
""",
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_port_runs_with_axcnn_and_jax_refused(case):
    """A process whose import system refuses ``axcnn``, ``axcnn.*``,
    ``jax*`` and ``tensorflow`` imports every module of the port and
    ``chip_smoke``, serves a JPEG through ``predict``, trains 2 steps
    through the training CLI (on the CPU at width 0.125, 64x64), imports a
    TF1 bundle (``chip_smoke._write_tf_bundle``'s, width 0.125) and builds
    TFRecord shards."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", _GUARD + _CASES[case] + _CHECK],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_no_axcnn_or_jax(path):
    """Nor ``tensorflow``, but in the TensorBoard writer that
    ``utils/logging.py`` imports only when asked to."""
    banned = {"axcnn", "jax", "jaxlib"}
    if path != "axcnn_torch/utils/logging.py":
        banned.add("tensorflow")
    tree = ast.parse((REPO / path).read_text(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [f"{path}:{node.lineno} {n}" for n in names
                if n.split(".")[0] in banned]
    assert not bad, bad
