"""ImageNet-C in the port (axcnn_torch.data.corruptions, .build_imagenet_c,
axcnn_torch.eval.imagenet_c) against the JAX reference's, on the CPU.

- Every corruption at severities 1 and 5: bit-equal to
  ``axcnn.data.corruptions.corrupt`` for the same generator.
- ``build_corrupted_set``: the same shard files, byte for byte, from the same clean
  shards and seed, in the layout ``<corruption>/<severity>/<prefix>-*``.
- ``compute_mce`` and the constants: equal to the reference's.
- ``run_imagenet_c`` through the port's CLI on the reference's initial
  weights (carried over by ``ckpt.convert``): each set's top-1 and the mCE
  equal to the reference's ``run_imagenet_c`` on the same shards, in fp32.
  Half the records are labelled with the port's own prediction on the clean
  image and half with another class, so that top-1 is neither 0 nor 100.
"""

import contextlib
import dataclasses
import filecmp
import io
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from axcnn.data import corruptions as j_corr
from axcnn.data.build_imagenet_c import build_corrupted_set as j_build
from axcnn.eval import imagenet_c as j_inc
from axcnn.models.resnet import ModelConfig as JModelConfig
from axcnn.train.train_step import create_train_state as j_create_state
from axcnn.utils import config as j_config
from axcnn_torch.ckpt.checkpoint import CheckpointManager
from axcnn_torch.ckpt.convert import train_state_from_axcnn
from axcnn_torch.data import corruptions as t_corr
from axcnn_torch.data.build_imagenet_c import build_corrupted_set as t_build
from axcnn_torch.data.tfrecord import TFRecordWriter, make_example
from axcnn_torch.eval import imagenet_c as t_inc
from axcnn_torch.models.resnet import ModelConfig
import torch_inprocess

capped_threads = torch_inprocess.capped_threads

MODEL = dict(resnet_size=50, width_multiplier=0.125, num_classes=1001, use_resnet_d=True,
             use_se_block=True, use_sk_block=True, anti_alias_type="sconv")
SIZE = 32


def _img(seed=0, size=96):
    """Structured content (gradients and stripes) plus noise, as
    tests/test_corruptions.py makes it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    base = np.stack([yy * 255 // size, xx * 255 // size, ((yy // 8) % 2) * 200], axis=-1)
    return (base + rng.integers(0, 40, base.shape)).clip(0, 255).astype(np.uint8)


def test_constants_match_reference():
    assert t_inc.CORRUPTIONS == j_inc.CORRUPTIONS
    assert t_inc.ALEXNET_ERR == j_inc.ALEXNET_ERR
    assert list(t_corr.CORRUPTION_FNS) == list(j_corr.CORRUPTION_FNS)


@pytest.mark.parametrize("errs", ["alexnet", "random", "subset"])
def test_compute_mce_matches_reference(errs):
    rng = np.random.default_rng(1)
    per = {"alexnet": dict(j_inc.ALEXNET_ERR),
           "random": {c: float(rng.uniform(0.2, 0.9)) for c in j_inc.CORRUPTIONS},
           "subset": {"fog": 0.5, "snow": 0.25}}[errs]
    assert t_inc.compute_mce(per) == j_inc.compute_mce(per)
    assert t_inc.compute_mce({}) == j_inc.compute_mce({}) == {"mce": 0.0}


@pytest.mark.parametrize("severity", [1, 5])
@pytest.mark.parametrize("name", list(j_corr.CORRUPTION_FNS))
def test_corruption_bit_equal_to_reference(name, severity):
    img = _img(severity)
    got = t_corr.corrupt(img, name, severity, np.random.default_rng(7))
    want = j_corr.corrupt(img, name, severity, np.random.default_rng(7))
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, want)


def _clean_shards(directory, labels, shards=2):
    """Clean validation shards of 40x50 JPEGs with the given labels."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(3)
    per = -(-len(labels) // shards)
    for s in range(shards):
        with TFRecordWriter(os.path.join(directory,
                                         f"validation-{s:05d}-of-{shards:05d}")) as w:
            for label in labels[s * per:(s + 1) * per]:
                buf = io.BytesIO()
                Image.fromarray(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)).save(buf, "JPEG")
                w.write(make_example({"image/encoded": [buf.getvalue()],
                                      "image/class/label": [int(label)],
                                      "image/filename": [f"img{s}".encode()]}))


def test_build_corrupted_set_writes_the_reference_files(tmp_path):
    clean = str(tmp_path / "clean")
    _clean_shards(clean, [1, 2, 3, 4, 5])
    kw = dict(image_size=SIZE, resize_min=36, severities=(1, 3), seed=4,
              progress=lambda _: None)
    n_t = t_build(clean, str(tmp_path / "t"), **kw)
    n_j = j_build(clean, str(tmp_path / "j"), **kw)
    assert n_t == n_j == 5 * 15 * 2
    for name in t_inc.CORRUPTIONS:
        for sev in (1, 3):
            d = os.path.join(name, str(sev))
            files = sorted(os.listdir(tmp_path / "t" / d))
            assert files == ["validation-00000-of-00002", "validation-00001-of-00002"]
            assert files == sorted(os.listdir(tmp_path / "j" / d))
            _, bad, errors = filecmp.cmpfiles(tmp_path / "t" / d, tmp_path / "j" / d, files,
                                              shallow=False)
            assert not bad and not errors, (d, bad, errors)


def test_build_corrupted_set_subset_regenerates_the_same_pixels(tmp_path):
    """A subset build writes what the full build wrote for those sets."""
    clean = str(tmp_path / "clean")
    _clean_shards(clean, [0, 1, 2])
    kw = dict(image_size=SIZE, resize_min=36, severities=(2,), progress=lambda _: None)
    t_build(clean, str(tmp_path / "all"), **kw)
    t_build(clean, str(tmp_path / "fog"), corruptions=["fog"], **kw)
    d = os.path.join("fog", "2")
    assert os.listdir(tmp_path / "fog") == ["fog"]
    _, bad, errors = filecmp.cmpfiles(tmp_path / "all" / d, tmp_path / "fog" / d,
                                      os.listdir(tmp_path / "all" / d), shallow=False)
    assert not bad and not errors
    with pytest.raises(ValueError, match="unknown corruption"):
        t_build(clean, str(tmp_path / "x"), corruptions=["rain"], **kw)


@pytest.fixture(scope="module")
def mce_runs(tmp_path_factory):
    """The reference's and the port's mCE evaluation of the reference's
    initial weights on the same corrupted shards (2 corruptions x 2
    severities, 6 images each), fp32."""
    from axcnn_torch.cli import main_classification
    from axcnn_torch.data.preprocessing import normalize_device, preprocess_eval
    from axcnn_torch.data.tfrecord import TFRecordReader, list_shards, parse_example

    root = tmp_path_factory.mktemp("mce")
    seed = 5
    jstate = j_create_state(jax.random.key(seed), JModelConfig(**MODEL), use_ema=False)
    tstate = train_state_from_axcnn(jstate, ModelConfig(**MODEL))
    # labels: the port's own predictions on the clean pixels, the second half
    # moved to another class
    clean = str(root / "clean")
    _clean_shards(clean, [0] * 6)
    u8 = np.stack([preprocess_eval(bytes(parse_example(p)["image/encoded"][0]),
                                   image_size=SIZE, resize_min=36)
                   for s in list_shards(clean, "validation") for p in TFRecordReader(s)])
    with torch.inference_mode():
        preds = tstate.model(normalize_device(torch.from_numpy(u8))).argmax(-1).numpy()
    preds[3:] = (preds[3:] + 1) % MODEL["num_classes"]
    _clean_shards(clean, preds.tolist())
    data = str(root / "c")
    t_build(clean, data, image_size=SIZE, resize_min=36, corruptions=["gaussian_noise", "fog"],
            severities=(1, 2), progress=lambda _: None)

    port_dir = root / "port"
    mgr = CheckpointManager(str(port_dir / "checkpoints"),
                            model_config=dataclasses.asdict(ModelConfig(**MODEL)))
    mgr.save(tstate)
    mgr.close()
    flags = [f"--data.data_dir={data}", f"--data.image_size={SIZE}", "--train.batch_size=4",
             "--train.dtype=fp32", "--train.use_ema=false", "--data.num_workers=1",
             f"--train.seed={seed}"] + [f"--model.{k}={v}" for k, v in MODEL.items()]
    with contextlib.redirect_stderr(io.StringIO()):
        got = main_classification.main([*flags, "--runtime.eval_imagenet_c",
                                        "--runtime.platform=cpu",
                                        f"--runtime.model_dir={port_dir}"])
    jcfg = j_config.parse_cli([*flags, "--runtime.eval_imagenet_c", "--runtime.num_devices=1",
                               f"--runtime.model_dir={root / 'ref'}"])
    want = j_inc.run_imagenet_c(jcfg)

    def lines(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    # the same evaluation on two Gloo ranks, each reading one of the two shards
    ranks_dir = root / "ranks"
    shutil.copytree(port_dir / "checkpoints", ranks_dir / "checkpoints")
    with contextlib.redirect_stderr(io.StringIO()):
        got_ranks = main_classification.main([*flags, "--runtime.eval_imagenet_c",
                                              "--runtime.platform=cpu", "--runtime.num_devices=2",
                                              f"--runtime.model_dir={ranks_dir}"])
    return dict(got=got, want=want, got_lines=lines(port_dir), want_lines=lines(root / "ref"),
                got_ranks=got_ranks, ranks_lines=lines(ranks_dir))


def test_run_imagenet_c_matches_reference(mce_runs):
    def sets(lines):
        return {(r["corruption"], r["severity"]): (r["top1"], r["count"])
                for r in lines if r["tag"] == "imagenet_c"}

    got, want = sets(mce_runs["got_lines"]), sets(mce_runs["want_lines"])
    assert len(got) == 4 and got == want
    assert 0 < np.mean([t for t, _ in got.values()]) < 100  # labels the model sometimes hits
    assert set(mce_runs["got"]) == set(mce_runs["want"]) == {"mce", "ce/gaussian_noise",
                                                            "ce/fog"}
    for k, v in mce_runs["want"].items():
        assert mce_runs["got"][k] == pytest.approx(v, rel=1e-12)


def test_two_ranks_evaluate_as_one(mce_runs):
    """Two ranks (the CLI's data-parallel eval over Gloo), each on its shard:
    the same sets, counts and mCE as one process."""
    def sets(lines):
        return {(r["corruption"], r["severity"]): (r["top1"], r["count"])
                for r in lines if r["tag"] == "imagenet_c"}

    assert sets(mce_runs["ranks_lines"]) == sets(mce_runs["got_lines"])
    assert mce_runs["got_ranks"] == pytest.approx(mce_runs["got"], rel=1e-12)


def test_mce_line_is_compute_mce_of_the_set_lines(mce_runs):
    lines = mce_runs["got_lines"]
    errs = {}
    for r in lines:
        if r["tag"] == "imagenet_c":
            errs.setdefault(r["corruption"], []).append(1.0 - r["top1"] / 100.0)
    want = t_inc.compute_mce({c: sum(e) / len(e) for c, e in errs.items()})
    (mce_line,) = [r for r in lines if r["tag"] == "mce"]
    assert {k: mce_line[k] for k in want} == pytest.approx(want, rel=1e-12)


def test_spatial_partitioning_is_refused(tmp_path):
    from axcnn_torch.utils.config import parse_cli

    cfg = parse_cli(["--runtime.eval_imagenet_c", "--runtime.platform=cpu",
                     "--runtime.spatial_partitions=2", f"--runtime.model_dir={tmp_path}"])
    with pytest.raises(ValueError, match="spatial partitioning"):
        t_inc.run_imagenet_c(cfg)
