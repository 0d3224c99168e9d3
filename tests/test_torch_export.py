"""The port's serving export (axcnn_torch.ckpt.export) against the JAX
reference's (axcnn.ckpt.export), on the CPU.

The exports here are traced on the CPU and served there; on the card the
same program holds the card's routes (chip_smoke.py ``export``).

- Round trip: the reloaded program's logits equal the direct forward's bit
  for bit (the same ATen calls on the same weights), and the reference's
  forward on the same weights within atol = rtol = 1e-4, the bound of the
  reference's own round-trip test (tests/test_export.py).
- int8: the reloaded program equals the direct int8 forward bit for bit, and
  the reference's int8 forward within relative L2 0.05 with the same argmax,
  tests/test_export.py's bound for the reference's int8 round trip.
- The files and config.json (the reference's keys, plus the device the
  program was traced on), the device refusals, ``predict --export`` (padded
  to the export's batch) and the training loop's export at the end of a run
  and after an ``eval_only`` eval.
"""

import contextlib
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from axcnn.core.dtypes import DEFAULT_POLICY as J_FP32
from axcnn.core.dtypes import INT8_SERVING_POLICY as J_INT8
from axcnn.data.preprocessing import normalize_device as j_normalize
from axcnn.models.resnet import ModelConfig as JModelConfig
from axcnn.models.resnet import resnet_apply
from axcnn_torch.ckpt.convert import from_axcnn
from axcnn_torch.ckpt.export import export_serving, load_serving
from axcnn_torch.cli import predict
from axcnn_torch.core.dtypes import DEFAULT_POLICY, INT8_SERVING_POLICY
from axcnn_torch.data.preprocessing import normalize_device
from axcnn_torch.kernels import blurpool as kblur
from axcnn_torch.models.resnet import ModelConfig, ResNet
from test_torch_model import _random_tree
import torch_inprocess

capped_threads = torch_inprocess.capped_threads

KW = dict(width_multiplier=0.25, num_classes=12, use_resnet_d=True, use_se_block=True,
          use_sk_block=True, anti_alias_type="sconv")
BATCH, SIZE = 2, 64
REFERENCE_KEYS = {"model_config", "batch_size", "image_size", "compute_dtype",
                  "quantized_int8"}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Reference weights carried into the port, exported in fp32 and int8."""
    params, state = _random_tree(KW, seed=11)
    cfg = ModelConfig(**KW)
    model = ResNet(cfg)
    model.load_state_dict(from_axcnn(params, state, cfg), strict=True)
    model = model.to(memory_format=torch.channels_last).eval()
    root = tmp_path_factory.mktemp("exports")
    dirs = {}
    for name, policy in (("fp32", DEFAULT_POLICY), ("int8", INT8_SERVING_POLICY)):
        dirs[name] = export_serving(str(root / name), cfg, model, batch_size=BATCH,
                                    image_size=SIZE, policy=policy)
    images = np.random.default_rng(12).integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    loaded = {name: load_serving(d, "cpu") for name, d in dirs.items()}
    return dict(params=params, state=state, model=model, dirs=dirs, images=images,
                loaded=loaded)


def _reference(exported, policy):
    out = resnet_apply(exported["params"], exported["state"], j_normalize(exported["images"]),
                       cfg=JModelConfig(**KW), train=False, policy=policy)[0]
    return np.asarray(out.astype(jnp.float32))


def _direct(exported, policy):
    with torch.inference_mode():
        return exported["model"](normalize_device(torch.from_numpy(exported["images"])),
                                 policy=policy)


def test_round_trip_matches_direct_and_reference(exported):
    fn, meta = exported["loaded"]["fp32"]
    assert meta["model_config"]["num_classes"] == 12
    got = fn(exported["images"])
    assert got.dtype == torch.float32 and got.shape == (BATCH, 12)
    assert torch.equal(got, _direct(exported, DEFAULT_POLICY))
    np.testing.assert_allclose(got.numpy(), _reference(exported, J_FP32), atol=1e-4, rtol=1e-4)


def test_int8_round_trip(exported):
    fn, meta = exported["loaded"]["int8"]
    assert meta["quantized_int8"] is True and meta["compute_dtype"] == "bfloat16"
    got = fn(exported["images"])
    assert torch.equal(got, _direct(exported, INT8_SERVING_POLICY))
    want = _reference(exported, J_INT8)
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel < 0.05, rel
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


def test_export_files_and_config(exported):
    d = exported["dirs"]["fp32"]
    assert sorted(os.listdir(d)) == ["config.json", "serving.pt2", "weights.pt"]
    with open(os.path.join(d, "config.json")) as f:
        meta = json.load(f)
    assert set(meta) == REFERENCE_KEYS | {"device"}
    assert (meta["batch_size"], meta["image_size"], meta["device"]) == (BATCH, SIZE, "cpu")
    assert meta["compute_dtype"] == "float32" and meta["quantized_int8"] is False
    assert ModelConfig(**{**meta["model_config"], "dropblock_stages": (3, 4)}) == ModelConfig(**KW)


def test_program_holds_the_blurpool_op(exported):
    """The program keeps BlurPool as the custom op, so the device it runs on
    picks the implementation (the kernel on the card); here, the plain
    version, which launches nothing."""
    program = torch.export.load(os.path.join(exported["dirs"]["fp32"], "serving.pt2"))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("axcnn.blur_pool3_s2.default") == 3
    before = kblur.LAUNCHES
    exported["loaded"]["fp32"][0](exported["images"])
    assert kblur.LAUNCHES == before


def test_load_refuses_another_device(exported, tmp_path, monkeypatch):
    d = exported["dirs"]["fp32"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_serving(d)
    copy = tmp_path / "copy"
    copy.mkdir()
    for name in os.listdir(d):
        (copy / name).write_bytes((open(os.path.join(d, name), "rb")).read())
    meta = json.loads((copy / "config.json").read_text())
    (copy / "config.json").write_text(json.dumps({**meta, "device": "cuda"}))
    with pytest.raises(ValueError, match="traced on cuda"):
        load_serving(str(copy), "cpu")


def _predict_lines(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert predict.main(argv) == 0
    return [json.loads(line) for line in out.getvalue().splitlines()]


def test_predict_export_pads_to_the_batch(exported, tmp_path):
    """Three images through a batch-2 export: padded to 4 with zeros, as the
    reference pads; each line is that of the export's own logits."""
    from axcnn_torch.data.preprocessing import preprocess_eval

    rng = np.random.default_rng(13)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"img{i}.jpg"))
        Image.fromarray(rng.integers(0, 256, (70, 90, 3), dtype=np.uint8)).save(paths[-1])
    got = _predict_lines([*(f"--image={p}" for p in paths), "--cpu",
                          f"--export={exported['dirs']['fp32']}"])
    assert [line["image"] for line in got] == paths
    fn, _ = exported["loaded"]["fp32"]
    u8 = np.stack([preprocess_eval(open(p, "rb").read(), image_size=SIZE,
                                   resize_min=SIZE * 256 // 224) for p in paths]
                  + [np.zeros((SIZE, SIZE, 3), np.uint8)])
    logits = torch.cat([fn(u8[:2]), fn(u8[2:])]).numpy()[:3]
    for line, row in zip(got, logits):
        p = np.exp(row - row.max())
        p /= p.sum()
        assert [c for c, _ in line["top5"]] == [int(i) for i in np.argsort(p)[::-1][:5]]
        np.testing.assert_allclose([v for _, v in line["top5"]], np.sort(p)[::-1][:5],
                                   atol=1e-5)


def test_loop_exports_at_the_end_and_after_eval_only(tmp_path):
    from axcnn_torch.cli import main_classification

    small = ["--config=assemble_resnet50", "--data.use_synthetic_data", "--train.batch_size=4",
             "--data.image_size=32", "--model.width_multiplier=0.125", "--runtime.platform=cpu",
             f"--runtime.model_dir={tmp_path / 'run'}"]
    with contextlib.redirect_stderr(io.StringIO()):
        main_classification.main([*small, "--train.train_steps=1",
                                  f"--runtime.export_dir={tmp_path / 'e'}"])
        main_classification.main([*small, "--runtime.eval_only", "--train.dtype=int8",
                                  f"--runtime.export_dir={tmp_path / 'e8'}"])
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [(r["tag"], r["path"]) for r in records if r["tag"] == "export"] == [
        ("export", str(tmp_path / "e")), ("export", str(tmp_path / "e8"))]
    for name, int8 in (("e", False), ("e8", True)):
        assert sorted(os.listdir(tmp_path / name)) == ["config.json", "serving.pt2",
                                                       "weights.pt"]
        with open(tmp_path / name / "config.json") as f:
            meta = json.load(f)
        # the export's defaults, as the reference's loop leaves them
        assert meta["quantized_int8"] is int8 and (meta["batch_size"], meta["image_size"]) == (
            8, 32)
    # the end-of-run export serves (the round trips above cover the rest)
    fn, _ = load_serving(str(tmp_path / "e"), "cpu")
    logits = fn(np.zeros((8, 32, 32, 3), np.uint8))
    assert logits.shape == (8, 1001) and torch.isfinite(logits).all()
