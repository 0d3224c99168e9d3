"""The port's checkpoint manager, ``axcnn_torch.ckpt.checkpoint``, on the CPU.

A train state of the assembled R50 at width 0.125 (10 classes) with a
non-zero velocity, an EMA unlike the parameters and perturbed BN statistics
goes through ``save`` and ``restore``: every tensor comes back bit for bit,
in the fresh state's memory format. Also: retention, the orbax-like save
rules, atomic writes, strict restore, the ``model_config.json`` sidecar
against the reference's, and the bridge from an ``axcnn`` orbax checkpoint
(``train_state_from_axcnn``, then the port's ``save``) to the port's
``predict``, which must serve what ``axcnn``'s ``predict`` serves.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from axcnn_torch.ckpt.checkpoint import SIDECAR, CheckpointManager
from axcnn_torch.data.pipeline import LoaderState
from axcnn_torch.models.resnet import ModelConfig
from axcnn_torch.train.train_step import create_train_state, eval_logits
import torch_inprocess

capped_threads = torch_inprocess.capped_threads

CFG = dict(width_multiplier=0.125, num_classes=10, use_resnet_d=True,
           use_se_block=True, use_sk_block=True, anti_alias_type="sconv",
           use_dropblock=True, zero_gamma=True)


def _state(seed, *, use_ema=True, cfg=None):
    """A state unlike a fresh one in every field."""
    state = create_train_state(cfg or ModelConfig(**CFG),
                               generator=torch.Generator().manual_seed(seed),
                               device="cpu", use_ema=use_ema)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for t in [*state.velocity.values(), *(state.ema or {}).values(),
                  *state.model.buffers()]:
            t.add_(torch.rand(t.shape, generator=g).to(memory_format=_fmt(t)))
    state.step = 7
    return state


def _fmt(t):
    return torch.channels_last if t.dim() == 4 else torch.contiguous_format


def _tensors(state):
    return {"model": state.model.state_dict(), "velocity": state.velocity,
            "ema": state.ema}


def test_round_trip_is_bit_exact_with_the_fresh_formats(tmp_path):
    saved = _state(0)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(saved, loader_state=LoaderState(3, 11), rng_seed=42)
    fresh = _state(5)
    fresh.step = 0
    formats = {f: {k: t.stride() for k, t in d.items()} for f, d in _tensors(fresh).items()}
    state, loader_state, rng_seed = mgr.restore(fresh)
    assert state is fresh and state.step == 7
    assert loader_state == LoaderState(3, 11) and rng_seed == 42
    for field, want in _tensors(saved).items():
        got = _tensors(state)[field]
        assert list(got) == list(want), field
        for k in want:
            assert torch.equal(got[k], want[k]), (field, k)
            assert got[k].dtype == want[k].dtype
            assert got[k].stride() == formats[field][k], (field, k)
    assert state.velocity["stem.conv0.weight"].is_contiguous(memory_format=torch.channels_last)


def test_the_payload_holds_the_reference_fields(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(1), loader_state=LoaderState(1, 2), rng_seed=3)
    raw = mgr.load()
    assert set(raw) == {"step", "params", "model_state", "velocity", "ema", "rng_seed",
                        "loader_epoch", "loader_batches"}
    assert (raw["step"], raw["rng_seed"], raw["loader_epoch"], raw["loader_batches"]) == (7, 3, 1, 2)
    assert set(raw["model_state"]) == {k for k, _ in _state(1).model.named_buffers()}
    mgr2 = CheckpointManager(str(tmp_path / "noema"))
    mgr2.save(_state(1, use_ema=False))
    assert "ema" not in mgr2.load()
    state, *_ = mgr2.restore(_state(2, use_ema=False))
    assert state.ema is None


def test_retention_and_save_rules(tmp_path):
    """``max_to_keep`` keeps the newest; as with orbax, a saved step is never
    rewritten and an older step is written only when forced."""
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    state = _state(2)
    for step in (1, 2, 3, 4):
        state.step = step
        assert mgr.save(state)
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["3.pt", "4.pt"]
    state.step = 4
    assert not mgr.save(state, force=True)
    state.step = 2
    assert not mgr.save(state)
    wider = CheckpointManager(str(tmp_path), max_to_keep=3)
    assert wider.save(state, force=True)
    assert wider.all_steps() == [2, 3, 4]  # retention is by step
    wider.wait()
    assert mgr.restore(_state(3), step=2)[0].step == 2
    with pytest.raises(ValueError, match="max_to_keep"):
        CheckpointManager(str(tmp_path), max_to_keep=0)
    keep_all = CheckpointManager(str(tmp_path / "all"), max_to_keep=None)
    for step in range(1, 8):
        state.step = step
        keep_all.save(state)
    assert keep_all.all_steps() == list(range(1, 8))


def test_no_checkpoint_reads_as_none_and_creates_nothing(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "none"))
    assert mgr.latest_step() is None and mgr.load() is None
    assert mgr.restore(_state(0)) is None and mgr.model_config() is None
    assert not (tmp_path / "none").exists()


def test_a_failed_save_leaves_the_last_good_checkpoint(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    state = _state(4)
    mgr.save(state)
    mgr.wait()
    good = (tmp_path / "7.pt").read_bytes()

    def killed(obj, f):
        f.write(b"partial")
        raise KeyboardInterrupt("killed mid-save")

    monkeypatch.setattr(torch, "save", killed)
    state.step = 8
    assert mgr.save(state)  # the write fails in the writer thread
    with pytest.raises(KeyboardInterrupt):
        mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["7.pt"]
    assert (tmp_path / "7.pt").read_bytes() == good and mgr.latest_step() == 7


@pytest.mark.parametrize("change,match", [
    (dict(width_multiplier=0.25), "mis-shaped"),
    (dict(num_classes=11), "mis-shaped"),
    (dict(use_se_block=False), "unexpected"),
    (dict(use_resnet_d=False), "missing"),
])
def test_restore_is_strict_and_writes_nothing_on_a_mismatch(tmp_path, change, match):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(0))
    other = _state(1, cfg=ModelConfig(**{**CFG, **change}))
    before = {k: t.clone() for k, t in other.model.state_dict().items()}
    with pytest.raises(ValueError, match=match) as err:
        mgr.restore(other)
    assert "7.pt" in str(err.value) and "does not match the model" in str(err.value)
    for k, t in other.model.state_dict().items():
        assert torch.equal(t, before[k])
    assert other.step == 7  # untouched (the helper's step)


def test_restore_refuses_an_ema_mismatch(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(0, use_ema=False))
    with pytest.raises(ValueError, match="has no EMA"):
        mgr.restore(_state(1, use_ema=True))


def test_sidecar_matches_the_reference(tmp_path):
    """The same ``model_config.json`` as ``axcnn.ckpt.checkpoint`` writes:
    the reference's keys and values, from ``dataclasses.asdict``."""
    from axcnn.ckpt.checkpoint import CheckpointManager as JCheckpointManager
    from axcnn.models.resnet import ModelConfig as JModelConfig

    JCheckpointManager(str(tmp_path / "j"), model_config=dataclasses.asdict(
        JModelConfig(**CFG))).close()
    mgr = CheckpointManager(str(tmp_path / "t"),
                            model_config=dataclasses.asdict(ModelConfig(**CFG)))
    want = json.loads((tmp_path / "j" / SIDECAR).read_text())
    got = json.loads((tmp_path / "t" / SIDECAR).read_text())
    assert got == want and mgr.model_config() == want
    assert set(got) == {f.name for f in dataclasses.fields(JModelConfig)}


# ---------------------------------------------------------------------------
# the orbax bridge, served by both packages' predict
# ---------------------------------------------------------------------------

PREDICT = ["--config=assemble_resnet50", "--model.width_multiplier=0.125",
           "--data.image_size=64", "--data.dataset_name=custom", "--data.num_classes=10",
           "--train.dtype=fp32"]


def _reference_template(jcfg):
    """The reference's ``TrainState`` as shapes only (no init compile)."""
    import jax

    from axcnn.models.resnet import resnet_init
    from axcnn.train.train_step import TrainState as JTrainState

    p, s = jax.eval_shape(lambda k: resnet_init(k, jcfg), jax.random.key(0))
    return JTrainState(step=0, params=p, model_state=s, velocity=p, ema=p)


def _axcnn_checkpoint(model_dir, jcfg):
    """An ``axcnn`` orbax checkpoint of the assembled R50 at width 0.125 with
    He-scaled weights, perturbed BN, a wide head (so the top-5 probabilities
    are well apart) and an EMA unlike the parameters."""
    import jax

    from axcnn.ckpt.checkpoint import CheckpointManager as JCheckpointManager
    from axcnn.data.pipeline import LoaderState as JLoaderState

    shapes = _reference_template(jcfg)
    rng = np.random.default_rng(90)

    def fill(path, leaf):
        name = path[-1].key
        if name in ("gamma", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ("beta", "mean") or name.startswith("b"):
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = 1 if path[0].key == "head" else int(np.prod(leaf.shape[:-1]))
        return (rng.standard_normal(leaf.shape) * (2.0 / fan_in) ** 0.5).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes.params)
    state = shapes._replace(
        step=np.int32(3), params=params,
        model_state=jax.tree_util.tree_map_with_path(fill, shapes.model_state),
        velocity=jax.tree.map(lambda p: 0.01 * p, params),
        ema=jax.tree.map(lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
                         params))
    mgr = JCheckpointManager(os.path.join(model_dir, "checkpoints"),
                             model_config=dataclasses.asdict(jcfg))
    mgr.save(state, loader_state=JLoaderState(0, 3), rng_seed=42, force=True)
    mgr.wait()
    mgr.close()


def _top5(lines):
    return [json.loads(line)["top5"] for line in lines.strip().splitlines()]


def test_orbax_checkpoint_crosses_and_serves_the_same(tmp_path, capsys):
    """axcnn orbax checkpoint -> ``axcnn.ckpt.checkpoint.CheckpointManager
    .restore`` -> ``train_state_from_axcnn`` -> the port's ``save``; the
    port's ``predict`` then serves the reference's EMA weights: the same
    top-5 as ``axcnn.cli.predict`` on the same JPEG, fp32, rtol 1e-4."""
    from axcnn.ckpt.checkpoint import CheckpointManager as JCheckpointManager
    from axcnn.cli import predict as jpredict
    from axcnn.models.resnet import ModelConfig as JModelConfig
    from axcnn_torch.ckpt.convert import train_state_from_axcnn
    from axcnn_torch.cli import predict as tpredict

    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    _axcnn_checkpoint(jdir, JModelConfig(**CFG))
    # the three lines of the bridge (README.md)
    jmgr = JCheckpointManager(os.path.join(jdir, "checkpoints"))
    jstate, loader_state, rng_seed = jmgr.restore(_reference_template(JModelConfig(**CFG)))
    tmgr = CheckpointManager(os.path.join(tdir, "checkpoints"), model_config=jmgr.model_config())
    tmgr.save(train_state_from_axcnn(jstate, ModelConfig(**CFG)), loader_state=loader_state,
              rng_seed=rng_seed)
    tmgr.wait()
    jmgr.close()

    imgs = []
    for i, (h, w) in enumerate([(80, 96), (70, 110)]):
        p = tmp_path / f"img{i}.jpg"
        Image.fromarray(np.random.default_rng(i).integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(p)
        imgs.append(f"--image={p}")
    assert jpredict.main([*imgs, *PREDICT, f"--runtime.model_dir={jdir}"]) == 0
    want = _top5(capsys.readouterr().out)
    assert tpredict.main([*imgs, *PREDICT, f"--runtime.model_dir={tdir}", "--cpu"]) == 0
    out = capsys.readouterr()
    got = _top5(out.out)
    assert "random init" not in out.err
    for g, w in zip(got, want):
        assert [c for c, _ in g] == [c for c, _ in w]
        np.testing.assert_allclose([p for _, p in g], [p for _, p in w], rtol=1e-4)
    # the EMA was served, not the parameters
    restored = CheckpointManager(os.path.join(tdir, "checkpoints")).restore(
        create_train_state(ModelConfig(**CFG), generator=torch.Generator(), device="cpu"))
    assert restored[0].step == 3 and restored[1] == LoaderState(0, 3) and restored[2] == 42
    x = torch.zeros(1, 64, 64, 3, dtype=torch.uint8)
    assert not torch.allclose(eval_logits(restored[0], x, use_ema=True),
                              eval_logits(restored[0], x, use_ema=False))


def test_predict_refuses_a_checkpoint_of_another_model(tmp_path, capsys):
    """With a sidecar: a message naming the checkpoint directory and the
    fields; without one: the strict restore's message naming the file."""
    from axcnn_torch.cli import predict as tpredict

    img = tmp_path / "a.jpg"
    Image.fromarray(np.zeros((40, 40, 3), np.uint8)).save(img)
    ckpt_dir = tmp_path / "run" / "checkpoints"
    mgr = CheckpointManager(str(ckpt_dir), model_config=dataclasses.asdict(
        ModelConfig(**{**CFG, "width_multiplier": 0.25})))
    mgr.save(_state(0, cfg=ModelConfig(**{**CFG, "width_multiplier": 0.25})))
    mgr.wait()
    argv = [f"--image={img}", *PREDICT, f"--runtime.model_dir={tmp_path / 'run'}", "--cpu"]
    assert tpredict.main(argv) == 1
    err = capsys.readouterr().err
    assert str(ckpt_dir) in err and "width_multiplier: 0.25, 0.125" in err
    os.remove(ckpt_dir / SIDECAR)
    with pytest.raises(ValueError, match=r"checkpoint .*7\.pt does not match the model"):
        tpredict.main(argv)
