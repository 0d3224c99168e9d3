"""The 1001-way drive (``axcnn_torch.drives.convergence_1k``) over a whole
run, on the CPU: what one-step parity cannot show.

- The drive's flag list: with no extra flags, exactly the literal list
  (``cli_flags``) and the run's own flags; extra flags (a seed, the
  checkpoints to keep) come last and give the run a model directory of its
  own. ``evaluate_checkpoints`` evaluates each kept checkpoint's own state.
- (a) The schedules of the run the drive's flags make (10,000 steps,
  24,000 examples, b64, warm-up 0.05 epochs = 500 steps since
  ``train_steps`` is given, base LR 0.2 a 256, echo 4): both packages'
  ``run()`` parse the same flags and build their train step; at every step
  0..10,000 the port's DropBlock keep-prob (through
  ``train_step.step_progress``) and EMA decay equal the reference's own
  functions bit for bit, and its learning rate too through the warm-up;
  on the cosine it lies within one fp32 ulp of the peak rate (numpy's and
  XLA's fp32 cosines differ in the last place).
- (b) The training stream: the port's CLI on a generated 1001-way set of
  1,000 records (one a class, stored labels 0..999, 32x32 crops, b40 so an
  epoch is 25 whole batches, as the drive's 24,000 are 375 of 64), echo 4,
  the native loader with AutoAugment v0, two epochs, each step recorded in
  place of the train step. Each record reaches a step once an epoch, in
  the order of the reference's (Python, no ``cpp/`` build) loader on the
  same seed, and with its stored label: in both packages ``label_offset``
  is the head's geometry, not a shift of the stored labels, so the head's
  unused row is 1000 and a stored 0 trains row 0. Each echo group is four
  consecutive steps of one decoded batch, as the reference's
  ``EchoIterator`` yields the loader's batches. The share of images
  AutoAugment changes (the same stream with ``autoaugment_type=none``,
  same crops and flips) is the share the reference's AutoAugment v0
  changes on those images, within four standard errors of the difference
  of two proportions.
- (c) The EMA evaluation: from one saved state, the port's drive path
  (``common.restore_state``, ``common.evaluate_split`` with ``use_ema``)
  hands the model exactly the tensors the reference's EMA eval step hands
  ``resnet_apply``: the EMA weights with the raw BN moving statistics.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import torch_inprocess
from axcnn.data import pipeline as j_pipeline
from axcnn.data.autoaugment import make_autoaugment as j_make_autoaugment
from axcnn.data.datasets import DatasetInfo as JDatasetInfo
from axcnn.models.resnet import ModelConfig as JModelConfig
from axcnn.models.resnet import resnet_init
from axcnn.ops.dropblock import dropblock_keep_prob as j_keep_prob
from axcnn.train import loop as j_loop
from axcnn.train import train_step as j_train_step
from axcnn.train.ema import ema_update as j_ema_update
from axcnn.utils.config import parse_cli as j_parse_cli
from axcnn_torch.ckpt.checkpoint import CheckpointManager
from axcnn_torch.ckpt.convert import from_axcnn, train_state_from_axcnn
from axcnn_torch.cli import main_classification as tcli
from axcnn_torch.data.build_tfrecords import write_shards
from axcnn_torch.drives import common, convergence_1k
from axcnn_torch.models.resnet import ModelConfig
from axcnn_torch.ops.dropblock import dropblock_keep_prob
from axcnn_torch.train import loop
from axcnn_torch.train import train_step as t_train_step
from axcnn_torch.train.ema import ema_update
from axcnn_torch.utils.config import parse_cli

capped_threads = torch_inprocess.capped_threads

STEPS, N_TRAIN, N_EVAL, BATCH = 10_000, 24_000, 3_000, 64
CLASSES = 1000
STREAM_BATCH, STREAM_EPOCHS, IMAGE, WIDTH = 40, 2, 32, 0.125
TOY = ["--cpu", f"--batch={STREAM_BATCH}", f"--image_size={IMAGE}", f"--width={WIDTH}"]


class _Stop(Exception):
    """Raised by a stub once it has what the test needs."""


# ---------------------------------------------------------------------------
# the drive's flags
# ---------------------------------------------------------------------------

def _drive_args(monkeypatch, tmp_path, argv):
    """The CLI arguments and model directory ``main(argv)`` hands the CLI,
    with the set's generation and the CLI stubbed (and, without ``--cpu``,
    the card named but not touched)."""
    seen = {}
    resolve = common.resolve_device
    monkeypatch.setattr(common, "resolve_device", lambda device=None: resolve(
        "cuda" if device is None else device))

    def cli(args, tag, model_dir, log=print, retries=0):
        seen.update(args=args, model_dir=model_dir)
        raise _Stop

    monkeypatch.setattr(convergence_1k, "make_set_1k",
                        lambda root, n, n_eval, seed, log=print: os.path.join(root, "rec"))
    monkeypatch.setattr(common, "cli", cli)
    with pytest.raises(_Stop):
        convergence_1k.main(argv)
    return seen["args"], seen["model_dir"]


def test_no_extra_flags_pass_exactly_the_literal_list(monkeypatch, tmp_path):
    args, model_dir = _drive_args(monkeypatch, tmp_path, [str(STEPS), str(tmp_path)])
    root = str(tmp_path)
    assert model_dir == os.path.join(root, f"run_{STEPS}")
    assert args == [*convergence_1k.cli_flags(os.path.join(root, "rec"), model_dir, STEPS,
                                              N_TRAIN, N_EVAL),
                    "--runtime.num_devices=1"]


def test_extra_flags_come_last_and_get_their_own_model_dir(monkeypatch, tmp_path):
    extra = ["--train.seed=7", "--runtime.keep_checkpoint_max=11"]
    base, base_dir = _drive_args(monkeypatch, tmp_path, ["3", str(tmp_path), "2", *TOY])
    args, model_dir = _drive_args(monkeypatch, tmp_path,
                                  ["3", str(tmp_path), "2", *TOY, "--", *extra])
    assert model_dir != base_dir
    assert os.path.dirname(model_dir) == str(tmp_path)
    assert args == [*[a.replace(base_dir, model_dir) for a in base], *extra]
    other, other_dir = _drive_args(monkeypatch, tmp_path,
                                   ["3", str(tmp_path), "2", *TOY, "--", "--train.seed=8"])
    assert other_dir not in (base_dir, model_dir)
    assert other[-1] == "--train.seed=8"


# ---------------------------------------------------------------------------
# (a) the schedules over the whole run
# ---------------------------------------------------------------------------

def _step_kwargs(module, run, cfg, monkeypatch):
    """The keyword arguments ``run(cfg)`` builds its train step with."""
    seen = {}

    def make_train_step(model_cfg, **kw):
        seen.update(kw, model=model_cfg)
        raise _Stop

    monkeypatch.setattr(module, "make_train_step", make_train_step)
    with pytest.raises(_Stop):
        run(cfg)
    return seen


def test_schedules_equal_the_reference_at_every_step(monkeypatch, tmp_path):
    flags = convergence_1k.cli_flags(str(tmp_path / "rec"), str(tmp_path / "run"), STEPS,
                                     N_TRAIN, N_EVAL)
    port = _step_kwargs(loop, loop.run,
                        parse_cli([*flags, "--runtime.num_devices=1",
                                   "--runtime.platform=cpu"]), monkeypatch)
    ref = _step_kwargs(j_loop, j_loop.run, j_parse_cli([*flags, "--runtime.num_devices=1"]),
                       monkeypatch)
    total = port["total_steps"]
    assert total == ref["total_steps"] == STEPS
    assert port["ema_decay"] == ref["ema_decay"] == 0.9999 and port["use_ema"] and ref["use_ema"]
    keep = port["model"].dropblock_keep_prob
    assert keep == ref["model"].dropblock_keep_prob and port["model"].use_dropblock
    steps = np.arange(STEPS + 1)

    want_lr = np.asarray(ref["lr_schedule"](jnp.asarray(steps)))
    got_lr = np.array([port["lr_schedule"](s) for s in steps], np.float32)
    warm = 500  # 0.05 of the run
    assert got_lr[0] == 0 and got_lr.argmax() == warm
    np.testing.assert_allclose(got_lr.max(), 0.2 * BATCH / 256, rtol=1e-6)
    np.testing.assert_array_equal(got_lr[:warm + 1], want_lr[:warm + 1])
    # the cosine: numpy's fp32 cos and XLA's differ in the last place, which
    # the schedule scales by base_lr / 2: at most one fp32 ulp of the peak
    np.testing.assert_array_less(np.abs(got_lr - want_lr), np.spacing(got_lr.max()) * 1.0001)

    # the reference's step: progress = step.astype(f32) / max(total_steps, 1)
    want_keep = np.asarray(j_keep_prob(jnp.asarray(steps, jnp.float32) / max(total, 1), keep))
    got_keep = np.array([dropblock_keep_prob(t_train_step.step_progress(s, total), keep)
                         for s in steps], np.float32)
    np.testing.assert_array_equal(got_keep, want_keep)
    assert got_keep[0] == 1 and got_keep[-1] == np.float32(keep)

    # the decay d and 1 - d of the update e * d + p * (1 - d), at e = 1, p = 0 and e = 0, p = 1
    n = len(steps)
    ref_ema = j_ema_update({"d": jnp.ones(n), "1-d": jnp.zeros(n)},
                           {"d": jnp.zeros(n), "1-d": jnp.ones(n)},
                           decay=ref["ema_decay"], step=jnp.asarray(steps))
    got = {"d": [], "1-d": []}
    for s in steps:
        ema = {"d": torch.ones(1), "1-d": torch.zeros(1)}
        ema_update(ema, {"d": torch.zeros(1), "1-d": torch.ones(1)}, step=int(s),
                   decay=port["ema_decay"])
        for k in got:
            got[k].append(float(ema[k]))
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k], np.float32), np.asarray(ref_ema[k]))
    assert got["d"][0] == np.float32(0.1) and got["d"][-1] < 0.9992


# ---------------------------------------------------------------------------
# the generated 1001-way set of (b) and (c)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def set_1k(tmp_path_factory):
    """1,000 train records, one a class with stored label = class (0..999),
    and 40 eval records, as 48x40 JPEGs: smooth two-hue gradients with
    noise, so every AutoAugment op has something to change. 16 train and 4
    validation shards, as the drive writes them."""
    root = tmp_path_factory.mktemp("set_1k")
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:40, 0:48] / 48.0
    items = {"train": [], "validation": []}
    for i in range(CLASSES + STREAM_BATCH):
        a, b = rng.integers(0, 256, (2, 3))
        img = (a * xx[..., None] + b * yy[..., None] + rng.normal(0, 12, (40, 48, 3)))
        path = str(root / f"{i}.jpg")
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path, quality=92)
        split = "train" if i < CLASSES else "validation"
        items[split].append((path, i % CLASSES, f"c{i % CLASSES}"))
    rec = str(root / "rec")
    write_shards(items["train"], rec, "train", 16)
    write_shards(items["validation"], rec, "validation", 4)
    return rec


# ---------------------------------------------------------------------------
# (b) the training stream
# ---------------------------------------------------------------------------

def _stream(rec, model_dir, monkeypatch, extra=()):
    """The port's CLI on the drive's flags (toy sizes) for two epochs of
    echoed steps: what each train step was handed, and the loader's own
    batches (upstream of the prefetch and the echo)."""
    steps_seen, upstream = [], []

    def make_train_step(model_cfg, **kw):
        def step(state, batch, root_seed):
            steps_seen.append({k: v.clone() for k, v in batch.items()})
            state.step += 1
            zero = torch.zeros(())
            return state, {"loss": zero, "lr": zero, "train_top1": zero, "mixup_lam": zero}
        return step

    def make_eval_step(model_cfg, **kw):
        def step(state, batch):
            n = torch.tensor(float(batch["labels"].shape[0]))
            return {"top1": n, "top5": n, "count": n, "loss_sum": torch.zeros(())}
        return step

    class Recording:
        def __init__(self, loader):
            self.loader = loader

        @property
        def state(self):
            return self.loader.state

        @state.setter
        def state(self, value):
            self.loader.state = value

        def __iter__(self):
            for batch in self.loader:
                upstream.append({k: np.array(v) for k, v in batch.items()})
                yield batch

    make_loaders = loop._make_loaders
    monkeypatch.setattr(loop, "make_train_step", make_train_step)
    monkeypatch.setattr(loop, "make_eval_step", make_eval_step)
    monkeypatch.setattr(loop, "_make_loaders",
                        lambda *a, **k: (lambda t, e: (Recording(t), e))(*make_loaders(*a, **k)))
    per_epoch = CLASSES // STREAM_BATCH
    steps = STREAM_EPOCHS * per_epoch * convergence_1k.ECHO
    tcli.main([*convergence_1k.cli_flags(rec, model_dir, steps, CLASSES, STREAM_BATCH,
                                         STREAM_BATCH),
               *common.cli_run_flags(torch.device("cpu"), width=WIDTH, image_size=IMAGE,
                                     full_size=convergence_1k.IMAGE),
               "--train.log_every=1000", *extra])
    assert len(steps_seen) == steps
    return steps_seen, upstream


@pytest.fixture(scope="module")
def streams(set_1k, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        aa = _stream(set_1k, str(tmp_path_factory.mktemp("aa")), mp)
    with pytest.MonkeyPatch.context() as mp:
        plain = _stream(set_1k, str(tmp_path_factory.mktemp("plain")), mp,
                        ["--data.autoaugment_type=none"])
    return {"v0": aa, "none": plain}


def test_each_record_reaches_a_step_once_an_epoch_in_the_reference_order(streams, set_1k):
    steps, upstream = streams["v0"]
    echo, per_epoch = convergence_1k.ECHO, CLASSES // STREAM_BATCH
    assert len(upstream) >= STREAM_EPOCHS * per_epoch
    fresh = [s["labels"].numpy() for s in steps[::echo]]
    info = JDatasetInfo("drive1k", 1001, CLASSES, STREAM_BATCH, label_offset=1,
                        train_prefix="train", eval_prefix="validation")
    cfg = parse_cli(convergence_1k.cli_flags(set_1k, "/unused", 1, CLASSES, STREAM_BATCH))
    ref = j_pipeline.TFRecordImageLoader(
        set_1k, info, batch_size=STREAM_BATCH, train=True, image_size=IMAGE,
        resize_min=common.resize_min_for(IMAGE), seed=cfg.train.seed,
        shuffle_buffer=cfg.data.shuffle_buffer, num_workers=2, use_native=False)
    ref_labels = [b["labels"] for _, b in zip(range(len(fresh)), ref)]
    for epoch in range(STREAM_EPOCHS):
        labels = np.concatenate(fresh[epoch * per_epoch:(epoch + 1) * per_epoch])
        np.testing.assert_array_equal(np.sort(labels), np.arange(CLASSES))  # 0..999, once
        np.testing.assert_array_equal(
            labels, np.concatenate(ref_labels[epoch * per_epoch:(epoch + 1) * per_epoch]))
    assert not np.array_equal(np.concatenate(fresh[:per_epoch]),
                              np.concatenate(fresh[per_epoch:]))  # reshuffled


def test_echo_groups_are_the_reference_echo_of_the_loader_batches(streams):
    steps, upstream = streams["v0"]
    echo = convergence_1k.ECHO
    want = j_pipeline.EchoIterator(iter(upstream), echo)
    for i, got in enumerate(steps):
        ref = next(want)
        for k in ("images", "labels"):
            np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=f"step {i} {k}")
        if i % echo:
            assert torch.equal(got["images"], steps[i - 1]["images"])
    assert not torch.equal(steps[0]["images"], steps[echo]["images"])


def test_autoaugment_changes_the_share_the_reference_changes(streams):
    echo = convergence_1k.ECHO
    aa = np.concatenate([s["images"].numpy() for s in streams["v0"][0][::echo]])
    plain = np.concatenate([s["images"].numpy() for s in streams["none"][0][::echo]])
    labels = [np.concatenate([s["labels"].numpy() for s in streams[k][0][::echo]])
              for k in ("v0", "none")]
    np.testing.assert_array_equal(*labels)  # the same records in the same order
    n = len(plain)
    port = float(np.mean([(a != p).any() for a, p in zip(aa, plain)]))
    fn, rng = j_make_autoaugment("v0"), np.random.default_rng(11)
    ref = float(np.mean([(np.asarray(fn(Image.fromarray(p), rng)) != p).any() for p in plain]))
    se = np.sqrt(port * (1 - port) / n + ref * (1 - ref) / n)
    print(f"AutoAugment v0 changed {port:.4f} (port) vs {ref:.4f} (reference) of {n}, "
          f"se {se:.4f}")
    assert 0.5 < port < 1.0
    assert abs(port - ref) <= 4 * se


# ---------------------------------------------------------------------------
# (c) the EMA evaluation
# ---------------------------------------------------------------------------

CFG_1K = dict(width_multiplier=WIDTH, num_classes=1001, use_resnet_d=True, use_se_block=True,
              use_sk_block=True, anti_alias_type="sconv", use_dropblock=True,
              dropblock_keep_prob=0.9, zero_gamma=True)


def _reference_state(seed):
    """A reference TrainState: He-scaled weights, BN statistics away from
    their init, and an EMA that differs from the weights."""
    p_shape, s_shape = jax.eval_shape(lambda k: resnet_init(k, JModelConfig(**CFG_1K)),
                                      jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name in ("gamma", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ("beta", "mean") or name.startswith("b"):
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.standard_normal(leaf.shape) * (2.0 / fan_in) ** 0.5).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, p_shape)
    return j_train_step.TrainState(
        step=np.int32(STEPS), params=params,
        model_state=jax.tree_util.tree_map_with_path(fill, s_shape),
        velocity=jax.tree.map(np.zeros_like, params),
        ema=jax.tree.map(lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
                         params))


def test_ema_eval_takes_the_tensors_the_reference_takes(set_1k, tmp_path, monkeypatch):
    jstate = _reference_state(3)
    cfg = ModelConfig(**CFG_1K)
    mgr = CheckpointManager(str(tmp_path / "checkpoints"),
                            model_config=dataclasses.asdict(cfg))
    mgr.save(train_state_from_axcnn(jstate, cfg), force=True)
    mgr.close()
    mcfg, state = common.restore_state(str(tmp_path / "checkpoints"), device="cpu")

    seen = []
    call = t_train_step.functional_call

    def spy(module, params, args, kwargs):
        seen.append({**dict(module.named_buffers()), **params})
        return call(module, params, args, kwargs)

    monkeypatch.setattr(t_train_step, "functional_call", spy)
    info = convergence_1k.dataset_info(CLASSES, STREAM_BATCH)
    got = common.evaluate_split(mcfg, state, set_1k, info, use_ema=True, batch=STREAM_BATCH,
                                image_size=IMAGE, device="cpu")
    assert got["count"] == STREAM_BATCH and np.isfinite(got["loss"])
    assert seen

    ref_seen = []

    def apply(params, model_state, images, **kw):
        ref_seen.append((params, model_state))
        return jnp.zeros((images.shape[0], CFG_1K["num_classes"])), model_state

    monkeypatch.setattr(j_train_step, "resnet_apply", apply)
    images = np.zeros((2, IMAGE, IMAGE, 3), np.uint8)
    j_train_step.make_eval_step(JModelConfig(**CFG_1K), use_ema=True)(
        jstate, {"images": images, "labels": np.zeros(2, np.int32)})
    (params, model_state), = ref_seen
    want = from_axcnn(params, model_state, cfg)
    raw = from_axcnn(jstate.params, jstate.model_state, cfg)
    for tensors in seen:
        assert set(tensors) == set(want)
        for k, w in want.items():
            assert torch.equal(tensors[k], torch.as_tensor(w).to(tensors[k].dtype)), k
    moved = [k for k in want if not torch.equal(torch.as_tensor(raw[k]),
                                                torch.as_tensor(want[k]))]
    assert moved and all(k in dict(state.model.named_parameters()) for k in moved)


def test_the_curve_evaluates_each_kept_checkpoint(set_1k, tmp_path, monkeypatch):
    """``evaluate_checkpoints`` restores each kept step's own state."""
    cfg = ModelConfig(**CFG_1K)
    mgr = CheckpointManager(str(tmp_path / "checkpoints"), max_to_keep=None,
                            model_config=dataclasses.asdict(cfg))
    for seed, step in ((4, 1000), (5, 2000)):
        state = train_state_from_axcnn(_reference_state(seed)._replace(step=np.int32(step)),
                                       cfg)
        mgr.save(state, force=True)
        mgr.wait()
    mgr.close()
    steps = []

    def evaluate_split(mcfg, state, data_dir, info, *, use_ema, **kw):
        steps.append((state.step, use_ema))
        return {"top1": float(state.step), "top5": 100.0, "loss": 1.0, "count": 40.0}

    monkeypatch.setattr(common, "evaluate_split", evaluate_split)
    curve = convergence_1k.evaluate_checkpoints(
        str(tmp_path), set_1k, convergence_1k.dataset_info(CLASSES, STREAM_BATCH),
        batch=STREAM_BATCH, image_size=IMAGE, device="cpu", log=lambda *_: None)
    assert steps == [(1000, False), (1000, True), (2000, False), (2000, True)]
    assert [(p["step"], p["raw_top1"], p["ema_top1"]) for p in curve] == \
        [(1000, 1000.0, 1000.0), (2000, 2000.0, 2000.0)]
