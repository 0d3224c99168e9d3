"""One full training step of the PyTorch port against the JAX reference's
``make_train_step``, on the CPU, and the train-state converter.

Model: ResNet-50 at width 0.125 with the assembled flags (ResNet-D, SE, SK,
BlurPool sconv, DropBlock on stages 3-4 with keep-prob 0.5, zero-gamma), 10
classes, 64x64 images, batch 8, mixup 0.2 and label smoothing 0.1. The state
starts mid-run: step 5 of 10 (keep-prob 0.75), non-zero velocity, perturbed
BN statistics and EMA. It is built as the reference's tree from a numpy seed
and carried into the port by ``ckpt.convert.train_state_from_axcnn``. The
reference's own random draws (mixup's lambda and every DropBlock site's
uniforms, from ``RngStream(root_key).fold_step(step)``) are handed to the
port's step.

The step runs twice, from the same state and draws:

- In fp32, the working precision. Loss rtol 1e-5; BN moving statistics rtol 1e-5.
  Per-leaf gradients cannot agree to 1e-4 here: fp32 rounding flips ReLU
  and max-pool decisions near their ties, and each flip moves a leaf's
  gradient. The reference's own jitted and op-by-op runs of this step differ
  by up to 2.1e-2 per leaf (median 1.4e-3), so this leg holds the parameter
  update, the velocity and the EMA to that noise: relative L2 per leaf
  <= 5e-2, median over leaves <= 5e-3.
- In float64, where no decision flips: both packages run the same step with
  their fp32 casts re-pointed to float64 (``jnp.float32`` under
  ``jax.enable_x64``; ``Tensor.float``). The port still takes its host
  scalars (lr, the EMA decay, the DropBlock rate) in fp32, a 1e-8 relative
  difference; its EMA weights d and 1 - d, both fp32, sum to 1 + 3e-8. Loss
  rtol 1e-7; relative L2 per leaf of the update and of the velocity <= 1e-6;
  BN statistics rtol 1e-7; EMA rtol and atol 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from axcnn.core.dtypes import Policy as JPolicy
from axcnn.core.rng import RngStream as JRngStream
from axcnn.models.resnet import ModelConfig as JModelConfig
from axcnn.models.resnet import resnet_init
from axcnn.train.schedules import make_lr_schedule as j_lr
from axcnn.train.train_step import TrainState as JTrainState
from axcnn.train.train_step import make_train_step as j_make_train_step
from axcnn_torch.ckpt.convert import train_state_from_axcnn, train_state_to_axcnn
from axcnn_torch.core.dtypes import Policy
from axcnn_torch.models.resnet import ModelConfig
from axcnn_torch.train.schedules import make_lr_schedule as t_lr
from axcnn_torch.train.train_step import make_train_step

CFG = dict(width_multiplier=0.125, num_classes=10, use_resnet_d=True,
           use_se_block=True, use_sk_block=True, anti_alias_type="sconv",
           use_dropblock=True, dropblock_keep_prob=0.5, zero_gamma=True)
N, SIZE, STEP, TOTAL = 8, 64, 5, 10
STEP_KW = dict(total_steps=TOTAL, label_smoothing=0.1, mixup_alpha=0.2,
               weight_decay=1e-4, momentum=0.9, use_ema=True, ema_decay=0.9999)
LR_KW = dict(base_lr=0.1 * N / 256, total_steps=TOTAL, warmup_steps=2)
# DropBlock sites of R50 stages 3-4 and their map sizes at 64x64 input
SITES = {f"dropblock/stage{s}/block{b}": SIZE // 4 // 2 ** (s - 1)
         for s, blocks in ((3, 6), (4, 3)) for b in range(blocks)}
ROOT_KEY = 72


def _reference_state(seed):
    """The reference's TrainState at step 5: He-scaled weights, perturbed BN
    (small non-zero bn3 gamma, so no residual branch is zeroed), random
    velocity and an EMA near the weights."""
    p_shape, s_shape = jax.eval_shape(lambda k: resnet_init(k, JModelConfig(**CFG)),
                                      jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, parent = path[-1].key, path[-2].key
        shape = leaf.shape
        if name == "gamma":
            lo, hi = (0.1, 0.3) if parent == "bn3" else (0.5, 1.5)
            return rng.uniform(lo, hi, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name in ("beta", "mean") or name.startswith("b"):
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        gain = 2.0 if len(shape) == 4 else 1.0
        return (rng.standard_normal(shape) * (gain / fan_in) ** 0.5).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, p_shape)
    state = jax.tree_util.tree_map_with_path(fill, s_shape)
    velocity = jax.tree.map(
        lambda p: (0.01 * rng.standard_normal(p.shape)).astype(np.float32), params)
    ema = jax.tree.map(
        lambda p: (p + 0.01 * rng.standard_normal(p.shape)).astype(np.float32), params)
    return JTrainState(step=np.int32(STEP), params=params, model_state=state,
                       velocity=velocity, ema=ema)


def _batch():
    rng = np.random.default_rng(71)
    return {"images": rng.integers(0, 256, (N, SIZE, SIZE, 3), dtype=np.uint8),
            "labels": rng.integers(0, 10, N).astype(np.int32)}


def _run_both(float_dtype):
    """The reference's jitted step and the port's, from one state and batch,
    with the reference's draws handed to the port."""
    jstate = _reference_state(70)
    batch = _batch()
    root_key = jax.random.key(ROOT_KEY)
    f64 = float_dtype == np.float64
    j_in = jax.tree.map(lambda a: np.asarray(a, float_dtype) if a.dtype.kind == "f" else a,
                        jstate)
    policy = JPolicy(param_dtype=jnp.float32, compute_dtype=jnp.float32)
    jstep = jax.jit(j_make_train_step(JModelConfig(**CFG), lr_schedule=j_lr(**LR_KW),
                                      policy=policy, **STEP_KW))
    j_new, j_metrics = jstep(j_in, batch, root_key)
    j_new = jax.tree.map(np.asarray, j_new)

    draws = JRngStream(root_key).fold_step(jnp.int32(STEP))
    lam = np.asarray(jax.random.beta(draws("mixup"), 0.2, 0.2, dtype=jnp.float32))
    uniforms = {site: torch.from_numpy(np.array(jax.random.uniform(
        draws(site), (N, hw, hw, 1), jnp.float32))[..., 0]) for site, hw in SITES.items()}

    cfg = ModelConfig(**CFG)
    tstate = train_state_from_axcnn(jstate, cfg)
    tpolicy = Policy()
    if f64:
        tstate.model.double()
        tstate.velocity = {k: v.double() for k, v in tstate.velocity.items()}
        tstate.ema = {k: v.double() for k, v in tstate.ema.items()}
        tpolicy = Policy(param_dtype=torch.float64, compute_dtype=torch.float64)
    tstep = make_train_step(cfg, lr_schedule=t_lr(**LR_KW), policy=tpolicy, **STEP_KW)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tstate, t_metrics = tstep(tstate, tbatch, 0, lam=lam[()], dropblock_uniforms=uniforms)
    return dict(old=j_in, want=j_new, want_metrics=jax.device_get(j_metrics),
                got=train_state_to_axcnn(tstate), got_metrics=t_metrics, lam=lam)


@pytest.fixture(scope="module")
def fp32_step():
    """Compiled once per module."""
    return _run_both(np.float32)


@pytest.fixture(scope="module")
def fp64_step():
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "float32", jnp.float64)
        mp.setattr(torch.Tensor, "float", lambda self: self.double())
        out = _run_both(np.float64)
    out["got"] = jax.tree.map(lambda a: np.asarray(a, np.float64), out["got"])
    return out


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(tree):
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _update_errors(run, field):
    """Per-leaf relative L2 of ``new - old`` against the reference's."""
    old, want, got = (_leaves(getattr(run["old"], field)),
                      _leaves(getattr(run["want"], field)), _leaves(run["got"][field]))
    assert set(got) == set(want)
    return {k: _rel_l2(got[k] - old[k], want[k] - old[k]) for k in want}


def _check_metrics(run, loss_rtol):
    want, got = run["want_metrics"], run["got_metrics"]
    assert set(got) == set(want) == {"loss", "lr", "train_top1", "mixup_lam"}
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=loss_rtol)
    np.testing.assert_allclose(got["lr"], float(want["lr"]), rtol=1e-6)
    assert float(got["train_top1"]) == float(want["train_top1"])
    np.testing.assert_allclose(got["mixup_lam"], float(want["mixup_lam"]), rtol=1e-7)
    assert 0 < run["lam"] < 1  # mixup active
    assert run["got"]["step"] == run["want"].step == STEP + 1


def test_fp32_metrics_match(fp32_step):
    _check_metrics(fp32_step, 1e-5)


def test_fp64_metrics_match(fp64_step):
    _check_metrics(fp64_step, 1e-7)


@pytest.mark.parametrize("field", ["params", "velocity", "ema"])
def test_fp32_update_within_reference_noise(fp32_step, field):
    errs = _update_errors(fp32_step, field)
    worst = max(errs, key=errs.get)
    print(f"fp32 {field}: worst leaf {errs[worst]:.3g} ({worst}), "
          f"median {np.median(list(errs.values())):.3g}")
    assert errs[worst] <= 5e-2, (worst, errs[worst])
    assert np.median(list(errs.values())) <= 5e-3


@pytest.mark.parametrize("field", ["params", "velocity"])
def test_fp64_update_matches_per_leaf(fp64_step, field):
    errs = _update_errors(fp64_step, field)
    worst = max(errs, key=errs.get)
    print(f"fp64 {field}: worst leaf {errs[worst]:.3g} ({worst})")
    assert errs[worst] <= 1e-6, (worst, errs[worst])


def test_fp64_gradient_part_of_velocity_matches_per_leaf(fp64_step):
    """v_new - m * v_old = g + wd * p: the step's own gradient, without the
    old velocity that dominates v_new."""
    old, want, got = (_leaves(fp64_step["old"].velocity),
                      _leaves(fp64_step["want"].velocity),
                      _leaves(fp64_step["got"]["velocity"]))
    errs = {k: _rel_l2(got[k] - 0.9 * old[k], want[k] - 0.9 * old[k]) for k in want}
    worst = max(errs, key=errs.get)
    print(f"fp64 gradient part: worst leaf {errs[worst]:.3g} ({worst})")
    assert errs[worst] <= 1e-6, (worst, errs[worst])


@pytest.mark.parametrize("leg,rtol,atol", [("fp32", 1e-5, 1e-6), ("fp64", 1e-7, 1e-10)])
def test_bn_statistics_match(leg, rtol, atol, request):
    run = request.getfixturevalue(f"{leg}_step")
    want, got = _leaves(run["want"].model_state), _leaves(run["got"]["model_state"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def test_fp64_ema_matches(fp64_step):
    want, got = _leaves(fp64_step["want"].ema), _leaves(fp64_step["got"]["ema"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-7, atol=1e-7, err_msg=k)


def test_dropblock_drops_in_the_step():
    """With the step's keep-prob (0.75 at step 5 of 10) the reference's
    uniforms drop blocks at the sites, so the parity covers DropBlock."""
    from axcnn_torch.kernels.dropblock import dropblock_mask_reference
    from axcnn_torch.ops.dropblock import dropblock_gamma, dropblock_keep_prob

    kp = dropblock_keep_prob(STEP / TOTAL, CFG["dropblock_keep_prob"])
    assert kp == np.float32(0.75)
    draws = JRngStream(jax.random.key(ROOT_KEY)).fold_step(jnp.int32(STEP))
    dropped = 0
    for site, hw in SITES.items():
        bs = min(7, hw)
        u = torch.from_numpy(np.array(jax.random.uniform(
            draws(site), (N, hw, hw, 1), jnp.float32))[..., 0])
        mask, _ = dropblock_mask_reference(torch.zeros(N, dtype=torch.int32),
                                           float(dropblock_gamma(kp, bs, hw, hw)),
                                           hw, hw, bs, uniforms=u)
        dropped += int((mask == 0).sum())
    assert dropped > 0


# ---------------------------------------------------------------------------
# the train-state converter
# ---------------------------------------------------------------------------

def test_train_state_round_trip():
    """Reference TrainState -> port -> reference, exactly, leaf for leaf.
    Velocity and EMA cross with the parameters' leaf rule: a BN gamma's
    velocity comes back as ``gamma``, not as a conv ``w``."""
    jstate = _reference_state(73)
    tstate = train_state_from_axcnn(jstate, ModelConfig(**CFG))
    assert tstate.step == STEP
    assert set(tstate.velocity) == set(tstate.ema) == {
        k for k, _ in tstate.model.named_parameters()}
    torch.testing.assert_close(
        tstate.velocity["stage3.block0.bn3.weight"],
        torch.from_numpy(jstate.velocity["stage3"]["block0"]["bn3"]["gamma"]))
    back = train_state_to_axcnn(tstate)
    assert back["step"] == STEP
    for field in ("params", "model_state", "velocity", "ema"):
        want, got = getattr(jstate, field), back[field]
        assert jax.tree.structure(want) == jax.tree.structure(got), field
        jax.tree.map(np.testing.assert_array_equal, want, got)


def test_train_state_without_ema_round_trips():
    jstate = _reference_state(74)._replace(ema=None)
    tstate = train_state_from_axcnn(jstate, ModelConfig(**CFG))
    assert tstate.ema is None
    assert train_state_to_axcnn(tstate)["ema"] is None
