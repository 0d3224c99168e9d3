"""Knowledge distillation and gradient accumulation in the port, against the
JAX reference, on the CPU.

- ``kd_loss`` value and gradient against ``axcnn.train.losses.kd_loss``.
- The KD teacher's architecture and weights from a checkpoint
  (``loop._teacher_model_config``, ``loop._load_teacher``), mirroring the
  reference's tests/test_loop.py teacher cases.
- One KD step (teacher: vanilla R50 at width 0.125, frozen, ``kd_temp=2``,
  ``kd_alpha=0.5``), one ``grad_accum_steps=2`` step and one step of both
  together against the reference's ``make_train_step``, by the method and
  tolerances of
  tests/test_torch_train_step.py: the same student (assembled R50 at width
  0.125, 64x64, batch 8, step 5 of 10, DropBlock and mixup on), the
  reference's own draws handed to the port (one lambda and one set of
  DropBlock uniforms per micro-batch under accumulation, from the step's
  ``"accum"`` stream folded with the micro-batch index). The reference runs
  once per kind, in float64: both packages' fp32 casts are re-pointed, the
  port's host scalars included, and every run of a kind takes the same
  draws, fp32 values. The port's float64 step agrees per leaf to <= 1e-6
  (measured: <= 1.1e-11). Its fp32 step stays within the reference's own
  jit-vs-op-by-op fp32 noise of that exact step (one reference compile per
  kind instead of two). The combined step comes closest to that bound: 4.9e-2
  on the velocity of one SE bias, whose gradient is a cancelling sum.
  Under accumulation the micro-batch is 4 and stage 4 is 2x2, so BN sees 16
  samples per channel there.
- Three KD steps under accumulation from a fresh init at the learning rates
  of the KD preset's 3-step run, in float64: the loss at every step and the
  final parameters and velocity agree with the reference's, with the KD
  term and without it. The KD loss rises at the third step in both packages
  alike, as it does on the card at full width.
"""

import contextlib
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from axcnn.core.dtypes import Policy as JPolicy
from axcnn.core.rng import RngStream as JRngStream
from axcnn.models.resnet import ModelConfig as JModelConfig
from axcnn.models.resnet import resnet_init
from axcnn.train.losses import kd_loss as j_kd_loss
from axcnn.train.schedules import make_lr_schedule as j_lr
from axcnn.train.train_step import create_train_state as j_create_train_state
from axcnn.train.train_step import make_train_step as j_make_train_step
from axcnn_torch.ckpt.checkpoint import CheckpointManager
from axcnn_torch.ckpt.convert import from_axcnn, train_state_from_axcnn, train_state_to_axcnn
from axcnn_torch.core.dtypes import Policy
from axcnn_torch.models.resnet import ModelConfig, ResNet
from axcnn_torch.ops import dropblock as t_dropblock
from axcnn_torch.train import ema as t_ema
from axcnn_torch.train import loop
from axcnn_torch.train import schedules as t_schedules
from axcnn_torch.train import train_step as t_train_step
from axcnn_torch.train.losses import kd_loss
from axcnn_torch.train.schedules import make_lr_schedule as t_lr
from axcnn_torch.train.train_step import create_train_state, make_train_step
from axcnn_torch.utils.config import Config, DataConfig, TrainConfig
from test_torch_train_step import (
    CFG, LR_KW, N, ROOT_KEY, SITES, STEP, STEP_KW, _batch, _leaves, _reference_state,
    _rel_l2, _update_errors)

TEACHER_CFG = dict(width_multiplier=0.125, num_classes=10)
KD_KW = dict(kd_temp=2.0, kd_alpha=0.5)
A = 2


# ---------------------------------------------------------------------------
# kd_loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [1.0, 2.0, 4.0])
def test_kd_loss_value_and_gradient_match_reference(temperature):
    rng = np.random.default_rng(80)
    s = (3 * rng.standard_normal((6, 11))).astype(np.float32)
    t = (3 * rng.standard_normal((6, 11))).astype(np.float32)
    want, want_g = jax.value_and_grad(
        lambda x: j_kd_loss(x, jnp.asarray(t), temperature=temperature))(jnp.asarray(s))
    st = torch.from_numpy(s).requires_grad_()
    got = kd_loss(st, torch.from_numpy(t), temperature=temperature)
    got.backward()
    assert got.dtype == torch.float32 and got.item() > 0
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-6)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(want_g), rtol=2e-5, atol=1e-8)


def test_kd_loss_is_zero_for_equal_logits_and_fp32_from_bf16():
    x = torch.randn(4, 7, generator=torch.Generator().manual_seed(0))
    assert kd_loss(x, x).abs().item() < 1e-6
    assert kd_loss(x.bfloat16(), x.bfloat16()).dtype == torch.float32


# ---------------------------------------------------------------------------
# the teacher from a checkpoint
# ---------------------------------------------------------------------------

def _kd_cfg(ckpt_dir, **train_kw):
    return Config(model=ModelConfig(num_classes=10, width_multiplier=0.125),
                  data=DataConfig(image_size=32),
                  train=TrainConfig(kd_teacher_checkpoint=str(ckpt_dir), **train_kw))


def _save_teacher(directory, cfg, *, sidecar=True, seed=0):
    state = create_train_state(cfg, generator=torch.Generator().manual_seed(seed),
                               device="cpu", use_ema=True)
    with torch.no_grad():  # an EMA unlike the parameters
        for v in state.ema.values():
            v.add_(0.01)
    mgr = CheckpointManager(directory,
                            model_config=dataclasses.asdict(cfg) if sidecar else None)
    mgr.save(state)
    mgr.wait()
    return state


def test_teacher_architecture_from_the_sidecar(tmp_path):
    """An SE + ResNet-D teacher comes back as such for a vanilla student,
    frozen, in eval mode, with the checkpoint's EMA weights."""
    t_cfg = ModelConfig(num_classes=10, width_multiplier=0.125, use_se_block=True,
                        use_resnet_d=True)
    saved = _save_teacher(tmp_path / "t", t_cfg)
    teacher = loop._load_teacher(_kd_cfg(tmp_path / "t"), torch.device("cpu"))
    assert teacher.cfg == t_cfg and not teacher.training
    assert not any(p.requires_grad for p in teacher.parameters())
    for k, p in teacher.named_parameters():
        assert torch.equal(p, saved.ema[k]), k
    for k, b in teacher.named_buffers():
        assert torch.equal(b, dict(saved.model.named_buffers())[k]), k
    with torch.no_grad():
        assert teacher(torch.zeros(1, 32, 32, 3)).shape == (1, 10)


def test_teacher_architecture_from_flags_and_their_override(tmp_path):
    """Without a sidecar the student's knobs and the explicit flags decide;
    the flags also override a sidecar; a head mismatch is a ValueError."""
    _save_teacher(tmp_path / "t", ModelConfig(num_classes=10, width_multiplier=0.125,
                                              use_se_block=True), sidecar=False)
    kd = _kd_cfg(tmp_path / "t", kd_teacher_use_se_block="true")
    teacher = loop._load_teacher(kd, torch.device("cpu"))
    assert teacher.cfg.use_se_block and not kd.model.use_se_block
    with pytest.raises(ValueError, match="does not match the model"):
        loop._load_teacher(_kd_cfg(tmp_path / "t"), torch.device("cpu"))
    meta = {"resnet_size": 50, "num_classes": 10, "use_se_block": True,
            "use_sk_block": True, "dropblock_stages": [3, 4]}
    t2 = loop._teacher_model_config(
        _kd_cfg(tmp_path, kd_teacher_use_sk_block="false", kd_teacher_resnet_size=101,
                kd_teacher_anti_alias_type="sconv"), meta)
    assert t2.use_se_block and not t2.use_sk_block and t2.resnet_size == 101
    assert t2.anti_alias_type == "sconv" and t2.dropblock_stages == (3, 4)
    with pytest.raises(ValueError, match="head"):
        loop._teacher_model_config(_kd_cfg(tmp_path), {"num_classes": 1001})
    with pytest.raises(ValueError, match="kd_teacher_use_se_block"):
        loop._teacher_model_config(_kd_cfg(tmp_path, kd_teacher_use_se_block="maybe"), None)


def test_missing_teacher_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no teacher checkpoint"):
        loop._load_teacher(_kd_cfg(tmp_path / "none"), torch.device("cpu"))


def test_sidecar_teacher_config_matches_the_reference(tmp_path):
    """Both packages resolve the same teacher config from the same sidecar
    and flags."""
    from axcnn.train.loop import _teacher_model_config as j_teacher_cfg
    from axcnn.utils import config as jconfig
    from axcnn_torch.utils import config as tconfig

    argv = ["--model.num_classes=10", "--train.kd_teacher_use_sk_block=false",
            "--train.kd_teacher_anti_alias_type=proj"]
    meta = dataclasses.asdict(ModelConfig(num_classes=10, use_se_block=True,
                                          use_sk_block=True, width_multiplier=0.5))
    meta["dropblock_stages"] = list(meta["dropblock_stages"])  # as JSON has it
    got = loop._teacher_model_config(tconfig.parse_cli(argv), meta)
    want = j_teacher_cfg(jconfig.parse_cli(argv), meta)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# one KD step and one accumulated step against the reference
# ---------------------------------------------------------------------------

def _teacher_trees(seed):
    """Reference teacher params and BN state: He-scaled, perturbed BN."""
    p_shape, s_shape = jax.eval_shape(
        lambda k: resnet_init(k, JModelConfig(**TEACHER_CFG)), jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name in ("gamma", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ("beta", "mean", "b"):
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.standard_normal(leaf.shape) * (2.0 / fan_in) ** 0.5).astype(np.float32)

    return (jax.tree_util.tree_map_with_path(fill, p_shape),
            jax.tree_util.tree_map_with_path(fill, s_shape))


def _draws(accum, step=STEP):
    """The reference's lambda and DropBlock uniforms for ``step``: one set,
    or one per micro-batch from ``fold_in(rng("accum"), i)``."""
    step_rng = JRngStream(jax.random.key(ROOT_KEY)).fold_step(jnp.int32(step))
    if not accum:
        rngs, n = [step_rng], N
    else:
        base = step_rng("accum")
        rngs, n = [JRngStream(jax.random.fold_in(base, i)) for i in range(A)], N // A
    lams, unis = [], []
    for r in rngs:
        lams.append(np.asarray(jax.random.beta(r("mixup"), 0.2, 0.2, dtype=jnp.float32)))
        unis.append({site: np.array(jax.random.uniform(r(site), (n, hw, hw, 1),
                                                       jnp.float32))[..., 0]
                     for site, hw in SITES.items()})
    return lams, unis


def _port_teacher(t_params, t_state, dtype):
    teacher = ResNet(ModelConfig(**TEACHER_CFG))
    teacher.load_state_dict(from_axcnn(t_params, t_state, ModelConfig(**TEACHER_CFG)))
    return teacher.to(dtype, memory_format=torch.channels_last).eval().requires_grad_(False)


def _port_state(jstate, dtype):
    tstate = train_state_from_axcnn(jstate, ModelConfig(**CFG))
    tstate.model.to(dtype)
    tstate.velocity = {k: v.to(dtype) for k, v in tstate.velocity.items()}
    tstate.ema = {k: v.to(dtype) for k, v in tstate.ema.items()}
    return tstate


def _port_draws(draws, accum, dtype):
    """The reference's draws as the port's ``lam=``/``dropblock_uniforms=``
    take them: one entry per micro-batch under accumulation."""
    lams, unis = draws
    lams = [np.asarray(lam, np.float32 if dtype == torch.float32 else np.float64)[()]
            for lam in lams]
    unis = [{k: torch.from_numpy(u).to(dtype) for k, u in d.items()} for d in unis]
    return (lams, unis) if accum else (lams[0], unis[0])


def _port_step(jstate, kind, trees, draws, dtype):
    """The port's step of ``kind`` (``kd``, ``accum`` or ``kd_accum``) from
    the reference's state, batch and draws, with every float in ``dtype``."""
    accum = "accum" in kind
    extra = dict(grad_accum_steps=A) if accum else {}
    if "kd" in kind:
        extra.update(teacher=_port_teacher(*trees, dtype), **KD_KW)
    tstep = make_train_step(ModelConfig(**CFG), lr_schedule=t_lr(**LR_KW),
                            policy=Policy(dtype, dtype), **STEP_KW, **extra)
    lams, unis = _port_draws(draws, accum, dtype)
    tbatch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    tstate, metrics = tstep(_port_state(jstate, dtype), tbatch, 0, lam=lams,
                            dropblock_uniforms=unis)
    got = jax.tree.map(lambda a: np.asarray(a, np.float64), train_state_to_axcnn(tstate))
    return got, metrics


def _f64(a):
    return np.asarray(a, np.float64) if a.dtype.kind == "f" else a


class _Float64Numpy:
    """numpy with ``float32`` re-pointed to ``float64``, for the modules where
    the port computes its host scalars (lr, EMA decay, DropBlock rate,
    progress, lambda) in fp32 as the reference does on the device."""
    float32 = np.float64

    def __getattr__(self, name):
        return getattr(np, name)


_UNIFORM, _BETA = jax.random.uniform, jax.random.beta


def _uniform_fp32(key, shape=(), dtype=None, minval=0.0, maxval=1.0):
    return _UNIFORM(key, shape, np.float32, minval, maxval).astype(dtype or jnp.float32)


def _beta_fp32(key, a, b, shape=None, dtype=None):
    return _BETA(key, a, b, shape, np.float32).astype(dtype or jnp.float32)


@contextlib.contextmanager
def _float64():
    """Both packages in float64: x64 on, and every fp32 cast re-pointed,
    the port's host scalars included. The random draws (mixup's lambda,
    DropBlock's uniforms) stay fp32 values, so a kind's fp32 and float64
    runs all see the same draws."""
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "float32", jnp.float64)
        mp.setattr(torch.Tensor, "float", lambda self: self.double())
        for module in (t_dropblock, t_ema, t_schedules, t_train_step):
            mp.setattr(module, "np", _Float64Numpy())
        mp.setattr(jax.random, "uniform", _uniform_fp32)
        mp.setattr(jax.random, "beta", _beta_fp32)
        yield


def _reference_step(kind, trees, lr_kw=LR_KW, step_kw=STEP_KW, kd_kw=KD_KW):
    """The reference's jitted ``make_train_step`` of ``kind``, in float64
    (call it inside ``_float64``)."""
    extra = dict(grad_accum_steps=A) if "accum" in kind else {}
    if "kd" in kind:
        extra.update(teacher=(JModelConfig(**TEACHER_CFG), *jax.tree.map(_f64, trees)),
                     **kd_kw)
    policy = JPolicy(param_dtype=jnp.float32, compute_dtype=jnp.float32)
    return jax.jit(j_make_train_step(JModelConfig(**CFG), lr_schedule=j_lr(**lr_kw),
                                     policy=policy, **step_kw, **extra))


@pytest.fixture(scope="module", params=["kd", "accum", "kd_accum"])
def step_run(request):
    """The reference's jitted step in float64 (its fp32 casts re-pointed),
    once per kind, and the port's step from the same state, batch and draws
    in float64 (its fp32 casts re-pointed) and in fp32."""
    kind = request.param
    jstate = _reference_state({"kd": 81, "accum": 82, "kd_accum": 85}[kind])
    trees = _teacher_trees(83) if "kd" in kind else None
    with _float64():
        j_in = jax.tree.map(_f64, jstate)
        j_new, j_metrics = _reference_step(kind, trees)(j_in, _batch(),
                                                         jax.random.key(ROOT_KEY))
        j_new = jax.tree.map(np.asarray, j_new)
        j_metrics = jax.device_get(j_metrics)
        draws = _draws(accum="accum" in kind)
        got64 = _port_step(jstate, kind, trees, draws, torch.float64)
    got32 = _port_step(jstate, kind, trees, draws, torch.float32)
    return dict(kind=request.param, old=j_in, want=j_new, want_metrics=j_metrics,
                got={"fp64": got64, "fp32": got32})


DTYPES = ["fp32", "fp64"]


def _leg(run, dtype):
    """``run`` seen as tests/test_torch_train_step.py's helpers expect it."""
    state, metrics = run["got"][dtype]
    return dict(old=run["old"], want=run["want"], got=state, got_metrics=metrics,
                want_metrics=run["want_metrics"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_metrics_match(step_run, dtype):
    leg = _leg(step_run, dtype)
    want, got = leg["want_metrics"], leg["got_metrics"]
    f64 = dtype == "fp64"
    assert set(got) == set(want) == {"loss", "lr", "train_top1", "mixup_lam"}
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-7 if f64 else 1e-5)
    np.testing.assert_allclose(got["lr"], float(want["lr"]), rtol=1e-6)
    assert float(got["train_top1"]) == float(want["train_top1"])
    np.testing.assert_allclose(got["mixup_lam"], float(want["mixup_lam"]), rtol=1e-7)
    assert 0 < got["mixup_lam"] < 1
    assert leg["got"]["step"] == leg["want"].step == STEP + 1


@pytest.mark.parametrize("field", ["params", "velocity", "ema"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_update_matches(step_run, dtype, field):
    """float64: per leaf <= 1e-6 (the EMA to rtol/atol 1e-7, as its update is
    1e-4 of the weights). fp32: the port's fp32 step is as near the exact
    step as the reference's own fp32 runs are to each other."""
    leg = _leg(step_run, dtype)
    errs = _update_errors(leg, field)
    worst = max(errs, key=errs.get)
    med = float(np.median(list(errs.values())))
    print(f"{step_run['kind']} {dtype} {field}: worst leaf {errs[worst]:.3g} "
          f"({worst}), median {med:.3g}")
    if dtype == "fp32":
        assert errs[worst] <= 5e-2, (worst, errs[worst])
        assert med <= 5e-3
    elif field == "ema":
        want, got = _leaves(leg["want"].ema), _leaves(leg["got"]["ema"])
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-7, atol=1e-7, err_msg=k)
    else:
        assert errs[worst] <= 1e-6, (worst, errs[worst])


@pytest.mark.parametrize("dtype", DTYPES)
def test_bn_statistics_match(step_run, dtype):
    """Under accumulation the moving statistics move twice, micro by micro."""
    leg = _leg(step_run, dtype)
    f64 = dtype == "fp64"
    want, got = _leaves(leg["want"].model_state), _leaves(leg["got"]["model_state"])
    old = _leaves(leg["old"].model_state)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-7 if f64 else 1e-5,
                                   atol=1e-10 if f64 else 1e-6, err_msg=k)
    assert any(_rel_l2(want[k], old[k]) > 1e-4 for k in want)  # they moved


def test_kd_term_changes_the_step():
    """A KD step's gradient differs from the same step without the teacher by
    far more than the tolerances above: the parity covers the KD term."""
    jstate, trees = _reference_state(81), _teacher_trees(83)
    draws = [[np.float32(0.3)], [{k: np.asarray(u, np.float32) for k, u in
                                  _draws(accum=False)[1][0].items()}]]
    kd_state, kd_m = _port_step(jstate, "kd", trees, draws, torch.float32)
    cfg = ModelConfig(**CFG)
    tstate = train_state_from_axcnn(jstate, cfg)
    tstep = make_train_step(cfg, lr_schedule=t_lr(**LR_KW), **STEP_KW)
    tbatch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    tstate, m = tstep(tstate, tbatch, 0, lam=draws[0][0], dropblock_uniforms={
        k: torch.from_numpy(u) for k, u in draws[1][0].items()})
    plain = _leaves(train_state_to_axcnn(tstate)["velocity"])
    kd = _leaves(kd_state["velocity"])
    assert float(m["loss"]) < float(kd_m["loss"])
    assert max(_rel_l2(kd[k], plain[k]) for k in kd) > 1e-2


# the learning rates of the KD preset's 3-step run: 0.1 x 1024/256, its
# 5-epoch warm-up cut to the run (lr 0, 0.133, 0.267), and its kd_temp and
# kd_alpha
PRESET_STEPS = 3
PRESET_LR = dict(base_lr=0.1 * 1024 / 256, total_steps=PRESET_STEPS,
                 warmup_steps=PRESET_STEPS)
PRESET_KD = dict(kd_temp=1.0, kd_alpha=1.0)


@pytest.fixture(scope="module")
def trajectory_start():
    """What every trajectory starts from, made once: the reference's fresh
    init (``zero_gamma``: every bn3 gamma 0, velocity 0), the teacher's
    trees, a new batch for each step, and the port's float64 copy of the
    init (a trajectory steps a deep copy of it)."""
    jstate = jax.device_get(j_create_train_state(jax.random.key(86), JModelConfig(**CFG)))
    batches = []
    for k in range(PRESET_STEPS):
        rng = np.random.default_rng(90 + k)
        batches.append({"images": rng.integers(0, 256, (N, 64, 64, 3), dtype=np.uint8),
                        "labels": rng.integers(0, 10, N).astype(np.int32)})
    with _float64():
        port = _port_state(jstate, torch.float64)
    return dict(jstate=jstate, trees=_teacher_trees(83), batches=batches, port=port)


def _trajectory(kd_kw, start):
    """Three KD steps under accumulation from ``start`` (the
    ``trajectory_start`` fixture), at ``PRESET_LR``: the reference's and the
    port's losses and final states, both in float64, the port's with the
    reference's draws."""
    step_kw = {**STEP_KW, "total_steps": PRESET_STEPS}
    jstate, trees, batches = start["jstate"], start["trees"], start["batches"]
    with _float64():
        j = jax.tree.map(_f64, jstate)
        jstep = _reference_step("kd_accum", trees, lr_kw=PRESET_LR, step_kw=step_kw,
                                kd_kw=kd_kw)
        t = copy.deepcopy(start["port"])
        tstep = make_train_step(ModelConfig(**CFG), lr_schedule=t_lr(**PRESET_LR),
                                policy=Policy(torch.float64, torch.float64), **step_kw,
                                teacher=_port_teacher(*trees, torch.float64),
                                grad_accum_steps=A, **kd_kw)
        want, got = [], []
        for k, batch in enumerate(batches):
            j, jm = jstep(j, batch, jax.random.key(ROOT_KEY))
            lams, unis = _port_draws(_draws(accum=True, step=k), True, torch.float64)
            t, tm = tstep(t, {n: torch.from_numpy(v) for n, v in batch.items()}, 0,
                          lam=lams, dropblock_uniforms=unis)
            want.append(float(jm["loss"]))
            got.append(float(tm["loss"]))
        got_state = jax.tree.map(np.asarray, train_state_to_axcnn(t))  # its casts re-pointed
    old = jax.tree.map(_f64, jstate)
    return dict(old=old, want=jax.tree.map(np.asarray, j), want_losses=want,
                got=got_state, got_losses=got)


@pytest.mark.parametrize("kd_alpha", [1.0, 0.0])
def test_kd_accum_losses_follow_the_reference_over_three_steps(trajectory_start, kd_alpha):
    """The KD step under accumulation, three steps at the learning rates of
    the KD preset's 3-step run, from a fresh init: in float64 the port's loss
    at every step, and its parameters and velocity after the last, agree with
    the reference's to <= 1e-6. ``kd_alpha=0`` is the control without the KD
    term."""
    run = _trajectory({**PRESET_KD, "kd_alpha": kd_alpha}, trajectory_start)
    print(f"kd_alpha={kd_alpha} losses: reference {run['want_losses']}, "
          f"port {run['got_losses']}")
    np.testing.assert_allclose(run["got_losses"], run["want_losses"], rtol=1e-6)
    assert run["got"]["step"] == run["want"].step == PRESET_STEPS
    for field in ("params", "velocity"):
        errs = _update_errors(run, field)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 1e-6, (field, worst, errs[worst])


def test_accumulation_refuses_an_uneven_batch_and_wrong_draws():
    cfg = ModelConfig(**CFG)
    state = create_train_state(cfg, generator=torch.Generator().manual_seed(0),
                               device="cpu")
    step = make_train_step(cfg, lr_schedule=t_lr(**LR_KW), **STEP_KW, grad_accum_steps=3)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    with pytest.raises(ValueError, match="not divisible by grad_accum_steps 3"):
        step(state, batch, 0)
    step2 = make_train_step(cfg, lr_schedule=t_lr(**LR_KW), **STEP_KW, grad_accum_steps=2)
    with pytest.raises(ValueError, match="one per micro-batch"):
        step2(state, batch, 0, lam=[0.5])
    with pytest.raises(ValueError, match="grad_accum_steps must be >= 1"):
        make_train_step(cfg, lr_schedule=t_lr(**LR_KW), total_steps=10, grad_accum_steps=0)
