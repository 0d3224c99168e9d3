"""Spatial partitioning with the options of the one-rank step, on the CPU.

The step on the ``(D, S) = (2, 2)`` grid: four Gloo ranks (this file run as
a script), started once for the module, every leg run inside the same rank
processes, each process with a timeout of its own (a collective issued out
of order hangs rather than fails). The assembled ResNet-50 at width 0.125,
128x128, global batch 8, in float64 (the port's fp32 casts re-pointed, the
state itself turned to float64), step 5 of 10 with DropBlock and mixup on.
Batch 8, so that a micro-batch under accumulation holds 4 images: with 2,
mixup pairs the micro-batch's two images with each other and the update of
a bias (``stage1.block1.se.fc1.bias``) cancels, so far that two one-rank
steps that differ only in memory format lie 2.1e-10 apart on it, above the
bound; at 4 that floor is 3e-12.
Against the port's one-rank step with the same option on the global batch,
relative 1e-10 per tensor of the update and of the BN statistics, loss
1e-10, top-1 and lambda equal (the bounds of tests/test_torch_spatial.py):

- ``accum``: ``grad_accum_steps=2``; each micro-batch of 4 spans both data
  shards, so each data rank takes two images of it (the regather);
- ``remat``: ``remat="blocks"``, whose replay reissues the regions' halos,
  pooled sums and sync-BN all-reduces in the backward;
- ``aa``: device AutoAugment with injected draws, one group spanning both
  data shards;
- ``kd``: a KD teacher (an assembled R50 at width 0.125, eval BN);
- ``bl``: Big-Little stages (alpha 2, beta 4; the site
  ``dropblock/stage3/out``);
- ``int8``: the int8 evaluation: top-1 and top-5 counts equal, the logits
  within 1e-10.

The slice as a whole, ``grad_accum_steps=2`` with ``remat="blocks"``,
against the reference's jitted unsharded float64 step (``axis_name=None``)
with its lambda and DropBlock uniforms per micro-batch injected, at the
bounds of test_spatial_step_matches_the_reference. The other options reach
the reference through the tests that pin their one-rank steps
(tests/test_torch_train_step.py, test_torch_kd.py, test_torch_bl.py,
test_torch_int8.py). In one process: the regathered micro-batches' rows,
the AutoAugment applicator on data shards against the whole batch, and the
int8 conv on shards cut from one tensor against the unsharded accumulators.
"""

import contextlib
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent.parent
if __name__ == "__main__":  # a rank: the port only
    sys.path.insert(0, str(REPO))

from axcnn_torch.core.dtypes import Policy  # noqa: E402
from axcnn_torch.data.autoaugment import POLICIES  # noqa: E402
from axcnn_torch.data.autoaugment_device import (draw_autoaugment,  # noqa: E402
                                                 make_device_autoaugment)
from axcnn_torch.models.resnet import ModelConfig, ResNet  # noqa: E402
from axcnn_torch.ops import conv as oconv  # noqa: E402
from axcnn_torch.parallel import spatial as sp  # noqa: E402
from axcnn_torch.train.schedules import make_lr_schedule as t_lr  # noqa: E402
from axcnn_torch.train.train_step import (create_train_state, eval_logits,  # noqa: E402
                                          make_eval_step, make_train_step)
import torch_inprocess

capped_threads = torch_inprocess.capped_threads

CFG = dict(width_multiplier=0.125, num_classes=10, use_resnet_d=True,
           use_se_block=True, use_sk_block=True, anti_alias_type="sconv",
           use_dropblock=True, dropblock_keep_prob=0.5, zero_gamma=True)
TEACHER_CFG = dict(width_multiplier=0.125, num_classes=10, use_resnet_d=True,
                   use_se_block=True, use_sk_block=True, anti_alias_type="sconv")
N, SIZE, STEP, TOTAL, A = 8, 128, 5, 10, 2
GRID = (2, 2)  # (D, S)
STEP_KW = dict(total_steps=TOTAL, label_smoothing=0.1, mixup_alpha=0.2,
               weight_decay=1e-4, momentum=0.9, use_ema=True, ema_decay=0.9999)
LR_KW = dict(base_lr=0.1 * N / 256, total_steps=TOTAL, warmup_steps=2)
KD_KW = dict(kd_temp=2.0, kd_alpha=0.5)
# the R50's DropBlock sites at 128x128: (site, its map's side)
SITES = {f"dropblock/stage{s}/block{b}": SIZE // 4 // 2 ** (s - 1)
         for s, blocks in ((3, 6), (4, 3)) for b in range(blocks)}
TRAIN_LEGS = ("accum", "remat", "aa", "kd", "bl")
ROOT_KEY = 73
RANK_TIMEOUT_S = 240
F64 = Policy(param_dtype=torch.float64, compute_dtype=torch.float64)
INT8_F64 = Policy(param_dtype=torch.float64, compute_dtype=torch.float64, quantize_conv=True)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rel(a, b):
    a, b = (torch.as_tensor(t, dtype=torch.float64).detach() for t in (a, b))
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


@contextlib.contextmanager
def _fp32_casts_to_float64():
    to_float = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        yield
    finally:
        torch.Tensor.float = to_float


# ---------------------------------------------------------------------------
# the legs (run by the ranks and, on the global batch, by the test process)
# ---------------------------------------------------------------------------

def _cfg(leg):
    extra = {"remat": "blocks"} if leg in ("remat", "whole") else {}
    if leg == "bl":
        extra = dict(bl_alpha=2, bl_beta=4)
    return ModelConfig(**CFG, **extra)


def _state(payload, leg):
    """The leg's float64 state at step 5."""
    cfg = _cfg(leg)
    saved = payload["states"]["bl" if leg == "bl" else "base"]
    state = create_train_state(cfg, generator=torch.Generator(), device="cpu")
    state.model.load_state_dict(saved["model"])
    state.model.double()
    state.velocity = {k: v.double() for k, v in saved["velocity"].items()}
    state.ema = {k: v.double() for k, v in saved["ema"].items()}
    state.step = STEP
    return cfg, state


def _teacher(payload):
    teacher = ResNet(ModelConfig(**TEACHER_CFG))
    teacher.load_state_dict(payload["teacher"])
    return teacher.double().to(memory_format=torch.channels_last).eval().requires_grad_(False)


def _tensors(state, metrics):
    return {"params": {k: p.detach() for k, p in state.model.named_parameters()},
            "buffers": dict(state.model.named_buffers()), "velocity": state.velocity,
            "ema": state.ema, "step": state.step,
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _train_leg(leg, payload, images, labels, group=None, spatial=None):
    """The port's float64 step of ``leg``: the one-rank step on the global
    batch, or with ``spatial`` the rank's on its data shard ``images``."""
    cfg, state = _state(payload, leg)
    kw, call = {}, {}
    if leg in ("accum", "whole"):
        kw["grad_accum_steps"] = A
    if leg == "kd":
        kw.update(teacher=_teacher(payload), **KD_KW)
    if leg == "aa":
        kw["autoaugment_fn"] = make_device_autoaugment("v0", num_groups=1)
        call["aa_draws"] = payload["aa_draws"]
    if leg == "whole":
        # micro-batch i's uniforms are its M images' maps, the global
        # micro-batch's on every rank
        call["lam"] = payload["lams"]
        call["dropblock_uniforms"] = payload["uniforms"]
    step = make_train_step(cfg, lr_schedule=t_lr(**LR_KW), policy=F64, group=group,
                           spatial=spatial, **STEP_KW, **kw)
    with _fp32_casts_to_float64():
        state, metrics = step(state, {"images": images, "labels": labels}, ROOT_KEY, **call)
    return _tensors(state, metrics)


def _int8_leg(payload, images, labels, group=None, spatial=None):
    """The int8 evaluation (EMA weights) of ``images``: logits and sums."""
    cfg, state = _state(payload, "int8")
    batch = {"images": images, "labels": labels}
    with _fp32_casts_to_float64():
        logits = eval_logits(state, images, policy=INT8_F64, use_ema=True, spatial=spatial)
        ev = make_eval_step(cfg, policy=INT8_F64, use_ema=True, group=group,
                            spatial=spatial)(state, batch)
    return {"logits": logits, "eval": {k: float(v) for k, v in ev.items()}}


def _rank_main(rank, world, port, workdir):
    from axcnn_torch.parallel import mesh

    torch.set_num_threads(torch_inprocess.THREADS)
    mesh.init_distributed("cpu", rank=rank, world_size=world, coordinator=f"127.0.0.1:{port}")
    try:
        ctx = sp.make_spatial_context(GRID[1])
        payload = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
        n = N // ctx.data_parts
        rows = slice(ctx.data_index * n, (ctx.data_index + 1) * n)
        images, labels = payload["images"][rows], payload["labels"][rows]
        group = mesh.data_group()
        out = {"grid": (ctx.data_index, ctx.index),
               "micro": ctx.micro_batches(images, labels, steps=A)}
        for leg in TRAIN_LEGS + ("whole",):
            out[leg] = _train_leg(leg, payload, images, labels, group=group, spatial=ctx)
        out["int8"] = _int8_leg(payload, images, labels, group=group, spatial=ctx)
    finally:
        mesh.shutdown()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


# ---------------------------------------------------------------------------
# the test side (imports the reference)
# ---------------------------------------------------------------------------

def _reference_state(seed):
    """The reference's TrainState at step 5 (as tests/test_torch_spatial.py
    builds it), in float64."""
    import jax

    from axcnn.models.resnet import ModelConfig as JModelConfig
    from axcnn.models.resnet import resnet_init
    from axcnn.train.train_step import TrainState as JTrainState

    p_shape, s_shape = jax.eval_shape(lambda k: resnet_init(k, JModelConfig(**CFG)),
                                      jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, parent = path[-1].key, path[-2].key
        shape = leaf.shape
        if name == "gamma":
            lo, hi = (0.1, 0.3) if parent == "bn3" else (0.5, 1.5)
            return rng.uniform(lo, hi, shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape)
        if name in ("beta", "mean") or name.startswith("b"):
            return 0.1 * rng.standard_normal(shape)
        fan_in = int(np.prod(shape[:-1]))
        gain = 2.0 if len(shape) == 4 else 1.0
        return rng.standard_normal(shape) * (gain / fan_in) ** 0.5

    f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32).astype(np.float64), t)  # noqa: E731
    params = f32(jax.tree_util.tree_map_with_path(fill, p_shape))
    state = f32(jax.tree_util.tree_map_with_path(fill, s_shape))
    velocity = f32(jax.tree.map(lambda p: 0.01 * rng.standard_normal(p.shape), params))
    ema = f32(jax.tree.map(lambda p: p + 0.01 * rng.standard_normal(p.shape), params))
    return JTrainState(step=np.int32(STEP), params=params, model_state=state,
                       velocity=velocity, ema=ema)


def _perturbed(model, seed):
    """A port model's weights and BN statistics, perturbed as the
    reference's state above is (BN away from its init, ``bn3`` gamma small
    but not zero)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            u = torch.rand(t.shape, generator=gen, dtype=t.dtype)
            if name.endswith("running_var"):
                t.copy_(0.5 + u)
            elif name.endswith("running_mean") or name.endswith("bias"):
                t.copy_(0.2 * u - 0.1)
            elif name.endswith("weight") and t.dim() == 1:
                t.copy_(0.1 + 0.2 * u if ".bn3." in name else 0.5 + u)
    return model.state_dict()


def _port_payload_state(model, seed):
    gen = torch.Generator().manual_seed(seed)
    params = dict(model.named_parameters())
    return {"model": model.state_dict(),
            "velocity": {k: 0.01 * torch.randn(p.shape, generator=gen) for k, p in params.items()},
            "ema": {k: p.detach() + 0.01 * torch.randn(p.shape, generator=gen)
                    for k, p in params.items()}}


def _aa_draws():
    """One group of the whole batch (it spans both data shards): sub-policy
    0 (Equalize, ShearY), each op on some images of each data shard."""
    (_, _, signs), = draw_autoaugment(np.random.default_rng(97), len(POLICIES["v0"]), 1, N)
    coins = np.array([[0.0, 0.9, 0.0, 0.9, 0.9, 0.0, 0.9, 0.0],
                      [0.9, 0.0, 0.0, 0.9, 0.0, 0.9, 0.9, 0.0]], np.float32)
    return [(0, coins, signs)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks (in the background), the reference's jitted unsharded step
    with A = 2 and remat, and the port's one-rank step of every leg."""
    import jax
    import jax.numpy as jnp

    from axcnn.core.dtypes import Policy as JPolicy
    from axcnn.core.rng import RngStream as JRngStream
    from axcnn.models.resnet import ModelConfig as JModelConfig
    from axcnn.train.schedules import make_lr_schedule as j_lr
    from axcnn.train.train_step import make_train_step as j_make_train_step
    from axcnn_torch.ckpt.convert import train_state_from_axcnn, train_state_to_axcnn

    workdir = tmp_path_factory.mktemp("spatial_options")
    rng = np.random.default_rng(92)
    batch = {"images": rng.integers(0, 256, (N, SIZE, SIZE, 3), dtype=np.uint8),
             "labels": rng.integers(0, 10, N).astype(np.int32)}
    root_key = jax.random.key(ROOT_KEY)
    jstate = _reference_state(93)
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "float32", jnp.float64)
        # the reference's micro-batch streams: fold_in(rng("accum"), i)
        base = JRngStream(root_key).fold_step(jnp.int32(STEP))("accum")
        micro = [JRngStream(jax.random.fold_in(base, i)) for i in range(A)]
        lams = [np.asarray(jax.random.beta(r("mixup"), 0.2, 0.2, dtype=jnp.float32))[()]
                for r in micro]
        unis = [{site: torch.from_numpy(np.array(jax.random.uniform(
            r(site), (N // A, hw, hw, 1), jnp.float32))[..., 0]) for site, hw in SITES.items()}
            for r in micro]
        tstate = train_state_from_axcnn(jstate, ModelConfig(**CFG))
    bl = ResNet(_cfg("bl"), generator=torch.Generator().manual_seed(94))
    _perturbed(bl, 95)
    teacher = ResNet(ModelConfig(**TEACHER_CFG), generator=torch.Generator().manual_seed(96))
    payload = {"states": {"base": {"model": tstate.model.state_dict(),
                                   "velocity": tstate.velocity, "ema": tstate.ema},
                          "bl": _port_payload_state(bl, 98)},
               "teacher": _perturbed(teacher, 99), "aa_draws": _aa_draws(),
               "lams": lams, "uniforms": unis,
               "images": torch.from_numpy(batch["images"]),
               "labels": torch.from_numpy(batch["labels"]).long()}
    torch.save(payload, workdir / "inputs.pt")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    world, port = GRID[0] * GRID[1], _free_port()
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world), str(port),
                               str(workdir)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
            mp.setattr(jnp, "float32", jnp.float64)
            policy = JPolicy(param_dtype=jnp.float32, compute_dtype=jnp.float32)
            jstep = jax.jit(j_make_train_step(
                JModelConfig(**CFG, remat="blocks"), lr_schedule=j_lr(**LR_KW), policy=policy,
                grad_accum_steps=A, **STEP_KW))
            j_new, j_metrics = jstep(jstate, batch, root_key)
            want = (jstate, jax.tree.map(np.asarray, j_new), jax.device_get(j_metrics))
        images, labels = payload["images"], payload["labels"]
        one = {leg: _train_leg(leg, payload, images, labels)
               for leg in TRAIN_LEGS}
        one["int8"] = _int8_leg(payload, images, labels)
        outs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    ranks = [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(world)]

    out = ranks[0]["whole"]
    _, state = _state(payload, "whole")
    state.model.load_state_dict({**out["params"], **out["buffers"]})
    state.velocity, state.ema, state.step = out["velocity"], out["ema"], out["step"]
    with pytest.MonkeyPatch.context() as mp:  # the converter's fp32 cast, re-pointed
        mp.setattr(torch.Tensor, "float", lambda self: self.double())
        tree = jax.tree.map(lambda a: np.asarray(a, np.float64), train_state_to_axcnn(state))
    return dict(want=want, tree=tree, one=one, ranks=ranks, payload=payload)


def _fields(out):
    return {"params": out["params"], "velocity": out["velocity"], "ema": out["ema"],
            "buffers": out["buffers"]}


@pytest.mark.parametrize("leg", TRAIN_LEGS)
def test_spatial_option_step_equals_the_one_rank_step(runs, leg):
    """Loss, every parameter's update, the velocity, the EMA and the BN
    moving statistics, relative 1e-10 per tensor (of the update where one
    is taken); top-1 and lambda equal."""
    one, got = runs["one"][leg], runs["ranks"][0][leg]
    _, old = _state(runs["payload"], leg)
    olds = {"params": dict(old.model.named_parameters()), "velocity": old.velocity,
            "ema": old.ema, "buffers": dict(old.model.named_buffers())}
    assert abs(got["metrics"]["loss"] - one["metrics"]["loss"]) <= 1e-10 * one["metrics"]["loss"]
    assert got["metrics"]["train_top1"] == one["metrics"]["train_top1"]
    assert got["metrics"]["mixup_lam"] == one["metrics"]["mixup_lam"]
    worst = {}
    for field, tensors in _fields(one).items():
        for k, want in tensors.items():
            base = olds[field][k].detach().double()
            worst[(field, k)] = _rel(got[field][k].double() - base, want.double() - base)
    key = max(worst, key=worst.get)
    print(f"{leg}: worst {key}: {worst[key]:.3g}")
    assert worst[key] <= 1e-10, (key, worst[key])


@pytest.mark.parametrize("leg", TRAIN_LEGS + ("whole",))
def test_spatial_option_ranks_end_the_step_alike(runs, leg):
    """Every rank of the grid holds the same state and metrics after the
    step (replicas)."""
    ranks = [r[leg] for r in runs["ranks"]]
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        for field, tensors in _fields(ranks[0]).items():
            for k, t in tensors.items():
                assert torch.equal(r[field][k], t), (field, k)


def test_spatial_int8_eval_equals_the_one_rank_eval(runs):
    """Each rank's int8 logits are its data shard's rows of the one-rank
    int8 logits within 1e-10; the sums over the data column count each
    image once, with the one-rank eval's top-1 and top-5 counts."""
    one = runs["one"]["int8"]
    n = N // GRID[0]
    for r in runs["ranks"]:
        d = r["grid"][0]
        assert _rel(r["int8"]["logits"], one["logits"][d * n:(d + 1) * n]) <= 1e-10
        got = r["int8"]["eval"]
        assert got["count"] == one["eval"]["count"] == N
        assert got["top1"] == one["eval"]["top1"] and got["top5"] == one["eval"]["top5"]
        assert abs(got["loss_sum"] - one["eval"]["loss_sum"]) <= 1e-10 * abs(one["eval"]["loss_sum"])


def test_spatial_accum_remat_step_matches_the_reference(runs):
    """``grad_accum_steps=2`` with ``remat="blocks"`` on the D2xS2 grid
    against the reference's jitted unsharded step, float64: loss rtol 1e-7,
    the update and the velocity <= 1e-6 per leaf, BN statistics rtol 1e-7,
    EMA rtol and atol 1e-7 (the bounds of test_spatial_step_matches_the_reference)."""
    import jax

    def leaves(tree):
        return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(tree)}

    old, new, jm = runs["want"]
    tree, tm = runs["tree"], runs["ranks"][0]["whole"]["metrics"]
    np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=1e-7)
    assert tm["train_top1"] == float(jm["train_top1"])
    np.testing.assert_allclose(tm["mixup_lam"], float(jm["mixup_lam"]), rtol=1e-7)
    for field in ("params", "velocity"):
        o, n, p = leaves(getattr(old, field)), leaves(getattr(new, field)), leaves(tree[field])
        assert set(p) == set(n)
        errs = {k: _rel(torch.from_numpy(np.asarray(p[k] - o[k])),
                        torch.from_numpy(np.asarray(n[k] - o[k]))) for k in n}
        k = max(errs, key=errs.get)
        assert errs[k] <= 1e-6, (field, k, errs[k])
    ref, mine = leaves(new.model_state), leaves(tree["model_state"])
    for k in ref:
        np.testing.assert_allclose(mine[k], ref[k], rtol=1e-7, atol=1e-10, err_msg=k)
    ref, mine = leaves(new.ema), leaves(tree["ema"])
    for k in ref:
        np.testing.assert_allclose(mine[k], ref[k], rtol=1e-7, atol=1e-7, err_msg=k)


def test_micro_batches_are_the_global_batch_rows(runs):
    """Rank (d, s)'s part of micro-batch i is global rows
    ``[i*M + d*M/D, i*M + (d+1)*M/D)``, ``M = N / A``: the regather over the
    column."""
    payload, (dd, _) = runs["payload"], GRID
    m = N // A
    for r in runs["ranks"]:
        d = r["grid"][0]
        assert len(r["micro"]) == A
        for i, (images, labels) in enumerate(r["micro"]):
            rows = slice(i * m + d * m // dd, i * m + (d + 1) * m // dd)
            assert torch.equal(images, payload["images"][rows])
            assert torch.equal(labels, payload["labels"][rows])


# ---------------------------------------------------------------------------
# in one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_groups,shards", [(1, 2), (2, 2), (2, 4), (4, 2), (8, 4), (3, 2)])
def test_autoaugment_on_data_shards_takes_the_global_draws(num_groups, shards):
    """The applicator on each data shard with ``rows=(start, total)`` and
    the whole batch's draws gives the whole batch's output rows, bit for
    bit: the groups are the global batch's, boundaries included (8 images;
    3 groups do not divide them: one group)."""
    n = 8
    fn = make_device_autoaugment("v0", num_groups=num_groups)
    gen = np.random.default_rng(num_groups * 10 + shards)
    images = torch.from_numpy(gen.integers(0, 256, (n, 24, 20, 3), dtype=np.uint8))
    g = n // num_groups if n % num_groups == 0 else n
    draws = draw_autoaugment(gen, len(POLICIES["v0"]), n // g, g)
    whole = fn(images, draws=draws)
    k = n // shards
    parts = [fn(images[d * k:(d + 1) * k], draws=draws, rows=(d * k, n)) for d in range(shards)]
    assert torch.equal(torch.cat(parts), whole)
    assert not torch.equal(whole, images.float())  # some op applied


@pytest.mark.parametrize("k,stride,dilation", [(3, 1, 1), (3, 2, 1), (3, 1, 2), (5, 2, 1),
                                               (1, 2, 1), (3, 2, 2)])
def test_int8_conv_on_shards_gives_the_unsharded_accumulators(k, stride, dilation):
    """The int8 conv on S = 2 shards cut from one tensor, each with its halo
    rows and the whole tensor's max: the unsharded accumulators' rows, and
    the outputs, bit for bit."""
    gen = torch.Generator().manual_seed(k * 7 + stride + dilation)
    x = torch.randn(2, 5, 16, 9, generator=gen, dtype=torch.float64)
    w = torch.randn(6, 5, k, k, generator=gen, dtype=torch.float64)
    beg, _ = oconv.fixed_pad_amounts(k, dilation)
    xq, sx, wq, _ = oconv.quantize_int8(x, w)
    want = oconv.int8_conv_acc_reference(xq, wq, stride=stride, dilation=dilation, padding=beg)
    above, below = oconv.conv_halo(k, stride, dilation)
    xp = F.pad(x, (0, 0, above, below))
    rows_out = want.shape[2] // 2
    for s in range(2):
        xh = xp[:, :, 8 * s:8 * (s + 1) + above + below]
        hq, hsx, hwq, _ = oconv.quantize_int8(xh, w, x.abs().amax().float())
        assert torch.equal(hsx, sx)
        got = oconv.int8_conv_acc_reference(hq, hwq, stride=stride, dilation=dilation,
                                            padding=(0, beg))
        assert torch.equal(got, want[:, :, s * rows_out:(s + 1) * rows_out])


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
