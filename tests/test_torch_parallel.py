"""Data parallelism, block remat and the device prefetch of the PyTorch port,
on the CPU.

Data parallelism: two Gloo ranks (this file run as a script, one process
each) take the port's data-parallel step; the reference's
``shard_train_step`` runs the same step on a 2-device CPU mesh in the test
process. Both start from one state and one global batch of 8 (4 a rank),
with the reference's own draws handed to the port: one mixup lambda from
the step's stream before the rank fold, and each rank's DropBlock uniforms
from its shard-folded stream. The model, sizes and tolerances are those of
tests/test_torch_train_step.py (R50 width 0.125, assembled, 64x64, step 5
of 10):

- fp32: loss rtol 1e-5, BN moving statistics rtol 1e-5, the parameter
  update within the reference's own fp32 noise (relative L2 per leaf
  <= 5e-2, median <= 5e-3);
- float64 (both packages' fp32 casts re-pointed): loss rtol 1e-7, the
  update and the velocity <= 1e-6 per leaf, BN statistics rtol 1e-7;
- the two ranks end the step bit for bit alike;
- a third leg trains the fp32 step under ``remat="blocks"``: bit for bit
  the fp32 leg, the BN statistics' all-reduce replayed in the backward;
- ``sync_bn=False`` (float64): each rank normalizes with its own
  statistics, so the step's velocity, loss and moving statistics are the
  means of two one-process steps on the shards;
- the step's own draws: one lambda from the global stream, or with
  ``mixup_per_shard`` each rank's from its fold (``mixup_lam`` their mean);
- Big-Little stages (``bl_alpha=2, bl_beta=4`` on the same flags) in
  float64 against the reference's Big-Little ``shard_train_step``, with the
  same bounds.

Remat alone, the prefetch, the CLI on two CPU ranks (resume included, a
failing rank) and the refusals follow.
"""

import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if __name__ == "__main__":  # a rank: the port only
    sys.path.insert(0, str(REPO))

from axcnn_torch.core.dtypes import Policy  # noqa: E402
from axcnn_torch.core.rng import RngStream  # noqa: E402
from axcnn_torch.models.resnet import ModelConfig  # noqa: E402
from axcnn_torch.train.schedules import make_lr_schedule as t_lr  # noqa: E402
from axcnn_torch.train.train_step import create_train_state, make_train_step  # noqa: E402
import torch_inprocess  # noqa: E402

capped_threads = torch_inprocess.capped_threads

CFG = dict(width_multiplier=0.125, num_classes=10, use_resnet_d=True,
           use_se_block=True, use_sk_block=True, anti_alias_type="sconv",
           use_dropblock=True, dropblock_keep_prob=0.5, zero_gamma=True)
N, SIZE, STEP, TOTAL, WORLD = 8, 64, 5, 10, 2
STEP_KW = dict(total_steps=TOTAL, label_smoothing=0.1, mixup_alpha=0.2,
               weight_decay=1e-4, momentum=0.9, use_ema=True, ema_decay=0.9999)
LR_KW = dict(base_lr=0.1 * N / 256, total_steps=TOTAL, warmup_steps=2)
SITES = {f"dropblock/stage{s}/block{b}": SIZE // 4 // 2 ** (s - 1)
         for s, blocks in ((3, 6), (4, 3)) for b in range(blocks)}
ROOT_KEY = 72
BL_CFG = {**CFG, "bl_alpha": 2, "bl_beta": 4}
# a Big-Little stage 3 has one DropBlock site, at its output
BL_SITES = {"dropblock/stage3/out": SIZE // 16,
            **{k: hw for k, hw in SITES.items() if k.startswith("dropblock/stage4")}}
LEGS = ("fp32", "fp64", "fp32_remat", "fp64_nosync", "own_draws", "own_draws_per_shard",
        "bl_fp64")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# a rank of the data-parallel step (this file run as a script)
# ---------------------------------------------------------------------------

def _port_step(inputs, leg, rank, group="data"):
    """The port's step on this rank's shard (the data-parallel step; one
    process with ``group=None``), from the payload the test wrote; returns
    the new state's tensors and the metrics."""
    from axcnn_torch.parallel.mesh import data_group

    f64, bl = "fp64" in leg, leg.startswith("bl")
    remat = "blocks" if leg.endswith("remat") else "none"
    cfg = ModelConfig(**(BL_CFG if bl else CFG), remat=remat)
    state = create_train_state(cfg, generator=torch.Generator(), device="cpu")
    payload = inputs[leg if bl else "fp64" if f64 else "fp32"]
    state.model.load_state_dict(payload["model"])
    state.velocity = {k: v.clone() for k, v in payload["velocity"].items()}
    state.ema = {k: v.clone() for k, v in payload["ema"].items()}
    state.step = STEP
    policy = Policy()
    if f64:
        state.model.double()
        state.velocity = {k: v.double() for k, v in state.velocity.items()}
        state.ema = {k: v.double() for k, v in state.ema.items()}
        policy = Policy(param_dtype=torch.float64, compute_dtype=torch.float64)
    step = make_train_step(cfg, lr_schedule=t_lr(**LR_KW), policy=policy,
                           group=data_group() if group else None,
                           sync_bn=not leg.endswith("nosync"),
                           mixup_per_shard=leg.endswith("per_shard"), **STEP_KW)
    shard = payload["shards"][rank]
    batch = {"images": shard["images"], "labels": shard["labels"]}
    draws = ({} if leg.startswith("own_draws")
             else dict(lam=payload["lam"], dropblock_uniforms=shard["uniforms"]))
    to_float = torch.Tensor.float
    if f64:
        torch.Tensor.float = torch.Tensor.double
    try:
        state, metrics = step(state, batch, ROOT_KEY, **draws)
    finally:
        torch.Tensor.float = to_float
    return {"params": {k: p.detach() for k, p in state.model.named_parameters()},
            "buffers": {k: b for k, b in state.model.named_buffers()},
            "velocity": state.velocity, "ema": state.ema, "step": state.step,
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _rank_main(rank, world, port, workdir):
    from axcnn_torch.parallel import mesh

    torch.set_num_threads(torch_inprocess.THREADS)
    mesh.init_distributed("cpu", rank=rank, world_size=world,
                          coordinator=f"127.0.0.1:{port}")
    try:
        inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
        out = {leg: _port_step(inputs, leg, rank) for leg in LEGS}
    finally:
        mesh.shutdown()
    # this rank's shard in one process, for the sync_bn=False test: taken
    # here, beside the reference's compiles, not after them
    out["fp64_nosync_single"] = _port_step(inputs, "fp64_nosync", rank, group=None)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


# ---------------------------------------------------------------------------
# the test side (imports the reference)
# ---------------------------------------------------------------------------

def _reference_state(seed, cfg=CFG):
    """The reference's TrainState at step 5: He-scaled weights, perturbed BN,
    random velocity and an EMA near the weights (as in
    tests/test_torch_train_step.py)."""
    import jax

    from axcnn.models.resnet import ModelConfig as JModelConfig
    from axcnn.models.resnet import resnet_init
    from axcnn.train.train_step import TrainState as JTrainState

    p_shape, s_shape = jax.eval_shape(lambda k: resnet_init(k, JModelConfig(**cfg)),
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
    rng = np.random.default_rng(81)
    return {"images": rng.integers(0, 256, (N, SIZE, SIZE, 3), dtype=np.uint8),
            "labels": rng.integers(0, 10, N).astype(np.int32)}


def _draws(root_key, sites=SITES):
    """The reference's draws of the step: lambda from the global stream, each
    shard's DropBlock uniforms from the stream folded with its index."""
    import jax
    import jax.numpy as jnp

    from axcnn.core.rng import RngStream as JRngStream

    rng_global = JRngStream(root_key).fold_step(jnp.int32(STEP))
    lam = np.asarray(jax.random.beta(rng_global("mixup"), 0.2, 0.2, dtype=jnp.float32))
    uniforms = []
    for i in range(WORLD):
        rng_i = JRngStream(jax.random.fold_in(rng_global("shard"), i))
        uniforms.append({site: torch.from_numpy(np.array(jax.random.uniform(
            rng_i(site), (N // WORLD, hw, hw, 1), jnp.float32))[..., 0])
            for site, hw in sites.items()})
    return lam, uniforms


def _port_inputs(jstate, batch, lam, uniforms, cfg=CFG):
    from axcnn_torch.ckpt.convert import train_state_from_axcnn

    tstate = train_state_from_axcnn(jstate, ModelConfig(**cfg))
    m = N // WORLD
    return {"model": tstate.model.state_dict(), "velocity": tstate.velocity,
            "ema": tstate.ema, "lam": lam[()],
            "shards": [{"images": torch.from_numpy(batch["images"][i * m:(i + 1) * m]),
                        "labels": torch.from_numpy(batch["labels"][i * m:(i + 1) * m]),
                        "uniforms": uniforms[i]} for i in range(WORLD)]}


def _reference_step(jstate, batch, root_key, float_dtype, cfg=CFG):
    import jax
    import jax.numpy as jnp

    from axcnn.core.dtypes import Policy as JPolicy
    from axcnn.models.resnet import ModelConfig as JModelConfig
    from axcnn.parallel.mesh import DATA_AXIS, make_mesh, shard_train_step
    from axcnn.train.schedules import make_lr_schedule as j_lr
    from axcnn.train.train_step import make_train_step as j_make_train_step

    j_in = jax.tree.map(lambda a: np.asarray(a, float_dtype) if a.dtype.kind == "f" else a,
                        jstate)
    policy = JPolicy(param_dtype=jnp.float32, compute_dtype=jnp.float32)
    jstep = shard_train_step(
        j_make_train_step(JModelConfig(**cfg), lr_schedule=j_lr(**LR_KW), policy=policy,
                          axis_name=DATA_AXIS, **STEP_KW), make_mesh(WORLD))
    j_new, j_metrics = jstep(j_in, batch, root_key)
    return j_in, jax.tree.map(np.asarray, j_new), jax.device_get(j_metrics)


class _References(dict):
    """The reference's step of each kind (``fp32``, ``fp64``, ``bl_fp64``),
    run when a test first asks for it: one compile each, paid by that test
    alone, while the port's ranks run in the background."""

    def __init__(self, jstate, bl_state, batch, root_key):
        super().__init__()
        self._args = jstate, bl_state, batch, root_key

    def __missing__(self, kind):
        import jax
        import jax.numpy as jnp

        jstate, bl_state, batch, root_key = self._args
        if kind == "fp32":
            out = _reference_step(jstate, batch, root_key, np.float32)
        else:
            with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
                mp.setattr(jnp, "float32", jnp.float64)
                out = (_reference_step(jstate, batch, root_key, np.float64) if kind == "fp64"
                       else _reference_step(bl_state, batch, root_key, np.float64, BL_CFG))
        self[kind] = out
        return out


class _RankResults(dict):
    """Every leg of the two port ranks, read once they have ended (on the
    first lookup): the rank-0 state as the reference's tree, its metrics,
    both ranks' tensors, and each rank's one-process ``fp64_nosync`` step
    (``nosync_singles``)."""

    def __init__(self, procs, workdir):
        super().__init__()
        self._procs, self._workdir = procs, workdir

    def __missing__(self, key):
        import jax

        from axcnn_torch.ckpt.convert import train_state_to_axcnn

        outs = [p.communicate(timeout=600)[0] for p in self._procs]
        for p, out in zip(self._procs, outs):
            assert p.returncode == 0, out[-4000:]
        ranks = [torch.load(self._workdir / f"rank{r}.pt", weights_only=False)
                 for r in range(WORLD)]
        for leg in LEGS:
            r0 = ranks[0][leg]
            with pytest.MonkeyPatch.context() as mp:
                if "fp64" in leg:  # the converter's fp32 cast, re-pointed
                    mp.setattr(torch.Tensor, "float", lambda self: self.double())
                tree = train_state_to_axcnn(_as_state(
                    r0, remat=leg.endswith("remat"), cfg=BL_CFG if leg.startswith("bl") else CFG))
            self[leg] = dict(tree=jax.tree.map(lambda a: np.asarray(a, np.float64), tree),
                             metrics=r0["metrics"], ranks=[r[leg] for r in ranks])
        self["nosync_singles"] = [r["fp64_nosync_single"] for r in ranks]
        return self[key]


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """(the reference's steps, the port ranks' legs): the two ranks start
    here, in the background, and run every leg while the reference's steps
    compile, each when a test first needs it."""
    import jax
    import jax.numpy as jnp

    workdir = tmp_path_factory.mktemp("dp")
    jstate, batch, root_key = _reference_state(80), _batch(), jax.random.key(ROOT_KEY)
    bl_state = _reference_state(82, BL_CFG)
    inputs = {"fp32": _port_inputs(jstate, batch, *_draws(root_key))}
    to64 = lambda t: jax.tree.map(  # noqa: E731
        lambda a: np.asarray(a, np.float64) if a.dtype.kind == "f" else a, t)
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "float32", jnp.float64)
        inputs["fp64"] = _port_inputs(to64(jstate), batch, *_draws(root_key))
        inputs["bl_fp64"] = _port_inputs(to64(bl_state), batch,
                                         *_draws(root_key, BL_SITES), BL_CFG)
    torch.save(inputs, workdir / "inputs.pt")
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(WORLD), str(port),
                               str(workdir)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        yield _References(jstate, bl_state, batch, root_key), _RankResults(procs, workdir)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _as_state(out, remat, cfg=CFG):
    """A TrainState holding a rank's result, for the converter."""
    cfg = ModelConfig(**cfg, remat="blocks" if remat else "none")
    state = create_train_state(cfg, generator=torch.Generator(), device="cpu")
    if out["params"][next(iter(out["params"]))].dtype == torch.float64:
        state.model.double()
    state.model.load_state_dict({**out["params"], **out["buffers"]})
    state.velocity, state.ema, state.step = out["velocity"], out["ema"], out["step"]
    return state


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(tree):
    import jax

    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _update_errors(want, got, field):
    old, new, port = (_leaves(getattr(want[0], field)), _leaves(getattr(want[1], field)),
                      _leaves(got["tree"][field]))
    assert set(port) == set(new)
    return {k: _rel_l2(port[k] - old[k], new[k] - old[k]) for k in new}


@pytest.mark.parametrize("leg,loss_rtol", [("fp32", 1e-5), ("fp64", 1e-7)])
def test_dp_metrics_match_the_reference(dp_runs, leg, loss_rtol):
    want, got = dp_runs
    jm, tm = want[leg][2], got[leg]["metrics"]
    assert set(tm) == set(jm) == {"loss", "lr", "train_top1", "mixup_lam"}
    np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=loss_rtol)
    np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
    assert tm["train_top1"] == float(jm["train_top1"])
    np.testing.assert_allclose(tm["mixup_lam"], float(jm["mixup_lam"]), rtol=1e-7)
    assert 0 < tm["mixup_lam"] < 1
    assert got[leg]["tree"]["step"] == STEP + 1


@pytest.mark.parametrize("field", ["params", "velocity"])
def test_dp_fp64_update_matches_per_leaf(dp_runs, field):
    want, got = dp_runs
    errs = _update_errors(want["fp64"], got["fp64"], field)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-6, (worst, errs[worst])


def test_dp_fp32_update_within_reference_noise(dp_runs):
    want, got = dp_runs
    errs = _update_errors(want["fp32"], got["fp32"], "params")
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 5e-2, (worst, errs[worst])
    assert np.median(list(errs.values())) <= 5e-3


@pytest.mark.parametrize("leg,rtol,atol", [("fp32", 1e-5, 1e-6), ("fp64", 1e-7, 1e-10)])
def test_dp_bn_statistics_match(dp_runs, leg, rtol, atol):
    """The moving statistics: the mean over ranks of each rank's update,
    from statistics synchronised over the global batch."""
    want, got = dp_runs
    ref, port = _leaves(want[leg][1].model_state), _leaves(got[leg]["tree"]["model_state"])
    assert set(port) == set(ref)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=rtol, atol=atol, err_msg=k)


def test_dp_big_little_fp64_step_matches_the_reference(dp_runs):
    """Big-Little stages under data parallelism (sync-BN over the little
    branch's projection BN too, DropBlock at stage 3's output): float64, the
    bounds of the assembled legs."""
    want, got = dp_runs
    (old, new, jm), port = want["bl_fp64"], got["bl_fp64"]
    tm = port["metrics"]
    np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=1e-7)
    assert tm["train_top1"] == float(jm["train_top1"])
    np.testing.assert_allclose(tm["mixup_lam"], float(jm["mixup_lam"]), rtol=1e-7)
    for field in ("params", "velocity"):
        errs = _update_errors(want["bl_fp64"], port, field)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 1e-6, (field, worst, errs[worst])
    ref, mine = _leaves(new.model_state), _leaves(port["tree"]["model_state"])
    assert set(mine) == set(ref) and any("little_proj_bn" in k for k in ref)
    for k in ref:
        np.testing.assert_allclose(mine[k], ref[k], rtol=1e-7, atol=1e-10, err_msg=k)


def test_dp_fp64_ema_matches(dp_runs):
    want, got = dp_runs
    ref, port = _leaves(want["fp64"][1].ema), _leaves(got["fp64"]["tree"]["ema"])
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-7, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("leg", LEGS)
def test_dp_ranks_end_the_step_alike(dp_runs, leg):
    r0, r1 = dp_runs[1][leg]["ranks"]
    assert r0["metrics"] == r1["metrics"]
    for field in ("params", "buffers", "velocity", "ema"):
        for k, t in r0[field].items():
            assert torch.equal(t, r1[field][k]), (field, k)


def test_dp_remat_step_equals_the_plain_step(dp_runs):
    """``remat="blocks"`` under data parallelism: the replayed regions
    all-reduce their BN statistics again in the backward, and the step
    comes out bit for bit the same, moving statistics updated once."""
    legs = dp_runs[1]
    plain, remat = legs["fp32"]["ranks"][0], legs["fp32_remat"]["ranks"][0]
    assert plain["metrics"] == remat["metrics"]
    for field in ("params", "buffers", "velocity", "ema"):
        for k, t in plain[field].items():
            assert torch.equal(t, remat[field][k]), (field, k)


def test_dp_without_sync_bn_averages_two_one_process_steps(dp_runs):
    """``sync_bn=False``: no statistic crosses the ranks, so the data-parallel
    step is the mean of one-process steps on the two shards: velocity
    (gradients), moving statistics and loss, in float64 (relative L2 per
    tensor <= 1e-10: the two sides sum in other orders and thread splits)."""
    import torch as t

    singles = dp_runs[1]["nosync_singles"]  # rank r's shard, one process (_rank_main)
    got = dp_runs[1]["fp64_nosync"]["ranks"][0]
    np.testing.assert_allclose(got["metrics"]["loss"],
                               np.mean([m["metrics"]["loss"] for m in singles]), rtol=1e-12)
    for field in ("velocity", "buffers"):
        for k, v in got[field].items():
            want = (singles[0][field][k] + singles[1][field][k]) / 2
            assert _rel_l2(v, want) <= 1e-10, (field, k, _rel_l2(v, want))
    synced = dp_runs[1]["fp64"]["ranks"][0]["buffers"]
    assert any(not t.allclose(got["buffers"][k], synced[k]) for k in synced)


@pytest.mark.parametrize("per_shard", [False, True])
def test_dp_draws_lambda_from_the_global_or_the_rank_stream(dp_runs, per_shard):
    """Without handed-in draws: one lambda from the step's global stream on
    every rank, or with ``mixup_per_shard`` one from each rank's fold, and
    ``mixup_lam`` their mean over the ranks."""
    from axcnn_torch.data.mixup import draw_lambda

    leg = "own_draws_per_shard" if per_shard else "own_draws"
    rng = RngStream(ROOT_KEY).fold_step(STEP)
    streams = [rng.fold_shard(r) for r in range(WORLD)] if per_shard else [rng] * WORLD
    lams = [draw_lambda(s.numpy("mixup"), 0.2) for s in streams]
    want = np.float32(np.float32(lams[0] + lams[1]) / np.float32(WORLD))
    got = dp_runs[1][leg]["metrics"]["mixup_lam"]
    assert got == float(want)
    assert (lams[0] != lams[1]) == per_shard
    r0, r1 = dp_runs[1][leg]["ranks"]
    for k, v in r0["params"].items():
        assert torch.equal(v, r1["params"][k]), k


# ---------------------------------------------------------------------------
# remat on one process
# ---------------------------------------------------------------------------

def _small_state(remat, seed=3, kw=CFG):
    cfg = ModelConfig(**kw, remat=remat)
    state = create_train_state(cfg, generator=torch.Generator().manual_seed(seed),
                               device="cpu")
    state.step = STEP
    return cfg, state


@pytest.mark.parametrize("kw", [CFG, BL_CFG], ids=["assembled", "bl"])
def test_remat_blocks_matches_no_remat_and_updates_bn_once(kw):
    """DropBlock active (keep-prob 0.75 at step 5 of 10), drawn from the
    step's hashed seeds: under ``remat="blocks"`` the loss, every gradient
    (through the update) and the BN moving statistics equal the run without
    remat bit for bit, and each moving statistic moved by exactly one
    update from its initial value. Big-Little: each block of a BL stage is
    a region; its projection and merge are not."""
    rng = np.random.default_rng(5)
    batch = {"images": torch.from_numpy(rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)),
             "labels": torch.from_numpy(rng.integers(0, 10, 4).astype(np.int64))}
    runs = {}
    for remat in ("none", "blocks"):
        cfg, state = _small_state(remat, kw=kw)
        before = {k: b.clone() for k, b in state.model.named_buffers()}
        step = make_train_step(cfg, lr_schedule=t_lr(**LR_KW), **STEP_KW)
        state, metrics = step(state, batch, 11)
        runs[remat] = (before, state, float(metrics["loss"]))
    (b0, s0, l0), (b1, s1, l1) = runs["none"], runs["blocks"]
    assert l0 == l1 and np.isfinite(l0)
    for (k, p0), p1 in zip(s0.model.named_parameters(), s1.model.parameters()):
        assert torch.equal(p0, p1), k
    for k, v in s0.velocity.items():
        assert torch.equal(v, s1.velocity[k]), k
    bufs0, bufs1 = dict(s0.model.named_buffers()), dict(s1.model.named_buffers())
    moved = 0
    for k in bufs0:
        assert torch.equal(bufs0[k], bufs1[k]), k
        # one update m*b + (1-m)*batch moves a buffer by (1-m)(batch - b): a
        # second would move it about twice as far, which equality rules out
        moved += int(not torch.equal(bufs1[k], b1[k]))
    assert moved == len(bufs0)


def test_remat_regions_replay_blurpool_but_not_dropblock(monkeypatch):
    """The stem and each block are replayed in the backward (BlurPool runs
    twice in the stride-2 blocks); DropBlock sits outside the regions and
    runs once a site."""
    import axcnn_torch.models.resnet as resnet

    calls = {"blur": 0, "drop": 0}
    blur, drop = resnet.blur_pool, resnet.dropblock

    def counting(kind, fn):
        def wrapped(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(resnet, "blur_pool", counting("blur", blur))
    monkeypatch.setattr(resnet, "dropblock", counting("drop", drop))
    for remat, blur_calls in (("none", 3), ("blocks", 6)):
        calls.update(blur=0, drop=0)
        cfg, state = _small_state(remat)
        x = torch.rand(2, 32, 32, 3)
        y = state.model(x, train=True, rng=RngStream(1).fold_step(0), progress=0.5)
        y.sum().backward()
        assert calls == {"blur": blur_calls, "drop": 9}, (remat, calls)


# ---------------------------------------------------------------------------
# the device prefetch
# ---------------------------------------------------------------------------

def test_prefetch_forwards_a_producer_error():
    from axcnn_torch.data.pipeline import device_prefetch

    def batches():
        yield {"x": np.zeros(2)}
        raise OSError("bad record")

    it = device_prefetch(batches(), device="cpu", size=2)
    assert torch.equal(next(it)["x"], torch.zeros(2, dtype=torch.float64))
    with pytest.raises(RuntimeError, match="producer thread failed") as err:
        next(it)
    assert isinstance(err.value.__cause__, OSError)


def test_prefetch_consumed_state_is_the_batch_in_hand():
    """The loader runs up to size + 1 batches ahead; ``consumed_state`` is
    the position after the batch the consumer holds."""
    from axcnn_torch.data.pipeline import device_prefetch

    class Loader:
        def __init__(self):
            self.state = 0

        def __iter__(self):
            while True:
                self.state += 1
                yield {"i": np.array([self.state])}

    loader = Loader()
    it = device_prefetch(iter(loader), device="cpu", size=2, state_fn=lambda: loader.state)
    try:
        for want in (1, 2, 3):
            assert int(next(it)["i"]) == want
            assert it.consumed_state == want
        deadline = time.monotonic() + 10
        while loader.state < 3 + 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert 3 + 2 <= loader.state <= 3 + 2 + 1
    finally:
        it.close()
    assert not it._thread.is_alive()


def test_prefetch_close_stops_a_producer_on_a_full_queue():
    from axcnn_torch.data.pipeline import device_prefetch

    def endless():
        while True:
            yield {"x": np.zeros(1)}

    before = {t for t in threading.enumerate() if t.name == "device-prefetch"}
    it = device_prefetch(endless(), device="cpu", size=1)
    next(it)
    time.sleep(0.1)  # the producer now blocks on the full queue
    it.close()
    assert not [t for t in threading.enumerate()
                if t.name == "device-prefetch" and t not in before]


def test_prefetch_refuses_a_depth_below_one():
    from axcnn_torch.data.pipeline import device_prefetch

    with pytest.raises(ValueError, match="data.prefetch must be >= 1"):
        device_prefetch(iter([]), device="cpu", size=0)


# ---------------------------------------------------------------------------
# the streams
# ---------------------------------------------------------------------------

def test_shard_fold_gives_each_rank_its_own_stream():
    """The global stream (lambda) is the same on every rank; the per-rank
    stream (DropBlock) is the "shard" key folded with the rank."""
    g = RngStream(7).fold_step(3)
    r0, r1 = g.fold_shard(0), g.fold_shard(1)
    assert r0.key == RngStream(g("shard")).fold_step(0).key
    site = "dropblock/stage3/block0"
    assert len({r0(site), r1(site), g(site)}) == 3
    assert g.fold_shard(1)(site) == r1(site)


# ---------------------------------------------------------------------------
# the CLI on two CPU ranks, and the refusals
# ---------------------------------------------------------------------------

SMALL = ["--config=assemble_resnet50", "--data.use_synthetic_data", "--train.batch_size=8",
         "--data.image_size=32", "--model.width_multiplier=0.125", "--train.log_every=1",
         "--runtime.platform=cpu"]


def _cli(*args, timeout=300):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    return subprocess.run([sys.executable, "-m", "axcnn_torch.cli.main_classification",
                           *args], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)


def _records(model_dir):
    import json

    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_trains_on_two_cpu_ranks_and_resumes(tmp_path):
    """``--runtime.num_devices=2`` starts two Gloo ranks: rank 0 alone logs
    and saves; rerun to more steps, both ranks restore that checkpoint."""
    model_dir = str(tmp_path / "run")
    argv = [*SMALL, "--runtime.num_devices=2", "--runtime.save_checkpoint_steps=2",
            f"--runtime.model_dir={model_dir}"]
    first = _cli(*argv, "--train.train_steps=2")
    assert first.returncode == 0, first.stderr[-4000:]
    recs = _records(model_dir)
    assert [(r["tag"], r["step"]) for r in recs] == [("train", 1), ("train", 2), ("eval", 2)]
    assert recs[-1]["count"] == 4 * 8  # 4 synthetic eval batches of 4 on each rank
    assert sorted(os.listdir(os.path.join(model_dir, "checkpoints"))) == [
        "2.pt", "model_config.json"]
    second = _cli(*argv, "--train.train_steps=3")
    assert second.returncode == 0, second.stderr[-4000:]
    new = _records(model_dir)[len(recs):]
    assert [(r["tag"], r["step"]) for r in new] == [("restore", 2), ("train", 3), ("eval", 3)]
    assert all(np.isfinite(r["loss"]) for r in recs + new if r["tag"] == "train")


def test_cli_ranks_under_a_launchers_environment(tmp_path):
    """With ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_*`` set, as
    ``torchrun`` sets them, each CLI process is one rank and starts none."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    # torchrun also sets OMP_NUM_THREADS (to 1) for each of its processes
    env.update(WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               OMP_NUM_THREADS="2")
    model_dir = str(tmp_path / "run")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "axcnn_torch.cli.main_classification", *SMALL,
         "--train.train_steps=2", f"--runtime.model_dir={model_dir}"],
        cwd=REPO, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs[0][-3000:] + outs[1][-3000:]
    recs = _records(model_dir)
    assert [(r["tag"], r["step"]) for r in recs] == [("train", 1), ("train", 2), ("eval", 2)]
    assert recs[-1]["count"] == 4 * 8


def _write_records(directory, train_shards, eval_sizes):
    """2-class JPEG TFRecords: 8 training records in ``train_shards`` files,
    and one validation file of each of ``eval_sizes`` records."""
    from PIL import Image

    from axcnn.data.build_tfrecords import write_shards

    rng = np.random.default_rng(0)

    def items(n, tag):
        out = []
        for i in range(n):
            p = str(directory / f"{tag}{i}.jpg")
            Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(p)
            out.append((p, i % 2, "ab"[i % 2]))
        return out

    write_shards(items(8, "t"), str(directory / "rec"), "train", train_shards)
    # shard i of validation-0000i-of-0000k holds eval_sizes[i] records
    for i, n in enumerate(eval_sizes):
        write_shards(items(n, f"v{i}_"), str(directory / f"rec{i}"), "validation", 1)
        os.replace(directory / f"rec{i}" / "validation-00000-of-00001",
                   directory / "rec" / f"validation-{i:05d}-of-{len(eval_sizes):05d}")
    return ["--data.dataset_name=custom", f"--data.data_dir={directory / 'rec'}",
            "--data.num_classes=2", "--data.num_train_examples=8",
            f"--data.num_eval_examples={sum(eval_sizes)}", "--data.num_workers=1"]


def test_uneven_eval_shards_agree_on_their_batch_count(tmp_path):
    """Rank 0 reads 12 eval records (3 batches of 4), rank 1 reads 4 (1
    batch): rank 1 appends padding batches, so the per-batch all-reduce is
    called equally often and the eval counts all 16, once each."""
    data = _write_records(tmp_path, 2, (12, 4))
    proc = _cli(*[a for a in SMALL if a != "--data.use_synthetic_data"], *data,
                "--runtime.num_devices=2", "--train.train_steps=1",
                f"--runtime.model_dir={tmp_path / 'run'}", timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    evals = [r for r in _records(str(tmp_path / "run")) if r["tag"] == "eval"]
    assert len(evals) == 1 and evals[0]["count"] == 16


@pytest.mark.parametrize("native", [False, True])
def test_ranks_outnumbering_eval_files_deal_out_its_records(tmp_path, native):
    """Each of 3 hosts of one eval file keeps every third record: together
    they read each record once, and each promises the batches it yields
    (config 5 of the acceptance drive: 8 ranks, 2 eval files). ``evaluate``
    pads the ranks' uneven shares (the test above)."""
    from axcnn_torch.data.datasets import DatasetInfo
    from axcnn_torch.data.pipeline import TFRecordImageLoader

    _write_records(tmp_path, 1, (16,))
    info = DatasetInfo("two", 2, 8, 16, train_prefix="train", eval_prefix="validation")

    def images(host_id, num_hosts):
        loader = TFRecordImageLoader(str(tmp_path / "rec"), info, batch_size=4, train=False,
                                     image_size=32, resize_min=40, host_id=host_id,
                                     num_hosts=num_hosts, drop_remainder=False,
                                     use_native=native, num_workers=1)
        batches = list(loader)
        assert len(batches) == loader.num_batches()
        return [img for b in batches for img in b["images"]]

    whole = images(0, 1)
    dealt = [images(h, 3) for h in range(3)]
    assert [len(d) for d in dealt] == [6, 5, 5]
    assert all(np.array_equal(dealt[h][i], whole[3 * i + h])
               for h in range(3) for i in range(len(dealt[h])))


def test_a_failing_rank_ends_the_run_with_its_traceback(tmp_path):
    """One training shard file for two ranks: rank 1 has none and raises
    while rank 0 goes on to its first collective. The run must end non-zero
    with rank 1's error, not hang at rank 0's collective."""
    data = _write_records(tmp_path, 1, (8,))
    t0 = time.monotonic()
    proc = _cli(*[a for a in SMALL if a != "--data.use_synthetic_data"], *data,
                "--runtime.num_devices=2", "--train.train_steps=1",
                f"--runtime.model_dir={tmp_path / 'run'}", timeout=240)
    assert proc.returncode != 0
    assert "host 1/2 got no shards" in proc.stderr, proc.stderr[-4000:]
    assert time.monotonic() - t0 < 200


def test_dcn_slices_are_refused_with_the_reason(tmp_path):
    from axcnn_torch.cli import main_classification as tcli

    with pytest.raises(NotImplementedError, match="no DCN") as err:
        tcli.main([*SMALL, "--runtime.dcn_slices=2", f"--runtime.model_dir={tmp_path}"])
    assert "not ported" not in str(err.value)


@pytest.mark.parametrize("remat", ["conv", "conv_nocse"])
def test_remat_name_policies_are_refused_with_the_reason(remat, tmp_path):
    from axcnn_torch.cli import main_classification as tcli

    with pytest.raises(NotImplementedError, match="XLA name policy") as err:
        tcli.main([*SMALL, f"--model.remat={remat}", "--train.train_steps=1",
                   f"--runtime.model_dir={tmp_path}"])
    assert "not ported" not in str(err.value)


def test_a_global_batch_the_ranks_do_not_divide_is_refused(tmp_path):
    from axcnn_torch.cli import main_classification as tcli

    with pytest.raises(ValueError, match="global batch 8 not divisible by 3"):
        tcli.main([*SMALL, "--runtime.num_devices=3", f"--runtime.model_dir={tmp_path}"])
    assert not os.listdir(tmp_path)


def test_more_devices_than_cards_are_refused(tmp_path, monkeypatch):
    from axcnn_torch.cli import main_classification as tcli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    argv = [a for a in SMALL if a != "--runtime.platform=cpu"]
    with pytest.raises(ValueError, match="num_devices=2 but 1 CUDA card"):
        tcli.main([*argv, "--runtime.num_devices=2", f"--runtime.model_dir={tmp_path}"])
    assert not os.listdir(tmp_path)


def test_run_refuses_a_device_count_its_process_group_does_not_have(tmp_path):
    from axcnn_torch.train import loop
    from axcnn_torch.utils.config import parse_cli

    cfg = parse_cli([*SMALL, "--runtime.num_devices=2", f"--runtime.model_dir={tmp_path}"])
    with pytest.raises(ValueError, match="this process group has 1 rank"):
        loop.run(cfg)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
