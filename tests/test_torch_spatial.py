"""Spatial partitioning of the PyTorch port (image H split across ranks), on
the CPU.

Per op, in one process, float64: a tensor is split into S = 2 and 4 shards
along H, each shard is handed its neighbours' halo rows (cut from the
zero-padded tensor, -inf for the max pool, so autograd adds the halo rows'
gradient into their owners as the exchange's backward does), the op's shard
computation runs on it, and the shards' outputs, concatenated, and the input
gradient are held against the unsharded op. Tolerances: 0 where the shard's
result is a pure row slice of the same arithmetic (the ResNet-D 2x2/2
average pool, the max pool's output, the BlurPool 3/2 plain version's output
with top padding 0, the DropBlock mask windows and their counts' sum, the
apply with the global counts); a relative 1e-12 where the sharded op sums in
another order (a conv or a depthwise blur on a slice, the global average
pool's parts, the halo rows' gradient added into their owners).

The whole step, on Gloo ranks (this file run as a script, one process a
rank, started once for ``(D, S) = (1, 2)`` and once for ``(2, 2)``): the
assembled ResNet-50 at width 0.25, 128x128, global batch 4, float64 (the
port's fp32 casts re-pointed), the reference's mixup lambda and DropBlock
uniforms injected, step 5 of 10 (keep-prob 0.75). Against the port's
one-rank step on the global batch: loss, every parameter, the velocity, the
EMA and the BN moving statistics to a relative 1e-10; against the
reference's jitted unsharded ``make_train_step`` (``axis_name=None``) at
the float64 bounds of tests/test_torch_train_step.py; the eval's sums equal
the one-rank eval's (counts exactly); the halo exchange and the mixup
mirror checked directly on each rank. On the ``(1, 2)`` ranks, a Big-Little
model with ``remat="blocks"`` (both once refused under spatial partitioning)
runs a train forward and backward that the one-rank one matches. What the
step still refuses closes the file.
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
from axcnn_torch.kernels import blurpool as kblur  # noqa: E402
from axcnn_torch.kernels import dropblock as kdrop  # noqa: E402
from axcnn_torch.kernels.dropblock import (dropblock_apply_reference,  # noqa: E402
                                           dropblock_mask_reference)
from axcnn_torch.models.resnet import ModelConfig  # noqa: E402
from axcnn_torch.ops import blurpool as oblur  # noqa: E402
from axcnn_torch.ops import conv as oconv  # noqa: E402
from axcnn_torch.ops import pooling as opool  # noqa: E402
from axcnn_torch.ops.sk import merged_sk_weight  # noqa: E402
from axcnn_torch.parallel import spatial as sp  # noqa: E402
from axcnn_torch.train.schedules import make_lr_schedule as t_lr  # noqa: E402
from axcnn_torch.train.train_step import (create_train_state, make_eval_step,  # noqa: E402
                                          make_train_step)
import torch_inprocess

capped_threads = torch_inprocess.capped_threads

CFG = dict(width_multiplier=0.25, num_classes=10, use_resnet_d=True,
           use_se_block=True, use_sk_block=True, anti_alias_type="sconv",
           use_dropblock=True, dropblock_keep_prob=0.5, zero_gamma=True)
N, SIZE, STEP, TOTAL = 4, 128, 5, 10
STEP_KW = dict(total_steps=TOTAL, label_smoothing=0.1, mixup_alpha=0.2,
               weight_decay=1e-4, momentum=0.9, use_ema=True, ema_decay=0.9999)
LR_KW = dict(base_lr=0.1 * N / 256, total_steps=TOTAL, warmup_steps=2)
SITES = {f"dropblock/stage{s}/block{b}": SIZE // 4 // 2 ** (s - 1)
         for s, blocks in ((3, 6), (4, 3)) for b in range(blocks)}
ROOT_KEY = 72
# a Big-Little model with remat, no DropBlock, no zero-gamma: every branch live
BL_REMAT = dict(CFG, use_dropblock=False, zero_gamma=False, bl_alpha=2, bl_beta=4,
                remat="blocks")
GRIDS = ((1, 2), (2, 2))  # (D, S)
REL = 1e-12  # the per-op bound where the shards sum in another order


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rel(a, b):
    a, b = (torch.as_tensor(t, dtype=torch.float64).detach() for t in (a, b))
    return float((a - b).norm() / max(float(b.norm()), 1e-300))


def _shards(x, parts, above, below, fill=0.0):
    """Each shard of ``x``'s H with its halo rows, cut from the padded
    tensor (differentiable: a halo row's gradient reaches its owner)."""
    hs = x.shape[2] // parts
    xp = F.pad(x, (0, 0, above, below), value=fill)
    return [xp[:, :, s * hs:s * hs + hs + above + below] for s in range(parts)]


def _sharded(op, x, parts, above, below, fill=0.0):
    return torch.cat([op(xh) for xh in _shards(x, parts, above, below, fill)], dim=2)


def _input(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64).requires_grad_()


def _grads(x, out, g):
    (dx,) = torch.autograd.grad(out, x, g)
    return dx


# ---------------------------------------------------------------------------
# the ops, sharded in one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("k,stride,dilation,merged", [
    (3, 2, 1, False),  # stem conv0
    (3, 1, 1, False),  # stem 1-2, conv2
    (3, 1, 2, False),  # SK's dilated branch
    (3, 1, 1, True),   # SK's merged 5x5
    (1, 2, 1, False),  # a stride-2 projection: no halo
    (1, 1, 1, False),
])
def test_conv_shards_match(parts, k, stride, dilation, merged):
    x = _input((2, 3, 16, 9), 1)
    g = torch.Generator().manual_seed(2)
    w = torch.randn(4, 3, k, k, generator=g, dtype=torch.float64)
    if merged:
        w = merged_sk_weight(w, torch.randn(4, 3, 3, 3, generator=g, dtype=torch.float64))
    full = oconv.conv2d_fixed_padding(x, w, stride=stride, dilation=dilation)
    above, below = oconv.conv_halo(w.shape[-1], stride, dilation)
    assert (above, below) == {(3, 2, 1): (1, 0), (3, 1, 1): (1, 1), (3, 1, 2): (2, 2),
                              (5, 1, 1): (2, 2), (1, 2, 1): (0, 0),
                              (1, 1, 1): (0, 0)}[(w.shape[-1], stride, dilation)]
    got = _sharded(lambda xh: oconv.conv2d_on_halo(xh, w, stride=stride, dilation=dilation),
                   x, parts, above, below)
    assert got.shape == full.shape and _rel(got, full) <= REL
    gy = torch.randn(full.shape, generator=g, dtype=torch.float64)
    assert _rel(_grads(x, got, gy), _grads(x, full, gy)) <= REL


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("window,stride", [(3, 2), (3, 1)])
def test_max_pool_shards_match(parts, window, stride):
    """The output is a selection, so exact; the gradient adds a halo row's
    share into its owner, exact up to the order of a sum."""
    x = _input((2, 3, 16, 9), 3)
    full = opool.max_pool_same(x, window=window, stride=stride)
    halo = opool.max_pool_halo(16, window=window, stride=stride)
    assert halo == {(3, 2): (0, 1), (3, 1): (1, 1)}[(window, stride)]
    got = _sharded(lambda xh: opool.max_pool_on_halo(xh, window=window, stride=stride),
                   x, parts, *halo, fill=float("-inf"))
    assert torch.equal(got, full)
    gy = torch.randn(full.shape, dtype=torch.float64)
    assert _rel(_grads(x, got, gy), _grads(x, full, gy)) <= REL


@pytest.mark.parametrize("parts", [2, 4])
def test_avg_pool_is_row_local_on_even_shards(parts):
    x = _input((2, 3, 16, 9), 4)
    full = opool.avg_pool_same(x, window=2, stride=2)
    got = _sharded(lambda xh: opool.avg_pool_same(xh, window=2, stride=2), x, parts, 0, 0)
    assert torch.equal(got, full)
    gy = torch.randn(full.shape, dtype=torch.float64)
    assert torch.equal(_grads(x, got, gy), _grads(x, full, gy))


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_blur_pool_3s2_top_pad_zero_matches(parts, dtype, monkeypatch):
    """The kernels' plain version with top padding 0 on a shard with one
    halo row above: the unsharded output rows, bit for bit; its backward
    (``blur_pool_bwd_reference`` with ``pad_top=0``) is autograd's through
    that forward, bit for bit, and the gradient after the halo's return is
    the unsharded one's (in float64: the plain version's fp32 cast
    re-pointed)."""
    x = _input((2, 3, 16, 11), 5)
    xd = x.detach().to(dtype)
    full = kblur.blur_pool_reference(xd)
    above, below = oblur.blur_halo(2, 3)
    assert (above, below) == (1, 0)
    parts_in = _shards(xd, parts, above, below)
    got = torch.cat([oblur.blur_pool_on_halo(xh) for xh in parts_in], dim=2)
    assert torch.equal(got, full)
    for xh in parts_in:
        xh = xh.float().requires_grad_()
        y = kblur.blur_pool_reference(xh, pad_top=0)
        gy = torch.randn(y.shape)
        (want,) = torch.autograd.grad(y, xh, gy)
        assert torch.equal(kblur.blur_pool_bwd_reference(gy, xh.shape[-2:], pad_top=0), want)
    if dtype == torch.float64:
        monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
        got = _sharded(oblur.blur_pool_on_halo, x, parts, above, below)
        gy = torch.randn(full.shape, dtype=torch.float64)
        assert _rel(_grads(x, got, gy), _grads(x, kblur.blur_pool_reference(x), gy)) <= REL


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("size", range(1, 8))
@pytest.mark.parametrize("stride", [1, 2])
def test_blur_pool_general_shards_match(parts, size, stride):
    """Every filter size of the general route (the ``max`` stem, ``proj``
    shortcuts, Big-Little's sizes) on halo'd shards."""
    x = _input((2, 3, 16, 9), 6)
    full = oblur.blur_pool_general(x, stride=stride, filter_size=size)
    above, below = oblur.blur_halo(stride, size)
    got = _sharded(lambda xh: oblur.blur_pool_general(xh, stride=stride, filter_size=size,
                                                      pad_rows=False), x, parts, above, below)
    assert got.shape == full.shape and _rel(got, full) <= REL
    gy = torch.randn(full.shape, dtype=torch.float64)
    assert _rel(_grads(x, got, gy), _grads(x, full, gy)) <= REL


@pytest.mark.parametrize("parts", [2, 4])
def test_global_avg_pool_parts_sum_to_the_mean(parts, monkeypatch):
    """In float64 (the pool's fp32 cast re-pointed)."""
    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    x = _input((2, 3, 16, 9), 7)
    full = opool.global_avg_pool(x)
    hs = 16 // parts
    got = sum(opool.global_avg_pool_part(x[:, :, s * hs:(s + 1) * hs], 16 * 9)
              for s in range(parts))
    assert _rel(got, full) <= REL
    gy = torch.randn(full.shape, dtype=torch.float64)
    assert _rel(_grads(x, got, gy), _grads(x, full, gy)) <= REL


@pytest.mark.parametrize("parts,h,w,bs", [(2, 14, 14, 7), (7, 14, 14, 7), (2, 28, 28, 7),
                                          (4, 28, 28, 7), (4, 28, 17, 5), (2, 14, 14, 5)])
@pytest.mark.parametrize("injected", [False, True])
def test_dropblock_windows_match_the_global_mask(parts, h, w, bs, injected):
    """The window of rows ``[row0, row0 + h)`` of the global mask, hashed or
    from the whole map's injected uniforms: bit for bit (7 windows of 2 rows
    cut every block); the windows' counts add up to the global ones; the
    apply with the global counts and element count gives the global apply's
    rows."""
    g = torch.Generator().manual_seed(h * w + bs)
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (3,), dtype=torch.int32, generator=g)
    uniforms = torch.rand(3, h, w, generator=g, dtype=torch.float64) if injected else None
    gamma = 0.08
    full, counts = dropblock_mask_reference(seeds, gamma, h, w, bs, uniforms)
    assert 0 < counts.sum() < 3 * h * w  # some dropped, some kept
    hs = h // parts
    wins = [dropblock_mask_reference(seeds, gamma, hs, w, bs, uniforms, row0=s * hs,
                                     h_global=h) for s in range(parts)]
    assert torch.equal(torch.cat([m for m, _ in wins], dim=1), full)
    assert torch.equal(sum(c for _, c in wins), counts)
    x = torch.randn(3, 4, h, w, generator=g, dtype=torch.float64)
    want = dropblock_apply_reference(x, full, counts)
    got = torch.cat([dropblock_apply_reference(x[:, :, s * hs:(s + 1) * hs], m, counts,
                                               x.numel()) for s, (m, _) in enumerate(wins)],
                    dim=2)
    assert torch.equal(got, want)


def test_shard_rule_and_halo_rows():
    sp.check_shard_rows(448, 2)
    sp.check_shard_rows(128, 2)
    sp.check_shard_rows(256, 4)
    for h, s in [(448, 4), (224, 2), (96, 2), (64, 2), (192, 4)]:
        with pytest.raises(ValueError, match=r"H % \(32\*S\) == 0 and H / \(32\*S\) >= 2"):
            sp.check_shard_rows(h, s)
    assert sp.halo_rows(3, 2, 1) == (1, 0)
    assert sp.halo_rows(1, 2, 0) == (0, 0)


def test_rank_grid_and_its_refusals():
    """Rank r is (r // S, r % S); S must divide the ranks and, across
    hosts, each host's ranks (the reference's messages)."""
    assert sp.order_spatial_ranks(8, 2).tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert sp.order_spatial_ranks(8, 4, local_world=4).tolist() == [[0, 1, 2, 3],
                                                                   [4, 5, 6, 7]]
    with pytest.raises(ValueError, match="6 devices not divisible by spatial=4"):
        sp.order_spatial_ranks(6, 4)
    with pytest.raises(ValueError, match=r"must divide the per-host device count \(6\)"):
        sp.order_spatial_ranks(12, 4, local_world=6)
    assert sp.order_spatial_ranks(6, 2, local_world=6).shape == (3, 2)  # one host


# ---------------------------------------------------------------------------
# the whole step on Gloo ranks (this file run as a script)
# ---------------------------------------------------------------------------

def _port_state(payload):
    """The float64 state at step 5."""
    cfg = ModelConfig(**CFG)
    state = create_train_state(cfg, generator=torch.Generator(), device="cpu")
    state.model.load_state_dict(payload["model"])
    state.model.double()
    state.velocity = {k: v.double() for k, v in payload["velocity"].items()}
    state.ema = {k: v.double() for k, v in payload["ema"].items()}
    state.step = STEP
    return cfg, state


def _f64_step(payload, images, labels, uniforms, group=None, spatial=None):
    """The port's float64 step (fp32 casts re-pointed), then its eval on the
    same images; returns the state's tensors and the metrics."""
    cfg, state = _port_state(payload)
    policy = Policy(param_dtype=torch.float64, compute_dtype=torch.float64)
    step = make_train_step(cfg, lr_schedule=t_lr(**LR_KW), policy=policy, group=group,
                           spatial=spatial, **STEP_KW)
    evaluate = make_eval_step(cfg, policy=policy, use_ema=True, group=group, spatial=spatial)
    to_float = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        state, metrics = step(state, {"images": images, "labels": labels}, ROOT_KEY,
                              lam=payload["lam"], dropblock_uniforms=uniforms)
        ev = evaluate(state, {"images": images, "labels": labels})
    finally:
        torch.Tensor.float = to_float
    return {"params": {k: p.detach() for k, p in state.model.named_parameters()},
            "buffers": dict(state.model.named_buffers()), "velocity": state.velocity,
            "ema": state.ema, "step": state.step,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "eval": {k: float(v) for k, v in ev.items()}}


def _bl_remat_pass(images, group=None, spatial=None):
    """A float64 train forward and backward (loss: the logits' sum of
    squares) of a seeded Big-Little model with remat on ``images``, or on
    this rank's rows of them: the logits, this rank's share of the
    parameters' gradients and how far the BN moving statistics moved."""
    model = create_train_state(ModelConfig(**BL_REMAT), generator=torch.Generator().manual_seed(7),
                               device="cpu").model.double()
    start = {k: b.clone() for k, b in model.named_buffers()}
    x = images.double() / 255.0
    if spatial is not None:
        x = spatial.slice_rows(x)
    to_float = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        logits = model(x, train=True, policy=Policy(torch.float64, torch.float64), group=group,
                       spatial=spatial)
        # a spatial row's S ranks hold the same logits: each backs 1/S of the loss
        (logits.square().sum() / (1 if spatial is None else spatial.parts)).backward()
    finally:
        torch.Tensor.float = to_float
    return {"logits": logits.detach(),
            "grads": {k: p.grad for k, p in model.named_parameters()},
            "moved": {k: b - start[k] for k, b in model.named_buffers()}}


@contextlib.contextmanager
def _counting_collectives():
    """Counts, by name, the calls of ``torch.distributed.all_reduce`` and
    ``all_gather`` and of ``SpatialContext.global_counts`` in the block."""
    import torch.distributed as dist

    calls = dict.fromkeys(("all_reduce", "all_gather", "global_counts"), 0)

    def counted(owner, name):
        fn = getattr(owner, name)

        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call

    with pytest.MonkeyPatch.context() as mp:
        for owner, name in ((dist, "all_reduce"), (dist, "all_gather"),
                            (sp.SpatialContext, "global_counts")):
            mp.setattr(owner, name, counted(owner, name))
        yield calls


def _rank_main(rank, world, spatial_parts, port, workdir):
    from axcnn_torch.parallel import mesh

    torch.set_num_threads(torch_inprocess.THREADS)
    mesh.init_distributed("cpu", rank=rank, world_size=world, coordinator=f"127.0.0.1:{port}")
    try:
        ctx = sp.make_spatial_context(spatial_parts)
        payload = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
        d, n = ctx.data_index, N // ctx.data_parts
        out = {"grid": (ctx.data_index, ctx.index, ctx.data_parts, ctx.parts)}
        # the halo exchange alone, both ways, against slices of one tensor
        x = _input((2, 3, 8 * ctx.parts, 5), 11)
        mine = x[:, :, 8 * ctx.index:8 * (ctx.index + 1)].detach().requires_grad_()
        xh = ctx.halo(mine, 2, 1)
        gy = torch.randn(xh.shape, generator=torch.Generator().manual_seed(12 + rank),
                         dtype=torch.float64)
        (dmine,) = torch.autograd.grad(xh, mine, gy)
        out["halo"] = (xh.detach(), dmine, gy)
        # mixup's partner: data shard D - 1 - d's rows
        imgs = payload["images"][d * n:(d + 1) * n]
        out["mirror"] = ctx.mirror(ctx.slice_rows(imgs), payload["labels"][d * n:(d + 1) * n])
        # the injected uniforms are the global batch's: every rank counts
        # every global sample's keep-mask itself
        step = lambda: _f64_step(payload, imgs, payload["labels"][d * n:(d + 1) * n],  # noqa: E731
                                 payload["uniforms"], group=mesh.data_group(), spatial=ctx)
        with _counting_collectives() as calls:
            out["step"] = step()
        out["collectives"] = dict(calls)
        # the same step with the fused line moved to 0: every site takes the
        # route past it (every site's route before the fused window kernel),
        # the window counts summed over the grid
        with pytest.MonkeyPatch.context() as mp, _counting_collectives() as calls:
            mp.setattr(kdrop, "FUSED_MAX_HW", 0)
            out["step_past_line"] = step()
        out["collectives_past_line"] = dict(calls)
        if ctx.data_parts == 1:
            out["bl_remat"] = _bl_remat_pass(imgs, group=mesh.data_group(), spatial=ctx)
    finally:
        mesh.shutdown()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


# ---------------------------------------------------------------------------
# the test side (imports the reference)
# ---------------------------------------------------------------------------

def _reference_state(seed):
    """The reference's TrainState at step 5 (as tests/test_torch_train_step.py
    builds it)."""
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


def _leaves(tree):
    import jax

    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def spatial_runs(tmp_path_factory):
    """The port's spatial ranks for each grid (in the background), the
    reference's jitted unsharded step and the port's one-rank step."""
    import jax
    import jax.numpy as jnp

    from axcnn.core.dtypes import Policy as JPolicy
    from axcnn.core.rng import RngStream as JRngStream
    from axcnn.models.resnet import ModelConfig as JModelConfig
    from axcnn.train.schedules import make_lr_schedule as j_lr
    from axcnn.train.train_step import make_train_step as j_make_train_step
    from axcnn_torch.ckpt.convert import train_state_from_axcnn, train_state_to_axcnn

    workdir = tmp_path_factory.mktemp("spatial")
    rng = np.random.default_rng(91)
    batch = {"images": rng.integers(0, 256, (N, SIZE, SIZE, 3), dtype=np.uint8),
             "labels": rng.integers(0, 10, N).astype(np.int32)}
    root_key = jax.random.key(ROOT_KEY)
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "float32", jnp.float64)
        jstate = jax.tree.map(lambda a: np.asarray(a, np.float64) if a.dtype.kind == "f"
                              else a, _reference_state(90))
        draws = JRngStream(root_key).fold_step(jnp.int32(STEP))
        lam = np.asarray(jax.random.beta(draws("mixup"), 0.2, 0.2, dtype=jnp.float32))
        uniforms = {site: torch.from_numpy(np.array(jax.random.uniform(
            draws(site), (N, hw, hw, 1), jnp.float32))[..., 0]) for site, hw in SITES.items()}
        tstate = train_state_from_axcnn(jstate, ModelConfig(**CFG))
    payload = {"model": tstate.model.state_dict(), "velocity": tstate.velocity,
               "ema": tstate.ema, "lam": lam[()], "uniforms": uniforms,
               "images": torch.from_numpy(batch["images"]),
               "labels": torch.from_numpy(batch["labels"])}
    torch.save(payload, workdir / "inputs.pt")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    procs = {}
    for grid in GRIDS:
        world, port = grid[0] * grid[1], _free_port()
        gdir = workdir / f"grid{grid[0]}x{grid[1]}"
        gdir.mkdir()
        os.link(workdir / "inputs.pt", gdir / "inputs.pt")
        procs[grid] = [subprocess.Popen(
            [sys.executable, __file__, str(r), str(world), str(grid[1]), str(port), str(gdir)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
    try:
        with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
            mp.setattr(jnp, "float32", jnp.float64)
            policy = JPolicy(param_dtype=jnp.float32, compute_dtype=jnp.float32)
            jstep = jax.jit(j_make_train_step(JModelConfig(**CFG), lr_schedule=j_lr(**LR_KW),
                                              policy=policy, **STEP_KW))
            j_new, j_metrics = jstep(jstate, batch, root_key)
            want = (jstate, jax.tree.map(np.asarray, j_new), jax.device_get(j_metrics))
        one = _f64_step(payload, payload["images"], payload["labels"], uniforms)
        one["bl_remat"] = _bl_remat_pass(payload["images"])
        outs = {g: [p.communicate(timeout=600)[0] for p in ps] for g, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for g, ps in procs.items():
        for p, out in zip(ps, outs[g]):
            assert p.returncode == 0, out[-4000:]
    ranks = {g: [torch.load(workdir / f"grid{g[0]}x{g[1]}" / f"rank{r}.pt", weights_only=False)
                 for r in range(g[0] * g[1])] for g in GRIDS}

    def to_tree(out):
        _, state = _port_state(payload)
        state.model.load_state_dict({**out["params"], **out["buffers"]})
        state.velocity, state.ema, state.step = out["velocity"], out["ema"], out["step"]
        with pytest.MonkeyPatch.context() as mp:  # the converter's fp32 cast, re-pointed
            mp.setattr(torch.Tensor, "float", lambda self: self.double())
            return jax.tree.map(lambda a: np.asarray(a, np.float64), train_state_to_axcnn(state))

    trees = {g: to_tree(rs[0]["step"]) for g, rs in ranks.items()}
    return dict(want=want, one=one, ranks=ranks, trees=trees, payload=payload)


def _fields(out):
    return {"params": out["params"], "velocity": out["velocity"], "ema": out["ema"],
            "buffers": out["buffers"]}


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"D{g[0]}xS{g[1]}")
def test_spatial_step_equals_the_one_rank_step(spatial_runs, grid):
    """Loss, every parameter's update, the velocity, the EMA and the BN
    moving statistics, relative 1e-10 per tensor (of the update where one
    is taken); top-1 and lambda equal."""
    one, got = spatial_runs["one"], spatial_runs["ranks"][grid][0]["step"]
    _, old = _port_state(spatial_runs["payload"])
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
    print(f"worst {key}: {worst[key]:.3g}")
    assert worst[key] <= 1e-10, (key, worst[key])


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"D{g[0]}xS{g[1]}")
def test_spatial_ranks_end_the_step_alike(spatial_runs, grid):
    """Every rank of the grid holds the same state and metrics after the
    step (replicas)."""
    ranks = [r["step"] for r in spatial_runs["ranks"][grid]]
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"] and r["eval"] == ranks[0]["eval"]
        for field, tensors in _fields(ranks[0]).items():
            for k, t in tensors.items():
                assert torch.equal(r[field][k], t), (field, k)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"D{g[0]}xS{g[1]}")
def test_spatial_step_matches_the_reference(spatial_runs, grid):
    """Against the reference's jitted unsharded step (``axis_name=None``),
    float64: loss rtol 1e-7, the update and the velocity <= 1e-6 per leaf,
    BN statistics rtol 1e-7, EMA rtol and atol 1e-7 (the bounds of
    tests/test_torch_train_step.py)."""
    old, new, jm = spatial_runs["want"]
    tree, tm = spatial_runs["trees"][grid], spatial_runs["ranks"][grid][0]["step"]["metrics"]
    np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=1e-7)
    assert tm["train_top1"] == float(jm["train_top1"])
    np.testing.assert_allclose(tm["mixup_lam"], float(jm["mixup_lam"]), rtol=1e-7)
    for field in ("params", "velocity"):
        o, n, p = _leaves(getattr(old, field)), _leaves(getattr(new, field)), _leaves(tree[field])
        assert set(p) == set(n)
        errs = {k: _rel(torch.from_numpy(np.asarray(p[k] - o[k])),
                        torch.from_numpy(np.asarray(n[k] - o[k]))) for k in n}
        k = max(errs, key=errs.get)
        assert errs[k] <= 1e-6, (field, k, errs[k])
    ref, mine = _leaves(new.model_state), _leaves(tree["model_state"])
    for k in ref:
        np.testing.assert_allclose(mine[k], ref[k], rtol=1e-7, atol=1e-10, err_msg=k)
    ref, mine = _leaves(new.ema), _leaves(tree["ema"])
    for k in ref:
        np.testing.assert_allclose(mine[k], ref[k], rtol=1e-7, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"D{g[0]}xS{g[1]}")
def test_spatial_dropblock_sites_issue_no_collective(spatial_runs, grid):
    """Within the fused line no DropBlock site calls ``global_counts``: on
    every rank the step issues one all-reduce a site fewer (the window
    counts' sum over the row) and, with two data shards, one all-gather a
    site fewer (their counts) than the same step with the line moved to 0,
    the route every site took before; and the two end in the same state,
    bit for bit."""
    sites, data = len(SITES), grid[0]
    for r in spatial_runs["ranks"][grid]:
        now, past = r["collectives"], r["collectives_past_line"]
        assert now["global_counts"] == 0 and past["global_counts"] == sites
        assert past["all_reduce"] - now["all_reduce"] == sites
        assert past["all_gather"] - now["all_gather"] == (sites if data > 1 else 0)
        assert r["step_past_line"]["metrics"] == r["step"]["metrics"]
        for field, tensors in _fields(r["step"]).items():
            for k, t in tensors.items():
                assert torch.equal(r["step_past_line"][field][k], t), (field, k)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"D{g[0]}xS{g[1]}")
def test_spatial_eval_counts_each_image_once(spatial_runs, grid):
    """The eval's sums over the data column equal the one-rank eval's on the
    global batch: count and top-k exactly, the loss to 1e-10."""
    one, got = spatial_runs["one"]["eval"], spatial_runs["ranks"][grid][0]["step"]["eval"]
    assert got["count"] == one["count"] == N
    assert got["top1"] == one["top1"] and got["top5"] == one["top5"]
    assert abs(got["loss_sum"] - one["loss_sum"]) <= 1e-10 * abs(one["loss_sum"])


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"D{g[0]}xS{g[1]}")
def test_halo_exchange_and_its_transpose(spatial_runs, grid):
    """``SpatialContext.halo`` on each rank: its rows are the padded
    tensor's; the gradient each rank gets back is its rows' share of every
    rank's cotangent (zeros at the image's border)."""
    ranks = spatial_runs["ranks"][grid]
    parts = grid[1]
    for row in range(grid[0]):
        members = ranks[row * parts:(row + 1) * parts]
        x = _input((2, 3, 8 * parts, 5), 11).detach()
        xp = F.pad(x, (0, 0, 2, 1)).requires_grad_()
        total = torch.zeros_like(xp)
        for s, r in enumerate(members):
            xh, _, gy = r["halo"]
            assert torch.equal(xh, xp[:, :, 8 * s:8 * s + 11].detach())
            total[:, :, 8 * s:8 * s + 11] += gy
        for s, r in enumerate(members):
            assert _rel(r["halo"][1], total[:, :, 2 + 8 * s:2 + 8 * (s + 1)]) <= REL


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"D{g[0]}xS{g[1]}")
def test_mixup_pairs_with_the_mirror_data_shard(spatial_runs, grid):
    """Rank (d, s) receives rank (D - 1 - d, s)'s rows and labels: its own
    with one data shard, the other shard's with two."""
    payload, (dd, parts) = spatial_runs["payload"], grid
    n = N // dd
    for r in spatial_runs["ranks"][grid]:
        d, s = r["grid"][:2]
        images, labels = r["mirror"]
        p = dd - 1 - d
        want = payload["images"][p * n:(p + 1) * n, s * SIZE // parts:(s + 1) * SIZE // parts]
        assert torch.equal(images, want)
        assert torch.equal(labels, payload["labels"][p * n:(p + 1) * n])


# ---------------------------------------------------------------------------
# what was refused until ported, and what still is
# ---------------------------------------------------------------------------

def test_the_model_refuses_big_little_and_remat_under_spatial(spatial_runs):
    """No longer refused: on the D1xS2 ranks a Big-Little model with
    ``remat="blocks"`` runs a train forward and backward (sync-BN over both
    ranks, the replay's collectives in the backward) whose logits are the
    one-rank pass's and whose two ranks' gradients add up to its gradients,
    relative 1e-10 per tensor; the BN moving statistics are updated once,
    as the one-rank pass updates them."""
    one = spatial_runs["one"]["bl_remat"]
    ranks = [r["bl_remat"] for r in spatial_runs["ranks"][(1, 2)]]
    for r in ranks:
        assert _rel(r["logits"], one["logits"]) <= 1e-10
        for k, moved in one["moved"].items():
            assert _rel(r["moved"][k], moved) <= 1e-10, k
    worst = {k: _rel(sum(r["grads"][k] for r in ranks), g) for k, g in one["grads"].items()}
    key = max(worst, key=worst.get)
    assert worst[key] <= 1e-10, (key, worst[key])


def test_the_step_refuses_what_it_does_not_take_under_spatial():
    """The spatially partitioned step is the global-batch step: it needs the
    group of every rank with sync-BN. It takes gradient accumulation, a KD
    teacher and device AutoAugment."""
    ctx = sp.SpatialContext(index=0, parts=2, data_index=0, data_parts=1, row_group=None)
    cfg = ModelConfig(width_multiplier=0.125, num_classes=10)
    for kw in (dict(group=object(), sync_bn=False), {}):
        with pytest.raises(NotImplementedError, match="process group of every rank with sync-BN"):
            make_train_step(cfg, lr_schedule=t_lr(**LR_KW), spatial=ctx, **kw, **STEP_KW)
    teacher = create_train_state(cfg, generator=torch.Generator(), device="cpu").model
    for kw in (dict(grad_accum_steps=2), dict(autoaugment_fn=len), dict(teacher=teacher)):
        assert callable(make_train_step(cfg, lr_schedule=t_lr(**LR_KW), spatial=ctx,
                                        group=object(), **kw, **STEP_KW))


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
               sys.argv[5])

