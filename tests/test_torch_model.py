"""Model-level parity of the PyTorch port (axcnn_torch.models.resnet) against
the JAX reference (axcnn.models.resnet), on the CPU.

Weights are the reference's own tree (structure from ``jax.eval_shape`` of
``resnet_init``), filled from a numpy seed: conv weights He-scaled, every BN
gamma/beta/mean/var and every bias perturbed, and every ``bn3`` gamma small
and non-zero (U(0.1, 0.3)) so that no residual branch is zeroed out, as
``zero_gamma`` would do. The tree goes through ``ckpt.convert.from_axcnn``
into the port; both models then see the same numpy images.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from axcnn.core.dtypes import BF16_POLICY as J_BF16
from axcnn.core.tree import tree_count_params
from axcnn.models.resnet import ModelConfig as JModelConfig
from axcnn.models.resnet import resnet_apply, resnet_init
from axcnn.ops.conv import dense_apply
from axcnn.ops.pooling import global_avg_pool as j_gap
from axcnn_torch.ckpt.convert import from_axcnn, to_axcnn
from axcnn_torch.core.dtypes import BF16_POLICY
from axcnn_torch.models.resnet import ModelConfig, ResNet
from axcnn_torch.ops.conv import Dense
from axcnn_torch.ops.pooling import global_avg_pool

SMALL = dict(width_multiplier=0.125, num_classes=10)
ASSEMBLED = dict(use_resnet_d=True, use_se_block=True, use_sk_block=True,
                 anti_alias_type="sconv", use_dropblock=True, zero_gamma=True)
VARIANTS = {
    "vanilla": {},
    "assembled_sconv": ASSEMBLED,
    # without ResNet-D the projection shortcut is blurred too
    "proj": dict(use_se_block=True, use_sk_block=True, anti_alias_type="proj"),
    "max": dict(use_se_block=True, anti_alias_type="max"),
}


def _random_tree(kw, seed):
    p_shape, s_shape = jax.eval_shape(
        lambda k: resnet_init(k, JModelConfig(**kw)), jax.random.key(0))
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

    fill_tree = lambda t: jax.tree_util.tree_map_with_path(fill, t)  # noqa: E731
    return fill_tree(p_shape), fill_tree(s_shape)


def _pair(kw, seed=0):
    params, state = _random_tree(kw, seed)
    model = ResNet(ModelConfig(**kw))
    model.load_state_dict(from_axcnn(params, state, ModelConfig(**kw)), strict=True)
    return params, state, model.eval()


def _jax_logits(params, state, x, kw, policy=None):
    cfg = JModelConfig(**kw)
    extra = {} if policy is None else {"policy": policy}
    fwd = jax.jit(lambda p, s, x: resnet_apply(p, s, x, cfg=cfg, train=False,
                                               **extra)[0])
    return np.asarray(fwd(params, state, x))


def _images(seed, n=2, size=64):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# converter
# ---------------------------------------------------------------------------

def test_converter_round_trip():
    kw = {**ASSEMBLED, **SMALL}
    params, state = _random_tree(kw, 1)
    sd = from_axcnn(params, state, ModelConfig(**kw))
    assert sd["stem.conv0.weight"].shape == (32, 3, 3, 3)  # HWIO -> OIHW
    assert sd["head.weight"].shape == (10, 256)  # (in, out) -> (out, in)
    p2, s2 = to_axcnn(sd)
    for want, got in ((params, p2), (state, s2)):
        assert jax.tree.structure(want) == jax.tree.structure(got)
        jax.tree.map(np.testing.assert_array_equal, want, got)


def test_converter_refuses_a_tree_of_another_model():
    params, state = _random_tree({**SMALL}, 2)
    with pytest.raises(ValueError, match="does not match the model"):
        from_axcnn(params, state, ModelConfig(**ASSEMBLED, **SMALL))


# ---------------------------------------------------------------------------
# parameter counts at full width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,count", [
    (50, 25_557_032), (101, 44_549_160), (152, 60_192_808)])
def test_param_count_vanilla(size, count):
    """docs/DESIGN.md: canonical ResNet-v1 counts, 1000 classes."""
    with torch.device("meta"):
        model = ResNet(ModelConfig(resnet_size=size))
    assert sum(p.numel() for p in model.parameters()) == count


def test_param_count_assembled_matches_reference():
    kw = dict(ASSEMBLED, num_classes=1001)
    p_shape, _ = jax.eval_shape(
        lambda k: resnet_init(k, JModelConfig(**kw)), jax.random.key(0))
    with torch.device("meta"):
        model = ResNet(ModelConfig(**kw))
    assert sum(p.numel() for p in model.parameters()) == tree_count_params(p_shape)


# ---------------------------------------------------------------------------
# logits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_match_fp32(variant):
    """fp32, R50 at width 0.125, 64x64, batch 2. rtol 1e-4, with atol 1e-4 of
    the largest logit (fp32 sums reassociated over ~50 layers)."""
    kw = {**VARIANTS[variant], **SMALL}
    params, state, model = _pair(kw, seed=3)
    x = _images(4)
    want = _jax_logits(params, state, x, kw)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_head_rounds_pooled_features_to_compute_dtype():
    """GAP returns the activation dtype, so under bf16 the pooled features are
    rounded to bf16 before the fp32 head, as in the reference."""
    rng = np.random.default_rng(5)
    feat = rng.standard_normal((2, 7, 7, 64)).astype(np.float32)
    w, b = rng.standard_normal((64, 10)).astype(np.float32), np.zeros(10, np.float32)
    want = dense_apply({"w": w, "b": b}, j_gap(jnp.asarray(feat, jnp.bfloat16)),
                       compute_dtype=jnp.float32)
    head = Dense(64, 10, std=0.01)
    head.load_state_dict({"weight": torch.from_numpy(w.T.copy()),
                          "bias": torch.from_numpy(b)})
    pooled = global_avg_pool(torch.from_numpy(feat).permute(0, 3, 1, 2)
                             .to(torch.bfloat16))
    got = head(pooled, torch.float32).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    unrounded = feat.mean(axis=(1, 2)) @ w
    assert np.abs(unrounded - np.asarray(want)).max() > 1e-3  # rounding is visible


def test_logits_match_bf16():
    """bf16 policy on both sides. The two frameworks round the same tensors
    to bf16 but accumulate convs in another order, so the logits agree to a
    relative L2 of 1e-2 (bf16 keeps ~3 significant digits), and the port's
    bf16 logits are nearer the reference's bf16 logits than its own fp32
    ones: it rounds where the reference rounds."""
    kw = {**ASSEMBLED, **SMALL}
    params, state, model = _pair(kw, seed=6)
    x = _images(7)
    want = _jax_logits(params, state, x, kw, policy=J_BF16)
    with torch.inference_mode():
        got = model(torch.from_numpy(x), policy=BF16_POLICY).numpy()
        fp32 = model(torch.from_numpy(x)).numpy()
    err = _rel_l2(got, want)
    assert err < 1e-2, err
    assert err < _rel_l2(fp32, want), (err, _rel_l2(fp32, want))


def test_unported_features_refused():
    for kw in (dict(bl_alpha=2, bl_beta=4), dict(scan_blocks=True),
               dict(sk_merged_conv=True, use_sk_block=True),
               dict(anti_alias_type="sconv", anti_alias_filter_size=5)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ResNet(ModelConfig(**kw, **SMALL))
    with torch.device("meta"):
        model = ResNet(ModelConfig(**SMALL))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model(torch.zeros(1, 32, 32, 3, device="meta"), train=True)


def test_eval_ignores_dropblock_and_remat():
    kw = {**ASSEMBLED, **SMALL}
    _, _, model = _pair(kw, seed=8)
    other = ResNet(dataclasses.replace(ModelConfig(**kw), use_dropblock=False,
                                       remat="blocks"))
    other.load_state_dict(model.state_dict())
    x = torch.from_numpy(_images(9, n=1, size=32))
    with torch.inference_mode():
        assert torch.equal(model(x), other.eval()(x))


# ---------------------------------------------------------------------------
# eval step (EMA swap), top-k and padding
# ---------------------------------------------------------------------------

def test_eval_step_with_ema_swap_matches_reference():
    """BASELINE config 3: evaluate the EMA weights. The EMA tree differs from
    the raw params, so a step that ignored the swap would disagree."""
    from axcnn.train.train_step import TrainState as JTrainState
    from axcnn.train.train_step import make_eval_step as j_make_eval_step
    from axcnn.train.train_step import pad_batch as j_pad_batch
    from axcnn_torch.train.train_step import TrainState, make_eval_step, pad_batch

    kw = {**ASSEMBLED, **SMALL}
    params, state, model = _pair(kw, seed=10)
    ema, _ = _random_tree(kw, 11)
    rng = np.random.default_rng(12)
    batch = {"images": rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8),
             "labels": np.array([1, 7, 4], np.int32)}
    j_batch = j_pad_batch(batch, 4)
    t_batch = pad_batch({k: torch.from_numpy(v) for k, v in batch.items()}, 4)
    for k in j_batch:
        np.testing.assert_array_equal(t_batch[k].numpy(), j_batch[k])

    j_state = JTrainState(step=0, params=params, model_state=state, velocity=None,
                          ema=ema)
    want = jax.jit(j_make_eval_step(JModelConfig(**kw), use_ema=True))(j_state, j_batch)
    ema_sd = from_axcnn(ema, state, ModelConfig(**kw))
    t_state = TrainState(model=model,
                         ema={k: ema_sd[k] for k, _ in model.named_parameters()})
    got = make_eval_step(ModelConfig(**kw), use_ema=True)(t_state, t_batch)
    assert got["count"].item() == 3.0
    for k in ("top1", "top5", "count"):
        assert got[k].item() == float(want[k]), k
    np.testing.assert_allclose(got["loss_sum"].item(), float(want["loss_sum"]),
                               rtol=1e-5)
    raw = make_eval_step(ModelConfig(**kw), use_ema=False)(t_state, t_batch)
    assert raw["loss_sum"].item() != got["loss_sum"].item()


def test_load_ema_serves_what_the_swap_evaluates():
    """Serving loads the EMA into the model once; its plain forward must give
    the logits that the per-call swap of the eval step gives."""
    from axcnn_torch.train.train_step import TrainState, eval_logits, load_ema

    kw = {**ASSEMBLED, **SMALL}
    _, state, model = _pair(kw, seed=14)
    ema, _ = _random_tree(kw, 15)
    ema_sd = from_axcnn(ema, state, ModelConfig(**kw))
    t_state = TrainState(model=model,
                         ema={k: ema_sd[k] for k, _ in model.named_parameters()})
    u8 = torch.from_numpy(np.random.default_rng(16).integers(
        0, 256, (2, 32, 32, 3), dtype=np.uint8))
    raw = eval_logits(t_state, u8)
    swapped = eval_logits(t_state, u8, use_ema=True)
    load_ema(t_state)
    served = eval_logits(t_state, u8)
    # the loaded copy sits in the model's channels_last memory and the swapped
    # one does not, so the convs may sum in another order: fp32 rounding only
    assert (raw - swapped).abs().max() > 1e-2
    torch.testing.assert_close(served, swapped, rtol=1e-5, atol=1e-5)


def test_topk_correct_matches_reference():
    from axcnn.train.train_step import topk_correct as j_topk
    from axcnn_torch.train.train_step import topk_correct

    rng = np.random.default_rng(13)
    for classes in (3, 10):
        logits = rng.standard_normal((16, classes)).astype(np.float32)
        labels = rng.integers(-1, classes, 16).astype(np.int32)
        want = j_topk(logits, labels)
        got = topk_correct(torch.from_numpy(logits), torch.from_numpy(labels))
        assert {k: v.item() for k, v in got.items()} == {
            k: float(v) for k, v in want.items()}
