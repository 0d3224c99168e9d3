"""Big-Little stages and the rest of the model surface (``sk_merged_conv``,
``anti_alias_filter_size`` 1-7) in the port's model, against the JAX
reference's ``resnet_apply``, on the CPU.

Weights are the reference's own tree filled from a numpy seed, as in
tests/test_torch_model.py, carried into the port by the converter's leaf
rule. Inputs: 64x64, where every Big-Little merge is an exact 2x upsample
(the stage-2 big map 4 -> 8, stage 3's 2 -> 4), and 72x72, where the
stage-2 merge is 5 -> 9 and the stage-3 merge 3 -> 5, so the upsample's
rounding shows: ``jax.image.resize``'s ``nearest`` takes half-pixel
centres, as ``F.interpolate``'s ``nearest-exact`` does and ``nearest`` does
not. fp32, rtol 1e-4 with atol 1e-4 of the largest logit (as
tests/test_torch_model.py); the train-mode BN statistics rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from axcnn.core.tree import tree_count_params
from axcnn.models.resnet import ModelConfig as JModelConfig
from axcnn.models.resnet import resnet_apply, resnet_init
from axcnn_torch.ckpt.convert import from_axcnn, to_axcnn
from axcnn_torch.models.resnet import BLStage, ModelConfig, ResNet
from axcnn_torch.utils.config import load_preset
from test_torch_model import SMALL, _images, _jax_logits, _pair, _random_tree
import torch_inprocess

capped_threads = torch_inprocess.capped_threads

BL = dict(bl_alpha=2, bl_beta=4)
VARIANTS = {
    # the bl_resnet50 preset's model
    "bl_preset": dict(BL, use_resnet_d=True, zero_gamma=True),
    # the reference's assembly combination on Big-Little, SK as one 5x5 conv
    "bl_assembled": dict(BL, use_resnet_d=True, use_se_block=True, use_sk_block=True,
                         sk_merged_conv=True, anti_alias_type="sconv", use_dropblock=True,
                         zero_gamma=True),
    # the stem's blurred max pool and the blurred projection, 5x5 and 2x2
    # filters (even: asymmetric fixed padding)
    "max_filter5": dict(use_se_block=True, anti_alias_type="max", anti_alias_filter_size=5),
    "proj_filter2": dict(use_sk_block=True, sk_merged_conv=True, anti_alias_type="proj",
                         anti_alias_filter_size=2),
}


def _logit_tol(want):
    return dict(rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("size", [64, 72])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_eval_logits_match(variant, size):
    kw = {**VARIANTS[variant], **SMALL}
    params, state, model = _pair(kw, seed=20)
    x = _images(21, size=size)
    want = _jax_logits(params, state, x, kw)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, **_logit_tol(want))


@pytest.mark.parametrize("size", [64, 72])
def test_train_logits_and_bn_statistics_match(size):
    """Train mode (batch statistics, no DropBlock): the logits and every new
    BN moving statistic, the little branch's projection BN included."""
    kw = {**VARIANTS["bl_preset"], **SMALL}
    params, state, model = _pair(kw, seed=22)
    x = _images(23, n=4, size=size)
    cfg = JModelConfig(**kw)
    want, new_state = jax.jit(lambda p, s, x: resnet_apply(p, s, x, cfg=cfg, train=True))(
        params, state, x)
    got = model.train()(torch.from_numpy(x), train=True)
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, **_logit_tol(want))
    _, got_state = to_axcnn(model.state_dict())
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)  # noqa: E731
                      for k, v in jax.tree_util.tree_leaves_with_path(t)}
    want_s, got_s = flat(new_state), flat(got_state)
    assert set(got_s) == set(want_s)
    assert any("little_proj_bn" in k for k in got_s)
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_stage_layout_and_names():
    """Stages 2-3 are Big-Little: entry, n-1 big blocks, max(1, n // 4)
    little blocks at half width, the projection back; the converter's leaf
    rule carries the reference's tree both ways."""
    kw = {**VARIANTS["bl_preset"], **SMALL}
    model = ResNet(ModelConfig(**kw))
    for s, n in ((2, 4), (3, 6)):
        stage = getattr(model, f"stage{s}")
        assert isinstance(stage, BLStage)
        assert list(stage.big) == [f"block{b}" for b in range(n - 1)]
        assert list(stage.little) == ["block0"]
        assert stage.big.block0.stride == 2 and hasattr(stage.big.block0, "proj_conv")
        assert stage.little.block0.conv1.weight.shape[0] == 16  # max(filters // 2, 16)
    assert not isinstance(model.stage4, BLStage)
    params, state = _random_tree(kw, 24)
    sd = from_axcnn(params, state, ModelConfig(**kw))
    assert "stage2.little_proj.weight" in sd and "stage3.big.block4.bn3.weight" in sd
    p2, s2 = to_axcnn(sd)
    for want, got in ((params, p2), (state, s2)):
        assert jax.tree.structure(want) == jax.tree.structure(got)
        jax.tree.map(np.testing.assert_array_equal, want, got)


def test_preset_builds_at_full_width_with_the_reference_parameter_count():
    cfg = dataclasses.replace(load_preset("bl_resnet50").model, num_classes=1001)
    with torch.device("meta"):
        model = ResNet(cfg)
    p_shape, _ = jax.eval_shape(
        lambda k: resnet_init(k, JModelConfig(**dataclasses.asdict(cfg))), jax.random.key(0))
    assert sum(p.numel() for p in model.parameters()) == tree_count_params(p_shape)


@pytest.mark.parametrize("src,dst", [(7, 14), (13, 25), (4, 8), (3, 5)])
def test_merge_upsample_rounds_as_the_reference(src, dst):
    """``nearest-exact`` equals ``jax.image.resize(..., "nearest")``; plain
    ``nearest`` does not whenever the target is not exactly twice the
    source."""
    x = np.random.default_rng(src).standard_normal((1, src, src, 2)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, dst, dst, 2), method="nearest"))
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    exact = F.interpolate(t, size=(dst, dst), mode="nearest-exact").permute(0, 2, 3, 1)
    np.testing.assert_array_equal(exact.numpy(), want)
    plain = F.interpolate(t, size=(dst, dst), mode="nearest").permute(0, 2, 3, 1)
    assert np.array_equal(plain.numpy(), want) == (dst == 2 * src)


def test_dropblock_sits_at_the_big_little_stage_output(monkeypatch):
    """Stage 3's site is its output, ``dropblock/stage3/out``; stage 4 keeps
    one site a block."""
    import axcnn_torch.models.resnet as resnet
    from axcnn_torch.core.rng import RngStream

    shapes = {}
    drop = resnet.dropblock

    def recording(x, seeds, **kw):
        shapes[len(shapes)] = tuple(x.shape)
        return drop(x, seeds, **kw)

    monkeypatch.setattr(resnet, "dropblock", recording)
    kw = {**VARIANTS["bl_assembled"], **SMALL}
    model = ResNet(ModelConfig(**kw))
    sites = {}
    uniforms = _SiteRecorder(sites)
    model.train()(torch.rand(2, 64, 64, 3), train=True, rng=RngStream(1).fold_step(0),
                  progress=0.5, dropblock_uniforms=uniforms)
    assert list(sites) == ["dropblock/stage3/out"] + [f"dropblock/stage4/block{b}"
                                                      for b in range(3)]
    assert list(shapes.values()) == [(2, 128, 4, 4)] + [(2, 256, 2, 2)] * 3


class _SiteRecorder(dict):
    """A ``dropblock_uniforms`` dict that records the sites asked for."""

    def __init__(self, seen):
        super().__init__(unused=None)  # not empty, so the model keeps it
        self.seen = seen

    def get(self, key, default=None):
        self.seen[key] = True
        return default
