"""The port's device AutoAugment (axcnn_torch.data.autoaugment_device)
against the JAX reference's (axcnn.data.autoaugment_device), on the CPU.

Tolerances, on the [0, 255] pixel scale:

- each op against the reference's ``_OP_FNS[name]`` run op by op, on
  integer images (an op's first input) and on fractional ones (a second
  op's): the integer-valued ops (Posterize, Solarize, SolarizeAdd, Invert,
  Cutout) and Equalize exactly; AutoContrast exactly on integer images; the
  warps and enhances within 1e-4 (measured: the warps exact, Contrast and
  Sharpness 3.1e-5 from the sum order of a mean or a 3x3 stencil);
- the applicator, handed the reference's own draws (recomputed here from its
  key with ``jax.random``), within 1e-4 of the reference run op by op
  (``jax.disable_jit``). The reference's compiled applicator lies up to
  1.6e-3 from its own op-by-op run (XLA contracts the warps' multiply-adds),
  so against it the bound is 1e-2;
- the distribution against the port's host (PIL) AutoAugment, with the
  bounds of ``tests/test_autoaugment_device.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from axcnn.data import autoaugment_device as j_aa
from axcnn_torch.data import autoaugment as host_aa
from axcnn_torch.data import autoaugment_device as t_aa
from axcnn_torch.data.autoaugment import POLICIES

EXACT = {"Posterize", "Solarize", "SolarizeAdd", "Invert", "Equalize", "Cutout"}
MAGS = (0, 3, 7, 10)
SIGNS = np.array([1, -1, 1, -1], np.float32)


def _images(kind, seed=0, shape=(4, 40, 48, 3)):
    rng = np.random.default_rng(seed)
    ints = rng.integers(0, 256, shape).astype(np.float32)
    if kind == "integer":
        return ints
    return np.clip(ints * 0.7 + rng.random(shape, np.float32) * 60, 0, 255).astype(np.float32)


def _reference_op(name, imgs, mag):
    return np.stack([np.asarray(j_aa._OP_FNS[name](jnp.asarray(im), jnp.float32(mag),
                                                   jnp.float32(s)))
                     for im, s in zip(imgs, SIGNS)])


def test_op_table_matches_reference():
    assert list(t_aa.OP_FNS) == list(j_aa._OP_FNS)


@pytest.mark.parametrize("kind", ["integer", "fractional"])
@pytest.mark.parametrize("name", list(j_aa._OP_FNS))
def test_op_matches_reference(name, kind):
    imgs = _images(kind, seed=len(name))
    for mag in MAGS:
        got = t_aa.OP_FNS[name](torch.from_numpy(imgs), mag, SIGNS).numpy()
        want = _reference_op(name, imgs, mag)
        assert got.shape == want.shape and got.dtype == np.float32
        exact = name in EXACT or (name == "AutoContrast" and kind == "integer")
        np.testing.assert_allclose(got, want, rtol=0, atol=0 if exact else 1e-4,
                                   err_msg=f"{name} mag {mag}")


@pytest.mark.parametrize("case", ["flat", "two_levels", "one_channel_flat", "sparse"])
def test_equalize_edge_histograms_match_reference(case):
    """Equalize's LUT where the TF rule degenerates: one level (step 0: the
    identity), two levels, one flat channel, a few levels only."""
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (2, 16, 20, 3)).astype(np.float32)
    if case == "flat":
        imgs[:] = 77.0
    elif case == "two_levels":
        imgs = np.where(imgs < 128, 10.0, 240.0).astype(np.float32)
    elif case == "one_channel_flat":
        imgs[..., 1] = 3.0
    else:
        imgs = (imgs // 64 * 64).astype(np.float32)
    got = t_aa.equalize(torch.from_numpy(imgs)).numpy()
    want = np.asarray(j_aa._equalize_batch(jnp.asarray(imgs)))
    np.testing.assert_array_equal(got, want)


def _reference_draws(key, n, groups, num_sub):
    """The reference applicator's draws from its key (make_device_autoaugment:
    a key per group, then sub-policy, coins and signs)."""
    m = n // groups
    draws = []
    for kg in jax.random.split(key, groups):
        k_sub, k_coin, k_sign = jax.random.split(kg, 3)
        sub = int(jax.random.randint(k_sub, (), 0, num_sub))
        coins = np.asarray(jax.random.uniform(k_coin, (2, m)))
        signs = np.asarray(jnp.where(jax.random.uniform(k_sign, (2, m)) < 0.5, -1.0, 1.0),
                           np.float32)
        draws.append((sub, coins, signs))
    return draws


@pytest.mark.parametrize("policy,seed", [("v0", 0), ("v0", 3), ("imagenet", 1)])
def test_applicator_with_the_reference_draws(policy, seed):
    imgs = np.random.default_rng(seed).integers(0, 256, (8, 32, 40, 3), dtype=np.uint8)
    key = jax.random.key(seed)
    draws = _reference_draws(key, 8, 4, len(POLICIES[policy]))
    got = t_aa.make_device_autoaugment(policy, num_groups=4)(torch.from_numpy(imgs),
                                                             draws=draws).numpy()
    ref = j_aa.make_device_autoaugment(policy, num_groups=4)
    with jax.disable_jit():
        op_by_op = np.asarray(ref(key, jnp.asarray(imgs)))
    compiled = np.asarray(jax.jit(ref)(key, jnp.asarray(imgs)))
    np.testing.assert_allclose(got, op_by_op, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, compiled, rtol=0, atol=1e-2)
    assert not np.array_equal(got, imgs.astype(np.float32))  # the draws applied ops


def test_applicator_draws_on_the_host_and_is_deterministic():
    fn = t_aa.make_device_autoaugment("v0")
    imgs = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (16, 24, 24, 3),
                                                              dtype=np.uint8))
    a = fn(imgs, np.random.default_rng(7))
    b = fn(imgs, np.random.default_rng(7))
    c = fn(imgs, np.random.default_rng(8))
    assert a.shape == imgs.shape and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.min() >= 0 and a.max() <= 255
    # the draws: one entry per group, in the applicator's order
    draws = t_aa.draw_autoaugment(np.random.default_rng(7), len(POLICIES["v0"]), 8, 2)
    assert torch.equal(fn(imgs, draws=draws), a)
    assert [d[1].shape for d in draws] == [(2, 2)] * 8
    assert all(set(np.unique(d[2])) <= {-1.0, 1.0} for d in draws)


def test_one_group_when_the_batch_does_not_divide():
    assert t_aa.num_groups_for(12, 8) == 1 and t_aa.num_groups_for(16, 8) == 8
    fn = t_aa.make_device_autoaugment("v0", num_groups=8)
    imgs = torch.zeros((12, 8, 8, 3), dtype=torch.uint8)
    draws = t_aa.draw_autoaugment(np.random.default_rng(0), len(POLICIES["v0"]), 1, 12)
    assert fn(imgs, draws=draws).shape == imgs.shape
    with pytest.raises(ValueError, match="draws for 1 groups"):
        fn(imgs, draws=draws * 2)


def test_none_and_unknown_policies():
    assert t_aa.make_device_autoaugment("none") is None
    with pytest.raises(ValueError, match="unknown autoaugment_type"):
        t_aa.make_device_autoaugment("v9")


# -- the distribution against the port's host (PIL) AutoAugment ----------------

def _host(name, img_u8, mag):
    """The host op with a rigged RNG: a positive sign, central positions."""
    class FixedRng:
        def random(self):
            return 0.9

        def integers(self, lo, hi=None):
            return (lo + hi) // 2 if hi else lo

    return np.asarray(host_aa.NAME_TO_OP[name](Image.fromarray(img_u8), mag, FixedRng()),
                      np.float32)


def _device(name, img_u8, mag):
    return t_aa.OP_FNS[name](torch.from_numpy(img_u8[None].astype(np.float32)), mag,
                             np.ones(1, np.float32))[0].numpy()


def _smooth_img(h=48, w=64):
    x = np.linspace(0, 255, w, dtype=np.float32)
    y = np.linspace(0, 200, h, dtype=np.float32)
    img = x[None, :, None] * 0.6 + y[:, None, None] * 0.4
    img = np.concatenate([img, 255 - img, img * 0.5], axis=-1)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("name,mag", [
    ("Posterize", 6), ("Solarize", 3), ("Solarize", 10), ("SolarizeAdd", 7),
    ("Invert", 0), ("AutoContrast", 0), ("Equalize", 0)])
def test_pointwise_ops_match_host(name, mag):
    img = np.random.default_rng(1).integers(0, 256, (48, 64, 3)).astype(np.uint8)
    np.testing.assert_allclose(_device(name, img, mag), _host(name, img, mag), atol=1.0)


@pytest.mark.parametrize("name,mag", [("Color", 9), ("Contrast", 8), ("Brightness", 5),
                                      ("Sharpness", 7)])
def test_enhance_ops_close_to_host(name, mag):
    img = np.random.default_rng(2).integers(0, 256, (48, 64, 3)).astype(np.uint8)
    diff = np.abs(_device(name, img, mag) - _host(name, img, mag))
    assert np.mean(diff) < 2.0, (name, np.mean(diff))
    assert np.percentile(diff, 99) <= 6.0, (name, np.percentile(diff, 99))


@pytest.mark.parametrize("name,mag", [("ShearX", 5), ("ShearY", 5), ("TranslateX", 6),
                                      ("TranslateY", 6), ("Rotate", 6)])
def test_geometric_ops_close_to_host_on_smooth_images(name, mag):
    img = _smooth_img()
    gi, wi = _device(name, img, mag)[6:-6, 6:-6], _host(name, img, mag)[6:-6, 6:-6]
    mask = np.all(np.abs(wi - 128.0) > 0.5, axis=-1)  # skip the fill
    if mask.sum() > 100:  # a translation by 60 of 64 columns leaves fill only
        assert np.mean(np.abs(gi - wi)[mask]) < 8.0


def test_identity_warp():
    img = _images("integer")
    eye = np.tile(np.array([[1, 0, 0], [0, 1, 0]], np.float32), (len(img), 1, 1))
    out = t_aa.affine_warp(torch.from_numpy(img), eye).numpy()
    np.testing.assert_array_equal(out, img)
