"""The training path's pieces in the PyTorch port, held against the JAX
reference on the CPU: the BlurPool backward, DropBlock, the named random
streams, train-mode BN and SK, the loss, the weight-decay mask, momentum
SGD, EMA, the LR schedule and mixup.

Inputs are drawn from numpy seeds and fed to both packages (NHWC on the JAX
side, NCHW on the torch side). Random draws the two packages cannot share
(``jax.random`` against numpy) are handed from the reference to the port:
mixup's lambda and DropBlock's uniforms. Tolerances are fp32 unless stated.
The kernels themselves are checked on the card in tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from axcnn.data.mixup import mixup_batch as j_mixup
from axcnn.ops import blurpool as jblur
from axcnn.ops.dropblock import dropblock as j_dropblock
from axcnn.ops.norm import bn_apply
from axcnn.ops.sk import sk_apply
from axcnn.pallas.blurpool import blur_pool_pallas_bwd
from axcnn.pallas.dropblock import dropblock_mask_pallas
from axcnn.train import ema as jema
from axcnn.train import losses as jlosses
from axcnn.train import optimizer as jopt
from axcnn.train import schedules as jsched
from axcnn_torch.ckpt.convert import to_axcnn, tree_to_state_dict
from axcnn_torch.core.rng import RngStream
from axcnn_torch.data.mixup import draw_lambda, mixup_batch
from axcnn_torch.kernels import blurpool as kblur
from axcnn_torch.kernels import dropblock as kdrop
from axcnn_torch.models.resnet import ModelConfig, ResNet
from axcnn_torch.ops.blurpool import blur_pool
from axcnn_torch.ops.dropblock import dropblock, dropblock_gamma, dropblock_keep_prob
from axcnn_torch.ops.norm import BatchNorm
from axcnn_torch.ops.sk import SK
from axcnn_torch.train import ema as tema
from axcnn_torch.train import losses as tlosses
from axcnn_torch.train import optimizer as topt
from axcnn_torch.train import schedules as tsched
import torch_inprocess

capped_threads = torch_inprocess.capped_threads

TOL = dict(atol=1e-5, rtol=1e-5)
SMALL_ASSEMBLED = dict(width_multiplier=0.125, num_classes=10, use_resnet_d=True,
                       use_se_block=True, use_sk_block=True,
                       anti_alias_type="sconv", use_dropblock=True, zero_gamma=True)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def _bf16_ulp(v):
    """Spacing of bf16 numbers at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return np.exp2(e - 7)


# ---------------------------------------------------------------------------
# BlurPool backward (plain version of the CUDA kernel)
# ---------------------------------------------------------------------------

BWD_SHAPES = [(2, 8, 8, 16), (2, 14, 16, 32), (1, 15, 17, 8), (2, 7, 9, 4), (1, 1, 3, 2)]


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_blur_bwd_reference_matches_jax_vjp(shape):
    """Even and odd extents, against the VJP of the reference's XLA op."""
    rng = np.random.default_rng(20)
    x = _normal(rng, shape)
    n, h, w, c = shape
    g = _normal(rng, (n, (h + 1) // 2, (w + 1) // 2, c))
    _, vjp = jax.vjp(lambda a: jblur.blur_pool(a, stride=2, filter_size=3), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = kblur.blur_pool_bwd_reference(_nchw(g), (h, w))
    assert got.shape == (n, c, h, w)
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("shape", [s for s in BWD_SHAPES if s[1] % 2 == 0 and s[2] % 2 == 0])
def test_blur_bwd_reference_matches_pallas_kernel(shape, dtype):
    """Against the TPU backward kernel in interpret mode (even extents, the
    Pallas kernel's domain): exact in fp32, within one bf16 ulp in bf16."""
    n, h, w, c = shape
    g = _normal(np.random.default_rng(21), (n, h // 2, w // 2, c))
    want = np.asarray(blur_pool_pallas_bwd(jnp.asarray(g, dtype), interpret=True),
                      np.float32)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = _nhwc(kblur.blur_pool_bwd_reference(_nchw(g).to(tdtype), (h, w)))
    if dtype == jnp.float32:
        np.testing.assert_array_equal(got, want)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_blur_pool_autograd_gradient_is_the_bwd_reference(shape):
    """On the CPU the port's ``blur_pool`` is the plain forward and autograd
    differentiates it; that gradient is the plain backward, exactly."""
    rng = np.random.default_rng(22)
    n, h, w, c = shape
    x = _nchw(_normal(rng, shape)).requires_grad_()
    g = _nchw(_normal(rng, (n, (h + 1) // 2, (w + 1) // 2, c)))
    blur_pool(x).backward(g)
    assert torch.equal(x.grad, kblur.blur_pool_bwd_reference(g, (h, w)))


# ---------------------------------------------------------------------------
# DropBlock
# ---------------------------------------------------------------------------

DB_CASES = [((8, 14, 14, 16), 7), ((8, 7, 7, 32), 7), ((4, 15, 17, 8), 5)]


def _key_and_uniforms(shape, seed):
    """A key and the uniforms the reference's XLA DropBlock draws from it."""
    key = jax.random.key(seed)
    n, h, w, _ = shape
    u = np.array(jax.random.uniform(key, (n, h, w, 1), jnp.float32))[..., 0]
    return key, torch.from_numpy(u)


@pytest.mark.parametrize("shape,bs", DB_CASES)
def test_dropblock_matches_reference_given_its_uniforms(shape, bs):
    """Mask, scale and output equal the reference's XLA path exactly, when
    the port is handed the reference's own uniforms."""
    kp = 0.5
    key, u = _key_and_uniforms(shape, 30)
    n, h, w, c = shape
    x = _normal(np.random.default_rng(31), shape)
    seeds = np.zeros(n, np.int32)  # unused: the uniforms replace the hash
    want = np.asarray(j_dropblock(key, x, keep_prob=kp, block_size=bs, train=True))
    got = dropblock(_nchw(x), seeds, keep_prob=kp, block_size=bs, train=True,
                    uniforms=u)
    np.testing.assert_array_equal(_nhwc(got), want)
    # with x = 1 the output is mask * scale
    ones = np.ones(shape, np.float32)
    ref = np.asarray(j_dropblock(key, ones, keep_prob=kp, block_size=bs, train=True))
    mask, counts = kdrop.dropblock_mask_reference(
        torch.from_numpy(seeds), float(dropblock_gamma(kp, min(bs, h, w), h, w)),
        h, w, min(bs, h, w), uniforms=u)
    np.testing.assert_array_equal(mask.numpy(), (ref[..., 0] > 0).astype(np.float32))
    assert 0 < counts.sum() < n * h * w  # some dropped, some kept
    scale = n * h * w * c / (counts.sum().item() * c)
    np.testing.assert_allclose(ref.max(), scale, rtol=1e-6)


def test_dropblock_mask_matches_pallas_kernel_zero_stub():
    """The TPU kernel in interpret mode draws from a zero PRNG stub on the
    CPU (every uniform 0). Given all-zero uniforms the plain version gives
    its mask and counts exactly, for gamma 0 and > 0."""
    n, h, w = 3, 14, 14
    seeds = jnp.arange(n, dtype=jnp.int32)
    for gamma, bs in ((0.0, 7), (0.02, 7), (0.02, 3)):
        with pltpu.force_tpu_interpret_mode():
            want_m, want_c = dropblock_mask_pallas(seeds, gamma, h=h, w=w, block_size=bs)
        got_m, got_c = kdrop.dropblock_mask_reference(
            torch.zeros(n, dtype=torch.int32), gamma, h, w, bs,
            uniforms=torch.zeros(n, h, w))
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def test_dropblock_keep_prob_and_gamma_match_reference():
    from axcnn.ops.dropblock import dropblock_keep_prob as j_kp

    for progress in (0.0, 0.3, 0.5, 1.0, 1.7):
        want = np.float32(j_kp(progress, 0.9))
        assert dropblock_keep_prob(progress, 0.9) == want
        for bs, h, w in ((7, 14, 14), (7, 7, 7), (5, 15, 17)):
            kp = jnp.asarray(want, jnp.float32)
            jg = ((1.0 - kp) / (bs * bs)) * ((h * w) / max((h - bs + 1) * (w - bs + 1), 1))
            assert dropblock_gamma(want, bs, h, w) == np.float32(jg)


def test_hash_uniforms_are_uniform_and_deterministic():
    seeds = torch.tensor([0, 1, -1, 2 ** 31 - 1, -2 ** 31, 12345], dtype=torch.int32)
    u = kdrop.hash_uniforms(seeds, 64, 64)
    assert u.shape == (6, 64, 64) and u.dtype == torch.float32
    assert torch.equal(u, kdrop.hash_uniforms(seeds, 64, 64))
    assert 0.0 <= u.min() and u.max() < 1.0
    # 24-bit uniforms: integer multiples of 2**-24
    assert torch.equal(u * 2 ** 24, torch.floor(u * 2 ** 24))
    flat = u.flatten().double()
    sigma = (1 / 12 / flat.numel()) ** 0.5
    assert abs(flat.mean().item() - 0.5) < 4 * sigma  # 4 standard errors
    for i in range(6):
        for j in range(i + 1, 6):
            assert not torch.equal(u[i], u[j])


def test_hash_matches_known_fmix32_values():
    """MurmurHash3 fmix32 reference values, computed with Python integers."""
    def fmix32(h):
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & 0xFFFFFFFF
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & 0xFFFFFFFF
        return h ^ (h >> 16)

    vals = [0, 1, 2 ** 31, 2 ** 32 - 1, 0x9E3779B9, 123456789]
    got = kdrop._fmix32(torch.tensor(vals, dtype=torch.int64))
    assert got.tolist() == [fmix32(v) for v in vals]


@pytest.mark.parametrize("h,w,bs,gamma", [(14, 14, 7, 0.02), (7, 7, 7, 0.1),
                                          (15, 17, 5, 0.05)])
def test_hash_mask_drop_fraction_has_expected_mean(h, w, bs, gamma):
    """Pixel p is dropped with probability 1 - (1 - gamma)^k(p), where k(p)
    counts the valid centres whose block covers p. Over 2048 samples the
    mean drop fraction is within 4 standard errors of that expectation."""
    n = 2048
    seeds = torch.from_numpy(np.random.default_rng(40).integers(
        -2 ** 31, 2 ** 31, n, dtype=np.int32))
    mask, counts = kdrop.dropblock_mask_reference(seeds, gamma, h, w, bs)
    np.testing.assert_array_equal(counts.numpy(), mask.sum(dim=(1, 2)).numpy())
    half0, half1 = (bs - 1) // 2, bs // 2
    valid = np.zeros((h, w))
    valid[half0:h - half1, half0:w - half1] = 1
    k = np.array([[valid[max(r - half0, 0):r + half1 + 1, max(c - half0, 0):c + half1 + 1].sum()
                   for c in range(w)] for r in range(h)])
    expect = (1 - (1 - gamma) ** k).mean()
    frac = 1 - mask.mean(dim=(1, 2)).double().numpy()
    stderr = frac.std() / np.sqrt(n)
    assert abs(frac.mean() - expect) < 4 * stderr, (frac.mean(), expect, stderr)


def test_hash_mask_blocks_are_contiguous_and_seeded():
    """Every dropped pixel lies in a fully dropped bs x bs window (each
    centre's block fits the map); the same seed gives the same mask."""
    from numpy.lib.stride_tricks import sliding_window_view

    bs = 7
    seeds = torch.tensor([5, 5, 6, 7], dtype=torch.int32)
    mask, _ = kdrop.dropblock_mask_reference(seeds, 0.01, 32, 32, bs)
    m = mask.numpy()
    assert np.array_equal(m[0], m[1]) and not np.array_equal(m[0], m[2])
    for s in range(4):
        zero_win = sliding_window_view(m[s], (bs, bs)).sum(axis=(2, 3)) == 0
        covered = np.zeros_like(m[s], bool)
        for r, c in zip(*np.nonzero(zero_win)):
            covered[r:r + bs, c:c + bs] = True
        assert np.array_equal(covered, m[s] == 0)
    assert (m == 0).any()


def test_dropblock_is_identity_in_eval():
    x = torch.randn(2, 4, 7, 7)
    assert dropblock(x, np.zeros(2, np.int32), keep_prob=0.5, train=False) is x


def test_dropblock_refuses_maps_over_the_kernel_bound():
    """The bound is the 32-bit pixel index, checked before anything is
    allocated."""
    with pytest.raises(ValueError, match="H\\*W"):
        kdrop.dropblock_mask_reference(torch.zeros(1, dtype=torch.int32), 0.1,
                                       46341, 46341, 7)


# ---------------------------------------------------------------------------
# named random streams
# ---------------------------------------------------------------------------

def test_rng_streams_are_named_and_order_free():
    a, b = RngStream(7).fold_step(3), RngStream(7).fold_step(3)
    assert a("dropblock/stage3/block0") == b("dropblock/stage3/block0")
    assert a("mixup") != a("dropblock/stage3/block0")
    assert RngStream(7).fold_step(4)("mixup") != a("mixup")
    assert RngStream(8).fold_step(3)("mixup") != a("mixup")
    # the draw of one site does not depend on which sites drew before it
    x1 = a.numpy("dropblock/stage4/block2").random(4)
    b.numpy("mixup").random(100)
    np.testing.assert_array_equal(x1, b.numpy("dropblock/stage4/block2").random(4))
    with pytest.raises(ValueError):
        RngStream(-1)


# ---------------------------------------------------------------------------
# BN and SK in train mode
# ---------------------------------------------------------------------------

def _bn_tree(rng, c):
    return ({"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
             "beta": _normal(rng, c, 0.1)},
            {"mean": _normal(rng, c, 0.1),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)})


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_bn_train_forward_update_and_gradients(dtype):
    """Batch statistics, the moving update with m = 0.997 and the biased
    variance, and gradients w.r.t. x, gamma and beta against jax.grad."""
    rng = np.random.default_rng(50)
    x = _normal(rng, (4, 5, 7, 16), 2.0) + 0.5
    p, s = _bn_tree(rng, 16)
    wt = _normal(rng, (4, 5, 7, 16))

    def jloss(p, x):
        y, ns = bn_apply(p, s, x.astype(dtype), train=True, momentum=0.997)
        return jnp.sum(y.astype(jnp.float32) * wt), (y, ns)

    (_, (want_y, want_s)), (jg_p, jg_x) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    bn = BatchNorm(16)
    bn.load_state_dict(tree_to_state_dict(p, s))
    xt = _nchw(x).clone().requires_grad_()
    y = bn(xt.to(tdtype), train=True)
    assert y.dtype == tdtype
    (y.float() * _nchw(wt)).sum().backward()
    tol = TOL if dtype == jnp.float32 else dict(atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(_nhwc(y), np.asarray(want_y, np.float32), **tol)
    np.testing.assert_allclose(bn.running_mean.numpy(), want_s["mean"], **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), want_s["var"], **TOL)
    gtol = dict(atol=1e-4, rtol=1e-4) if dtype == jnp.float32 else dict(atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(jg_x), **gtol)
    np.testing.assert_allclose(bn.weight.grad.numpy(), jg_p["gamma"], **gtol)
    np.testing.assert_allclose(bn.bias.grad.numpy(), jg_p["beta"], **gtol)


@pytest.mark.parametrize("stride,hw", [(1, (8, 8)), (2, (9, 10))])
def test_sk_train_forward_update_and_gradients(stride, hw):
    """SK in train mode (its bn_z takes statistics over N alone): output,
    every BN's moving update, and gradients w.r.t. every parameter and the
    input, against jax.grad. N = 8: bn_z normalizes N values, which
    magnifies fp32 rounding as N shrinks (at N = 3 the reference's own fp32
    output is 2.7e-4 from its float64 one)."""
    rng = np.random.default_rng(52 + stride)
    c, d, n = 16, 32, 8
    p, s = {}, {}
    for b in range(2):
        p[f"conv{b}"] = {"w": _normal(rng, (3, 3, c, c), 0.2)}
        p[f"bn{b}"], s[f"bn{b}"] = _bn_tree(rng, c)
    p["fc_z"] = {"w": _normal(rng, (c, d), 0.3)}
    p["bn_z"], s["bn_z"] = _bn_tree(rng, d)
    p["fc_select"] = {"w": _normal(rng, (d, 2 * c), 0.3), "b": _normal(rng, 2 * c, 0.1)}
    x = _normal(rng, (n, *hw, c))
    ho, wo = -(-hw[0] // stride), -(-hw[1] // stride)
    wt = _normal(rng, (n, ho, wo, c))

    def jloss(p, x):
        y, ns = sk_apply(p, s, x, stride=stride, train=True)
        return jnp.sum(y * wt), (y, ns)

    (_, (want_y, want_s)), (jg_p, jg_x) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))
    sk = SK(c, c, stride=stride)
    sk.load_state_dict(tree_to_state_dict(p, s))
    xt = _nchw(x).clone().requires_grad_()
    y = sk(xt, train=True)
    (y * _nchw(wt)).sum().backward()
    np.testing.assert_allclose(_nhwc(y), np.asarray(want_y), **TOL)
    got_p, got_s = to_axcnn({k: v.grad for k, v in sk.named_parameters()},
                            bn_mods={"bn0", "bn1", "bn_z"})
    gtol = dict(atol=1e-4, rtol=1e-4)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), **gtol),
                 got_p, jg_p)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(jg_x), **gtol)
    new_p, new_s = to_axcnn(sk.state_dict())
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), **TOL),
                 new_s, want_s)


# ---------------------------------------------------------------------------
# loss, decay mask, optimizer, EMA, schedule, mixup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mixed", [False, True])
def test_softmax_ce_loss_matches_reference(mixed):
    rng = np.random.default_rng(60)
    logits = _normal(rng, (8, 10), 3.0)
    la, lb = rng.integers(0, 10, 8), rng.integers(0, 10, 8)
    lam = np.float32(0.3)
    jargs = (jnp.asarray(la), jnp.asarray(lb), lam) if mixed else (jnp.asarray(la),)
    want = jlosses.softmax_ce_loss(logits, *jargs, label_smoothing=0.1)
    targs = ((torch.from_numpy(la), torch.from_numpy(lb), float(lam)) if mixed
             else (torch.from_numpy(la),))
    got = tlosses.softmax_ce_loss(torch.from_numpy(logits), *targs, label_smoothing=0.1)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def _small_model():
    model = ResNet(ModelConfig(**SMALL_ASSEMBLED),
                   generator=torch.Generator().manual_seed(0))
    return model


def test_decay_mask_matches_reference_and_spares_bn_and_biases():
    """ROADMAP hazard (d): the mask is the reference's, by leaf name. A BN
    scale and a conv kernel are both ``weight`` in torch; only the latter
    decays. No BN gamma/beta and no bias is decayed; the SE/SK FC kernels
    and the head kernel are."""
    model = _small_model()
    mask = tlosses.decay_mask(model)
    params, _ = to_axcnn(model.state_dict())
    want = jlosses.decay_mask(params)
    got, _ = to_axcnn({k: torch.tensor(float(v)) for k, v in mask.items()},
                      bn_mods={k.rsplit(".", 1)[0] for k in model.state_dict()
                               if k.endswith("running_mean")})
    jax.tree.map(lambda g, w: np.testing.assert_equal(bool(g), bool(w)), got, want)
    bn_names = {n for n, m in model.named_modules() if isinstance(m, BatchNorm)}
    for name, decayed in mask.items():
        mod, leaf = name.rsplit(".", 1)
        if mod in bn_names or leaf == "bias":
            assert not decayed, name
        else:
            assert decayed, name
    assert mask["stage2.block0.se.fc1.weight"] and mask["stage2.block0.sk.fc_z.weight"]
    assert mask["head.weight"] and not mask["stage2.block0.bn3.weight"]
    l2 = tlosses.l2_regularization(model, 1e-4).item()
    np.testing.assert_allclose(l2, float(jlosses.l2_regularization(params, 1e-4)), rtol=1e-5)


def _param_trees(rng, model):
    """Random params, grads and velocity for the model, as torch dicts and
    as the reference's trees."""
    bn_mods = {k.rsplit(".", 1)[0] for k in model.state_dict() if k.endswith("running_mean")}
    out = []
    for scale in (1.0, 0.1, 0.5):
        d = {k: torch.from_numpy(_normal(rng, tuple(p.shape), scale))
             for k, p in model.named_parameters()}
        out.append((d, to_axcnn(d, bn_mods)[0]))
    return bn_mods, out


def test_momentum_update_matches_reference():
    model = _small_model()
    bn_mods, [(p, jp), (g, jg), (v, jv)] = _param_trees(np.random.default_rng(61), model)
    # the reference's inputs share memory with the torch tensors that the
    # port updates in place: finish its asynchronous dispatch first
    want_p, want_v = jax.block_until_ready(jopt.momentum_update(
        jp, jg, jv, lr=0.05, momentum=0.9, weight_decay=1e-4))
    topt.momentum_update(p, g, v, lr=0.05, momentum=0.9, weight_decay=1e-4,
                         mask=tlosses.decay_mask(model))
    for got, want in ((p, want_p), (v, want_v)):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b),
                                                             rtol=1e-6, atol=1e-7),
                     to_axcnn(got, bn_mods)[0], want)


@pytest.mark.parametrize("step", [0, 5, 100_000])
def test_ema_update_matches_reference(step):
    model = _small_model()
    bn_mods, [(e, je), (p, jp), _] = _param_trees(np.random.default_rng(62), model)
    # as above: the reference must read ``e`` before the port updates it
    want = jax.block_until_ready(jema.ema_update(je, jp, decay=0.9999, step=step))
    tema.ema_update(e, p, decay=0.9999, step=step)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                                         atol=1e-7),
                 to_axcnn(e, bn_mods)[0], want)


@pytest.mark.parametrize("decay_type", ["cosine", "step", "constant"])
def test_lr_schedule_matches_reference(decay_type):
    kw = dict(base_lr=0.4, total_steps=50, warmup_steps=7, decay_type=decay_type)
    want, got = jsched.make_lr_schedule(**kw), tsched.make_lr_schedule(**kw)
    for step in range(0, 60):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError):
        tsched.make_lr_schedule(base_lr=0.1, total_steps=1, decay_type="poly")


def test_mixup_matches_reference_given_its_lambda():
    rng = np.random.default_rng(63)
    images = _normal(rng, (6, 8, 8, 3))
    labels = rng.integers(0, 10, 6).astype(np.int32)
    key = jax.random.key(3)
    want_x, want_a, want_b, lam = j_mixup(key, images, labels, alpha=0.2)
    got_x, got_a, got_b = mixup_batch(torch.from_numpy(images), torch.from_numpy(labels),
                                      np.float32(lam))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))


def test_mixup_lambda_law():
    """lambda ~ Beta(a, a): mean 1/2; ``symmetric`` keeps the larger half."""
    lams = np.array([draw_lambda(np.random.default_rng(i), 0.2) for i in range(4000)])
    assert lams.dtype == np.float32 and ((0 <= lams) & (lams <= 1)).all()
    assert abs(lams.mean() - 0.5) < 4 * lams.std() / np.sqrt(len(lams))
    sym = draw_lambda(np.random.default_rng(0), 0.2, symmetric=True)
    assert sym >= 0.5 and sym in (lams[0], np.float32(1.0) - lams[0])

