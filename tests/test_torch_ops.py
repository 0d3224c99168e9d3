"""Op-level parity of the PyTorch port (axcnn_torch.ops) against the JAX
reference (axcnn.ops), on the CPU, in fp32.

Every input is drawn from a numpy seed and fed to both packages; activations
are NHWC on the JAX side and NCHW on the torch side. Tolerance: atol = rtol =
1e-5 (fp32 sums taken in another order by XLA and by PyTorch).

The CUDA kernel's own tests are in tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from axcnn.ops import blurpool as jblur
from axcnn.ops.conv import conv_apply, dense_apply, fixed_pad_amounts
from axcnn.ops.norm import bn_apply
from axcnn.ops.pooling import avg_pool as j_avg_pool
from axcnn.ops.pooling import global_avg_pool as j_gap
from axcnn.ops.pooling import max_pool_same as j_max_pool
from axcnn.ops.se import se_apply
from axcnn.ops.sk import sk_apply
from axcnn.pallas.blurpool import blur_pool_pallas
from axcnn_torch.ckpt.convert import tree_to_state_dict
from axcnn_torch.kernels import blurpool as kblur
from axcnn_torch.ops.conv import Conv, Dense, conv2d_fixed_padding
from axcnn_torch.ops.norm import BatchNorm, bn_eval
from axcnn_torch.ops.pooling import avg_pool_same, global_avg_pool, max_pool_same
from axcnn_torch.ops.se import SE
from axcnn_torch.ops.sk import SK

TOL = dict(atol=1e-5, rtol=1e-5)


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bn_tree(rng, c):
    params = {"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "beta": _normal(rng, c, 0.1)}
    state = {"mean": _normal(rng, c, 0.1),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    return params, state


# ---------------------------------------------------------------------------
# conv / dense
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,stride,dilation,hw", [
    (1, 1, 1, (9, 9)), (3, 2, 1, (16, 16)), (3, 2, 1, (15, 17)),
    (7, 2, 1, (32, 32)), (3, 1, 2, (14, 14)), (3, 2, 2, (15, 15))])
def test_conv_fixed_padding(k, stride, dilation, hw):
    rng = np.random.default_rng(k * 10 + stride + dilation)
    x = _normal(rng, (2, *hw, 8))
    w = _normal(rng, (k, k, 8, 12), 0.2)  # HWIO
    want = conv_apply({"w": w}, x, stride=stride, dilation=dilation)
    got = conv2d_fixed_padding(_nchw(x), torch.from_numpy(w).permute(3, 2, 0, 1),
                               stride=stride, dilation=dilation)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


def test_fixed_padding_is_symmetric_for_odd_kernels():
    for k in (1, 3, 5, 7):
        for d in (1, 2, 3):
            beg, end = fixed_pad_amounts(k, d)
            assert beg == end
    with pytest.raises(ValueError, match="even kernel"):
        conv2d_fixed_padding(torch.zeros(1, 2, 8, 8), torch.zeros(2, 2, 2, 2))


def test_dense_matches():
    rng = np.random.default_rng(1)
    x, w, b = _normal(rng, (4, 16)), _normal(rng, (16, 10)), _normal(rng, 10)
    want = dense_apply({"w": w, "b": b}, x, compute_dtype=jnp.float32)
    d = Dense(16, 10, std=0.01)
    d.load_state_dict({"weight": torch.from_numpy(w.T.copy()),
                       "bias": torch.from_numpy(b)})
    np.testing.assert_allclose(d(torch.from_numpy(x), torch.float32).detach(),
                               np.asarray(want), **TOL)


def test_he_normal_init_statistics():
    """The port draws other numbers than jax.random, from the same law:
    normal truncated at 2 sigma, rescaled to std sqrt(2 / fan_in)."""
    conv = Conv(3, 64, 128)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    w = conv.weight.detach()
    std = (2.0 / (64 * 9)) ** 0.5
    assert abs(w.std().item() / std - 1) < 0.02
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-7


# ---------------------------------------------------------------------------
# BN (eval)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_bn_eval_matches(dtype):
    rng = np.random.default_rng(2)
    x = _normal(rng, (2, 5, 7, 16), 2.0)
    p, s = _bn_tree(rng, 16)
    want, _ = bn_apply(p, s, jnp.asarray(x, dtype), train=False)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    bn = BatchNorm(16)
    bn.load_state_dict(tree_to_state_dict(p, s))
    got = bn(_nchw(x).to(tdtype))
    assert got.dtype == tdtype
    # bf16: both fold in fp32 and round once -> within one bf16 ulp
    tol = TOL if dtype == jnp.float32 else dict(atol=1e-2, rtol=8e-3)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want, np.float32), **tol)


def test_bn_train_mode_refused():
    """Train mode refuses torch's BatchNorm semantics (ROADMAP hazard (a)):
    F.batch_norm with momentum 1 - m updates the moving variance with the
    unbiased estimator; the port, like the reference, with the biased one.
    Parity of train mode with the reference is in test_torch_train_ops.py."""
    x = _nchw(_normal(np.random.default_rng(51), (2, 3, 3, 8)))
    bn = BatchNorm(8)
    bn.reset_parameters()
    bn(x, train=True)
    rm, rv = torch.zeros(8), torch.ones(8)
    torch.nn.functional.batch_norm(x, rm, rv, training=True, momentum=0.003)
    np.testing.assert_allclose(bn.running_mean.numpy(), rm.numpy(), atol=1e-7)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               (0.997 + 0.003 * var).numpy(), rtol=1e-6)
    assert not torch.allclose(bn.running_var, rv, rtol=1e-6, atol=0)


def test_bn_eval_on_vector():
    """SK's bn_z normalizes an (N, d) vector: channel dim 1 there too."""
    rng = np.random.default_rng(3)
    z = _normal(rng, (3, 32))
    p, s = _bn_tree(rng, 32)
    want, _ = bn_apply(p, s, z[:, None, None, :], train=False)
    got = bn_eval(torch.from_numpy(z), *(torch.from_numpy(a) for a in (
        p["gamma"], p["beta"], s["mean"], s["var"])))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0, 0, :], **TOL)


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,stride", [
    ((2, 112, 112, 8), 2),   # the stem: TF SAME pads (0, 1), not (1, 1)
    ((2, 8, 8, 4), 2), ((2, 7, 9, 4), 2), ((1, 15, 15, 3), 2),
    ((2, 7, 9, 4), 1)])      # the 'max' anti-alias stem's dense pool
def test_max_pool_same(shape, stride):
    x = _normal(np.random.default_rng(4), shape)
    want = j_max_pool(x, window=3, stride=stride)
    got = max_pool_same(_nchw(x), window=3, stride=stride)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


def test_max_pool_differs_from_symmetric_padding():
    """Pins the hazard: nn.MaxPool2d(3, 2, padding=1) is not TF SAME."""
    x = _nchw(_normal(np.random.default_rng(5), (1, 112, 112, 4)))
    ours = max_pool_same(x)
    naive = torch.nn.functional.max_pool2d(x, 3, 2, padding=1)
    assert ours.shape == naive.shape and not torch.equal(ours, naive)


@pytest.mark.parametrize("shape", [(2, 7, 9, 4), (2, 8, 8, 4), (1, 15, 15, 3)])
def test_avg_pool_same(shape):
    x = _normal(np.random.default_rng(6), shape)
    want = j_avg_pool(x, window=2, stride=2, padding="SAME")
    got = avg_pool_same(_nchw(x), window=2, stride=2)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_global_avg_pool(dtype):
    x = _normal(np.random.default_rng(7), (3, 7, 7, 16))
    want = j_gap(jnp.asarray(x, dtype))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = global_avg_pool(_nchw(x).to(tdtype))
    assert got.dtype == tdtype  # the mean is fp32, the result the input dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL)


# ---------------------------------------------------------------------------
# SE / SK (eval)
# ---------------------------------------------------------------------------

def test_se_matches():
    rng = np.random.default_rng(8)
    c, mid = 64, 4
    p = {"w1": _normal(rng, (c, mid), 0.3), "b1": _normal(rng, mid, 0.1),
         "w2": _normal(rng, (mid, c), 0.3), "b2": _normal(rng, c, 0.1)}
    x = _normal(rng, (2, 6, 6, c))
    want = se_apply(p, x)
    se = SE(c, ratio=16)
    sd = tree_to_state_dict({"se": p}, {})  # SE leaves convert under "se"
    se.load_state_dict({k.removeprefix("se."): v for k, v in sd.items()})
    np.testing.assert_allclose(_nhwc(se(_nchw(x))), np.asarray(want), **TOL)


@pytest.mark.parametrize("stride,hw", [(1, (8, 8)), (2, (9, 10))])
def test_sk_eval_matches(stride, hw):
    rng = np.random.default_rng(9 + stride)
    c, d = 16, 32
    p, s = {}, {}
    for b in range(2):
        p[f"conv{b}"] = {"w": _normal(rng, (3, 3, c, c), 0.2)}
        p[f"bn{b}"], s[f"bn{b}"] = _bn_tree(rng, c)
    p["fc_z"] = {"w": _normal(rng, (c, d), 0.3)}
    p["bn_z"], s["bn_z"] = _bn_tree(rng, d)
    p["fc_select"] = {"w": _normal(rng, (d, 2 * c), 0.3), "b": _normal(rng, 2 * c, 0.1)}
    x = _normal(rng, (2, *hw, c))
    want, _ = sk_apply(p, s, x, stride=stride, train=False)
    sk = SK(c, c, stride=stride)
    sk.load_state_dict(tree_to_state_dict(p, s))
    np.testing.assert_allclose(_nhwc(sk(_nchw(x))), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# BlurPool: the plain version of the CUDA kernel
# ---------------------------------------------------------------------------

BLUR_SHAPES = [(2, 8, 8, 128), (3, 14, 16, 256), (1, 15, 17, 8)]


@pytest.mark.parametrize("shape", BLUR_SHAPES)
def test_blur_reference_matches_xla(shape):
    x = _normal(np.random.default_rng(10), shape)
    want = jblur.blur_pool(x, stride=2, filter_size=3)
    got = kblur.blur_pool_reference(_nchw(x))
    assert got.shape == (shape[0], shape[3], -(-shape[1] // 2), -(-shape[2] // 2))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", [s for s in BLUR_SHAPES
                                   if s[1] % 2 == 0 and s[2] % 2 == 0])
def test_blur_reference_matches_pallas_kernel(shape):
    """Against the TPU kernel itself, run in interpret mode as
    tests/test_pallas.py runs it (the Pallas kernel takes even extents)."""
    x = _normal(np.random.default_rng(11), shape)
    want = blur_pool_pallas(jnp.asarray(x), interpret=True)
    got = kblur.blur_pool_reference(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
