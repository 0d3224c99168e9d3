"""The merged SK conv (``sk_merged_conv``) and BlurPool's filter sizes 1-7
in the port's ops, against the JAX reference's ``axcnn.ops.sk`` and
``axcnn.ops.blurpool``, on the CPU.

- The merged weight equals the reference's ``_merged_sk_kernel`` after the
  HWIO -> OIHW transpose, exactly.
- The merged SK unit equals the two-conv unit in float64 (outputs and every
  gradient to 1e-12 relative: the extra taps contract exact zeros), and the
  reference's ``sk_apply(merged=True)`` in fp32 (rtol 1e-5, atol 1e-5 of the
  largest value), gradients included (``jax.vjp``).
- BlurPool at filter sizes 1-7 and strides 1-2 on odd and even maps: the
  port's route (the general depthwise conv, or the kernels' plain version
  for 3x3/2) and the general route's own plain version (shifted adds)
  against the reference's ``blur_pool``, forward and gradient, fp32, max
  abs error <= 1e-6 of the largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from axcnn.ops import blurpool as jblur
from axcnn.ops.sk import _merged_sk_kernel, sk_apply
from axcnn_torch.ckpt.convert import tree_to_state_dict
from axcnn_torch.kernels import blurpool as kblur
from axcnn_torch.ops.blurpool import blur_kernel, blur_pool, blur_pool_general_reference
from axcnn_torch.ops.sk import SK, merged_sk_weight
import torch_inprocess

capped_threads = torch_inprocess.capped_threads


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _sk_tree(rng, c, d=32):
    normal = lambda shape, s: (rng.standard_normal(shape) * s).astype(np.float32)  # noqa: E731
    p, s = {}, {}
    for b in range(2):
        p[f"conv{b}"] = {"w": normal((3, 3, c, c), 0.2)}
        p[f"bn{b}"] = {"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
                       "beta": normal(c, 0.1)}
        s[f"bn{b}"] = {"mean": normal(c, 0.1), "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    p["fc_z"] = {"w": normal((c, d), 0.3)}
    p["bn_z"] = {"gamma": rng.uniform(0.5, 1.5, d).astype(np.float32), "beta": normal(d, 0.1)}
    s["bn_z"] = {"mean": normal(d, 0.1), "var": rng.uniform(0.5, 1.5, d).astype(np.float32)}
    p["fc_select"] = {"w": normal((d, 2 * c), 0.3), "b": normal(2 * c, 0.1)}
    return p, s


def _sk_pair(p, s, c, stride):
    units = []
    for merged in (False, True):
        sk = SK(c, c, stride=stride, merged=merged)
        sk.load_state_dict(tree_to_state_dict(p, s))
        units.append(sk)
    return units


def test_merged_weight_is_the_reference_kernel():
    rng = np.random.default_rng(30)
    w0, w1 = (rng.standard_normal((3, 3, 5, 6)).astype(np.float32) for _ in range(2))
    want = np.asarray(_merged_sk_kernel(jnp.asarray(w0), jnp.asarray(w1))).transpose(3, 2, 0, 1)
    oihw = lambda w: torch.from_numpy(w.transpose(3, 2, 0, 1).copy())  # noqa: E731
    got = merged_sk_weight(oihw(w0), oihw(w1))
    assert got.shape == (12, 5, 5, 5)
    np.testing.assert_array_equal(got.numpy(), want)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("stride,hw", [(1, (8, 8)), (2, (9, 10))])
def test_merged_unit_equals_the_two_convs_in_float64(stride, hw, train):
    rng = np.random.default_rng(31 + stride)
    c = 16
    p, s = _sk_tree(rng, c)
    two, one = (u.double() for u in _sk_pair(p, s, c, stride))
    x = torch.from_numpy(rng.standard_normal((4, c, *hw))).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((4, c, -(-hw[0] // stride), -(-hw[1] // stride))))
    outs = []
    for unit in (two, one):
        y = unit(x, train=train)
        grads = torch.autograd.grad(y, [x, *unit.parameters()], g)
        outs.append((y.detach(), grads, {k: b.clone() for k, b in unit.named_buffers()}))
    (y2, g2, b2), (y1, g1, b1) = outs
    assert _rel(y1, y2) <= 1e-12
    for a, b in zip(g1, g2):
        assert _rel(a, b) <= 1e-12
    for k in b2:
        assert _rel(b1[k], b2[k]) <= 1e-12, k


@pytest.mark.parametrize("stride,hw", [(1, (8, 8)), (2, (9, 10))])
def test_merged_unit_matches_the_reference_with_gradients(stride, hw):
    """Train mode: the output and the gradients of the input and of both
    branch weights against ``jax.vjp`` of ``sk_apply(merged=True)``. N = 8,
    as tests/test_torch_train_ops.py's SK test: ``bn_z`` normalizes N values,
    which magnifies fp32 rounding as N shrinks."""
    rng = np.random.default_rng(33 + stride)
    c = 16
    p, s = _sk_tree(rng, c)
    x = rng.standard_normal((8, *hw, c)).astype(np.float32)

    def ref(x, w0, w1):
        q = {**p, "conv0": {"w": w0}, "conv1": {"w": w1}}
        return sk_apply(q, s, x, stride=stride, train=True, merged=True)[0]

    want, vjp = jax.vjp(ref, jnp.asarray(x), jnp.asarray(p["conv0"]["w"]),
                        jnp.asarray(p["conv1"]["w"]))
    ct = rng.standard_normal(want.shape).astype(np.float32)
    jdx, jdw0, jdw1 = (np.asarray(a) for a in vjp(jnp.asarray(ct)))

    _, sk = _sk_pair(p, s, c, stride)
    xt = _nchw(x).requires_grad_()
    y = sk(xt, train=True)
    dx, dw0, dw1 = torch.autograd.grad(y, [xt, sk.conv0.weight, sk.conv1.weight], _nchw(ct))
    tol = lambda w: dict(rtol=1e-5, atol=1e-5 * np.abs(w).max())  # noqa: E731
    want = np.asarray(want)
    np.testing.assert_allclose(_nhwc(y), want, **tol(want))
    np.testing.assert_allclose(_nhwc(dx), jdx, **tol(jdx))
    for got, w in ((dw0, jdw0), (dw1, jdw1)):
        w = w.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        np.testing.assert_allclose(got.numpy(), w, **tol(w))


def test_blur_kernel_is_the_reference_filter():
    for fs in range(1, 8):
        np.testing.assert_array_equal(blur_kernel(fs), jblur.blur_kernel(fs))
    for fs in (0, 8):
        with pytest.raises(ValueError, match=r"\[1,7\]"):
            blur_pool(torch.zeros(1, 2, 8, 8), stride=2, filter_size=fs)


@pytest.mark.parametrize("hw", [(9, 11), (8, 10)])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("filter_size", range(1, 8))
def test_blur_pool_sizes_match_the_reference(filter_size, stride, hw):
    rng = np.random.default_rng(40 + filter_size)
    x = rng.standard_normal((2, *hw, 6)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jblur.blur_pool(a, stride=stride, filter_size=filter_size),
                        jnp.asarray(x))
    want = np.asarray(want)
    ct = rng.standard_normal(want.shape).astype(np.float32)
    (jdx,) = (np.asarray(a) for a in vjp(jnp.asarray(ct)))
    before = dict(kblur.ROUTES)
    for fn in (blur_pool, blur_pool_general_reference):
        xt = _nchw(x).requires_grad_()
        y = fn(xt, stride=stride, filter_size=filter_size)
        (dx,) = torch.autograd.grad(y, xt, _nchw(ct))
        assert _nhwc(y).shape == want.shape
        np.testing.assert_allclose(_nhwc(y), want, rtol=0, atol=1e-6 * np.abs(want).max())
        np.testing.assert_allclose(_nhwc(dx), jdx, rtol=0, atol=1e-6 * np.abs(jdx).max())
    general = kblur.ROUTES["general"] - before["general"]
    assert general == (0 if (filter_size, stride) == (3, 2) else 1)
