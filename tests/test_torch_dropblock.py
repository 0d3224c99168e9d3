"""DropBlock's apply in the PyTorch port, held against the JAX reference on
the CPU: the op's input gradient against ``jax.vjp`` of
``axcnn.ops.dropblock.dropblock``, the apply's plain backward against
autograd through its plain forward, the fused kernel's plain version (the
plain mask, then the plain apply) against the reference, the rescale in
fp32, the CPU route, the card's route by map size (fused kernel or two
launches), and the apply and fused kernels' wrappers refusing what the
kernels do not take before they load the library. The kernels themselves
are checked on the card in tests/test_torch_kernels.py.

Inputs come from numpy seeds; the reference's own uniforms are handed to
the port (``jax.random`` cannot be reproduced in torch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from axcnn.ops.dropblock import dropblock as j_dropblock
from axcnn_torch.kernels import dropblock as kdrop
from axcnn_torch.ops import dropblock as op_dropblock
from axcnn_torch.ops.dropblock import dropblock, dropblock_gamma
import torch_inprocess

capped_threads = torch_inprocess.capped_threads

# the sizes of tests/test_torch_train_ops.py's DropBlock cases, and a map of
# 160x160 = 25,600 pixels, past the 16,384 the mask kernel once took: (N, H,
# W, C), block size
DB_CASES = [((8, 14, 14, 16), 7), ((8, 7, 7, 32), 7), ((4, 15, 17, 8), 5),
            ((2, 160, 160, 8), 7)]


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def _bits(t):
    """The bit patterns of ``t``: equal bits hold NaNs and signed zeros too."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _key_and_uniforms(shape, seed):
    """A key and the uniforms the reference's XLA DropBlock draws from it."""
    key = jax.random.key(seed)
    n, h, w, _ = shape
    u = np.array(jax.random.uniform(key, (n, h, w, 1), jnp.float32))[..., 0]
    return key, torch.from_numpy(u)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,bs", DB_CASES)
def test_dropblock_gradient_matches_jax_vjp(shape, bs, dtype):
    """Output and input gradient equal the reference's, given its uniforms.
    Tolerance 0: each gradient element is g * scale or a zero whatever the
    order of the two products, and bf16 rounds that one fp32 value once."""
    kp = 0.5
    key, u = _key_and_uniforms(shape, 32)
    rng = np.random.default_rng(33)
    x, g = rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(
        np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want_y, vjp = jax.vjp(lambda a: j_dropblock(key, a, keep_prob=kp, block_size=bs, train=True),
                          jnp.asarray(x, jdt))
    (want_dx,) = vjp(jnp.asarray(g, jdt))
    xt = _nchw(x).to(tdt).requires_grad_()
    y = dropblock(xt, np.zeros(shape[0], np.int32), keep_prob=kp, block_size=bs, train=True,
                  uniforms=u)
    (dx,) = torch.autograd.grad(y, xt, _nchw(g).to(tdt))
    assert y.dtype == dx.dtype == tdt
    np.testing.assert_array_equal(_nhwc(y), np.asarray(want_y, np.float32))
    np.testing.assert_array_equal(_nhwc(dx), np.asarray(want_dx, np.float32))
    assert bool((dx == 0).any()) and bool((dx != 0).any())  # some dropped, some kept


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,bs", DB_CASES)
def test_apply_bwd_reference_is_autograd_of_the_apply_reference(shape, bs, dtype):
    """Bit for bit, with inf, -inf and NaN in the cotangent at a dropped and
    at a kept pixel."""
    n, h, w, c = shape
    rng = np.random.default_rng(34)
    x = _nchw(rng.standard_normal(shape).astype(np.float32)).to(dtype).requires_grad_()
    u = rng.random((n, h, w)).astype(np.float32)
    u[0, h // 2, w // 2] = 0.0  # a block centred in sample 0
    mask, counts = kdrop.dropblock_mask_reference(
        torch.zeros(n, dtype=torch.int32), 0.1, h, w, bs, uniforms=torch.from_numpy(u))
    g = rng.standard_normal(shape).astype(np.float32)
    for keep in (0.0, 1.0):
        s, r, col = (mask == keep).nonzero()[0].tolist()
        g[s, r, col, :3] = [np.inf, -np.inf, np.nan]
    gt = _nchw(g).to(dtype)
    (want,) = torch.autograd.grad(kdrop.dropblock_apply_reference(x, mask, counts), x, gt)
    got = kdrop.dropblock_apply_bwd_reference(gt, mask, counts)
    assert got.dtype == dtype and bool(want.isnan().any()) and bool(want.isinf().any())
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("shape", [(129, 1027, 13, 13), (251, 2049, 7, 7), (33, 1021, 29, 23)])
def test_scale_reference_matches_the_reference_in_fp32(shape):
    """``numel / (max(sum(counts), 1) * C)`` as the reference computes it,
    for element counts above 2**24 that fp32 cannot hold, so their rounding
    enters the scale. The count comes from the shape; nothing that size is
    allocated."""
    n, c, h, w = shape
    numel = n * c * h * w
    assert numel > 2 ** 24 and int(np.float32(numel)) != numel
    counts = np.random.default_rng(35).integers(0, h * w + 1, n).astype(np.float32)
    # axcnn/ops/dropblock.py:78-79, with the per-sample counts for the mask's sum
    denom = jnp.maximum(jnp.sum(jnp.asarray(counts)), 1.0) * c
    want = np.asarray((numel / denom).astype(jnp.float32))
    got = kdrop.dropblock_scale_reference(torch.from_numpy(counts), numel, c)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert np.float32(got.item()).view(np.int32) == want.view(np.int32)
    # all counts zero: the divisor is max(0, 1) * C
    zero = kdrop.dropblock_scale_reference(torch.zeros(n), numel, c)
    assert zero.item() == np.float32(np.float32(numel) / np.float32(c))


def test_scale_reference_sums_the_counts_exactly():
    """Counts whose total passes 2**24: an fp32 running sum loses the odd
    counts there; the plain version sums them exactly and rounds the total
    to fp32 once, as the apply kernel does in 64-bit integers."""
    counts = torch.full((8,), 2.0 ** 22 + 1)  # total 2**25 + 8
    total = 8 * (2 ** 22 + 1)
    running = np.float32(0)
    for v in counts.numpy():
        running = np.float32(running + v)
    assert running != np.float32(total)
    numel, c = 10 ** 9, 3
    want = np.float32(np.float32(numel) / (np.float32(total) * np.float32(c)))
    got = kdrop.dropblock_scale_reference(counts, numel, c)
    assert np.float32(got.item()).view(np.int32) == want.view(np.int32)


def test_op_on_cpu_takes_the_plain_versions():
    """A CPU tensor takes the plain mask, the plain apply and autograd
    through it; no kernel is launched, fused or not."""
    n, h, w, c, bs, kp = 2, 14, 14, 8, 7, 0.8
    rng = np.random.default_rng(36)
    x = _nchw(rng.standard_normal((n, h, w, c)).astype(np.float32)).requires_grad_()
    g = _nchw(rng.standard_normal((n, h, w, c)).astype(np.float32))
    seeds = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int32)
    counters = ("LAUNCHES", "APPLY_LAUNCHES", "APPLY_BWD_LAUNCHES", "FUSED_LAUNCHES")
    before = [getattr(kdrop, k) for k in counters]
    y = dropblock(x, seeds, keep_prob=kp, block_size=bs, train=True)
    (dx,) = torch.autograd.grad(y, x, g)
    assert [getattr(kdrop, k) for k in counters] == before
    mask, counts = kdrop.dropblock_mask_reference(
        torch.from_numpy(seeds), float(dropblock_gamma(kp, bs, h, w)), h, w, bs)
    assert torch.equal(y, kdrop.dropblock_apply_reference(x, mask, counts))
    assert torch.equal(dx, kdrop.dropblock_apply_bwd_reference(g, mask, counts))


def _apply_args(n=2, c=8, h=6, w=6, dtype=torch.float32, mask_shape=None,
                counts_shape=None, mask_dtype=torch.float32):
    return (torch.zeros(n, c, h, w, dtype=dtype),
            torch.ones(mask_shape or (n, h, w), dtype=mask_dtype),
            torch.full(counts_shape or (n,), float(h * w)))


def _too_many_pixels():
    """N = 2**31 one-pixel samples, more than the kernel's int sample index
    takes, as views of one element."""
    n = 2 ** 31
    return (torch.zeros(1, 1, 1, 1).expand(n, 1, 1, 1), torch.ones(1, 1, 1).expand(n, 1, 1),
            torch.ones(1).expand(n))


REFUSALS = {  # case -> (the wrapper's arguments, the exception, its message)
    "cpu_tensor": (_apply_args, ValueError, "CUDA tensors"),
    "float64": (lambda: _apply_args(dtype=torch.float64), TypeError, "float32 or bfloat16"),
    "float16": (lambda: _apply_args(dtype=torch.float16), TypeError, "float32 or bfloat16"),
    "not_4d": (lambda: (torch.zeros(2, 8, 36),) + _apply_args()[1:], ValueError, "NCHW"),
    "mask_shape": (lambda: _apply_args(mask_shape=(2, 6, 5)), ValueError, "mask must be"),
    "mask_float64": (lambda: _apply_args(mask_dtype=torch.float64), ValueError, "mask must be"),
    "counts_shape": (lambda: _apply_args(counts_shape=(3,)), ValueError, "counts must be"),
    "too_many_pixels": (_too_many_pixels, ValueError, r"N and C <= 2147483647"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_apply_wrapper_refuses_before_loading_the_library(case, monkeypatch):
    from axcnn_torch.kernels import build

    def no_load():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(build, "load_library", no_load)
    make_args, exc, match = REFUSALS[case]
    launches = (kdrop.APPLY_LAUNCHES, kdrop.APPLY_BWD_LAUNCHES, kdrop.APPLY_NOT_CHANNELS_LAST)
    for backward in (False, True):
        with pytest.raises(exc, match=match):
            kdrop.dropblock_apply_cuda(*make_args(), backward=backward)
    assert (kdrop.APPLY_LAUNCHES, kdrop.APPLY_BWD_LAUNCHES,
            kdrop.APPLY_NOT_CHANNELS_LAST) == launches


def test_apply_function_refuses_cpu_tensors():
    x, mask, counts = _apply_args()
    with pytest.raises(ValueError, match="CUDA tensors"):
        kdrop.DropBlockApply.apply(x.requires_grad_(), mask, counts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,bs", DB_CASES[:3])
def test_plain_fused_composition_matches_jax_vjp(shape, bs, dtype):
    """The fused kernel's plain version (the plain mask, then the plain
    apply), given the reference's uniforms, against
    ``axcnn.ops.dropblock.dropblock`` and its ``jax.vjp`` at the maps the
    fused route takes. Tolerance 0, as for the op."""
    kp = 0.5
    n, h, w, _ = shape
    assert kdrop.fused_route(h, w)
    key, u = _key_and_uniforms(shape, 37)
    rng = np.random.default_rng(38)
    x, g = rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(
        np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want_y, vjp = jax.vjp(lambda a: j_dropblock(key, a, keep_prob=kp, block_size=bs, train=True),
                          jnp.asarray(x, jdt))
    (want_dx,) = vjp(jnp.asarray(g, jdt))
    bs = min(bs, h, w)
    gamma = float(dropblock_gamma(kp, bs, h, w))
    xt = _nchw(x).to(tdt).requires_grad_()
    y, mask, counts = kdrop.dropblock_fused_reference(
        xt, torch.zeros(n, dtype=torch.int32), gamma, bs, uniforms=u)
    (dx,) = torch.autograd.grad(y, xt, _nchw(g).to(tdt))
    assert mask.shape == (n, h, w) and torch.equal(counts, mask.sum(dim=(1, 2)))
    np.testing.assert_array_equal(_nhwc(y), np.asarray(want_y, np.float32))
    np.testing.assert_array_equal(_nhwc(dx), np.asarray(want_dx, np.float32))
    assert bool((dx == 0).any()) and bool((dx != 0).any())


# (H, W) -> whether the card takes the fused kernel: the presets' 14x14 and
# 7x7, the line itself (16,384 pixels), and maps past it
ROUTES = [((14, 14), True), ((7, 7), True), ((1, 1), True), ((128, 128), True),
          ((1, 16384), True), ((128, 129), False), ((160, 160), False), ((245, 245), False)]


@pytest.mark.parametrize("hw,fused", ROUTES)
def test_fused_route_by_map_size(hw, fused):
    assert kdrop.fused_route(*hw) is fused


def test_fused_line_is_the_kernel_source_line():
    """FUSED_MAX_HW is the source's kWholeMapHW, the bound the fused entry
    point enforces (a sample's two byte maps in shared memory)."""
    import pathlib
    import re

    src = (pathlib.Path(kdrop.__file__).parents[1] / "csrc" / "dropblock.cu").read_text()
    assert int(re.search(r"constexpr int kWholeMapHW = (\d+);", src).group(1)) == kdrop.FUSED_MAX_HW
    entry = src[src.index('extern "C" int axcnn_dropblock_fused'):]
    assert "h_global * w > kWholeMapHW" in entry[:entry.index("return")]


class _Recorder:
    """Stands in for a kernel wrapper or an autograd Function: records each
    call's arguments (a tensor as its device and dtype) and returns the
    input, or ``result``."""

    def __init__(self, name, calls, result=None):
        self.name, self.calls, self.result = name, calls, result

    def _record(self, args):
        self.calls.append((self.name, tuple((a.device.type, a.dtype) if torch.is_tensor(a)
                                            else a for a in args)))

    def apply(self, *args):
        self._record(args)
        return args[0]

    def __call__(self, *args):
        self._record(args)
        return self.result


@pytest.mark.parametrize("hw,fused", ROUTES[:2] + ROUTES[5:7])
def test_op_routes_card_tensors_by_map_size(hw, fused, monkeypatch):
    """A tensor off the CPU takes the fused Function at maps within the line
    and the mask kernel, then the apply Function, past it; with the same
    gamma and block size either way. (A meta tensor stands in for a CUDA
    one: the route is chosen before anything launches.)"""
    h, w = hw
    calls = []
    monkeypatch.setattr(op_dropblock, "DropBlockFused", _Recorder("fused", calls))
    monkeypatch.setattr(op_dropblock, "DropBlockApply", _Recorder("apply", calls))
    monkeypatch.setattr(op_dropblock, "dropblock_mask_cuda",
                        _Recorder("mask", calls, result=("mask", "counts")))
    x = torch.empty(2, 8, h, w, device="meta")
    y = dropblock(x, np.array([5, 6], np.int32), keep_prob=0.9, block_size=7, train=True)
    bs = min(7, h, w)
    gamma = float(dropblock_gamma(0.9, bs, h, w))
    assert y is x
    xt, seeds = ("meta", torch.float32), ("meta", torch.int32)
    if fused:
        assert calls == [("fused", (xt, seeds, gamma, bs))]
    else:
        assert calls == [("mask", (seeds, gamma, h, w, bs)), ("apply", (xt, "mask", "counts"))]


def _fused_args(n=2, c=8, h=6, w=6, dtype=torch.float32, seeds_dtype=torch.int32,
                seeds_n=None):
    return (torch.zeros(n, c, h, w, dtype=dtype),
            torch.zeros(n if seeds_n is None else seeds_n, dtype=seeds_dtype), 0.1, 3)


def _too_many_samples():
    """N = 2**31 one-pixel samples, as views of one element."""
    n = 2 ** 31
    return (torch.zeros(1, 1, 1, 1).expand(n, 1, 1, 1),
            torch.zeros(1, dtype=torch.int32).expand(n), 0.1, 1)


FUSED_REFUSALS = {  # case -> (the wrapper's arguments, the exception, its message)
    "cpu_tensor": (_fused_args, ValueError, "CUDA tensors"),
    "float64": (lambda: _fused_args(dtype=torch.float64), TypeError, "float32 or bfloat16"),
    "float16": (lambda: _fused_args(dtype=torch.float16), TypeError, "float32 or bfloat16"),
    "not_4d": (lambda: (torch.zeros(2, 8, 36),) + _fused_args()[1:], ValueError, "NCHW"),
    "seeds_int64": (lambda: _fused_args(seeds_dtype=torch.int64), TypeError, "seeds must be"),
    "seeds_count": (lambda: _fused_args(seeds_n=3), TypeError, "seeds must be"),
    "block_size": (lambda: _fused_args()[:3] + (7,), ValueError, "block_size"),
    "past_the_line": (lambda: _fused_args(h=160, w=160), ValueError, "H\\*W <= 16384"),
    "too_many_samples": (_too_many_samples, ValueError, r"N and C <= 2147483647"),
}


@pytest.mark.parametrize("case", list(FUSED_REFUSALS))
def test_fused_wrapper_refuses_before_loading_the_library(case, monkeypatch):
    from axcnn_torch.kernels import build

    def no_load():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(build, "load_library", no_load)
    make_args, exc, match = FUSED_REFUSALS[case]
    before = (kdrop.FUSED_LAUNCHES, kdrop.APPLY_NOT_CHANNELS_LAST)
    with pytest.raises(exc, match=match):
        kdrop.dropblock_fused_cuda(*make_args())
    assert (kdrop.FUSED_LAUNCHES, kdrop.APPLY_NOT_CHANNELS_LAST) == before


def test_fused_function_refuses_cpu_tensors():
    x, seeds, gamma, bs = _fused_args()
    with pytest.raises(ValueError, match="CUDA tensors"):
        kdrop.DropBlockFused.apply(x.requires_grad_(), seeds, gamma, bs)
