"""The port's hand-written kernels, held against their plain PyTorch versions.

This file imports no JAX, so on a machine with a CUDA card and no JAX it runs
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tests marked ``cuda`` launch the kernels and skip where there is no CUDA
device (a CUDA kernel has no CPU mode); the rest check the plain versions and
the wrappers' routing and refusals on the CPU. Parity of the plain versions
with the JAX reference is in tests/test_torch_ops.py.
"""

import numpy as np
import pytest
import torch

from axcnn_torch.kernels import blurpool as kblur
from axcnn_torch.kernels import dropblock as kdrop
from axcnn_torch.ops.blurpool import blur_pool
from axcnn_torch.ops.dropblock import dropblock


def _nchw(shape_nhwc, seed, device="cpu", dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(shape_nhwc).astype(np.float32)
    return torch.from_numpy(x).to(device, dtype).permute(0, 3, 1, 2)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def test_blur_reference_bf16_rounds_once():
    x = _nchw((2, 9, 8, 16), 12, dtype=torch.bfloat16)
    got = kblur.blur_pool_reference(x)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, kblur.blur_pool_reference(x.float()).to(torch.bfloat16))


@pytest.mark.parametrize("hw", [(8, 8), (7, 9), (1, 1), (2, 3)])
def test_blur_reference_against_direct_sum(hw):
    """The even/odd form against the definition: out[i,j] = sum of
    w[a] w[b] x[2i-1+a, 2j-1+b] over the zero-padded image, w = [1,2,1]/4."""
    x = _nchw((2, *hw, 3), 15).double()
    h, w = hw
    xp = torch.nn.functional.pad(x, (1, 2, 1, 2))
    k = torch.tensor([1.0, 2.0, 1.0], dtype=torch.float64) / 4
    want = torch.zeros(2, 3, (h + 1) // 2, (w + 1) // 2, dtype=torch.float64)
    for a in range(3):
        for b in range(3):
            want += k[a] * k[b] * xp[:, :, a:a + 2 * want.shape[2]:2,
                                     b:b + 2 * want.shape[3]:2]
    got = kblur.blur_pool_reference(x.float())
    torch.testing.assert_close(got.double(), want, atol=1e-6, rtol=1e-6)


def test_blur_pool_routes_cpu_tensors_to_reference():
    x = _nchw((1, 6, 6, 8), 13)
    before = kblur.LAUNCHES
    assert torch.equal(blur_pool(x), kblur.blur_pool_reference(x))
    assert kblur.LAUNCHES == before  # the kernel was not launched


def test_blur_pool_refuses_what_it_does_not_take():
    x = torch.zeros(1, 8, 6, 6)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kblur.blur_pool_cuda(x)
    with pytest.raises(NotImplementedError, match="filter_size=3, stride=2"):
        blur_pool(x, filter_size=5)
    with pytest.raises(NotImplementedError):
        blur_pool(x, stride=3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 56, 56, 128), (3, 15, 17, 96), (2, 7, 9, 3)])
def test_kernel_matches_reference_on_card(shape, dtype):
    _cuda()
    x = _nchw(shape, 14, "cuda", dtype)
    before = kblur.LAUNCHES
    got = kblur.blur_pool_cuda(x)
    torch.cuda.synchronize()
    assert kblur.LAUNCHES == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    # the same fp32 terms in the same order, rounded once: bit-identical
    assert torch.equal(got, kblur.blur_pool_reference(x))


@pytest.mark.cuda
def test_kernel_refuses_bad_inputs_on_card():
    _cuda()
    x = _nchw((2, 8, 8, 16), 16, "cuda")
    with pytest.raises(ValueError, match="channels_last"):
        kblur.blur_pool_cuda(x.contiguous())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kblur.blur_pool_cuda(x.half())
    with pytest.raises(NotImplementedError):
        kblur.blur_pool_cuda(x, filter_size=5)


# ---------------------------------------------------------------------------
# BlurPool backward and its autograd Function
# ---------------------------------------------------------------------------

def _grad_for(shape_nhwc, seed, device="cpu", dtype=torch.float32):
    n, h, w, c = shape_nhwc
    return _nchw((n, (h + 1) // 2, (w + 1) // 2, c), seed, device, dtype)


def test_blur_bwd_reference_against_the_forward_transpose():
    """<D x, g> == <x, D^T g>: the plain backward is the transpose of the
    plain forward, odd extents included (both compute in fp32; the inner
    products are taken in float64, so rtol 1e-6 covers fp32 rounding)."""
    for hw in [(8, 8), (7, 9), (1, 1), (2, 3), (15, 17)]:
        x, g = _nchw((2, *hw, 3), 17), _grad_for((2, *hw, 3), 18)
        lhs = (kblur.blur_pool_reference(x).double() * g.double()).sum()
        rhs = (x.double() * kblur.blur_pool_bwd_reference(g, hw).double()).sum()
        torch.testing.assert_close(lhs, rhs, rtol=1e-6, atol=1e-6)


def test_blur_bwd_refuses_what_it_does_not_take():
    g = torch.zeros(1, 8, 3, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kblur.blur_pool_bwd_cuda(g, (6, 6))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 56, 56, 128), (4, 28, 28, 256), (4, 14, 14, 512),
                                   (3, 15, 17, 96), (2, 8, 9, 3)])
def test_bwd_kernel_matches_reference_on_card(shape, dtype):
    _cuda()
    g = _grad_for(shape, 19, "cuda", dtype)
    before = kblur.BWD_LAUNCHES
    got = kblur.blur_pool_bwd_cuda(g, shape[1:3])
    torch.cuda.synchronize()
    assert kblur.BWD_LAUNCHES == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, kblur.blur_pool_bwd_reference(g, shape[1:3]))
    # autograd may hand in a gradient in another memory format
    assert torch.equal(kblur.blur_pool_bwd_cuda(g.contiguous(), shape[1:3]), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_gradient_matches_autograd_of_plain_forward_on_card(dtype):
    _cuda()
    shape = (3, 15, 17, 96)
    x = _nchw(shape, 20, "cuda", dtype).requires_grad_()
    g = _grad_for(shape, 21, "cuda", dtype)
    fwd, bwd = kblur.LAUNCHES, kblur.BWD_LAUNCHES
    blur_pool(x).backward(g)
    assert (kblur.LAUNCHES, kblur.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    x2 = x.detach().clone().requires_grad_()
    kblur.blur_pool_reference(x2).backward(g)
    assert torch.equal(x.grad, x2.grad)


# ---------------------------------------------------------------------------
# DropBlock mask
# ---------------------------------------------------------------------------

def test_dropblock_routes_cpu_tensors_to_reference():
    x = _nchw((2, 14, 14, 8), 22)
    seeds = np.array([3, 4], np.int32)
    before = kdrop.LAUNCHES
    y = dropblock(x, seeds, keep_prob=0.8, block_size=7, train=True)
    assert kdrop.LAUNCHES == before
    assert y.shape == x.shape and torch.isfinite(y).all()


def test_dropblock_mask_kernel_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="CUDA seeds"):
        kdrop.dropblock_mask_cuda(torch.zeros(2, dtype=torch.int32), 0.1, 14, 14, 7)
    with pytest.raises(ValueError, match="H\\*W"):
        kdrop.check_mask_args(200, 200, 7)
    with pytest.raises(ValueError, match="block_size"):
        kdrop.check_mask_args(5, 5, 7)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,bs", [(14, 14, 7), (7, 7, 7), (15, 17, 5)])
@pytest.mark.parametrize("gamma", [0.0, 0.02, 0.1])
def test_mask_kernel_matches_reference_on_card(h, w, bs, gamma):
    _cuda()
    seeds = torch.from_numpy(np.random.default_rng(23).integers(
        -2 ** 31, 2 ** 31, 128, dtype=np.int32)).cuda()
    before = kdrop.LAUNCHES
    mask, counts = kdrop.dropblock_mask_cuda(seeds, gamma, h, w, bs)
    torch.cuda.synchronize()
    assert kdrop.LAUNCHES == before + 1  # it launches for gamma = 0 too
    want_m, want_c = kdrop.dropblock_mask_reference(seeds, gamma, h, w, bs)
    assert torch.equal(mask, want_m) and torch.equal(counts, want_c)
    if gamma == 0.0:
        assert bool((mask == 1).all())


@pytest.mark.cuda
def test_dropblock_op_on_card_matches_cpu():
    """The op on the card (mask kernel) equals the op on the CPU (plain
    version) bit for bit, from the same seeds."""
    _cuda()
    x = _nchw((8, 14, 14, 64), 24)
    seeds = np.random.default_rng(25).integers(-2 ** 31, 2 ** 31, 8, dtype=np.int32)
    want = dropblock(x, seeds, keep_prob=0.8, block_size=7, train=True)
    got = dropblock(x.cuda(), seeds, keep_prob=0.8, block_size=7, train=True)
    assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# the kernels on the KD and gradient-accumulation paths
# ---------------------------------------------------------------------------

KD_CFG = dict(width_multiplier=0.125, num_classes=10, use_resnet_d=True,
              use_se_block=True, use_sk_block=True, anti_alias_type="sconv",
              use_dropblock=True, dropblock_keep_prob=0.5, zero_gamma=True)


def _teacher(device):
    from axcnn_torch.models.resnet import ModelConfig, ResNet

    model = ResNet(ModelConfig(**KD_CFG), generator=torch.Generator().manual_seed(30))
    return model.to(device, memory_format=torch.channels_last).eval().requires_grad_(False)


def _kd_batch():
    rng = np.random.default_rng(31)
    return {"images": torch.from_numpy(rng.integers(0, 256, (8, 64, 64, 3), dtype=np.uint8)),
            "labels": torch.from_numpy(rng.integers(0, 10, 8))}


def _counts():
    return (kblur.LAUNCHES, kblur.BWD_LAUNCHES, kdrop.LAUNCHES)


@pytest.mark.cuda
def test_teacher_forward_on_card():
    """The frozen teacher's no_grad forward launches the BlurPool forward
    kernel at the 3 stride-2 blocks and no backward; its logits agree with
    the CPU's plain path (fp32, TF32 off)."""
    _cuda()
    from axcnn_torch.core.dtypes import DEFAULT_POLICY, set_fp32_precision

    set_fp32_precision(DEFAULT_POLICY)
    x = torch.from_numpy(np.random.default_rng(32).standard_normal(
        (4, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        want = _teacher("cpu")(x)
        before = _counts()
        got = _teacher("cuda")(x.cuda()).cpu()
    assert np.subtract(_counts(), before).tolist() == [3, 0, 0]
    assert (got - want).norm() / want.norm() <= 1e-4


@pytest.mark.cuda
def test_accumulated_kd_step_on_card():
    """One KD step with grad_accum_steps=2 on the card: per micro-batch the
    student's 3 forward and 3 backward BlurPool launches, the teacher's 3
    forward launches and 9 DropBlock masks; the loss agrees with the same
    step on the CPU through the plain versions."""
    _cuda()
    from axcnn_torch.core.dtypes import DEFAULT_POLICY, set_fp32_precision
    from axcnn_torch.models.resnet import ModelConfig
    from axcnn_torch.train.schedules import make_lr_schedule
    from axcnn_torch.train.train_step import create_train_state, make_train_step

    set_fp32_precision(DEFAULT_POLICY)
    cfg = ModelConfig(**KD_CFG)
    losses = {}
    for device in ("cpu", "cuda"):
        state = create_train_state(cfg, generator=torch.Generator().manual_seed(33),
                                   device=device)
        state.step = 5  # DropBlock drops
        step = make_train_step(cfg, lr_schedule=make_lr_schedule(
            base_lr=0.1, total_steps=10, warmup_steps=0), total_steps=10,
            mixup_alpha=0.2, teacher=_teacher(device), kd_temp=2.0, grad_accum_steps=2)
        before = _counts()
        state, metrics = step(state, {k: v.to(device) for k, v in _kd_batch().items()}, 7)
        losses[device] = metrics["loss"].item()
        if device == "cuda":
            torch.cuda.synchronize()
            assert np.subtract(_counts(), before).tolist() == [2 * (3 + 3), 2 * 3, 2 * 9]
            assert all(torch.isfinite(v).all() for v in state.velocity.values())
    assert np.isfinite(losses["cuda"])
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"])
