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
from axcnn_torch.ops.blurpool import blur_pool


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
