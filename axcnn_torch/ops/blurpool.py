"""Anti-alias BlurPool (port of ``axcnn/ops/blurpool.py``), NCHW.

The device decides the route: a CPU tensor takes the plain PyTorch version,
a CUDA tensor the hand-written kernel, which raises on what it does not take.
There is no fallback and no switch.
"""

from __future__ import annotations

from axcnn_torch.kernels.blurpool import blur_pool_cuda, blur_pool_reference


def blur_pool(x, *, stride: int = 2, filter_size: int = 3):
    """Depthwise binomial blur + stride-``stride`` subsample."""
    if x.device.type == "cpu":
        return blur_pool_reference(x, stride=stride, filter_size=filter_size)
    return blur_pool_cuda(x, stride=stride, filter_size=filter_size)
