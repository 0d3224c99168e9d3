"""Anti-alias BlurPool (port of ``axcnn/ops/blurpool.py``), NCHW.

The device decides the route: a CPU tensor takes the plain PyTorch version,
which autograd differentiates; a CUDA tensor takes the hand-written kernels
through ``BlurPool3S2`` (forward kernel, backward kernel as its gradient),
which raise on what they do not take. There is no fallback and no switch.
"""

from __future__ import annotations

from axcnn_torch.kernels.blurpool import BlurPool3S2, blur_pool_reference, check_blur_args


def blur_pool(x, *, stride: int = 2, filter_size: int = 3):
    """Depthwise binomial blur + stride-``stride`` subsample."""
    if x.device.type == "cpu":
        return blur_pool_reference(x, stride=stride, filter_size=filter_size)
    check_blur_args(stride, filter_size)
    return BlurPool3S2.apply(x)
