"""axcnn_torch — the PyTorch / CUDA (NVIDIA Hopper) port of ``axcnn``.

The JAX package ``axcnn`` is the reference; every module here mirrors the
module of the same name there, and the ``tests/test_torch_*.py`` parity tests
hold the two against each other. This package imports ``torch`` and never
``jax``. It reuses the JAX package's jax-free host modules
(``axcnn.data.datasets``, ``axcnn.data.preprocessing``).

Layout conventions:
- activations are NCHW tensors in ``torch.channels_last`` memory (physically
  NHWC, like the JAX code); the model's public entry takes NHWC images;
- conv weights are OIHW, dense weights ``(out, in)``;
- fp32 parameters, compute dtype from ``axcnn_torch.core.dtypes.Policy``.

Slice ported so far: eval-mode serving of the ResNet family through
``python -m axcnn_torch.cli.predict`` with the hand-written CUDA BlurPool
kernel (``axcnn_torch/csrc/blurpool.cu``). Training comes next (ROADMAP.md).
"""

__version__ = "0.1.0"
