"""Mixed-precision policy (port of ``axcnn/core/dtypes.py``).

Same convention as the reference: parameters and BN statistics are stored in
fp32, activations and conv/matmul inputs are cast to ``compute_dtype``, and
normalization, attention and the classifier head run in fp32. Casts are
explicit (no ``torch.autocast``) so the port rounds where the reference does.

``INT8_SERVING_POLICY`` is the reference's serving-only post-training
quantization: every model conv runs through the dynamic int8 conv
(``axcnn_torch.ops.conv.dynamic_int8_conv``), everything else in bf16. The
quantized conv is not differentiable, so the training loop refuses it.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    # serving only: every model conv through the dynamic int8 conv
    quantize_conv: bool = False

    def cast_to_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)


DEFAULT_POLICY = Policy()
BF16_POLICY = Policy(param_dtype=torch.float32, compute_dtype=torch.bfloat16)
INT8_SERVING_POLICY = Policy(param_dtype=torch.float32, compute_dtype=torch.bfloat16,
                             quantize_conv=True)


def policy_from_name(name: str) -> Policy:
    """Map the ``--train.dtype`` flag onto a policy (``fp16`` means bf16, as
    in the reference; ``int8`` is the serving-only quantized policy)."""
    name = name.lower()
    if name in ("fp32", "float32"):
        return DEFAULT_POLICY
    if name in ("bf16", "bfloat16", "fp16", "float16", "amp"):
        return BF16_POLICY
    if name == "int8":
        return INT8_SERVING_POLICY
    raise ValueError(f"unknown dtype policy: {name!r}")


def set_fp32_precision(policy: Policy) -> None:
    """fp32 means fp32: under the fp32 policy turn off TF32 in cuDNN
    convolutions and cuBLAS matmuls (cuDNN's fp32 convolutions run in TF32 by
    default), the counterpart of the reference's ``Precision.HIGHEST``."""
    if policy.compute_dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
