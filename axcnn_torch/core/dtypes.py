"""Mixed-precision policy (port of ``axcnn/core/dtypes.py``).

Same convention as the reference: parameters and BN statistics are stored in
fp32, activations and conv/matmul inputs are cast to ``compute_dtype``, and
normalization, attention and the classifier head run in fp32. Casts are
explicit (no ``torch.autocast``) so the port rounds where the reference does.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)


DEFAULT_POLICY = Policy()
BF16_POLICY = Policy(param_dtype=torch.float32, compute_dtype=torch.bfloat16)


def policy_from_name(name: str) -> Policy:
    """Map the ``--train.dtype`` flag onto a policy (``fp16`` means bf16, as
    in the reference)."""
    name = name.lower()
    if name in ("fp32", "float32"):
        return DEFAULT_POLICY
    if name in ("bf16", "bfloat16", "fp16", "float16", "amp"):
        return BF16_POLICY
    if name == "int8":
        raise NotImplementedError(
            "the int8 serving policy is not ported yet (ROADMAP.md Queue A "
            "item 10)")
    raise ValueError(f"unknown dtype policy: {name!r}")


def set_fp32_precision(policy: Policy) -> None:
    """fp32 means fp32: under the fp32 policy turn off TF32 in cuDNN
    convolutions and cuBLAS matmuls (cuDNN's fp32 convolutions run in TF32 by
    default), the counterpart of the reference's ``Precision.HIGHEST``."""
    if policy.compute_dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
