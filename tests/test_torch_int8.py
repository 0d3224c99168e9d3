"""int8 serving in the port (axcnn_torch.ops.conv.dynamic_int8_conv and
INT8_SERVING_POLICY) against the JAX reference's (axcnn.ops.conv
._dynamic_int8_conv, axcnn.core.dtypes.INT8_SERVING_POLICY), on the CPU.

- The conv, in fp32 and bf16, at stride 2, dilation 2, 1x1 and the stem's
  k = 27, against the reference's on the same inputs: tolerance 0. The
  quantization (max-abs scales, round half to even) and the dequantize
  (``acc * (sx * sw)`` in fp32) are the same IEEE operations in the same
  order, and the plain version's float64 conv sums integers exactly.
- The card route's operands (``int8_gemm_operands``: the patch matrix and
  the weight matrix, padded for ``torch._int_mm``) reproduce the plain
  accumulators exactly through an int64 product here.
- The model's int8 forward against the reference's on converted weights:
  relative L2 < 0.05 and the same argmax, as tests/test_export.py bounds
  the reference's own exported int8 forward (bf16 rounds at other places in
  the two frameworks).
- The policy, and the training loop's refusal of it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from axcnn.core.dtypes import INT8_SERVING_POLICY as J_INT8
from axcnn.core.dtypes import policy_from_name as j_policy
from axcnn.models.resnet import ModelConfig as JModelConfig
from axcnn.models.resnet import resnet_apply
from axcnn.ops.conv import _dynamic_int8_conv, fixed_pad_amounts
from axcnn_torch.ckpt.convert import from_axcnn
from axcnn_torch.core.dtypes import BF16_POLICY, INT8_SERVING_POLICY, policy_from_name
from axcnn_torch.models.resnet import ModelConfig, ResNet
from axcnn_torch.ops.conv import (conv2d_fixed_padding, int8_conv_acc_reference,
                                  int8_gemm_operands, quantize_int8)
from test_torch_model import _random_tree
import torch_inprocess

capped_threads = torch_inprocess.capped_threads

# (N, H, W, C, O, k, stride, dilation)
CONV_CASES = {
    "3x3": (2, 9, 9, 8, 16, 3, 1, 1),
    "3x3_stride2": (2, 9, 9, 8, 16, 3, 2, 1),
    "3x3_dilation2": (2, 9, 9, 8, 20, 3, 1, 2),
    "stem_k27_stride2": (2, 16, 16, 3, 32, 3, 2, 1),
    "1x1": (2, 8, 8, 16, 24, 1, 1, 1),
    "1x1_stride2": (2, 8, 8, 16, 24, 1, 2, 1),
    "5x5_merged_sk": (1, 7, 7, 8, 16, 5, 2, 1),
}


def _conv_inputs(case, seed=0):
    n, h, w, c, o, k, _, _ = CONV_CASES[case]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, h, w, c)).astype(np.float32),
            (rng.standard_normal((k, k, c, o)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_int8_conv_matches_reference_exactly(case, dtype):
    _, _, _, _, _, k, stride, dilation = CONV_CASES[case]
    x, w = _conv_inputs(case)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    pad = (fixed_pad_amounts(k, dilation),) * 2
    want = _dynamic_int8_conv(jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd),
                              stride=stride, dilation=dilation, groups=1, pad=pad, out_dtype=jd)
    got = conv2d_fixed_padding(torch.from_numpy(x).permute(0, 3, 1, 2),
                               torch.from_numpy(w).permute(3, 2, 0, 1), stride=stride,
                               dilation=dilation, compute_dtype=td, quantize=True)
    assert got.dtype == td
    np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("case", sorted(CONV_CASES) + ["few_rows", "odd_width"])
def test_gemm_operands_reproduce_the_accumulators(case):
    """The card route's matrices, with their padding (M past 16, K and N to
    multiples of 8), give the plain version's int32 accumulators."""
    n, h, w, c, o, k, stride, dilation = {
        "few_rows": (1, 2, 2, 8, 8, 1, 1, 1), "odd_width": (2, 5, 6, 5, 13, 3, 1, 1),
    }.get(case) or CONV_CASES[case]
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(n, c, h, w, generator=gen).contiguous(memory_format=torch.channels_last)
    wt = torch.randn(o, c, k, k, generator=gen)
    pad = fixed_pad_amounts(k, dilation)[0]
    xq, _, wq, _ = quantize_int8(x, wt)
    want = int8_conv_acc_reference(xq, wq, stride=stride, dilation=dilation, padding=pad)
    a, b, (nn, ho, wo, m, oo) = int8_gemm_operands(xq, wq, stride=stride, dilation=dilation,
                                                   padding=pad)
    assert a.dtype == b.dtype == torch.int8
    assert a.shape[0] > 16 and a.shape[1] % 8 == 0 and b.shape[0] % 8 == 0
    got = (a.long() @ b.long().t())[:m, :oo].view(nn, ho, wo, oo).permute(0, 3, 1, 2)
    assert torch.equal(got.to(torch.int32), want)


def test_int8_policy_matches_reference():
    j, t = j_policy("int8"), policy_from_name("int8")
    assert t is INT8_SERVING_POLICY
    assert t.quantize_conv is j.quantize_conv is True
    assert (t.param_dtype, t.compute_dtype) == (torch.float32, torch.bfloat16)
    assert (j.param_dtype, j.compute_dtype) == (jnp.float32, jnp.bfloat16)
    assert not policy_from_name("bf16").quantize_conv and not BF16_POLICY.quantize_conv


@pytest.mark.parametrize("merged", [False, True], ids=["sk", "sk_merged"])
def test_model_int8_forward_tracks_reference(merged):
    kw = dict(width_multiplier=0.25, num_classes=10, use_resnet_d=True, use_se_block=True,
              use_sk_block=True, sk_merged_conv=merged, anti_alias_type="sconv")
    params, state = _random_tree(kw, seed=3)
    model = ResNet(ModelConfig(**kw))
    model.load_state_dict(from_axcnn(params, state, ModelConfig(**kw)), strict=True)
    model = model.to(memory_format=torch.channels_last).eval()
    x = np.random.default_rng(4).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(resnet_apply(params, state, jnp.asarray(x), cfg=JModelConfig(**kw),
                                   train=False, policy=J_INT8)[0], np.float32)
    with torch.inference_mode():
        got = model(torch.from_numpy(x), policy=INT8_SERVING_POLICY).numpy()
    assert np.isfinite(got).all()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 0.05, rel
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_loop_refuses_int8_training(tmp_path):
    from axcnn_torch.train.loop import run
    from axcnn_torch.utils.config import Config

    cfg = Config()
    cfg.data.use_synthetic_data = True
    cfg.train.dtype = "int8"
    cfg.runtime.platform = "cpu"
    cfg.runtime.model_dir = str(tmp_path)
    with pytest.raises(ValueError, match="serving-only"):
        run(cfg)
    assert not list(tmp_path.iterdir())  # refused before anything ran
