"""Plain PyTorch forward of the ResNet-50 family the configurations name.

Written from the published descriptions, not from the program: the
bottleneck ResNet v1 (He et al. 2016); ResNet-D's deep stem and
average-pooled shortcut; Selective Kernel units (a 3x3 and a dilated 3x3
branch, attention over them from the pooled sum); Squeeze-and-Excitation;
BlurPool (a [1, 2, 1] x [1, 2, 1] / 16 depthwise blur with stride 2 after
the strided block's middle conv); DropBlock after every block of stages 3
and 4. Convolutions pad as TensorFlow's ``fixed_padding`` does, pools as
its ``SAME``. Batch norm uses the batch's biased statistics in training
and the moving ones in evaluation, eps 1e-5.

Parameters live in one dict of tensors whose names are the state-dict
names of the program's model (``stage2.block0.sk.conv1.weight``), so the
benchmark hands both sides the same tensors. Everything runs in the dtype
of the parameters (float32 for the judged reference, TF32 off); a
``quant`` function, when given, rounds every tensor that passes between
operations (conv and dense inputs, weights and outputs, batch-norm
outputs, block outputs): the lower-precision control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
STAGE_FILTERS = (64, 128, 256, 512)
EXPANSION = 4
EPS = 1e-5
MEAN_RGB = (123.68, 116.78, 103.94)
STDDEV_RGB = (58.393, 57.12, 57.375)


def stage_filters(model: dict, s: int) -> int:
    return int(STAGE_FILTERS[s] * model.get("width_multiplier", 1.0))


def param_shapes(model: dict) -> dict:
    """{name: shape} of every parameter. Refuses a configuration with a
    block this reference does not write down."""
    if (model["anti_alias_type"] not in ("none", "sconv") or model["anti_alias_filter_size"] != 3
            or model["bl_alpha"] or model["bl_beta"]):
        raise NotImplementedError("the reference writes the plain and assembled ResNet only: "
                                  "BlurPool sconv 3x3, no Big-Little stages")
    shapes = {}

    def conv(name, k, cin, cout):
        shapes[f"{name}.weight"] = (cout, cin, k, k)

    def bn(name, c):
        shapes[f"{name}.weight"] = (c,)
        shapes[f"{name}.bias"] = (c,)

    def dense(name, cin, cout, bias=True):
        shapes[f"{name}.weight"] = (cout, cin)
        if bias:
            shapes[f"{name}.bias"] = (cout,)

    if model["use_resnet_d"]:
        for i, (cin, cout) in enumerate([(3, 32), (32, 32), (32, 64)]):
            conv(f"stem.conv{i}", 3, cin, cout)
            bn(f"stem.bn{i}", cout)
    else:
        conv("stem.conv0", 7, 3, 64)
        bn("stem.bn0", 64)
    cin = 64
    for s, n in enumerate(BLOCKS[model["resnet_size"]]):
        f = stage_filters(model, s)
        for b in range(n):
            p = f"stage{s + 1}.block{b}"
            if b == 0:
                conv(f"{p}.proj_conv", 1, cin, f * EXPANSION)
                bn(f"{p}.proj_bn", f * EXPANSION)
            conv(f"{p}.conv1", 1, cin, f)
            bn(f"{p}.bn1", f)
            if model["use_sk_block"]:
                d = max(f // 16, 32)
                for br in range(2):
                    conv(f"{p}.sk.conv{br}", 3, f, f)
                    bn(f"{p}.sk.bn{br}", f)
                dense(f"{p}.sk.fc_z", f, d, bias=False)
                bn(f"{p}.sk.bn_z", d)
                dense(f"{p}.sk.fc_select", d, 2 * f)
            else:
                conv(f"{p}.conv2", 3, f, f)
                bn(f"{p}.bn2", f)
            conv(f"{p}.conv3", 1, f, f * EXPANSION)
            bn(f"{p}.bn3", f * EXPANSION)
            if model["use_se_block"]:
                c = f * EXPANSION
                dense(f"{p}.se.fc1", c, max(c // model.get("se_ratio", 16), 1))
                dense(f"{p}.se.fc2", max(c // model.get("se_ratio", 16), 1), c)
            cin = f * EXPANSION
    dense("head", cin, model["num_classes"])
    return shapes


def bn_names(model: dict) -> list:
    """The batch norms, each with a moving mean and variance."""
    return sorted({k.rsplit(".", 1)[0] for k, v in param_shapes(model).items()
                   if len(v) == 1 and k.endswith(".weight")})


def normalize(images_u8: torch.Tensor, dtype) -> torch.Tensor:
    """uint8 NHWC -> standardized NCHW."""
    x = images_u8.to(dtype).permute(0, 3, 1, 2)
    mean = torch.tensor(MEAN_RGB, dtype=dtype, device=x.device)[None, :, None, None]
    std = torch.tensor(STDDEV_RGB, dtype=dtype, device=x.device)[None, :, None, None]
    return (x - mean) / std


class Net:
    """One forward pass over parameters ``P`` and moving statistics ``M``
    (``{bn name: (mean, var)}``). In training, ``stats`` receives each
    batch norm's batch mean and biased variance, ``drop(x, site)``
    applies DropBlock at a site, and the stem and every block are
    recomputed in the backward, so that the cell's batch fits beside the
    program's peak."""

    def __init__(self, model: dict, P: dict, M: dict, *, train: bool, quant=None, drop=None):
        self.m, self.P, self.M = model, P, M
        self.train, self.quant, self.drop = train, quant, drop
        self.stats = {}

    def q(self, t):
        return t if self.quant is None else self.quant(t)

    def conv(self, x, name, stride=1, dilation=1):
        w = self.P[f"{name}.weight"]
        pad = dilation * (w.shape[-1] - 1) // 2
        return self.q(F.conv2d(self.q(x), self.q(w), stride=stride, padding=pad,
                               dilation=dilation))

    def dense(self, x, name):
        return F.linear(self.q(x), self.q(self.P[f"{name}.weight"]), self.P.get(f"{name}.bias"))

    def bn(self, x, name):
        g, b = self.P[f"{name}.weight"], self.P[f"{name}.bias"]
        dims = (0,) if x.dim() == 2 else (0, 2, 3)
        if self.train:
            mean = x.mean(dims)
            var = torch.clamp_min((x * x).mean(dims) - mean * mean, 0.0)
            self.stats[name] = (mean.detach(), var.detach())
        else:
            mean, var = self.M[name]
        shape = (1, -1) if x.dim() == 2 else (1, -1, 1, 1)
        return self.q((x - mean.view(shape)) * torch.rsqrt(var.view(shape) + EPS)
                      * g.view(shape) + b.view(shape))

    @staticmethod
    def blur(x):
        k = torch.tensor([1.0, 2.0, 1.0], dtype=x.dtype, device=x.device)
        k = (k[:, None] * k[None, :]) / 16.0
        c = x.shape[1]
        return F.conv2d(x, k.expand(c, 1, 3, 3), stride=2, padding=1, groups=c)

    @staticmethod
    def same_pads(size, k, s):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        return total // 2, total - total // 2

    def max_pool(self, x):
        ph, pw = self.same_pads(x.shape[2], 3, 2), self.same_pads(x.shape[3], 3, 2)
        return F.max_pool2d(F.pad(x, (*pw, *ph), value=float("-inf")), 3, 2)

    def avg_pool(self, x):
        ph, pw = self.same_pads(x.shape[2], 2, 2), self.same_pads(x.shape[3], 2, 2)
        ones = torch.ones((1, 1) + x.shape[2:], dtype=x.dtype, device=x.device)
        num = F.avg_pool2d(F.pad(x, (*pw, *ph)), 2, 2, divisor_override=1)
        den = F.avg_pool2d(F.pad(ones, (*pw, *ph)), 2, 2, divisor_override=1)
        return num / den

    def stem(self, x):
        if self.m["use_resnet_d"]:
            for i in range(3):
                x = torch.relu(self.bn(self.conv(x, f"stem.conv{i}", 2 if i == 0 else 1),
                                       f"stem.bn{i}"))
        else:
            x = torch.relu(self.bn(self.conv(x, "stem.conv0", 2), "stem.bn0"))
        return self.max_pool(x)

    def sk(self, x, p, stride):
        branches = [torch.relu(self.bn(self.conv(x, f"{p}.sk.conv{b}", stride, b + 1),
                                       f"{p}.sk.bn{b}")) for b in range(2)]
        u = branches[0] + branches[1]
        z = torch.relu(self.bn(self.dense(u.mean((2, 3)), f"{p}.sk.fc_z"), f"{p}.sk.bn_z"))
        a = torch.softmax(self.dense(z, f"{p}.sk.fc_select").view(-1, 2, u.shape[1]), dim=1)
        return branches[0] * a[:, 0, :, None, None] + branches[1] * a[:, 1, :, None, None]

    def block(self, x, p, stride, proj):
        m = self.m
        blur = m["anti_alias_type"] == "sconv" and stride > 1
        short = x
        if proj:
            if stride > 1 and m["use_resnet_d"]:
                short = self.conv(self.avg_pool(x), f"{p}.proj_conv")
            else:
                short = self.conv(x, f"{p}.proj_conv", stride)
            short = self.bn(short, f"{p}.proj_bn")
        h = torch.relu(self.bn(self.conv(x, f"{p}.conv1"), f"{p}.bn1"))
        mid = 1 if blur else stride
        if m["use_sk_block"]:
            h = self.sk(h, p, mid)
        else:
            h = torch.relu(self.bn(self.conv(h, f"{p}.conv2", mid), f"{p}.bn2"))
        if blur:
            h = self.blur(h)
        h = self.bn(self.conv(h, f"{p}.conv3"), f"{p}.bn3")
        if m["use_se_block"]:
            z = torch.relu(self.dense(h.mean((2, 3)), f"{p}.se.fc1"))
            h = h * torch.sigmoid(self.dense(z, f"{p}.se.fc2"))[:, :, None, None]
        return self.q(torch.relu(h + short))

    def region(self, fn, x, *args):
        if self.train:
            return checkpoint(fn, x, *args, use_reentrant=False)
        return fn(x, *args)

    def __call__(self, x):
        """Standardized NCHW images -> logits."""
        m = self.m
        x = self.region(self.stem, x)
        for s, n in enumerate(BLOCKS[m["resnet_size"]]):
            for b in range(n):
                stride = 2 if (s > 0 and b == 0) else 1
                x = self.region(self.block, x, f"stage{s + 1}.block{b}", stride, b == 0)
                if self.drop is not None and s + 1 in m["dropblock_stages"]:
                    x = self.drop(x, f"dropblock/stage{s + 1}/block{b}")
        return self.dense(x.mean((2, 3)), "head")
