"""Plain PyTorch training step and served forward, the yardstick of
``correct``.

The step is the recipe's: standardize, mixup (one Beta lambda a step, each
image paired with the reversed batch of its shard), the forward in training
mode (batch statistics over the whole global batch; DropBlock at the
schedule's keep probability, one mask a sample from its seed, rescaled by
its shard's kept share), label-smoothed cross-entropy weighted by lambda,
the mean over the global batch, the backward, momentum SGD with weight
decay on conv and dense kernels, the moving statistics at momentum 0.997,
and the EMA of the parameters with TF's ramp ``min(decay, (1 + t) / (10 +
t))``. A global batch of ``shards`` data-parallel shards is one step over
all of it: the ranks of a data-parallel step must each end there.

Every draw comes from ``draws`` (the root seed, the step and the site's
name), and the parameters and moving statistics from the caller: nothing
comes from the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import draws
from benchmark.reference.model import Net, bn_names, normalize, param_shapes

BN_MOMENTUM = 0.997


def _e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude to 448)."""
    scale = torch.clamp_min(t.abs().amax(), 1e-12) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, fn):
        ctx.fn = fn
        return fn(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """The lower-precision control: a tensor rounded to float8 e4m3 where
    it passes between operations, and its gradient rounded alike on the
    way back."""
    return _Rounded.apply(t, _e4m3)


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """The configuration's own precision, as a witness: a tensor rounded to
    bfloat16 where it passes between operations, its gradient alike."""
    return _Rounded.apply(t, _bf16)


def recipe_lr(recipe: dict, step: int) -> float:
    """The recipe's learning rate at ``step``: the base rate per 256 images
    scaled to the global batch, a linear warmup over its first epochs, then
    a cosine decay to 0, in fp32."""
    f = np.float32
    per_epoch = recipe["train_examples"] // recipe["global_batch"]
    total = per_epoch * recipe["train_epochs"]
    warm = int(recipe["lr_warmup_epochs"] * per_epoch)
    peak = f(recipe["base_lr"] * recipe["global_batch"] / 256.0)
    if step < warm:
        return float(peak * f(step) / f(warm))
    if recipe["lr_decay_type"] != "cosine":
        raise NotImplementedError(recipe["lr_decay_type"])
    progress = min(f(step - warm) / f(max(total - warm, 1)), f(1.0))
    return float(peak * f(0.5) * (f(1.0) + np.cos(f(np.pi) * progress)))


def smoothed_ce(logits, labels, smoothing: float):
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    return (1.0 - smoothing) * nll - smoothing * logp.mean(dim=1)


class Step:
    """The recipe's step over ``P`` (parameters, updated in place), ``M``
    (moving statistics), ``V`` (momentum) and ``E`` (EMA, or None)."""

    def __init__(self, model: dict, recipe: dict, *, shards: int = 1, quant=None):
        self.model, self.recipe, self.shards = model, recipe, shards
        self.quant = quant

    def dropblock(self, x, site, seeds, kp):
        n, c, h, w = x.shape
        bs = min(self.model["dropblock_block_size"], h, w)
        rate = draws.drop_rate(kp, bs, h, w)
        mask = draws.keep_mask(seeds[site], rate, h, w, bs, x.device)
        per = n // self.shards
        counts = mask.sum((1, 2)).view(self.shards, per).sum(1)  # each shard's kept pixels
        scale = (per * c * h * w) / (torch.clamp_min(counts, 1.0) * c)
        return x * mask[:, None] * scale.repeat_interleave(per)[:, None, None, None]

    def loss(self, P, M, images_u8, labels, root_seed: int, step: int, progress: float):
        """(loss, the batch statistics by batch norm)."""
        r = self.recipe
        n = labels.shape[0]
        per = n // self.shards
        g = draws.Stream(root_seed).fold_step(step)
        x = normalize(images_u8, P["head.weight"].dtype)
        lam = None
        if r["mixup_alpha"] > 0:
            lam = float(draws.mixup_lambda(g, r["mixup_alpha"]))
            flipped = x.view(self.shards, per, *x.shape[1:]).flip(1).reshape(x.shape)
            x = x * lam + flipped * (1.0 - lam)
            labels_b = labels.view(self.shards, per).flip(1).reshape(-1)
        drop = None
        if self.model["use_dropblock"]:
            kp = draws.keep_prob(progress, self.model["dropblock_keep_prob"])
            streams = [g if self.shards == 1 else g.fold_shard(k) for k in range(self.shards)]
            seeds = {}

            def drop(t, site):
                if site not in seeds:
                    seeds[site] = np.concatenate([draws.site_seeds(st, site, per)
                                                  for st in streams])
                return self.dropblock(t, site, seeds, kp)
        net = Net(self.model, P, M, train=True, quant=self.quant, drop=drop)
        logits = net(x)
        ce = smoothed_ce(logits, labels, r["label_smoothing"])
        if lam is not None:
            ce = lam * ce + (1.0 - lam) * smoothed_ce(logits, labels_b, r["label_smoothing"])
        return ce.mean(), net.stats

    def __call__(self, P, M, V, E, images_u8, labels, root_seed: int, step: int, *,
                 lr: float, progress: float):
        """One step; returns (loss, the gradient with weight decay as the
        optimizer takes it, by name)."""
        r = self.recipe
        for t in P.values():
            t.requires_grad_(True)
            t.grad = None
        loss, stats = self.loss(P, M, images_u8, labels, root_seed, step, progress)
        loss.backward()
        with torch.no_grad():
            grads = {}
            for k, p in P.items():
                g = p.grad
                if p.dim() >= 2:  # conv and dense kernels take weight decay
                    g = g + r["weight_decay"] * p
                grads[k] = g
                V[k].mul_(r["momentum"]).add_(g)
                p.requires_grad_(False)
                p.grad = None
                p.sub_(lr * V[k])
            for name in bn_names(self.model):
                mean, var = stats[name]
                old_mean, old_var = M[name]
                M[name] = (old_mean * BN_MOMENTUM + mean * (1.0 - BN_MOMENTUM),
                           old_var * BN_MOMENTUM + var * (1.0 - BN_MOMENTUM))
            if E is not None:
                t = np.float32(step)
                d = min(np.float32(r["ema_decay"]), (np.float32(1.0) + t) / (np.float32(10.0) + t))
                for k in E:
                    E[k].mul_(float(d)).add_(P[k], alpha=float(np.float32(1.0) - d))
        return float(loss.detach()), grads


def serve_logits(model: dict, P: dict, M: dict, images_u8, *, block: int = 128, quant=None):
    """Evaluation-mode logits of ``images_u8``, ``block`` images at a time."""
    dtype = P["head.weight"].dtype
    out = []
    with torch.no_grad():
        for i in range(0, images_u8.shape[0], block):
            net = Net(model, P, M, train=False, quant=quant)
            out.append(net(normalize(images_u8[i:i + block], dtype)))
    return torch.cat(out)


def moving_init(model: dict, device, dtype=torch.float32) -> dict:
    """Moving statistics as a fresh model holds them: mean 0, variance 1."""
    shapes = param_shapes(model)
    out = {}
    for name in bn_names(model):
        c = shapes[f"{name}.weight"][0]
        out[name] = (torch.zeros(c, dtype=dtype, device=device),
                     torch.ones(c, dtype=dtype, device=device))
    return out

