"""The benchmark's inputs, made on the device from ``--seed``.

Parameters: one standard normal draw for all of them, from a generator on
the device, cut into the leaves in the order of their sorted names and
scaled per leaf: conv kernels (4-D) He-normal, ``sqrt(2 / fan_in)``; dense
kernels (2-D) ``sqrt(1 / fan_in)``; batch-norm scales (1-D ``weight``)
``1 + 0.1 n``, but ``0.2 + 0.05 n`` for the last batch norm of each
residual branch (``bn3``); biases and shifts (1-D ``bias``) ``0.1 n``.
The small last scale starts each block near the identity, as zero-gamma
initialisation does, so that the forward is not chaotic and rounding is
not amplified with depth; it is not zero, so that every branch carries
signal into the loss and its gradients, and a branch's layers are not
hidden from the comparison. Moving statistics start at mean 0, variance 1.

Images are uint8 NHWC: a smooth random field (an 8 x 8 normal draw per
channel, bilinearly enlarged) under a per-image contrast and per-channel
brightness, plus pixel noise, so that images differ at every scale as
photographs do. Pixels drawn independently would average out under the
pools, every image would pool to nearly the same vector, and SK's batch
norm over those vectors would divide by rounding noise. Labels are
uniform over the classes. Each purpose has a stream of its own, folded
from the seed, so the same seed gives the same inputs on every rank and on
every run.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

PURPOSES = ("weights", "images", "labels", "arrivals", "requests")


def stream_seed(seed: int, purpose: str) -> int:
    """A 63-bit generator seed for ``purpose``, folded from ``seed`` (any
    whole number >= 0)."""
    state = np.random.SeedSequence([int(seed), PURPOSES.index(purpose)]).generate_state(2)
    return int((int(state[0]) << 32 | int(state[1])) & (2 ** 63 - 1))


def generator(seed: int, purpose: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, purpose))
    return g


def leaf_affine(name: str, shape) -> tuple[float, float]:
    """(mean, std) of a parameter leaf's entries."""
    if len(shape) >= 2:
        fan_in = int(np.prod(shape[1:]))
        return 0.0, float((2.0 if len(shape) == 4 else 1.0) / fan_in) ** 0.5
    if name.endswith("bn3.weight"):
        return 0.2, 0.05
    return (1.0, 0.1) if name.endswith(".weight") else (0.0, 0.1)


def make_params(shapes: dict, seed: int, device, dtype=torch.float32) -> dict:
    """{name: tensor} for ``shapes`` ({name: shape}), from ``seed``."""
    names = sorted(shapes)
    sizes = [int(np.prod(shapes[k])) for k in names]
    flat = torch.randn(sum(sizes), generator=generator(seed, "weights", device), device=device,
                       dtype=torch.float32)
    leaves = list(torch.split(flat, sizes))
    affine = [leaf_affine(k, shapes[k]) for k in names]
    torch._foreach_mul_(leaves, [s for _, s in affine])
    torch._foreach_add_(leaves, [m for m, _ in affine])
    return {k: t.view(shapes[k]).to(dtype) for k, t in zip(names, leaves)}


def make_images(n: int, size: int, seed: int, device, chunk: int = 256) -> torch.Tensor:
    g = generator(seed, "images", device)
    out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        low = torch.randn((m, 3, 8, 8), generator=g, device=device)
        field = F.interpolate(low, size=(size, size), mode="bilinear", align_corners=False)
        contrast = 30.0 + 40.0 * torch.rand((m, 1, 1, 1), generator=g, device=device)
        bright = 128.0 + 40.0 * torch.randn((m, 3, 1, 1), generator=g, device=device)
        noise = 16.0 * torch.randn((m, 3, size, size), generator=g, device=device)
        img = (field * contrast + bright + noise).clamp_(0, 255).round_()
        out[i:i + m] = img.to(torch.uint8).permute(0, 2, 3, 1)
    return out


def make_labels(n: int, classes: int, seed: int, device) -> torch.Tensor:
    return torch.randint(0, classes, (n,), generator=generator(seed, "labels", device),
                         device=device, dtype=torch.int64)
