"""Batch-level mixup (port of ``axcnn/data/mixup.py``).

One lambda per batch, ``lam ~ Beta(alpha, alpha)``, drawn on the host from
an explicit numpy generator (``torch.distributions.Beta`` takes no
generator); each image is paired with the reversed batch. The labels stay
hard: the loss takes ``(labels, reversed labels, lam)``.
"""

from __future__ import annotations

import numpy as np


def draw_lambda(rng: np.random.Generator, alpha: float, *,
                symmetric: bool = False) -> np.float32:
    """``symmetric=True`` takes ``max(lam, 1 - lam)``, a deliberate deviation
    from the reference recipe, off by default as in the reference."""
    lam = np.float32(rng.beta(alpha, alpha))
    return max(lam, np.float32(1.0) - lam) if symmetric else lam


def mixup_batch(images, labels, lam):
    """Returns ``(mixed_images, labels_a, labels_b)`` for a host ``lam``
    (``np.float32`` as drawn; ``1 - lam`` is taken in its precision):
    ``images * lam + images[::-1] * (1 - lam)`` in the images' dtype."""
    lam = np.asarray(lam)
    mixed = images * float(lam) + images.flip(0) * float(1.0 - lam)
    return mixed.to(images.dtype), labels, labels.flip(0)
