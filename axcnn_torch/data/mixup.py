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


def mixup_batch(images, labels, lam, partner=None):
    """Returns ``(mixed_images, labels_a, labels_b)`` for a host ``lam``
    (``np.float32`` as drawn; ``1 - lam`` is taken in its precision):
    ``images * lam + images[::-1] * (1 - lam)`` in the images' dtype.
    ``partner``, an ``(images, labels)`` pair, is reversed in the batch's
    place: under spatial partitioning data shard ``d`` of the global batch
    pairs with the reverse of shard ``D - 1 - d``."""
    lam = np.asarray(lam)
    p_images, p_labels = (images, labels) if partner is None else partner
    mixed = images * float(lam) + p_images.flip(0) * float(1.0 - lam)
    return mixed.to(images.dtype), labels, p_labels.flip(0)
