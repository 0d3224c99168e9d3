"""Named per-site random streams (port of ``axcnn/core/rng.py``).

As in the reference, every stochastic op (DropBlock, mixup) draws from a
stream derived from one root seed, then the step, then a stable blake2s hash
of the site's name (``"dropblock/stage3/block0"``, ``"mixup"``), so streams
do not depend on the order of the sites and adding a site shuffles no other.
Keys are plain integers, folded with numpy's ``SeedSequence``, and every
draw happens on the host from an explicit ``numpy.random.Generator``: the
same key gives the same numbers on any device. The numbers differ from
``jax.random``'s.
"""

from __future__ import annotations

import hashlib

import numpy as np


def _stable_hash(name: str) -> int:
    return int.from_bytes(hashlib.blake2s(name.encode()).digest()[:4], "little")


def _fold(key: int, data: int) -> int:
    return int(np.random.SeedSequence([key, data]).generate_state(1, np.uint64)[0])


class RngStream:
    """Derives named, independent integer keys from one root seed.

    >>> rng = RngStream(42).fold_step(7)
    >>> lam = rng.numpy("mixup").beta(0.2, 0.2)
    """

    def __init__(self, seed: int):
        if seed < 0:
            raise ValueError(f"seed must be >= 0, got {seed}")
        self.key = int(seed)

    def __call__(self, name: str) -> int:
        return _fold(self.key, _stable_hash(name))

    def numpy(self, name: str) -> np.random.Generator:
        return np.random.default_rng(self(name))

    def fold_step(self, step: int) -> "RngStream":
        """A stream unique to a training step."""
        return RngStream(_fold(self.key, int(step)))
