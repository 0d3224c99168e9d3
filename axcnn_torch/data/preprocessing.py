"""Device-side normalize (port of ``axcnn/data/preprocessing.py:123-129``).

Host-side decode and crop are the reference's own jax-free functions
(``axcnn.data.preprocessing.preprocess_eval`` and friends), used as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from axcnn.data.preprocessing import MEAN_RGB, STDDEV_RGB


def normalize_device(images_u8: torch.Tensor, mean=None, std=None) -> torch.Tensor:
    """uint8 NHWC -> standardized fp32 NHWC, on the tensor's device."""
    kw = dict(dtype=torch.float32, device=images_u8.device)
    mean = torch.as_tensor(MEAN_RGB if mean is None else np.asarray(mean, np.float32), **kw)
    std = torch.as_tensor(STDDEV_RGB if std is None else np.asarray(std, np.float32), **kw)
    return (images_u8.float() - mean) / std
