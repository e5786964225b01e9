"""Tensors of module-level numpy tables, made once per device."""

from __future__ import annotations

import numpy as np
import torch

_CACHE: dict = {}


def on_device(arr: np.ndarray, device) -> torch.Tensor:
    """``arr`` as a tensor on ``device``, cached.

    Only for module-level constant arrays: the cache keeps ``arr`` alive,
    so its id stays unique.
    """
    device = torch.device(device)
    key = (id(arr), device)
    hit = _CACHE.get(key)
    if hit is None:
        hit = (arr, torch.as_tensor(np.ascontiguousarray(arr)).to(device))
        _CACHE[key] = hit
    return hit[1]
