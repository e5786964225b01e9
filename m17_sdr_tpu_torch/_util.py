"""Device copies of module-level numpy tables, made once per device."""

from __future__ import annotations

import numpy as np
import torch

_CACHE: dict = {}


def on_device(arr: np.ndarray, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``arr`` as a tensor on ``device``, cached.

    Only for module-level constant arrays: the cache keeps ``arr`` alive,
    so its id stays unique.  Caching matters on CUDA, where a fresh copy
    of a host array would wait for the device on every call.
    """
    device = torch.device(device)
    key = (id(arr), device, dtype)
    hit = _CACHE.get(key)
    if hit is None:
        hit = (arr, torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype).to(device))
        _CACHE[key] = hit
    return hit[1]
