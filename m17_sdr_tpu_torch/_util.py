"""Device copies of module-level numpy tables, made once per device, the
float32 convolution context, and the device fence of the timing tools."""

from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def no_tf32():
    """cuDNN without TF32 for the block, every other flag as it was: on
    CUDA a float32 ``conv1d`` goes to cuDNN, which rounds its operands to
    TF32 by default, while the JAX reference is float32."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


def fence(device) -> None:
    """Wait for the work queued on ``device``: ``torch.cuda.synchronize``
    on CUDA; CPU work is done when its call returns."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
