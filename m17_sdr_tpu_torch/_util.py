"""Device copies of module-level numpy tables, made once per device, the
float32 convolution context, and the device fence and record of the
timing tools."""

from __future__ import annotations

import contextlib
import subprocess

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


def device_record(device) -> dict:
    """What a timing document names its device by: ``name`` (the card's
    name, or "cpu") and ``name_power_limit``, the card's line of
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    (None on the CPU, or where nvidia-smi cannot be run)."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"name": "cpu", "name_power_limit": None}
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        smi = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        smi = None
    return {"name": torch.cuda.get_device_name(device), "name_power_limit": smi}
