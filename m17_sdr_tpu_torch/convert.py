"""Session state across the two packages.

The system has no weights: what carries over is the per-channel session
state.  The flat keys are those ``m17_sdr_tpu.app.checkpoint.save_state``
writes for an ``RxSessionState`` ("frontend/disc_tail",
"receiver/index", ..., "last_fn"), so a JAX checkpoint loads into the
port, and a port state saves in the JAX package's format.  ``last_fn``
is uint32 in the JAX package and int64 here.  ``tree_to_numpy`` and
``tree_from_numpy`` do this for any NamedTuple tree: a streaming
session's ``StreamChunkState`` flattens to "rx/..." keys and
"dec_tail", the decimator's history, as a JAX ``StreamingRx``
checkpoint does.  The flat float32 states -- a TX modulator's ``ModState`` ("filter_tail"
[B, 30], "phase" [B]), the training equalizer's ``EqState`` and the PLL's
``PllState`` -- carry over by their field names (``fields_to_numpy``,
``fields_from_numpy``), so a transmission or an adaptation started in one
package goes on in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .pipeline.rx import RxSessionState

# the one leaf whose dtype differs: uint32 in the JAX package, int64 here
_UINT32_LEAVES = ("last_fn",)


def tree_to_numpy(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Flatten a NamedTuple tree of tensors (or of host arrays) to
    {key: numpy array}.

    Keys are the field names joined with "/", as the JAX package's
    checkpoints name the leaves of its pytrees; dtypes are the JAX
    package's.
    """
    flat = {}
    for name, x in tree._asdict().items():
        key = prefix + name
        if isinstance(x, tuple):
            flat.update(tree_to_numpy(x, key + "/"))
        else:
            arr = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            flat[key] = arr.astype(np.uint32) if name in _UINT32_LEAVES else arr
    return flat


def tree_from_numpy(template, flat: dict[str, np.ndarray]):
    """The tree of ``template``'s structure holding ``flat``'s arrays, each
    leaf with the template leaf's dtype and device.  Raises ValueError on
    missing or surplus keys and on a shape that differs."""
    keys = _leaf_keys(template)
    missing = set(keys) - set(flat)
    surplus = set(flat) - set(keys)
    if missing or surplus:
        raise ValueError(f"checkpoint field mismatch: missing={sorted(missing)} "
                         f"surplus={sorted(surplus)}")
    return _fill(template, flat, "")


def _leaf_keys(tree, prefix: str = "") -> list[str]:
    keys = []
    for name, x in tree._asdict().items():
        if isinstance(x, tuple):
            keys += _leaf_keys(x, prefix + name + "/")
        else:
            keys.append(prefix + name)
    return keys


def _fill(template, flat, prefix):
    fields = {}
    for name, leaf in template._asdict().items():
        key = prefix + name
        if isinstance(leaf, tuple):
            fields[name] = _fill(leaf, flat, key + "/")
            continue
        arr = np.asarray(flat[key])
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"checkpoint shape mismatch at {key}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        if leaf.dtype == torch.int64:
            arr = arr.astype(np.int64)
        fields[name] = torch.as_tensor(arr).to(device=leaf.device, dtype=leaf.dtype)
    return type(template)(**fields)


def _stored(flat: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """A JAX save_state file's leaves: without its format tag and extras."""
    return {k: v for k, v in flat.items()
            if k != "__format__" and not k.startswith("extra/")}


def state_to_numpy(state: RxSessionState) -> dict[str, np.ndarray]:
    """Flatten a port state to {checkpoint key: numpy array}, dtypes as in
    the JAX package."""
    return tree_to_numpy(state)


def state_from_numpy(flat: dict[str, np.ndarray], device) -> RxSessionState:
    """Build a port state on ``device`` from {checkpoint key: array}.

    Accepts the contents of a JAX ``save_state`` file of an
    ``RxSessionState`` (its format tag and ``extra/`` entries are
    ignored).  Raises on missing or surplus keys.
    """
    stored = _stored(flat)
    batch = len(next(iter(stored.values()))) if stored else 0
    return tree_from_numpy(RxSessionState.init(batch, device), stored)


def fields_to_numpy(state) -> dict[str, np.ndarray]:
    """A port ``ModState``, ``EqState`` or ``PllState`` -> {field: float32
    array}, the JAX state's fields and layout."""
    return {f: getattr(state, f).detach().cpu().numpy() for f in state._fields}


def fields_from_numpy(cls, flat: dict[str, np.ndarray], device):
    """{field: array} (a JAX ``ModState``, ``EqState`` or ``PllState``'s
    fields) -> the port's ``cls`` on ``device``.  Raises ValueError when
    the fields differ."""
    if set(flat) != set(cls._fields):
        raise ValueError(f"{cls.__name__} fields {sorted(flat)} != {sorted(cls._fields)}")
    return cls(**{f: torch.as_tensor(np.array(flat[f], dtype=np.float32)).to(device)
                  for f in cls._fields})
