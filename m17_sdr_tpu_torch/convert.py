"""Session state across the two packages.

The system has no weights: what carries over is the per-channel session
state.  The flat keys are those ``m17_sdr_tpu.app.checkpoint.save_state``
writes for an ``RxSessionState`` ("frontend/disc_tail",
"receiver/index", ..., "last_fn"), so a JAX checkpoint loads into the
port.  ``last_fn`` is uint32 in the JAX package and int64 here.  A TX
modulator's ``ModState`` ("filter_tail" [B, 30] and "phase" [B], both
float32 in both packages) carries over the same way, so a transmission
started in one package goes on in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .dsp.discriminator import RxFrontEndState
from .dsp.equalize import EqState
from .dsp.modulate import ModState
from .frame.receiver import ReceiverState
from .pipeline.rx import RxSessionState

_GROUPS = {"frontend": RxFrontEndState, "receiver": ReceiverState, "eq": EqState}


def _keys() -> list[str]:
    keys = []
    for name in RxSessionState._fields:
        group = _GROUPS.get(name)
        if group is None:
            keys.append(name)
        else:
            keys.extend(f"{name}/{field}" for field in group._fields)
    return keys


def state_to_numpy(state: RxSessionState) -> dict[str, np.ndarray]:
    """Flatten a port state to {checkpoint key: numpy array}, dtypes as in
    the JAX package."""
    flat = {}
    for key in _keys():
        parts = key.split("/")
        x = getattr(state, parts[0])
        if len(parts) == 2:
            x = getattr(x, parts[1])
        arr = x.detach().cpu().numpy()
        flat[key] = arr.astype(np.uint32) if key == "last_fn" else arr
    return flat


def state_from_numpy(flat: dict[str, np.ndarray], device) -> RxSessionState:
    """Build a port state on ``device`` from {checkpoint key: array}.

    Accepts the contents of a JAX ``save_state`` file of an
    ``RxSessionState`` (its format tag and ``extra/`` entries are
    ignored).  Raises on missing or surplus keys.
    """
    stored = {k: v for k, v in flat.items()
              if k != "__format__" and not k.startswith("extra/")}
    keys = _keys()
    missing = set(keys) - set(stored)
    surplus = set(stored) - set(keys)
    if missing or surplus:
        raise ValueError(f"state field mismatch: missing={sorted(missing)} "
                         f"surplus={sorted(surplus)}")

    def tensor(key):
        arr = np.asarray(stored[key])
        if key == "last_fn":
            arr = arr.astype(np.int64)
        return torch.as_tensor(arr).to(device)

    fields = {}
    for name in RxSessionState._fields:
        group = _GROUPS.get(name)
        if group is None:
            fields[name] = tensor(name)
        else:
            fields[name] = group(**{f: tensor(f"{name}/{f}") for f in group._fields})
    return RxSessionState(**fields)


def mod_state_to_numpy(state: ModState) -> dict[str, np.ndarray]:
    """A port ModState -> {"filter_tail": [B, 30] f32, "phase": [B] f32}."""
    return {f: getattr(state, f).detach().cpu().numpy() for f in ModState._fields}


def mod_state_from_numpy(flat: dict[str, np.ndarray], device) -> ModState:
    """{"filter_tail", "phase"} arrays (a JAX ModState's fields) -> a port
    ModState on ``device``."""
    if set(flat) != set(ModState._fields):
        raise ValueError(f"ModState fields {sorted(flat)} != {sorted(ModState._fields)}")
    return ModState(**{f: torch.as_tensor(np.array(flat[f], dtype=np.float32)).to(device)
                       for f in ModState._fields})
