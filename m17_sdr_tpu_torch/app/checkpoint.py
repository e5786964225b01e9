"""Checkpoint and resume of a streaming session's modem state.

Port of ``m17_sdr_tpu.app.checkpoint``, in its file format: an npz whose
keys are the state's field names joined with "/" ("rx/receiver/index",
..., "dec_tail"), plus the format tag, so that a checkpoint written by
either package resumes in the other.  A session split at any block
boundary and resumed from the file is bit-identical to the unbroken run.
"""

from __future__ import annotations

import numpy as np

from .. import convert

FORMAT = "m17-sdr-tpu-ckpt-v1"


def save_state(path: str, tree, extra: dict | None = None) -> None:
    """Persist a NamedTuple tree of tensors (a ``StreamChunkState``, an
    ``RxSessionState``, a TX ``ModState``) to an npz file."""
    data = convert.tree_to_numpy(tree)
    data["__format__"] = np.asarray(FORMAT)
    for k, v in (extra or {}).items():
        data[f"extra/{k}"] = np.asarray(v)
    np.savez(path, **data)


def load_state(path: str, template):
    """Restore a tree saved by ``save_state`` into ``template``'s structure,
    dtypes and devices (e.g. ``RxSessionState.init(batch, device)``).
    Returns (tree, extra)."""
    with np.load(path, allow_pickle=False) as z:
        if str(z["__format__"]) != FORMAT:
            raise ValueError(f"unknown checkpoint format in {path}")
        stored = {k: z[k] for k in z.files
                  if k != "__format__" and not k.startswith("extra/")}
        extra = {k[6:]: z[k] for k in z.files if k.startswith("extra/")}
    return convert.tree_from_numpy(template, stored), extra
