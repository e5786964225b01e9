"""The comparison that decides ``correct``: the program's outputs and
carried state against the reference's, on the same sampled channels.

Two numbers, each with its limit (``portbench/limits/<cell>.json``):

``decoded_mismatches``  channel-blocks (and channels' carried state) in
    which a decoded answer differs: lock, AOS/LOS, which slots hold a
    frame of which type, the voice gate, the LICH state, the Golay count,
    and the bytes of every decoded frame (stream FN and payload, LSF,
    packet, BERT bits).  Timing-slip counts and the scan's carry are
    compared where both sides are locked (a hunting channel's timing walk
    is not an answer).  Exact: the limit is 0.
``soft_rms``  for each float output (signal level, DC offset, the decode
    metric and voice quality of every decoded frame) and each float carry
    (front end, the automatic equalizer's eye estimate and taps, the
    scan's history): the root mean square of the gaps between the two
    sides, as a share of that quantity's largest magnitude in the
    reference; the largest over the quantities.  A root mean square and
    not the widest gap: the matched filter takes bfloat16 operands on both
    sides, and where one soft sample lies on a bfloat16 rounding edge the
    two sides' float32 sums round it to neighbouring values, so that one
    symbol of one channel differs by one bfloat16 step, as large a gap as
    a lower precision gives everywhere.  Such a tie moves one element;
    a lower precision moves them all.

``soft_gap``, the widest gap, and the quantities of both are reported
beside them, with no limit.

Both sides are flat dicts of numpy arrays, outputs ``[S, NB, ...]`` (S
sampled channels, NB blocks or calls) and state ``[S, ...]``.
"""

from __future__ import annotations

import numpy as np

# decoded answers of each channel-block, compared everywhere
EXACT = ("locked", "aos", "los", "golay_errors_blk", "stream_valid", "lsf_valid",
         "packet_valid", "bert_valid", "stream_gate", "stream_lich_ok")
# decoded answers compared where the reference holds such a frame
EXACT_WHERE = {"stream_fn": "stream_valid", "stream_payload": "stream_valid",
               "stream_fn_ok": "stream_valid", "lsf_bytes": "lsf_valid",
               "packet_data": "packet_valid", "packet_eof": "packet_valid",
               "packet_fn": "packet_valid", "bert_bits": "bert_valid",
               "frame_slipped": "any_valid"}
# float outputs and where they are compared
SOFT = {"rssi": None, "dc_offset": None, "viterbi_metric": "any_valid",
        "stream_quality": "stream_valid"}
# carried state: session-layer answers (exact, every channel), and the
# scan's carry (where both sides end locked)
STATE_EXACT = ("lich_asm", "lich_good", "lich_good_valid", "golay_errors", "n_frames",
               "last_fn", "eq_armed", "receiver/flock", "frontend/dc_seeded")
STATE_SOFT_ALWAYS = ("frontend/", "eq/", "receiver/window")
# the gap of a value that is not finite, or of one where the reference is 0
# (a finite number, so that the result's line stays JSON)
UNBOUNDED = 1e30


def leaves(tree, prefix: str = "") -> dict:
    """A NamedTuple tree -> {"a/b": leaf}, the leaves as they are."""
    out = {}
    for name, x in zip(tree._fields, tree):
        key = f"{prefix}{name}"
        if isinstance(x, tuple):
            out.update(leaves(x, key + "/"))
        else:
            out[key] = x
    return out


def flatten(tree) -> dict:
    """A NamedTuple tree of arrays or tensors -> {"a/b": numpy array}."""
    return {k: x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
            for k, x in leaves(tree).items()}


def _expand(mask: np.ndarray, like: np.ndarray) -> np.ndarray:
    return mask.reshape(mask.shape + (1,) * (like.ndim - mask.ndim))


def _masks(ref: dict) -> dict:
    any_valid = ref["stream_valid"] | ref["lsf_valid"] | ref["packet_valid"] | ref["bert_valid"]
    return {"any_valid": any_valid, "stream_valid": ref["stream_valid"],
            "lsf_valid": ref["lsf_valid"], "packet_valid": ref["packet_valid"],
            "bert_valid": ref["bert_valid"]}


def _rel_gap(p: np.ndarray, r: np.ndarray, mask) -> tuple[float, float]:
    """(widest gap, root mean square of the gaps), each as a share of the
    reference's largest magnitude."""
    p = p.astype(np.float64)
    r = r.astype(np.float64)
    if mask is not None:
        m = np.broadcast_to(_expand(mask, r), r.shape)
        p, r = p[m], r[m]
    if r.size == 0:
        return 0.0, 0.0
    d = np.abs(p - r)
    if not np.all(np.isfinite(d)):
        return UNBOUNDED, UNBOUNDED
    scale = float(np.abs(r).max())
    if scale == 0:
        return (0.0, 0.0) if d.max() == 0 else (UNBOUNDED, UNBOUNDED)
    return float(d.max()) / scale, float(np.sqrt(np.mean(d * d))) / scale


def _differs(p: np.ndarray, r: np.ndarray, units: int) -> np.ndarray:
    """[S, NB] (units=2) or [S] (units=1): does any element differ there."""
    d = p != r
    return d.reshape(d.shape[:units] + (-1,)).any(axis=-1) if d.ndim > units else d


def compare(prog_out: dict, ref_out: dict, prog_state: dict, ref_state: dict) -> dict:
    """{"decoded_mismatches": n, "soft_rms": q, "soft_gap": g, "rms_in": quantity
    of q, "widest": quantity of g, "frames": decoded frames compared}."""
    masks = _masks(ref_out)
    bad = np.zeros(ref_out["locked"].shape, dtype=bool)                  # [S, NB]
    for f in EXACT:
        bad |= _differs(prog_out[f], ref_out[f], 2)
    for f, m in EXACT_WHERE.items():
        d = (prog_out[f] != ref_out[f]) & np.broadcast_to(_expand(masks[m], ref_out[f]),
                                                          ref_out[f].shape)
        bad |= d.reshape(d.shape[:2] + (-1,)).any(axis=-1)
    both_locked = prog_out["locked"] & ref_out["locked"]
    bad |= (prog_out["n_slips"] != ref_out["n_slips"]) & both_locked
    gaps = {f: _rel_gap(prog_out[f], ref_out[f], masks[m] if m else None)
            for f, m in SOFT.items()}

    bad_state = np.zeros(ref_state["receiver/flock"].shape, dtype=bool)   # [S]
    locked_end = prog_state["receiver/flock"] & ref_state["receiver/flock"]
    for key, r in ref_state.items():
        p = prog_state[key]
        if key in STATE_EXACT:
            bad_state |= _differs(p, r, 1)
        elif key.startswith(STATE_SOFT_ALWAYS):
            gaps[key] = _rel_gap(p, r, None)
        elif r.dtype.kind == "f":
            gaps[key] = _rel_gap(p, r, locked_end)
        else:
            bad_state |= _differs(p, r, 1) & locked_end
    widest = max(gaps, key=lambda k: gaps[k][0])
    rms_in = max(gaps, key=lambda k: gaps[k][1])
    return {"decoded_mismatches": int(bad.sum()) + int(bad_state.sum()),
            "soft_rms": gaps[rms_in][1], "rms_in": rms_in,
            "soft_gap": gaps[widest][0], "widest": widest,
            "frames": int(masks["any_valid"].sum())}


def merge(results: list[dict]) -> dict:
    """Several comparisons of one run -> one: mismatches and frames add up,
    the soft numbers are the largest."""
    widest = max(results, key=lambda r: r["soft_gap"])
    rms = max(results, key=lambda r: r["soft_rms"])
    return {"decoded_mismatches": sum(r["decoded_mismatches"] for r in results),
            "soft_rms": rms["soft_rms"], "rms_in": rms["rms_in"],
            "soft_gap": widest["soft_gap"], "widest": widest["widest"],
            "frames": sum(r["frames"] for r in results)}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for the numbers that have limits."""
    check = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(v["value"] <= v["limit"] for v in check.values()), check
