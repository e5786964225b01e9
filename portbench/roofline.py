"""The yardstick of the kernels' roofline shares: the card's peaks, and the
work the receive path's two kernels must do for a call's shapes.

A bound is the larger of the bytes (every input read once, every output
written once) over the peak memory rate and the float32 operations over
the peak float32 rate; a kernel's share is its bound over its measured
device time.  The work is computed from the shapes alone, so a share
reads the same work whatever implements it.
"""

from __future__ import annotations

# published peaks, dense, at the card's full power limit: (bytes/s, f32 ops/s)
PEAKS = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 67e12),
}

FRAME_SYMBOLS = 192
SAMPLES_PER_STEP = 5            # the front end decimates 48 kHz by 5
# the four typed decodes of every frame slot: trellis steps each
TRELLIS_STEPS = {"lsf": 244, "stream": 148, "packet": 210, "bert": 205}
K1_OPS_PER_STEP = 68            # 16 states x (2 adds, compare, select) + 4 branch adds
K2_OPS_PER_CLK = 122            # 2 filters x (31 products + 30 sums) at a clk step
# the scan's carry a channel, read and written once a call: the 31-sample
# window (f32), six int32 and three f32 scalars, four flags, 8 sync symbols
K2_STATE_BYTES = 31 * 4 + 6 * 4 + 3 * 4 + 4 + 8 * 4


def steps(call_samples: int) -> int:
    """Scan steps (2 samples a symbol) of a call of this many input samples."""
    return call_samples // SAMPLES_PER_STEP


def frame_slots(call_samples: int) -> int:
    """Frame slots a call decodes: a call of S2 steps carries ~S2/2 symbols."""
    return steps(call_samples) // (2 * FRAME_SYMBOLS) + 2


def k1_work(channels: int, call_samples: int) -> tuple[float, float]:
    """(bytes, ops) of one call's four typed Viterbi decodes (K1)."""
    n = channels * frame_slots(call_samples)
    nbytes = ops = 0.0
    for t in TRELLIS_STEPS.values():
        nbytes += n * 2 * t * 4 + n * t + n * 4     # soft in, bits and metric out
        ops += K1_OPS_PER_STEP * n * t
    return nbytes, ops


def k2_work(channels: int, call_samples: int) -> tuple[float, float]:
    """(bytes, ops) of one call's timing and framer scan (K2)."""
    s2 = steps(call_samples)
    nbytes = channels * s2 * 4 * 3 + 2 * channels * K2_STATE_BYTES   # samples, slots, flags
    return float(nbytes), float(K2_OPS_PER_CLK * channels * s2 / 2)


def bound_s(work: tuple[float, float], card: str):
    """Least seconds for (bytes, ops) on this card, or None if its peaks are
    not in the table."""
    pk = PEAKS.get(card)
    if pk is None:
        return None
    return max(work[0] / pk[0], work[1] / pk[1])
