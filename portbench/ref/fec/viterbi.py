"""Batched soft-decision Viterbi decoder for the M17 K=5 code, in numpy.

The plain decoder of the port, step for step (terminated trellis, strict
'>' ties keep the second predecessor, traceback from state 0, terminal
metric ``acm[0]``), written with numpy arrays so that a step costs
microseconds on the host.  Every sum is the same float32 sum in the same
order, so the bits and metrics are those of the plain decoder.

Conventions: soft bits > 0 mean 1, < 0 mean 0, 0.0 is an erasure; output
bit t is the bit that entered the encoder at step t.
"""

from __future__ import annotations

import numpy as np
import torch

from .conv import DIBIT0, DIBIT1, NUM_STATES, PREV0, PREV1

# sign of m1 and m2 in the branch metric toward each next state
_S1_0 = np.where((DIBIT0 >> 1) & 1, 1.0, -1.0).astype(np.float32)
_S2_0 = np.where(DIBIT0 & 1, 1.0, -1.0).astype(np.float32)
_S1_1 = np.where((DIBIT1 >> 1) & 1, 1.0, -1.0).astype(np.float32)
_S2_1 = np.where(DIBIT1 & 1, 1.0, -1.0).astype(np.float32)
# which of the four sums (+m1+m2, +m1-m2, -m1+m2, -m1-m2) each branch takes
_COMBO0 = ((_S1_0 < 0) * 2 + (_S2_0 < 0)).astype(np.int64)
_COMBO1 = ((_S1_1 < 0) * 2 + (_S2_1 < 0)).astype(np.int64)
# the K=5 trellis: next state s comes from states 2(s mod 8) and 2(s mod 8) + 1
assert list(PREV0) == [2 * (s % 8) for s in range(NUM_STATES)]
assert list(PREV1) == [2 * (s % 8) + 1 for s in range(NUM_STATES)]


def viterbi_decode_np(soft: np.ndarray):
    """[N, 2T] float32 soft bits -> (bits [N, T] uint8, metric [N] float32)."""
    n, n2 = soft.shape
    t_steps = n2 // 2
    # time-major pairs [T, N]; the branch metric m1*s1 + m2*s2 with signs
    # s1, s2 = +-1 is one of four sums, each exact as written here
    pairs = np.ascontiguousarray(
        np.asarray(soft, dtype=np.float32).reshape(n, t_steps, 2).transpose(1, 0, 2))
    m1, m2 = pairs[..., 0], pairs[..., 1]
    plus = m1 + m2
    sums = np.stack([plus, m1 - m2, m2 - m1, -plus], axis=-1)     # [T, N, 4]
    # branch metrics toward each next state: [T, N, 2, 8] for next state
    # 8h + j, whose predecessors are states 2j and 2j + 1
    bm0 = sums[..., _COMBO0].reshape(t_steps, n, 2, NUM_STATES // 2)
    bm1 = sums[..., _COMBO1].reshape(t_steps, n, 2, NUM_STATES // 2)
    acm = np.full((n, NUM_STATES), np.float32(-1.0e6), dtype=np.float32)
    acm[:, 0] = 0.0
    decisions = np.empty((t_steps, n, NUM_STATES), dtype=bool)
    for t in range(t_steps):
        pair = acm.reshape(n, NUM_STATES // 2, 2)
        cand0 = pair[:, None, :, 0] + bm0[t]     # from PREV0 = 2j
        cand1 = pair[:, None, :, 1] + bm1[t]     # from PREV1 = 2j + 1
        take0 = cand0 > cand1          # strict: ties keep the second predecessor
        acm = np.where(take0, cand0, cand1).reshape(n, NUM_STATES)
        np.logical_not(take0.reshape(n, NUM_STATES), out=decisions[t])
    rows = np.arange(n)
    state = np.zeros(n, dtype=np.int64)
    bits = np.empty((n, t_steps), dtype=np.uint8)
    for t in range(t_steps - 1, -1, -1):
        bits[:, t] = state >> 3
        d = decisions[t][rows, state]
        state = ((state & 7) << 1) | d
    return bits, acm[:, 0].copy()


def viterbi_decode(soft: torch.Tensor):
    """[..., 2T] float32 soft bits (a CPU tensor) -> (bits [..., T] uint8,
    metric [...] float32) as tensors."""
    *batch, n2 = soft.shape
    bits, metric = viterbi_decode_np(soft.reshape(-1, n2).numpy())
    return (torch.from_numpy(bits).reshape(*batch, n2 // 2),
            torch.from_numpy(metric).reshape(tuple(batch)))
