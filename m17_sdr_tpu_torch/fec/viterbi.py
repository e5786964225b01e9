"""Batched soft-decision Viterbi decoder for the M17 K=5 code.

``viterbi_decode_ref`` is the plain PyTorch version: a port of
``m17_sdr_tpu.fec.viterbi.viterbi_decode_xla`` step for step (terminated
trellis, strict '>' ties keep the second predecessor, traceback from
state 0, terminal metric ``acm[0]``).  ``viterbi_decode_cuda`` launches
the hand-written kernel ``csrc/viterbi.cu``.  ``viterbi_decode`` picks
one by device.

Conventions: soft bits > 0 mean 1, < 0 mean 0, 0.0 is an erasure; output
bit t is the bit that entered the encoder at step t.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .._util import on_device
from .conv import DIBIT0, DIBIT1, NUM_STATES, PREV0, PREV1

# sign of m1 and m2 in the branch metric toward each next state
_S1_0 = np.where((DIBIT0 >> 1) & 1, 1.0, -1.0).astype(np.float32)
_S2_0 = np.where(DIBIT0 & 1, 1.0, -1.0).astype(np.float32)
_S1_1 = np.where((DIBIT1 >> 1) & 1, 1.0, -1.0).astype(np.float32)
_S2_1 = np.where(DIBIT1 & 1, 1.0, -1.0).astype(np.float32)


def viterbi_decode(soft: torch.Tensor, use_kernel: bool | None = None):
    """Decode [..., 2T] soft bits -> (bits [..., T] uint8, metric [...] f32).

    CUDA tensors go to the kernel and CPU tensors to the plain version,
    unless ``use_kernel`` says otherwise (see ``_build.use_kernel_for``).
    """
    if _build.use_kernel_for(soft, use_kernel):
        return viterbi_decode_cuda(soft)
    return viterbi_decode_ref(soft)


def viterbi_decode_ref(soft: torch.Tensor):
    """Plain PyTorch decoder, on any device: [..., 2T] -> (bits, metric)."""
    *batch, n2 = soft.shape
    t_steps = n2 // 2
    dev = soft.device
    pairs = soft.reshape(*batch, t_steps, 2)
    m1 = pairs[..., 0, None]
    m2 = pairs[..., 1, None]
    # branch metrics toward each next state from its two predecessors,
    # time-major: [T, ..., 16]
    bm0 = (m1 * on_device(_S1_0, dev) + m2 * on_device(_S2_0, dev)).movedim(-2, 0)
    bm1 = (m1 * on_device(_S1_1, dev) + m2 * on_device(_S2_1, dev)).movedim(-2, 0)
    prev0 = on_device(PREV0, dev)
    prev1 = on_device(PREV1, dev)

    acm = torch.full((*batch, NUM_STATES), -1.0e6, dtype=torch.float32, device=dev)
    acm[..., 0] = 0.0
    decisions = []
    for t in range(t_steps):
        cand0 = acm[..., prev0] + bm0[t]
        cand1 = acm[..., prev1] + bm1[t]
        take0 = cand0 > cand1          # strict: ties keep the second predecessor
        acm = torch.where(take0, cand0, cand1)
        decisions.append(~take0)       # 1 = came from the second predecessor

    state = torch.zeros(tuple(batch), dtype=torch.int64, device=dev)
    bits = [None] * t_steps
    for t in range(t_steps - 1, -1, -1):
        bits[t] = state >> 3
        d = torch.gather(decisions[t], -1, state[..., None])[..., 0]
        state = ((state & 7) << 1) | d.to(torch.int64)
    return torch.stack(bits, dim=-1).to(torch.uint8), acm[..., 0]


def viterbi_decode_cuda(soft: torch.Tensor):
    """The CUDA kernel K1 on [..., 2T] float32 soft bits -> (bits, metric)."""
    *batch, n2 = soft.shape
    if n2 % 2:
        raise ValueError(f"soft input length {n2} is odd")
    t_steps = n2 // 2
    flat = soft.reshape(-1, n2)
    _build.check_cuda_input("viterbi_decode_cuda", flat, torch.float32, 2)
    n = flat.shape[0]
    if n * t_steps >= 2**31:
        raise ValueError("viterbi_decode_cuda: batch too large for int indexing")
    bits = torch.empty((n, t_steps), dtype=torch.uint8, device=soft.device)
    metric = torch.empty((n,), dtype=torch.float32, device=soft.device)
    with torch.cuda.device(soft.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.VITERBI.launch(flat.data_ptr(), bits.data_ptr(), metric.data_ptr(),
                              n, t_steps, ctypes.c_void_p(stream))
    return bits.reshape(*batch, t_steps), metric.reshape(tuple(batch))
