"""The frame compaction's plain version (``compact_ref``), the contract K5
(``compact_cuda``, csrc/compact.cu) is held to on the card, pinned on
hand-made scan outputs: every output exact in each edge case.  Imports
neither JAX nor the JAX package."""

from __future__ import annotations

import pytest
import torch
from torch_parity import compact_block, compact_cases

from m17_sdr_tpu_torch.frame import receiver as tr

CASES = compact_cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_compact_ref_edge_case(case):
    s2, channels, want = CASES[case]
    slot, flags, hist = compact_block(s2, channels)
    b = len(channels)
    state = tr.ReceiverState.init(b, "cpu")._replace(sym_hist=hist)
    ev, st = tr.compact_ref(slot, flags, state)
    f = tr.max_frames_per_block(s2)
    assert ev.frames.shape == (b, f, 192) and st.sym_hist.shape == (b, 191)
    rows = lambda x: torch.tensor([x] * b)          # noqa: E731  the same on every channel
    assert torch.equal(ev.frames, rows(want["frames"]))
    assert torch.equal(ev.frame_valid, rows(want["valid"]))
    assert torch.equal(ev.frame_type, rows(want["type"]).to(torch.int32))
    assert torch.equal(ev.frame_parse, rows(want["parse"]))
    assert torch.equal(ev.frame_slipped, rows(want["slipped"]))
    assert torch.equal(st.sym_hist, rows(want["sym_hist"]))
    assert ev.aos.tolist() == want["aos"] and ev.los.tolist() == want["los"]
    assert ev.n_slips.dtype == torch.int32 and ev.n_slips.tolist() == want["n_slips"]
    assert ev.locked is state.flock


def test_receive_block_takes_the_plain_compaction_on_the_cpu():
    """CPU tensors go through both plain versions; asking for the kernels
    there raises."""
    samples = torch.zeros(2, 384)
    state = tr.ReceiverState.init(2, "cpu")
    ev, _ = tr.receive_block(samples, state)
    assert ev.frames.shape == (2, 3, 192)
    with pytest.raises(ValueError):
        tr.receive_block(samples, state, use_kernel=True)
    slot, flags, hist = compact_block(16, [{}])
    with pytest.raises(ValueError):
        tr.compact_cuda(slot, flags, state._replace(sym_hist=hist[:1]))
