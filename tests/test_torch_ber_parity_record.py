"""The port against the committed soft-domain parity record
(BER_PARITY_r4.json) at its full size, 64 channels x 64 frames, on the CPU.

``replay_record`` regenerates the stream point at 12 dB with the record's
seed scheme (seed 0 + 1000 x its index, sigma from the clean power of
2 x 16 frames), decodes it with the port's plain path, and must give the
recorded ``jax`` tuple exactly and pass both of the record's predicates
against the recorded ``ref`` tuple.  One point only: it takes the port
about a minute here.  The card replays all 25 points (chip_smoke.py
phase 17).  In a file of its own, so that it runs beside the others.
"""

from __future__ import annotations

from pathlib import Path

import torch

from m17_sdr_tpu_torch.pipeline import ber_parity as t_bp

torch.set_num_threads(2)
RECORD = Path(__file__).resolve().parents[1] / "BER_PARITY_r4.json"


def test_replay_stream_12db_equals_record():
    (p,) = t_bp.replay_record(RECORD, ("stream",), device="cpu", snr_db=[12.0])
    assert (p.kind, p.snr_db) == ("stream", 12.0)
    assert p.port == (3470, 3584, 6, 444160) == p.recorded_jax()
    assert p.equals_recorded_jax()
    assert p.checks == {"ber_agreement_ok": True, "frame_agreement_ok": True}
