"""The port's loopbacks and BER sweep against the JAX package, TX ->
channel -> RX on the same noise.

The JAX functions draw their AWGN from a ``jax.random`` key; the test
draws the same array with the same key and shape and passes it to the
port, so both run on bit-for-bit the same noise.  The two TXs' IQ
differs by a few f32 ulps of the modulator's phase (tests/test_torch_tx.py),
so a frame slot that holds no frame, whose "decode" is noise, may
decode otherwise.  Held exactly: every per-slot flag and per-block count
of the RX output, every decoded field of the slots that hold a frame
of that type, the session layer of the final state (LICH assembly,
counters, last FN), recovered payloads, reassembled packets and BER
counts.  The final timing-loop and front-end state is not held: after
the EOT those track noise.  Float fields (metrics, quality) are held to
LOOP_RTOL/LOOP_ATOL.
The port runs its plain path here (``use_kernel=False``).

    python tests/test_torch_loopback.py --check-sweep

runs the JAX package's BER sweep on the CPU at a cut-down width and
holds its frame recovery against the recorded curve (SWEEP_POD_r5.json)
with the tolerance that chip_smoke.py applies to the port on the card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from torch_parity import assert_same

from m17_sdr_tpu.app.checkpoint import _flatten_with_paths
from m17_sdr_tpu.frame import tx_frames as j_tf
from m17_sdr_tpu.pipeline import ber_sweep as j_sweep
from m17_sdr_tpu.pipeline import loopback as j_lb
from m17_sdr_tpu.pipeline import tx as j_tx
from m17_sdr_tpu.spec import bits as j_bits
from m17_sdr_tpu.spec import callsign
from m17_sdr_tpu.spec.typefield import CCT_PACKET, M17Type
from m17_sdr_tpu_torch.convert import state_to_numpy
from m17_sdr_tpu_torch.pipeline import ber_sweep as t_sweep
from m17_sdr_tpu_torch.pipeline.ber_sweep import recovery_tolerance
from m17_sdr_tpu_torch.pipeline import loopback as t_lb

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
B, NF = 3, 4
LOOP_RTOL = 1e-2
LOOP_ATOL = 1e-3
# decoded fields and the flag of the slots that hold such a frame
DECODED = {"stream_fn": "stream_valid", "stream_payload": "stream_valid",
           "stream_quality": "stream_valid", "stream_fn_ok": "stream_valid",
           "lsf_bytes": "lsf_valid", "packet_data": "packet_valid",
           "packet_eof": "packet_valid", "packet_fn": "packet_valid",
           "bert_bits": "bert_valid"}


def assert_loopback_match(out_t, st_t, out_j, st_j):
    """A port loopback's RX output and final state against the JAX one's."""
    assert out_t._fields == out_j._fields
    held = np.asarray(out_j.stream_valid | out_j.lsf_valid | out_j.packet_valid
                      | out_j.bert_valid)
    for name in out_j._fields:
        got, want = getattr(out_t, name).numpy(), np.asarray(getattr(out_j, name))
        if name == "viterbi_metric" or name in DECODED:
            # the flags themselves are fields compared exactly
            mask = held if name == "viterbi_metric" else np.asarray(getattr(out_j, DECODED[name]))
            got, want = got[mask], want[mask]
        assert_same(name, got, want, rtol=LOOP_RTOL, atol=LOOP_ATOL)
    want = _flatten_with_paths(st_j)
    got = state_to_numpy(st_t)
    assert set(got) == set(want)
    for k in want:
        if "/" not in k:                       # the session layer
            assert_same(k, got[k], want[k], rtol=LOOP_RTOL, atol=LOOP_ATOL)


def _lsf(batch: int, packet: bool = False) -> np.ndarray:
    dst = np.tile(j_bits.word_to_bytes(callsign.encode_callsign("AB1CDE"), 6), (batch, 1))
    src = np.tile(j_bits.word_to_bytes(callsign.encode_callsign("G4GUO"), 6), (batch, 1))
    tw = M17Type(packet_stream=CCT_PACKET).pack() if packet else M17Type().pack()
    return np.asarray(j_tf.build_lsf_bytes(
        jnp.asarray(dst), jnp.asarray(src), jnp.full((batch,), tw, dtype=jnp.uint32),
        jnp.zeros((batch, 14), jnp.uint8)))


def _noise(key, dibits) -> torch.Tensor:
    """The unit-variance noise the JAX loopback draws for these dibits'
    IQ: jax.random.normal(key, [B, 2, 10 N])."""
    b, n = dibits.shape
    return torch.as_tensor(np.array(jax.random.normal(key, (b, 2, 10 * n))))


@pytest.mark.parametrize("snr_db, freq_hz, ppm, afc", [
    (20.0, [100.0, -200.0, 0.0], [100.0, 0.0, -60.0], True),
    (15.0, 0.0, 0.0, False),
])
def test_voice_loopback_matches_jax(snr_db, freq_hz, ppm, afc):
    lsf = _lsf(B)
    pay = np.random.default_rng(int(snr_db)).integers(0, 256, (B, NF, 16), dtype=np.uint8)
    key = jax.random.PRNGKey(int(snr_db))
    kw = dict(snr_db=snr_db, freq_offset_hz=np.asarray(freq_hz), drift_ppm=np.asarray(ppm))
    out_j, st_j = j_lb.voice_loopback(key, jnp.asarray(lsf), jnp.asarray(pay), afc=afc, **kw)
    noise = _noise(key, j_tx.build_voice_session_dibits(jnp.asarray(lsf), jnp.asarray(pay)))
    out_t, st_t = t_lb.voice_loopback(torch.as_tensor(lsf), torch.as_tensor(pay), afc=afc,
                                      noise=noise, use_kernel=False, **kw)
    assert_loopback_match(out_t, st_t, out_j, st_j)
    got_t, mask_t = t_lb.recover_stream_payloads(out_t, NF)
    got_j, mask_j = j_lb.recover_stream_payloads(out_j, NF)
    np.testing.assert_array_equal(mask_t, mask_j)
    np.testing.assert_array_equal(got_t, got_j)
    if snr_db >= 20.0:
        assert mask_t.all() and np.array_equal(got_t, pay)


def test_packet_loopback_matches_jax():
    """60 bytes + CRC: 3 frames, the last with 12 bytes; a carrier offset
    and 25 dB."""
    rng = np.random.default_rng(7)
    lsf = _lsf(B, packet=True)
    data = rng.integers(0, 256, (B, 60), dtype=np.uint8)
    key = jax.random.PRNGKey(8)
    kw = dict(snr_db=25.0, freq_offset_hz=np.array([150.0, 0.0, -300.0]))
    out_j, st_j = j_lb.packet_loopback(key, jnp.asarray(lsf), jnp.asarray(data), **kw)
    noise = _noise(key, j_tx.build_packet_session_dibits(jnp.asarray(lsf),
                                                         jnp.asarray(data)))
    out_t, st_t = t_lb.packet_loopback(torch.as_tensor(lsf), torch.as_tensor(data),
                                       noise=noise, use_kernel=False, **kw)
    assert_loopback_match(out_t, st_t, out_j, st_j)
    got = t_lb.reassemble_packets(out_t)
    assert got == j_lb.reassemble_packets(out_j)
    assert got == [bytes(d) for d in data]


def test_bert_loopback_matches_jax():
    """Three SNRs from the waterfall to clean, with clock drift."""
    key = jax.random.PRNGKey(9)
    snr = np.array([13.0, 16.0, 30.0], dtype=np.float32)
    e_j, n_j = j_lb.bert_loopback(key, B, 6, snr_db=jnp.asarray(snr), drift_ppm=50.0)
    noise = _noise(key, j_tx.build_bert_session_dibits(B, 6))
    e_t, n_t = t_lb.bert_loopback(B, 6, snr_db=torch.as_tensor(snr), drift_ppm=50.0,
                                  noise=noise, device="cpu", use_kernel=False)
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    assert n_t[2] >= 5 * 197 and e_t[2] == 0


def test_ber_sweep_and_device_counts_match_jax():
    """ber_sweep's points exactly; bert_sweep_counts (the accounting on
    the device) against JAX's, per-channel-keyed noise."""
    key = jax.random.PRNGKey(10)
    pts, cpp, nf = [14.0, 30.0], 2, 4
    want = j_sweep.ber_sweep(key, pts, channels_per_point=cpp, n_frames=nf)
    noise = _noise(key, j_tx.build_bert_session_dibits(len(pts) * cpp, nf))
    got = t_sweep.ber_sweep(pts, channels_per_point=cpp, n_frames=nf, noise=noise,
                            device="cpu", use_kernel=False)
    assert got == want
    assert t_sweep.sweep_to_json(got) == j_sweep.sweep_to_json(want)

    keys = jax.random.split(key, len(pts) * cpp)
    snr = np.repeat(np.float32(pts), cpp)
    counts_j = j_sweep.bert_sweep_counts(keys, jnp.asarray(snr), nf)
    shape = (2, 10 * j_tx.build_bert_session_dibits(1, nf).shape[1])
    noise = torch.as_tensor(np.array(jax.vmap(lambda k: jax.random.normal(k, shape))(keys)))
    counts_t = t_sweep.bert_sweep_counts(torch.as_tensor(snr), nf, noise=noise,
                                         use_kernel=False)
    for name, a, b in zip(("errors", "bits", "unsynced", "frames"), counts_t, counts_j):
        assert a.dtype == torch.int32, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def check_jax_sweep(channels_per_point: int = 32) -> int:
    """The JAX package's sweep at the recorded configuration but
    ``channels_per_point`` channels, against SWEEP_POD_r5.json."""
    rec = json.loads((ROOT / "SWEEP_POD_r5.json").read_text())
    curve = rec["curve"]
    snr = np.float32([p["snr_db"] for p in curve])
    keys = jax.random.split(jax.random.PRNGKey(0), len(snr) * channels_per_point)
    err, bits, uns, frames = j_sweep.bert_sweep_counts(
        keys, jnp.asarray(np.repeat(snr, channels_per_point)), rec["frames_per_channel"])
    frames = np.asarray(frames).reshape(len(snr), channels_per_point)
    bad = 0
    for i, p in enumerate(curve):
        got = frames[i].sum() / (rec["frames_per_channel"] * channels_per_point)
        tol = recovery_tolerance(p["frame_recovery"], channels_per_point)
        ok = abs(got - p["frame_recovery"]) <= tol
        bad += not ok
        print(f"snr {p['snr_db']:6.2f} dB: recovery {got:.4f} vs recorded "
              f"{p['frame_recovery']:.4f} (tolerance {tol:.4f}) {'ok' if ok else 'OFF'}")
    return bad


if __name__ == "__main__":
    if sys.argv[1:] != ["--check-sweep"]:
        sys.exit("usage: python tests/test_torch_loopback.py --check-sweep")
    jax.config.update("jax_platforms", "cpu")
    sys.exit(1 if check_jax_sweep() else 0)
