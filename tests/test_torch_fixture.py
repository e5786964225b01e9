"""The committed receive fixture (m17_sdr_tpu_torch/data/rx_fixture.npz).

``chip_smoke.py`` runs on a machine without JAX, so what the JAX package
decodes from a fixed set of sessions is recorded here, on the CPU, and
committed.  Rebuild it with

    python tests/test_torch_fixture.py --write

The tests check that a fresh build matches the committed file and that
the port's plain path reproduces the recorded decode.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "m17_sdr_tpu_torch" / "data" / "rx_fixture.npz"

N_SESSIONS = 8
N_FRAMES = 8              # stream frames per session: 13 blocks of 1920
BLOCK = 1920
NOISY = slice(4, 8)       # sessions with a carrier offset and noise
CARRIER_HZ = 300.0
NOISE_SIGMA = 0.02        # per IQ component, unit-amplitude signal
RECORDED = ("stream_valid", "stream_fn", "stream_payload", "stream_gate",
            "lsf_valid", "lsf_bytes", "locked", "aos", "los")

torch.set_num_threads(2)


def build_fixture() -> dict[str, np.ndarray]:
    """Sessions from the JAX TX and the JAX ``rx_stream`` decode of them
    (AFC on, equalize "auto"), on the CPU."""
    import jax.numpy as jnp

    from m17_sdr_tpu.frame import tx_frames
    from m17_sdr_tpu.pipeline import tx as txp
    from m17_sdr_tpu.pipeline.rx import RxSessionState, rx_stream
    from m17_sdr_tpu.spec import bits as bitpack
    from m17_sdr_tpu.spec import callsign
    from m17_sdr_tpu.spec.typefield import M17Type

    b0 = N_SESSIONS
    # as m17_sdr_tpu/pipeline/benchdata.py builds its sessions
    dst = jnp.asarray(np.tile(
        bitpack.word_to_bytes(callsign.encode_callsign("AB1CDE"), 6), (b0, 1)))
    src = jnp.asarray(np.tile(
        bitpack.word_to_bytes(callsign.encode_callsign("G4GUO"), 6), (b0, 1)))
    lsf = tx_frames.build_lsf_bytes(
        dst, src, jnp.full((b0,), M17Type().pack(), dtype=jnp.uint32),
        jnp.zeros((b0, 14), jnp.uint8))
    rng = np.random.default_rng(0)
    payloads = jnp.asarray(rng.integers(0, 256, (b0, N_FRAMES, 16), dtype=np.uint8))
    iq, _ = txp.dibits_to_iq(txp.build_voice_session_dibits(lsf, payloads))
    iq = np.asarray(iq, dtype=np.float64)                  # [b0, 2, T]

    t = iq.shape[-1]
    z = iq[:, 0] + 1j * iq[:, 1]
    z[NOISY] *= np.exp(2j * np.pi * CARRIER_HZ / 48_000 * np.arange(t))
    noise_rng = np.random.default_rng(1)
    z[NOISY] += NOISE_SIGMA * (noise_rng.normal(size=z[NOISY].shape)
                               + 1j * noise_rng.normal(size=z[NOISY].shape))
    iq = np.stack([z.real, z.imag], axis=1)
    # the int16 wire format, quantized as benchdata.py does
    iq16 = np.clip(np.round(iq / 3.0e-5), -32768, 32767).astype(np.int16)

    nblk = t // BLOCK
    blocks = iq16.reshape(b0, 2, nblk, BLOCK).transpose(0, 2, 1, 3)
    out, _ = rx_stream(jnp.asarray(blocks), RxSessionState.init(b0),
                       afc_enabled=True, equalize="auto")
    rec = {k: np.asarray(getattr(out, k)) for k in RECORDED}
    rec["stream_fn"] = rec["stream_fn"].astype(np.int64)
    return {"iq": iq16, "payloads": np.asarray(payloads), **rec}


def load_fixture() -> dict[str, np.ndarray]:
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


def test_fresh_build_matches_committed():
    fresh = build_fixture()
    stored = load_fixture()
    assert set(fresh) == set(stored)
    # the IQ goes through float math and rounding: allow one LSB
    assert np.abs(fresh["iq"].astype(np.int32) - stored["iq"]).max() <= 1
    for k in fresh:
        if k != "iq":
            np.testing.assert_array_equal(fresh[k], stored[k], err_msg=k)
    # every stream frame of every session is decoded and routed
    assert stored["stream_gate"].sum() == N_SESSIONS * N_FRAMES
    assert stored["lsf_valid"].sum() == N_SESSIONS


def test_port_plain_path_reproduces_record():
    from m17_sdr_tpu_torch.pipeline.rx import RxSessionState, rx_stream

    fx = load_fixture()
    iq = torch.as_tensor(fx["iq"])
    b, _, t = iq.shape
    blocks = iq.reshape(b, 2, t // BLOCK, BLOCK).permute(0, 2, 1, 3)
    out, _ = rx_stream(blocks, RxSessionState.init(b, "cpu"),
                       afc_enabled=True, equalize="auto", use_kernel=False)
    for k in RECORDED:
        np.testing.assert_array_equal(getattr(out, k).numpy(), fx[k], err_msg=k)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_fixture.py --write")
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    data = build_fixture()
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **data)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")
    for k in RECORDED:
        print(k, data[k].shape, int(data[k].astype(np.int64).sum()))
