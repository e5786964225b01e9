"""Helpers shared by the tests that hold the PyTorch port
(m17_sdr_tpu_torch) to the JAX package on the same inputs."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

# Float fields of the whole path.  The front end's float32 math differs
# from XLA's in the last ulp (sin/cos, sums in another order).  Where such
# a difference crosses a bf16 rounding boundary of the matched filter,
# one soft symbol moves by one bf16 step (2^-8 relative), which moves a
# Viterbi metric or a stream quality by about 1e-4 relative.  Integer,
# bool and byte fields stay exact.
FLOAT_RTOL = 1e-3
FLOAT_ATOL = 1e-5


def assert_same(name: str, got, want, rtol: float = FLOAT_RTOL, atol: float = FLOAT_ATOL):
    """Integer, bool and byte arrays exactly; float arrays to rtol/atol."""
    if isinstance(got, torch.Tensor):
        got = got.detach().cpu().numpy()
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{name}: shape {got.shape} vs {want.shape}"
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)
    else:
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64),
                                      err_msg=name)


def assert_outputs_match(out_t, out_j):
    """Every field of a port RxBlockOutput against the JAX one."""
    assert out_t._fields == out_j._fields
    for name in out_j._fields:
        assert_same(name, getattr(out_t, name), getattr(out_j, name))


def assert_states_match(st_t, st_j):
    """Every leaf of a port RxSessionState against the JAX one, by the
    JAX checkpoint's keys."""
    from m17_sdr_tpu.app.checkpoint import _flatten_with_paths
    from m17_sdr_tpu_torch.convert import state_to_numpy

    want = _flatten_with_paths(st_j)
    got = state_to_numpy(st_t)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert_same(k, got[k], want[k])


@pytest.fixture
def cuda():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def voice_iq(nch: int, nf: int, seed: int, carrier_hz=(), sigma: float = 0.0):
    """nch voice sessions of nf stream frames from the JAX TX, as planar
    float32 IQ [nch, 2, T] (T = (nf + 5) * 1920).  ``carrier_hz`` gives
    per-channel carrier offsets; ``sigma`` adds seeded complex noise."""
    import jax.numpy as jnp

    from m17_sdr_tpu.pipeline import tx as txp
    from m17_sdr_tpu.pipeline.ber_parity import _lsf_for

    rng = np.random.default_rng(seed)
    payloads = jnp.asarray(rng.integers(0, 256, (nch, nf, 16), dtype=np.uint8))
    iq, _ = txp.dibits_to_iq(txp.build_voice_session_dibits(_lsf_for(nch), payloads))
    z = np.asarray(iq[:, 0] + 1j * iq[:, 1], dtype=np.complex128)
    n = np.arange(z.shape[1])
    for ch, hz in enumerate(carrier_hz):
        z[ch] *= np.exp(2j * np.pi * hz / 48_000 * n + 1j * rng.uniform(0, 2 * np.pi))
    z += sigma * (rng.normal(size=z.shape) + 1j * rng.normal(size=z.shape))
    return np.stack([z.real, z.imag], axis=1).astype(np.float32)


def iq_blocks(iq: np.ndarray, block: int = 1920) -> np.ndarray:
    """[B, 2, T] -> [B, T // block, 2, block]."""
    b, _, t = iq.shape
    n = t // block
    return np.ascontiguousarray(
        iq[..., : n * block].reshape(b, 2, n, block).transpose(0, 2, 1, 3))


def two_sessions() -> np.ndarray:
    """3 channels, two voice sessions back to back (so a second AOS), as
    [B, NBLK, 2, 1920] float32 blocks.  Channel 1 has a +300 Hz carrier,
    channel 2 -200 Hz; all carry a little noise."""
    return _two_sessions().copy()


@functools.lru_cache(maxsize=None)
def _two_sessions() -> np.ndarray:
    a = voice_iq(3, 2, seed=1, carrier_hz=(0.0, 300.0, -200.0), sigma=0.02)
    b = voice_iq(3, 1, seed=2, carrier_hz=(0.0, 300.0, -200.0), sigma=0.02)
    return iq_blocks(np.concatenate([a, b], axis=-1))


def to_int16(iq: np.ndarray) -> np.ndarray:
    """The int16 wire format (inverse of the front end's 3e-5 scale)."""
    return np.clip(np.round(iq / 3.0e-5), -32768, 32767).astype(np.int16)
