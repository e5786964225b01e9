"""The port's front end and frame equalizer against the JAX package."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same, voice_iq

from m17_sdr_tpu.dsp import discriminator as j_disc
from m17_sdr_tpu.dsp import equalize as j_eq
from m17_sdr_tpu_torch.dsp import discriminator as t_disc
from m17_sdr_tpu_torch.dsp import equalize as t_eq
from m17_sdr_tpu_torch.dsp import iq as t_iq

torch.set_num_threads(2)

# front end: float32 elementwise math and block means, summed in another
# order and with other sin/cos implementations
FE_RTOL, FE_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def iq():
    """4 channels, 4 blocks of a voice session: two with carrier offsets
    and noise, one silent channel."""
    x = voice_iq(4, 1, seed=7, carrier_hz=(0.0, 300.0, -450.0), sigma=0.05)
    x[3] = 0.0
    return x[..., : 4 * 1920]


@pytest.mark.parametrize("afc", [False, True])
@pytest.mark.parametrize("in_frame", ["never", "toggling"])
@pytest.mark.parametrize("int16", [False, True])
def test_front_end_matches_jax(iq, afc, in_frame, int16):
    x = np.clip(np.round(iq / 3.0e-5), -32768, 32767).astype(np.int16) if int16 else iq
    b = x.shape[0]
    st_t = t_disc.RxFrontEndState.init(b, "cpu")
    st_j = j_disc.RxFrontEndState.init(b)
    for blk in range(4):
        frame = np.zeros(b, bool) if in_frame == "never" else \
            (np.arange(b) + blk) % 3 != 0
        xb = x[..., blk * 1920:(blk + 1) * 1920]
        dec_t, off_t, st_t = t_disc.rx_front_end(torch.as_tensor(xb), st_t,
                                                 torch.as_tensor(frame), afc_enabled=afc)
        dec_j, off_j, st_j = j_disc.rx_front_end(jnp.asarray(xb), st_j,
                                                 jnp.asarray(frame), afc_enabled=afc)
        msg = f"block {blk}"
        assert_same(f"soft {msg}", dec_t, dec_j, FE_RTOL, FE_ATOL)
        assert_same(f"offset {msg}", off_t, off_j, FE_RTOL, FE_ATOL)
        for f in j_disc.RxFrontEndState._fields:
            assert_same(f"{f} {msg}", getattr(st_t, f), getattr(st_j, f), FE_RTOL, FE_ATOL)


def _pairwise_f64(x: np.ndarray) -> float:
    """The front end's summation order, written top-down: the float32
    summands zero-padded to a power of two, each half summed the same way,
    the two halves added in float64."""
    n = 1 << max(0, (len(x) - 1).bit_length())
    x = np.concatenate([x.astype(np.float64), np.zeros(n - len(x))])

    def tree(lo, hi):
        return x[lo] if hi - lo == 1 else tree(lo, (lo + hi) // 2) + tree((lo + hi) // 2, hi)
    return tree(0, n)


@pytest.mark.parametrize("int16", [False, True])
@pytest.mark.parametrize("t", [5, 1920, 24960])
def test_front_end_means_are_pairwise_sums(iq, t, int16):
    """The plain front end's level (the meter's first reading) and DC offset
    equal, bit for bit, float64 pairwise sums in numpy of its float32
    summands, |iq| and the discriminator output, divided by T and rounded
    to float32: the order K3 adds in on the card.  (The summands come from
    the port's own elementwise functions: PyTorch's CPU square root is
    not numpy's.)"""
    x = np.tile(iq, (1, 1, -(-t // iq.shape[-1])))[:2, :, :t]
    if int16:
        x = np.clip(np.round(x / 3.0e-5), -32768, 32767).astype(np.int16)
    rng = np.random.default_rng(t)
    tail = torch.as_tensor(rng.normal(size=(2, 2, 2)).astype(np.float32))
    st = t_disc.RxFrontEndState.init(2, "cpu")._replace(disc_tail=tail)
    _, off, new = t_disc.rx_front_end(torch.as_tensor(x), st, torch.zeros(2, dtype=torch.bool))

    iq2 = torch.as_tensor(x).to(torch.float32) * 3.0e-5 if int16 else torch.as_tensor(x)
    z = t_disc.limit(iq2)
    zh = torch.cat([tail, z], dim=-1)
    u = (t_iq.conj_mul_im(zh[..., 1:-1], z) + t_iq.conj_mul_im(zh[..., :-2], zh[..., 1:-1])) * 0.5
    for name, got, summands in (("level", new.rssi, t_iq.magnitude(iq2)), ("offset", off, u)):
        for c in range(2):
            want = np.float32(_pairwise_f64(summands[c].numpy()) / t)
            assert got[c].numpy().tobytes() == want.tobytes(), (name, c)


def test_front_end_kernel_needs_cuda():
    """K3 takes CUDA tensors only: asked for on the CPU it raises."""
    st = t_disc.RxFrontEndState.init(2, "cpu")
    x = torch.zeros((2, 2, 1920), dtype=torch.int16)
    with pytest.raises(ValueError):
        t_disc.rx_front_end(x, st, torch.zeros(2, dtype=torch.bool), use_kernel=True)
    with pytest.raises(ValueError):
        t_disc.rx_front_end(x[..., :1918], st, torch.zeros(2, dtype=torch.bool))


def test_slicer_and_windows_equal_jax():
    rng = np.random.default_rng(0)
    y = (rng.normal(size=(5, 192)) * 2.5).astype(np.float32)
    np.testing.assert_array_equal(t_eq.slicer4(torch.as_tensor(y)).numpy(),
                                  np.asarray(j_eq.slicer4(jnp.asarray(y))))
    np.testing.assert_array_equal(t_eq._frame_windows(torch.as_tensor(y)).numpy(),
                                  np.asarray(j_eq._frame_windows(jnp.asarray(y))))
    init_t = t_eq.EqState.init_identity(3, "cpu")
    init_j = j_eq.EqState.init_identity(3)
    for f in j_eq.EqState._fields:
        np.testing.assert_array_equal(getattr(init_t, f).numpy(), np.asarray(getattr(init_j, f)))


def test_equalize_frames_matches_jax():
    """Frames of 4FSK symbols through a two-ray channel with noise; the
    per-frame taps update under a random mask."""
    rng = np.random.default_rng(1)
    b, f = 6, 3
    sym = rng.choice([-3.0, -1.0, 1.0, 3.0], size=(b, f, 192))
    frames = sym + 0.45 * np.roll(sym, 1, axis=-1) + rng.normal(0, 0.1, sym.shape)
    frames = frames.astype(np.float32)
    c0 = np.asarray(j_eq.EqState.init_identity(b).c)
    c0 = (c0 + rng.normal(0, 0.05, c0.shape)).astype(np.float32)
    update = rng.random((b, f)) < 0.7
    update[0] = False
    out_t, c_t = t_eq.equalize_frames(torch.as_tensor(frames), torch.as_tensor(c0),
                                      torch.as_tensor(update))
    out_j, c_j = j_eq.equalize_frames(jnp.asarray(frames), jnp.asarray(c0),
                                      jnp.asarray(update))
    assert_same("frames", out_t, out_j, 1e-5, 1e-5)
    assert_same("taps", c_t, c_j, 1e-5, 1e-5)
    np.testing.assert_array_equal(c_t[0].numpy(), c0[0])    # never updated
