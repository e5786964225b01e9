"""Helpers shared by the tests that hold the PyTorch port
(m17_sdr_tpu_torch) to the JAX package on the same inputs."""

from __future__ import annotations

import functools
import socket

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


def _jax_gate_session(nch: int, nf: int, seed: int):
    """The JAX quality-gate tool's ``mk_session`` (tools/quality_gate.py):
    (dibits, payloads [nch, nf, 16] from ``default_rng(seed)``)."""
    import jax.numpy as jnp

    from m17_sdr_tpu.pipeline import tx as txp
    from m17_sdr_tpu.pipeline.ber_parity import _lsf_for

    pl = np.random.default_rng(seed).integers(0, 256, (nch, nf, 16), dtype=np.uint8)
    return txp.build_voice_session_dibits(_lsf_for(nch), jnp.asarray(pl)), pl


def jax_offset_drift_wire(nch: int, nf: int, seed: int, noisy: bool = True):
    """The JAX quality-gate tool's offset+drift wire, by its own lines:
    (IQ [nch, 2, T] float32, payloads, the unit noise ``awgn`` drew from
    ``PRNGKey(seed)``, or None and no noise where not ``noisy``)."""
    import jax

    from m17_sdr_tpu.dsp import channel
    from m17_sdr_tpu.pipeline import tx as txp

    dibits, pl = _jax_gate_session(nch, nf, seed + 1)
    iq, _ = txp.dibits_to_iq(dibits)
    iq = channel.timing_drift(iq, 120.0)
    iq = channel.carrier_offset(iq, 300.0)
    if not noisy:
        return np.array(iq), pl, None
    key = jax.random.PRNGKey(seed)
    return np.array(channel.awgn(key, iq, 17.0)), pl, np.array(jax.random.normal(key, iq.shape))


def jax_pluto_wire(nch: int, nf: int, seed: int):
    """The JAX quality-gate tool's Pluto wire, by its own lines: (48 kHz IQ
    [nch, 2, T] float32 after the x8 decimator, payloads, the unit noise
    [nch, 2, 8 T] ``awgn`` drew from ``PRNGKey(seed + 9)`` at 384 kHz)."""
    import jax
    import jax.numpy as jnp

    from m17_sdr_tpu.dsp import channel, resample
    from m17_sdr_tpu.pipeline import tx as txp

    dibits, pl = _jax_gate_session(nch, nf, seed + 2)
    iq384, _ = txp.dibits_to_iq(dibits, oversample=80)
    key = jax.random.PRNGKey(seed + 9)
    noise = np.array(jax.random.normal(key, iq384.shape))
    iq384 = channel.awgn(key, iq384, 20.0)
    iq48, _ = resample.fir_decimate(iq384, jnp.asarray(resample.pluto_dec_taps()),
                                    resample.decimate_init(nch), factor=8)
    return np.array(iq48), pl, noise


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


def isi_smear(iq: np.ndarray, start: float = 0.35, full: float = 0.5) -> np.ndarray:
    """int16 [B, 2, T] sessions through a two-ray channel of their
    instantaneous frequency (tools/quality_gate.py's isi_2ray echoes):
    gains 0.6 and 0.3 at 5 and 10 samples (half a symbol and one at 48
    kS/s), ramping in from 0 at ``start`` to full strength at ``full``
    (shares of T), then FM-modulated again at each channel's mean
    magnitude and quantized."""
    z = iq[:, 0].astype(np.float64) + 1j * iq[:, 1]
    inc = np.zeros(z.shape)
    inc[:, 1:] = np.angle(z[:, 1:] * np.conj(z[:, :-1]))
    g = np.clip((np.arange(z.shape[1]) / z.shape[1] - start) / (full - start), 0.0, 1.0)
    smeared = inc.copy()
    smeared[:, 5:] += g[5:] * 0.6 * inc[:, :-5]
    smeared[:, 10:] += g[10:] * 0.3 * inc[:, :-10]
    ph = np.angle(z[:, :1]) + np.cumsum(smeared, axis=1)
    x = np.stack([np.cos(ph), np.sin(ph)], axis=1) * np.abs(z).mean(axis=1)[:, None, None]
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)


def to_int16(iq: np.ndarray) -> np.ndarray:
    """The int16 wire format (inverse of the front end's 3e-5 scale)."""
    return np.clip(np.round(iq / 3.0e-5), -32768, 32767).astype(np.int16)


class FakeReflector:
    """A reflector stand-in on a free local UDP port the kernel picks:
    poll() takes one datagram (or None) and send() answers whoever sent
    the last one, as a reflector answers its clients."""

    def __init__(self):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.setblocking(False)
        self.port = self.sock.getsockname()[1]
        self.peer = None

    def poll(self) -> bytes | None:
        try:
            data, self.peer = self.sock.recvfrom(65536)
        except BlockingIOError:
            return None
        return data

    def send(self, data: bytes) -> None:
        self.sock.sendto(data, self.peer)

    def close(self) -> None:
        self.sock.close()


# ---- hand-made scan outputs for the frame compaction (compact_ref and K5)

HIST = [-1.0 - i for i in range(191)]       # the carried symbol history


def slot_value(t: int) -> float:
    """The slot value of step t in the hand-made blocks."""
    return 100.0 + t


def _values(steps) -> list[float]:
    return [slot_value(t) for t in steps]


def compact_block(s2: int, channels: list[dict]):
    """Scan outputs (slot_vals [B, s2] f32, flags [B, s2] i32, sym_hist
    [B, 191] f32) from one dict of step sets a channel: ``valid``,
    ``done``, ``parse``, ``slipframe``, ``aos``, ``los``, ``slip``, and
    ``types`` ({step: sync type}; other steps carry type t % 6).  Step t's
    slot value is ``slot_value(t)`` on every channel."""
    from m17_sdr_tpu_torch.frame import receiver as tr

    bits = {"valid": tr.F_VALID, "done": tr.F_DONE, "parse": tr.F_PARSE, "aos": tr.F_AOS,
            "los": tr.F_LOS, "slip": tr.F_SLIP, "slipframe": tr.F_SLIPFRAME}
    flags = np.zeros((len(channels), s2), np.int32)
    for c, ch in enumerate(channels):
        types = ch.get("types", {})
        for t in range(s2):
            flags[c, t] = np.int32(types.get(t, t % 6)) << tr.F_TYPE_SHIFT
        for key, bit in bits.items():
            for t in ch.get(key, ()):
                flags[c, t] |= bit
    slot = np.tile(np.asarray(_values(range(s2)), np.float32), (len(channels), 1))
    hist = np.tile(np.asarray(HIST, np.float32), (len(channels), 1))
    return torch.as_tensor(slot), torch.as_tensor(flags), torch.as_tensor(hist)


def compact_cases() -> dict:
    """The compaction's edge cases: name -> (s2, channels, expected), the
    expected outputs of one channel (of each, for ``lock_events``) as
    lists: ``frames`` (each slot's 192 symbols), ``valid``, ``type``,
    ``parse``, ``slipped``, ``sym_hist``, and ``aos``, ``los``,
    ``n_slips`` a channel.  At s2 = 16 a block has F = 2 frame slots; a
    slot no completion filled reads step s2 - 1 at the block's valid
    count."""
    v16 = _values(range(16))
    quiet = dict(aos=[False], los=[False], n_slips=[0])
    return {
        # no valid slot: a frame reads the history and then the stable
        # argsort's first entry, the first invalid step (step 0)
        "no_valid_slot": (16, [dict(done={5}, parse={5})], dict(
            frames=[HIST + _values([0])] * 2, valid=[True, False], type=[5, 3],
            parse=[True, False], slipped=[False, False], sym_hist=HIST, **quiet)),
        # a completion before any valid step starts at stream offset 0
        "completion_at_vcount_0": (16, [dict(valid={4, 6, 8}, done={2}, parse={2},
                                             slipframe={2})], dict(
            frames=[HIST + _values([4]), HIST[2:] + _values([4, 6, 8])], valid=[True, False],
            type=[2, 3], parse=[True, False], slipped=[True, False],
            sym_hist=HIST[3:] + _values([4, 6, 8]), **quiet)),
        # four completions, two slots: the first two in step order
        "more_completions_than_slots": (16, [dict(valid=set(range(16)), done={12, 3, 9, 5},
                                                  parse={5, 9})], dict(
            frames=[HIST[3:] + v16[:4], HIST[5:] + v16[:6]], valid=[True, True], type=[3, 5],
            parse=[False, True], slipped=[False, False], sym_hist=HIST[16:] + v16, **quiet)),
        # no completion: both slots read step 15 (its parse and slip bits
        # masked, its type kept, shifted arithmetically)
        "no_completion": (16, [dict(valid={1, 2, 3}, parse={15}, slipframe={15},
                                    types={15: -3})], dict(
            frames=[HIST[2:] + _values([1, 2, 3])] * 2, valid=[False, False], type=[-3, -3],
            parse=[False, False], slipped=[False, False],
            sym_hist=HIST[3:] + _values([1, 2, 3]), **quiet)),
        # 10 valid symbols: the history keeps its last 181
        "history_partly_kept": (16, [dict(valid=set(range(10)), done={9})], dict(
            frames=[HIST[9:] + v16[:10], HIST[9:] + v16[:10]], valid=[True, False],
            type=[3, 3], parse=[False, False], slipped=[False, False],
            sym_hist=HIST[10:] + v16[:10], **quiet)),
        # 400 valid symbols (F = 3): the history is the last 191 of them
        "history_rolled_whole": (400, [dict(valid=set(range(400)), done={200, 399})], dict(
            frames=[_values(range(9, 201)), _values(range(208, 400)),
                    _values(range(208, 400))], valid=[True, True, False], type=[2, 3, 3],
            parse=[False, False, False], slipped=[False, False, False],
            sym_hist=_values(range(209, 400)), **quiet)),
        # the block's lock events and slip counts, three channels
        "lock_events": (16, [dict(valid=set(range(16)), aos={2}),
                             dict(valid=set(range(16)), los={7}, slip={1, 4, 9}),
                             dict(valid=set(range(16)), aos={3}, los={11}, slip={15})], dict(
            frames=[HIST[15:] + v16] * 2, valid=[False, False], type=[3, 3],
            parse=[False, False], slipped=[False, False], sym_hist=HIST[16:] + v16,
            aos=[True, False, True], los=[False, True, True], n_slips=[0, 3, 1])),
    }
