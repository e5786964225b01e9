"""The frame equalizer stage in fixed order, on the CPU: its solve, the
automatic stage on ISI-smeared IQ against the JAX package, and the port's
plain receiver on the benchmark's ``isi`` signal against the benchmark's
reference chain, which arms where the ``voice`` signal does not."""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_outputs_match, assert_states_match, isi_smear

from m17_sdr_tpu.pipeline import rx as jrx
from m17_sdr_tpu_torch import _build
from m17_sdr_tpu_torch.dsp import equalize as teq
from m17_sdr_tpu_torch.pipeline import rx as trx

torch.set_num_threads(2)
SEED = 3_000_000_021
REPO = Path(__file__).resolve().parents[1]
FIXTURE = _build.CSRC.parent / "data" / "rx_fixture.npz"


def test_solve5_against_numpy():
    """The LDL^T solve on regularized normal matrices of frame windows,
    well and badly conditioned (a constant and an alternating frame)."""
    rng = np.random.default_rng(4)
    rows = [rng.choice([-3.0, -1.0, 1.0, 3.0], 192), np.full(192, 2.0),
            np.tile([3.0, -3.0], 96), rng.normal(size=192)]
    win = np.stack([np.lib.stride_tricks.sliding_window_view(np.pad(r, 2, mode="edge"), 5)
                    for r in rows])                                     # [4, 192, 5]
    a = np.einsum("bnk,bnl->bkl", win, win) + 1e-3 * np.eye(5)
    rhs = rng.normal(size=(4, 5))
    t = [[torch.as_tensor(a[:, i, j]) for j in range(5)] for i in range(5)]
    got = torch.stack(teq._solve5(t, list(torch.as_tensor(rhs).unbind(1))), dim=-1).numpy()
    want = np.linalg.solve(a, rhs[..., None])[..., 0]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9 * np.abs(want).max())


def test_auto_stage_on_isi_iq_matches_jax():
    """Three fixture sessions through the two-ray channel, int16 IQ, AFC on:
    every channel arms mid-session, and the port's plain receiver follows
    JAX field for field within the parity tolerances."""
    with np.load(FIXTURE) as z:
        iq = isi_smear(z["iq"][:3])
    b, _, t = iq.shape
    blocks = iq.reshape(b, 2, t // 1920, 1920).transpose(0, 2, 1, 3).copy()
    out_t, st_t = trx.rx_stream(torch.as_tensor(blocks), trx.RxSessionState.init(b, "cpu"),
                                afc_enabled=True, equalize="auto")
    out_j, st_j = jrx.rx_stream(jnp.asarray(blocks), jrx.RxSessionState.init(b),
                                afc_enabled=True, equalize="auto")
    assert bool(np.asarray(st_j.eq_armed).all())
    assert_outputs_match(out_t, out_j)
    assert_states_match(st_t, st_j)


@pytest.fixture(scope="module")
def isi_call():
    """One whole-session call of the ``isi`` cell's signal at 8 channels
    (4 sessions), from a fresh state: the input, and the port's plain
    receiver's outputs and state."""
    from portbench import cells
    from portbench.signals import isi

    cell = cells.load_cell(REPO, "m17_autoeq16384.session_isi")
    mix, config = dict(cell.traffic, sessions=4), dict(cell.config, channels=8)
    sig = isi.build(mix, config, SEED, "cpu")                     # [8, 13, 2, 1920]
    b, p, _, t = sig.shape
    iq = sig.permute(0, 2, 1, 3).reshape(b, 2, p * t).contiguous()
    out, st = trx.rx_block(iq, trx.RxSessionState.init(b, "cpu"), equalize="auto",
                           use_kernel=False)
    return cell, mix, config, iq, out, st


def test_plain_receiver_matches_the_benchmark_reference_on_isi(isi_call):
    """The port's plain ``rx_block(equalize="auto")`` against the frozen
    reference chain of the benchmark (``portbench/ref``, the eager
    equalizer): decoded fields and carried answers equal, float fields
    within the cell's ``soft_rms`` limit."""
    from portbench import compare
    from portbench.ref.pipeline import rx as ref_rx

    cell, _, _, iq, out, st = isi_call
    r_out, r_st = ref_rx.rx_block(iq, ref_rx.RxSessionState.init(iq.shape[0], "cpu"),
                                  equalize="auto")
    as_call = lambda d: {k: v[:, None] for k, v in d.items()}     # noqa: E731
    got = compare.compare(as_call(compare.flatten(out)), as_call(compare.flatten(r_out)),
                          compare.flatten(st), compare.flatten(r_st))
    assert got["frames"] > 0
    assert got["decoded_mismatches"] == 0
    assert got["soft_rms"] <= cell.limits["limits"]["soft_rms"], got


def test_isi_signal_arms_the_equalizer_and_voice_does_not(isi_call):
    """From a fresh state, one call: the ISI arms nearly every channel (one
    whose echoes all come before it acquires arms in the next call); the
    clean sessions' eye stays open on every channel."""
    from portbench.signals import voice

    _, mix, config, iq, _, st = isi_call
    assert int(st.eq_armed.sum()) >= 6
    sig = voice.build(mix, config, SEED, "cpu")
    b, p, _, t = sig.shape
    clean = sig.permute(0, 2, 1, 3).reshape(b, 2, p * t).contiguous()
    _, st_v = trx.rx_block(clean, trx.RxSessionState.init(b, "cpu"), equalize="auto")
    assert not bool(st_v.eq_armed.any())
    assert bool((st_v.eye_est > 0).all()) and float(st_v.eye_est.max()) < teq.EYE_DISARM
