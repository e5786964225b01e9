"""The port's acceptance gate (m17_sdr_tpu_torch/tools/kernel_validate.py)
against the JAX tool (tools/pallas_validate.py), at 64 channels on the CPU.

The JAX tool builds its session and scores its legs inside its ``main()``,
so both are composed here from the same JAX functions by its own lines.
JAX's session goes through the port's plain leg and through JAX's
``rx_block(use_pallas=False)`` chain: both must route all 512 frames with
no byte error, and their scoring tensors (the payload kept at each FN and
which FNs were routed) must be equal.  The port's own session is held
within IQ_ATOL of JAX's (tests/test_torch_tx.py's bound: the modulator's
float32 phase sums in another order), its payloads exactly.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m17_sdr_tpu.frame import tx_frames as j_tf
from m17_sdr_tpu.pipeline import rx as jrx
from m17_sdr_tpu.pipeline import tx as jtx
from m17_sdr_tpu.spec import bits as j_bits
from m17_sdr_tpu.spec import callsign as j_call
from m17_sdr_tpu.spec.typefield import M17Type
from m17_sdr_tpu_torch.tools import kernel_validate as kv

torch.set_num_threads(2)
B = 64
NF = 8
IQ_ATOL = 2e-4           # planar IQ, port TX vs JAX TX (tests/test_torch_tx.py)
JAX_KEYS = {"platform", "xla", "pallas", "expected_frames", "ok"}


def jax_session(batch: int) -> tuple[np.ndarray, np.ndarray]:
    """The JAX tool's (blocks [batch, nblk, 2, 1920] float32, expected
    payloads [batch, 8, 16]), by its own lines."""
    block, b0, nf = 1920, 64, NF
    dst = jnp.asarray(np.tile(j_bits.word_to_bytes(j_call.encode_callsign("AB1CDE"), 6),
                              (b0, 1)))
    src = jnp.asarray(np.tile(j_bits.word_to_bytes(j_call.encode_callsign("G4GUO"), 6),
                              (b0, 1)))
    lsf = j_tf.build_lsf_bytes(dst, src, jnp.full((b0,), M17Type().pack(), dtype=jnp.uint32),
                               jnp.zeros((b0, 14), jnp.uint8))
    rng = np.random.default_rng(0)
    payloads = jnp.asarray(rng.integers(0, 256, (b0, nf, 16), dtype=np.uint8))
    iq, _ = jtx.dibits_to_iq(jtx.build_voice_session_dibits(lsf, payloads))
    nblk = iq.shape[-1] // block
    blk = jnp.moveaxis(iq[:, :, : nblk * block].reshape(b0, 2, nblk, block), 1, 2)
    return (np.array(jnp.tile(blk, (batch // b0, 1, 1, 1))),
            np.array(jnp.tile(payloads, (batch // b0, 1, 1))))


def jax_score(blocks: np.ndarray, nf: int = NF):
    """The JAX tool's ``run(use_pallas=False)`` scoring, returning its
    tensors (got, have) before they are counted."""
    batch = blocks.shape[0]
    st = jrx.RxSessionState.init(batch)
    got = jnp.zeros((batch, nf, 16), jnp.uint8)
    have = jnp.zeros((batch, nf), bool)
    for i in range(blocks.shape[1]):
        out, st = jrx.rx_block(jnp.asarray(blocks[:, i]), st, use_pallas=False)
        fn = out.stream_fn.astype(jnp.int32)
        for s in range(fn.shape[1]):
            ok = out.stream_valid[:, s] & (fn[:, s] < nf)
            idx = jnp.clip(fn[:, s], 0, nf - 1)
            onehot = (jnp.arange(nf)[None, :] == idx[:, None]) & ok[:, None]
            got = jnp.where(onehot[..., None], out.stream_payload[:, s][:, None, :], got)
            have = have | onehot
    return got, have


@pytest.fixture(scope="module")
def session():
    return jax_session(B)


def test_session_matches_jax(session):
    blocks_j, expect_j = session
    blocks, expect = kv.session_blocks(B, "cpu")
    assert blocks.dtype == torch.float32 and blocks.shape == blocks_j.shape == (B, 13, 2, 1920)
    np.testing.assert_allclose(blocks.numpy(), blocks_j, rtol=0, atol=IQ_ATOL)
    np.testing.assert_array_equal(expect.numpy(), expect_j)


def test_plain_leg_scores_jax_session_as_jax_does(session):
    blocks_j, expect_j = session
    res = kv.score(torch.as_tensor(blocks_j), torch.as_tensor(expect_j), use_kernel=False)
    got_j, have_j = jax_score(blocks_j)
    have_j, got_j = np.asarray(have_j), np.asarray(got_j)
    assert int(res.frames) == have_j.sum() == B * NF
    assert int(res.byte_errors) == 0
    assert (np.not_equal(got_j, expect_j) & have_j[..., None]).sum() == 0
    np.testing.assert_array_equal(res.have.numpy(), have_j)
    np.testing.assert_array_equal(res.got.numpy(), got_j)


def test_score_counts_a_wrong_payload(session):
    """A payload sent differs from the one expected: its 16 bytes count."""
    blocks_j, expect_j = session
    expect = torch.as_tensor(expect_j).clone()
    expect[3, 1] ^= 0xFF
    res = kv.score(torch.as_tensor(blocks_j[:, :7]), expect, use_kernel=False)
    assert bool(res.have[3, 1]) and int(res.byte_errors) == 16
    assert 0 < int(res.frames) < B * NF        # 7 of 13 blocks: part of the session


def test_cli_on_cpu(capsys):
    assert kv.main(["--batch", str(B), "--device", "cpu"]) == 0
    io = capsys.readouterr()
    doc = json.loads(io.out.strip().splitlines()[-1])
    # the JAX tool's keys, its legs renamed: xla -> plain, pallas -> kernel
    assert set(doc) == (JAX_KEYS - {"xla", "pallas"}) | {"plain", "kernel"}
    assert doc == {"platform": "cpu", "plain": {"frames": B * NF, "byte_errors": 0},
                   "kernel": {"frames": B * NF, "byte_errors": 0},
                   "expected_frames": B * NF, "ok": True}
    assert "both legs are the plain versions" in io.err
    assert "plain leg: 13 blocks x 64 channels" in io.err


def test_batch_must_be_a_multiple_of_64():
    with pytest.raises(SystemExit):
        kv.main(["--batch", "96", "--device", "cpu"])
    with pytest.raises(ValueError):
        kv.session_blocks(96, "cpu")


def test_device_cuda_without_card_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kv.main([]) == 1
    assert kv.main(["--batch", str(B), "--device", "cuda"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
