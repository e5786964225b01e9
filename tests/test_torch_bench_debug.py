"""The port's per-block timing harness (m17_sdr_tpu_torch/tools/bench_debug.py)
against the JAX tool (tools/bench_debug.py), at 64 channels on the CPU.

``gen`` is held within IQ_ATOL of the JAX tool's construction (its blocks
are those of tools/pallas_validate.py, composed in
tests/test_torch_kernel_validate.py by the JAX tool's own lines).  ``run``
over the first 3 of JAX's blocks must equal JAX's ``rx_block`` chain from a
fresh state on the same numpy blocks: its last output and final state,
integers exactly and floats within tests/torch_parity.py's tolerances.
``noise`` draws the JAX tool's ``default_rng(1)`` noise, on which no
channel locks at this size.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernel_validate import IQ_ATOL, jax_session
from torch_parity import assert_outputs_match, assert_states_match

from m17_sdr_tpu.pipeline import rx as jrx
from m17_sdr_tpu_torch.tools import bench_debug as bd
from m17_sdr_tpu_torch.tools.kernel_validate import session_blocks

torch.set_num_threads(2)
B = 64
RUN_BLOCKS = 3


@pytest.fixture(scope="module")
def jax_blocks() -> np.ndarray:
    return jax_session(B)[0]


@pytest.fixture
def saved(tmp_path, jax_blocks) -> str:
    """JAX's first RUN_BLOCKS blocks, saved where ``run`` reads them."""
    path = str(tmp_path / "blocks.npy")
    np.save(path, jax_blocks[:, :RUN_BLOCKS])
    return path


def test_gen_matches_jax(tmp_path, jax_blocks, capsys):
    path = tmp_path / "blocks.npy"
    assert bd.main(["gen", str(B), "--path", str(path), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == f"saved ({B}, 13, 2, 1920) float32"
    got = np.load(path)
    assert got.dtype == np.float32 and got.shape == jax_blocks.shape
    np.testing.assert_allclose(got, jax_blocks, rtol=0, atol=IQ_ATOL)
    # the validation gate's session, made by the same function
    np.testing.assert_array_equal(got, session_blocks(B, "cpu")[0].numpy())


def test_run_matches_jax_rx_block_chain(saved, capsys):
    data = np.load(saved)
    res = bd.run(data, "cpu")
    st = jrx.RxSessionState.init(B)
    for i in range(RUN_BLOCKS):
        out, st = jrx.rx_block(jnp.asarray(data[:, i]), st)
    assert_outputs_match(res.out, out)
    assert_states_match(res.state, st)
    assert np.asarray(out.locked).all()       # every channel has locked by block 3
    assert res.times_ms.shape == (RUN_BLOCKS,) and (res.times_ms > 0).all()
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("per-block ms: min=") and " all=[" in lines[0]
    assert lines[1].startswith("median throughput: ") and lines[1].endswith(" M samples/s")


def test_noise_mode_draws_the_jax_noise_and_hunts(saved, monkeypatch):
    shape = (B, RUN_BLOCKS, 2, 1920)
    noise = bd.noise(shape)
    np.testing.assert_array_equal(
        noise, np.random.default_rng(1).normal(size=shape).astype(np.float32))
    runs = []
    monkeypatch.setattr(bd, "run", lambda data, device: runs.append((data, device)))
    assert bd.main(["noise", "--path", saved, "--device", "cpu"]) == 0
    (data, device), = runs
    np.testing.assert_array_equal(data, noise)
    assert device == "cpu"
    monkeypatch.undo()
    res = bd.run(noise, "cpu")
    assert not res.out.locked.any() and not res.state.receiver.flock.any()
    assert int(res.state.n_frames.sum()) == 0


def test_run_mode_reads_the_path(saved, monkeypatch):
    runs = []
    monkeypatch.setattr(bd, "run", lambda data, device: runs.append((data, device)))
    assert bd.main(["run", "--path", saved, "--device", "cpu"]) == 0
    np.testing.assert_array_equal(runs[0][0], np.load(saved))


def test_gen_batch_must_be_a_multiple_of_64(tmp_path):
    with pytest.raises(SystemExit):
        bd.main(["gen", "100", "--path", str(tmp_path / "b.npy"), "--device", "cpu"])


def test_device_cuda_without_card_exits_1(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("gen", "run", "noise"):
        assert bd.main([mode, "--path", str(tmp_path / "b.npy")]) == 1
    assert not (tmp_path / "b.npy").exists()
    assert "no CUDA device" in capsys.readouterr().err
