"""The port's mesh layer (``m17_sdr_tpu_torch.mesh``), the sharded BER
sweep, ``sweep --pod`` and the dry run, across processes on the CPU.

Ranks are gloo processes started by the port's launcher
(``mesh.launch.spawn``, one thread a rank); their bodies are in
tests/torch_mesh_workers.py, which imports no JAX, and write their shards
to an .npz that the test reads.  Each test mirrors one of
tests/test_mesh.py (and tests/test_multihost.py) and holds the port to the
JAX package on the same inputs: JAX's own functions on conftest's virtual
CPU devices.  Integer, bool and byte fields are exact; sharded and
unsharded port runs are held bit for bit; port against JAX floats to
torch_parity's FLOAT_RTOL/FLOAT_ATOL.
"""

from __future__ import annotations

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_workers
from test_pipeline import _mk_lsf, _payloads
from torch_parity import assert_same

from m17_sdr_tpu.app.checkpoint import _flatten_with_paths
from m17_sdr_tpu.mesh import halo as j_halo
from m17_sdr_tpu.mesh import sharding as j_sharding
from m17_sdr_tpu.pipeline import ber_sweep as j_sweep
from m17_sdr_tpu.pipeline import loopback as j_lb
from m17_sdr_tpu.pipeline import tx as j_tx
from m17_sdr_tpu.pipeline.rx import RxSessionState as JState
from m17_sdr_tpu.pipeline.rx import rx_stream as j_rx_stream
from m17_sdr_tpu_torch import entry
from m17_sdr_tpu_torch.convert import state_to_numpy
from m17_sdr_tpu_torch.mesh import launch
from m17_sdr_tpu_torch.pipeline import ber_sweep as t_sweep
from m17_sdr_tpu_torch.pipeline.rx import RxSessionState, rx_stream

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
BLOCK = 1920
WARMUP = 3
SLAB_RANKS = 4
FIR_TOL = 1e-5                 # tests/test_mesh.py's bound for the split FIR
POD_B, POD_NF, POD_SEED = 32, 6, 7
POD_SNR = np.repeat(np.float32([6.0, 30.0]), POD_B // 2)


def _session_blocks(b, nf=4, seed=0):
    """JAX TX voice sessions as [B, NBLK, 2, T] float32 blocks, and payloads."""
    pl = _payloads(b, nf, seed)
    iq, _ = j_tx.dibits_to_iq(j_tx.build_voice_session_dibits(_mk_lsf(b), pl))
    return np.array(j_lb._blockify(iq)), np.asarray(pl)


@pytest.fixture(scope="module")
def channel_blocks():
    return _session_blocks(8)[0]


@pytest.fixture(scope="module")
def four_sessions():
    """Four voice sessions back to back at B=2, cut to a multiple of the
    slab ranks (tests/test_mesh.py:106)."""
    iq = np.concatenate([np.asarray(j_tx.dibits_to_iq(j_tx.build_voice_session_dibits(
        _mk_lsf(2), _payloads(2, 4, s)))[0]) for s in range(4)], axis=-1)
    blocks = np.asarray(j_lb._blockify(jnp.asarray(iq), BLOCK))
    return blocks[:, : blocks.shape[1] - blocks.shape[1] % SLAB_RANKS]


@pytest.fixture(scope="module")
def adversarial():
    """tests/test_mesh.py:147's 56-block capture at B=1: sessions of 12, 3
    and 6 frames starting at blocks 2, 25 and 42, so that at 4 ranks (slabs
    of 14 blocks) one spans a boundary mid-session and one starts on one.
    Returns (blocks, the (fn, payload) set sent)."""
    sig = np.zeros((1, 2, 56 * BLOCK), np.float32)
    sent, pos = set(), 0
    for i, (off, nf) in enumerate(zip([2, 5, 8], [12, 3, 6])):
        pl = _payloads(1, nf, 10 + i)
        iq = np.asarray(j_tx.dibits_to_iq(j_tx.build_voice_session_dibits(_mk_lsf(1), pl))[0])
        start = (pos + off) * BLOCK
        sig[:, :, start:start + iq.shape[-1]] = iq
        sent |= {(f, bytes(p)) for f, p in enumerate(np.asarray(pl)[0])}
        pos += off + iq.shape[-1] // BLOCK + 1
    return np.asarray(j_lb._blockify(jnp.asarray(sig), BLOCK)), sent


def _jax_keys():
    return jax.random.split(jax.random.PRNGKey(POD_SEED), POD_B)


@pytest.fixture(scope="module")
def pod_jax_noise():
    """JAX's per-channel sweep noise: normal(key_c, [2, T]) for each key."""
    shape = (2, 10 * j_tx.build_bert_session_dibits(1, POD_NF).shape[1])
    return np.array(jax.vmap(lambda k: jax.random.normal(k, shape))(_jax_keys()))


def _spawn(n, jobs, tmp: Path) -> list[dict]:
    tmp.mkdir()
    np.savez(tmp / "in.npz", **jobs)
    launch.spawn(torch_mesh_workers.run_jobs, n, str(tmp / "in.npz"), str(tmp), device="cpu")
    out = []
    for r in range(n):
        with np.load(tmp / f"rank{r}.npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


class _Ranks:
    """Each rank's results at world sizes 2 and 4: both worlds start at
    once, and run while the test process computes its JAX references."""

    def __init__(self, base: Path, jobs: dict):
        self._pool = ThreadPoolExecutor(max_workers=len(jobs))
        self._runs = {n: self._pool.submit(_spawn, n, j, base / f"w{n}") for n, j in jobs.items()}

    def __getitem__(self, n: int) -> list[dict]:
        return self._runs[n].result(timeout=600)

    def close(self):
        self._pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, channel_blocks, four_sessions, adversarial, pod_jax_noise):
    x = np.random.default_rng(0).normal(size=(4, 8 * 256)).astype(np.float32)
    taps = np.random.default_rng(0).normal(size=31).astype(np.float32)
    common = {"ch_blocks": channel_blocks, "pod0_snr": POD_SNR, "pod0_frames": POD_NF,
              "pod0_seed": POD_SEED}
    # the 2-rank world also runs the slabs' sequential references
    two = {**common, "seq0_blocks": adversarial[0], "seq1_blocks": four_sessions}
    four = {**common, "fir_x": x, "fir_taps": taps,
            "slab0_blocks": four_sessions, "slab0_warmup": WARMUP,
            "slab1_blocks": adversarial[0], "slab1_warmup": WARMUP,
            "pod1_snr": POD_SNR, "pod1_frames": POD_NF, "pod1_noise": pod_jax_noise}
    runs = _Ranks(tmp_path_factory.mktemp("mesh"), {2: two, 4: four})
    yield runs
    runs.close()


@pytest.fixture(scope="module")
def local_refs(ranks, channel_blocks):
    """The port's unsharded rx_stream of the channel blocks and its keyed
    sweep, beside JAX's rx_stream of the same blocks."""
    b = channel_blocks.shape[0]
    out_t, st_t = rx_stream(torch.as_tensor(channel_blocks), RxSessionState.init(b, "cpu"))
    out_j, st_j = j_rx_stream(jnp.asarray(channel_blocks), JState.init(b))
    sweep = t_sweep.bert_sweep_counts(torch.as_tensor(POD_SNR), POD_NF, seed=POD_SEED)
    return out_t, st_t, out_j, st_j, sweep


def _gather(parts: list[dict], prefix: str, axis: int) -> dict:
    keys = [k for k in parts[0] if k.startswith(prefix + "/")]
    return {k[len(prefix) + 1:]: np.concatenate([p[k] for p in parts], axis=axis) for k in keys}


def _frames(out: dict, ch: int) -> set:
    b = out["stream_valid"].shape[0]
    v = out["stream_valid"].reshape(b, -1)[ch]
    fn = out["stream_fn"].reshape(b, -1)[ch]
    pl = out["stream_payload"].reshape(b, -1, 16)[ch]
    return {(int(f), bytes(p)) for f, p in zip(fn[v], pl[v])}


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_rx_stream_equals_local_and_jax(ranks, local_refs, n):
    """tests/test_mesh.py:65: the channel-sharded stream equals the port's
    unsharded rx_stream bit for bit and JAX's field by field; the reduced
    metrics equal the local sums; replicate gives rank 0's tensor."""
    out_t, st_t, out_j, st_j, _ = local_refs
    got = _gather(ranks[n], "ch", 0)
    got_state = _gather(ranks[n], "ch_state", 0)
    for name in out_t._fields:
        np.testing.assert_array_equal(got[name], getattr(out_t, name).numpy(), err_msg=name)
        assert_same(name, got[name], np.asarray(getattr(out_j, name)))
    want_state, want_j = state_to_numpy(st_t), _flatten_with_paths(st_j)
    assert set(got_state) == set(want_state) == set(want_j)
    for k in want_state:
        np.testing.assert_array_equal(got_state[k], want_state[k], err_msg=k)
        assert_same(k, got_state[k], want_j[k])
    local = [float(st_t.n_frames.sum()), float(st_t.golay_errors.sum()),
             float(out_t.locked[:, -1].sum())]
    assert local[0] > 0
    for part in ranks[n]:
        np.testing.assert_array_equal(part["ch_metrics"], np.float32(local))
        np.testing.assert_array_equal(part["replicated"], [0])


def test_overlap_save_split_equals_unsplit(ranks):
    """tests/test_mesh.py:90: the FIR split over 4 ranks equals the unsplit
    causal FIR within 1e-5."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 8 * 256)).astype(np.float32)
    taps = np.random.default_rng(0).normal(size=31).astype(np.float32)
    xp = np.pad(x, [(0, 0), (30, 0)])
    want = xp[:, np.arange(x.shape[-1])[:, None] + np.arange(31)[None, :]] @ taps
    got = np.concatenate([p["fir_y"] for p in ranks[4]], axis=-1)
    np.testing.assert_allclose(got, want, rtol=FIR_TOL, atol=FIR_TOL)


def test_time_parallel_rx_equals_jax_and_recovers_frames(ranks, four_sessions):
    """tests/test_mesh.py:105: 4 time slabs with 3 warm-up blocks equal
    JAX's time_parallel_rx on a 4-device mesh field by field, and recover
    every (fn, payload) the sequential run recovers."""
    got = _gather(ranks[SLAB_RANKS], "slab0", 1)
    mesh = j_sharding.make_mesh(SLAB_RANKS)
    out_j = j_halo.time_parallel_rx(mesh, warmup_blocks=WARMUP, block=BLOCK)(
        jnp.asarray(four_sessions))
    for name in out_j._fields:
        assert_same(name, got[name], np.asarray(getattr(out_j, name)))
    ref = _gather(ranks[2][1:], "seq1", 0)      # run by rank 1 of the 2-rank world
    for ch in range(four_sessions.shape[0]):
        assert _frames(ref, ch), "the sequential run recovered nothing"
        assert not _frames(ref, ch) - _frames(got, ch), f"channel {ch} lost frames"


def test_zero_frame_loss_at_adversarial_alignment(ranks, adversarial):
    """tests/test_mesh.py:147: with 3 warm-up blocks no (fn, payload) of the
    sequential run is lost, sessions placed across slab boundaries."""
    blocks, sent = adversarial
    got = _gather(ranks[SLAB_RANKS], "slab1", 1)
    ref_set = _frames(_gather(ranks[2][:1], "seq0", 0), 0)   # run by rank 0 of 2
    assert len(ref_set & sent) >= len(sent) - 3
    missing = ref_set - _frames(got, 0)
    assert not missing, f"lost {len(missing)} frames: {sorted(missing)[:4]}"


@pytest.mark.parametrize("n", [2, 4])
def test_pod_sweep_sharded_equals_unsharded(ranks, local_refs, n):
    """tests/test_mesh.py:38: the sweep over n ranks, noise keyed per
    channel, equals the unsharded keyed sweep bit for bit; the totals are
    the sums; the 30 dB half decodes frames with no bit error."""
    want = local_refs[4]
    got = np.concatenate([p["pod0_counts"] for p in ranks[n]], axis=1)
    for i, name in enumerate(("errors", "bits", "unsynced", "frames")):
        np.testing.assert_array_equal(got[i], want[i].numpy(), err_msg=name)
    for p in ranks[n]:
        np.testing.assert_array_equal(p["pod0_totals"], [int(w.sum()) for w in want])
    half = POD_B // 2
    assert int(want[3][half:].sum()) > 0 and int(want[0][half:].sum()) == 0


def test_pod_sweep_on_jax_noise_equals_jax(ranks):
    """The sweep over 4 ranks on JAX's per-channel noise equals JAX's
    pod_bert_sweep on a 4-device mesh, counter by counter."""
    *want, totals = j_sweep.pod_bert_sweep(j_sharding.make_mesh(4), _jax_keys(),
                                           jnp.asarray(POD_SNR), POD_NF)
    got = np.concatenate([p["pod1_counts"] for p in ranks[4]], axis=1)
    for i, name in enumerate(("errors", "bits", "unsynced", "frames")):
        np.testing.assert_array_equal(got[i], np.asarray(want[i]), err_msg=name)
    np.testing.assert_array_equal(ranks[4][0]["pod1_totals"], np.asarray(totals))


def test_keyed_noise_depends_only_on_seed_and_channel():
    from m17_sdr_tpu_torch.dsp.channel import keyed_noise

    whole = keyed_noise((6, 2, 40), 3, 0, "cpu")
    np.testing.assert_array_equal(keyed_noise((2, 2, 40), 3, 4, "cpu").numpy(),
                                  whole[4:].numpy())
    assert not torch.equal(keyed_noise((6, 2, 40), 4, 0, "cpu"), whole)
    with pytest.raises(ValueError):
        keyed_noise((1, 2, 4), -1, 0, "cpu")


def test_spawn_defaults_to_the_card(monkeypatch):
    """Like every entry point of the port, the launcher runs its ranks on
    the card unless the caller asks for the CPU."""
    seen = {}

    def fake_spawn(fn, args, nprocs, join):
        seen["device"], seen["nprocs"] = args[3], nprocs

    monkeypatch.setattr(torch.multiprocessing, "spawn", fake_spawn)
    launch.spawn(torch_mesh_workers.run_jobs, 2)
    assert seen == {"device": "cuda", "nprocs": 2}
    launch.spawn(torch_mesh_workers.run_jobs, 2, device="cpu")
    assert seen["device"] == "cpu"


def _sweep_pod(*prefix: str) -> dict:
    r = subprocess.run(
        [sys.executable, *prefix, "-m", "m17_sdr_tpu_torch.app.main", "--device", "cpu",
         "sweep", "--pod", "--points", "4", "--channels", "16", "--frames", "4",
         "--snr-min", "6", "--snr-step", "8", "--seed", "3"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_sweep_pod_two_processes_equal_one():
    """tests/test_multihost.py:19: sweep --pod under a 2-process torchrun
    prints the points and totals of the 1-process run, with the JAX CLI's
    keys; the totals are the points' sums."""
    one = _sweep_pod()
    two = _sweep_pod("-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2")
    assert set(one) == {"mesh_devices", "channels", "totals_psum", "points"}
    assert (one["mesh_devices"], two["mesh_devices"]) == (1, 2)
    assert one["channels"] == two["channels"] == 16
    assert one["points"] == two["points"] and one["totals_psum"] == two["totals_psum"]
    pts = one["points"]
    assert one["totals_psum"][1] == sum(p["bits"] for p in pts) > 0
    assert one["totals_psum"][0] == sum(p["bit_errors"] for p in pts)
    assert one["totals_psum"][3] == sum(p["frames_recovered"] for p in pts)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip_runs(n):
    """__graft_entry__.dryrun_multichip's counterpart: channel sharding at
    1 and 2 ranks, the 2 x 2 ch x time mesh at 4."""
    entry.dryrun_multichip(n, "cpu")
