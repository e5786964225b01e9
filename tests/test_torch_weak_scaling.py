"""The port's weak-scaling tool (m17_sdr_tpu_torch/tools/weak_scaling.py)
on gloo ranks on the CPU: N = 1 and 2 ranks at 8 channels a rank and 2
blocks.

Its two legs must compute the same thing, so each rank checks its legs'
outputs and final states equal exactly.  The nocomm leg's last output and
state, which the rank keeps, must equal the port's unsharded ``rx_stream``
of the rank's rows of the JAX tool's draw in this process exactly, and
the JAX package's ``rx_stream`` of the same rows within
tests/torch_parity.py's tolerances (integers exact, floats rtol 1e-3,
atol 1e-5): two calls from a fresh state, the warm call and a rep's.
The sharded leg's reduced metrics must be the sum of the ranks' own, and
the document's derived numbers must recompute from its times.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_outputs_match, assert_states_match

from m17_sdr_tpu.pipeline import rx as jrx
from m17_sdr_tpu_torch.convert import state_from_numpy, state_to_numpy
from m17_sdr_tpu_torch.pipeline.rx import RxBlockOutput, RxSessionState, rx_stream
from m17_sdr_tpu_torch.tools import weak_scaling as ws

CH, NBLK, REPS = 8, 2, 2


@pytest.fixture(scope="module")
def points():
    return {n: ws.run_point(n, CH, NBLK, "cpu", reps=REPS) for n in (1, 2)}


def rank_iq(n: int, r: int) -> np.ndarray:
    """Rank r's rows of the JAX tool's draw at world size n."""
    iq = np.random.default_rng(0).normal(size=(n * CH, NBLK, 2, 1920)).astype(np.float32)
    return iq[r * CH:(r + 1) * CH]


def kept(res: dict) -> tuple[RxBlockOutput, RxSessionState]:
    """The nocomm leg's last output and state that a rank kept."""
    out = RxBlockOutput(**{f: torch.as_tensor(res[f"out/{f}"]) for f in RxBlockOutput._fields})
    state = state_from_numpy({k[len("state/"):]: v for k, v in res.items()
                              if k.startswith("state/")}, "cpu")
    return out, state


def test_rank_rows_are_the_jax_draw():
    shape = (4 * CH, NBLK, 2, 1920)
    full = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    for r in range(4):
        np.testing.assert_array_equal(ws.rank_rows(0, shape, r, 4), full[r * CH:(r + 1) * CH])


@pytest.mark.parametrize("n", [1, 2])
def test_legs_equal_and_equal_rx_stream(points, n):
    point, ranks = points[n]
    assert point["legs_equal"] and len(ranks) == n
    assert CH <= ws.KEPT                # the rank keeps all its channels
    for r, res in enumerate(ranks):
        iq = torch.as_tensor(rank_iq(n, r))
        out, state = rx_stream(iq, RxSessionState.init(CH, "cpu"))
        # every rep starts from the state the warm nocomm call left
        out, state = rx_stream(iq, state)
        for name, want in out._asdict().items():
            np.testing.assert_array_equal(res[f"out/{name}"], want.numpy(),
                                          err_msg=f"rank {r} {name}")
        for key, want in state_to_numpy(state).items():
            np.testing.assert_array_equal(res[f"state/{key}"], want,
                                          err_msg=f"rank {r} state {key}")


@pytest.mark.parametrize("n", [1, 2])
def test_nocomm_leg_matches_jax_rx_stream(points, n):
    _, ranks = points[n]
    for r, res in enumerate(ranks):
        iq = jnp.asarray(rank_iq(n, r))
        out_j, st_j = jrx.rx_stream(iq, jrx.RxSessionState.init(CH))
        out_j, st_j = jrx.rx_stream(iq, st_j)
        out_t, st_t = kept(res)
        assert_outputs_match(out_t, out_j)
        assert_states_match(st_t, st_j)


@pytest.mark.parametrize("n", [1, 2])
def test_reduced_metrics_are_the_ranks_sums(points, n):
    point, ranks = points[n]
    assert point["metrics_equal_sum"]
    for res in ranks:
        np.testing.assert_array_equal(res["metrics"], sum(x["own"] for x in ranks))
        frames = res["state/n_frames"].sum()
        assert res["own"][0] == frames


@pytest.mark.parametrize("n", [1, 2])
def test_point_recomputes_from_times(points, n):
    point, ranks = points[n]
    times = ranks[0]["times"]
    assert times.shape == (2, REPS) and (times > 0).all()
    for res in ranks:                  # every rank holds the max-reduced times
        np.testing.assert_array_equal(res["times"], times)
    assert (point["devices"], point["channels"], point["blocks"]) == (n, n * CH, NBLK)
    assert point["t_nocomm_s"] == times[0].min() and point["t_sharded_s"] == times[1].min()
    assert point["samples_processed"] == n * CH * NBLK * 1920
    assert point["sharding_efficiency"] == round(point["t_nocomm_s"] / point["t_sharded_s"], 4)
    assert point["kernel_launches"] == {"m17_viterbi_decode": 0, "m17_receiver_scan": 0,
                                        "m17_front_end": 0, "m17_equalize": 0,
                                        "m17_compact": 0}


def test_document_and_world_sizes(points):
    doc = ws.document([points[1][0], points[2][0]], CH, "cpu")
    assert {"methodology", "ch_per_dev", "points"} <= set(doc)
    assert (doc["ch_per_dev"], doc["device"], doc["backend"], doc["ranks"]) == (
        CH, "cpu", "gloo", [1, 2])
    assert ws.world_sizes("cpu") == [1, 2, 4, 8]


def test_device_cuda_without_card_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ws.main([str(CH), str(NBLK)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
