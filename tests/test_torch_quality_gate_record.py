"""The port's quality-gate harness against the committed record
(QUALITY_GATE_r5.json) at its full size, 32 channels x 24 frames, seed 0,
on the CPU.

``run_regimes`` builds the five numpy-noise regimes (AWGN 7, 10 and
14 dB, both ISI regimes) itself, the same samples as the JAX tool's.
The offset+drift and Pluto regimes draw ``jax.random`` noise in the JAX
tool, so their wires are JAX's own, built by the tool's lines, and the
port decodes and tallies them; the port's own builders, given JAX's
unit-noise draws, must give wires that decode to the record too (at the
record's 55680 samples ``timing_drift`` reads the last sample where JAX's
gather fills NaN, tests/test_torch_quality_gate.py).  Every regime must
equal the record:
exactly in every field but the quality extremes and ``eye_est_med``,
which may move by FLOAT_ABS (the port's stream quality may differ from
XLA's by about 1e-4 relative, tests/torch_parity.py).  In a file of its
own, so that it runs beside the others.

``python tests/test_torch_quality_gate_record.py --floor`` prints, for
each soft-domain regime at the record's size, the frame at its clean
floor with its quality in both packages (the same wave decoded by the
JAX package and by the port on the CPU) and the largest quality
difference over all delivered frames.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from m17_sdr_tpu_torch.tools import quality_gate as qg  # noqa: E402
from torch_parity import jax_offset_drift_wire, jax_pluto_wire  # noqa: E402

torch.set_num_threads(2)
RECORD = json.loads((Path(__file__).resolve().parents[1] / "QUALITY_GATE_r5.json").read_text())
FLOAT_ABS = 1e-3
FLOAT_KEYS = ("clean_quality_floor", "garbage_quality_ceiling", "eye_est_med")


NCH, NF = RECORD["channels"], RECORD["frames_per_session"]
JAX_WIRES = {qg.OFFSET_DRIFT: jax_offset_drift_wire, qg.PLUTO: jax_pluto_wire}
PORT_WIRES = {qg.OFFSET_DRIFT: qg.offset_drift_wire, qg.PLUTO: qg.pluto_wire}


@pytest.fixture(scope="module")
def jax_wires():
    """Each IQ regime's JAX wire, payloads and unit-noise draw."""
    return {name: build(NCH, NF, 0) for name, build in JAX_WIRES.items()}


@pytest.fixture(scope="module")
def doc(jax_wires):
    wires = {name: (torch.as_tensor(iq), pl) for name, (iq, pl, _) in jax_wires.items()}
    return qg.run_regimes(NCH, NF, 0, "cpu", wires=wires)


@pytest.fixture(scope="module")
def own_wire_regimes(jax_wires):
    """The IQ regimes' tallies on the port's own wires, built from JAX's
    unit-noise draws and decoded in one call."""
    made = {name: PORT_WIRES[name](NCH, NF, 0, "cpu", noise=torch.as_tensor(noise))
            for name, (_, _, noise) in jax_wires.items()}
    for name, (_, pl) in made.items():
        assert np.array_equal(pl, jax_wires[name][1])
    out, st = qg.decode_group(qg.IQ_REGIMES, (made[name][0] for name in qg.IQ_REGIMES), "cpu")
    return {name: qg.regime_tally(name, qg.channels(out, k * NCH, NCH), st, made[name][1], NF)
            for k, name in enumerate(qg.IQ_REGIMES)}


def assert_regime_equals_record(got: dict, name: str) -> None:
    want = RECORD["regimes"][name]
    assert set(got) == set(want)
    for key, value in want.items():
        if key in FLOAT_KEYS and value is not None:
            assert got[key] == pytest.approx(value, abs=FLOAT_ABS), key
        else:
            assert got[key] == value, key


def test_document_equals_record(doc):
    head = {k: v for k, v in doc.items() if k != "regimes"}
    assert head == {k: v for k, v in RECORD.items() if k != "regimes"}
    assert head["ok"] is True
    assert list(doc["regimes"]) == list(RECORD["regimes"]) == list(qg.REGIMES)


@pytest.mark.parametrize("name", qg.REGIMES)
def test_regime_equals_record(doc, name):
    assert_regime_equals_record(doc["regimes"][name], name)


@pytest.mark.parametrize("name", qg.IQ_REGIMES)
def test_own_wire_on_jax_noise_equals_record(own_wire_regimes, name):
    assert_regime_equals_record(own_wire_regimes[name], name)


def floor_frames() -> None:
    """Print each soft-domain regime's clean-floor frame at the record's
    size, its quality in the port and in JAX on the same wave, and the
    largest quality difference over all delivered frames."""
    import jax.numpy as jnp

    from m17_sdr_tpu.pipeline.rx import RxSessionState, rx_stream_soft

    nch, nf = NCH, NF
    for name in qg.REGIMES:
        if name in qg.IQ_REGIMES:
            continue
        wave, payloads = qg.regime_input(name, nch, nf, 0, "cpu")
        out_t, _ = qg.decode(name, wave, "cpu")
        out_j, _ = rx_stream_soft(jnp.asarray(wave.reshape(nch, -1, qg.CHUNK_2X)),
                                  RxSessionState.init(nch), equalize=qg.EQUALIZE.get(name, False))
        out_j = type(out_j)(*(torch.as_tensor(np.asarray(f).astype(np.int64)
                                              if np.asarray(f).dtype == np.uint32
                                              else np.array(f)) for f in out_j))
        rows_t, rows_j = qg.score(out_t, payloads, nf), qg.score(out_j, payloads, nf)
        q_t, q_j = (np.array([r[0] for r in rows]) for rows in (rows_t, rows_j))
        clean = np.array([r[2] == 0 for r in rows_t])
        i = int(np.argmin(np.where(clean, q_t, np.inf)))
        print(f"{name}: clean floor at channel {rows_t[i][5]}, quality {q_t[i]:.8f} in the "
              f"port, {q_j[i]:.8f} in JAX (rows agree in all but quality: "
              f"{[r[1:] for r in rows_t] == [r[1:] for r in rows_j]}); largest quality "
              f"difference over {len(rows_t)} frames {np.abs(q_t - q_j).max():.3g}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--floor"]:
        sys.exit("usage: python tests/test_torch_quality_gate_record.py --floor")
    jax.config.update("jax_platforms", "cpu")
    floor_frames()
