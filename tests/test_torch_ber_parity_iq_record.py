"""The port's IQ decode against the committed IQ-domain parity record
(BER_PARITY_IQ_r5.json) at its full size, 16 channels x 16 frames, on the
CPU.

Every point's wire is JAX's own (``make_iq_wire`` with the record's seed
scheme, seed 0 + 1000 x the point's index in its config, so the very
samples the record's ``jax`` side decoded); the port decodes all 14 in one
``rx_stream`` call and each point's score must equal the recorded ``jax``
tuple exactly.  This holds the port's front end and decode to the record
point by point, where the card's replay (chip_smoke.py phase 18) can only
draw its own noise and meet the record's two-proportion predicates.  In a
file of its own, so that it runs beside the others.

``python tests/test_torch_ber_parity_iq_record.py --spread`` prints the
frames the port recovers from JAX's wires at each config's 18 dB point
over the record's seed and 8 further seeds: the spread of the draw.
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

from m17_sdr_tpu.pipeline import ber_parity_iq as j_biq  # noqa: E402
from m17_sdr_tpu_torch.pipeline import ber_parity as t_bp  # noqa: E402
from m17_sdr_tpu_torch.pipeline import ber_parity_iq as t_biq  # noqa: E402

torch.set_num_threads(2)
RECORD = json.loads((Path(__file__).resolve().parents[1] / "BER_PARITY_IQ_r5.json").read_text())
POINTS = [(name, i) for name, cfg in RECORD["configs"].items()
          for i in range(len(cfg["points"]))]


@pytest.fixture(scope="module")
def scores():
    """{(config, index): the port's score of JAX's wire at that point}."""
    nch, nf = RECORD["channels"], RECORD["frames"]
    wires, payloads = [], []
    for name, i in POINTS:
        row = RECORD["configs"][name]["points"][i]
        w, p = j_biq.make_iq_wire(nch, nf, row["snr_db"], seed=t_bp.SEED_BASE + t_bp.SEED_STEP * i,
                                  freq_offset_hz=t_biq.config_offset_hz(name))
        wires.append(w)
        payloads.append(p)
    dec = t_biq.run_chain_iq(np.concatenate(wires), device="cpu")
    return {pt: t_bp.score(t_bp._channels(dec, k * nch, nch).stream, p, RECORD["min_fn_scored"])
            for k, (pt, p) in enumerate(zip(POINTS, payloads))}


@pytest.mark.parametrize("name, i", POINTS,
                         ids=[f"{n}-{RECORD['configs'][n]['points'][i]['snr_db']:g}dB"
                              for n, i in POINTS])
def test_port_decode_of_jax_wire_equals_record(scores, name, i):
    row = RECORD["configs"][name]["points"][i]
    assert scores[(name, i)] == t_bp._tuple(row["jax"])


def spread(snr_db: float = 18.0, draws: int = 8) -> None:
    """Print the frames the port recovers from JAX's wires at each config's
    ``snr_db`` point: the record's seed and ``draws`` further seeds, so a
    replay's own draw can be read against the draw's spread."""
    nch, nf, min_fn = RECORD["channels"], RECORD["frames"], RECORD["min_fn_scored"]
    for name, cfg in RECORD["configs"].items():
        i = next(i for i, r in enumerate(cfg["points"]) if r["snr_db"] == snr_db)
        seeds = [t_bp.SEED_BASE + t_bp.SEED_STEP * i + s for s in range(draws + 1)]
        made = [j_biq.make_iq_wire(nch, nf, snr_db, seed=s,
                                   freq_offset_hz=t_biq.config_offset_hz(name)) for s in seeds]
        dec = t_biq.run_chain_iq(np.concatenate([w for w, _ in made]), device="cpu")
        frames = [t_bp.score(t_bp._channels(dec, k * nch, nch).stream, p, min_fn)[0]
                  for k, (_, p) in enumerate(made)]
        print(f"{name} {snr_db:g} dB, JAX's draws at seeds {seeds[0]}-{seeds[-1]}: frames "
              f"{frames} of {nch * (nf - min_fn)}, mean {np.mean(frames):.2f}; recorded ref "
              f"{cfg['points'][i]['ref']['frames']}, jax {cfg['points'][i]['jax']['frames']}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--spread"]:
        sys.exit("usage: python tests/test_torch_ber_parity_iq_record.py --spread")
    jax.config.update("jax_platforms", "cpu")
    spread()
