"""The port's Viterbi decoder: the plain version against the JAX XLA
decoder and the Pallas kernel (interpreted), and the dispatch rule.
The kernel itself is tested on the card by tests/test_torch_cuda.py."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m17_sdr_tpu.fec.viterbi import viterbi_decode_xla
from m17_sdr_tpu.fec.viterbi_pallas import viterbi_decode_pallas
from m17_sdr_tpu_torch.fec import viterbi as tv
from m17_sdr_tpu_torch.fec.conv import conv_encode_bits

torch.set_num_threads(2)

# the M17 trellis lengths: LSF, stream, packet, 201 BERT data bits + tail
# (as in tests/test_viterbi_pallas.py), and the BERT trellis of rx_frames
FRAME_STEPS = [244, 148, 210, 201, 205]


def _soft(steps: int, shape=(9,)) -> np.ndarray:
    rng = np.random.default_rng(steps)
    soft = rng.normal(size=(*shape, 2 * steps)).astype(np.float32)
    soft[..., ::7] = 0.0                   # depunctured erasures
    return soft


@pytest.mark.parametrize("steps", FRAME_STEPS)
def test_ref_matches_xla_and_pallas(steps):
    soft = _soft(steps)
    bits_t, met_t = tv.viterbi_decode_ref(torch.as_tensor(soft))
    bits_x, met_x = viterbi_decode_xla(jnp.asarray(soft), return_metric=True)
    bits_p, met_p = viterbi_decode_pallas(jnp.asarray(soft), return_metric=True,
                                          interpret=True)
    np.testing.assert_array_equal(bits_t.numpy(), np.asarray(bits_x))
    np.testing.assert_array_equal(bits_t.numpy(), np.asarray(bits_p))
    np.testing.assert_allclose(met_t.numpy(), np.asarray(met_x), rtol=1e-4)
    np.testing.assert_allclose(met_t.numpy(), np.asarray(met_p), rtol=1e-4)


def test_ref_batch_shapes_and_clean_codeword():
    soft = _soft(148, (2, 3))
    bits_t, met_t = tv.viterbi_decode_ref(torch.as_tensor(soft))
    bits_x, _ = viterbi_decode_xla(jnp.asarray(soft), return_metric=True)
    assert bits_t.shape == (2, 3, 148) and met_t.shape == (2, 3)
    np.testing.assert_array_equal(bits_t.numpy(), np.asarray(bits_x))

    rng = np.random.default_rng(7)
    bits = torch.as_tensor(rng.integers(0, 2, (5, 144), dtype=np.uint8))
    coded = conv_encode_bits(bits).to(torch.float32) * 2 - 1
    out, metric = tv.viterbi_decode(coded)
    np.testing.assert_array_equal(out[:, :144].numpy(), bits.numpy())
    assert not out[:, 144:].any()                              # zero tail
    np.testing.assert_array_equal(metric.numpy(), np.full(5, 2.0 * 148, np.float32))


def test_dispatch_on_cpu():
    soft = torch.as_tensor(_soft(148, (3,)))
    bits, metric = tv.viterbi_decode(soft)                     # CPU: plain version
    ref_bits, ref_metric = tv.viterbi_decode_ref(soft)
    assert torch.equal(bits, ref_bits) and torch.equal(metric, ref_metric)
    assert torch.equal(tv.viterbi_decode(soft, use_kernel=False)[0], ref_bits)
    with pytest.raises(ValueError):
        tv.viterbi_decode(soft, use_kernel=True)
    with pytest.raises(ValueError):
        tv.viterbi_decode_cuda(soft)


def test_goldens():
    """The C++ reference's decodes; it emits each bit one step later
    than this decoder, so its bit i+1 is our bit i."""
    from pathlib import Path

    gold = {}
    for line in (Path(__file__).parent / "goldens" / "goldens.txt").read_text().splitlines():
        name, _, *vals = line.split()
        gold[name] = np.array([float(v) for v in vals])
    for soft, want in ((gold["conv_out_bits"] * 2 - 1, gold["viterbi_clean_out"]),
                       (gold["viterbi_noisy_in"], gold["viterbi_noisy_out"])):
        bits, _ = tv.viterbi_decode(torch.as_tensor(soft, dtype=torch.float32))
        np.testing.assert_array_equal(bits[:243].numpy(), want[1:244].astype(np.uint8))
