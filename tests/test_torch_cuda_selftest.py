"""The port's Viterbi self-test (m17_sdr_tpu_torch/tools/cuda_selftest.py)
against the JAX tool (tools/tpu_selftest.py), on the CPU.

The JAX tool's steps live inside its ``main()``, so they are composed here
from the same JAX functions in its order.  On the CPU the port's tool
compares the plain decoder with itself, so what it is held to here is its
inputs (the JAX tool's draws, value for value), its encoder (the JAX
``conv_encode_bits`` exactly), its reference (``viterbi_decode_ref`` equal
to JAX's ``viterbi_decode_xla`` bit for bit on every input) and its
output's keys and checks.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m17_sdr_tpu.fec.conv import conv_encode_bits as j_encode
from m17_sdr_tpu.fec.viterbi import viterbi_decode_xla
from m17_sdr_tpu_torch.fec.viterbi import viterbi_decode_ref
from m17_sdr_tpu_torch.tools import cuda_selftest as st

torch.set_num_threads(2)
XLA_ROWS = 16            # rows of each input also decoded by JAX's XLA decoder
JAX_KEYS = {"platform", "checks", "bit_mismatches", "ok"}


def jax_tool_inputs() -> list[tuple[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """The JAX tool's (T, soft, bits, clean, noisy) for each T, by its own lines."""
    rng = np.random.default_rng(0)
    out = []
    for t_steps in [244, 148, 210, 201]:
        soft = rng.normal(size=(128, 2 * t_steps)).astype(np.float32)
        bits = rng.integers(0, 2, (128, t_steps - 4), dtype=np.uint8)
        coded = j_encode(jnp.asarray(bits))
        clean = jnp.where(coded > 0, 1.0, -1.0).astype(jnp.float32)
        noisy = clean + jnp.asarray(rng.normal(0, 0.5, clean.shape).astype(np.float32))
        out.append((t_steps, soft, bits, np.array(clean), np.array(noisy)))
    return out


@pytest.fixture(scope="module")
def jax_inputs():
    return jax_tool_inputs()


def test_draws_equal_the_jax_tools(jax_inputs):
    port = list(st.draws())
    assert [d.steps for d in port] == [x[0] for x in jax_inputs] == list(st.TRELLIS_STEPS)
    for d, (steps, soft, bits, clean, noisy) in zip(port, jax_inputs):
        np.testing.assert_array_equal(d.soft, soft, err_msg=f"soft T={steps}")
        np.testing.assert_array_equal(d.bits, bits, err_msg=f"bits T={steps}")
        got_clean = st.codewords(torch.as_tensor(d.bits))
        np.testing.assert_array_equal(got_clean.numpy(), clean, err_msg=f"clean T={steps}")
        np.testing.assert_array_equal((got_clean + torch.as_tensor(d.noise)).numpy(), noisy,
                                      err_msg=f"noisy T={steps}")


@pytest.mark.parametrize("i", range(4), ids=lambda i: f"t{st.TRELLIS_STEPS[i]}")
def test_conv_encode_bits_equals_jax(jax_inputs, i):
    from m17_sdr_tpu_torch.fec.conv import conv_encode_bits

    _, _, bits, _, _ = jax_inputs[i]
    got = conv_encode_bits(torch.as_tensor(bits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_encode(jnp.asarray(bits))))


@pytest.mark.parametrize("i", range(4), ids=lambda i: f"t{st.TRELLIS_STEPS[i]}")
def test_plain_decoder_equals_xla_on_every_input(jax_inputs, i):
    """The self-test's reference against JAX's: the random, clean and
    noisy inputs of one T, on their first XLA_ROWS rows; the clean decode
    inverts the encoder."""
    steps, soft, bits, clean, noisy = jax_inputs[i]
    for tag, x in (("random", soft), ("clean", clean), ("noisy", noisy)):
        x = x[:XLA_ROWS]
        got, _ = viterbi_decode_ref(torch.as_tensor(x))
        want = np.asarray(viterbi_decode_xla(jnp.asarray(x)))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{tag}_t{steps}")
        if tag == "clean":
            np.testing.assert_array_equal(got.numpy()[:, :steps - 4], bits[:XLA_ROWS])


def test_cpu_run_has_the_jax_tools_keys_and_checks(capsys):
    assert st.main(["--device", "cpu"]) == 0
    io = capsys.readouterr()
    doc = json.loads(io.out.strip().splitlines()[-1])
    assert set(doc) == JAX_KEYS
    assert doc["checks"] == [f"{tag}_t{t}" for t in (244, 148, 210, 201)
                             for tag in ("random", "clean", "noisy")]
    assert (doc["platform"], doc["bit_mismatches"], doc["ok"]) == ("cpu", 0, True)
    assert "both sides are the plain decoder" in io.err


def test_a_mismatch_fails(monkeypatch, capsys):
    """A decoder that flips one bit of every clean decode is caught."""
    def flip_clean(soft, use_kernel=None):
        bits, metric = viterbi_decode_ref(soft)
        if bool((soft.abs() == 1.0).all()):
            bits = bits.clone()
            bits[0, 0] ^= 1
        return bits, metric

    monkeypatch.setattr(st, "viterbi_decode", flip_clean)
    assert st.main(["--device", "cpu"]) == 1
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # each clean decode differs from the reference and from the payload by one bit
    assert (doc["bit_mismatches"], doc["ok"]) == (2 * len(st.TRELLIS_STEPS), False)


def test_device_cuda_without_card_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert st.main([]) == 1
    assert st.main(["--device", "cuda"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
