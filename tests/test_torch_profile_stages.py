"""The port's stage profiler (m17_sdr_tpu_torch.tools.profile_stages)
against the JAX tool (tools/profile_stages.py), at B=16 on the CPU.

The JAX tool's stage bodies are closures inside its ``main()``, so they
are composed here from the same JAX functions in the same way.  Inputs
are JAX's own bench blocks (``make_bench_blocks(64)``, first 16
channels), its front end's soft blocks and the ``default_rng(1)`` draws,
passed to both packages as numpy arrays.  Integer, bool and byte fields
must be equal, float fields within tests/torch_parity.py's tolerance.

JAX's ``kernel_only`` runs the Pallas receiver scan, which needs
B % 1024 == 0 and packs slot values to 2^-11; here it runs through its
plain reference, the hoisted filter bank and ``lax.scan(_scan_step)`` of
``receive_block``, with the flags packed in the Pallas kernel's layout.
That is the formulation the port's kernel and plain scan both equal.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_outputs_match, assert_same, assert_states_match

from m17_sdr_tpu.dsp import discriminator as jd
from m17_sdr_tpu.fec.viterbi_pallas import viterbi_decode_pallas
from m17_sdr_tpu.frame import receiver as jr
from m17_sdr_tpu.frame import receiver_pallas as jp
from m17_sdr_tpu.frame import rx_frames as jf
from m17_sdr_tpu.pipeline import benchdata as jbench
from m17_sdr_tpu.pipeline import rx as jrx
from m17_sdr_tpu_torch.dsp import discriminator as td
from m17_sdr_tpu_torch.frame import receiver as tr
from m17_sdr_tpu_torch.pipeline import rx as trx
from m17_sdr_tpu_torch.tools import profile_stages as ps

torch.set_num_threads(2)
B = 16
BENCH_LSB = 8            # the port's bench mix against JAX's (tests/test_torch_tx.py)
RECORD = json.loads((Path(__file__).resolve().parents[1] / "PROFILE_r5.json").read_text())
# the record's stage names -> the port's on the CPU (JAX's Pallas legs run
# on its TPU only; the port's kernel legs on the card only)
CPU_NAMES = {"rx_xla": "rx_plain", "recv_xla": "recv_plain", "rx_session": "rx_session",
             "front_end": "front_end", "viterbi4096": "viterbi4096",
             "decode_typed": "decode_typed"}


@pytest.fixture(scope="module")
def jax_inputs():
    """JAX's stage inputs at B=16, as numpy arrays."""
    blocks, nblk = jbench.make_bench_blocks(64, 1920)
    blocks = [np.asarray(b)[:B] for b in blocks]
    fe = jd.RxFrontEndState.init(B)
    inf = jnp.zeros(B, bool)
    soft = []
    for blk in blocks:
        dec, _, fe = jd.rx_front_end(jnp.asarray(blk), fe, inf)
        soft.append(np.asarray(dec))
    rng = np.random.default_rng(1)
    vit_soft = rng.normal(size=(B, 296)).astype(np.float32)
    frames = rng.normal(size=(B * 3, 192)).astype(np.float32)
    return {"blocks": blocks, "soft": soft, "vit_soft": vit_soft, "frames": frames,
            "session": np.concatenate(blocks, axis=-1), "nblk": nblk}


def t(x: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.array(x))


def assert_tuple_match(what: str, got, want) -> None:
    for name in want._fields:
        assert_same(f"{what} {name}", getattr(got, name), getattr(want, name))


@jax.jit
def jax_kernel_only(soft, state):
    """The JAX tool's ``kernel_only_block`` with the scan's plain reference."""
    ext = jnp.concatenate([state.window[:, 1:], soft], axis=-1)
    kern = jnp.asarray(np.concatenate([jr._MF_BANK, jr._DMF_BANK], axis=0))
    mf = jax.lax.conv_general_dilated(
        ext[:, None, :].astype(jnp.bfloat16), kern[:, None, :].astype(jnp.bfloat16),
        window_strides=(1,), padding="VALID", dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.bfloat16)
    st2, ys = jax.lax.scan(jr._scan_step, state, jnp.moveaxis(mf, 2, 0))
    slot, valid, done, stype, parse, aos, los, slip, slipped = (y.T for y in ys)
    i32 = jnp.int32
    flags = (valid.astype(i32) * jp.F_VALID + done.astype(i32) * jp.F_DONE
             + parse.astype(i32) * jp.F_PARSE + aos.astype(i32) * jp.F_AOS
             + los.astype(i32) * jp.F_LOS + slip.astype(i32) * jp.F_SLIP
             + slipped.astype(i32) * jp.F_SLIPFRAME + (stype.astype(i32) << jp.F_TYPE_SHIFT))
    return slot, flags, st2._replace(window=ext[:, -31:])


@jax.jit
def jax_viterbi_chained(soft, prev_metric):
    s = soft + jnp.where(prev_metric[:1] > 1e30, 1.0, 0.0)
    return viterbi_decode_pallas(s, return_metric=True, interpret=True)


@jax.jit
def jax_decode_typed(fr, prev):
    fr = fr + jnp.where(prev[:1, :1] > 1e30, 1.0, 0.0)
    soft = jf.demap_frame(fr)
    return (jf.decode_lsf(soft).metric + jf.decode_stream(soft).metric
            + jf.decode_packet(soft).metric + jf.decode_bert(soft).metric)[:, None]


def test_bench_inputs_match_jax(jax_inputs):
    inp = ps.bench_inputs(B, "cpu")
    assert len(inp.blocks) == jax_inputs["nblk"] == 13
    for i, (got, want) in enumerate(zip(inp.blocks, jax_inputs["blocks"])):
        assert got.dtype == torch.int16 and got.shape == want.shape
        assert np.abs(got.numpy().astype(np.int32) - want).max() <= BENCH_LSB, f"block {i}"
    np.testing.assert_array_equal(inp.vit_soft.numpy(), jax_inputs["vit_soft"])
    np.testing.assert_array_equal(inp.frames.numpy(), jax_inputs["frames"])
    assert torch.equal(inp.session, torch.cat(inp.blocks, dim=-1))


def test_kernel_only_matches_jax(jax_inputs):
    st_t, st_j = tr.ReceiverState.init(B, "cpu"), jr.ReceiverState.init(B)
    flags_seen = 0
    for i, soft in enumerate(jax_inputs["soft"]):
        slot_t, flags_t, st_t = ps.kernel_only(t(soft), st_t)
        slot_j, flags_j, st_j = jax_kernel_only(jnp.asarray(soft), st_j)
        assert_same(f"slot_val block {i}", slot_t, np.asarray(slot_j))
        assert_same(f"flags block {i}", flags_t, np.asarray(flags_j))
        flags_seen |= int(np.bitwise_or.reduce(np.asarray(flags_j).ravel()))
    assert_tuple_match("state", st_t, st_j)
    # the mix reached acquisition and frame ends
    assert flags_seen & jp.F_AOS and flags_seen & jp.F_DONE


def test_viterbi_chained_matches_jax(jax_inputs):
    soft = jax_inputs["vit_soft"]
    m_t, m_j = torch.zeros(B), jnp.zeros(B, jnp.float32)
    for i in range(3):
        bits_t, m_t = ps.viterbi_chained(t(soft), m_t)
        bits_j, m_j = jax_viterbi_chained(jnp.asarray(soft), m_j)
        assert_same(f"bits call {i}", bits_t, np.asarray(bits_j))
        assert_same(f"metric call {i}", m_t, np.asarray(m_j))
    assert bits_t.shape == (B, 148)


def test_decode_typed_matches_jax(jax_inputs):
    fr = jax_inputs["frames"]
    p_t, p_j = torch.zeros(3 * B, 1), jnp.zeros((3 * B, 1), jnp.float32)
    for i in range(2):
        p_t = ps.decode_typed(t(fr), p_t)
        p_j = jax_decode_typed(jnp.asarray(fr), p_j)
        assert_same(f"metric sum call {i}", p_t, np.asarray(p_j))
    assert p_t.shape == (3 * B, 1)


def test_rx_two_passes_match_jax(jax_inputs):
    """Two chained passes of rx_block over the 13 bench blocks."""
    out_t, st_t = ps.rx([t(b) for b in jax_inputs["blocks"]], trx.RxSessionState.init(B, "cpu"),
                        2)
    st_j = jrx.RxSessionState.init(B)
    for _ in range(2):
        for blk in jax_inputs["blocks"]:
            out_j, st_j = jrx.rx_block(jnp.asarray(blk), st_j)
    assert_outputs_match(out_t, out_j)
    assert_states_match(st_t, st_j)
    assert int(np.asarray(st_j.n_frames).sum()) > 0


def test_rx_session_matches_jax(jax_inputs):
    """One rx_block call on the whole 24960-sample session."""
    session = jax_inputs["session"]
    out_t, st_t = ps.rx_session(t(session), trx.RxSessionState.init(B, "cpu"), 1)
    out_j, st_j = jrx.rx_block(jnp.asarray(session), jrx.RxSessionState.init(B))
    assert_outputs_match(out_t, out_j)
    assert_states_match(st_t, st_j)
    assert np.asarray(out_j.stream_valid).sum() > 0


def test_front_end_and_recv_match_jax(jax_inputs):
    """A chained pass of rx_front_end and of receive_block over the
    session (two passes are held by the rx test)."""
    dec_t, fe_t = ps.front_end([t(b) for b in jax_inputs["blocks"]],
                               td.RxFrontEndState.init(B, "cpu"), 1)
    fe_j, inf = jd.RxFrontEndState.init(B), jnp.zeros(B, bool)
    for blk in jax_inputs["blocks"]:
        dec_j, _, fe_j = jd.rx_front_end(jnp.asarray(blk), fe_j, inf)
    assert_same("front end soft", dec_t, np.asarray(dec_j))
    assert_tuple_match("front end state", fe_t, fe_j)

    ev_t, rs_t = ps.recv([t(s) for s in jax_inputs["soft"]], tr.ReceiverState.init(B, "cpu"), 1)
    rs_j = jr.ReceiverState.init(B)
    for soft in jax_inputs["soft"]:
        ev_j, rs_j = jr.receive_block(jnp.asarray(soft), rs_j)
    assert_tuple_match("events", ev_t, ev_j)
    assert_tuple_match("receiver state", rs_t, rs_j)


def test_document_json_and_trace(tmp_path, monkeypatch):
    """The CLI at B=16 on the CPU, iters = reps = 1, on
    the first 2 blocks of the session (the document's keys and formulas do
    not depend on the session's length; the whole session would take a
    minute here): the record's keys, derived values by their formulas,
    the JSON file and the trace file."""
    for name in ("ITERS", "REPS"):
        monkeypatch.setattr(ps, name, 1)
    full = ps.bench_inputs

    def two_blocks(batch, device):
        inp = full(batch, device)
        return inp._replace(blocks=inp.blocks[:2], soft_blocks=inp.soft_blocks[:2],
                            session=torch.cat(inp.blocks[:2], dim=-1))

    monkeypatch.setattr(ps, "bench_inputs", two_blocks)
    jpath, tdir = tmp_path / "profile.json", tmp_path / "trace"
    assert ps.main([str(B), "--device", "cpu", f"--json={jpath}", f"--trace={tdir}"]) == 0
    doc = json.loads(jpath.read_text())

    assert set(doc) == set(RECORD) | {"device"}
    assert (doc["batch"], doc["nblk"], doc["iters"], doc["reps"],
            doc["backend"], doc["device"]) == (B, 2, 1, 1, "cpu", "cpu")
    want_stages = [CPU_NAMES[n] for n in RECORD["stages"] if n in CPU_NAMES]
    assert list(doc["stages"]) == ["rx_session", "rx_plain", "front_end", "recv_plain",
                                   "viterbi4096", "decode_typed"]
    assert sorted(doc["stages"]) == sorted(want_stages)
    for name, st in doc["stages"].items():
        assert set(st) == set(RECORD["stages"]["rx_session"]), name
        assert 0 < st["ms_per_block_min"] <= st["ms_per_block_med"], name
        assert st["samples_per_s"] == pytest.approx(
            B * 1920 / (st["ms_per_block_min"] / 1e3), rel=1e-3), name
    s = {n: v["ms_per_block_min"] for n, v in doc["stages"].items()}
    assert set(doc["derived"]) == {"dispatch_overhead_ms_per_block"}
    assert doc["derived"]["dispatch_overhead_ms_per_block"] == pytest.approx(
        s["rx_plain"] - s["rx_session"], abs=1e-4)

    trace = json.loads((tdir / "rx_block_trace.json").read_text())
    assert trace["traceEvents"]


def test_card_stages_and_derived():
    """The card's stage list, and its document from rep times with known
    differences: the kernel legs' three derived values by their formulas."""
    names = ["rx_kernel", "rx_session", "front_end", "recv_kernel", "kernel_only",
             "viterbi4096", "decode_typed"]
    inp = ps.bench_inputs(B, "cpu")
    assert [n for n, _ in ps._stages(inp, torch.device("cuda"))] == names
    # ms a block at iters=2, nblk=13: 26 blocks a rep (rx_session: 2 calls)
    ms = {"rx_kernel": 12.0, "rx_session": 4.0, "front_end": 1.5, "recv_kernel": 3.25,
          "kernel_only": 0.5, "viterbi4096": 0.1, "decode_typed": 0.75}
    times = {n: [v * 26 / 1e3 * k for k in (1.2, 1.0, 1.1)] for n, v in ms.items()}
    doc = ps.document(times, 4096, 13, 2, 3, "cuda", "a card")
    assert list(doc["stages"]) == names and doc["device"] == "a card"
    for n, v in ms.items():
        assert doc["stages"][n]["ms_per_block_min"] == pytest.approx(v, abs=1e-4), n
        assert doc["stages"][n]["ms_per_block_med"] == pytest.approx(1.1 * v, abs=1e-4), n
    assert doc["derived"] == pytest.approx({"dispatch_overhead_ms_per_block": 8.0,
                                            "extraction_ms": 2.75, "typed_decode_ms": 7.25})


def test_device_cuda_without_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ps.main([str(B)]) == 1
    assert ps.main([str(B), "--device", "cuda"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
