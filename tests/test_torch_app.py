"""The port's application layer (m17_sdr_tpu_torch.app) against the JAX
package's (m17_sdr_tpu.app) on the same captures.

Three 9-block sessions (a voice session from PCM through the codec2
stand-in, with a GPS fix in its META; a 98-byte packet; 5 BERT frames)
are transmitted by the JAX package and decoded as one batch of B=3
channels by both packages, in chunks of 4 blocks, so that the last chunk
is a one-block tail.  Integer, bool and byte fields must be equal, and
float fields agree to ``torch_parity.FLOAT_RTOL`` (1e-3 relative): the
front end's float32 math differs from XLA's in the last ulp.  Stats
JSON: equal, apart from "rssi", a float that both packages round to 4
places, held to 1e-3 relative plus one unit of the 4th place.
Payload, PCM and packet files must be byte-equal.  Both packages use
the codec2 stand-in here: the real libcodec2's decoder draws from the C
library's global random state, so two decodes of the same frames in one
process differ.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch
from torch_parity import FLOAT_RTOL, FakeReflector, assert_outputs_match, assert_same

from m17_sdr_tpu.app import checkpoint as j_ckpt
from m17_sdr_tpu.app.checkpoint import _flatten_with_paths
from m17_sdr_tpu.app import session as j_session
from m17_sdr_tpu.app import streaming as j_st
from m17_sdr_tpu.dsp import resample as j_resample
from m17_sdr_tpu.io import codec2 as j_codec2
from m17_sdr_tpu.io import gps as j_gps
from m17_sdr_tpu.io import reflector as j_refl
from m17_sdr_tpu.pipeline.rx import RxSessionState as JRxState
from m17_sdr_tpu_torch.app import checkpoint as t_ckpt
from m17_sdr_tpu_torch.app import session as t_session
from m17_sdr_tpu_torch.app import streaming as t_st
from m17_sdr_tpu_torch.io import codec2 as t_codec2
from m17_sdr_tpu_torch.io import reflector as t_refl
from m17_sdr_tpu_torch.convert import tree_to_numpy

torch.set_num_threads(2)
CHUNK = 4             # 9 blocks -> chunks of 4, 4 and a 1-block tail
SPLIT = 5             # checkpoint after 5 blocks (a chunk and a 1-block tail)
TX_LSB = 8            # port TX vs JAX TX, int16 LSB: the f32 phase cumsum sums
                      # in another order (tests/test_torch_tx.py)
RSSI_ATOL = 1e-4      # one unit of the 4th place both packages round rssi to


def _assert_tree(got, want):
    fg, fw = tree_to_numpy(got), tree_to_numpy(want)
    assert set(fg) == set(fw)
    for k in fw:
        assert_same(k, fg[k], fw[k])


def _assert_stats(got, want, path="stats"):
    """Stats dicts: equal, with rssi floats within rounding."""
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert set(got) == set(want), f"{path}: {sorted(got)} vs {sorted(want)}"
        for k in want:
            _assert_stats(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_stats(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, atol=RSSI_ATOL, err_msg=path)
    else:
        assert got == want, path


def _sessions(pkg, **kw):
    sess = pkg.Session(**kw)
    sess.db.tx_src_call, sess.db.tx_dest_call = "G4GUO", "AB1CDE"
    return sess


@pytest.fixture(scope="module", autouse=True)
def standin_codec():
    """Sessions of both packages use the codec2 stand-in."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (j_codec2, t_codec2):
            mp.setattr(mod, "_find_lib", lambda: None)
        yield


@pytest.fixture(scope="module")
def caps(tmp_path_factory, standin_codec):
    """The three JAX-transmitted captures, their inputs, and the JAX
    package's batch decode of them."""
    td = tmp_path_factory.mktemp("app")
    rng = np.random.default_rng(5)
    t = np.arange(4 * 320)
    pcm = (3000 * np.sin(2 * np.pi * 330 * t / 8000)
           + 500 * rng.normal(size=t.size)).astype("<i2")
    (td / "mic.raw").write_bytes(pcm.tobytes())
    (td / "pkt.bin").write_bytes(rng.integers(0, 256, 98, dtype=np.uint8).tobytes())
    (td / "voice.bin").write_bytes(rng.integers(0, 256, 4 * 16, dtype=np.uint8).tobytes())
    fix = j_gps.GpsFix(lat=51.5, lon=-0.125, alt=120)
    meta = bytes(j_gps.gps_meta_for_lsf(fix))
    inputs = {"voice": dict(audio_in=str(td / "mic.raw")),
              "packet": dict(packet_in=str(td / "pkt.bin")),
              "bert": dict(bert_frames=5)}
    js = _sessions(j_session)
    paths, tx_stats = {}, {}
    for name, kw in inputs.items():
        js.db.meta = meta if name == "voice" else b""
        paths[name] = str(td / f"{name}.iq")
        tx_stats[name] = js.tx_file(paths[name], **kw)
    batch = [paths["voice"], paths["packet"], paths["bert"]]
    srx = j_st.StreamingRx(batch=3, chunk_blocks=CHUNK, equalize="auto")
    srx.run(j_st.batch_wire_block_iter(batch, srx.block_in))
    out, state, n = srx.finish()
    return dict(td=td, meta=meta, inputs=inputs, paths=paths, batch=batch,
                tx_stats=tx_stats, jax=(out, state, n))


@pytest.fixture(scope="module")
def port_run(caps):
    """The port's unbroken decode of the batch (ring on)."""
    srx = t_st.StreamingRx(batch=3, chunk_blocks=CHUNK, equalize="auto", device="cpu")
    srx.run(t_st.batch_wire_block_iter(caps["batch"], srx.block_in))
    return srx.finish()


def test_streaming_rx_matches_jax_with_ring(caps, port_run):
    out_j, st_j, n_j = caps["jax"]
    out_t, st_t, n_t = port_run
    assert n_t == n_j == 9
    assert_outputs_match(out_t, out_j)
    _assert_tree(st_t, st_j)
    assert int(out_t.stream_gate.sum()) == 4        # every voice frame routed
    assert int(out_t.packet_valid.sum()) == 4 and int(out_t.bert_valid.sum()) == 5


def test_streaming_rx_matches_jax_without_ring(caps):
    srx = t_st.StreamingRx(batch=3, chunk_blocks=CHUNK, equalize="auto", device="cpu")
    srx.run(t_st.batch_wire_block_iter(caps["batch"], srx.block_in), use_ring=False)
    out_t, st_t, n_t = srx.finish()
    out_j, st_j, n_j = caps["jax"]
    assert n_t == n_j
    assert_outputs_match(out_t, out_j)
    _assert_tree(st_t, st_j)
    with pytest.raises(RuntimeError):
        srx.feed_block(np.zeros((3, 1920, 2), np.int16))     # single-use


def _blocks(caps):
    return list(j_st.batch_wire_block_iter(caps["batch"], 1920))


def _tail(out, start):
    """Blocks [start:] of a stacked host output."""
    return type(out)(*(x[:, start:] for x in out))


def test_jax_checkpoint_resumes_in_port(caps, tmp_path):
    """A JAX StreamingRx checkpoint after SPLIT blocks, resumed by the
    port: the port's remaining blocks and final state agree with the JAX
    unbroken run."""
    blocks = _blocks(caps)
    ck = str(tmp_path / "jax.npz")
    j = j_st.StreamingRx(batch=3, chunk_blocks=CHUNK, equalize="auto")
    for b in blocks[:SPLIT]:
        j.feed_block(b)
    j.checkpoint(ck)
    t = t_st.StreamingRx(batch=3, chunk_blocks=CHUNK, equalize="auto", device="cpu")
    t.resume(ck)
    for b in blocks[SPLIT:]:
        t.feed_block(b)
    out_t, st_t, n_t = t.finish()
    out_j, st_j, _ = caps["jax"]
    assert n_t == len(blocks) - SPLIT
    assert_outputs_match(out_t, _tail(out_j, SPLIT))
    _assert_tree(st_t, st_j)


def test_port_checkpoint_resumes_in_jax(caps, tmp_path):
    """A port checkpoint is a JAX checkpoint: same keys, dtypes and tag,
    and the JAX StreamingRx resumed from it agrees with its own unbroken
    run."""
    blocks = _blocks(caps)
    ck = str(tmp_path / "port.npz")
    t = t_st.StreamingRx(batch=3, chunk_blocks=CHUNK, equalize="auto", device="cpu")
    for b in blocks[:SPLIT]:
        t.feed_block(b)
    t.checkpoint(ck)
    with np.load(ck) as z:
        got = {k: z[k] for k in z.files}
    want = _flatten_with_paths(j_st.StreamChunkState(
        rx=JRxState.init(3), dec_tail=j_resample.decimate_init(3)))
    assert set(got) == set(want) | {"__format__"}
    assert str(got["__format__"]) == j_ckpt.FORMAT
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k

    j = j_st.StreamingRx(batch=3, chunk_blocks=CHUNK, equalize="auto")
    j.resume(ck)
    for b in blocks[SPLIT:]:
        j.feed_block(b)
    out_j2, st_j2, _ = j.finish()
    out_j, st_j, _ = caps["jax"]
    for name in out_j._fields:
        assert_same(name, getattr(out_j2, name), getattr(_tail(out_j, SPLIT), name))
    for k, v in _flatten_with_paths(st_j).items():
        assert_same(k, _flatten_with_paths(st_j2)[k], v)


def test_port_split_resume_is_bit_identical(caps, port_run, tmp_path):
    blocks = _blocks(caps)
    ck = str(tmp_path / "split.npz")
    a = t_st.StreamingRx(batch=3, chunk_blocks=CHUNK, equalize="auto", device="cpu")
    for b in blocks[:SPLIT]:
        a.feed_block(b)
    a.checkpoint(ck)
    out1, _, n1 = a.finish()
    b2 = t_st.StreamingRx(batch=3, chunk_blocks=CHUNK, equalize="auto", device="cpu")
    b2.resume(ck)
    for b in blocks[SPLIT:]:
        b2.feed_block(b)
    out2, st2, n2 = b2.finish()
    out_ref, st_ref, n_ref = port_run
    assert n1 + n2 == n_ref
    for name in out_ref._fields:
        joined = np.concatenate([getattr(out1, name), getattr(out2, name)], axis=1)
        np.testing.assert_array_equal(joined, getattr(out_ref, name), err_msg=name)
    for k, v in tree_to_numpy(st_ref).items():
        np.testing.assert_array_equal(tree_to_numpy(st2)[k], v, err_msg=k)


def test_checkpoint_rejects_mismatched_templates(tmp_path):
    p = str(tmp_path / "s.npz")
    t_ckpt.save_state(p, t_st.StreamChunkState.init(2, "cpu"))
    with pytest.raises(ValueError, match="shape mismatch"):
        t_ckpt.load_state(p, t_st.StreamChunkState.init(3, "cpu"))
    from m17_sdr_tpu_torch.pipeline.rx import RxSessionState

    with pytest.raises(ValueError, match="field mismatch"):
        t_ckpt.load_state(p, RxSessionState.init(2, "cpu"))
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, __format__=np.asarray("something-else"))
    with pytest.raises(ValueError, match="unknown checkpoint format"):
        t_ckpt.load_state(bad, RxSessionState.init(2, "cpu"))
    srx = t_st.StreamingRx(batch=2, device="cpu")
    srx.feed_block(np.zeros((2, 1920, 2), np.int16))
    with pytest.raises(RuntimeError):
        srx.resume(p)
    srx.finish()


def _rx_file(pkg, caps, td, tag, **kw):
    sess = _sessions(pkg, **kw)
    outs = {k: str(td / f"{tag}.{k}") for k in ("payload_out", "audio_out", "packet_out")}
    stats = sess.rx_file(caps["batch"], chunk_blocks=CHUNK, **outs)
    files = {}
    for k, base in outs.items():
        for ch in range(3):
            p = td / f"{tag}.{k}.ch{ch}"
            files[(k, ch)] = p.read_bytes() if p.exists() else None
    return stats, files, sess.db


def test_session_rx_file_batch_matches_jax(caps, tmp_path):
    s_j, f_j, db_j = _rx_file(j_session, caps, tmp_path, "jax")
    s_t, f_t, db_t = _rx_file(t_session, caps, tmp_path, "port", device="cpu")
    _assert_stats(s_t, s_j)
    assert f_t == f_j
    assert f_t[("payload_out", 0)] and f_t[("audio_out", 0)] and f_t[("packet_out", 1)]
    assert s_t["channels"][0]["lsf"]["gps"]["lat"] == 51.5
    assert s_t["channels"][2]["bert"]["errors"] == 0
    assert (db_t.rx_src, db_t.rx_dest, db_t.n_frames) == (db_j.rx_src, db_j.rx_dest,
                                                          db_j.n_frames)


@pytest.mark.parametrize("name", ["voice", "packet", "bert"])
def test_session_tx_file_matches_jax(caps, tmp_path, name):
    ts = _sessions(t_session, device="cpu")
    ts.db.meta = caps["meta"] if name == "voice" else b""
    path = tmp_path / f"{name}.iq"
    stats = ts.tx_file(str(path), **caps["inputs"][name])
    assert stats == caps["tx_stats"][name]
    got = np.fromfile(path, dtype="<i2").astype(np.int32)
    want = np.fromfile(caps["paths"][name], dtype="<i2").astype(np.int32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TX_LSB
    assert not ts.db.ptt


def test_session_duplex_file_matches_jax(caps, tmp_path):
    """duplex_file: the RX side's stats equal the JAX decode of the same
    capture, the TX side's IQ is the JAX TX of the same payloads."""
    ts = _sessions(t_session, device="cpu")
    out = tmp_path / "duplex_tx.iq"
    voice = str(caps["td"] / "voice.bin")
    res = ts.duplex_file(caps["paths"]["packet"], str(out), payload_in=voice,
                         payload_out=str(tmp_path / "dp.bin"))
    js = _sessions(j_session)
    want_tx = js.tx_file(str(tmp_path / "jax_tx.iq"), payload_in=voice)
    assert res["tx"] == want_tx
    got = np.fromfile(out, dtype="<i2").astype(np.int32)
    want = np.fromfile(tmp_path / "jax_tx.iq", dtype="<i2").astype(np.int32)
    assert got.shape == want.shape and np.abs(got - want).max() <= TX_LSB
    s_j, _, _ = _rx_file(j_session, caps, tmp_path, "jax")
    want_rx = {"blocks": s_j["blocks"], **s_j["channels"][1]}
    _assert_stats(res["rx"], want_rx)


def test_session_gateway_run_file_with_fake_reflector(caps, tmp_path):
    """The RF->NET leg forwards every routed voice frame of the capture
    (the JAX decode's FNs and payloads, under the LICH of the LSF sent)
    to a fake reflector over UDP; the reflector's net frames, queued
    during the pass, key up RF under the originator's LSF, built as the
    JAX package builds it."""
    refl = FakeReflector()
    ts = _sessions(t_session, device="cpu")
    try:
        ts.connect("127.0.0.1", "A", port=refl.port)
        deadline = time.monotonic() + 5.0
        while (d := refl.poll()) is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert d is not None and d[:4] == b"CONN"
        refl.send(b"ACKN")
        src = t_refl._call6(t_refl.cs.encode_callsign("M0ABC"))
        lich28 = bytes(6 * [0xFF]) + src + b"\x00\x05" + bytes(range(14))
        net = [np.random.default_rng(fn).integers(0, 256, 16, dtype=np.uint8).tobytes()
               for fn in range(3)]
        time.sleep(0.2)
        ts.reflector.poll()                      # the ACKN
        assert ts.reflector.active
        for fn, pl in enumerate(net):
            refl.send(t_refl.pack_voice_frame(0x4242, lich28, fn, pl))
        time.sleep(0.2)
        rf_out = tmp_path / "rf_out.iq"
        stats = ts.gateway_run_file(caps["paths"]["voice"], str(rf_out))
        time.sleep(0.3)
        seen = []
        while (d := refl.poll()) is not None:
            vf = j_refl.parse_voice_frame(d)
            if vf is not None:
                seen.append(vf)
    finally:
        ts.disconnect()
        refl.close()
    out_j = caps["jax"][0]
    gate = out_j.stream_gate[0].reshape(-1)
    want = [(int(f), bytes(p)) for f, p in zip(out_j.stream_fn[0].reshape(-1)[gate],
                                               out_j.stream_payload[0].reshape(-1, 16)[gate])]
    assert stats == {"rf_to_net": len(want), "net_to_rf": len(net)}
    assert [(vf.fn, vf.payload) for vf in seen] == want
    lsf = caps["jax"][1].lich_good[0]
    assert all((vf.dst, vf.src) == (int(j_session.bitpack.bytes_to_word(lsf[0:6])),
                                    int(j_session.bitpack.bytes_to_word(lsf[6:12])))
               for vf in seen)
    # the RF key-up: the originator's LSF, equal to the JAX package's
    vf = j_refl.parse_voice_frame(t_refl.pack_voice_frame(0x4242, lich28, 0, net[0]))
    np.testing.assert_array_equal(t_session._lsf_from_net(vf, "cpu").numpy(),
                                  np.asarray(j_session._lsf_from_net(vf)))
    decoded = t_session.Session(device="cpu").rx_file(str(rf_out))
    assert decoded["lsf"]["src"] == "M0ABC" and decoded["payload_frames"] == len(net)


class _QueueReflector:
    """Stand-in reflector client: hands out pre-queued voice frames once
    and records what the gateway forwards."""

    active = True

    def __init__(self, frames):
        self._frames, self.sent = frames, []

    def poll(self):
        f, self._frames = self._frames, []
        return f

    def send_voice(self, sid, lich28, fn, payload):
        self.sent.append((fn, payload))


def test_session_gateway_run_live_keys_up_mid_capture(caps, tmp_path):
    """The live gateway loop: the jitter queue (17 frames, above the
    key-up threshold of 15) drains to RF after the first RF chunk, and
    RF decoding resumes; the RF leg forwards the JAX decode's frames."""
    lich28 = bytes(6 * [0xFF]) + t_refl._call6(t_refl.cs.encode_callsign("M0XYZ")) \
        + b"\x00\x05" + bytes(14)
    rng = np.random.default_rng(9)
    net = [j_refl.parse_voice_frame(t_refl.pack_voice_frame(
        0x4242, lich28, fn, rng.integers(0, 256, 16, dtype=np.uint8).tobytes()))
        for fn in range(17)]
    ts = _sessions(t_session, device="cpu")
    ts.reflector = _QueueReflector(net)
    rf_out = tmp_path / "rf_out.iq"
    stats = ts.gateway_run_live(caps["paths"]["voice"], str(rf_out), chunk_blocks=5,
                                idle_polls=1, idle_poll_s=0.0)
    out_j = caps["jax"][0]
    gate = out_j.stream_gate[0].reshape(-1)
    want = [(int(f), bytes(p)) for f, p in zip(out_j.stream_fn[0].reshape(-1)[gate],
                                               out_j.stream_payload[0].reshape(-1, 16)[gate])]
    assert ts.reflector.sent == want
    assert stats["keyups"] == 1 and stats["net_to_rf"] == 17
    assert stats["events"] == [("rx", 0), ("tx", stats["events"][1][1]),
                               ("rx", stats["events"][1][1])]
    decoded = t_session.Session(device="cpu").rx_file(str(rf_out))
    assert decoded["lsf"]["src"] == "M0XYZ" and decoded["payload_frames"] == 17


def test_session_tx_live_matches_jax(caps, tmp_path):
    """Live TX from a file mic, frame by frame with the modulator's state
    carried across calls: the same stats, IQ within TX_LSB of the JAX
    package's, and the port decodes it as sent."""
    from m17_sdr_tpu.io.sources import FileSink as JSink
    from m17_sdr_tpu_torch.io.sources import FileSink as TSink

    res = {}
    for name, pkg, sink_cls, kw in (("jax", j_session, JSink, {}),
                                    ("port", t_session, TSink, {"device": "cpu"})):
        sess = _sessions(pkg, **kw)
        sink = sink_cls(tmp_path / f"{name}.iq")
        res[name] = sess.tx_live(sink, audio_in=caps["inputs"]["voice"]["audio_in"])
        sink.close()
        assert not sess.db.ptt
    assert res["port"] == res["jax"] and res["port"]["frames"] == 4
    got = np.fromfile(tmp_path / "port.iq", dtype="<i2").astype(np.int32)
    want = np.fromfile(tmp_path / "jax.iq", dtype="<i2").astype(np.int32)
    assert got.shape == want.shape and np.abs(got - want).max() <= TX_LSB
    decoded = t_session.Session(device="cpu").rx_file(str(tmp_path / "port.iq"))
    assert decoded["payload_frames"] == 4 and decoded["lsf"]["src"] == "G4GUO"
