"""Behaviours of the port that JAX tests hold for the JAX package, held
here for the port: the control plane (tests/test_control_plane.py), the
reflector directory, LICH readdress, mic prebuffering and UDP sink sizing
(tests/test_io_app.py), the packet size cap (tests/test_packet.py), the
FN continuity gate and channel independence (tests/test_pipeline.py),
``rx_live`` at 384 kHz and its ``equalize`` pass-through; and the two
repairs of the port's audio module (two writers on one loopback, a dead
player).  Torch inputs, ``device="cpu"``, ports the kernel picks."""

from __future__ import annotations

import json
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from test_pipeline import _mk_lsf, _payloads

from m17_sdr_tpu_torch.app import session as sessionm
from m17_sdr_tpu_torch.app import streaming
from m17_sdr_tpu_torch.app.dbase import Dbase
from m17_sdr_tpu_torch.app.main import _mk_session, _udp_sink, build_parser
from m17_sdr_tpu_torch.app.session import GATEWAY_KEYUP_THRESHOLD, Session
from m17_sdr_tpu_torch.dsp.channel import keyed_noise
from m17_sdr_tpu_torch.frame import tx_frames
from m17_sdr_tpu_torch.io import audio as audiom
from m17_sdr_tpu_torch.io import reflector as refl
from m17_sdr_tpu_torch.pipeline import loopback
from m17_sdr_tpu_torch.pipeline import tx as txp
from m17_sdr_tpu_torch.pipeline.rx import RxSessionState, rx_stream
from m17_sdr_tpu_torch.spec import bits as bitpack
from m17_sdr_tpu_torch.spec import callsign as cs
from m17_sdr_tpu_torch.spec.constants import FRAME_SYMBOLS

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
NF = 4


def _session() -> Session:
    return Session(device="cpu")


def _lsf(b: int) -> torch.Tensor:
    return torch.as_tensor(np.array(_mk_lsf(b)))


def _pl(b: int, nf: int, seed: int) -> torch.Tensor:
    return torch.as_tensor(np.array(_payloads(b, nf, seed)))


# ------------------------------------------------------------ control plane


def test_mmi_ptt_commands_key_gpio():
    sess, mmi = _mk_session(build_parser().parse_args(["--device", "cpu", "repl"]))
    assert not sess.ptt.get()
    assert mmi.parse("tx") == "OK"
    assert sess.ptt.get() and sess.db.ptt
    assert mmi.parse("rx") == "OK"
    assert not sess.ptt.get() and not sess.db.ptt
    assert mmi.parse("tc") == "OK"          # carrier keys up too
    assert sess.ptt.get()
    assert mmi.parse("rx") == "OK"
    assert mmi.parse("td") == "OK"          # duplex keys up
    assert sess.ptt.get()
    assert sess.db.extra["ptt_mode"] == "dp"


def test_tx_file_keys_ptt_for_burst(tmp_path):
    sess = _session()
    states = []
    orig_set, orig_clear = sess.ptt.set, sess.ptt.clear
    sess.ptt.set = lambda: (states.append("on"), orig_set())[1]
    sess.ptt.clear = lambda: (states.append("off"), orig_clear())[1]
    sess.tx_file(str(tmp_path / "t.iq"), n_frames=2)
    assert states == ["on", "off"]
    assert not sess.ptt.get()


def test_duplex_circuit(tmp_path):
    """TX to one file while decoding another, concurrently."""
    cap, out = str(tmp_path / "in.iq"), str(tmp_path / "out.iq")
    _session().tx_file(cap, n_frames=4)
    sess = _session()
    sess.db.tx_src_call = "G4GUO"
    stats = sess.duplex_file(cap, out, n_frames=3, payload_out=str(tmp_path / "p.bin"))
    assert stats["rx"]["payload_frames"] == 4 and stats["tx"]["frames"] == 3
    check = _session().rx_file(out)          # the transmitted side decodes
    assert check["payload_frames"] == 3 and check["lsf"]["src"] == "G4GUO"
    assert not sess.ptt.get()


def test_duplex_cli(tmp_path):
    cap = str(tmp_path / "in.iq")
    _session().tx_file(cap, n_frames=2)
    r = subprocess.run(
        [sys.executable, "-m", "m17_sdr_tpu_torch.app.main", "--device", "cpu", "duplex",
         "--in", cap, "--out", str(tmp_path / "o.iq"), "--frames", "2"],
        check=True, capture_output=True, text=True, cwd=REPO, timeout=300)
    stats = json.loads(r.stdout.splitlines()[-1])
    assert stats["rx"]["payload_frames"] == 2 and stats["tx"]["frames"] == 2


class _QueueReflector:
    """Stand-in reflector client holding pre-queued voice frames."""

    active = True

    def __init__(self, frames):
        self._frames = frames

    def poll(self):
        f, self._frames = self._frames, []
        return f

    def send_voice(self, *a, **k):
        pass


def test_gateway_rf_lsf_comes_from_received_lich(tmp_path):
    """The RF key-up carries the originator's callsigns and META from the
    network frame's LICH, not the gateway's own identity."""
    dst = bitpack.word_to_bytes(0xFFFFFFFFFFFF, 6)
    src = bitpack.word_to_bytes(cs.encode_callsign("M0ABC"), 6)
    meta = bytes(range(14))
    lich28 = bytes(dst) + bytes(src) + b"\x00\x05" + meta
    rng = np.random.default_rng(0)
    frames = [refl.parse_voice_frame(refl.pack_voice_frame(
        0x1234, lich28, fn, rng.integers(0, 256, 16, dtype=np.uint8).tobytes()))
        for fn in range(GATEWAY_KEYUP_THRESHOLD + 2)]
    sess = _session()
    sess.db.tx_src_call = "GATEWAY1"         # must not appear on RF
    sess.reflector = _QueueReflector(frames)
    empty, out = tmp_path / "empty.iq", str(tmp_path / "rf.iq")
    empty.write_bytes(b"")
    assert sess.gateway_run_file(str(empty), out)["net_to_rf"] == len(frames)
    decoded = _session().rx_file(out)
    assert decoded["lsf"]["src"] == "M0ABC" and decoded["lsf"]["dst"] == "BROADCAST"
    assert decoded["lsf"]["meta"] == meta.hex()


def test_gateway_live_loop_interleaves_rx_and_tx(tmp_path):
    """The live DRTODN loop: a fake reflector on a free port answers the
    third RF-originated voice datagram with a 20-frame net stream from
    another originator, so the key-up lands mid-capture and the loop
    returns to RX with RF still to decode."""
    rf_in, payload_in = tmp_path / "rf_in.iq", tmp_path / "voice.bin"
    rng = np.random.default_rng(7)
    payload_in.write_bytes(rng.integers(0, 256, (24, 16), dtype=np.uint8).tobytes())
    txs = _session()
    txs.db.tx_src_call = "G4GUO"
    txs.tx_file(str(rf_in), payload_in=str(payload_in))
    dst = bitpack.word_to_bytes(0xFFFFFFFFFFFF, 6)
    src = bitpack.word_to_bytes(cs.encode_callsign("M0XYZ"), 6)
    lich28 = bytes(dst) + bytes(src) + b"\x00\x05" + bytes(14)
    net_payloads = rng.integers(0, 256, (20, 16), dtype=np.uint8)

    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.settimeout(0.05)
    seen_rf, stop = [], threading.Event()

    def reflector_side():
        burst_sent = False
        while not stop.is_set():
            try:
                d, peer = sock.recvfrom(65536)
            except socket.timeout:
                continue
            if d[:4] == b"CONN":
                sock.sendto(b"ACKN", peer)
            elif d[:4] == b"M17 ":
                vf = refl.parse_voice_frame(d)
                if vf is not None:
                    seen_rf.append(vf)
                if len(seen_rf) == 3 and not burst_sent:
                    burst_sent = True
                    for fn, pl in enumerate(net_payloads):
                        sock.sendto(refl.pack_voice_frame(0x4242, lich28, fn, pl.tobytes()),
                                    peer)

    t = threading.Thread(target=reflector_side, daemon=True)
    t.start()
    sess = _session()
    sess.db.tx_src_call = "GATE1"
    sess.connect("127.0.0.1", "A", port=sock.getsockname()[1], bind_port=0)
    rf_out = tmp_path / "rf_out.iq"
    try:
        stats = sess.gateway_run_live(str(rf_in), str(rf_out), chunk_blocks=3)
    finally:
        stop.set()
        t.join(timeout=5)
        sess.disconnect()
        sock.close()
    assert not t.is_alive()
    assert stats["net_to_rf"] == 20, stats
    assert stats["rf_to_net"] >= 14, stats
    assert stats["keyups"] >= 1
    tx_events = [n for s, n in stats["events"] if s == "tx"]
    assert tx_events[0] < stats["rf_to_net"], stats["events"]
    assert all(cs.decode_callsign(vf.src).strip() == "G4GUO" for vf in seen_rf)
    out_payload = tmp_path / "net_rf.bin"
    decoded = _session().rx_file(str(rf_out), payload_out=str(out_payload))
    assert decoded["lsf"]["src"] == "M0XYZ"
    got = np.frombuffer(out_payload.read_bytes(), np.uint8).reshape(-1, 16)
    sent_rows = [bytes(r) for r in net_payloads]
    assert got.shape[0] >= 19 and all(bytes(r) in sent_rows for r in got)


# ------------------------------------------------------ reflector directory


@pytest.mark.parametrize("port, want_port", [(None, 17000), (17005, 17005)])
def test_connect_resolves_directory_name(port, want_port):
    """A directory designator resolves to its address; an explicit port
    beats the directory's."""
    s = _session()
    s.db.extra["hosts_file"] = str(REPO / "assets" / "M17Hosts.txt")
    s.connect("TEST-LOCAL", "C", port=port, bind_port=0)
    try:
        assert s.reflector.host == "127.0.0.1" and s.reflector.port == want_port
        assert s.db.connected_reflector == "127.0.0.1"
    finally:
        s.disconnect()


def test_gateway_net_lich_readdressed_to_reflector(tmp_path):
    """RF->NET voice carries the LICH dest overwritten with '<reflector>
    <module>'; a direct-IP connect leaves the LICH as it is."""
    hosts = tmp_path / "M17Hosts.txt"
    hosts.write_text("M17-TST 127.0.0.1 17000\n")
    lich = bytes(range(28))
    s = _session()
    s.db.extra["hosts_file"] = str(hosts)
    s.connect("M17-TST", "C", bind_port=0)
    try:
        assert s.db.extra["reflector_name"] == "M17-TST"
        out = s._net_lich(lich)
        dest = int(bitpack.bytes_to_word_host(np.frombuffer(out[:6], np.uint8)))
        assert cs.decode_callsign(dest) == "M17-TST C"
        assert out[6:] == lich[6:]
    finally:
        s.disconnect()
    s2 = _session()
    s2.connect("127.0.0.1", "A", port=17009, bind_port=0)
    try:
        assert "reflector_name" not in s2.db.extra
        assert s2._net_lich(lich) == lich
    finally:
        s2.disconnect()


# ------------------------------------------------------------------ TX side


def test_mic_prebuffered_before_head(monkeypatch):
    """tx_live reads the first mic block before the head goes on the air
    (the reference prebuffers before key-up, m17_tx_rx.cpp:88-93)."""
    order = []

    class LogMic:
        blocks = 4

        def audio_input(self, n=160):
            if not self.blocks:
                return None
            self.blocks -= 1
            order.append("mic")
            return np.zeros(160, np.int16)

        def close(self):
            pass

    class LogSink:
        def transmit_samples(self, iq):
            order.append("send")
            return int(len(iq))

    monkeypatch.setattr(sessionm.audiom, "open_source", lambda path: LogMic())
    stats = Session(db=Dbase(tx_src_call="G4GUO"), device="cpu").tx_live(
        LogSink(), audio_in="device")
    assert stats["frames"] == 2
    assert order[0] == "mic" and order[1] == "send"
    assert order.count("send") == 4          # head + 2 frames + tail


@pytest.mark.parametrize("argv, block", [
    (["tx", "--live", "--out", "x", "--udp-out", ":42973", "--rate", "384000"], 15360),
    (["tx", "--out", "x", "--udp-out", "localhost:42973"], 1920),
])
def test_udp_sink_block_scales_with_rate(argv, block):
    """tx --udp-out sends datagrams of the block rx --udp reads at --rate
    (the sink only sends; it binds no port)."""
    sink = _udp_sink(build_parser().parse_args(argv))
    try:
        assert sink._block == block
    finally:
        sink.close()


def test_packet_tx_rejects_oversize(tmp_path):
    """Files beyond the 823-byte superframe cap are refused, not sent
    with a wrapped frame counter."""
    big = tmp_path / "big.bin"
    big.write_bytes(bytes(1000))
    with pytest.raises(ValueError, match="823"):
        _session().tx_file(str(tmp_path / "x.iq"), packet_in=str(big))


# --------------------------------------------------------- FN continuity


def _routed(dibits: torch.Tensor):
    iq, _ = txp.dibits_to_iq(dibits)
    out, _ = rx_stream(loopback._blockify(iq), RxSessionState.init(1, "cpu"))
    gate = out.stream_gate[0].reshape(-1).numpy()
    fn = out.stream_fn[0].reshape(-1).numpy()
    valid = out.stream_valid[0].reshape(-1).numpy()
    return list(fn[gate]), list(fn[valid])


@pytest.mark.parametrize("fn0, want", [
    (0, list(range(8))),                                     # sequential
    (0x7FFD, [0x7FFD, 0x7FFE, 0x7FFF, 0, 1, 2, 3, 4]),       # 15-bit wrap
    (12345, list(range(12345, 12345 + 8))),                  # mid-stream join
])
def test_fn_gate_routes_sessions(fn0, want):
    """The routing gate: an FN advancing 1..16 past the anchor routes, the
    FN wraps at 15 bits (its MSB marks the end of stream), and a fresh
    session accepts any first FN."""
    routed, _ = _routed(txp.build_voice_session_dibits(
        _lsf(1), _pl(1, 8, 3), fn0=torch.tensor([fn0])))
    assert routed == want and all(f < 0x8000 for f in routed)


def test_fn_gate_rejects_discontinuity_then_self_heals():
    """A confident misframe (an absurd FN mid-stream) does not route; the
    anchor follows it, so one clean frame after it is lost."""
    lsf, pl = _lsf(1), _pl(1, 8, 4)
    d1 = txp.build_voice_session_dibits(lsf, pl[:, :4], fn0=torch.tensor([0]))
    idx = torch.arange(4)
    stream2 = tx_frames.build_stream_frame(
        lsf.repeat(4, 1), idx % 6 + 4, 5000 + idx, pl[0, 4:8]).reshape(1, -1)
    eot_start = d1.shape[1] - 2 * FRAME_SYMBOLS               # EOT + idle tail
    routed, delivered = _routed(torch.cat([d1[:, :eot_start], stream2, d1[:, eot_start:]], 1))
    assert delivered == [0, 1, 2, 3, 5000, 5001, 5002, 5003]
    assert routed == [0, 1, 2, 3, 5001, 5002, 5003]


def test_batched_equals_single():
    """Channels batched decode as they do alone: each channel's noise is
    keyed by its index, so a one-channel run sees the same noise."""
    lsf, pl = _lsf(2), _pl(2, NF, 6)
    shape = txp.dibits_to_iq(txp.build_voice_session_dibits(lsf, pl))[0].shape
    out_b, _ = loopback.voice_loopback(lsf, pl, snr_db=80.0,
                                       noise=keyed_noise(shape, 6, 0, "cpu"))
    got_b, mask_b = loopback.recover_stream_payloads(out_b, NF)
    assert mask_b.all()
    for ch in range(2):
        out_s, _ = loopback.voice_loopback(lsf[ch:ch + 1], pl[ch:ch + 1], snr_db=80.0,
                                           noise=keyed_noise((1, *shape[1:]), 6, ch, "cpu"))
        got_s, mask_s = loopback.recover_stream_payloads(out_s, NF)
        assert np.array_equal(mask_s[0], mask_b[ch])
        assert np.array_equal(got_s[0], got_b[ch])
        for name in out_b._fields:
            assert torch.equal(getattr(out_s, name)[0], getattr(out_b, name)[ch]), name


# ----------------------------------------------------------------- rx_live


def test_rx_live_at_384k_over_udp():
    """rx_live at the Pluto rate: 15360-sample datagrams (61440 bytes)
    through the x8 decimator, decoded mid-stream."""
    from m17_sdr_tpu_torch.io.sources import UdpSampleSink

    payloads = _pl(1, 6, 12)
    iq, _ = txp.dibits_to_iq(txp.build_voice_session_dibits(_lsf(1), payloads),
                             oversample=80)                   # 384 kS/s
    ciq = (iq[0, 0] + 1j * iq[0, 1]).numpy().astype(np.complex64)
    blk = 1920 * 8
    senders = []

    def send(port):
        sink = UdpSampleSink("127.0.0.1", port, block=blk)
        for i in range(len(ciq) // blk):
            sink.transmit_samples(ciq[i * blk:(i + 1) * blk] * 0.5)
            time.sleep(0.04)
        sink.close()

    def start(port):
        senders.append(threading.Thread(target=send, args=(port,), daemon=True))
        senders[0].start()

    stats = _session().rx_live(0, chunk_blocks=3, idle_timeout_s=2.0, input_rate=384_000,
                               on_listen=start)
    senders[0].join(timeout=10)
    assert not senders[0].is_alive()
    assert stats["payload_frames"] >= 5
    assert stats["lsf"] == {"dst": "AB1CDE", "src": "G4GUO"}
    assert stats["golay_errors"] == 0


def test_rx_live_passes_equalize_through(monkeypatch):
    """rx --udp passes its --equalize choice to the chunk decode."""
    seen = []
    real = streaming.run_chunk

    def spy(*a, **k):
        seen.append(k.get("equalize"))
        return real(*a, **k)

    monkeypatch.setattr(streaming, "run_chunk", spy)
    stats = _session().rx_live(0, idle_timeout_s=0.2, equalize="off")
    assert seen and set(seen) == {"off"}
    assert stats["blocks"] == 0


# -------------------------------------------------------------- audio repairs


def test_loopback_audio_two_writers_keep_writes_whole_and_in_order():
    """Two threads write 3.5-block chunks into one LoopbackAudio whose
    queue holds 2 blocks, while a reader drains it, so writers wait in the
    queue: the blocks read back form each chunk as one contiguous run,
    each writer's chunks in its order."""
    chunks, length = 60, 560
    audio = audiom.LoopbackAudio(max_blocks=2)
    got, done = [], threading.Event()

    def reader():
        while not done.is_set() or not audio._q.empty():
            blk = audio.audio_input(timeout=0.05)
            if blk is not None:
                got.append(blk)

    def writer(w):
        for i in range(chunks):
            audio.audio_output(np.full(length, w * 1000 + i, np.int16))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        rd = threading.Thread(target=reader)
        rd.start()
        threads = [threading.Thread(target=writer, args=(w,)) for w in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        done.set()
        rd.join(timeout=10)
        assert not any(t.is_alive() for t in [*threads, rd])
    finally:
        sys.setswitchinterval(old)
    stream = np.concatenate(got)
    assert all(len(b) == audiom.AUDIO_BLOCK for b in got)
    assert len(stream) == 2 * chunks * length // audiom.AUDIO_BLOCK * audiom.AUDIO_BLOCK
    starts = np.concatenate([[0], np.nonzero(np.diff(stream))[0] + 1])
    runs = [(int(stream[s]), int(e - s)) for s, e in zip(starts, [*starts[1:], len(stream)])]
    ids = [r[0] for r in runs]
    assert len(ids) == len(set(ids)) == 2 * chunks, "a chunk was split"
    assert all(n == length for _, n in runs[:-1])
    for w in (1, 2):
        mine = [i for i in ids if i // 1000 == w]
        assert mine == sorted(mine)


def test_device_sink_warns_once_when_the_player_dies(capsys):
    sink = audiom.DeviceSink(player=[sys.executable, "-c", "pass"])
    sink._proc.wait(timeout=30)
    for _ in range(3):
        sink.audio_output(np.zeros(8 * audiom.AUDIO_BLOCK * 10, np.int16))
        sink.audio_flush()
    sink.close()
    err = capsys.readouterr().err
    assert sink.broken
    assert err.count("warning: audio player") == 1, err
