"""The port's host layer -- its copies of the JAX package's ``io`` modules,
``runtime`` and the app modules without a modem (dbase, mmi, view) --
against the JAX package's, plus the port's CLI, the live UDP receiver
and the rule that the port imports nothing of JAX.

Host code is compared exactly: datagrams, PCM, GPS blobs, MMI responses
and session databases are equal.  The CLI runs on the CPU
(``--device cpu``); the live receiver's decode is held to the payloads
sent.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import FakeReflector

from m17_sdr_tpu.app import dbase as j_dbase
from m17_sdr_tpu.app import mmi as j_mmi
from m17_sdr_tpu.app import view as j_view
from m17_sdr_tpu.io import codec2 as j_codec2
from m17_sdr_tpu.io import gps as j_gps
from m17_sdr_tpu.io import hosts as j_hosts
from m17_sdr_tpu.io import reflector as j_refl
from m17_sdr_tpu.io import sources as j_sources
from m17_sdr_tpu_torch import runtime
from m17_sdr_tpu_torch.app import dbase as t_dbase
from m17_sdr_tpu_torch.app import mmi as t_mmi
from m17_sdr_tpu_torch.app import view as t_view
from m17_sdr_tpu_torch.app.session import Session
from m17_sdr_tpu_torch.io import codec2 as t_codec2
from m17_sdr_tpu_torch.io import gps as t_gps
from m17_sdr_tpu_torch.io import hosts as t_hosts
from m17_sdr_tpu_torch.io import ptt as t_ptt
from m17_sdr_tpu_torch.io import reflector as t_refl
from m17_sdr_tpu_torch.io import sources as t_sources
from m17_sdr_tpu_torch.runtime import DatagramQueue, SampleRing, UdpTransport

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
GLL = "$GPGLL,5048.22247,N,00026.51350,W,191209.00,A,A*77"
GGA = "$GPGGA,132334.00,5048.22218,N,00026.51640,W,1,07,1.14,11.4,M,45.8,M,,*74"


def _db(db) -> dict:
    """A Dbase as a plain dict (enums by value)."""
    return {k: (v.value if isinstance(v, enum.Enum) else v)
            for k, v in dataclasses.asdict(db).items()}


# ---------------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------------

def test_runtime_builds_from_the_port_source():
    assert runtime.SOURCE == REPO / "m17_sdr_tpu_torch" / "csrc" / "m17_runtime.cpp"
    assert runtime.lib_path().parent == REPO / "build"
    runtime.lib()
    assert runtime.lib_path().exists()


def test_sample_ring_and_datagram_queue():
    r = SampleRing(32, 8)
    for i in range(8):
        assert r.push(bytes([i]) * 32)
    assert not r.push(b"x" * 32)                 # full
    assert len(r) == 8
    for i in range(8):
        assert r.pop() == bytes([i]) * 32
    assert r.pop() is None
    r.close()
    q = DatagramQueue(capacity=200)
    for _ in range(200):
        assert q.push(b"M17 " + bytes(50))
    assert not q.push(b"overflow")
    assert len(q) == 200
    assert q.pop() == b"M17 " + bytes(50)
    assert not q.push(b"") and not q.push(bytes(65536))
    q.close()



def test_sample_ring_moves_arrays():
    """The streaming receiver's use: int16 blocks pushed from their own
    buffer and popped into a caller's array, in order; sizes checked."""
    rng = np.random.default_rng(3)
    blocks = [rng.integers(-2**15, 2**15, (2, 5, 2), dtype=np.int16) for _ in range(6)]
    r = SampleRing(blocks[0].nbytes, 4)
    try:
        for b in blocks[:4]:
            assert r.push(b)
        assert not r.push(blocks[4])              # full
        out = np.empty_like(blocks[0])
        for b in blocks[:4]:
            assert r.pop_into(out)
            np.testing.assert_array_equal(out, b)
        assert not r.pop_into(out)
        with pytest.raises(ValueError):
            r.push(np.zeros(3, np.int16))
        with pytest.raises(ValueError):
            r.pop_into(np.empty(3, np.int16))
    finally:
        r.close()

def test_udp_roundtrip():
    """bind_port 0 binds a free port the kernel picks, read back by
    local_port, so no test names a machine-wide port."""
    b = UdpTransport("127.0.0.1", 0)
    a = UdpTransport("127.0.0.1", b.local_port)
    assert b.local_port and a.local_port and a.local_port != b.local_port
    b.start_rx()
    try:
        a.send(b"PING" + bytes(6))
        deadline = time.monotonic() + 5.0
        while (got := b.poll()) is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert got == b"PING" + bytes(6)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# io copies
# ---------------------------------------------------------------------------

def test_reflector_datagrams_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        sid = int(rng.integers(0, 1 << 16))
        lich = rng.integers(0, 256, 28, dtype=np.uint8).tobytes()
        fn = int(rng.integers(0, 1 << 16))
        pl = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        dgram = t_refl.pack_voice_frame(sid, lich, fn, pl)
        assert dgram == j_refl.pack_voice_frame(sid, lich, fn, pl)
        assert vars(t_refl.parse_voice_frame(dgram)) == vars(j_refl.parse_voice_frame(dgram))
        bad = bytearray(dgram)
        bad[40] ^= 0xFF
        assert t_refl.parse_voice_frame(bytes(bad)) is None
        call = int(rng.integers(0, 1 << 47))
        for name in ("pack_ping", "pack_pong", "pack_disc"):
            assert getattr(t_refl, name)(call) == getattr(j_refl, name)(call)
        assert t_refl.pack_conn(call, "C") == j_refl.pack_conn(call, "C")
    assert t_refl.pack_disc() == j_refl.pack_disc() == b"DISC"


def test_reflector_client_against_fake_reflector():
    """CONN -> ACKN, PING -> PONG, and voice, against a fake reflector."""
    refl = FakeReflector()
    client = t_refl.ReflectorClient("127.0.0.1", port=refl.port)
    try:
        client.connect("N0CALL", "B")
        time.sleep(0.3)
        conn = refl.poll()
        assert conn == j_refl.pack_conn(j_refl.cs.encode_callsign("N0CALL  G"), "B")
        refl.send(b"ACKN")
        refl.send(t_refl.pack_ping(0))
        time.sleep(0.3)
        assert client.poll() == [] and client.active
        time.sleep(0.2)
        assert refl.poll()[:4] == b"PONG"
        refl.send(t_refl.pack_voice_frame(7, bytes(28), 3, bytes(16)))
        time.sleep(0.3)
        frames = client.poll()
        assert len(frames) == 1 and frames[0].fn == 3
    finally:
        client.close()
        refl.close()


def test_sources_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    iq = (rng.normal(size=1920 * 2) + 1j * rng.normal(size=1920 * 2))
    iq = (iq / np.abs(iq).max()).astype(np.complex64)
    wire = t_sources.iq_to_wire(iq)
    np.testing.assert_array_equal(wire, j_sources.iq_to_wire(iq))
    np.testing.assert_array_equal(t_sources.wire_to_iq(wire), j_sources.wire_to_iq(wire))
    sink = t_sources.FileSink(tmp_path / "cap.iq")
    sink.transmit_samples(iq)
    sink.close()
    got = list(t_sources.FileSource(tmp_path / "cap.iq").blocks())
    want = list(j_sources.FileSource(tmp_path / "cap.iq").blocks())
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_hosts_lookup_equal_jax(tmp_path):
    f = tmp_path / "M17Hosts.txt"
    f.write_text("M17-M17 152.70.192.70 17000\nREF2 10.0.0.1 17001\nbad line x\n")
    assert t_hosts.load_hosts(f) == j_hosts.load_hosts(f)
    assert t_hosts.find_reflector("REF2", f) == ("10.0.0.1", 17001)
    shipped = REPO / "assets" / "M17Hosts.txt"
    assert t_hosts.load_hosts(shipped) == j_hosts.load_hosts(shipped)


def test_codec2_stand_in_pcm_equal_jax():
    rng = np.random.default_rng(2)
    assert t_codec2.Codec2().is_real == j_codec2.Codec2().is_real
    for _ in range(10):
        speech = (rng.normal(size=160) * rng.uniform(10, 8000)).astype(np.int16)
        frame = t_codec2._fallback_encode(speech)
        assert frame == j_codec2._fallback_encode(speech)
        np.testing.assert_array_equal(t_codec2._fallback_decode(frame),
                                      j_codec2._fallback_decode(frame))


def test_gps_equal_jax():
    for pkg in (t_gps, j_gps):
        assert pkg.nmea_checksum_ok(GLL) and not pkg.nmea_checksum_ok("garbage")
    for sentence in (GLL, GGA):
        ft, fj = t_gps.GpsFix(), j_gps.GpsFix()
        assert t_gps.parse_nmea(sentence, ft) == j_gps.parse_nmea(sentence, fj)
        assert dataclasses.asdict(ft) == dataclasses.asdict(fj)
    for lat, lon, alt in ((50.8037, -0.4419, 123), (-33.8688, 151.2093, 20), (1.5, 2.5, 0)):
        kw = dict(lat=lat, lon=lon, alt=alt, course=270, speed=55, object_id=0xABCDE)
        blob = t_gps.encode_gps_meta(t_gps.GpsFix(**kw))
        np.testing.assert_array_equal(blob, j_gps.encode_gps_meta(j_gps.GpsFix(**kw)))
        np.testing.assert_array_equal(t_gps.gps_meta_for_lsf(t_gps.GpsFix(**kw)),
                                      j_gps.gps_meta_for_lsf(j_gps.GpsFix(**kw)))
        assert dataclasses.asdict(t_gps.decode_gps_meta(blob)) == \
            dataclasses.asdict(j_gps.decode_gps_meta(blob))


def test_ptt_stub_and_sysfs(tmp_path):
    p = t_ptt.Ptt(root="/nonexistent/gpio")
    assert not p.hardware
    p.set()
    assert p.get()
    p.clear()
    assert not p.get() and p.read() is False
    root = tmp_path / "gpio"
    root.mkdir()
    (root / "export").write_text("")
    for pin in (10, 11):
        (root / f"gpio{pin}").mkdir()
        (root / f"gpio{pin}" / "direction").write_text("")
        (root / f"gpio{pin}" / "value").write_text("1")
    p = t_ptt.Ptt(root=str(root))
    assert p.hardware
    p.set()
    assert (root / "gpio10" / "value").read_text() == "1"
    p.clear()
    assert (root / "gpio10" / "value").read_text() == "0"
    (root / "gpio11" / "value").write_text("0")
    assert p.read() is True


# ---------------------------------------------------------------------------
# app copies without a modem
# ---------------------------------------------------------------------------

COMMANDS = ["sa g4guo", "da ab1cde", "ba", "tf 434000000", "rf 433500000", "afc on",
            "afc off", "mode gate", "tg 0.7", "tg 1.5", "rg 0.3", "fc 1.5", "zz",
            "# comment", "ga g4guo x", "mode client", "mode loop", "tx", "rx", "td",
            "tc", "w", "h", "da m17-m17 c", "mode radio"]


def test_mmi_command_set_equal_jax():
    mt, mj = t_mmi.Mmi(), j_mmi.Mmi()
    for line in COMMANDS:
        assert mt.parse(line) == mj.parse(line), line
        assert _db(mt.db) == _db(mj.db), line
    assert mt.db.tx_dest_call == "M17-M17" and mt.db.chan_type == t_dbase.CircuitType.DRTOAS


def test_shipped_config_loads_as_in_jax():
    mt, mj = t_mmi.Mmi(), j_mmi.Mmi()
    mt.load_file(REPO / "assets" / "config.txt")
    mj.load_file(REPO / "assets" / "config.txt")
    assert "Invalid command" not in mt.responses
    assert mt.responses == mj.responses
    assert _db(mt.db) == _db(mj.db)
    assert mt.db.tx_freq == 144962500 and mt.db.tx_gate_call == "N0CALL  G"


def test_view_renders_as_in_jax():
    for signal in (0.0, 0.5, 1.0):
        dt, dj = t_dbase.Dbase(), j_dbase.Dbase()
        dt.rx_src = dj.rx_src = 0x1234
        assert t_view.render(dt, signal=signal) == j_view.render(dj, signal=signal)


# ---------------------------------------------------------------------------
# the port imports nothing of JAX
# ---------------------------------------------------------------------------

def test_port_and_chip_smoke_import_no_jax():
    """Every module of the port, its CLI and chip_smoke.py import with jax
    and the JAX package blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['m17_sdr_tpu'] = None\n"
        "import m17_sdr_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(m17_sdr_tpu_torch.__path__,"
        " 'm17_sdr_tpu_torch.')]\n"
        "for m in mods + ['m17_sdr_tpu_torch.app.main', 'chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'm17_sdr_tpu.'))"
        " for k, v in sys.modules.items() if v is not None)\n"
        "print(len(mods))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout) > 40


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(*args, check=True):
    r = subprocess.run([sys.executable, "-m", "m17_sdr_tpu_torch.app.main", *args],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    if check:
        assert r.returncode == 0, r.stderr
    return r


def test_cli_tx_rx_on_cpu(tmp_path):
    rng = np.random.default_rng(4)
    sent = rng.integers(0, 256, (4, 16), dtype=np.uint8).tobytes()
    (tmp_path / "voice.bin").write_bytes(sent)
    iq, pay, st = (str(tmp_path / n) for n in ("tx.iq", "rx.bin", "st.npz"))
    tx = json.loads(_cli("--device", "cpu", "tx", "--out", iq, "--payload",
                         str(tmp_path / "voice.bin"), "--src", "G4GUO",
                         "--dest", "AB1CDE").stdout)
    assert tx == {"samples": 9 * 1920, "frames": 4}
    rx = json.loads(_cli("--device", "cpu", "rx", "--in", iq, "--payload-out", pay,
                         "--save-state", st).stdout)
    assert rx["payload_frames"] == 4 and rx["golay_errors"] == 0
    assert rx["lsf"] == {"dst": "AB1CDE", "src": "G4GUO"}
    assert Path(pay).read_bytes() == sent
    with np.load(st) as z:
        assert "dec_tail" in z.files and "rx/receiver/index" in z.files


def test_cli_bert_on_cpu():
    out = json.loads(_cli("--device", "cpu", "bert", "--channels", "2", "--frames", "4",
                          "--snr", "25").stdout)
    assert out["errors"] == 0 and out["bits"] == 2 * 4 * 197 and out["ber"] == 0.0


def test_cli_needs_a_card_or_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the CLI's default device works")
    r = _cli("bert", "--channels", "1", check=False)
    assert r.returncode != 0 and "--device cpu" in r.stderr and not r.stdout


def test_cli_sweep_on_cpu_and_pod_exits_2():
    points = json.loads(_cli("--device", "cpu", "sweep", "--points", "2", "--channels", "2",
                             "--frames", "2", "--snr-min", "20").stdout)
    assert [p["snr_db"] for p in points] == [20.0, 21.0]
    assert all(p["bit_errors"] == 0 and p["frames_sent"] == 4 for p in points)
    # --pod runs on a one-rank world and prints the JAX CLI's keys
    pod = json.loads(_cli("--device", "cpu", "sweep", "--pod", "--points", "2", "--channels",
                          "2", "--frames", "2", "--snr-min", "20").stdout)
    assert set(pod) == {"mesh_devices", "channels", "totals_psum", "points"}
    assert pod["mesh_devices"] == 1 and pod["channels"] == 2
    assert [p["snr_db"] for p in pod["points"]] == [20.0, 21.0]


# ---------------------------------------------------------------------------
# live receive over UDP
# ---------------------------------------------------------------------------

def test_rx_live_over_udp_decodes_mid_stream(tmp_path):
    """A sender streams a capture as UDP block datagrams while rx_live
    decodes it in 3-block chunks: the sender holds back the rest of the
    capture until the first chunk has decoded, so decoding happens
    mid-stream however slow the host; every payload is routed."""
    tx = Session(device="cpu")
    tx.db.tx_src_call, tx.db.tx_dest_call = "G4GUO", "AB1CDE"
    rng = np.random.default_rng(12)
    sent = rng.integers(0, 256, (6, 16), dtype=np.uint8)
    (tmp_path / "voice.bin").write_bytes(sent.tobytes())
    tx.tx_file(str(tmp_path / "cap.iq"), payload_in=str(tmp_path / "voice.bin"))
    blocks = list(t_sources.FileSource(tmp_path / "cap.iq").blocks())
    decoded = threading.Event()

    def send(port):
        sink = t_sources.UdpSampleSink("127.0.0.1", port)
        for i, blk in enumerate(blocks):
            if i == 3:
                decoded.wait(timeout=120.0)       # the first chunk decodes first
            sink.transmit_samples(blk)
            time.sleep(0.02)
        sink.close()

    events, sender = [], []

    def on_listen(port):
        assert port
        sender.append(threading.Thread(target=send, args=(port,), daemon=True))
        sender[0].start()

    def on_chunk(stats):
        events.append((stats, sender[0].is_alive()))
        decoded.set()

    rx = Session(device="cpu")
    stats = rx.rx_live(0, payload_out=str(tmp_path / "live.bin"), chunk_blocks=3,
                       idle_timeout_s=5.0, on_chunk=on_chunk, on_listen=on_listen)
    sender = sender[0]
    sender.join(timeout=10.0)
    assert not sender.is_alive()
    assert stats["blocks"] == len(blocks) and stats["payload_frames"] == 6
    assert stats["lsf"] == {"dst": "AB1CDE", "src": "G4GUO"} and stats["golay_errors"] == 0
    assert (tmp_path / "live.bin").read_bytes() == sent.tobytes()
    assert events[0][1] and len(events) == -(-len(blocks) // 3)
    assert all(s["turnaround_s"] > 0 for s, _ in events)
    assert rx.db.rssi > 0.1 and rx.db.golay_errors == 0
