"""Circuit session engine: the mode loops of m17_tx_rx.cpp, hardware-free.

Port of ``m17_sdr_tpu.app.session``.  The reference runs one of four
circuit loops picked by CircuitType (m17_txrx_threads,
m17_tx_rx.cpp:238-257).  Here each loop is a method over file/memory/UDP
backends preserving the radio HAL contract (48 kHz IQ blocks), with the
modem work executed by the port's batched pipelines on ``device``
(default CUDA; the tests ask for the CPU).  The gateway jitter-buffer
policy (key up above 15 queued frames, drain until empty, EOT --
m17_tx_rx.cpp:28-81) is kept.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass, field

import numpy as np
import torch

from ..frame import tx_frames
from ..io import audio as audiom
from ..io import codec2 as c2
from ..io import gps as gpsm
from ..io import ptt as pttm
from ..io.reflector import ReflectorClient, VoiceFrame
from ..dsp import iq as iqp
from ..io.sources import FileSink, FileSource, iq_to_wire
from ..pipeline import tx as txp
from ..pipeline.rx import RxSessionState, rx_block
from . import streaming
from ..spec import bits as bitpack
from ..spec import callsign as cs
from ..spec.constants import BLOCK_SAMPLES
from ..spec.typefield import M17Type
from .dbase import Dbase

GATEWAY_KEYUP_THRESHOLD = 15   # frames buffered before key-up (m17_tx_rx.cpp:40)


def _host_bytes(x: np.ndarray, device) -> torch.Tensor:
    """[N] host uint8 -> [1, N] uint8 tensor on ``device``."""
    return torch.as_tensor(np.array(x, dtype=np.uint8))[None].to(device)


def _lsf_for(db: Dbase, device, type_word: int | None = None) -> torch.Tensor:
    dst = _host_bytes(bitpack.word_to_bytes(db.tx_dest, 6), device)
    src = _host_bytes(bitpack.word_to_bytes(db.tx_src, 6), device)
    tw = torch.tensor([M17Type().pack() if type_word is None else type_word],
                      dtype=torch.int64, device=device)
    if len(db.meta) == 14:
        meta = _host_bytes(np.frombuffer(db.meta, np.uint8), device)
    else:
        meta = torch.zeros((1, 14), dtype=torch.uint8, device=device)
    return tx_frames.build_lsf_bytes(dst, src, tw, meta)


def _lsf_from_net(vf: VoiceFrame, device) -> torch.Tensor:
    """RF LSF rebuilt from a received network voice frame's LICH --
    the gatewayed stream must go out under the ORIGINATOR's
    src/dst/type/meta, not the gateway's own
    (m17_fmt_add_link_setup_frame_fm_net, m17_tx_routines.cpp:121-137;
    called from the net->RF key-up at m17_tx_rx.cpp:47)."""
    dst = _host_bytes(bitpack.word_to_bytes(vf.dst, 6), device)
    src = _host_bytes(bitpack.word_to_bytes(vf.src, 6), device)
    tw = torch.tensor([vf.type_word], dtype=torch.int64, device=device)
    meta = _host_bytes(np.frombuffer(vf.meta.ljust(14, b"\0")[:14], np.uint8), device)
    return tx_frames.build_lsf_bytes(dst, src, tw, meta)


@dataclass
class Session:
    db: Dbase = field(default_factory=Dbase)
    codec: c2.Codec2 = field(default_factory=c2.Codec2)
    reflector: ReflectorClient | None = None
    # GPIO transmit key, driven around every transmission exactly like
    # radio_transmit/radio_receive call rpi_tx/rpi_rx (radio.cpp:74-98)
    ptt: pttm.Ptt = field(default_factory=pttm.Ptt)
    # where the modem runs: "cuda" (the kernels) unless the caller asks
    # for the CPU (the plain versions)
    device: str = "cuda"

    # ------------------------------------------------------------------
    # DRTOAS receive: IQ capture -> voice payloads (+ audio if codec2)
    # ------------------------------------------------------------------
    def rx_file(self, iq_path: str | list[str],
                payload_out: str | None = None,
                audio_out: str | None = None,
                input_rate: int = 48_000,
                chunk_blocks: int = streaming.DEFAULT_CHUNK_BLOCKS,
                resume_state: str | None = None,
                save_state: str | None = None,
                equalize: bool | str = "auto",
                packet_out: str | None = None) -> dict:
        """Decode one or more IQ capture files; mirrors the PTT_RX loop
        (m17_tx_rx.cpp:160-170) via the device-resident streaming
        engine: chunked dispatch, on-device state, ONE device->host
        transfer at session end (app/streaming.py).

        A list of paths decodes B independent channels IN ONE BATCH --
        the framework's channel dimension surfaced at the CLI (the
        reference is structurally single-channel, m17_tx_rx.cpp:238).
        Per-channel results come back under stats["channels"];
        payload_out/audio_out get ".ch<N>" suffixes for batch > 1.

        input_rate 384000 engages the Pluto-rate x8 decimating FIR
        front end (radio.cpp:157-177) before the 48 kHz modem chain.
        """
        import os

        paths = [iq_path] if isinstance(
            iq_path, (str, bytes, os.PathLike)) else list(iq_path)
        batch = len(paths)
        srx = streaming.StreamingRx(
            batch=batch, input_rate=input_rate, afc=self.db.afc,
            equalize=equalize, chunk_blocks=chunk_blocks, device=self.device)
        if resume_state:
            srx.resume(resume_state)
        if batch == 1:
            srx.run(streaming.wire_block_iter(paths[0], srx.block_in))
        else:
            srx.run(streaming.batch_wire_block_iter(paths, srx.block_in))
        if save_state:
            srx.checkpoint(save_state)
        out, state, n_blocks = srx.finish()

        # packet-mode reassembly (decode_packet_frame chunks + EOF +
        # whole-superframe CRC, m17_rx_parse.cpp:34-51)
        packets: list[bytes | None] = [None] * batch
        if out is not None:
            from ..pipeline import loopback

            packets = loopback.reassemble_packets(out)

        per_ch = []
        for ch in range(batch):
            ch_stats = {"frames": 0, "golay_errors": 0, "lsf": None}
            payloads: list[bytes] = []
            speech: list[np.ndarray] = []
            if out is not None:
                sv = out.stream_valid[ch].reshape(-1)       # [NBLK*F]
                gate = out.stream_gate[ch].reshape(-1)
                pls = out.stream_payload[ch].reshape(-1, 16)
                ch_stats["frames"] = int(np.sum(sv))
                for i in np.nonzero(sv & gate)[0]:
                    pl = bytes(pls[i])
                    payloads.append(pl)
                    # two codec2 frames per 40 ms payload
                    # (sound_data_received, m17_rx_parse.cpp:26-32)
                    speech.append(self.codec.decode(pl[:8]))
                    speech.append(self.codec.decode(pl[8:]))
            ch_stats["golay_errors"] = int(
                np.asarray(state.golay_errors)[ch])
            ch_stats["rssi"] = round(
                float(np.asarray(state.frontend.rssi)[ch]), 4)
            if bool(np.asarray(state.lich_good_valid)[ch]):
                lsf = np.asarray(state.lich_good)[ch]
                ch_stats["lsf"] = {
                    "dst": cs.decode_callsign(
                        int(bitpack.bytes_to_word_host(lsf[0:6]))).strip(),
                    "src": cs.decode_callsign(
                        int(bitpack.bytes_to_word_host(lsf[6:12]))).strip(),
                }
                meta = lsf[14:28]
                if meta.any():
                    ch_stats["lsf"]["meta"] = bytes(meta).hex()
                    fix = gpsm.decode_gps_meta(np.concatenate([meta, [0]]))
                    ch_stats["lsf"]["gps"] = {
                        "lat": round(fix.lat, 5), "lon": round(fix.lon, 5),
                        "alt_ft": fix.alt,
                    }
            suffix = f".ch{ch}" if batch > 1 else ""
            if payload_out:
                with open(payload_out + suffix, "wb") as f:
                    for p in payloads:
                        f.write(p)
            if audio_out and speech:
                audiom.write_pcm(audio_out + suffix,
                                 np.concatenate(speech))
            if packets[ch] is not None:
                ch_stats["packet_bytes"] = len(packets[ch])
                if packet_out:
                    with open(packet_out + suffix, "wb") as f:
                        f.write(packets[ch])
            # on-air BERT measurement: any decoded BERT frames are
            # PRBS9-aligned and scored (the checker the reference
            # never wired in, m17_prbs9.cpp:40-64 / m17_rx_parse.cpp:
            # 178-180)
            if out is not None:
                bv = out.bert_valid[ch].reshape(-1)
                if bv.any():
                    from ..spec import prbs

                    bb = out.bert_bits[ch].reshape(bv.shape[0], -1)
                    nerr, nbits, nuns = prbs.check_stream(
                        np.asarray(bb[np.nonzero(bv)[0]]))
                    ch_stats["bert"] = {
                        "frames": int(bv.sum()), "bits": nbits,
                        "errors": nerr,
                        # frames booked at the estimated-50% dead-link
                        # rate because no PRBS alignment held -- their
                        # error mass is estimated, not measured
                        "unsynced_frames": nuns,
                        "ber": (nerr / nbits) if nbits else None,
                    }
            ch_stats["payload_frames"] = len(payloads)
            per_ch.append(ch_stats)

        # channel 0 mirrors into the shared database, like the
        # reference's single channel updates M17_Dbase
        self.db.golay_errors = per_ch[0]["golay_errors"]
        self.db.n_frames = int(np.asarray(state.n_frames)[0])
        self.db.rssi = float(np.asarray(state.frontend.rssi)[0])
        if per_ch[0]["lsf"]:
            lsf0 = np.asarray(state.lich_good)[0]
            self.db.rx_dest = int(bitpack.bytes_to_word_host(lsf0[0:6]))
            self.db.rx_src = int(bitpack.bytes_to_word_host(lsf0[6:12]))

        if batch == 1:
            return {"blocks": n_blocks, **per_ch[0]}
        return {"blocks": n_blocks, "batch": batch,
                "frames": sum(c["frames"] for c in per_ch),
                "payload_frames": sum(c["payload_frames"] for c in per_ch),
                "channels": per_ch}

    # ------------------------------------------------------------------
    # live DRTOAS receive: UDP IQ stream -> voice, decoded MID-STREAM
    # ------------------------------------------------------------------
    def rx_live(self, listen_port: int,
                audio_out: str | None = None,
                payload_out: str | None = None,
                chunk_blocks: int = 5,
                idle_timeout_s: float = 2.0,
                max_blocks: int | None = None,
                on_chunk=None,
                forever: bool = False,
                stop=None,
                input_rate: int = 48_000,
                equalize: bool | str = "auto",
                on_listen=None) -> dict:
        """The reference's normal operating mode: an open-ended
        real-time RX loop -- samples arrive continuously and voice
        exits continuously (m17_txrx_thread PTT_RX, m17_tx_rx.cpp:
        160-170, fed by the blocking radio at 48 kHz) -- with a UDP IQ
        sample stream as the radio (io/sources.UdpSampleSource, the
        radio_receive_samples contract over the network).

        Every `chunk_blocks` received 40 ms blocks are decoded in one
        device dispatch and the results are acted on IMMEDIATELY:
        gated voice payloads go through codec2 to `audio_out` (a
        device spec like "pulse"/"alsa"/"default" plays live through
        io/audio.DeviceSink; a path writes wav/raw), and the shared
        database's rssi / in_frame / callsign fields update so a
        live view (repl --live --udp) tracks the session as it
        happens.  The loop ends after `idle_timeout_s` of socket
        silence (the reference's loop is infinite; a session needs an
        exit) or `max_blocks` blocks; `forever=True` restores the
        reference's infinite-loop semantics (silence just flushes the
        pending chunk and keeps listening) until the `stop`
        threading.Event is set -- the repl --live --udp mode.

        Each chunk's results are read to the host as it decodes.
        `on_chunk(stats)` is called after each decoded chunk, with the
        chunk's turnaround (upload, decode and host read) in seconds
        under "turnaround_s".  `listen_port` 0 listens on a free port
        the kernel picks; `on_listen(port)` is called with the port once
        the socket is bound, before any device set-up.
        """
        import time

        from ..io.sources import UdpSampleSource

        # bind the socket FIRST: the transport's RX thread queues
        # datagrams from the moment the port exists, so the (possibly
        # seconds-long) device set-up and kernel build below lose nothing
        factor = streaming.rate_factor(input_rate)
        src = UdpSampleSource(listen_port, timeout_s=idle_timeout_s,
                              block=BLOCK_SAMPLES * factor)
        if on_listen is not None:
            on_listen(src.port)

        def chunk_fn(chunk, state):
            return streaming.run_chunk(chunk, state, afc=self.db.afc,
                                       factor=factor, equalize=equalize)

        state = streaming.StreamChunkState.init(1, self.device)

        sink = audiom.open_sink(audio_out) if audio_out else None
        pay_f = open(payload_out, "wb") if payload_out else None
        stats = {"blocks": 0, "frames": 0, "payload_frames": 0,
                 "chunks": 0, "lsf": None, "golay_errors": 0}
        self.ptt.clear()

        # warm the chunk path BEFORE consuming samples: the first call
        # builds and loads the kernels (seconds), and a live session must
        # not stall its opening chunks on that (datagrams arriving
        # meanwhile sit in the transport's queue)
        warm = torch.zeros((1, chunk_blocks, BLOCK_SAMPLES * factor, 2),
                           dtype=torch.int16, device=self.device)
        chunk_fn(warm, state)[1].rx.n_frames.cpu()    # result discarded

        def process(pending: list[np.ndarray]) -> None:
            nonlocal state
            t0 = time.perf_counter()
            chunk = torch.from_numpy(np.stack(pending, axis=0)[None]).to(self.device)
            out, state = chunk_fn(chunk, state)
            sv = out.stream_valid[0].cpu().numpy().reshape(-1)
            gate = out.stream_gate[0].cpu().numpy().reshape(-1)
            pls = out.stream_payload[0].cpu().numpy().reshape(-1, 16)
            stats["chunks"] += 1
            stats["frames"] += int(sv.sum())
            for i in np.nonzero(sv & gate)[0]:
                pl = bytes(pls[i])
                stats["payload_frames"] += 1
                if pay_f:
                    pay_f.write(pl)
                if sink:
                    # two codec2 frames per 40 ms payload, played as
                    # they decode (sound_data_received,
                    # m17_rx_parse.cpp:26-32 -> audio_io.cpp:44-59)
                    sink.audio_output(self.codec.decode(pl[:8]))
                    sink.audio_output(self.codec.decode(pl[8:]))
            # mirror channel 0 into the shared DB like the reference
            # updates M17_Dbase mid-session
            rx = streaming.to_host(state.rx)
            turnaround = time.perf_counter() - t0
            self.db.rssi = float(np.asarray(rx.frontend.rssi)[0])
            self.db.in_frame = bool(np.asarray(rx.receiver.flock)[0])
            self.db.n_frames = int(np.asarray(rx.n_frames)[0])
            self.db.golay_errors = int(np.asarray(rx.golay_errors)[0])
            stats["golay_errors"] = self.db.golay_errors
            if bool(np.asarray(rx.lich_good_valid)[0]):
                lsf = np.asarray(rx.lich_good)[0]
                self.db.rx_dest = int(bitpack.bytes_to_word_host(lsf[0:6]))
                self.db.rx_src = int(bitpack.bytes_to_word_host(lsf[6:12]))
                stats["lsf"] = {
                    "dst": cs.decode_callsign(self.db.rx_dest).strip(),
                    "src": cs.decode_callsign(self.db.rx_src).strip(),
                }
            if on_chunk:
                # turnaround_s: upload, decode and host read of this chunk
                on_chunk({**stats, "turnaround_s": turnaround})

        try:
            pending: list[np.ndarray] = []
            while not (stop is not None and stop.is_set()):
                wire = src.receive_wire()       # [block, 2] int16
                if wire is None:                # idle_timeout_s silence
                    if pending:
                        process(pending)
                        pending = []
                    if forever:
                        continue
                    break
                pending.append(wire)
                stats["blocks"] += 1
                if len(pending) >= chunk_blocks:
                    process(pending)
                    pending = []
                if max_blocks and stats["blocks"] >= max_blocks:
                    break
            if pending:
                process(pending)
        finally:
            src.close()
            if sink:
                sink.close()
            if pay_f:
                pay_f.close()
        return stats

    # ------------------------------------------------------------------
    def _transmit_dibits(self, dibits, iq_path: str,
                         factor: int = 1) -> int:
        """Key the PTT, modulate one channel's dibit stream, and write
        int16 IQ to iq_path -- the single transmit convention every TX
        path shares (radio_transmit -> rpi_tx at PTT_TX entry,
        m17_tx_rx.cpp:88-93; radio_receive -> rpi_rx after EOT,
        m17_tx_rx.cpp:118).  Amplitude = tx_gain * 2.0: unity output
        at the default gain 0.5, keeping every capture this framework
        emits at one level."""
        self.ptt.set()
        self.db.ptt = True
        try:
            iq, _ = txp.dibits_to_iq(dibits, oversample=10 * factor)
            sink = FileSink(iq_path)
            n = sink.transmit_samples(iqp.to_complex(iq[0]) * self.db.tx_gain * 2.0)
            sink.close()
        finally:
            self.ptt.clear()
            self.db.ptt = False
        return n

    # ------------------------------------------------------------------
    # DRTOAS transmit: audio/payloads -> IQ capture
    # ------------------------------------------------------------------
    def tx_file(self, iq_path: str, audio_in: str | None = None,
                payload_in: str | None = None, n_frames: int = 10,
                output_rate: int = 48_000,
                packet_in: str | None = None,
                bert_frames: int | None = None) -> dict:
        """Encode a transmission; mirrors the PTT_TX loop
        (m17_tx_rx.cpp:88-119): carrier+preambles, LSF, stream frames,
        EOT.  `packet_in` sends the file's bytes as an M17 packet-mode
        superframe instead of a voice stream (the packet TX path the
        reference left dormant, m17_tx_routines.cpp:323-353);
        `bert_frames` sends a PRBS9 BERT session (the on-air bit-error
        test the reference started and never finished: TX frames at
        m17_tx_routines.cpp:226-238, the RX checker never called).

        output_rate scales the TX polyphase oversample like the HAL
        does (10 at 48 k Lime, 80 at 384 k Pluto; radio.cpp:211-219).
        """
        factor = streaming.rate_factor(output_rate)
        if bert_frames is not None:
            if bert_frames <= 0:
                raise ValueError(f"--bert needs a positive frame count, "
                                 f"got {bert_frames}")
            n = self._transmit_dibits(
                txp.build_bert_session_dibits(1, bert_frames, device=self.device),
                iq_path, factor)
            return {"samples": n, "bert_frames": int(bert_frames)}
        if packet_in:
            from ..spec.typefield import CCT_PACKET, DATA_DATA, M17Type

            data = np.fromfile(packet_in, dtype=np.uint8)
            # 5-bit frame counter + 25-byte chunks + CRC-16 cap the M17
            # packet superframe at 823 data bytes (33 frames x 25 - 2);
            # beyond that the counter would wrap and any spec receiver
            # misassembles (m17_tx_routines.cpp:211 masks with 0x1F)
            if len(data) > 823:
                raise ValueError(
                    f"packet too large: {len(data)} bytes > the M17 "
                    "823-byte superframe limit (split the file)")
            # same identity/META as every other TX (a GPS fix in
            # db.meta rides along), packet-mode TYPE word
            lsf = _lsf_for(self.db, self.device, M17Type(
                packet_stream=CCT_PACKET, data_type=DATA_DATA).pack())
            n = self._transmit_dibits(
                txp.build_packet_session_dibits(lsf, _host_bytes(data, self.device)),
                iq_path, factor)
            return {"samples": n, "packet_bytes": int(len(data))}
        if payload_in:
            raw = np.fromfile(payload_in, dtype=np.uint8)
            nf = len(raw) // 16
            payloads = raw[: nf * 16].reshape(1, nf, 16)
        elif audio_in:
            # mic device: 2 x 160-sample blocking reads per 40 ms frame
            # (m17_tx_rx.cpp:104-108); .wav or raw S16LE per extension
            mic = audiom.open_source(audio_in)
            frames = []
            while True:
                a_pcm = mic.audio_input()
                b_pcm = mic.audio_input()
                if a_pcm is None or b_pcm is None:
                    break
                a = self.codec.encode(a_pcm)
                b = self.codec.encode(b_pcm)
                frames.append(np.frombuffer(a + b, dtype=np.uint8))
            mic.close()
            payloads = np.stack(frames)[None] if frames else \
                np.zeros((1, 0, 16), np.uint8)
        else:
            rng = np.random.default_rng(0)
            payloads = rng.integers(0, 256, (1, n_frames, 16), dtype=np.uint8)

        lsf = _lsf_for(self.db, self.device)
        n = self._transmit_dibits(
            txp.build_voice_session_dibits(
                lsf, torch.as_tensor(payloads).to(self.device)),
            iq_path, factor)
        return {"samples": n, "frames": int(payloads.shape[1])}

    # ------------------------------------------------------------------
    # DRTOAS live transmit: open-ended mic -> modulator -> sample sink
    # ------------------------------------------------------------------
    def tx_live(self, sink, audio_in: str = "device",
                max_frames: int | None = None,
                output_rate: int = 48_000,
                pace: bool = False,
                on_frame=None) -> dict:
        """The reference's live TX loop: block on real microphone audio,
        encode, frame, modulate, transmit -- open-ended until the mic
        ends or `max_frames` (PTT_TX, m17_tx_rx.cpp:88-119: two blocking
        20 ms audio_input reads per 40 ms stream frame pace the loop;
        the mic clock IS the TX clock).

        `sink` is any transmit_samples() backend (io/sources.UdpSampleSink
        for the live UDP radio contract, FileSink for capture).
        `audio_in` = "device"/"pulse"/"alsa" captures live through
        io/audio.DeviceSource (parec/arecord; M17_AUDIO_RECORDER
        overrides for headless tests); a path reads wav/raw, where
        `pace` restores real-time 40 ms pacing a real mic would give.
        Unlike tx_file, nothing is pre-built: the head (carrier +
        preambles + LSF) goes out first, then each frame is encoded and
        transmitted as its audio arrives, with the modulator's phase
        carried across calls -- mid-stream listeners join via LICH
        reassembly exactly as off a radio."""
        import time

        factor = streaming.rate_factor(output_rate)
        oversample = 10 * factor
        gain = self.db.tx_gain * 2.0

        mic = audiom.open_source(audio_in)
        dev = self.device
        lsf = _lsf_for(self.db, dev)
        stats = {"frames": 0, "samples": 0}
        self.ptt.set()
        self.db.ptt = True
        mod = None

        def send(dibits, mod):
            iq, mod = txp.dibits_to_iq(dibits, mod, oversample=oversample)
            stats["samples"] += sink.transmit_samples(iqp.to_complex(iq[0]) * gain)
            return mod

        try:
            # prebuffer the first mic block BEFORE keying up, as the
            # reference does (audio_mic_open + 120 ms prebuffer before
            # radio_transmit, m17_tx_rx.cpp:88-93): a live recorder
            # process can take O(100 ms..s) to deliver its first
            # sample, and sending the head first would put that whole
            # startup latency on the air as dead carrier-less time
            # between the LSF and frame 0 -- long enough for a
            # receiver's idle squelch to drop the session
            pre_pcm = mic.audio_input()
            # head: 2 x preamble + link setup (m17_tx_rx.cpp:95-101)
            head = torch.cat(
                [tx_frames.preamble_frame(1, dev), tx_frames.preamble_frame(1, dev),
                 tx_frames.build_link_setup_frame(lsf)], dim=-1)
            mod = send(head, mod)
            fn = 0
            t0 = time.monotonic()
            while max_frames is None or fn < max_frames:
                a_pcm, pre_pcm = ((pre_pcm, None) if pre_pcm is not None
                                  else (mic.audio_input(), None))
                b_pcm = mic.audio_input()
                if a_pcm is None or b_pcm is None:
                    break
                pl = self.codec.encode(a_pcm) + self.codec.encode(b_pcm)
                # FN wraps at 15 bits: the MSB is the M17 end-of-stream
                # marker, so an open-ended session (>32768 frames =
                # ~22 min) must not let the counter run into it.  (The
                # reference wraps at 0xFFFF, m17_tx_routines.cpp:170,
                # and would flag EOS on every frame of its 22nd minute;
                # rx here masks FN deltas to 15 bits either way.)
                frame = tx_frames.build_stream_frame(
                    lsf, torch.tensor([fn % 6], device=dev),
                    torch.tensor([fn & 0x7FFF], device=dev),
                    _host_bytes(np.frombuffer(pl, np.uint8), dev))
                mod = send(frame, mod)
                fn += 1
                stats["frames"] = fn
                if on_frame:
                    on_frame(dict(stats))
                if pace:     # file mics don't block; emulate the mic clock
                    time.sleep(max(0.0, t0 + 0.04 * fn - time.monotonic()))
            # tail: EOT + one idle frame so receivers complete the EOT
            # (m17_tx_rx.cpp:110-115)
            tail = torch.cat(
                [tx_frames.eot_frame(1, dev), tx_frames.preamble_frame(1, dev)],
                dim=-1)
            send(tail, mod)
            if hasattr(sink, "flush"):
                sink.flush()
        finally:
            mic.close()
            self.ptt.clear()
            self.db.ptt = False
        return stats

    # ------------------------------------------------------------------
    # Full duplex: transmit AND receive at once (radio_duplex
    # radio.cpp:98-109; PTT_DP loop m17_tx_rx.cpp:121-158; MMI `td`)
    # ------------------------------------------------------------------
    def duplex_file(self, iq_in: str, iq_out: str,
                    audio_in: str | None = None,
                    payload_in: str | None = None,
                    audio_out: str | None = None,
                    payload_out: str | None = None,
                    n_frames: int = 10) -> dict:
        """File-backed duplex circuit: the TX chain streams a voice
        session to iq_out while the RX chain decodes iq_in, PTT keyed
        for the whole pass (the reference's duplex keys GPIO TX and
        runs mic+speaker concurrently).  The two directions run in
        parallel threads like the reference's txrx thread drives both
        streams of the duplex radio."""
        import threading

        self.ptt.set()
        self.db.ptt = True
        results: dict = {}

        def tx_side() -> None:
            # inline tx_file's body without its PTT handling (the
            # duplex pass owns the key)
            if payload_in:
                raw = np.fromfile(payload_in, dtype=np.uint8)
                nf = len(raw) // 16
                payloads = raw[: nf * 16].reshape(1, nf, 16)
            elif audio_in:
                mic = audiom.open_source(audio_in)
                frames = []
                while True:
                    a_pcm = mic.audio_input()
                    b_pcm = mic.audio_input()
                    if a_pcm is None or b_pcm is None:
                        break
                    a = self.codec.encode(a_pcm)
                    b = self.codec.encode(b_pcm)
                    frames.append(np.frombuffer(a + b, dtype=np.uint8))
                mic.close()
                payloads = np.stack(frames)[None] if frames else \
                    np.zeros((1, 0, 16), np.uint8)
            else:
                rng = np.random.default_rng(0)
                payloads = rng.integers(0, 256, (1, n_frames, 16),
                                        dtype=np.uint8)
            lsf = _lsf_for(self.db, self.device)
            dibits = txp.build_voice_session_dibits(
                lsf, torch.as_tensor(payloads).to(self.device))
            iq, _ = txp.dibits_to_iq(dibits)
            sink = FileSink(iq_out)
            n = sink.transmit_samples(iqp.to_complex(iq[0]) * self.db.tx_gain * 2.0)
            sink.close()
            results["tx"] = {"samples": n, "frames": int(payloads.shape[1])}

        try:
            t = threading.Thread(target=tx_side)
            t.start()
            results["rx"] = self.rx_file(
                iq_in, payload_out=payload_out, audio_out=audio_out)
            t.join()
        finally:
            self.ptt.clear()
            self.db.ptt = False
        return results

    # ------------------------------------------------------------------
    # ASTODN client: audio <-> reflector (m17_txrx_client_thread)
    # ------------------------------------------------------------------
    def client_send_voice(self, payloads: np.ndarray) -> int:
        """Send voice payload frames to the connected reflector
        (m17_send_stream_frame_to_net, m17_tx_routines.cpp:298-306)."""
        if not (self.reflector and self.reflector.active):
            return 0
        lsf = _lsf_for(self.db, self.device)[0].cpu().numpy()
        lich28 = bytes(lsf[:28])
        sid = secrets.randbits(16)
        n = 0
        for fn, pl in enumerate(payloads):
            self.reflector.send_voice(sid, lich28, fn + 1, bytes(pl))
            n += 1
        return n

    def client_poll_voice(self) -> list[VoiceFrame]:
        """Receive reflector voice for the local speaker path
        (m17_parse_m17_data ASTODN branch, m17_net.cpp:223-228)."""
        if not self.reflector:
            return []
        return [vf for vf in self.reflector.poll()
                if self.db.is_for_me(vf.dst)]

    # ------------------------------------------------------------------
    # DRTODN gateway: radio <-> reflector (m17_txrx_net_thread)
    # ------------------------------------------------------------------
    def _net_lich(self, lich28: bytes) -> bytes:
        """RF->NET readdress: the reference overwrites the forwarded
        LICH's dest callsign with '<reflector> <module>' before
        sending RF voice to the net (m17_net_new_rx_data,
        m17_net.cpp:55-62) -- reflector clients subscribe to a module
        and expect gateway streams addressed to it.  The designator
        comes from the `conn` argument; without one (direct-IP tests
        with no name) the LICH passes through unchanged."""
        name = self.db.extra.get("reflector_name")
        if not name:
            return lich28
        dest = cs.encode_callsign(f"{name} {self.db.reflector_module}")
        return bytes(np.asarray(
            bitpack.word_to_bytes(dest, 6), np.uint8)) + lich28[6:]

    def gateway_run_file(self, iq_in: str, iq_out: str) -> dict:
        """One gateway pass over file backends: decode the RF side and
        forward to the reflector; drain queued reflector frames to RF
        when the jitter buffer passes the threshold
        (m17_tx_rx.cpp:28-81)."""
        stats = {"rf_to_net": 0, "net_to_rf": 0}
        src = FileSource(iq_in)
        state = RxSessionState.init(1, self.device)
        sid = secrets.randbits(16)
        # RF -> NET (auto-armed equalizer, same decode default as every
        # other RX surface: forwarded voice must not be the confident
        # ISI misdecodes the eye detector exists to correct)
        for block in src.blocks():
            out, state = rx_block(iqp.from_complex(block[None, :], self.device), state,
                                  equalize="auto")
            sv = out.stream_gate[0].cpu().numpy()
            fns = out.stream_fn[0].cpu().numpy()
            pls = out.stream_payload[0].cpu().numpy()
            lich = state.lich_good[0].cpu().numpy()
            for i in np.nonzero(sv)[0]:
                if self.reflector and self.reflector.active:
                    self.reflector.send_voice(
                        sid, self._net_lich(bytes(lich[:28])),
                        int(fns[i]), bytes(pls[i]))
                stats["rf_to_net"] += 1
        # NET -> RF: drain the jitter queue above threshold, keyed up
        # with the LSF rebuilt from the received stream's LICH
        # (m17_tx_rx.cpp:47 -> m17_send_link_setup_frame_fm_net)
        if self.reflector:
            queued = self.reflector.poll()
            if len(queued) > GATEWAY_KEYUP_THRESHOLD or (queued and iq_out):
                frames = np.stack([np.frombuffer(vf.payload, np.uint8)
                                   for vf in queued])[None]
                lsf = _lsf_from_net(queued[0], self.device)
                self.ptt.set()           # radio_transmit -> rpi_tx
                try:
                    dibits = txp.build_voice_session_dibits(
                        lsf, torch.as_tensor(frames).to(self.device))
                    iq, _ = txp.dibits_to_iq(dibits)
                    sink = FileSink(iq_out)
                    sink.transmit_samples(
                        iqp.to_complex(iq[0])
                        * self.db.tx_gain * 2.0)   # shared TX amplitude
                    sink.close()
                finally:
                    self.ptt.clear()     # radio_receive -> rpi_rx
                stats["net_to_rf"] = len(queued)
        return stats

    def gateway_run_live(self, iq_in: str, iq_out: str,
                         chunk_blocks: int = 5,
                         keyup_threshold: int = GATEWAY_KEYUP_THRESHOLD,
                         idle_polls: int = 10,
                         idle_poll_s: float = 0.05,
                         final_drain: bool = True,
                         max_keyup_frames: int = 750) -> dict:
        """Continuous DRTODN gateway: the alternating STATE_RX/STATE_TX
        loop of m17_txrx_net_thread (m17_tx_rx.cpp:28-81), with the
        native UDP thread feeding the jitter queue MID-SESSION.

        Per iteration the RF side decodes one chunk of blocks
        (STATE_RX), forwarding routed voice to the reflector; between
        chunks the jitter queue (UdpTransport's native RX thread +
        parsed-frame deque) is drained of new arrivals, and once it
        holds more than `keyup_threshold` frames the loop keys up
        (STATE_TX): carrier + preambles + LSF rebuilt from the
        ORIGINATOR's LICH, streams the queue until empty -- new frames
        arriving DURING the drain are included, exactly like the
        reference's while-queue-not-empty TX state -- then EOT and
        back to STATE_RX where RF decoding resumes.  The RF output is
        time-multiplexed onto iq_out in transmission order.

        After the RF capture is exhausted the loop lingers
        `idle_polls` x `idle_poll_s` for late net traffic (the
        reference loop is infinite; a file-backed session needs an
        exit), then optionally drains any below-threshold remainder.

        This loop reads decoded frames per chunk.  Returns stats incl. an event log proving RX/TX interleaving.
        """
        import time

        stats = {"rf_to_net": 0, "net_to_rf": 0, "keyups": 0,
                 "events": []}
        jitter: list[VoiceFrame] = []
        sid = secrets.randbits(16)
        sink = FileSink(iq_out)

        def chunk_fn(chunk, state):
            return streaming.run_chunk(chunk, state, afc=self.db.afc,
                                       equalize="auto")

        state = streaming.StreamChunkState.init(1, self.device)

        def poll_net() -> None:
            if self.reflector:
                jitter.extend(self.reflector.poll())

        def tx_drain() -> None:
            """STATE_TX: key up, stream until the queue is empty, EOT
            (m17_tx_rx.cpp:56-72)."""
            stats["keyups"] += 1
            stats["events"].append(("tx", stats["rf_to_net"]))
            lsf = _lsf_from_net(jitter[0], self.device)
            self.ptt.set()               # radio_transmit -> rpi_tx
            try:
                drained: list[VoiceFrame] = []
                # bound one key-up (the reference's TX state runs until
                # the queue empties, m17_tx_rx.cpp:56-72, but its loop
                # is infinite by design -- here a reflector delivering
                # at least as fast as the drain would otherwise keep
                # the gateway keyed forever and starve RF-side RX)
                while jitter and len(drained) < max_keyup_frames:
                    drained.append(jitter.pop(0))
                    if not jitter:
                        poll_net()       # arrivals during the drain
                frames = np.stack([
                    np.frombuffer(vf.payload, np.uint8)
                    for vf in drained])[None]
                dibits = txp.build_voice_session_dibits(
                    lsf, torch.as_tensor(frames).to(self.device))
                iq, _ = txp.dibits_to_iq(dibits)
                sink.transmit_samples(
                    iqp.to_complex(iq[0])
                    * self.db.tx_gain * 2.0)   # shared TX amplitude
                stats["net_to_rf"] += len(drained)
            finally:
                self.ptt.clear()         # radio_receive -> rpi_rx
            stats["events"].append(("rx", stats["rf_to_net"]))

        def forward_chunk(out, rx_state) -> None:
            sv = out.stream_gate[0].cpu().numpy().reshape(-1)
            fns = out.stream_fn[0].cpu().numpy().reshape(-1)
            pls = out.stream_payload[0].cpu().numpy().reshape(-1, 16)
            lich = rx_state.lich_good[0].cpu().numpy()
            for i in np.nonzero(sv)[0]:
                if self.reflector and self.reflector.active:
                    self.reflector.send_voice(
                        sid, self._net_lich(bytes(lich[:28])),
                        int(fns[i]), bytes(pls[i]))
                stats["rf_to_net"] += 1

        # ---- the live loop ----
        stats["events"].append(("rx", 0))
        blocks_iter = streaming.wire_block_iter(iq_in, BLOCK_SAMPLES)
        pending: list[np.ndarray] = []
        for blk in blocks_iter:
            pending.append(blk[None])
            if len(pending) < chunk_blocks:
                continue
            chunk = torch.from_numpy(np.stack(pending, axis=1)).to(self.device)
            pending = []
            out, state = chunk_fn(chunk, state)
            forward_chunk(out, state.rx)
            poll_net()
            if len(jitter) > keyup_threshold:
                tx_drain()
        if pending:
            chunk = torch.from_numpy(np.stack(pending, axis=1)).to(self.device)
            out, state = chunk_fn(chunk, state)
            forward_chunk(out, state.rx)

        # RF exhausted: linger for late net traffic, then final drain
        for _ in range(idle_polls):
            poll_net()
            if len(jitter) > keyup_threshold:
                tx_drain()
            time.sleep(idle_poll_s)
        poll_net()
        if jitter and final_drain:
            tx_drain()
        sink.close()
        return stats

    # ------------------------------------------------------------------
    # ASTOAS loopback (m17_txrx_audio_loopback, m17_tx_rx.cpp:221-234)
    # ------------------------------------------------------------------
    def audio_loopback(self, pcm: np.ndarray) -> np.ndarray:
        out = []
        for i in range(len(pcm) // 160):
            frame = self.codec.encode(pcm[i * 160:(i + 1) * 160])
            out.append(self.codec.decode(frame))
        return np.concatenate(out) if out else np.zeros(0, np.int16)

    # ------------------------------------------------------------------
    def connect(self, reflector_host: str, module: str,
                port: int | None = None, bind_port: int = 0) -> None:
        """Connect to a reflector by host/IP or by DIRECTORY NAME: a
        designator found in an M17Hosts.txt directory resolves to its
        ip/port first (net_find_reflector, m17_net.cpp:314-334).  The
        directory is db.extra['hosts_file'] if set, else ./M17Hosts.txt,
        else the shipped assets/M17Hosts.txt.  An EXPLICIT `port`
        always wins; the directory's port applies only when the caller
        left it None (default 17000, m17_net.cpp:10)."""
        import pathlib

        from ..io import hosts as hostsm

        # the designator names the gateway's net-side LICH dest
        # ('<reflector> <module>', m17_net.cpp:55-62 via _net_lich);
        # keep it before directory resolution replaces it with an IP.
        # Direct host:port connections (no directory hit) only count
        # if the argument looks like a designator, not an address.
        self.db.extra.pop("reflector_name", None)
        candidates = [
            self.db.extra.get("hosts_file"),
            "M17Hosts.txt",
            pathlib.Path(__file__).resolve().parents[2]
            / "assets" / "M17Hosts.txt",
        ]
        for path in candidates:
            if path and pathlib.Path(path).exists():
                hit = hostsm.find_reflector(reflector_host, path)
                if hit:
                    self.db.extra["reflector_name"] = \
                        reflector_host.upper()
                    reflector_host = hit[0]
                    if port is None:
                        port = hit[1]
                    # breadcrumb: a stray ./M17Hosts.txt overriding the
                    # shipped directory is otherwise invisible
                    self.db.extra["hosts_file_used"] = str(path)
                    break
        # `port is None` (not falsy): an explicit port=0 means "let the
        # OS pick" for test reflectors bound to ephemeral ports
        self.reflector = ReflectorClient(
            reflector_host, 17000 if port is None else port)
        self.reflector.connect(self.db.tx_src_call, module, bind_port=bind_port)
        self.db.connected_reflector = reflector_host
        self.db.reflector_module = module

    def disconnect(self) -> None:
        if self.reflector:
            self.reflector.disconnect()
            self.reflector.close()
            self.reflector = None
        self.db.connected_reflector = ""
