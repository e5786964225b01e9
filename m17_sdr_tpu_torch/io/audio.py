"""Audio I/O: the reference's PulseAudio contract over files and memory.

Reference: audio_io.cpp -- 8 kHz mono S16LE (lines 11-20), blocking
read/write/flush of 160-sample (20 ms) blocks (lines 44-65).  Two codec
frames (320 samples) feed one 40 ms M17 stream frame
(m17_tx_rx.cpp:104-108).

There is no sound server on a compute host, so the *devices* here
are WAV files, raw PCM files, and a thread-safe in-memory loopback --
but the interface contract (sample format, block size, blocking
semantics) is the reference's, so the session layer is agnostic to
what actually sits behind `audio_input`/`audio_output`.

The port's own copy of ``m17_sdr_tpu.io.audio``: the port imports nothing of the
JAX package, so it keeps copies of the modules it needs from it.
"""

from __future__ import annotations

import pathlib
import queue
import threading
import wave

import numpy as np

AUDIO_RATE = 8_000          # audio_io.cpp:16
AUDIO_BLOCK = 160           # samples per 20 ms block (m17defines.h AUDIO_N)
_DT = np.dtype("<i2")       # S16LE (audio_io.cpp:15)


class WavSource:
    """audio_input() over a WAV file (8 kHz mono S16LE enforced)."""

    def __init__(self, path: str | pathlib.Path):
        self._w = wave.open(str(path), "rb")
        if self._w.getnchannels() != 1 or self._w.getsampwidth() != 2:
            raise ValueError("need mono 16-bit WAV")
        if self._w.getframerate() != AUDIO_RATE:
            raise ValueError(f"need {AUDIO_RATE} Hz WAV, "
                             f"got {self._w.getframerate()}")

    def audio_input(self, n: int = AUDIO_BLOCK) -> np.ndarray | None:
        """Blocking read of one block; None at end of stream
        (audio_io.cpp:44-50 blocks on pa_simple_read)."""
        raw = self._w.readframes(n)
        if len(raw) < n * 2:
            return None
        return np.frombuffer(raw, dtype=_DT)

    def close(self) -> None:
        self._w.close()


class WavSink:
    """audio_output() into a WAV file."""

    def __init__(self, path: str | pathlib.Path):
        self._w = wave.open(str(path), "wb")
        self._w.setnchannels(1)
        self._w.setsampwidth(2)
        self._w.setframerate(AUDIO_RATE)

    def audio_output(self, pcm: np.ndarray) -> None:
        self._w.writeframes(np.asarray(pcm, dtype=_DT).tobytes())

    def audio_flush(self) -> None:   # audio_io.cpp:60-65
        pass

    def close(self) -> None:
        self._w.close()


class RawSource:
    """audio_input() over a headerless S16LE PCM file."""

    def __init__(self, path: str | pathlib.Path):
        self._pcm = np.fromfile(path, dtype=_DT)
        self._pos = 0

    def audio_input(self, n: int = AUDIO_BLOCK) -> np.ndarray | None:
        if self._pos + n > len(self._pcm):
            return None
        out = self._pcm[self._pos:self._pos + n]
        self._pos += n
        return out

    def close(self) -> None:
        pass


class RawSink:
    def __init__(self, path: str | pathlib.Path):
        self._f = open(path, "wb")

    def audio_output(self, pcm: np.ndarray) -> None:
        self._f.write(np.asarray(pcm, dtype=_DT).tobytes())

    def audio_flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class LoopbackAudio:
    """Thread-safe mic->speaker queue with the blocking semantics of the
    PulseAudio simple API -- the test/loopback stand-in for a sound
    card (cf. the ASTOAS circuit, m17_tx_rx.cpp:221-234)."""

    def __init__(self, max_blocks: int = 256):
        self._q: queue.Queue[np.ndarray] = queue.Queue(maxsize=max_blocks)
        # sub-block writes accumulate here until a full block exists --
        # a partial must neither be dropped nor read back as a short
        # block (PulseAudio gives fixed-size reads regardless of the
        # writer's chunking)
        self._residue = np.zeros(0, _DT)
        self._rlock = threading.Lock()

    def audio_output(self, pcm: np.ndarray) -> None:
        # the lock covers the puts too, so that two writers' blocks never
        # interleave (a put blocks only while the queue is full)
        with self._rlock:
            pcm = np.concatenate(
                [self._residue, np.asarray(pcm, dtype=_DT)])
            nblk = len(pcm) // AUDIO_BLOCK
            self._residue = pcm[nblk * AUDIO_BLOCK:]
            for i in range(nblk):
                self._q.put(pcm[i * AUDIO_BLOCK:(i + 1) * AUDIO_BLOCK])

    def audio_input(self, n: int = AUDIO_BLOCK,
                    timeout: float | None = 1.0) -> np.ndarray | None:
        assert n == AUDIO_BLOCK
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def audio_flush(self) -> None:
        while not self._q.empty():
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def close(self) -> None:
        self.audio_flush()


class DeviceSink:
    """Live audio playback through a system player process.

    The reference plays decoded voice on a real device via the
    PulseAudio simple API in blocking 20 ms writes (audio_io.cpp:11-20,
    44-65).  There is no libpulse in this environment, so the device
    path shells out to the first available raw-PCM player -- `paplay`
    (PulseAudio) or `aplay` (ALSA) -- and streams S16LE 8 kHz mono
    into its stdin; the pipe's backpressure provides the reference's
    blocking-write pacing.  M17_AUDIO_PLAYER overrides the player
    command (shell-split), which is also how tests exercise this path
    headless (a `cat > file` player).
    """

    PLAYERS = (
        ["paplay", "--raw", f"--rate={AUDIO_RATE}", "--channels=1",
         "--format=s16le"],
        ["aplay", "-q", "-r", str(AUDIO_RATE), "-c", "1", "-f",
         "S16_LE", "-t", "raw"],
    )

    def __init__(self, player: list[str] | None = None):
        import os
        import shlex
        import shutil
        import subprocess

        if player is None:
            env = os.environ.get("M17_AUDIO_PLAYER")
            if env:
                player = shlex.split(env)
            else:
                player = next(
                    (p for p in self.PLAYERS if shutil.which(p[0])), None)
                if player is None:
                    raise RuntimeError(
                        "no audio player found (need paplay or aplay; "
                        "or set M17_AUDIO_PLAYER)")
        self._cmd = player
        self.broken = False     # the player's pipe broke; audio is lost from then on
        self._proc = subprocess.Popen(
            player, stdin=subprocess.PIPE,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    def _pipe_broke(self) -> None:
        # a dead player (daemon restart, user kill) degrades audio; it
        # must not unwind the live RX session that is feeding it, but
        # the user is told once
        if not self.broken:
            self.broken = True
            import sys

            print(f"warning: audio player {self._cmd[0]!r} exited "
                  f"(code {self._proc.poll()}); decoded audio is no longer played",
                  file=sys.stderr, flush=True)

    def audio_output(self, pcm: np.ndarray) -> None:
        try:
            self._proc.stdin.write(np.asarray(pcm, dtype=_DT).tobytes())
        except (BrokenPipeError, ValueError):   # ValueError: closed pipe
            self._pipe_broke()

    def audio_flush(self) -> None:   # audio_io.cpp:60-65
        try:
            self._proc.stdin.flush()
        except (BrokenPipeError, ValueError):
            self._pipe_broke()

    def close(self) -> None:
        try:
            self._proc.stdin.close()
        except BrokenPipeError:
            pass
        self._proc.wait(timeout=5.0)


class DeviceSource:
    """Live microphone capture through a system recorder process.

    The reference's TX loop blocks on real mic audio via the PulseAudio
    simple API in 20 ms reads (audio_io.cpp:44-52, wired into the TX
    session at m17_tx_rx.cpp:104-108).  There is no libpulse in this
    environment, so the device path shells out to the first available
    raw-PCM recorder -- `parec` (PulseAudio) or `arecord` (ALSA) --
    and reads S16LE 8 kHz mono from its stdout; the blocking pipe read
    provides the reference's pa_simple_read pacing (the mic clock
    paces the TX loop).  M17_AUDIO_RECORDER overrides the recorder
    command (shell-split), which is also how tests exercise this path
    headless (e.g. a `cat file` or ffmpeg-tone recorder).
    """

    RECORDERS = (
        ["parec", "--raw", f"--rate={AUDIO_RATE}", "--channels=1",
         "--format=s16le"],
        ["arecord", "-q", "-r", str(AUDIO_RATE), "-c", "1", "-f",
         "S16_LE", "-t", "raw"],
    )

    def __init__(self, recorder: list[str] | None = None):
        import os
        import shlex
        import shutil
        import subprocess

        if recorder is None:
            env = os.environ.get("M17_AUDIO_RECORDER")
            if env:
                recorder = shlex.split(env)
            else:
                recorder = next(
                    (r for r in self.RECORDERS if shutil.which(r[0])), None)
                if recorder is None:
                    raise RuntimeError(
                        "no audio recorder found (need parec or arecord; "
                        "or set M17_AUDIO_RECORDER)")
        self._proc = subprocess.Popen(
            recorder, stdout=subprocess.PIPE,
            stdin=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    def audio_input(self, n: int = AUDIO_BLOCK) -> np.ndarray | None:
        """Blocking read of one block; None when the recorder ends
        (a real mic never does -- pa_simple_read blocks forever)."""
        want = n * 2
        raw = b""
        while len(raw) < want:
            chunk = self._proc.stdout.read(want - len(raw))
            if not chunk:
                return None
            raw += chunk
        return np.frombuffer(raw, dtype=_DT)

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.terminate()
        try:
            self._proc.wait(timeout=5.0)
        except Exception:
            self._proc.kill()
            self._proc.wait(timeout=5.0)


def open_source(path: str | pathlib.Path):
    """Pick a mic device: "device"/"pulse"/"alsa"/"default" captures
    live through DeviceSource; otherwise by file extension
    (.wav or raw PCM)."""
    if str(path) in ("device", "pulse", "alsa", "default"):
        return DeviceSource()
    return WavSource(path) if str(path).endswith(".wav") else RawSource(path)


def open_sink(path: str | pathlib.Path):
    """Pick a speaker device: "device"/"pulse"/"alsa" plays live
    through DeviceSink; otherwise by file extension (.wav or raw)."""
    if str(path) in ("device", "pulse", "alsa", "default"):
        return DeviceSink()
    return WavSink(path) if str(path).endswith(".wav") else RawSink(path)


def read_pcm(path: str | pathlib.Path) -> np.ndarray:
    """Whole-file read through the device layer (wav or raw)."""
    src = open_source(path)
    blocks = []
    while (blk := src.audio_input()) is not None:
        blocks.append(blk)
    src.close()
    return np.concatenate(blocks) if blocks else np.zeros(0, dtype=_DT)


def write_pcm(path: str | pathlib.Path, pcm: np.ndarray) -> None:
    sink = open_sink(path)
    sink.audio_output(pcm)
    sink.close()
