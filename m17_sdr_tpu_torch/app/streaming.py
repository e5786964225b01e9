"""Streaming receiver: int16 wire blocks in, decoded results out once.

Port of ``m17_sdr_tpu.app.streaming``.  Three rules shape it:

1. samples cross to the device in chunks of ``chunk_blocks`` 40 ms
   blocks, not block by block;
2. the modem state (``RxSessionState`` and the Pluto-rate FIR tail)
   stays on the device between chunks;
3. decoded outputs stay on the device and cross to the host once, in
   ``finish()``.

On CUDA each chunk is staged by an uploader thread in pinned host memory
and copied with ``non_blocking=True`` on a dedicated stream; the compute
stream waits on the copy's event, so the upload of chunk N+1 overlaps
the compute of chunk N and chunks are computed in order.  Host-side
sample transport runs through the native ``SampleRing`` between a
producer thread draining the source and the consumer loop that batches
chunks.

CUDA tensors take the kernels (the receiver scan and the Viterbi
decoder) at every batch size, CPU tensors their plain versions;
``use_kernel=False`` is the plain path on any device.
"""

from __future__ import annotations

import concurrent.futures
import threading
from typing import Iterator, NamedTuple

import numpy as np
import torch

from ..dsp import resample
from ..dsp.discriminator import scale_int16
from ..pipeline.rx import RxBlockOutput, RxSessionState, rx_stream
from ..spec.constants import BLOCK_SAMPLES

DEFAULT_CHUNK_BLOCKS = 25            # 1 s of signal per chunk
RING_BYTES = 256 << 20               # host ring budget: covers I/O jitter


class StreamChunkState(NamedTuple):
    """Everything carried on the device between chunks."""

    rx: RxSessionState
    dec_tail: torch.Tensor           # [B, 2, 30] Pluto-rate FIR history

    @staticmethod
    def init(batch: int, device) -> "StreamChunkState":
        return StreamChunkState(rx=RxSessionState.init(batch, device),
                                dec_tail=resample.decimate_init(batch, device))


def rate_factor(rate: int) -> int:
    """The decimation factor of a supported IQ rate (48 k or 384 k)."""
    factor = rate // 48_000
    if rate != factor * 48_000 or factor not in (1, 8):
        raise ValueError(f"unsupported input rate {rate}")
    return factor


def run_chunk(wire: torch.Tensor, state: StreamChunkState, afc: bool = False,
              factor: int = 1, equalize=False, use_kernel: bool | None = None):
    """One chunk: wire int16 [B, NBLK, T_in, 2] -> (RxBlockOutput stacked
    on axis 1, new StreamChunkState), on the wire's device."""
    b, nblk, t_in, _ = wire.shape
    iq = scale_int16(wire)                          # [B, NBLK, 2, T_in]
    dec_tail = state.dec_tail
    if factor > 1:
        flat = iq.movedim(1, 2).reshape(b, 2, nblk * t_in)
        flat, dec_tail = resample.fir_decimate(flat, resample.pluto_dec_taps(),
                                               dec_tail, factor=factor)
        iq = flat.reshape(b, 2, nblk, t_in // factor).movedim(2, 1)
    out, rx = rx_stream(iq, state.rx, afc_enabled=afc, equalize=equalize,
                        use_kernel=use_kernel)
    return out, StreamChunkState(rx=rx, dec_tail=dec_tail)


def to_host(tree):
    """A NamedTuple tree of tensors -> the same tree of numpy arrays."""
    return type(tree)(*(to_host(x) if isinstance(x, tuple) else x.cpu().numpy()
                        for x in tree))


class StreamingRx:
    """Streaming receiver: feed int16 IQ blocks, collect results once.

    Usage:
        srx = StreamingRx(input_rate=..., afc=..., device=...)
        srx.run(source)           # or: feed_block(...) repeatedly
        outs, state, nblk = srx.finish()
    """

    def __init__(self, batch: int = 1, input_rate: int = 48_000,
                 afc: bool = False, equalize=False,
                 chunk_blocks: int = DEFAULT_CHUNK_BLOCKS, device="cuda",
                 use_kernel: bool | None = None):
        self.factor = rate_factor(input_rate)
        self.batch = batch
        self.afc = afc
        self.equalize = equalize
        self.chunk_blocks = chunk_blocks
        self.use_kernel = use_kernel
        self.device = torch.device(device)
        self.block_in = BLOCK_SAMPLES * self.factor  # input samples/block
        self._state = StreamChunkState.init(batch, self.device)
        self._pending: list[np.ndarray] = []         # [B, T_in, 2] int16
        self._outs: list[RxBlockOutput] = []         # device outputs
        self._real_blocks: list[int] = []            # per chunk
        self._staged: list[tuple] = []               # (upload future, nblk)
        self._finished = False
        self._uploader = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="m17-upload")
        self._upload_stream = (torch.cuda.Stream(self.device)
                               if self.device.type == "cuda" else None)

    # ------------------------------------------------------------------
    def feed_block(self, wire_block: np.ndarray) -> None:
        """One [B, T_in, 2] (or [T_in, 2] for batch 1) int16 IQ block."""
        if self._finished:
            raise RuntimeError(
                "StreamingRx.finish() was already called; the engine is "
                "single-use -- create a new StreamingRx for another session")
        if wire_block.ndim == 2:
            wire_block = wire_block[None]
        if wire_block.shape != (self.batch, self.block_in, 2):
            raise ValueError(f"wire block {wire_block.shape} is not "
                             f"{(self.batch, self.block_in, 2)}")
        self._pending.append(wire_block)
        if len(self._pending) == self.chunk_blocks:
            pend, self._pending = self._pending, []
            self._dispatch(pend)

    def _upload(self, blocks: list[np.ndarray]):
        """(device wire [B, NBLK, T_in, 2] int16, copy event or None)."""
        if self._upload_stream is None:
            return torch.from_numpy(np.stack(blocks, axis=1)).to(self.device), None
        host = torch.empty((self.batch, len(blocks), self.block_in, 2),
                           dtype=torch.int16, pin_memory=True)
        np.stack(blocks, axis=1, out=host.numpy())
        with torch.cuda.stream(self._upload_stream):
            wire = host.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return wire, done

    def _dispatch(self, blocks: list[np.ndarray]) -> None:
        """Stage this chunk's upload; compute the oldest staged chunk once
        one chunk is staged ahead (order is kept: compute always takes
        the oldest)."""
        self._staged.append((self._uploader.submit(self._upload, blocks), len(blocks)))
        while len(self._staged) > 1:
            self._compute_one()

    def _compute_one(self) -> None:
        fut, n = self._staged.pop(0)
        wire, done = fut.result()
        if done is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(done)
            wire.record_stream(compute)     # allocated on the upload stream
        out, self._state = run_chunk(wire, self._state, afc=self.afc, factor=self.factor,
                                     equalize=self.equalize, use_kernel=self.use_kernel)
        self._outs.append(out)
        self._real_blocks.append(n)

    def flush_pending(self) -> None:
        """Dispatch buffered blocks exactly (no zero padding: pad blocks
        would change the carried state), as power-of-two sub-chunks, and
        compute everything staged."""
        pend, self._pending = self._pending, []
        while pend:
            n = 1 << (len(pend).bit_length() - 1)    # largest 2^k <= len
            self._dispatch(pend[:n])
            pend = pend[n:]
        while self._staged:
            self._compute_one()

    # ------------------------------------------------------------------
    def checkpoint(self, path: str) -> None:
        """Persist the modem carry (RxSessionState + FIR tail) so that a
        later StreamingRx resumes bit-identically."""
        from . import checkpoint as ckpt

        self.flush_pending()
        ckpt.save_state(path, self._state)

    def resume(self, path: str) -> None:
        """Restore carry state saved by checkpoint() (by either package)."""
        from . import checkpoint as ckpt

        if self._outs or self._pending or self._staged:
            raise RuntimeError("resume() must precede any processing")
        self._state, _ = ckpt.load_state(path, self._state)

    # ------------------------------------------------------------------
    def run(self, raw_blocks: Iterator[np.ndarray], use_ring: bool = True) -> None:
        """Drain a block iterator through the native SampleRing.

        A producer thread pushes raw int16 wire blocks into the ring; this
        (consumer) thread pops, batches and dispatches chunks, so I/O
        overlaps the device's work.  Each block is copied once into the
        ring and once out of it, in C, straight between numpy buffers.
        """
        if not use_ring:
            for blk in raw_blocks:
                self.feed_block(blk)
            return

        from ..runtime import SampleRing

        block_bytes = self.batch * self.block_in * 2 * 2
        # the depth targets a byte budget, not a block count (a 64-deep
        # ring of 384 kHz blocks at a large batch would be GBs), rounded
        # down to the power of two the ring's capacity must be
        depth = max(4, min(64, RING_BYTES // max(block_bytes, 1)))
        depth = 1 << (depth.bit_length() - 1)
        ring = SampleRing(block_bytes, capacity_pow2=depth)
        done = threading.Event()
        producer_error: list[BaseException] = []

        def producer() -> None:
            try:
                for blk in raw_blocks:
                    data = np.ascontiguousarray(blk, dtype="<i2")
                    while not ring.push(data):      # backpressure
                        if done.is_set():
                            return
                        threading.Event().wait(0.001)
            except BaseException as e:   # surfaced to run()'s caller: a
                producer_error.append(e)  # truncated capture must not
            finally:                      # decode as a successful run
                done.set()

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        shape = (self.batch, self.block_in, 2)
        try:
            blk = np.empty(shape, dtype="<i2")
            while True:
                got = ring.pop_into(blk)
                if not got and done.is_set():
                    got = ring.pop_into(blk)     # drain race: check once more
                    if not got:
                        break
                if not got:
                    threading.Event().wait(0.001)
                    continue
                self.feed_block(blk)
                blk = np.empty(shape, dtype="<i2")   # feed_block keeps blk
        finally:
            done.set()
            t.join(timeout=5.0)
            # ring_destroy frees the block array; a producer still blocked
            # inside raw_blocks (a stalled source) would then push into
            # freed memory.  Leak the ring instead: the daemon thread dies
            # with the process either way.
            if not t.is_alive():
                ring.close()
        if producer_error:
            raise RuntimeError(
                "sample producer failed mid-stream; the capture is "
                "truncated") from producer_error[0]

    # ------------------------------------------------------------------
    def finish(self):
        """Flush pending blocks and bring the results to the host, the
        session's one device-to-host read.  Returns (RxBlockOutput of
        numpy arrays over all blocks on axis 1, RxSessionState of numpy
        arrays, n_blocks).  Terminal: the uploader thread is shut down."""
        self.flush_pending()
        self._finished = True
        self._uploader.shutdown(wait=False)
        n_blocks = sum(self._real_blocks)
        if not self._outs:
            return None, to_host(self._state.rx), 0
        out = RxBlockOutput(*(torch.cat(xs, dim=1) if xs[0].dim() >= 2 else xs[-1]
                              for xs in zip(*self._outs)))
        return to_host(out), to_host(self._state.rx), n_blocks


def wire_block_iter(path: str, block_in: int) -> Iterator[np.ndarray]:
    """Raw int16 IQ wire blocks [T_in, 2] from a capture file."""
    data = np.fromfile(path, dtype="<i2")
    n = (len(data) // (block_in * 2)) * block_in * 2
    for pos in range(0, n, block_in * 2):
        yield data[pos: pos + block_in * 2].reshape(block_in, 2)


def batch_wire_block_iter(paths: list[str], block_in: int) -> Iterator[np.ndarray]:
    """[B, T_in, 2] int16 wire blocks from B parallel capture files.

    Channels shorter than the longest capture are zero-padded (idle
    carrier), and the partial tail block of the longest capture is
    dropped, as in the single-file iterator.
    """
    datas = [np.fromfile(p, dtype="<i2") for p in paths]
    per_blk = block_in * 2
    nblk = max(len(d) for d in datas) // per_blk
    for pos in range(0, nblk * per_blk, per_blk):
        blk = np.zeros((len(datas), block_in, 2), np.int16)
        for i, d in enumerate(datas):
            seg = d[pos: pos + per_blk]
            blk[i, : len(seg) // 2] = seg[: (len(seg) // 2) * 2].reshape(-1, 2)
        yield blk
