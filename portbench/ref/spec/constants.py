"""M17 protocol constants.

Same names and values as ``m17_sdr_tpu.spec.constants``; the sync
patterns are derived here from the sync words in the same way.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 48_000          # baseband complex sample rate, Hz
SYMBOL_RATE = 4_800           # 4FSK baud
SAMPLES_PER_SYMBOL = SAMPLE_RATE // SYMBOL_RATE   # 10
BLOCK_SAMPLES = 1_920         # one 40 ms processing block at 48 kHz
FRAME_SYMBOLS = 192           # 8 sync symbols + 184 payload symbols
PAYLOAD_SOFT_BITS = 368
SYNC_SYMBOLS = 8

RX_DECIMATION = 5             # 48 kHz discriminator output -> 2 samples/symbol

# frame types, in the order of the sync-correlation rows (row 0: preamble)
FT_LINK = 1
FT_STREAM = 2
FT_PACKET = 3
FT_BERT = 4
FT_EOT = 5

SYNC_WORD_LINK = 0x55F7
SYNC_WORD_STREAM = 0xFF5D
SYNC_WORD_PACKET = 0x75FF
SYNC_WORD_BERT = 0xDF55

# dibit b1b0 -> symbol: 00 -> +1, 01 -> +3, 10 -> -1, 11 -> -3
DIBIT_TO_SYMBOL = np.array([1.0, 3.0, -1.0, -3.0], dtype=np.float32)

# phase step per 48 kHz sample of each dibit: +-800 and +-2400 Hz deviation
DIBIT_TO_PHASE_INC = np.array(
    [np.pi / 30.0, np.pi / 10.0, -np.pi / 30.0, -np.pi / 10.0],
    dtype=np.float32,
)


def _sync_word_to_symbols(word: int) -> np.ndarray:
    """16-bit sync word -> 8 symbol signs (the framer correlates signs)."""
    dibits = [(word >> (14 - 2 * i)) & 0x3 for i in range(8)]
    return np.sign(DIBIT_TO_SYMBOL[dibits]).astype(np.float32)


SYNC_PATTERNS = np.stack(
    [
        np.array([1, -1, 1, -1, 1, -1, 1, -1], dtype=np.float32),  # preamble
        _sync_word_to_symbols(SYNC_WORD_LINK),
        _sync_word_to_symbols(SYNC_WORD_STREAM),
        _sync_word_to_symbols(SYNC_WORD_PACKET),
        _sync_word_to_symbols(SYNC_WORD_BERT),
        np.array([1, 1, 1, 1, 1, 1, -1, 1], dtype=np.float32),     # EOT
    ]
)

# preamble: alternating +3 -3; EOT: 24 repeats of {+3 x6, -3, +3}
PREAMBLE_DIBITS = np.tile(np.array([1, 3], dtype=np.uint8), FRAME_SYMBOLS // 2)
EOT_DIBITS = np.tile(np.array([1, 1, 1, 1, 1, 1, 3, 1], dtype=np.uint8),
                     FRAME_SYMBOLS // 8)

# framer thresholds
MAX_FRAME_ERRORS = 5
UNLOCKED_MAX_VOTES = 0
LOCKED_MAX_VOTES = 1
UNLOCKED_MAX_VARIANCE = 0.3
LOCKED_MAX_VARIANCE = 0.5

# timing loop
TIMING_THRESH_UNLOCKED = 10
TIMING_THRESH_LOCKED = 80
TIMING_NUM_PHASES = 40
TIMING_FILTER_TAPS = 31
TIMING_INIT_PHASE = 10

# TX pulse shaping
TX_FILTER_TAPS = 31
RRC_ROLLOFF = 0.5

# soft-bit demap: |soft symbol| - 2/3 decides the LSB
DEMAP_LSB_OFFSET = 0.6666

# LSF / LICH layout
LSF_BYTES = 30                # 6 dst + 6 src + 2 type + 14 meta + 2 crc
LICH_CHUNK_BYTES = 5
LICH_CHUNKS = 6               # stream frames' 5-byte chunks per LSF
STREAM_PAYLOAD_BYTES = 16     # 2 codec2 frames
PACKET_CHUNK_BYTES = 25
BERT_BITS = 197               # PRBS9 bits per BERT frame -> 402 -> P2 -> 368

BROADCAST_ADDRESS = 0xFFFF_FFFF_FFFF

# network / reflector protocol
NET_FRAME_BYTES = 54          # "M17 " voice datagram size
NET_UDP_PORT = 17_000
