"""M17 TYPE field pack/unpack (a copy of ``m17_sdr_tpu.spec.typefield``)."""

from __future__ import annotations

from dataclasses import dataclass

# data type indicator values
CCT_PACKET = 0
CCT_STREAM = 1
DATA_RESERVED = 0
DATA_DATA = 1
DATA_VOICE = 2
DATA_VOICE_DATA = 3
ENC_NONE = 0
ENC_AES = 1
ENC_SCRAMBLE = 2
ENC_OTHER = 3


@dataclass(frozen=True)
class M17Type:
    """TYPE field: packet/stream, data type, encryption type/subtype,
    channel access number, reserved bits."""

    packet_stream: int = CCT_STREAM
    data_type: int = DATA_VOICE
    enc_type: int = ENC_NONE
    enc_subtype: int = 0
    can: int = 0
    reserved: int = 0

    def pack(self) -> int:
        """-> 16-bit word."""
        word = self.reserved & 0x1F
        word = (word << 4) | (self.can & 0xF)
        word = (word << 2) | (self.enc_subtype & 0x3)
        word = (word << 2) | (self.enc_type & 0x3)
        word = (word << 2) | (self.data_type & 0x3)
        word = (word << 1) | (self.packet_stream & 0x1)
        return word

    @staticmethod
    def unpack(word: int) -> "M17Type":
        """16-bit word -> fields."""
        return M17Type(
            packet_stream=word & 0x1,
            data_type=(word >> 1) & 0x3,
            enc_type=(word >> 3) & 0x3,
            enc_subtype=(word >> 5) & 0x3,
            can=(word >> 7) & 0xF,
            reserved=(word >> 11) & 0x1F,
        )


VOICE_STREAM_TYPE = M17Type()
