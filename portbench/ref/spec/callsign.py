"""M17 base-40 callsign codec (host side).

A copy of ``m17_sdr_tpu.spec.callsign``: callsigns of up to 9
characters from [A-Z 0-9 - / . space], little-endian base 40 in a
48-bit word; 0xFFFFFFFFFFFF is BROADCAST.
"""

from __future__ import annotations

_CHARSET = {**{chr(ord("A") + i): i + 1 for i in range(26)},
            **{chr(ord("0") + i): i + 27 for i in range(10)},
            "-": 37, "/": 38, ".": 39, " ": 0}


def encode_callsign(call: str) -> int:
    """Callsign string -> 48-bit address word.

    The call is right-padded with spaces to 9 characters and digested
    from the last character down; unknown characters map to 0 (space).
    """
    call = call.upper().ljust(9)[:9]
    word = 0
    for ch in reversed(call):
        word = word * 40 + _CHARSET.get(ch, 0)
    return word
