"""GPS: NMEA parsing + the M17 meta-field position codec.

Reference: gps.cpp -- a serial-reader thread parsing NMEA sentences
($GPGLL for lat/lon/time/fix-valid, $GPGGA for satellite count and
altitude-with-feet-conversion; gps.cpp:161-240) guarded by the XOR
checksum (nmea_chksum, gps.cpp:91-104), plus a binary position codec
for the 14-byte LSF META field (gps_decode/gps_encode, gps.cpp:8-52).

The reference opens the GPS at startup but never wires the fix into a
transmitted META field (SURVEY.md row 26 marks the path dormant).  Here
the codec is complete and the session layer can embed a live or file
-sourced fix into the LSF META of a transmission.

Note: the reference's gps_encode has two bugs -- it stores the latitude
fraction into the longitude-degrees slot (gps.cpp:42 reuses stale `n`)
and drops the packed course/speed/object word entirely (gps.cpp:48-51
shifts `w` but never writes it).  This implementation encodes the
layout its *decoder* (gps.cpp:8-27) defines, so encode->decode round
-trips; parity with the reference is judged against gps_decode.

The port's own copy of ``m17_sdr_tpu.io.gps``: the port imports nothing of the
JAX package, so it keeps copies of the modules it needs from it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

META_GPS_BYTES = 15


@dataclass
class GpsFix:
    """The reference's GpsMsg (m17defines.h) -- one position fix."""

    lat: float = 0.0       # degrees, +N
    lon: float = 0.0       # degrees, +E
    alt: int = 0           # feet (GPGGA meters are converted, gps.cpp:175-178)
    course: int = 0        # 10 bits
    speed: int = 0         # 10 bits
    object_id: int = 0     # 20 bits
    hour: int = 0
    minute: int = 0
    second: int = 0
    nsats: int = 0
    valid: bool = False


def nmea_checksum_ok(sentence: str) -> bool:
    """XOR of chars between '$' and '*' equals the hex suffix
    (nmea_chksum, gps.cpp:91-104)."""
    sentence = sentence.strip()
    if not sentence.startswith("$") or "*" not in sentence:
        return False
    body, _, tail = sentence[1:].partition("*")
    try:
        want = int(tail[:2], 16)
    except ValueError:
        return False
    c = 0
    for ch in body:
        c ^= ord(ch)
    return c == want


def _nmea_latlon(value: str, hemi: str, int_digits: int) -> float:
    """ddmm.mmmm -> signed degrees (gps.cpp:215-231)."""
    deg = int(value[:int_digits])
    minutes = float(value[int_digits:])
    out = deg + minutes / 60.0
    if hemi in ("S", "W"):
        out = -out
    return out


def parse_nmea(sentence: str, fix: GpsFix) -> bool:
    """Update `fix` in place from one NMEA sentence.  Returns True if
    the sentence was understood (GPGLL or GPGGA; gps.cpp:120-240 parses
    these two and ignores RMC/VTG/GSA/GSV)."""
    if not nmea_checksum_ok(sentence):
        return False
    parts = sentence.strip().split("*")[0].split(",")
    tag = parts[0]
    try:
        if tag.endswith("GLL"):
            # $GPGLL,lat,N,lon,W,hhmmss.ss,A,...  (gps.cpp:213-239)
            fix.lat = _nmea_latlon(parts[1], parts[2], 2)
            fix.lon = _nmea_latlon(parts[3], parts[4], 3)
            fix.hour = int(parts[5][0:2])
            fix.minute = int(parts[5][2:4])
            fix.second = int(parts[5][4:6])
            fix.valid = parts[6].startswith("A")
            return True
        if tag.endswith("GGA"):
            # $GPGGA,...,nsats,hdop,alt,M,...  (gps.cpp:161-183)
            fix.nsats = int(parts[7])
            alt = float(parts[9])
            if parts[10].startswith("M"):
                alt *= 3.28084          # meters -> feet, gps.cpp:177
            fix.alt = int(alt)
            return True
    except (ValueError, IndexError):
        return False
    return False


def encode_gps_meta(fix: GpsFix) -> np.ndarray:
    """Fix -> 15-byte META position blob, the layout gps_decode
    (gps.cpp:8-27) reads:

      [0]     latitude integer degrees (int8)
      [1:3]   latitude fraction * 65536 (u16 BE)
      [3:5]   longitude integer degrees (i16 BE)
      [5:7]   longitude fraction * 65536 (u16 BE)
      [7:9]   altitude + 1500 feet (u16 BE)
      [9:15]  course(10) | speed(10) | object(20) packed into 48 bits

    Layout limitation (inherited from the wire format): the sign lives
    in the integer-degrees field, so coordinates in (-1, 0) degrees
    decode with the wrong sign -- the reference's own decode has the
    same degenerate zone.
    """
    b = np.zeros(META_GPS_BYTES, np.uint8)
    lat_i = int(fix.lat)                       # C truncation (modf keeps sign)
    lat_f = int(round(abs(fix.lat - lat_i) * 65536)) & 0xFFFF
    lon_i = int(fix.lon)
    lon_f = int(round(abs(fix.lon - lon_i) * 65536)) & 0xFFFF
    b[0] = np.uint8(lat_i & 0xFF)
    b[1:3] = [(lat_f >> 8) & 0xFF, lat_f & 0xFF]
    b[3:5] = [(lon_i >> 8) & 0xFF, lon_i & 0xFF]
    b[5:7] = [(lon_f >> 8) & 0xFF, lon_f & 0xFF]
    alt = (fix.alt + 1500) & 0xFFFF
    b[7:9] = [(alt >> 8) & 0xFF, alt & 0xFF]
    w = ((fix.course & 0x3FF) << 38) | ((fix.speed & 0x3FF) << 28) \
        | (fix.object_id & 0xFFFFF)
    for i in range(6):
        b[9 + i] = (w >> (8 * (5 - i))) & 0xFF
    return b


def decode_gps_meta(b: np.ndarray) -> GpsFix:
    """15-byte META blob -> fix (gps_decode, gps.cpp:8-27)."""
    b = np.asarray(b, np.uint8)
    fix = GpsFix()
    lat_i = int(np.int8(b[0]))
    lat_f = (int(b[1]) << 8 | int(b[2])) / 65536.0
    fix.lat = lat_i + (-lat_f if lat_i < 0 else lat_f)
    lon_i = int(b[3]) << 8 | int(b[4])
    if lon_i >= 0x8000:
        lon_i -= 0x10000
    lon_f = (int(b[5]) << 8 | int(b[6])) / 65536.0
    fix.lon = lon_i + (-lon_f if lon_i < 0 else lon_f)
    fix.alt = (int(b[7]) << 8 | int(b[8])) - 1500
    w = 0
    for i in range(6):
        w = (w << 8) | int(b[9 + i])
    fix.course = w >> 38
    fix.speed = (w >> 28) & 0x3FF
    fix.object_id = w & 0xFFFFF
    return fix


def gps_meta_for_lsf(fix: GpsFix) -> np.ndarray:
    """Fit the position blob into the 14-byte LSF META field.

    The reference's layout is 15 bytes, one more than META holds (its
    encode path was never finished, so the overrun was latent); the low
    8 bits of the 20-bit object id are dropped to fit.
    """
    return encode_gps_meta(fix)[:14]


class GpsReader:
    """Background NMEA reader (gps_thread, gps.cpp:241-253): consumes
    lines from a serial device or file path and keeps the latest fix."""

    def __init__(self, path: str = "/dev/ttyACM0"):
        self.path = path
        self.fix = GpsFix()
        # parse_nmea mutates a fix field-by-field; the session thread
        # reads self.fix concurrently (gps_meta_for_lsf), so sentences
        # are parsed into this private fix and PUBLISHED as a whole
        # snapshot -- a reader can never see half of one sentence's
        # coordinates paired with half of another's
        self._work = GpsFix()
        self._running = False
        self._thread: threading.Thread | None = None

    def _parse_publish(self, line: str) -> bool:
        import copy

        ok = parse_nmea(line, self._work)
        self.fix = copy.copy(self._work)   # atomic reference swap
        return ok

    def _run(self):
        try:
            with open(self.path, "r", errors="replace") as f:
                while self._running:
                    line = f.readline()
                    if not line:
                        break
                    self._parse_publish(line)
        except OSError:
            pass

    def open(self):
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def close(self):
        self._running = False
        if self._thread:
            self._thread.join(timeout=1.0)

    def feed(self, sentence: str) -> bool:
        """Synchronous path for tests and file replay."""
        return self._parse_publish(sentence)
