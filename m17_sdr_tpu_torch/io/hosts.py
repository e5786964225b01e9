"""Reflector directory: name -> (ip, port) lookup.

Reference: net_find_reflector reads M17Hosts.txt lines of
"NAME IP PORT" (m17_net.cpp:314-334).  Same file format; the file
location is configurable instead of hard-coded CWD.

The port's own copy of ``m17_sdr_tpu.io.hosts``: the port imports nothing of the
JAX package, so it keeps copies of the modules it needs from it.
"""

from __future__ import annotations

import pathlib


def load_hosts(path: str | pathlib.Path) -> dict[str, tuple[str, int]]:
    out: dict[str, tuple[str, int]] = {}
    p = pathlib.Path(path)
    if not p.exists():
        return out
    for line in p.read_text().splitlines():
        parts = line.split()
        if len(parts) >= 3:
            try:
                out[parts[0]] = (parts[1], int(parts[2]))
            except ValueError:
                continue
    return out


def find_reflector(name: str, path: str | pathlib.Path) -> tuple[str, int] | None:
    return load_hosts(path).get(name)
