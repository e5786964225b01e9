"""Host IO: sample sources/sinks, reflector protocol, codec2, hosts."""

from . import codec2, gps, hosts, ptt, reflector, sources  # noqa: F401
