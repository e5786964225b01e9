"""Baseband DSP on the receive path: filter design, front end, equalizer."""
