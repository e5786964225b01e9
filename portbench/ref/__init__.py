"""The reference chain: a frozen copy of the port's plain receive and
transmit paths, on CPU tensors, importing nothing of the port.

The receive chain (``pipeline/rx.py``) is the port's plain chain as it
stood when the benchmark was made: the same front end, timing and framer
scan, equalizer, typed decodes and session layer, with the scan and the
Viterbi decoder written in numpy so that a step costs microseconds; their
sums are the same float32 sums in the same order, so the reference gives
the bits of the port's plain chain (a CPU test holds it to that).  The
transmit chain (``pipeline/tx.py``) builds the voice mix's waveforms.
"""
