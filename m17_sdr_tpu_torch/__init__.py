"""PyTorch port of the m17_sdr_tpu receive path, with CUDA kernels for Hopper.

The package mirrors ``m17_sdr_tpu``'s subpackages and module names.  It
imports torch and numpy only: every table is re-derived here, and the
JAX package is never imported (its ``spec`` and ``dsp`` packages pull in
JAX when imported).  Functions take tensors and work on the device the
tensors live on.  The two hand-written CUDA kernels (``csrc/``) are
built by ``_build.py`` on first use.
"""
