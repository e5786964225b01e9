"""Harnesses run as programs (``python -m m17_sdr_tpu_torch.tools.<name>``),
each the counterpart of the JAX package's script of the same name under
``tools/``."""
