"""The benchmark of the PyTorch and CUDA port (``m17_sdr_tpu_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the card; see ``portbench/README.md``.
The benchmark drives the port and never loads JAX or the JAX package; its
reference chain (``portbench/ref``) imports nothing of the port.
"""
