"""The benchmark of the PyTorch and CUDA port (``dolfinx_eqlb_tpu_torch``):
flux equilibration through ``EqlbEngine.equilibrate`` at 1M cells in f64,
held to a plain reference (``reference/``).  ``python -m eqlb_bench.run``
runs one cell of ``BENCHMARK.json``."""
