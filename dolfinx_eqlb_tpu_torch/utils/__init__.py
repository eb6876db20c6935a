"""Tooling around the port: the performance-measurement harness
(``perftest``), profiling (``profiling``) and ParaView output (``io``)."""
from .perftest import run_perftest  # noqa: F401
from .profiling import timed, trace, sync  # noqa: F401
from .io import write_vtu, write_xdmf, flux_cell_values  # noqa: F401
