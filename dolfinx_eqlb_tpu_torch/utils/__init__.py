"""Tooling around the port: the performance-measurement harness
(``perftest``), profiling (``profiling``) and ParaView output (``io``).

``run_perftest`` is loaded on first use: ``perftest`` imports the
equilibrators, whose solve wrappers import ``profiling`` from here."""
from .profiling import timed, trace, sync  # noqa: F401
from .io import write_vtu, write_xdmf, flux_cell_values  # noqa: F401


def __getattr__(name):
    if name == "run_perftest":
        from .perftest import run_perftest
        return run_perftest
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
