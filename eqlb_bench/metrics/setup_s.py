"""setup_s: process start to the first timed call, host clock: imports,
CUDA context, host tables, engine, geometry caches, kernel load and the
warm-up of the cell's calls.  The benchmark's own steps (loading or
generating the mesh, the reference's topology, drawing the load cases)
are timed apart and left out."""


def read(ctx):
    return ctx.setup_s
