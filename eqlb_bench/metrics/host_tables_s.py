"""host_tables_s: host clock around the program's host tables: TriMesh,
eqlb.patches.build_patches, FunctionSpace, EqlbEngine.__init__,
BoundaryData."""


def read(ctx):
    return ctx.host_tables_s
