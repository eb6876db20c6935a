from .topology import TriMesh  # noqa: F401
from .generators import (  # noqa: F401
    unit_square,
    unit_square_unstructured,
    rectangle,
    lshape,
    permute_vertices,
    cook_membrane,
)
from .refine import refine_uniform, refine_marked, refine_facets  # noqa: F401
from .msh_io import read_msh  # noqa: F401
