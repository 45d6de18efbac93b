"""Process launch for multi-rank runs (``launch.ranks``) and the mesh
factories and roofline constants (``launch.mesh``)."""
from .mesh import HW, make_local_mesh, make_production_mesh

__all__ = ["HW", "make_local_mesh", "make_production_mesh"]
