from .gro import read_gro, write_gro  # noqa: F401
from .pdb import read_pdb  # noqa: F401
from .pqr import read_pqr  # noqa: F401
from .ndx import read_ndx  # noqa: F401
from .bnd import read_bnd  # noqa: F401
