"""Multi-device scale-out: the mesh, sharded placement, collectives.

The counterpart of the reference package's ``parallel``: there a
``jax.sharding.Mesh`` over chips with ``psum`` reductions; here one
process a rank over ``torch.distributed`` (:mod:`.mesh`,
:mod:`.multihost`), the map replicated on every rank, the object batch
split over the ranks, and the cluster-wide reductions (per-OSD
histograms, moved counts) as collectives.
"""

from . import multihost  # noqa: F401
from .mesh import Mesh  # noqa: F401
from .padding import (  # noqa: F401
    pad_to_multiple,
    padded_size,
    trim_to_size,
)
from .placement import make_mesh, sharded_placement_step  # noqa: F401
