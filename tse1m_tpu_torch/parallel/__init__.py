"""The mesh: a 1-D data mesh over a ``torch.distributed`` world (one rank a
process), the collectives that replace JAX's ``psum``/``pmin``/
``all_gather``/``all_to_all``, starting and feeding a world
(``multihost``), and the RQ reductions over it (``rq_mesh``)."""

from . import multihost, rq_mesh
from .mesh import Mesh, detection_hist_sharded, make_mesh, pad_to_devices
from .rq_mesh import auto_mesh

__all__ = ["Mesh", "auto_mesh", "detection_hist_sharded", "make_mesh",
           "multihost", "pad_to_devices", "rq_mesh"]
