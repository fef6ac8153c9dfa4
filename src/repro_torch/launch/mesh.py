"""The port's counterpart of the reference's ``launch/mesh.py``.

The reference builds a JAX mesh (``make_mesh(shape, axes)``) whose
``data`` axis its data-parallel steps reduce over.  The port has one
data-parallel axis, the ranks of a process group, one process per rank:
``make_mesh`` is ``distributed.comm.init_group``, and ``axis_size`` the
group's world size.  The reference's tensor, expert and sequence axes
(``model``, ``pod``) and their shardings are ``distributed/sharding.py``
of ROADMAP.md queue 1, item 6, not in the port.
"""

from __future__ import annotations

from ..distributed.comm import axis_size, init_group

#: ``make_mesh`` of the reference: the default process group
make_mesh = init_group

__all__ = ["make_mesh", "init_group", "axis_size"]
