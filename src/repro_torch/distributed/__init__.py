"""Multi-process data parallelism on ``torch.distributed``.

The port's counterpart of the reference's ``repro.distributed`` and of
JAX's named mesh axes: one process per rank, each rank holding a
``ProcessGroup`` where the reference names a mesh axis.

  * ``comm``        — the collectives every other module calls (``psum``
                      on integers, ``pmax``, ``all_gather``, the rank and
                      the world size) and ``init_group``;
  * ``collectives`` — the data-parallel and the elastic train steps;
  * ``spawn``       — start a group of ranks as fresh interpreters, each
                      with a timeout, and collect what each returns.
"""

from . import comm  # noqa: F401
