"""Checkpoints of the port's trees in the reference's format
(``checkpoint``)."""

from . import checkpoint  # noqa: F401
from .checkpoint import (CheckpointError, latest_step, restore,  # noqa: F401
                         restore_latest_valid, save, save_every)
