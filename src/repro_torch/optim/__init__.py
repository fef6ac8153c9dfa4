"""Optimizers of the port: AdamW with the deterministic global-norm clip
(``adamw``)."""

from . import adamw  # noqa: F401
