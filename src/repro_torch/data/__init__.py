"""Tokenized data sources of the port (``pipeline``): a copy of the
reference's numpy pipeline."""

from . import pipeline  # noqa: F401
from .pipeline import DataCfg, PackedFile, SyntheticLM, make_source  # noqa: F401
