"""Columnar data layer: typed columns with validity masks (the TPU-native
analog of DuckDB's DataChunk; SURVEY.md §7.1)."""

from . import types  # noqa: F401
from .batch import Column, Table, format_float, format_sql_value, infer_sql_type  # noqa: F401
