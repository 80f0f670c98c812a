"""SQL surface: lexer → parser → executor over the columnar engine, with the
13 infera_* scalar functions registered (parity with the reference's DuckDB
binding, upstream infera/bindings/infera_extension.cpp:546-592). Aggregates
over one scanned table run as kernel K2 on CUDA (``device_plan``)."""

from . import functions  # noqa: F401  (registers scalar functions)
from .executor import Catalog, Connection, QueryResult  # noqa: F401
from .parser import parse_one, parse_sql  # noqa: F401
