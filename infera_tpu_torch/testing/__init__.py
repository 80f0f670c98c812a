"""Test harnesses: the sqllogictest runner."""

from .sqllogic import SqlLogicRunner  # noqa: F401
