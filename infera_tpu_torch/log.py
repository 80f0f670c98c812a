"""Leveled stderr logging, parity with the reference's ``log!`` macro
(upstream infera/src/config.rs:179-207): messages print as
``[LEVEL] text`` on stderr, gated by the configured log level."""

from __future__ import annotations

import sys

from .config import LogLevel, get_config


def log(level: LogLevel, msg: str) -> None:
    if get_config().should_log(level):
        print(f"[{level.name}] {msg}", file=sys.stderr)


def error(msg: str) -> None:
    log(LogLevel.ERROR, msg)


def warn(msg: str) -> None:
    log(LogLevel.WARN, msg)


def info(msg: str) -> None:
    log(LogLevel.INFO, msg)


def debug(msg: str) -> None:
    log(LogLevel.DEBUG, msg)
