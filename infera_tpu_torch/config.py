"""Config / flag system.

Re-design of the reference env-var config singleton
(upstream infera/src/config.rs:14, :101-176; catalog in
docs/CONFIGURATION.md). Parity behaviors kept:

- The same 8 ``INFERA_*`` env vars, same defaults, read once at first use.
- Invalid values silently fall back to defaults (config.rs:101-176).

TPU-native additions: mesh/topology knobs for the distributed query engine
(data-parallel axis size, shuffle partition count, padded-batch bucketing)
in the same read-once dataclass.
"""

from __future__ import annotations

import os
import tempfile
import threading
from dataclasses import dataclass
from enum import IntEnum
from pathlib import Path

DEFAULT_CACHE_SIZE_LIMIT = 1 << 30  # 1 GiB (config.rs:8)
DEFAULT_HTTP_TIMEOUT_S = 30
DEFAULT_HTTP_RETRY_ATTEMPTS = 3
DEFAULT_HTTP_RETRY_DELAY_MS = 1000


class LogLevel(IntEnum):
    """Leveled logging (config.rs:18-44). Lower value = more severe."""

    ERROR = 0
    WARN = 1
    INFO = 2
    DEBUG = 3

    @staticmethod
    def parse(s: str) -> "LogLevel | None":
        try:
            return LogLevel[s.strip().upper()]
        except KeyError:
            return None


class EvictionPolicy(IntEnum):
    """Cache eviction strategy (config.rs:49-67). Only LRU is implemented in
    the reference; LFU/FIFO parse but fall back to LRU behavior."""

    LRU = 0
    LFU = 1
    FIFO = 2

    @staticmethod
    def parse(s: str) -> "EvictionPolicy | None":
        try:
            return EvictionPolicy[s.strip().upper()]
        except KeyError:
            return None


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


@dataclass(frozen=True)
class InferaConfig:
    cache_dir: Path
    cache_size_limit: int
    verbose: bool
    http_timeout_s: int
    http_retry_attempts: int
    http_retry_delay_ms: int
    eviction_policy: EvictionPolicy
    log_level: LogLevel
    # --- TPU-native additions (not in the reference) ---
    # Padded row-bucket sizes for static-shape jit caching (SURVEY.md §7.3).
    batch_buckets: tuple = (256, 1024, 4096, 16384, 65536, 262144, 1048576)
    # Number of hash partitions used by the distributed shuffle.
    shuffle_partitions: int = 8
    # INFERA_MESH=N — data-parallel mesh size for partitioned SQL execution
    # (0 = off). When set, fused device plans lower through shard_map over an
    # N-device dp mesh with a bucket-pack + all_to_all exchange for GROUP BY.
    mesh_devices: int = 0

    def should_log(self, level: LogLevel) -> bool:
        return level <= self.log_level

    @staticmethod
    def from_env() -> "InferaConfig":
        cache_dir = os.environ.get("INFERA_CACHE_DIR")
        if cache_dir:
            cache_path = Path(cache_dir)
        else:
            cache_path = Path(tempfile.gettempdir()) / "infera_cache"

        log_level = None
        raw_level = os.environ.get("INFERA_LOG_LEVEL")
        if raw_level is not None:
            log_level = LogLevel.parse(raw_level)
        if log_level is None:
            # INFERA_VERBOSE=1 is the deprecated alias for DEBUG-ish output.
            log_level = LogLevel.DEBUG if _env_bool("INFERA_VERBOSE", False) else LogLevel.WARN

        eviction = None
        raw_ev = os.environ.get("INFERA_CACHE_EVICTION")
        if raw_ev is not None:
            eviction = EvictionPolicy.parse(raw_ev)
        if eviction is None:
            eviction = EvictionPolicy.LRU

        return InferaConfig(
            cache_dir=cache_path,
            cache_size_limit=_env_int("INFERA_CACHE_SIZE_LIMIT", DEFAULT_CACHE_SIZE_LIMIT),
            verbose=_env_bool("INFERA_VERBOSE", False),
            http_timeout_s=_env_int("INFERA_HTTP_TIMEOUT", DEFAULT_HTTP_TIMEOUT_S),
            http_retry_attempts=_env_int("INFERA_HTTP_RETRY_ATTEMPTS", DEFAULT_HTTP_RETRY_ATTEMPTS),
            http_retry_delay_ms=_env_int("INFERA_HTTP_RETRY_DELAY", DEFAULT_HTTP_RETRY_DELAY_MS),
            eviction_policy=eviction,
            log_level=log_level,
            shuffle_partitions=_env_int("INFERA_SHUFFLE_PARTITIONS", 8),
            mesh_devices=_env_int("INFERA_MESH", 0),
        )


_lock = threading.Lock()
_config: InferaConfig | None = None


def get_config() -> InferaConfig:
    """Process-wide lazy singleton, read once from env (config.rs:14)."""
    global _config
    if _config is None:
        with _lock:
            if _config is None:
                _config = InferaConfig.from_env()
    return _config


def reset_config_for_tests() -> None:
    """Drop the singleton so the next get_config() re-reads the environment.

    The reference cannot do this (Lazy is immutable); tests there set env vars
    before first touch. We expose an explicit reset for test hygiene.
    """
    global _config
    with _lock:
        _config = None
