"""Thread-safe model registry.

Re-design of the reference's global model store — a
``Lazy<RwLock<HashMap<String, OnnxModel>>>``
(upstream infera/src/model.rs:41-42): many concurrent readers during
inference (engine.rs:118), exclusive writers on load/unload (engine.rs:80,
lib.rs:88). Python's GIL does not make check-then-act sequences atomic, so we
implement a proper readers-writer lock.

In the multi-host design (SURVEY.md §7.1) this registry is replicated per
host: every process compiles its own executables from the same model bytes,
and load/unload/autoload are broadcast through the coordination service (see
infera_tpu.parallel.distributed).
"""

from __future__ import annotations

import threading
from typing import Iterator


class RwLock:
    """Writer-preferring readers-writer lock."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._waiting_writers = 0

    def acquire_read(self):
        with self._cond:
            while self._writer or self._waiting_writers:
                self._cond.wait()
            self._readers += 1

    def release_read(self):
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self):
        with self._cond:
            self._waiting_writers += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._waiting_writers -= 1
            self._writer = True

    def release_write(self):
        with self._cond:
            self._writer = False
            self._cond.notify_all()

    class _ReadGuard:
        def __init__(self, lock):
            self._lock = lock

        def __enter__(self):
            self._lock.acquire_read()

        def __exit__(self, *exc):
            self._lock.release_read()

    class _WriteGuard:
        def __init__(self, lock):
            self._lock = lock

        def __enter__(self):
            self._lock.acquire_write()

        def __exit__(self, *exc):
            self._lock.release_write()

    def read(self):
        return RwLock._ReadGuard(self)

    def write(self):
        return RwLock._WriteGuard(self)


class ModelRegistry:
    """name → CompiledOnnxModel under an RwLock."""

    def __init__(self):
        self._lock = RwLock()
        self._models: dict = {}

    def insert(self, name: str, model) -> None:
        with self._lock.write():
            self._models[name] = model

    def remove(self, name: str) -> bool:
        with self._lock.write():
            return self._models.pop(name, None) is not None

    def get(self, name: str):
        with self._lock.read():
            return self._models.get(name)

    def names(self) -> list:
        with self._lock.read():
            return list(self._models.keys())

    def __contains__(self, name: str) -> bool:
        with self._lock.read():
            return name in self._models

    def __len__(self) -> int:
        with self._lock.read():
            return len(self._models)

    def clear(self) -> None:
        with self._lock.write():
            self._models.clear()

    def items(self) -> Iterator:
        with self._lock.read():
            return iter(list(self._models.items()))


# Process-wide registry (model.rs:41).
MODELS = ModelRegistry()
