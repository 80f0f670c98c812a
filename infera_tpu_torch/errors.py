"""Error subsystem.

TPU-native re-design of the reference error module
(upstream infera/src/error.rs:11-62): one exception hierarchy whose
``str()`` forms reproduce the reference's error strings byte-for-byte, since the
SQL parity tests pin exact messages (see upstream test/sql/test_edge_cases.test).

Instead of a thread-local "last error" slot behind a C ABI (error.rs:70-102),
errors propagate as Python exceptions; the SQL layer wraps them with the same
"Invalid Input Error: ..." envelopes the reference's C++ binding produces
(upstream infera/bindings/infera_extension.cpp:52-55).
"""

from __future__ import annotations


class InferaError(Exception):
    """Base class for all engine errors. str(err) is the parity error string."""


class ModelNotFound(InferaError):
    def __init__(self, name: str):
        self.name = name
        super().__init__(f"Model not found: {name}")


class InvalidInputShape(InferaError):
    def __init__(self, expected: str, actual: str):
        self.expected = expected
        self.actual = actual
        super().__init__(f"Invalid input shape: expected {expected}, got {actual}")


class OnnxError(InferaError):
    def __init__(self, msg: str):
        super().__init__(f"ONNX error: {msg}")


class MemoryError_(InferaError):
    def __init__(self):
        super().__init__("Memory allocation error")


class Utf8Error(InferaError):
    def __init__(self):
        super().__init__("Invalid UTF-8 string")


class NullPointer(InferaError):
    def __init__(self):
        super().__init__("Null pointer passed")


class IoError(InferaError):
    def __init__(self, msg: str):
        super().__init__(f"IO error: {msg}")


class JsonError(InferaError):
    def __init__(self, msg: str):
        super().__init__(f"JSON serialization error: {msg}")


class FeatureNotEnabled(InferaError):
    def __init__(self, msg: str):
        super().__init__(f"Feature not enabled: {msg}")


class HttpRequestError(InferaError):
    def __init__(self, msg: str):
        super().__init__(f"HTTP request failed: {msg}")


class CacheDirError(InferaError):
    def __init__(self, msg: str):
        super().__init__(f"Failed to create cache directory: {msg}")


class InvalidBlobSize(InferaError):
    def __init__(self):
        super().__init__("Invalid BLOB size: length must be a multiple of 4")


class BlobShapeMismatch(InferaError):
    def __init__(self, expected: int, actual: int):
        self.expected = expected
        self.actual = actual
        super().__init__(
            "BLOB data does not match model's expected input shape. "
            f"Expected {expected} elements, but BLOB contained {actual}."
        )


class SqlError(Exception):
    """An error surfaced at the SQL layer (binding-level message envelopes).

    Mirrors DuckDB's InvalidInputException text produced by the reference C++
    binding (infera_extension.cpp:52-55, :275-279).
    """


def invalid_input(msg: str) -> SqlError:
    return SqlError(f"Invalid Input Error: {msg}")


def inference_failed(model_name: str, err: InferaError) -> SqlError:
    """infera_extension.cpp:272-274 envelope."""
    return invalid_input(f"Inference failed for model '{model_name}': {err}")
