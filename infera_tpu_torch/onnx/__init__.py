"""ONNX subsystem: dependency-free protobuf codec, PyTorch op implementations
and the eager graph executor."""

from . import builder, ops, proto  # noqa: F401
from .executor import (  # noqa: F401
    CompiledOnnxModel,
    compile_model_bytes,
    compile_model_file,
    shape_rows_cols,
)
