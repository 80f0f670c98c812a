"""ONNX subsystem: dependency-free protobuf codec, PyTorch op implementations
(the standard ops and the ai.onnx.ml ops) and the eager graph executor."""

from . import builder, ml_ops, ops, proto  # noqa: F401
from .executor import (  # noqa: F401
    CompiledOnnxModel,
    compile_model_bytes,
    compile_model_file,
    shape_rows_cols,
)
