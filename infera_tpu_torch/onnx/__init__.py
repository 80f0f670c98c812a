"""ONNX subsystem: dependency-free protobuf codec, PyTorch op implementations
(the core standard ops, If/Loop/Scan, HardSwish and the ai.onnx.ml ops) and
the eager graph executor."""

from . import builder, control_flow, ml_ops, ops, ops_extra, proto  # noqa: F401
from .executor import (  # noqa: F401
    CompiledOnnxModel,
    compile_model_bytes,
    compile_model_file,
    shape_rows_cols,
)
