"""ONNX subsystem: dependency-free protobuf codec, PyTorch op implementations
(the whole standard op set ``infera_tpu`` runs: the core ops, If/Loop/Scan,
the extended ops with the quantized-model family, RNN/GRU/LSTM, the Sequence
and Optional ops, the signal, vision and random ops, and the ai.onnx.ml ops)
and the eager graph executor."""

from . import (  # noqa: F401
    builder,
    control_flow,
    ml_ops,
    ops,
    ops_extra,
    proto,
    rnn_ops,
    sequence_ops,
    signal_vision_ops,
)
from .executor import (  # noqa: F401
    CompiledOnnxModel,
    compile_model_bytes,
    compile_model_file,
    shape_rows_cols,
)
