"""Extended ONNX ops (beyond ``onnx/ops.py``'s core set).

Counterpart of ``infera_tpu/onnx/ops_extra.py``. This slice carries
HardSwish, which the MobileNetV3-Small stand-in
(``builder.mobilenet_like_model``) needs, with the other one-line unary ops
that file builds on ops.py's ``_unary`` (so their registered functions
belong to ``infera_tpu.onnx.ops``, and the op-set test counts them there).
The rest of that file (IsInf, Selu, Celu, Shrink, padding and scatter ops,
Einsum, TopK, the quantized-model family, ...) is ROADMAP item P12b.
"""

from __future__ import annotations

import torch

from .ops import _unary, register

register("Tan")(_unary(torch.tan))
register("Asin")(_unary(torch.asin))
register("Acos")(_unary(torch.acos))
register("Atan")(_unary(torch.atan))
register("Sinh")(_unary(torch.sinh))
register("Cosh")(_unary(torch.cosh))
register("Asinh")(_unary(torch.asinh))
register("Acosh")(_unary(torch.acosh))
register("Atanh")(_unary(torch.atanh))
register("Sign")(_unary(torch.sign))
register("IsNaN")(_unary(torch.isnan))
register("HardSwish")(_unary(lambda x: x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)))
register("Mish")(_unary(lambda x: x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))))
