"""infera_tpu_torch — the PyTorch + CUDA port of ``infera_tpu`` for one NVIDIA
H100 (Hopper, ``sm_90a``).

The layout follows ``infera_tpu`` module for module; this package imports
PyTorch and numpy and nothing of JAX or ``infera_tpu``. Its slice so far:

- ``infera_tpu_torch.api``    — the 13-function public API
- ``infera_tpu_torch.engine`` — batched inference engine
- ``infera_tpu_torch.onnx``   — ONNX codec + eager PyTorch executor for the
                                MatMul/Gemm/Add/Relu/Softmax/Identity graphs
- ``infera_tpu_torch.ops``    — the CUDA kernels K6 (fused MLP), K1 and K3
                                (fused inference query), each beside its
                                plain PyTorch version; sources in ``csrc/``
- ``cache`` / ``config`` / ``errors`` / ``log`` / ``registry`` — support
  services, copied from ``infera_tpu``

Models load onto CUDA unless ``INFERA_PLATFORM=cpu`` is set or
``set_device("cpu")`` was called.
"""

import torch as _torch

# f32 is the parity path: matmuls and convolutions in full f32, never TF32
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .api import (  # noqa: E402,F401
    clear_cache,
    get_cache_info,
    get_loaded_models,
    get_model_info,
    get_version,
    is_model_loaded,
    load_model,
    predict,
    predict_from_blob,
    set_autoload_dir,
    unload_all_models,
    unload_model,
)
from .device import get_device, set_device  # noqa: E402,F401
from .engine import InferenceResult  # noqa: E402,F401
from .errors import InferaError  # noqa: E402,F401
from .version import VERSION  # noqa: E402,F401

__version__ = VERSION
