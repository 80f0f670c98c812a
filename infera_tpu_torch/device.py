"""Device selection.

The port runs on CUDA unless the caller asks for the CPU: with
``INFERA_PLATFORM=cpu`` in the environment (as ``infera_tpu`` reads it) or by
calling ``set_device("cpu")``. Without CUDA and without that request, the
first use of the device raises; importing the package does not.
"""

from __future__ import annotations

import os
import threading

import torch

_lock = threading.Lock()
_device: torch.device | None = None


def set_device(device) -> None:
    """Pin the device that models load onto (``"cpu"`` or ``"cuda[:i]"``);
    ``None`` goes back to ``INFERA_PLATFORM`` and the CUDA default."""
    global _device
    with _lock:
        _device = None if device is None else torch.device(device)


def get_device() -> torch.device:
    """The device that new models load onto."""
    with _lock:
        device = _device
    if device is None:
        platform = os.environ.get("INFERA_PLATFORM", "").strip().lower()
        device = torch.device("cpu" if platform == "cpu" else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: set INFERA_PLATFORM=cpu or call "
            "infera_tpu_torch.set_device('cpu') to run on the CPU")
    return device
