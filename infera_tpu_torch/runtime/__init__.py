"""The native host runtime: a C++ data plane (blob decode, feature
extraction, hashing, radix partitioning, the numeric CSV parser) behind a
ctypes C ABI, with a numpy fallback where no C++ toolchain is present.

Counterpart of ``infera_tpu/runtime``."""

from .native import (  # noqa: F401
    blob_decode_f32,
    extract_features_f32,
    hash64_i64,
    native_available,
    radix_partition,
)
