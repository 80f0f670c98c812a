"""Framework version. The reference reports its crate version through
infera_get_version (upstream infera/src/lib.rs:276-286)."""

VERSION = "0.4.0"
ONNX_BACKEND = "torch-cuda"
