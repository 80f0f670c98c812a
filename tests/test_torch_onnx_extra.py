"""The rest of the port's ONNX op set against ``infera_tpu``'s, on the CPU.

Every case of ``infera_tpu_torch.testing.onnx_cases.CASES`` (the 64
registrations of ``ops_extra.py`` beyond its unary ops, ``rnn_ops.py``,
``sequence_ops.py`` and ``signal_vision_ops.py``) runs through both
packages from the same bytes and inputs at its tolerance, or raises the
same refusal prefix; the random ops are held to their properties on both
sides (``check_case``).
"""

from __future__ import annotations

import pytest

from infera_tpu_torch.errors import OnnxError
from infera_tpu_torch.onnx.executor import compile_model_bytes as port_compile
from infera_tpu_torch.testing.onnx_cases import CASES, check_case, run_case

EXTRA_MODULES = {"infera_tpu.onnx.ops_extra", "infera_tpu.onnx.rnn_ops",
                 "infera_tpu.onnx.sequence_ops", "infera_tpu.onnx.signal_vision_ops"}


@pytest.mark.parametrize("cid", list(CASES))
def test_op_matches_infera_tpu(cid):
    from infera_tpu.errors import OnnxError as RefOnnxError
    from infera_tpu.onnx.executor import compile_model_bytes as ref_compile

    case = CASES[cid]
    data = case.model().serialize()
    want = run_case(ref_compile, RefOnnxError, data, case.feeds)
    got = run_case(port_compile, OnnxError, data, case.feeds, device="cpu")
    check_case(case, got, want, (RefOnnxError, OnnxError))


def test_every_extra_registration_is_ported_and_has_a_case():
    import infera_tpu.onnx  # noqa: F401  (registers every module)
    import infera_tpu.onnx.ops as ref_ops
    import infera_tpu_torch.onnx  # noqa: F401
    import infera_tpu_torch.onnx.ops as port_ops

    ref = {op for (domain, op), fn in ref_ops.OP_IMPLS.items()
           if domain == "" and fn.__module__ in EXTRA_MODULES}
    assert len(ref) == 64, len(ref)
    assert not sorted(op for op in ref if ("", op) not in port_ops.OP_IMPLS)
    covered = {n.op_type for case in CASES.values() for n in case.nodes}
    assert not sorted(ref - covered), sorted(ref - covered)
    refused = {n.op_type for case in CASES.values() if case.refuse for n in case.nodes}
    assert len(refused) >= 30, len(refused)
