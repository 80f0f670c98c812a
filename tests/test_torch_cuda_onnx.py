"""The port's ONNX op set and models on the card, against the port on the CPU.

These need a CUDA card and skip without one. On the card:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_onnx.py`` (no
JAX is imported). Every case of ``test_torch_onnx_ops.py`` runs on the card
and on the CPU from the same bytes and inputs, at that file's tolerances;
the refusals must raise the same message prefix; so does every case of
``infera_tpu_torch.testing.onnx_cases`` (the rest of ONNX; the random ops
held to their properties). The models: the MobileNetV3-Small stand-in at
batch 1 and 2, the transformer encoder at ``onnx.builder``'s widths in f32,
bf16 and int8, and the If, Loop (both paths) and Scan graphs, at
``test_torch_onnx_models.py``'s bounds; the dynamically quantized config-2
MLP, the LSTM language model and the log-mel front end of ``chip_smoke``
at their full widths (fewer rows, sequences and clips) within 1e-5 of the
CPU's largest magnitude (for the log-mel front end, its mel power; the log
magnifies the f32 DFT's rounding in the faintest bins, so it is held to the
log of the card's own mel power). Conv runs without TF32: the flags stay off, and
a convolution whose products TF32 would round (operands one part in 2^13
from 1) matches an f64 sum to 1e-6.
"""

import numpy as np
import pytest
import torch

import infera_tpu_torch  # noqa: F401  (sets the TF32 flags)
from infera_tpu_torch.errors import OnnxError
from infera_tpu_torch.onnx import builder
from infera_tpu_torch.onnx.executor import compile_model_bytes
from infera_tpu_torch.testing.onnx_cases import CASES as EXTRA_CASES
from test_torch_onnx_ops import CASES, check_case, run_case

pytestmark = pytest.mark.cuda

F32_MODEL = 1e-5
BOUNDS = {"f32": (F32_MODEL, F32_MODEL), "bf16": (1e-2, 5e-4), "int8": (2e-2, 1e-3)}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("cid", list(CASES))
def test_op_on_the_card(cuda, cid):
    case = CASES[cid]
    data = case.model().serialize()
    want = run_case(compile_model_bytes, OnnxError, data, case.feeds, device="cpu")
    got = run_case(compile_model_bytes, OnnxError, data, case.feeds, device=cuda)
    check_case(case, got, want)


@pytest.mark.parametrize("cid", list(EXTRA_CASES))
def test_extra_op_on_the_card(cuda, cid):
    case = EXTRA_CASES[cid]
    data = case.model().serialize()
    want = run_case(compile_model_bytes, OnnxError, data, case.feeds, device="cpu")
    got = run_case(compile_model_bytes, OnnxError, data, case.feeds, device=cuda)
    check_case(case, got, want)


def _card_and_cpu(model, x, precision="f32"):
    data = model.serialize()
    outs = []
    for device in ("cuda", "cpu"):
        m = compile_model_bytes(data, "m", precision, device=device)
        outs.append([o.cpu().numpy() for o in m.run(x)])
    return outs


RNG = np.random.default_rng(15)
MODELS = {
    "mobilenet-b1": (builder.mobilenet_like_model(), RNG.standard_normal((1, 3, 224, 224)), "f32"),
    "mobilenet-b2": (builder.mobilenet_like_model(), RNG.standard_normal((2, 3, 224, 224)), "f32"),
    **{f"transformer-{p}": (builder.transformer_encoder_model(),
                            RNG.standard_normal((512, 16 * 64)), p) for p in BOUNDS},
    "if-then": (builder.if_model(), np.abs(RNG.standard_normal((3, 4))), "f32"),
    "if-else": (builder.if_model(), -np.abs(RNG.standard_normal((3, 4))), "f32"),
    "if-static": (builder.if_model(static_cond=True), RNG.standard_normal((3, 4)), "f32"),
    "loop-while": (builder.loop_model(trips=5), RNG.standard_normal((3, 4)), "f32"),
    "loop-scan-outputs": (builder.loop_model(trips=4, scan_output=True),
                          RNG.standard_normal((3, 4)), "f32"),
    "scan": (builder.scan_model(), RNG.standard_normal((6, 4)), "f32"),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_model_on_the_card(cuda, name):
    model, x, precision = MODELS[name]
    got, want = _card_and_cpu(model, x.astype(np.float32), precision)
    worst, mean = BOUNDS[precision]
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.all(np.isfinite(g))
        scale = float(np.abs(w).max())
        err = np.abs(g - w)
        assert err.max() <= worst * scale and err.mean() <= mean * scale, \
            (err.max() / scale, err.mean() / scale)


def test_conv_runs_without_tf32(cuda):
    from infera_tpu_torch.onnx.proto import Attribute, Graph, Model, Node, Tensor, ValueInfo

    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    rng = np.random.default_rng(0)
    cin = 64
    x = (1 + rng.integers(1, 8, (2, cin, 16, 16)) * 2.0 ** -13).astype(np.float32)
    w = (1 + rng.integers(1, 8, (8, cin, 3, 3)) * 2.0 ** -13).astype(np.float32)
    g = Graph(name="conv",
              nodes=[Node(op_type="Conv", inputs=["X", "W"], outputs=["Y"], name="conv",
                          attributes={"pads": Attribute.make("pads", [1, 1, 1, 1])})],
              initializers={"W": Tensor.from_array("W", w)},
              inputs=[ValueInfo(name="X", shape=[-1, cin, 16, 16])],
              outputs=[ValueInfo(name="Y", shape=[-1, 8, 16, 16])])
    got = compile_model_bytes(Model(graph=g).serialize(), "conv", device=cuda).run(x)[0]
    want = torch.nn.functional.conv2d(torch.from_numpy(x).double(), torch.from_numpy(w).double(),
                                      padding=1).numpy()
    assert torch.backends.cudnn.allow_tf32 is False
    # TF32 keeps 10 bits of each operand: the 2^-13 parts would be lost
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-6)


def _p12b_models():
    from chip_smoke import logmel_model, lstm_lm_model, quantize_dynamic_mlp

    rng = np.random.default_rng(18)
    mlp = builder.mlp_model(in_dim=32, hidden=(128, 128), out_dim=16, softmax=True)
    return {
        "quantized-mlp": (quantize_dynamic_mlp(mlp), rng.standard_normal((4096, 32)).astype(np.float32)),
        "lstm-lm": (lstm_lm_model(seed=0), rng.integers(0, 33278, (35, 2)).astype(np.int64)),
        "logmel": (logmel_model(), rng.standard_normal((1, 480000)).astype(np.float32) * 0.1),
    }


@pytest.mark.parametrize("name", ["quantized-mlp", "lstm-lm", "logmel"])
def test_p12b_model_on_the_card(cuda, name):
    model, x = _p12b_models()[name]
    got, want = _card_and_cpu(model, x)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and np.all(np.isfinite(g))
        scale = float(np.abs(w).max())
        if name == "logmel" and k == 0:
            # the log magnifies the f32 DFT's rounding in the faintest bins:
            # held to the log of the card's own mel power instead
            np.testing.assert_allclose(g, np.log(np.maximum(got[1], np.float32(1e-10))),
                                       rtol=1e-6, atol=1e-5)
            continue
        assert float(np.abs(g - w).max()) <= F32_MODEL * scale, float(np.abs(g - w).max()) / scale
