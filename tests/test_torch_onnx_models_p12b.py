"""The three models of the rest of ONNX through both packages on the CPU, at
small widths: onnxruntime's dynamic quantization of the config-2 MLP, the
LSTM language model of pytorch/examples ``word_language_model`` and
Whisper's log-mel front end (``chip_smoke``'s graphs, which it runs on the
card at full width). Each output within 1e-5 of ``infera_tpu``'s largest
magnitude (the f32 bound).
"""

import numpy as np
import pytest

import infera_tpu as it
import infera_tpu_torch as itt
from chip_smoke import logmel_model, lstm_lm_model, quantize_dynamic_mlp
from infera_tpu.onnx.executor import compile_model_bytes as ref_compile
from infera_tpu_torch.onnx import builder, proto
from infera_tpu_torch.onnx.executor import compile_model_bytes as port_compile
from infera_tpu_torch.registry import MODELS as PORT_MODELS

F32 = 1e-5


def _close(got, want, rel=F32):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.all(np.isfinite(got))
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, err / scale


def _run_both(model, *xs):
    data = model.serialize()
    want = [np.asarray(o) for o in ref_compile(data, "ref").run(*xs)]
    got = [o.numpy() for o in port_compile(data, "port", device="cpu").run(*xs)]
    return got, want


def test_quantized_mlp_matches_infera_tpu_through_predict(tmp_path, clean_registry):
    f32 = builder.mlp_model(in_dim=8, hidden=(16, 16), out_dim=4, softmax=True)
    q = quantize_dynamic_mlp(f32)
    assert [n.op_type for n in q.graph.nodes[:6]] == [
        "DynamicQuantizeLinear", "MatMulInteger", "Cast", "Mul", "Mul", "Add"]
    path = str(tmp_path / "mlp_q.onnx")
    proto.save_model_file(q, path)
    x = np.random.default_rng(2).standard_normal((512, 8)).astype(np.float32)
    it.load_model("mlp_q", path)
    itt.set_device("cpu")
    PORT_MODELS.clear()
    try:
        itt.load_model("mlp_q", path)
        got, want = itt.predict("mlp_q", x), it.predict("mlp_q", x)
    finally:
        PORT_MODELS.clear()
        itt.set_device(None)
    assert (got.rows, got.cols) == (want.rows, want.cols) == (512, 4)
    _close(got.data, want.data)
    # the quantized model stays near the f32 one it came from
    (ref,), _ = _run_both(f32, x)
    assert np.abs(got.data.reshape(512, 4) - ref).max() < 0.05


@pytest.mark.parametrize("batch", [1, 3])
def test_lstm_language_model_matches_infera_tpu(batch):
    m = lstm_lm_model(seed=1, vocab=50, emsize=8, nhid=12, nlayers=2, bptt=6)
    tokens = np.random.default_rng(3).integers(0, 50, (6, batch)).astype(np.int64)
    (got,), (want,) = _run_both(m, tokens)
    assert got.shape == (6, batch, 50)
    _close(got, want)


def test_lstm_language_model_batch_rows_agree():
    """A sequence's logits do not depend on the other sequences of the batch."""
    m = port_compile(lstm_lm_model(seed=1, vocab=50, emsize=8, nhid=12, bptt=6).serialize(), "lm",
                     device="cpu")
    tokens = np.random.default_rng(4).integers(0, 50, (6, 5)).astype(np.int64)
    wide = m.run(tokens)[0].numpy()
    narrow = m.run(tokens[:, :2])[0].numpy()
    _close(wide[:, :2], narrow)


def test_logmel_front_end_matches_infera_tpu():
    m = logmel_model(n_fft=16, hop=4, n_mels=6, sample_rate=800, f_max=400.0, samples=200)
    audio = np.random.default_rng(5).standard_normal((2, 200)).astype(np.float32)
    (logmel, mel), (want_log, want_mel) = _run_both(m, audio)
    assert mel.shape == (2, (200 + 16 - 16) // 4 + 1, 6)
    _close(mel, want_mel)
    _close(logmel, want_log)
    np.testing.assert_allclose(logmel, np.log(np.maximum(mel, np.float32(1e-10))), rtol=1e-6, atol=1e-6)


def test_logmel_power_matches_numpy_fft():
    """The mel power against numpy's FFT of the reflect-padded,
    Hann-windowed frames in f64, through the same mel triangles."""
    from infera_tpu_torch.onnx.signal_vision_ops import _mel_triangles

    n_fft, hop = 16, 4
    m = logmel_model(n_fft=n_fft, hop=hop, n_mels=6, sample_rate=800, f_max=400.0, samples=64)
    audio = np.random.default_rng(6).standard_normal((1, 64)).astype(np.float32)
    (_, mel), _ = _run_both(m, audio)
    padded = np.pad(audio[0].astype(np.float64), n_fft // 2, mode="reflect")
    window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
    frames = np.stack([padded[i:i + n_fft] * window for i in range(0, len(padded) - n_fft + 1, hop)])
    want = np.abs(np.fft.rfft(frames, axis=-1)) ** 2 @ _mel_triangles(6, n_fft, 800, 0.0, 400.0)
    _close(mel[0], want, rel=1e-5)
