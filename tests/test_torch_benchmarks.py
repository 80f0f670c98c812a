"""``infera_tpu_torch.testing.benchmarks``: configs 1-4 at a few thousand rows
on the CPU, each output held against numpy or ``infera_tpu``'s query rebuilt
here, and ``roofline`` against the H100's peaks."""

import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infera_tpu.ops import pallas_query as jpq
from infera_tpu_torch.testing import benchmarks as bm

ROWS = 4096


def test_roofline_reads_the_cards_peaks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    # 67 GFLOP in 1 ms is the f32 peak; 989 GFLOP the bf16 one; 3.35 GB the HBM rate
    assert bm.roofline(67e9, 0, 1e-3).startswith("SOL: 100.0% of NVIDIA H100 80GB HBM3 "
                                                 "(compute-bound")
    assert bm.roofline(989e9, 0, 1e-3, f32=False).startswith("SOL: 100.0%")
    assert "50.0%" in bm.roofline(0, 1.675e9, 1e-3) and "memory-bound" in bm.roofline(0, 1e9, 1)


def test_card_peaks_by_name():
    assert bm.card_peaks("NVIDIA H100 80GB HBM3") == bm.PEAKS["SXM"]
    assert bm.card_peaks("NVIDIA H100 PCIe")["bf16"] == 756e12
    assert bm.card_peaks("NVIDIA H100 NVL")["bytes"] == 3.9e12
    assert bm.device_peaks(torch.device("cpu")) is None


def test_roofline_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bm.roofline(1e9, 1e9, 1.0) == "SOL: not measured (no CUDA card)"


def test_config1_linear():
    res = bm.bench_config1_linear(rows=ROWS, device="cpu")
    x = np.random.default_rng(0).standard_normal((ROWS, 3)).astype(np.float32)
    want = x @ np.array([[2.0], [-1.0], [0.5]], np.float32) + np.float32(0.25)
    np.testing.assert_allclose(res.output.numpy(), want, rtol=1e-6, atol=1e-6)
    assert res.name == "config1_linear_predict" and res.rows == ROWS and res.rows_per_s > 0


def _jax_config2(use_pallas):
    """``infera_tpu``'s config-2 query rebuilt from its draws: the Pallas
    kernel in interpret mode (bf16), or its XLA chain (f32)."""
    rng = np.random.default_rng(0)
    dims = [32, 128, 128, 16]
    params = [(jnp.asarray(rng.standard_normal((dims[i], dims[i + 1])), jnp.float32)
               * np.float32(1 / np.sqrt(dims[i])),
               jnp.asarray(rng.standard_normal(dims[i + 1]), jnp.float32) * 0.1)
              for i in range(3)]
    x = jnp.asarray(rng.standard_normal((ROWS, 32)), jnp.float32)
    if use_pallas:
        c, s = jpq.fused_mlp_query_columnar(params, x.T.astype(jnp.bfloat16), tile_n=1024,
                                            interpret=True, compute_dtype=jnp.bfloat16)
        return np.asarray(c), np.asarray(s)
    h = x
    for i, (w, b) in enumerate(params):
        h = jnp.dot(h, w, preferred_element_type=jnp.float32) + b
        if i < 2:
            h = jax.nn.relu(h)
    pred = jnp.argmax(h, axis=-1)
    sel = (h[:, 0] > 0).astype(jnp.float32)
    return (np.asarray(jax.ops.segment_sum(sel, pred, num_segments=16)),
            np.asarray(jax.ops.segment_sum(h[:, 0] * sel, pred, num_segments=16)))


def test_config2_params_are_the_references_draws():
    rng = np.random.default_rng(0)
    params, rng_after = bm.config2_params()
    for w, b in params:
        din, dout = w.shape
        jw = (jnp.asarray(rng.standard_normal((din, dout)), jnp.float32)
              * np.float32(1 / np.sqrt(din)))
        jb = jnp.asarray(rng.standard_normal(dout), jnp.float32) * 0.1
        assert np.array_equal(w, np.asarray(jw)) and np.array_equal(b, np.asarray(jb))
    assert rng_after.standard_normal() == rng.standard_normal()


@pytest.mark.parametrize("use_pallas", [True, False])
def test_config2_mlp(use_pallas):
    res = bm.bench_config2_mlp(rows=ROWS, use_pallas=use_pallas, device="cpu")
    want_c, want_s = _jax_config2(use_pallas)
    got_c, got_s = (t.numpy() for t in res.output)
    if use_pallas:
        # bf16: a ReLU output whose f32 sum differs in its last bit can round
        # to the other bf16 neighbour
        assert np.abs(got_c - want_c).sum() <= max(1, 1e-3 * want_c.sum())
        np.testing.assert_allclose(got_s, want_s, rtol=2e-2, atol=1e-2)
    else:
        # f32 sums in another order can flip a row next to a tie
        assert np.abs(got_c - want_c).sum() <= 2
        np.testing.assert_allclose(got_s, want_s, rtol=1e-4, atol=1e-4)
    assert res.detail.startswith("cuda-query-fused" if use_pallas else "torch")
    assert "SOL: not measured" in res.detail       # the CPU is no card


def test_config3_join():
    res = bm.bench_config3_join(rows=ROWS, device="cpu")
    rng = np.random.default_rng(0)
    rng.permutation(ROWS)
    x = rng.standard_normal((ROWS, 8)).astype(np.float32).astype(np.float64)
    w = rng.standard_normal((8, 4)).astype(np.float32).astype(np.float64)
    payload = rng.standard_normal(ROWS).astype(np.float32).astype(np.float64)
    # the 1:1 join aligns every prediction with its own row
    np.testing.assert_allclose(float(res.output), (x @ w)[:, 0] @ payload, rtol=1e-4)


def test_config4_gbt():
    from infera_tpu.onnx import builder as jbuilder
    from infera_tpu.onnx import compile_model_bytes

    res = bm.bench_config4_gbt(rows=ROWS, device="cpu")
    model = compile_model_bytes(
        jbuilder.gbt_regressor_model(n_features=16, n_trees=64, depth=6).serialize(), "gbt_ref")
    x = np.random.default_rng(0).standard_normal((ROWS, 16)).astype(np.float32)
    want = np.asarray(model.run(x)[0])
    np.testing.assert_allclose(res.output.numpy(), want, rtol=1e-5, atol=1e-5)


def test_config5_and_scaling_wait_for_the_mesh():
    """With the mesh ported (ROADMAP P13a) config 5 and the scaling harness
    run and are in ALL_BENCHMARKS; their logical shards are named as such."""
    res = bm.bench_config5_distributed(rows_per_dev=64, device="cpu")
    assert res.name == "config5_distributed_8dev" and res.rows == 512
    assert "logical" in res.detail and res.rows_per_s > 0
    runs = bm.bench_scaling(rows_per_dev=64, device_counts=(1, 2), device="cpu")
    assert [r.name for r in runs] == ["scaling_dp1", "scaling_dp2"]
    assert list(bm.ALL_BENCHMARKS) == ["config1", "config2", "config3", "config4", "config5",
                                       "scaling"]


def test_main_prints_one_line_a_config(monkeypatch):
    monkeypatch.setenv("INFERA_PLATFORM", "cpu")
    out = io.StringIO()
    with redirect_stdout(out):
        bm.main(["config1"])
    (line,) = out.getvalue().splitlines()
    assert line.startswith("config1_linear_predict: ") and "rows/s (1,000,000 rows" in line
