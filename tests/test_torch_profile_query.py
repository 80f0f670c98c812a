"""K8a and K8b (``infera_tpu_torch/testing/profile_query.py``) against
``infera_tpu``'s ``exp_empty`` and ``exp_variants`` kernels in interpret mode,
and the port's experiments, on the CPU.

The JAX experiments run as they are, with three things patched inside each
test: ``pallas_call`` runs in interpret mode, ``jax.jit`` records every
result, and ``_time_queued`` makes one call and skips the 4096² timer check.
The same table goes to the port's plain versions as numpy (the CUDA kernels
are held against those plain versions on the card)."""

import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from infera_tpu.testing import profile_query as jpq
from infera_tpu_torch.ops import fused_query as fq
from infera_tpu_torch.testing import profile_query as pq

ROWS, TILE = 8192, 1024


def _run_jax(exp, shape):
    """Run ``jpq.<exp>`` at ROWS x TILE; returns its kernel's last output of
    each call whose result has ``shape``, as numpy."""
    results = []
    real_call, real_jit = pl.pallas_call, jax.jit

    def jit(fn, *a, **k):
        f = real_jit(fn, *a, **k)

        def g(*args):
            out = f(*args)
            results.append(out)
            return out
        return g

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", lambda *a, **k: real_call(*a, **{**k, "interpret": True}))
        mp.setattr(jax, "jit", jit)
        mp.setattr(jpq, "_time_queued",
                   lambda jnp_, fn, x, iters: (fn(x) if x.shape == (ROWS, 32) else None, 1e-3)[1])
        with redirect_stdout(io.StringIO()):
            getattr(jpq, exp)(rows=ROWS, tile_n=TILE)
    return [np.asarray(r).reshape(-1) for r in results if getattr(r, "shape", None) == shape]


def _table():
    """exp_empty's and exp_variants' table, as numpy f32 (bf16 values)."""
    x = jax.random.normal(jax.random.PRNGKey(1), (ROWS, 32), jnp.float32).astype(jnp.bfloat16)
    return np.array(x.astype(jnp.float32))


@pytest.fixture(scope="module")
def jax_variants():
    outs = _run_jax("exp_variants", (1, 128))
    assert len(outs) == len(pq.VARIANTS)
    return dict(zip(pq.VARIANTS, outs))


def test_params_are_bit_equal_to_the_reference():
    for seed in (0, 3):
        for (w, b), (jw, jb) in zip(pq._params(seed), jpq._params(seed), strict=True):
            assert w.dtype == jw.dtype and np.array_equal(w, jw)
            assert b.dtype == jb.dtype and np.array_equal(b, jb)


def test_k8a_matches_exp_empty():
    want = _run_jax("exp_empty", (1, 32))[-1]
    x = _table()
    before = pq.empty_grid_scan.launches
    got = pq.empty_grid_scan(torch.from_numpy(x).to(torch.bfloat16)).numpy()
    assert pq.empty_grid_scan.launches == before        # the CPU runs the plain version
    # f32 sums in another order: within 1e-5 of the column's sum of |x|
    np.testing.assert_array_less(np.abs(got - want), 1e-5 * np.abs(x).sum(0))


@pytest.mark.parametrize("variant", pq.VARIANTS)
def test_k8b_matches_exp_variants(jax_variants, variant):
    want = jax_variants[variant]
    x = torch.from_numpy(_table()).to(torch.bfloat16)
    weights = pq.stage_weights(pq._params(), "cpu")
    got = pq.query_stage(weights, x, variant).numpy()
    if variant == "scan":
        np.testing.assert_array_less(np.abs(got[:32] - want[:32]),
                                     1e-5 * x.float().abs().sum(0).numpy())
        assert not got[32:].any() and not want[32:].any()
    elif variant in ("mm1", "mm_all"):
        # f32 sums of the same bf16 products in another order
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())
    else:
        # a ReLU output whose f32 sum differs in its last bit can round to
        # the other bf16 neighbour: at most 0.1 % of the kept rows move
        kept = want[:16].sum()
        assert np.abs(got[:16] - want[:16]).sum() <= max(1, 1e-3 * kept)
        np.testing.assert_allclose(got[16:32], want[16:32], rtol=2e-2, atol=1e-2)
        assert not got[32:].any()


@pytest.mark.parametrize("n", [1, 64, 1000, 4097])
def test_plain_stages_match_numpy(n):
    """The plain stages at ragged row counts against numpy: column sums, the
    first layer without ReLU, the logits, and both tails (every tied class
    counts in tail_nomax; the first index in full)."""
    params = pq._params(5)
    x = np.random.default_rng(n).standard_normal((n, 32)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    xf = xb.float().numpy().astype(np.float64)
    bf = [(torch.from_numpy(w).to(torch.bfloat16).double().numpy(), b.astype(np.float64))
          for w, b in params]
    h1 = xf @ bf[0][0] + bf[0][1]
    h = xf
    for i, (w, b) in enumerate(bf):
        h = h @ w + b
        if i < 2:
            h = torch.from_numpy(np.maximum(h, 0).astype(np.float32)).to(torch.bfloat16) \
                .double().numpy()
    weights = pq.stage_weights(params, "cpu")
    out = {v: pq.query_stage(weights, xb, v).double().numpy() for v in pq.VARIANTS}
    np.testing.assert_allclose(out["scan"][:32], xf.sum(0), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(out["mm1"], h1.sum(0), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(out["mm_all"][:16], h.sum(0), rtol=1e-4, atol=1e-3)
    kept = h[:, 0] > 0
    hit = (h == h.max(1, keepdims=True)) & kept[:, None]
    np.testing.assert_array_equal(out["tail_nomax"][:16], hit.sum(0))
    pred = h.argmax(1)
    counts = np.bincount(pred[kept], minlength=16)
    np.testing.assert_array_equal(out["full"][:16], counts)
    sums = np.bincount(pred[kept], weights=h[kept, 0], minlength=16)
    np.testing.assert_allclose(out["full"][16:32], sums, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(out["scan"][:32], pq.empty_grid_scan(xb).double().numpy())


def test_tail_nomax_counts_every_tied_class():
    """A row whose maximum two classes share counts for both in tail_nomax
    and for the first of them in full."""
    params = pq._params()
    w3, b3 = params[2]
    tied = [(w, b) for w, b in params[:2]] + [(np.concatenate([w3[:, :1], w3[:, :1],
                                                               w3[:, 2:]], 1), b3.copy())]
    tied[2][1][1] = tied[2][1][0]
    wt = pq.stage_weights(tied, "cpu")
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((512, 32)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    nomax = pq.query_stage(wt, xb, "tail_nomax")
    full = pq.query_stage(wt, xb, "full")
    assert torch.equal(nomax[0], nomax[1]) and nomax[1] > 0
    assert full[1] == 0 and full[0] == nomax[0]


def test_full_stage_is_k7a_bf16():
    weights = pq.stage_weights(pq._params(), "cpu")
    x = torch.from_numpy(_table()[:3001]).to(torch.bfloat16)
    full = pq.query_stage(weights, x, "full")
    counts, sums = fq.fused_mlp_query(weights.full, x)
    assert torch.equal(full[:16].long(), counts) and torch.equal(full[16:32], sums)


def test_query_stage_refuses_an_unknown_stage():
    with pytest.raises(ValueError, match="variant must be one of"):
        pq.query_stage(pq.stage_weights(pq._params(), "cpu"), torch.zeros(4, 32), "argmax")


# the keys of each experiment's lines in infera_tpu (a measurement, or an error)
JAX_KEYS = {
    "iters": [{"exp", "iters", "rows", "ms_per_iter", "rows_per_s"}],
    "rows": [{"exp", "rows", "ms", "rows_per_s"}],
    "empty": [{"exp", "rows", "tile_n", "iters", "ms_per_iter", "us_per_grid_step"}],
    "tiles": [{"exp", "tile_n", "rows", "error"}],
    "chain": [{"exp", "rows", "k", "ms_per_iter", "rows_per_s"}],
    "variants": [{"exp", "variant", "ms_per_iter", "expected_ms_floor"},
                 {"exp", "variant", "rows", "ms_per_iter", "rows_per_s"}],
    "col": [{"exp", "variant", "ms_per_iter", "rows_per_s"}, {"exp", "variant", "error"}],
}
SMALL = {"iters": {"rows": 512}, "rows": {"row_counts": (256, 1000)}, "empty": {"rows": 1000},
         "tiles": {"rows": 1000}, "chain": {"rows": 512, "k": 3}, "variants": {"rows": 1000},
         "col": {"rows": 1000}}


@pytest.mark.parametrize("name", list(pq.EXPS))
def test_experiments_emit_the_reference_keys(name, monkeypatch):
    monkeypatch.setattr(pq, "CALIB_N", 64)
    out = io.StringIO()
    with redirect_stdout(out):
        lines = pq.EXPS[name](device="cpu", **SMALL[name])
    printed = [json.loads(line) for line in out.getvalue().splitlines()]
    assert printed == lines and lines
    for line in lines:
        assert line["exp"] == name
        assert any(keys <= set(line) for keys in JAX_KEYS[name]), line
    if name == "variants":
        assert [line["variant"] for line in lines] == ["calib_matmul64", *pq.VARIANTS]
        assert lines[0]["expected_ms_floor"] is None      # no card, no peak
    if name == "empty":
        assert lines[0]["tile_n"] == 64


def test_main_ends_with_a_done_line(monkeypatch):
    monkeypatch.setenv("INFERA_PLATFORM", "cpu")
    out = io.StringIO()
    with redirect_stdout(out):
        pq.main(["tiles"])
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    assert len(lines) == 5 and all("error" in line for line in lines[:4])
    assert lines[-1]["exp"] == "tiles" and lines[-1]["done"] is True


def test_trace_summary_of_a_cpu_trace(tmp_path):
    from infera_tpu_torch import observability as obs

    with obs.trace(str(tmp_path)) as prof:
        with obs.annotate("span"):
            torch.ones(64).sum()
    (path,) = tmp_path.glob("*.pt.trace.json")
    summary = pq.trace_device_summary(path)
    assert summary["spans"] == {"span": 1}
    assert summary["device_events"] == 0 and summary["idle_share"] is None
    assert summary["window_us"] > 0
    assert pq.top_device_ops(prof) == []


def test_trace_summary_unions_device_intervals(tmp_path):
    events = [{"ph": "X", "cat": "cpu_op", "name": "a", "ts": 0, "dur": 100},
              {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 20},
              {"ph": "X", "cat": "kernel", "name": "k", "ts": 20, "dur": 20},
              {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 60, "dur": 10},
              {"ph": "i", "cat": "kernel", "name": "instant", "ts": 90}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    summary = pq.trace_device_summary(path)
    assert summary["device_busy_us"] == 40.0 and summary["device_events"] == 3
    assert summary["idle_share"] == pytest.approx(0.6)


def test_top_device_ops_ranks_self_device_time_without_spans():
    from types import SimpleNamespace as Event

    events = [Event(key="query A", count=5, self_device_time_total=5000.0, is_user_annotation=True),
              Event(key="kernel", count=5, self_device_time_total=4000.0, is_user_annotation=False),
              Event(key="copy", count=30, self_device_time_total=50.0, is_user_annotation=False),
              Event(key="host op", count=9, self_device_time_total=0.0, is_user_annotation=False)]
    prof = Event(key_averages=lambda: events)
    assert pq.top_device_ops(prof) == [("kernel", 5, 4.0), ("copy", 30, 0.05)]
    assert pq.top_device_ops(prof, k=1) == [("kernel", 5, 4.0)]
