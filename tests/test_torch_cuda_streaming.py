"""The streaming and shuffle tiers on the card against the CPU, at 2**17 to
2**20 rows. These need a CUDA card and skip without one. On the card:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_streaming.py``
(the file imports no JAX). ``ops/streaming.stream_query``'s pinned staging
slots and copy stream against the CPU's chunks; the streaming plan (query
A's MLP, exact int64 aggregates, a key past 2**24, ragged chunks) and
``testing/billion_stream``'s table on the card equal to the CPU and to the
closed form; ``chip_smoke``'s Z1-Z3 at 2**18 rows a side on the card equal
to the CPU and to the numpy per-key oracle."""

import numpy as np
import pytest
import torch

from chip_smoke import (BIG_TABLE, SQL_A, SQL_Z, compare_rows, register_shuffle_tables,
                        shuffle_oracle)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on_each_device(cuda, run):
    """``run()`` with the port on the card, then on the CPU."""
    import infera_tpu_torch as itt

    out = []
    try:
        for device in (cuda, torch.device("cpu")):
            itt.set_device(device)
            out.append(run())
    finally:
        itt.set_device(None)
    return out


@pytest.mark.parametrize("n,chunk", [((1 << 17) + 3, 1 << 14), (1 << 18, 1 << 16)])
def test_stream_query_stages_through_pinned_slots(cuda, n, chunk):
    from infera_tpu_torch.ops.streaming import chunked, stream_query

    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    k = rng.integers(0, 1 << 40, n)
    w = rng.standard_normal((8, 1)).astype(np.float32)

    def run(device):
        wt = torch.from_numpy(w).to(device)

        def step(xc, kc):
            return [(xc @ wt)[:, 0].double().sum(), kc.sum(), kc.max()]

        def combine(acc, p):
            return p if acc is None else [acc[0] + p[0], acc[1] + p[1], torch.maximum(acc[2], p[2])]

        stats = {}
        acc = stream_query(chunked((x, k), chunk), step, combine, None, device=device,
                           stats=stats)
        return [float(acc[0]), int(acc[1]), int(acc[2])], stats

    (card, st), (cpu, _) = run(cuda), run(torch.device("cpu"))
    assert card[1:] == cpu[1:] == [int(k.sum()), int(k.max())]
    assert card[0] == pytest.approx(cpu[0], rel=1e-6, abs=1e-6)
    assert st["chunks"] == -(-n // chunk) and st["upload_ms"] > 0 and st["compute_ms"] > 0


@pytest.mark.parametrize("q", [
    SQL_A,
    "select g, sum(ib), min(ib), max(ib), avg(ib), count(*) from big group by g order by g",
    "select kb, count(*), sum(f1), max(f2) from big where f3 > 2.0 group by kb order by kb",
])
def test_streaming_plan_on_the_card_equals_the_cpu(cuda, monkeypatch, tmp_path, q):
    from infera_tpu_torch.columnar import Column, Table
    from infera_tpu_torch.columnar import types as T
    from infera_tpu_torch.onnx import builder, proto
    from infera_tpu_torch.registry import MODELS
    from infera_tpu_torch.sql import Connection
    from infera_tpu_torch.sql import streaming_plan as sp

    monkeypatch.setattr(sp, "STREAM_MIN_ROWS", 1 << 14)
    monkeypatch.setattr(sp, "CHUNK_ROWS", 50_000)   # ragged: 2**18 + 12,345 rows
    n = (1 << 18) + 12_345
    proto.save_model_file(builder.mlp_model(in_dim=4, hidden=(32,), out_dim=1), tmp_path / "m.onnx")
    tables = Connection()
    tables.execute(BIG_TABLE.format(n=n))
    x = np.arange(n)
    big = tables.catalog.get("big")
    cols = dict(big.columns)
    cols["ib"] = Column((x - n // 2) * 700_000_007 + (1 << 48), T.BIGINT)
    cols["kb"] = Column((1 << 25) + x % 9, T.BIGINT)
    tables.register_table("big", Table(cols))

    def run():
        MODELS.clear()
        from infera_tpu_torch import load_model

        load_model("m", str(tmp_path / "m.onnx"))
        conn = Connection(tables.catalog)
        rows = conn.execute(q).rows
        assert conn._exec_path == "streaming_plan"
        return rows

    try:
        card, cpu = _on_each_device(cuda, run)
    finally:
        MODELS.clear()
    tols = {SQL_A: (None, None, 1e-6, 1e-6)}.get(
        q, tuple(None if isinstance(v, int) else 1e-9 for v in cpu[0]))
    compare_rows("stream", card, cpu, tols)


def test_billion_stream_table_on_the_card(cuda, monkeypatch, tmp_path):
    from infera_tpu_torch.sql import streaming_plan as sp
    from infera_tpu_torch.testing import billion_stream as bs

    monkeypatch.setattr(sp, "STREAM_MIN_ROWS", 1 << 14)
    monkeypatch.setattr(sp, "CHUNK_ROWS", 1 << 16)
    n = (1 << 20) + 12_345
    bs.write_table(str(tmp_path / "b"), n)
    card, cpu = _on_each_device(cuda, lambda: bs.main(str(tmp_path / "b"), n))
    assert card["path"] == cpu["path"] == "streaming_plan"
    assert card["device_peak_bytes"] is not None


@pytest.mark.parametrize("key", list(SQL_Z))
def test_shuffle_join_on_the_card_equals_the_cpu(cuda, monkeypatch, key):
    from infera_tpu_torch.sql import Connection
    from infera_tpu_torch.sql import shuffle_join_plan as sjp

    monkeypatch.setattr(sjp, "A_CHUNK_ROWS", 100_000)   # ragged chunks
    tables = Connection()
    want = shuffle_oracle(*register_shuffle_tables(tables, 1 << 18))[key]

    def run():
        conn = Connection(tables.catalog)
        rows = conn.execute(SQL_Z[key]).rows
        assert conn._exec_path == "shuffle_join"
        return rows

    card, cpu = _on_each_device(cuda, run)
    tol = {"Z1": (None, 1e-9, 1e-9), "Z2": (None, None, 1e-9, 1e-9, 1e-9),
           "Z3": (1e-9, None)}[key]
    compare_rows(key, card, cpu, tol)
    compare_rows(key, card, want, tol)
