"""The torch program (``device_plan``) on the card against the same program
on the CPU, for ``chip_smoke.py``'s device-plan queries M–S at 32,768 rows.
These need a CUDA card and skip without one. On the card:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_device_plan.py``
(the file imports no JAX). Each query runs through ``Connection.execute``
on each device over the same catalog and models (Q with
``INFERA_PALLAS_SQL=0``, its plan the one K2 runs by default; S's ORDER BY
through the host executor, its sort on the device), on the path the phase
checks, with rows equal at ``chip_smoke.DP_TOL``'s tolerances (S exact);
and ``testing/plan_fuzz``'s random queries through K2 and the program on
the card against the host."""

import numpy as np
import pytest
import torch

from chip_smoke import (BIG_TABLE, DP_QUERIES, DP_S, DP_SORT, DP_T, DP_TOL, compare_rows,
                        device_plan_expected_sorts)

pytestmark = pytest.mark.cuda
N = 1 << 15


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("key", [*DP_QUERIES, *DP_S])
def test_program_on_the_card_equals_the_cpu(cuda, monkeypatch, tmp_path, key):
    import infera_tpu_torch as itt
    from infera_tpu_torch.onnx import builder, proto
    from infera_tpu_torch.registry import MODELS
    from infera_tpu_torch.sql import Connection

    proto.save_model_file(builder.mlp_model(in_dim=4, hidden=(32,), out_dim=1), tmp_path / "m.onnx")
    tables = Connection()
    for sql in (BIG_TABLE, DP_T, *DP_SORT):
        tables.execute(sql.format(n=N))
    if key == "Q":
        monkeypatch.setenv("INFERA_PALLAS_SQL", "0")
    else:
        monkeypatch.delenv("INFERA_PALLAS_SQL", raising=False)
    q = {**DP_QUERIES, **DP_S}[key]
    rows = []   # the card's, then the CPU's
    try:
        for device in (cuda, torch.device("cpu")):
            itt.set_device(device)
            MODELS.clear()
            itt.load_model("m", str(tmp_path / "m.onnx"))
            itt.load_model("m8", str(tmp_path / "m.onnx"), "int8")
            conn = Connection(tables.catalog)
            rows.append(conn.execute(q).rows)
            assert conn._exec_path == ("host" if key in DP_S else "device_plan")
    finally:
        MODELS.clear()
        itt.set_device(None)
    card, cpu = rows
    if key in DP_S:
        assert card == cpu == device_plan_expected_sorts(N)[key]
    else:
        assert len(card) > 0
        compare_rows(key, card, cpu, DP_TOL[key])


def test_hll_bits_on_the_card_equal_the_host(cuda):
    """splitmix64 over the host's bits on the card (wrapping int64
    multiplies, masked shifts), bit for bit."""
    from infera_tpu_torch.ops import hashing as H

    rng = np.random.default_rng(12)
    for a, dt in ((rng.integers(-2**31, 2**31 - 1, 100_000).astype(np.int64), "int64"),
                  (rng.standard_normal(100_000).astype(np.float32), "float32")):
        a[:3] = [0, 1, -1] if dt == "int64" else [0.0, -0.0, np.nan]
        got = H.splitmix64_device(H.value_bits64_device(torch.as_tensor(a, device=cuda), dt))
        np.testing.assert_array_equal(got.cpu().numpy().view(np.uint64), H.hash_array_host(a))


def test_random_plans_on_the_card_equal_the_host(cuda, monkeypatch):
    """testing/plan_fuzz's random aggregate queries through K2 and the
    program on the card: the host's rows (four seeds of 150 queries)."""
    import infera_tpu_torch as itt
    from infera_tpu_torch.testing import plan_fuzz

    monkeypatch.delenv("INFERA_PALLAS_SQL", raising=False)
    itt.set_device(cuda)
    try:
        results = [plan_fuzz.run_seed(seed, 20000, 150) for seed in range(4)]
    finally:
        itt.set_device(None)
    assert not [m for r in results for m in r["mismatches"]]
    assert all(r["paths"].get("device_plan_cuda", 0) and r["paths"].get("device_plan", 0)
               for r in results)
