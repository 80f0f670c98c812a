"""The meshed tiers on the card against the same port on the CPU. These need
a CUDA card and skip without one. On the card:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_mesh.py``
(the file imports no JAX). At 1, 3 and 8 logical shards on ``cuda:0``: the
meshed device plan (model, exact int64, DISTINCT, MODE, HLL, medians), the
meshed join program, streaming and the shuffle join give the CPU mesh's
rows (keys, counts, integers, HLL and order statistics exact; f64 sums to
1e-9, 1e-5 where a model is read); ``make_mesh`` on CUDA puts every shard
on a card; a CUDA mesh across processes raises (ROADMAP P13c)."""

import os
import socket
import subprocess
import sys

import pytest
import torch

from chip_smoke import BIG_TABLE, SQL_A, compare_rows

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = (1 << 15) + 13
TABLES = [BIG_TABLE.format(n=N),
          f"create table t as select x % 11 as g, x % 3 as h, x as id, {(1 << 45) + 1} + x * 3 "
          f"as v, (x * 7) % 37 as d, ((x * 13) % 101)::float / 8.0 as f from range({N}) r(x)",
          "create table dim as select x as k, (x * 2)::float as w from range(60) r(x)",
          f"create table fact as select x % 100 as k, x % 5 as og, (x % 40)::float / 4.0 as fv "
          f"from range({N}) r(x)"]
QUERIES = {
    "A": (SQL_A, "device_plan_mesh", (None, None, 1e-5, 1e-9)),
    "exact": ("select g, h, count(*), sum(v), min(v), max(v), count(distinct d), mode(d), "
              "approx_count_distinct(d), median(f), quantile_cont(f, 0.8) from t "
              "group by g, h order by g, h", "device_plan_mesh", (None,) * 11),
    "join": ("select og, count(*), count(w), sum(w), min(w), max(fv) from fact left join dim "
             "on fact.k = dim.k group by og order by og", "device_join_plan_mesh",
             (None, None, None, 1e-9, None, None)),
}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _run(device, shards, queries, setup=TABLES):
    import infera_tpu_torch as itt
    from infera_tpu_torch.onnx import builder, proto
    from infera_tpu_torch.sql import Connection

    itt.set_device(device)
    try:
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            proto.save_model_file(builder.mlp_model(in_dim=4, hidden=(32,), out_dim=1),
                                  f"{d}/m.onnx")
            itt.load_model("m", f"{d}/m.onnx")
        conn = Connection()
        conn.set_mesh(shards)
        for sql in setup:
            conn.execute(sql)
        out = {}
        for key, (q, path, _tol) in queries.items():
            rows = conn.execute(q).rows
            assert conn._exec_path == path, (key, conn._exec_path)
            out[key] = rows
        return out, conn._mesh
    finally:
        itt.unload_model("m")
        itt.set_device(None)


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_meshed_plans_on_the_card_equal_the_cpu(cuda, shards):
    card, mesh = _run(cuda, shards, QUERIES)
    cpu, _ = _run(torch.device("cpu"), shards, QUERIES)
    assert all(d.type == "cuda" for d in mesh.devices.flat)
    for key, (_q, _path, tol) in QUERIES.items():
        compare_rows(key, card[key], cpu[key], tol)


SQL_ZG = ("select g, count(*) c, min(w), max(v), sum(w) from fa join fb on fa.k = fb.k "
          "group by g order by g")


@pytest.mark.parametrize("shards", [3, 8])
def test_meshed_streaming_and_shuffle_join_on_the_card(cuda, shards, monkeypatch):
    """S: query A's MLP streamed over 65,613 rows in chunks of 4,096 a
    shard; Z: the shuffle join of two 65,536-row sides with a hot key, in
    A chunks of 8,192 a shard: the card equals the CPU, and Z's pair counts
    equal the numpy per-key oracle."""
    from chip_smoke import register_shuffle_tables, shuffle_oracle
    from infera_tpu_torch.sql import Connection
    from infera_tpu_torch.sql import shuffle_join_plan as sjp
    from infera_tpu_torch.sql import streaming_plan as sp

    monkeypatch.setattr(sp, "STREAM_MIN_ROWS", 1 << 14)
    monkeypatch.setattr(sp, "CHUNK_ROWS", 1 << 12)
    monkeypatch.setattr(sjp, "A_CHUNK_ROWS", 1 << 13)
    stream = {"S": (SQL_A, "streaming_plan_mesh", (None, None, 1e-5, 1e-9))}
    results = []
    for device in (cuda, torch.device("cpu")):
        import infera_tpu_torch as itt

        out, _ = _run(device, shards, stream, setup=[BIG_TABLE.format(n=(1 << 16) + 77)])
        itt.set_device(device)
        try:
            conn = Connection()
            conn.set_mesh(shards)
            tables = register_shuffle_tables(conn, 1 << 16)
            out["Z"] = conn.execute(SQL_ZG).rows
            assert conn._exec_path == "shuffle_join_mesh"
        finally:
            itt.set_device(None)
        results.append(out)
    compare_rows("S", results[0]["S"], results[1]["S"], stream["S"][2])
    compare_rows("Z", results[0]["Z"], results[1]["Z"], (None, None, None, None, 1e-9))
    want = shuffle_oracle(*tables)["Z2"]
    assert [(r[0], r[1]) for r in results[0]["Z"]] == [(w[0], w[1]) for w in want]


def test_make_mesh_on_cuda_never_places_a_shard_on_the_cpu(cuda):
    from infera_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(8, device="cuda")
    count = torch.cuda.device_count()
    assert [str(d) for d in mesh.devices.flat] == [f"cuda:{i % count}" for i in range(8)]
    assert mesh.n_physical == count


_GROUP = """
import sys
import infera_tpu_torch as itt
from infera_tpu_torch.parallel import mesh as M
from infera_tpu_torch.parallel.distributed import initialize
assert initialize(f"127.0.0.1:{sys.argv[2]}", 2, int(sys.argv[1]))
itt.set_device("cuda")
try:
    M.make_mesh(2)
except NotImplementedError as e:
    assert "P13c" in str(e)
    print("REFUSED", flush=True)
"""


def test_a_cuda_mesh_across_processes_raises(cuda, tmp_path):
    script = tmp_path / "group.py"
    script.write_text(_GROUP)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, str(script), str(i), str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert all("REFUSED" in o for o in outs)
