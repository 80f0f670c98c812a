"""The port's multi-process control plane (``parallel/distributed.py``) and
its mesh across processes, on the CPU.

The tests of ``tests/test_distributed_control.py`` run here against the
port's registry, and the three tests of ``tests/test_multiprocess.py`` run
as two spawned OS processes that join a gloo process group over localhost
(``parallel.distributed.initialize``): the replicated registry and a
cross-process psum; the distributed query step over a global 4-shard mesh
(2 shards a process); and SQL over a global 8-shard mesh (4 a process),
whose rows equal the host executor's on both ranks: a grouped aggregate
with a model, an exact int64 sum and a stddev on ``device_plan_mesh``, a
LEFT join on ``device_join_plan_mesh``, a median, and the shuffle join on
``shuffle_join_mesh``. Each spawned test has its own timeout. Keys, counts
and integers exact; floats 1e-6 relative, 1e-5 where a model is read.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import infera_tpu_torch as itt
from infera_tpu_torch.errors import ModelNotFound
from infera_tpu_torch.parallel.distributed import (
    Heartbeat,
    PartitionFailure,
    ReplicatedModelOps,
    initialize,
    run_partitions_with_retry,
)
from infera_tpu_torch.registry import MODELS as PORT_MODELS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def port_registry():
    itt.set_device("cpu")
    PORT_MODELS.clear()
    yield PORT_MODELS
    PORT_MODELS.clear()
    itt.set_device(None)


def test_replicated_ops_apply_locally(model_dir, port_registry):
    ops = ReplicatedModelOps()
    ops.load("m", f"{model_dir}/linear.onnx")
    assert itt.is_model_loaded("m")
    ops.unload("m")
    assert not itt.is_model_loaded("m")
    assert "linear" in ops.autoload(model_dir)
    assert ops.applied[0][0] == "load"


def test_partition_retry_recovers_from_transient_faults(model_dir, port_registry):
    itt.load_model("linear", f"{model_dir}/linear.onnx")
    x = np.random.default_rng(0).standard_normal((32, 3)).astype(np.float32)
    parts = np.array_split(x, 4)
    killed = set()

    def fault_hook(p, attempt):
        if p == 2 and attempt == 1 and p not in killed:
            killed.add(p)
            raise ConnectionResetError("worker lost mid-shuffle")

    got = np.concatenate(run_partitions_with_retry(
        lambda p: itt.predict("linear", parts[p]).data, 4, fault_hook=fault_hook))
    np.testing.assert_allclose(got, x @ np.array([2.0, -1.0, 0.5], np.float32) + 0.25,
                               rtol=1e-5, atol=1e-5)
    assert killed == {2}


def test_partition_retry_exhausts():
    def always_fail(p):
        raise OSError("host unreachable")

    with pytest.raises(PartitionFailure) as ei:
        run_partitions_with_retry(always_fail, 2, max_attempts=2)
    assert ei.value.partition == 0


def test_engine_errors_not_retried(port_registry):
    attempts = []

    def run_part(p):
        attempts.append(p)
        return itt.predict("missing_model", [[1.0]])

    with pytest.raises(ModelNotFound):
        run_partitions_with_retry(run_part, 2, max_attempts=5)
    assert attempts == [0]


def test_heartbeat_detects_and_recovers():
    import time

    dead = []
    with Heartbeat(deadline_s=0.2, interval_s=0.05, on_dead=dead.append) as hb:
        hb.beat("w0")
        hb.beat("w1")
        for _ in range(8):
            time.sleep(0.05)
            hb.beat("w1")
        assert "w0" in hb.dead_workers() and "w1" not in hb.dead_workers()
        assert dead == ["w0"]
        hb.beat("w0")
        assert "w0" not in hb.dead_workers()


def test_roofline_formatting(monkeypatch):
    """tests/test_distributed_control.py's roofline check, on the H100's
    peaks (the port's table): f32 67 TFLOP/s, 3.35 TB/s."""
    from infera_tpu_torch.testing.benchmarks import roofline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    out = roofline(flops=67e12, bytes_moved=0, seconds=1.0)
    assert "100.0%" in out and "compute-bound" in out
    out = roofline(flops=0, bytes_moved=3.35e12 // 2, seconds=1.0)
    assert "50.0%" in out and "memory-bound" in out


def test_initialize_is_a_no_op_for_one_process():
    assert initialize() is False
    assert initialize(num_processes=1) is False


PRELUDE = """
import os, sys
pid, port = int(sys.argv[1]), sys.argv[2]
model_dir = sys.argv[3] if len(sys.argv) > 3 else None
import numpy as np, torch
import infera_tpu_torch as itt
itt.set_device("cpu")
from infera_tpu_torch.parallel import mesh as M
from infera_tpu_torch.parallel.distributed import ReplicatedModelOps, initialize
assert initialize(f"127.0.0.1:{port}", 2, pid)
"""

GROUP_WORKER = PRELUDE + textwrap.dedent("""
    ops = ReplicatedModelOps()
    ops.load("m", f"{model_dir}/linear.onnx")
    res = itt.predict("m", [[1.0, 2.0, 3.0]])
    assert abs(float(res.data[0]) - 1.75) < 1e-5, res.data
    mesh = M.make_mesh(2)
    assert mesh.local == [pid] and mesh.world == 2
    total = M.psum(mesh, [torch.tensor([float(pid + 1)])])[0]
    assert float(total[0]) == 3.0, total
    gathered = M.all_gather(mesh, [torch.tensor([pid, 10 + pid])])[0]
    assert gathered.tolist() == [0, 10, 1, 11], gathered
    assert mesh.transport == "gloo" and "transport=gloo" in repr(mesh), mesh
    torch.cuda.device_count = lambda: 0   # a machine without a card, wherever this runs
    try:
        bad = M.make_mesh(2, device="cuda")
        raise AssertionError(f"a CUDA mesh without a card: {list(bad.devices.flat)}")
    except RuntimeError as e:
        assert "needs a CUDA card" in str(e), e
    ops.unload("m")
    assert not itt.is_model_loaded("m")
    print(f"proc{pid} OK", flush=True)
""")

PIPELINE_WORKER = PRELUDE + textwrap.dedent("""
    from infera_tpu_torch.parallel.pipeline import make_distributed_query_step
    ndev, rows_per_dev, in_dim, out_dim, n_groups = 4, 16, 8, 4, 8
    n = rows_per_dev * ndev
    mesh = M.make_mesh(ndev)
    assert mesh.local == [2 * pid, 2 * pid + 1]
    rng = np.random.default_rng(0)   # the same draws on every process
    x_all = rng.standard_normal((n, in_dim)).astype(np.float32)
    keys_all = rng.integers(0, n_groups, n)
    params = [(rng.standard_normal((in_dim, 16)).astype(np.float32) * np.float32(0.3),
               np.zeros(16, np.float32)),
              (rng.standard_normal((16, out_dim)).astype(np.float32) * np.float32(0.3),
               np.zeros(out_dim, np.float32))]
    tparams = [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in params]
    a2a = M.all_to_all(mesh, [torch.arange(4) + 100 * s for s in mesh.local])
    assert [t.tolist() for t in a2a] == [[d + 100 * s for s in range(4)] for d in mesh.local]
    step = make_distributed_query_step(mesh, n_groups=n_groups, cap=rows_per_dev)
    sums, counts, total = step(tparams, x_all, keys_all)
    h = x_all
    for i, (w, b) in enumerate(params):
        h = h @ w + b
        if i < len(params) - 1:
            h = np.maximum(h, 0)
    sel = h[:, 0] > 0
    exp_s, exp_c = np.zeros(n_groups), np.zeros(n_groups)
    np.add.at(exp_s, keys_all % n_groups, np.where(sel, h[:, 0], 0.0))
    np.add.at(exp_c, keys_all % n_groups, sel.astype(np.float64))
    assert np.array_equal(counts.numpy(), exp_c), (counts, exp_c)
    assert np.allclose(sums.numpy(), exp_s, rtol=1e-5, atol=1e-5), (sums, exp_s)
    assert float(total) == sel.sum()
    print(f"proc{pid} PIPELINE OK", flush=True)
""")

SQL_WORKER = PRELUDE + textwrap.dedent("""
    from infera_tpu_torch.sql import Connection
    from infera_tpu_torch.sql import device_join_plan as djp, device_plan as dp

    ops = ReplicatedModelOps()
    ops.load("linear", f"{model_dir}/linear.onnx")
    conn = Connection()
    conn.set_mesh(8)
    mesh = conn._mesh
    assert mesh.world == 2 and mesh.local == list(range(4 * pid, 4 * pid + 4))

    def host_rows(q):
        host = Connection(conn.catalog)
        saved = dp.try_execute_on_device, djp.try_execute_join_on_device
        dp.try_execute_on_device = djp.try_execute_join_on_device = lambda *a, **k: None
        try:
            return host.execute(q).rows
        finally:
            dp.try_execute_on_device, djp.try_execute_join_on_device = saved

    def same(rows, want, rel):
        assert len(rows) == len(want), (rows, want)
        for a, b in zip(rows, want):
            for x, y in zip(a, b):
                if isinstance(y, float):
                    assert abs(x - y) <= rel * abs(y) + 1e-9, (a, b)
                else:
                    assert x == y, (a, b)

    n = (1 << 15) + 13
    conn.execute(f"create table big as select x % 7 as g, 2199023255553 + x as v, "
                 f"(x % 100)::float / 10.0 as f1, ((x + 3) % 50)::float / 5.0 as f2, "
                 f"((x * 7) % 30)::float / 3.0 as f3 from range({n}) r(x)")
    q = ("select g, count(*) c, sum(v) s, avg(infera_predict('linear', f1, f2, f3)) p, "
         "stddev(f1) sd from big where f1 > 2.0 group by g order by g")
    rows = conn.execute(q).rows
    assert conn._exec_path == "device_plan_mesh", conn._exec_path
    assert len(rows) == 7
    same(rows, host_rows(q), 1e-5)
    x = np.arange(n, dtype=np.int64)
    f1 = (x % 100).astype(np.float32) / np.float32(10.0)
    for key, c, s, p, sd in rows:
        m = (f1 > 2.0) & (x % 7 == key)
        assert c == int(m.sum()) and s == sum(2199023255553 + int(i) for i in x[m])

    conn.execute("create table dim as select x as k, (x * 2)::float as w from range(60) r(x)")
    conn.execute(f"create table fact as select x % 100 as k, (x % 40)::float / 4.0 as fv "
                 f"from range({n}) r(x)")
    q = "select count(*) c, count(w) cw, avg(w) aw from fact left join dim on fact.k = dim.k"
    rows = conn.execute(q).rows
    assert conn._exec_path == "device_join_plan_mesh", conn._exec_path
    same(rows, host_rows(q), 1e-6)

    q = "select median(fv), quantile_cont(fv, 0.3) from fact"
    rows = conn.execute(q).rows
    assert conn._exec_path == "device_plan_mesh", conn._exec_path
    same(rows, host_rows(q), 0)

    conn.execute(f"create table fb as select (x * 3) % 120 as k, (x % 90)::float / 9.0 as w "
                 f"from range({n}) r(x)")
    rows = conn.execute("select count(*) c, sum(w) sw from fact join fb on fact.k = fb.k").rows
    assert conn._exec_path == "shuffle_join_mesh", conn._exec_path
    ks, kb = x % 100, (x * 3) % 120
    cntb = np.bincount(kb, minlength=128)
    swb = np.bincount(kb, weights=((x % 90).astype(np.float32) / np.float32(9.0)).astype(
        np.float64), minlength=128)
    assert rows[0][0] == int(cntb[ks].sum())
    assert abs(rows[0][1] - swb[ks].sum()) <= 1e-9 * swb[ks].sum()

    ops.unload("linear")
    assert not itt.is_model_loaded("linear")
    print(f"proc{pid} SQL OK", flush=True)
""")


def _spawn(tmp_path, name, source, extra, timeout):
    """Run ``source`` as two processes of one gloo group; (codes, outputs)."""
    worker = tmp_path / f"{name}.py"
    worker.write_text(source)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["INFERA_PLATFORM"] = "cpu"
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen([sys.executable, "-u", str(worker), str(i), str(port), *extra],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for i in range(2)]
    outputs, codes = [], []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outputs.append(out)
        codes.append(p.returncode)
    return codes, outputs


def test_two_process_group(tmp_path, model_dir):
    """The replicated registry, a cross-process psum and all_gather on the
    gloo transport, and the clear refusal of a CUDA mesh on a machine
    without a card (no CPU shards)."""
    codes, outputs = _spawn(tmp_path, "group", GROUP_WORKER, [model_dir], 150)
    assert codes == [0, 0], "\n".join(outputs)
    assert "proc0 OK" in outputs[0] and "proc1 OK" in outputs[1]


def test_two_process_distributed_pipeline(tmp_path):
    """The distributed query step across two processes (4 global shards)."""
    codes, outputs = _spawn(tmp_path, "pipeline", PIPELINE_WORKER, [], 150)
    assert codes == [0, 0], "\n".join(outputs)
    assert all("PIPELINE OK" in o for o in outputs)


def test_two_process_sql_query(tmp_path, model_dir):
    """SQL over a global 8-shard mesh across two processes: the device plan,
    the outer join, the median and the shuffle join, equal to the host on
    both ranks."""
    codes, outputs = _spawn(tmp_path, "sql", SQL_WORKER, [model_dir], 240)
    assert codes == [0, 0], "\n".join(outputs)
    assert all("SQL OK" in o for o in outputs)
