"""The process-group mesh of the port (``parallel/distributed.py``,
``parallel/mesh.py``) on the CPU.

The transport choice as a pure function (the CPU takes gloo; CUDA takes
NCCL where each process of the host owns a card, gloo through pinned host
buffers where processes share one; CUDA without a card raises), the card
of each process, the wire pair's round trip on CPU tensors, ``make_mesh``'s
placement under a process group from what ``initialize`` recorded (no card
is touched: the devices are only named), its clear error on a machine
without a card or under a group ``initialize`` did not bring up on CUDA,
and ``streaming_plan_mesh`` across two spawned processes of one gloo group,
whose rows equal, on both ranks, the port's host executor's and
``infera_tpu``'s on the same seeded table (computed in the test's parent,
as ``tests/test_multiprocess.py`` runs it). Keys, counts and integers
exact; floats 1e-5 relative where a model is read, as
``tests/test_torch_streaming_mesh.py`` holds the same query.
"""

import inspect
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import infera_tpu as it
import infera_tpu_torch as itt
from infera_tpu.sql import Connection as RefConnection
from infera_tpu.sql import streaming_plan as ref_sp
from infera_tpu_torch.columnar import Column, Table
from infera_tpu_torch.columnar import types as T
from infera_tpu_torch.parallel import distributed as D
from infera_tpu_torch.parallel import mesh as M
from infera_tpu_torch.registry import MODELS as PORT_MODELS
from infera_tpu_torch.sql import Connection
from infera_tpu_torch.sql import device_join_plan as djp
from infera_tpu_torch.sql import device_plan as dp
from infera_tpu_torch.sql import streaming_plan as sp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("device, local_world, cards, want", [
    ("cpu", 2, 0, "gloo"),
    ("cpu", 4, 8, "gloo"),
    ("cuda", 2, 2, "nccl"),
    ("cuda", 4, 8, "nccl"),
    ("cuda", 1, 1, "nccl"),
    ("cuda", 2, 1, "gloo-pinned"),
    ("cuda", 8, 4, "gloo-pinned"),
    ("cuda", 3, 2, "gloo-pinned"),
])
def test_choose_transport(device, local_world, cards, want):
    assert D.choose_transport(device, local_world, cards) == want
    assert D.PG_BACKEND[want] in ("gloo", "cpu:gloo,cuda:nccl")


@pytest.mark.parametrize("local_world", [1, 2])
def test_choose_transport_on_cuda_without_a_card_raises(local_world):
    """No card: a clear error; nothing switches to gloo on the CPU."""
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        D.choose_transport("cuda", local_world, 0)


@pytest.mark.parametrize("local_world, cards, want", [
    (4, 8, [0, 1, 2, 3]),
    (2, 1, [0, 0]),
    (4, 2, [0, 0, 1, 1]),
])
def test_card_of_each_process(local_world, cards, want):
    assert [D.card_of(r, local_world, cards) for r in range(local_world)] == want


def test_local_world(monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert D.local_world(4) == 4
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert D.local_world(4) == 2


@pytest.mark.parametrize("dtype", [torch.bool, torch.int64, torch.float32, torch.float64])
def test_wire_pair_round_trip(dtype):
    """gloo's wire form of a CPU tensor: contiguous, bool as uint8, and
    back bit for bit (NaN and the extremes of each dtype kept)."""
    if dtype == torch.bool:
        t = torch.tensor([[True, False, True], [False, False, True]])
    elif dtype == torch.int64:
        t = torch.tensor([[-(1 << 63), -1, 0], [1, (1 << 62) + 7, (1 << 63) - 1]])
    else:
        info = torch.finfo(dtype)
        t = torch.tensor([[info.min, -0.0, float("nan")], [info.tiny, 1.5, info.max]],
                         dtype=dtype)
    t = t.t()   # not contiguous
    w = M.to_wire(t, "gloo")
    assert w.is_contiguous() and w.dtype == (torch.uint8 if dtype == torch.bool else dtype)
    back = M.from_wire(w, dtype, t.device)
    assert back.dtype == dtype and back.shape == t.shape
    bits = {torch.float32: torch.int32, torch.float64: torch.int64}.get(dtype)
    if bits is None:
        assert torch.equal(back, t)
    else:
        assert torch.equal(back.contiguous().view(bits), t.contiguous().view(bits))


@pytest.mark.parametrize("transport", ["nccl", "gloo-pinned"])
def test_wire_refuses_a_tensor_off_its_transport(transport):
    with pytest.raises(RuntimeError, match=f"the {transport} transport moves cuda tensors"):
        M.to_wire(torch.zeros(3), transport)


def test_make_mesh_on_cuda_without_a_card_raises(monkeypatch):
    """A clear error, not a division by zero, and never a CPU shard."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for n in (None, 1, 8):
        with pytest.raises(RuntimeError, match="a CUDA mesh needs a CUDA card"):
            M.make_mesh(n, device="cuda")


@pytest.mark.parametrize("world, rank, per_host, cards, transport, want", [
    # two processes, a card each, NCCL: rank 1's shards on cuda:1
    (2, 1, 2, 2, "nccl", (["cuda:0"] * 4 + ["cuda:1"] * 4, 2)),
    # two processes sharing one card on gloo: every shard on cuda:0
    (2, 1, 2, 1, "gloo-pinned", (["cuda:0"] * 8, 1)),
    # two hosts of two processes, one card a host
    (4, 2, 2, 1, "gloo-pinned", (["cuda:0"] * 8, 2)),
    # four processes sharing two cards, neighbouring ranks together
    (4, 3, 4, 2, "gloo-pinned", (["cuda:0"] * 4 + ["cuda:1"] * 4, 2)),
])
def test_make_mesh_under_a_group_places_shards_on_the_process_card(
        monkeypatch, world, rank, per_host, cards, transport, want):
    """The global grid from what ``initialize`` recorded (the processes of
    the host and the transport), each process's shards on its own card."""
    monkeypatch.setattr(M, "_process_group", lambda: (world, rank))
    monkeypatch.setattr(D, "_GROUP", (per_host, transport))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    devices, physical = want
    mesh = M.make_mesh(8, device="cuda")
    assert [str(d) for d in mesh.devices.flat] == devices
    assert mesh.local == list(range(rank * 8 // world, (rank + 1) * 8 // world))
    assert {str(d) for d in mesh.local_devices} == {devices[mesh.local[0]]}
    assert (mesh.transport, mesh.n_physical) == (transport, physical)
    assert f"transport={transport}" in repr(mesh)
    assert M.make_mesh(device="cuda").shape["dp"] == world


@pytest.mark.parametrize("group, message", [
    (None, "needs the process group that"),
    ((2, "gloo"), "moves CPU tensors"),
])
def test_cuda_mesh_under_a_group_initialize_did_not_bring_up_for_cuda_raises(
        monkeypatch, group, message):
    """A CUDA mesh across processes takes its layout and transport from
    ``initialize`` on CUDA; without them it raises, and no shard lands on
    the CPU."""
    monkeypatch.setattr(M, "_process_group", lambda: (2, 0))
    monkeypatch.setattr(D, "_GROUP", group)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match=message):
        M.make_mesh(8, device="cuda")
    assert M.make_mesh(8, device="cpu").transport == "gloo"


def test_mesh_without_a_group_is_local():
    mesh = M.make_mesh(4, device="cpu")
    assert mesh.transport == "local" and not mesh.distributed
    assert repr(mesh) == "Mesh(dp=4, mp=1, devices=1 physical, processes=1, transport=local)"


def stream_table(n: int) -> dict:
    """The seeded table of the two-process streaming test: 11 int64 keys,
    int64 values near 2**41 (group sums past 2**53), f32 eighths."""
    rng = np.random.default_rng(23)
    return {"g": rng.integers(0, 11, n),
            "v": (1 << 41) + rng.integers(0, 1 << 20, n),
            "f1": (rng.integers(0, 800, n) / 8).astype(np.float32),
            "f2": (rng.integers(-400, 400, n) / 8).astype(np.float32),
            "f3": (rng.integers(0, 80, n) / 8).astype(np.float32)}


N_STREAM = 4096 * 8 * 3 + 777   # three global chunks of 4,096 rows a shard and a tail
SQL_STREAM = ("select g, count(*) c, sum(v) s, min(v), max(v), sum(f1), "
              "avg(infera_predict('linear', f1, f2, f3)) p from s where f1 > 20.0 "
              "group by g order by g")


def _register(conn, cols):
    conn.register_table("s", Table({k: Column(v, T.BIGINT if v.dtype == np.int64 else T.FLOAT)
                                    for k, v in cols.items()}))


STREAM_WORKER = textwrap.dedent("""
    import json, sys
    pid, port, model_dir, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    import numpy as np
    import infera_tpu_torch as itt
    itt.set_device("cpu")
    from infera_tpu_torch.columnar import Column, Table
    from infera_tpu_torch.columnar import types as T
    from infera_tpu_torch.parallel.distributed import ReplicatedModelOps, initialize
    from infera_tpu_torch.sql import Connection
    from infera_tpu_torch.sql import streaming_plan as sp
    assert initialize(f"127.0.0.1:{port}", 2, pid)
    sp.STREAM_MIN_ROWS, sp.CHUNK_ROWS = 1 << 14, 4096
    """) + inspect.getsource(stream_table) + inspect.getsource(_register) + textwrap.dedent(f"""
    ReplicatedModelOps().load("linear", f"{{model_dir}}/linear.onnx")
    conn = Connection()
    _register(conn, stream_table({N_STREAM}))
    conn.set_mesh(8)
    mesh = conn._mesh
    assert (mesh.world, mesh.transport) == (2, "gloo"), mesh
    assert mesh.local == list(range(4 * pid, 4 * pid + 4)), mesh.local
    rows = conn.execute({SQL_STREAM!r}).rows
    assert conn._exec_path == "streaming_plan_mesh", conn._exec_path
    with open(f"{{out}}{{pid}}.json", "w") as f:
        json.dump(rows, f)
    print(f"proc{{pid}} STREAM OK", flush=True)
""")


def _spawn(tmp_path, source, extra, timeout):
    """Run ``source`` as two processes of one gloo group; (codes, outputs)."""
    worker = tmp_path / "worker.py"
    worker.write_text(source)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               INFERA_PLATFORM="cpu", OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-u", str(worker), str(i), str(port), *extra],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for i in range(2)]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    return [p.returncode for p in procs], outputs


def _same(rows, want, rel):
    assert len(rows) == len(want), (rows, want)
    for a, b in zip(rows, want):
        for x, y in zip(a, b, strict=True):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=rel, abs=1e-9), (a, b)
            else:
                assert x == y, (a, b)


def test_two_process_streaming_mesh(tmp_path, model_dir, clean_registry, monkeypatch):
    """``streaming_plan_mesh`` over a global 8-shard mesh, 4 shards in each
    of two processes: both ranks give the same rows, equal to the port's
    host executor's, ``infera_tpu``'s streaming mesh's and numpy's counts,
    int64 sums and extremes."""
    codes, outputs = _spawn(tmp_path, STREAM_WORKER, [model_dir, str(tmp_path / "rows")], 180)
    assert codes == [0, 0], "\n".join(outputs)
    got = [json.loads((tmp_path / f"rows{i}.json").read_text()) for i in range(2)]
    assert got[0] == got[1]
    rows = [tuple(r) for r in got[0]]

    cols = stream_table(N_STREAM)
    itt.set_device("cpu")
    PORT_MODELS.clear()
    try:
        itt.load_model("linear", f"{model_dir}/linear.onnx")
        port = Connection()
        _register(port, cols)
        host = Connection(port.catalog)
        with monkeypatch.context() as m:
            m.setattr(sp, "try_execute_streaming", lambda *a, **k: None)
            m.setattr(dp, "try_execute_on_device", lambda *a, **k: None)
            m.setattr(djp, "try_execute_join_on_device", lambda *a, **k: None)
            want = host.execute(SQL_STREAM).rows
        assert host._exec_path == "host"
    finally:
        PORT_MODELS.clear()
        itt.set_device(None)
    _same(rows, want, 1e-5)

    from infera_tpu.columnar import Column as RefColumn
    from infera_tpu.columnar import Table as RefTable
    from infera_tpu.columnar import types as RT

    monkeypatch.setattr(ref_sp, "STREAM_MIN_ROWS", 1 << 14)
    monkeypatch.setattr(ref_sp, "CHUNK_ROWS", 4096)
    it.load_model("linear", f"{model_dir}/linear.onnx")
    ref = RefConnection()
    ref.register_table("s", RefTable({k: RefColumn(v, RT.BIGINT if v.dtype == np.int64
                                                   else RT.FLOAT) for k, v in cols.items()}))
    ref.set_mesh(8)
    ref_rows = ref.execute(SQL_STREAM).rows
    assert ref._exec_path == "streaming_plan_mesh", ref._exec_path
    _same(rows, ref_rows, 1e-5)

    g, v, f1 = cols["g"], cols["v"], cols["f1"]
    assert [r[0] for r in rows] == sorted(set(g[f1 > 20.0].tolist()))
    for key, c, s, mn, mx, *_ in rows:
        sel = v[(f1 > 20.0) & (g == key)]
        assert (c, s, mn, mx) == (len(sel), sum(int(x) for x in sel), int(sel.min()),
                                  int(sel.max()))
