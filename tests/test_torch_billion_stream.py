"""``testing/billion_stream.py`` on the CPU at 2**20 + 12,345 rows: the
generator writes the table in the columnar format through ``np.memmap``,
the port's streaming plan answers the closed form in chunks of 2**16 (counts
and int64 sums exact, float sums within 1e-9), and ``infera_tpu``'s
``read_columnar`` reads the same directory (the formats are one) and gives
the same rows on its streaming plan (float sums within 1e-6, its bound)."""

import json

import numpy as np
import pytest

import infera_tpu_torch as itt
from infera_tpu.sql import Connection as RefConnection
from infera_tpu.sql import streaming_plan as ref_sp
from infera_tpu_torch.columnar.diskfile import read_columnar
from infera_tpu_torch.sql import streaming_plan as sp
from infera_tpu_torch.testing import billion_stream as bs

N = (1 << 20) + 12345


@pytest.fixture()
def table_dir(tmp_path, monkeypatch):
    itt.set_device("cpu")
    for mod in (sp, ref_sp):
        monkeypatch.setattr(mod, "STREAM_MIN_ROWS", 1 << 14)
        monkeypatch.setattr(mod, "CHUNK_ROWS", 1 << 16)
    d = str(tmp_path / "billion")
    nbytes = bs.write_table(d, N, step=1 << 18)
    assert nbytes == N * 16
    yield d
    itt.set_device(None)


def test_generator_writes_the_formulas(table_dir):
    t = read_columnar(table_dir)
    assert t.num_rows == N
    x = np.arange(N)
    assert isinstance(t.columns["v"].data, np.memmap)
    np.testing.assert_array_equal(t.columns["g"].data, (x % 16).astype(np.int32))
    np.testing.assert_array_equal(t.columns["v"].data, 30_000_000_000 + 7 * x)
    np.testing.assert_array_equal(t.columns["f"].data, (x % 1000).astype(np.float32) / 8)
    assert [t.columns[c].sql_type.name for c in ("g", "v", "f")] == ["INTEGER", "BIGINT", "FLOAT"]


def test_main_holds_the_closed_form(table_dir, capsys):
    out = bs.main(table_dir, N)
    assert out["path"] == "streaming_plan" and out["chunk_rows"] == 1 << 16
    assert out["phases"]["chunks"] == -(-N // (1 << 16))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["rows"] == N and line["rows_per_s"] > 0


def test_closed_form_is_the_numpy_answer():
    n = 40_000
    x = np.arange(n)
    for g, c, sv, sf in bs.expected(n):
        m = x % 16 == g
        assert c == int(m.sum())
        assert sv == int((30_000_000_000 + 7 * x[m]).sum())
        assert sf == float(((x[m] % 1000) / 8).sum())


def test_infera_tpu_reads_the_same_directory(table_dir):
    conn = RefConnection()
    rows = conn.execute(bs.QUERY.format(path=table_dir)).rows
    assert conn._exec_path == "streaming_plan"
    bs.check_rows(rows, N, rel=1e-6)
    from infera_tpu_torch.sql import Connection

    port = Connection()
    assert port.execute(bs.QUERY.format(path=table_dir)).rows == [
        (g, c, sv, pytest.approx(sf, rel=1e-6)) for g, c, sv, sf in rows]
