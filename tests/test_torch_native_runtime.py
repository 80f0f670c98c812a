"""The port's native host runtime (``infera_tpu_torch/runtime``) on the CPU.

Mirrors of the 6 tests of ``tests/test_native_runtime.py``; then each of the
library's 8 C functions in the port's build against ``infera_tpu``'s build
on the same bytes; the numpy fallback against the C path; and ``read_csv``
through both packages on numeric, quoted and header-only files (names,
types, values and validity equal, and the C parser taken or declined in
both alike). Everything is compared exactly: this is host code, and both
builds compile the same C++ body.
"""

import ctypes

import numpy as np
import pytest

import infera_tpu_torch as itt
from infera_tpu.runtime import native as ref_native
from infera_tpu.sql import csv_io as ref_csv
from infera_tpu_torch import runtime
from infera_tpu_torch.ops.hashing import _mix64_np
from infera_tpu_torch.registry import MODELS
from infera_tpu_torch.runtime import native
from infera_tpu_torch.sql import csv_io

_P = ctypes.c_void_p


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_P)


@pytest.fixture()
def numpy_only(monkeypatch):
    """The runtime as it is where no C++ toolchain is present."""
    monkeypatch.setattr(native, "get_lib", lambda: None)


# -- mirrors of tests/test_native_runtime.py ---------------------------------

def test_native_builds_and_loads():
    # g++ is present here, so the native path must be live, built under the
    # port's own _build directory
    assert native.native_available()
    assert native._LIB.parent.parent.name == "_build"
    assert native._LIB.exists() and native._LIB.stat().st_mtime >= native._SRC.stat().st_mtime


def test_blob_decode_roundtrip():
    vals = np.array([1.5, -2.25, 3.75], "<f4")
    out = native.blob_decode_f32(vals.tobytes())
    np.testing.assert_array_equal(out, vals)
    assert out.dtype == np.float32
    assert native.blob_decode_f32(b"\x00" * 5) is None


def test_extract_features_types_and_nulls():
    cols = [
        np.array([1.0, 2.0], np.float32),
        np.array([3.0, 4.0], np.float64),
        np.array([5, 6], np.int32),
        np.array([7, 8], np.int64),
        np.array([True, False]),
    ]
    m, first_null = native.extract_features_f32(cols, [None] * 5)
    assert first_null is None
    np.testing.assert_array_equal(m, np.array([[1, 3, 5, 7, 1], [2, 4, 6, 8, 0]], np.float32))
    m2, pos = native.extract_features_f32([np.array([1.0, 2.0]), np.array([3.0, 4.0])],
                                          [None, np.array([True, False])])
    assert m2 is None and pos == (1, 1)


def test_hash_matches_python_mix():
    keys = np.random.default_rng(0).integers(-(2**62), 2**62, 1000)
    np.testing.assert_array_equal(native.hash64_i64(keys),
                                  _mix64_np(keys.astype(np.int64).view(np.uint64)))


def test_radix_partition_stable_and_complete():
    rng = np.random.default_rng(1)
    h = native.hash64_i64(rng.integers(0, 1 << 40, 5000))
    parts = 16
    counts, indices = native.radix_partition(h, parts)
    assert counts.sum() == len(h)
    assert sorted(indices.tolist()) == list(range(len(h)))
    off = 0
    for p in range(parts):
        seg = indices[off:off + counts[p]]
        assert (h[seg] % parts == p).all()
        assert (np.diff(seg) > 0).all()  # stable: ascending original order
        off += counts[p]


def test_engine_blob_path_uses_native(model_dir, monkeypatch):
    itt.set_device("cpu")
    MODELS.clear()
    seen = []
    real = runtime.blob_decode_f32

    def spy(blob):
        seen.append(len(blob))
        return real(blob)

    monkeypatch.setattr(runtime, "blob_decode_f32", spy)
    try:
        itt.load_model("linear", f"{model_dir}/linear.onnx")
        res = itt.predict_from_blob("linear", np.array([1.0, 2.0, 3.0], "<f4").tobytes())
        assert abs(float(res.data[0]) - 1.75) < 1e-5
        assert seen == [12]
    finally:
        MODELS.clear()
        itt.set_device(None)


# -- the port's C functions against infera_tpu's, on the same bytes ----------

@pytest.fixture(scope="module")
def libs():
    port, ref = native.get_lib(), ref_native.get_lib()
    assert port is not None and ref is not None
    for lib in (port, ref):
        lib.infera_blob_batch_validate.restype = ctypes.c_int64
        lib.infera_blob_batch_validate.argtypes = [_P, ctypes.c_int64, _P]
        lib.infera_hash64_combine.restype = None
    return port, ref


def test_abi_version(libs):
    assert [lib.infera_host_abi_version() for lib in libs] == [2, 2]


@pytest.mark.parametrize("n_bytes", [0, 4, 12, 13, 4096 * 4 + 3, 4096 * 4])
def test_c_blob_decode(libs, n_bytes):
    blob = np.random.default_rng(n_bytes).integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
    outs = []
    for lib in libs:
        out = np.zeros(n_bytes // 4, np.float32)
        rc = lib.infera_blob_decode_f32(blob, len(blob), _ptr(out))
        outs.append((rc, out.view(np.uint32).tolist()))
    assert outs[0] == outs[1]
    assert outs[0][0] == (0 if n_bytes % 4 == 0 else -1)


@pytest.mark.parametrize("lens", [[], [4, 8, 12], [4, 6, 8], [3]])
def test_c_blob_batch_validate(libs, lens):
    arr = np.asarray(lens, np.int64)
    outs = []
    for lib in libs:
        bad = np.full(1, -7, np.int64)
        outs.append((lib.infera_blob_batch_validate(_ptr(arr), len(arr), _ptr(bad)), int(bad[0])))
    assert outs[0] == outs[1]


def test_c_extract_features(libs):
    rng = np.random.default_rng(2)
    n = 1000
    cols = [rng.standard_normal(n).astype(np.float32), rng.standard_normal(n),
            rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32),
            rng.integers(-(2**62), 2**62, n).astype(np.int64),
            rng.integers(0, 2, n).astype(np.uint8)]
    codes = np.array([0, 1, 2, 3, 4], np.int32)
    for null_at in (None, (617, 3), (5, 0)):
        valid = [None] * 5
        if null_at is not None:
            v = np.ones(n, np.uint8)
            v[null_at[0]] = 0
            valid[null_at[1]] = v
        outs = []
        for lib in libs:
            col_ptrs = (_P * 5)(*[_ptr(c) for c in cols])
            val_ptrs = (_P * 5)(*[None if v is None else _ptr(v) for v in valid])
            out = np.zeros((n, 5), np.float32)
            rc = lib.infera_extract_features_f32(col_ptrs, _ptr(codes), val_ptrs,
                                                 ctypes.c_int64(n), ctypes.c_int64(5), _ptr(out))
            outs.append((rc, out.view(np.uint32).tobytes()))
        assert outs[0] == outs[1]
        if null_at is not None:
            assert outs[0][0] == null_at[0] * 5 + null_at[1] + 1


def test_c_hash_and_combine(libs):
    rng = np.random.default_rng(3)
    keys = rng.integers(-(2**63), 2**63 - 1, 4096, dtype=np.int64)
    other = rng.integers(0, 2**63 - 1, 4096, dtype=np.int64).view(np.uint64)
    hashes, combined = [], []
    for lib in libs:
        h = np.zeros(len(keys), np.uint64)
        lib.infera_hash64_i64(_ptr(keys), ctypes.c_int64(len(keys)), _ptr(h))
        c = np.zeros(len(keys), np.uint64)
        lib.infera_hash64_combine(_ptr(h), _ptr(other), ctypes.c_int64(len(keys)), _ptr(c))
        hashes.append(h)
        combined.append(c)
    np.testing.assert_array_equal(hashes[0], hashes[1])
    np.testing.assert_array_equal(combined[0], combined[1])


@pytest.mark.parametrize("n,parts", [(0, 4), (1000, 7), (300_000, 64)])
def test_c_radix_partition(libs, n, parts):
    h = native.hash64_i64(np.random.default_rng(n).integers(0, 1 << 50, n))
    outs = []
    for lib in libs:
        counts, idx = np.zeros(parts, np.int64), np.zeros(n, np.int64)
        lib.infera_radix_partition(_ptr(h), ctypes.c_int64(n), ctypes.c_int32(parts),
                                   _ptr(counts), _ptr(idx))
        outs.append((counts.tolist(), idx.tolist()))
    assert outs[0] == outs[1]


def test_c_csv_parse_numeric(libs):
    del libs  # both modules' wrappers around the two builds
    for body in (b"1,2\n3,4\n", b"1.5,\n,-2\n", b"9007199254740993,1\n", b'"a",1\n',
                 b"1,2,3\n", b"0x1A,2\n", b"inf,nan\r\n-0,+5"):
        a = native.csv_parse_numeric(body, 2)
        b = ref_native.csv_parse_numeric(body, 2)
        assert (a is None) == (b is None), body
        if a is not None:
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(a[2], b[2])


# -- the numpy fallback against the C path ------------------------------------

def test_fallback_matches_native(monkeypatch):
    rng = np.random.default_rng(4)
    blob = rng.standard_normal(100).astype("<f4").tobytes()
    cols = [rng.standard_normal(50), rng.integers(0, 9, 50), rng.integers(0, 2, 50).astype(bool)]
    keys = rng.integers(-(2**62), 2**62, 500)
    want = (native.blob_decode_f32(blob), native.extract_features_f32(cols, [None] * 3)[0],
            native.hash64_i64(keys), native.radix_partition(native.hash64_i64(keys), 8))
    nulls = [None, np.arange(50) != 17, None]
    want_null = native.extract_features_f32(cols, nulls)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert not native.native_available()
    got = (native.blob_decode_f32(blob), native.extract_features_f32(cols, [None] * 3)[0],
           native.hash64_i64(keys), native.radix_partition(native.hash64_i64(keys), 8))
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[3][0], want[3][0])
    np.testing.assert_array_equal(got[3][1], want[3][1])
    assert native.extract_features_f32(cols, nulls) == (None, (17, 1)) == want_null
    assert native.csv_parse_numeric(b"1,2\n", 2) is None


# -- read_csv through both packages -------------------------------------------

CSV_CASES = {
    "ints": b"a,b\n1,2\n3,4\n-5,6\n",
    "floats": b"a,b\n1.5,2\n3,4.25\n",
    "nulls": b"a,b\n1,\n,2.5\n3,4\n",
    "past_2_53": b"a,b\n9007199254740993,1\n2,3\n",
    "padded_negatives": b"a,b\n  -1 , -2.5 \n3,4\n",
    "inf": b"a,b\ninf,-inf\n1,2\n",
    "nan": b"a,b\nnan,1\n2,3\n",
    "hex": b"a,b\n0x1A,1\n2,3\n",
    "plus": b"a,b\n+5,1\n2,+3.5\n",
    "crlf": b"a,b\r\n1,2\r\n3,4\r\n",
    "no_final_newline": b"a,b\n1,2\n3,4",
    "duplicate_names": b"a,a,a\n1,2,3\n4,5,6\n",
    "blank_lines": b"a,b\n1,2\n\n3,4\n",
    "exponent": b"a,b\n1e2,2\n3,4\n",
    "dot_forms": b"a,b\n1.,.5\n2,3\n",
    "quoted": b'a,b\n"x,y",1\n"z",2\n',
    "quoted_numbers": b'a,b\n"1",2\n3,4\n',
    "header_only": b"a,b\n",
    "strings": b"a,b\nfoo,1\nbar,2\n",
    "ragged": b"a,b\n1,2,3\n4,5\n",
}


def _as_rows(table):
    out = []
    for name in table.names:
        col = table.columns[name]
        valid = col.valid_mask()
        out.append((name, col.sql_type.name, valid.tolist(),
                    [v for v, ok in zip(col.data.tolist(), valid) if ok]))
    return out


@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_read_csv_matches_reference(case, tmp_path):
    path = tmp_path / f"{case}.csv"
    path.write_bytes(CSV_CASES[case])
    port, ref = csv_io.read_csv(str(path)), ref_csv.read_csv(str(path))
    a, b = _as_rows(port), _as_rows(ref)
    assert [r[:3] for r in a] == [r[:3] for r in b]
    for (_, ty, _, va), (_, _, _, vb) in zip(a, b):
        if ty == "DOUBLE":
            np.testing.assert_array_equal(np.asarray(va, np.float64), np.asarray(vb, np.float64))
        else:
            assert va == vb
    raw = CSV_CASES[case]
    took = csv_io._read_csv_native(raw, True, ",") is not None
    assert took == (ref_csv._read_csv_native(raw, True, ",") is not None)


def test_read_csv_takes_the_c_parser_on_numeric_bodies():
    for case in ("ints", "floats", "nulls", "crlf", "exponent", "duplicate_names"):
        assert csv_io._read_csv_native(CSV_CASES[case], True, ",") is not None, case
    for case in ("past_2_53", "quoted", "header_only", "strings"):
        assert csv_io._read_csv_native(CSV_CASES[case], True, ",") is None, case


def test_read_csv_without_header_and_without_the_library(tmp_path, numpy_only):
    path = tmp_path / "h.csv"
    path.write_bytes(b"1,2\n3,4\n")
    assert csv_io._read_csv_native(path.read_bytes(), False, ",") is None
    t = csv_io.read_csv(str(path), header=False)
    r = ref_csv.read_csv(str(path), header=False)
    assert _as_rows(t) == _as_rows(r)
