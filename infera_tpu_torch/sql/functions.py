"""Scalar SQL functions, including the 13 ``infera_*`` functions.

This is the parity surface of the reference's C++ binding
(upstream infera/bindings/infera_extension.cpp:546-592 registration;
SURVEY.md §2.2 behavioral table). Differences from the reference are
TPU-native by design:

- Feature extraction is a vectorized column stack + cast, not the per-cell
  ``Value::GetValue`` loop (infera_extension.cpp:199-227); the NULL policy is
  a mask reduction producing the same "Feature values cannot be NULL" error.
- The whole batch goes to the engine as ONE [rows, cols] tensor per call —
  like the reference's per-DataChunk call (cpp:264-270), but without the
  2048-row chunk ceiling.

Every infera_* function is volatile: results are never cached or
constant-folded (the regression suite in
test/sql/test_volatile_and_null_safety.test exists to pin this; our executor
re-evaluates every call site on every execution).
"""

from __future__ import annotations

import numpy as np

from .. import api
from ..columnar import Column
from ..columnar import types as T
from ..errors import InferaError, inference_failed, invalid_input

# registry: name → (fn, volatile)
SCALAR_FUNCTIONS: dict = {}
# names the executor routes through the GROUP BY operator
# (implementations live in infera_tpu.ops.aggregate)
AGGREGATE_FUNCTIONS = frozenset(
    {"count", "sum", "avg", "mean", "min", "max", "first", "any_value",
     "last", "stddev", "stddev_samp", "stddev_pop", "var_samp", "variance",
     "var_pop", "median", "mode", "bool_and", "bool_or",
     "approx_count_distinct", "product", "count_if", "countif",
     "quantile_cont", "quantile_disc", "quantile", "percentile_cont",
     "percentile_disc", "arg_min", "arg_max", "min_by", "max_by",
     "string_agg", "listagg"}
)


def scalar(name: str, volatile: bool = False):
    def deco(fn):
        SCALAR_FUNCTIONS[name] = (fn, volatile)
        return fn

    return deco


# ---------------------------------------------------------------------------
# generic helpers
# ---------------------------------------------------------------------------

_NUMERIC_FEATURES = ("FLOAT", "DOUBLE", "INTEGER", "BIGINT", "DECIMAL",
                     "TINYINT", "SMALLINT", "BOOLEAN")


def _require_args(name: str, args: list, n: int):
    if len(args) != n:
        raise invalid_input(f"{name} expects exactly {n} argument{'s' if n != 1 else ''}")


def _constant_name(args: list, fname: str) -> str | None:
    """Model name from row 0 (infera_extension.cpp:239-248
    ValidateAndGetModelName — per-row names within a chunk are ignored).
    Returns None when NULL (caller propagates a NULL result)."""
    col = args[0]
    if len(col) == 0:
        return None
    if col.is_null(0):
        return None
    v = col.value(0)
    if not isinstance(v, str):
        raise invalid_input("Model name must be VARCHAR")
    return v


def _extract_features(args: list, n_rows: int) -> np.ndarray:
    """Stack feature columns into an f32 [rows, cols] matrix.

    Vectorized ExtractFeatures (infera_extension.cpp:199-227) through the
    native host runtime (``runtime.extract_features_f32``, with its numpy
    fallback), as ``infera_tpu``'s: NULL anywhere gives the exact reference
    error; non-numeric types are rejected."""
    from ..runtime import extract_features_f32

    cols = []
    validities = []
    for col in args[1:]:
        if not col.sql_type.is_numeric and col.sql_type.name != "NULL":
            raise invalid_input(
                f"infera_predict: unsupported feature type {col.sql_type}"
            )
        if col.sql_type.name == "NULL":
            raise invalid_input("Feature values cannot be NULL")
        cols.append(col.data)
        validities.append(col.validity)
    if not cols:
        return np.zeros((n_rows, 0), dtype=np.float32)
    matrix, first_null = extract_features_f32(cols, validities)
    if first_null is not None:
        raise invalid_input("Feature values cannot be NULL")
    return matrix


def _run_predict(fname: str, args: list, n_rows: int):
    """Common batched path for predict / predict_multi / predict_multi_list."""
    name = _constant_name(args, fname)
    if name is None:
        return None
    features = _extract_features(args, n_rows)
    try:
        res = api.predict(name, features, n_rows, features.shape[1])
    except InferaError as e:
        raise inference_failed(name, e)
    return name, res


# ---------------------------------------------------------------------------
# the 13 infera_* functions
# ---------------------------------------------------------------------------

@scalar("infera_load_model", volatile=True)
def _f_load_model(ctx, args, n_rows):
    # 2-arg form is reference parity; optional 3rd arg selects the matmul
    # precision policy ('f32' | 'bf16' | 'int8') — an extension
    if len(args) != 3:
        _require_args("infera_load_model(model_name, path)", args, 2)
    if args[0].is_null(0) or args[1].is_null(0):
        return Column.constant(None, T.BOOLEAN, n_rows)
    name = args[0].value(0)
    path = args[1].value(0)
    precision = "f32"
    if len(args) == 3 and not args[2].is_null(0):
        precision = str(args[2].value(0))
    if name == "":
        raise invalid_input("Model name cannot be empty")
    try:
        api.load_model(str(name), str(path), precision)
    except InferaError as e:
        raise invalid_input(f"Failed to load model '{name}': {e}")
    return Column.constant(True, T.BOOLEAN, n_rows)


@scalar("infera_unload_model", volatile=True)
def _f_unload_model(ctx, args, n_rows):
    _require_args("infera_unload_model(model_name)", args, 1)
    if args[0].is_null(0):
        return Column.constant(None, T.BOOLEAN, n_rows)
    # Idempotent: TRUE whether or not the model existed
    # (infera_extension.cpp:180-187; pinned by test_edge_cases_more.test).
    api.unload_model(str(args[0].value(0)))
    return Column.constant(True, T.BOOLEAN, n_rows)


@scalar("infera_predict", volatile=True)
def _f_predict(ctx, args, n_rows):
    if len(args) < 2:
        raise invalid_input("infera_predict requires a model name and at least 1 feature")
    out = _run_predict("infera_predict", args, n_rows)
    if out is None:
        return Column.constant(None, T.FLOAT, n_rows)
    name, res = out
    if res.rows != n_rows or res.cols != 1:
        # exact message: infera_extension.cpp:275-279
        raise invalid_input(
            f"Model output shape mismatch. Expected ({n_rows}, 1), "
            f"but got ({res.rows}, {res.cols})."
        )
    return Column(res.data.astype(np.float32), T.FLOAT)


@scalar("infera_predict_multi", volatile=True)
def _f_predict_multi(ctx, args, n_rows):
    out = _run_predict("infera_predict_multi", args, n_rows)
    if out is None:
        return Column.constant(None, T.VARCHAR, n_rows)
    name, res = out
    if res.rows != n_rows:
        raise invalid_input(
            f"Model output row count mismatch. Expected {n_rows}, but got {res.rows}."
        )
    # JSON-ish string per row with C++ ostream float formatting ("%g"):
    # [1,2,3,4] (infera_extension.cpp:405-416; pinned by test_multi_output.test)
    data = np.empty(n_rows, dtype=object)
    flat = res.data
    for i in range(n_rows):
        vals = flat[i * res.cols : (i + 1) * res.cols]
        data[i] = "[" + ",".join(f"{v:g}" for v in vals) + "]"
    return Column(data, T.VARCHAR)


@scalar("infera_predict_multi_list", volatile=True)
def _f_predict_multi_list(ctx, args, n_rows):
    out = _run_predict("infera_predict_multi_list", args, n_rows)
    if out is None:
        return Column.constant(None, T.LIST_FLOAT, n_rows)
    name, res = out
    if res.rows != n_rows:
        raise invalid_input(
            f"Model output row count mismatch. Expected {n_rows}, but got {res.rows}."
        )
    data = np.empty(n_rows, dtype=object)
    for i in range(n_rows):
        data[i] = [float(v) for v in res.data[i * res.cols : (i + 1) * res.cols]]
    return Column(data, T.LIST_FLOAT)


@scalar("infera_predict_from_blob", volatile=True)
def _f_predict_from_blob(ctx, args, n_rows):
    if len(args) != 2:
        # exact reference message (infera_extension.cpp:299-300)
        raise invalid_input(
            "infera_predict_from_blob(model_name, input_blob) requires 2 arguments"
        )
    # Row-at-a-time like the reference (model name may vary per row;
    # NULL name/blob → NULL row, not an error — infera_extension.cpp:303-310).
    names, blobs = args
    data = np.empty(n_rows, dtype=object)
    validity = np.ones(n_rows, dtype=bool)
    for i in range(n_rows):
        if names.is_null(i) or blobs.is_null(i):
            validity[i] = False
            continue
        name = str(names.value(i))
        blob = blobs.value(i)
        if isinstance(blob, str):
            blob = blob.encode("utf-8")
        try:
            res = api.predict_from_blob(name, bytes(blob))
        except InferaError as e:
            raise inference_failed(name, e)
        data[i] = [float(v) for v in res.data]
    return Column(data, T.LIST_FLOAT, None if validity.all() else validity)


@scalar("infera_get_model_info", volatile=True)
def _f_get_model_info(ctx, args, n_rows):
    _require_args("infera_get_model_info(model_name)", args, 1)
    if args[0].is_null(0):
        return Column.constant(None, T.VARCHAR, n_rows)
    name = str(args[0].value(0))
    info = api.get_model_info(name)
    if '"error"' in info:
        # C++ probes the JSON for an error key (infera_extension.cpp:492-494)
        raise invalid_input(f"Failed to get info for model '{name}'")
    return Column.constant(info, T.VARCHAR, n_rows)


@scalar("infera_get_loaded_models", volatile=True)
def _f_get_loaded_models(ctx, args, n_rows):
    return Column.constant(api.get_loaded_models(), T.VARCHAR, n_rows)


@scalar("infera_is_model_loaded", volatile=True)
def _f_is_model_loaded(ctx, args, n_rows):
    _require_args("infera_is_model_loaded(model_name)", args, 1)
    if args[0].is_null(0):
        raise invalid_input("Model name cannot be NULL")
    return Column.constant(api.is_model_loaded(str(args[0].value(0))), T.BOOLEAN, n_rows)


@scalar("infera_get_version")
def _f_get_version(ctx, args, n_rows):
    # The only non-volatile infera function (infera_extension.cpp:585).
    return Column.constant(api.get_version(), T.VARCHAR, n_rows)


@scalar("infera_clear_cache", volatile=True)
def _f_clear_cache(ctx, args, n_rows):
    try:
        api.clear_cache()
    except InferaError as e:
        raise invalid_input(f"Failed to clear cache: {e}")
    return Column.constant(True, T.BOOLEAN, n_rows)


@scalar("infera_get_cache_info", volatile=True)
def _f_get_cache_info(ctx, args, n_rows):
    return Column.constant(api.get_cache_info(), T.VARCHAR, n_rows)


@scalar("infera_set_autoload_dir", volatile=True)
def _f_set_autoload_dir(ctx, args, n_rows):
    _require_args("infera_set_autoload_dir(path)", args, 1)
    if args[0].is_null(0):
        return Column.constant(None, T.VARCHAR, n_rows)
    return Column.constant(api.set_autoload_dir(str(args[0].value(0))), T.VARCHAR, n_rows)


# ---------------------------------------------------------------------------
# general-purpose scalar functions used by the test suite / benchmarks
# ---------------------------------------------------------------------------

def _map_rows(args: list, n_rows: int, fn, out_type: T.SqlType,
              null_on_null: bool = True) -> Column:
    """Row-wise helper for host (string/object) functions."""
    data = (
        np.empty(n_rows, dtype=object)
        if out_type.np_dtype is None
        else np.zeros(n_rows, dtype=out_type.np_dtype)
    )
    validity = np.ones(n_rows, dtype=bool)
    for i in range(n_rows):
        vals = [a.value(i) for a in args]
        if null_on_null and any(v is None for v in vals):
            validity[i] = False
            continue
        out = fn(*vals)
        if out is None:
            validity[i] = False
        else:
            data[i] = out
    return Column(data, out_type, None if validity.all() else validity)


@scalar("abs")
def _f_abs(ctx, args, n_rows):
    c = args[0]
    if not c.sql_type.is_numeric:
        raise invalid_input("abs() requires a numeric argument")
    return Column(np.abs(c.data), c.sql_type, c.validity)


@scalar("round")
def _f_round(ctx, args, n_rows):
    c = args[0]
    nd = int(args[1].value(0)) if len(args) > 1 else 0
    return Column(np.round(c.data.astype(np.float64), nd), T.DOUBLE, c.validity)


@scalar("floor")
def _f_floor(ctx, args, n_rows):
    c = args[0]
    return Column(np.floor(c.data.astype(np.float64)), T.DOUBLE, c.validity)


@scalar("ceil")
def _f_ceil(ctx, args, n_rows):
    c = args[0]
    return Column(np.ceil(c.data.astype(np.float64)), T.DOUBLE, c.validity)


@scalar("sqrt")
def _f_sqrt(ctx, args, n_rows):
    c = args[0]
    return Column(np.sqrt(c.data.astype(np.float64)), T.DOUBLE, c.validity)


@scalar("instr")
def _f_instr(ctx, args, n_rows):
    # 1-based position of needle in haystack; 0 when absent
    return _map_rows(args, n_rows, lambda h, nd: (str(h).find(str(nd)) + 1), T.BIGINT)


@scalar("strpos")
def _f_strpos(ctx, args, n_rows):
    return _f_instr(ctx, args, n_rows)


@scalar("length")
def _f_length(ctx, args, n_rows):
    def ln(v):
        if isinstance(v, (list, tuple)):
            return len(v)
        if isinstance(v, (bytes, bytearray)):
            return len(v)
        return len(str(v))

    return _map_rows(args, n_rows, ln, T.BIGINT)


@scalar("len")
def _f_len(ctx, args, n_rows):
    return _f_length(ctx, args, n_rows)


@scalar("octet_length")
def _f_octet_length(ctx, args, n_rows):
    return _map_rows(args, n_rows, lambda v: len(v) if isinstance(v, (bytes, bytearray)) else len(str(v).encode()), T.BIGINT)


@scalar("repeat")
def _f_repeat(ctx, args, n_rows):
    return _map_rows(args, n_rows, lambda s, n: str(s) * int(n), T.VARCHAR)


@scalar("chr")
def _f_chr(ctx, args, n_rows):
    return _map_rows(args, n_rows, lambda n: chr(int(n)), T.VARCHAR)


@scalar("upper")
def _f_upper(ctx, args, n_rows):
    return _map_rows(args, n_rows, lambda s: str(s).upper(), T.VARCHAR)


@scalar("lower")
def _f_lower(ctx, args, n_rows):
    return _map_rows(args, n_rows, lambda s: str(s).lower(), T.VARCHAR)


@scalar("concat")
def _f_concat(ctx, args, n_rows):
    def cc(*vals):
        return "".join(str(v) for v in vals if v is not None)

    return _map_rows(args, n_rows, cc, T.VARCHAR, null_on_null=False)


@scalar("substr")
def _f_substr(ctx, args, n_rows):
    def sub(s, start, ln=None):
        s = str(s)
        start = int(start) - 1
        if ln is None:
            return s[start:]
        return s[start : start + int(ln)]

    return _map_rows(args, n_rows, sub, T.VARCHAR)


@scalar("contains")
def _f_contains(ctx, args, n_rows):
    return _map_rows(args, n_rows, lambda h, nd: str(nd) in str(h), T.BOOLEAN)


@scalar("list_extract")
def _f_list_extract(ctx, args, n_rows):
    def ext(lst, idx):
        idx = int(idx)
        if not isinstance(lst, (list, tuple)) or idx < 1 or idx > len(lst):
            return None
        return float(lst[idx - 1])

    return _map_rows(args, n_rows, ext, T.DOUBLE)


@scalar("coalesce")
def _f_coalesce(ctx, args, n_rows):
    out_type = next((a.sql_type for a in args if a.sql_type.name != "NULL"), T.SQLNULL)

    def co(*vals):
        for v in vals:
            if v is not None:
                return v
        return None

    return _map_rows(args, n_rows, co, out_type, null_on_null=False)


@scalar("greatest")
def _f_greatest(ctx, args, n_rows):
    out_type = args[0].sql_type
    return _map_rows(args, n_rows, lambda *v: max(v), out_type)


@scalar("least")
def _f_least(ctx, args, n_rows):
    out_type = args[0].sql_type
    return _map_rows(args, n_rows, lambda *v: min(v), out_type)


@scalar("typeof")
def _f_typeof(ctx, args, n_rows):
    return Column.constant(str(args[0].sql_type), T.VARCHAR, n_rows)


@scalar("hash")
def _f_hash(ctx, args, n_rows):
    from ..ops.hashing import hash_columns_host

    return Column(hash_columns_host([a for a in args]).astype(np.int64), T.BIGINT)


@scalar("trim")
def _f_trim(ctx, args, n_rows):
    return _map_rows(args, n_rows, lambda s: str(s).strip(), T.VARCHAR)


@scalar("ltrim")
def _f_ltrim(ctx, args, n_rows):
    return _map_rows(args, n_rows, lambda s: str(s).lstrip(), T.VARCHAR)


@scalar("rtrim")
def _f_rtrim(ctx, args, n_rows):
    return _map_rows(args, n_rows, lambda s: str(s).rstrip(), T.VARCHAR)


@scalar("replace")
def _f_replace(ctx, args, n_rows):
    return _map_rows(args, n_rows,
                     lambda s, a, b: str(s).replace(str(a), str(b)), T.VARCHAR)


@scalar("reverse")
def _f_reverse(ctx, args, n_rows):
    return _map_rows(args, n_rows, lambda s: str(s)[::-1], T.VARCHAR)


@scalar("split_part")
def _f_split_part(ctx, args, n_rows):
    def sp(s, sep, idx):
        parts = str(s).split(str(sep))
        i = int(idx)
        return parts[i - 1] if 1 <= i <= len(parts) else ""

    return _map_rows(args, n_rows, sp, T.VARCHAR)


@scalar("starts_with")
def _f_starts_with(ctx, args, n_rows):
    return _map_rows(args, n_rows,
                     lambda s, p: str(s).startswith(str(p)), T.BOOLEAN)


@scalar("ends_with")
def _f_ends_with(ctx, args, n_rows):
    return _map_rows(args, n_rows,
                     lambda s, p: str(s).endswith(str(p)), T.BOOLEAN)


@scalar("lpad")
def _f_lpad(ctx, args, n_rows):
    return _map_rows(args, n_rows,
                     lambda s, n, c=" ": str(s).rjust(int(n), str(c)[:1] or " "),
                     T.VARCHAR)


@scalar("regexp_matches")
def _f_regexp_matches(ctx, args, n_rows):
    import re as _re

    cache: dict = {}

    def rm(s, pat):
        rx = cache.get(pat)
        if rx is None:
            rx = _re.compile(str(pat))
            cache[pat] = rx
        return rx.search(str(s)) is not None

    return _map_rows(args, n_rows, rm, T.BOOLEAN)


@scalar("pow")
def _f_pow(ctx, args, n_rows):
    a, b = args[0], args[1]
    valid = a.valid_mask() & b.valid_mask()
    with np.errstate(invalid="ignore"):
        data = np.power(a.data.astype(np.float64), b.data.astype(np.float64))
    return Column(data, T.DOUBLE, None if valid.all() else valid)


@scalar("power")
def _f_power(ctx, args, n_rows):
    return _f_pow(ctx, args, n_rows)


@scalar("exp")
def _f_exp(ctx, args, n_rows):
    c = args[0]
    return Column(np.exp(c.data.astype(np.float64)), T.DOUBLE, c.validity)


@scalar("ln")
def _f_ln(ctx, args, n_rows):
    c = args[0]
    with np.errstate(invalid="ignore", divide="ignore"):
        return Column(np.log(c.data.astype(np.float64)), T.DOUBLE, c.validity)


@scalar("log")
def _f_log(ctx, args, n_rows):
    if len(args) == 1:
        c = args[0]
        with np.errstate(invalid="ignore", divide="ignore"):
            return Column(np.log10(c.data.astype(np.float64)), T.DOUBLE, c.validity)
    base, c = args
    with np.errstate(invalid="ignore", divide="ignore"):
        data = np.log(c.data.astype(np.float64)) / np.log(base.data.astype(np.float64))
    valid = base.valid_mask() & c.valid_mask()
    return Column(data, T.DOUBLE, None if valid.all() else valid)


@scalar("log2")
def _f_log2(ctx, args, n_rows):
    c = args[0]
    with np.errstate(invalid="ignore", divide="ignore"):
        return Column(np.log2(c.data.astype(np.float64)), T.DOUBLE, c.validity)


@scalar("sin")
def _f_sin(ctx, args, n_rows):
    c = args[0]
    return Column(np.sin(c.data.astype(np.float64)), T.DOUBLE, c.validity)


@scalar("cos")
def _f_cos(ctx, args, n_rows):
    c = args[0]
    return Column(np.cos(c.data.astype(np.float64)), T.DOUBLE, c.validity)


@scalar("sign")
def _f_sign(ctx, args, n_rows):
    c = args[0]
    return Column(np.sign(c.data.astype(np.float64)), T.DOUBLE, c.validity)


@scalar("pi")
def _f_pi(ctx, args, n_rows):
    return Column.constant(float(np.pi), T.DOUBLE, n_rows)


@scalar("random", volatile=True)
def _f_random(ctx, args, n_rows):
    return Column(np.random.default_rng().random(n_rows), T.DOUBLE)


@scalar("list_sum")
def _f_list_sum(ctx, args, n_rows):
    return _map_rows(args, n_rows,
                     lambda lst: float(sum(lst)) if isinstance(lst, (list, tuple)) else None,
                     T.DOUBLE)


@scalar("list_avg")
def _f_list_avg(ctx, args, n_rows):
    return _map_rows(
        args, n_rows,
        lambda lst: float(sum(lst)) / len(lst)
        if isinstance(lst, (list, tuple)) and lst else None,
        T.DOUBLE)


@scalar("to_blob")
def _f_to_blob(ctx, args, n_rows):
    """Encode a LIST[FLOAT] or string as a little-endian f32 / raw BLOB."""

    def enc(v):
        if isinstance(v, (list, tuple)):
            return np.asarray(v, dtype="<f4").tobytes()
        if isinstance(v, (bytes, bytearray)):
            return bytes(v)
        return str(v).encode("utf-8")

    return _map_rows(args, n_rows, enc, T.BLOB)
