"""The port's SQL front end and host executor against ``infera_tpu``'s.

The port keeps its own copies of the lexer, parser and host operators: the
same SQL parses to the same AST (compared by ``repr``), and the same
statements over the same data give the same rows. The tables here are small
(under ``MIN_DEVICE_ROWS``), so both packages answer on their host
executors."""

import glob
import os
import random

import numpy as np
import pytest

from infera_tpu.sql import Connection as RefConnection
from infera_tpu.sql.lexer import tokenize as ref_tokenize
from infera_tpu.sql.parser import parse_sql as ref_parse_sql
from infera_tpu_torch.errors import SqlError
from infera_tpu_torch.sql import Connection
from infera_tpu_torch.sql.lexer import tokenize
from infera_tpu_torch.sql.parser import parse_sql
from infera_tpu_torch.testing.sqllogic import SqlLogicRunner
from perfbench import harness

# the statements of tests/test_pallas_sql.py:52-186 and the SQL flagship of
# infera_tpu/testing/e2e_eval.py
PARSED = [
    "select g, count(*) c, avg(infera_predict('m', f1, f2, f3, f4)) p, "
    "sum(f1) s from big where f2 > 1.0 group by g order by g",
    "select g, h, min(f1) mn, max(f2) mx, count(*) c from big "
    "group by g, h having count(*) > 10 order by g, h",
    "select count(*), sum(f1 * 2.0 + f3), min(f2 - f4), max(f2) "
    "from big where f1 > 3.0 and f3 < 8.0",
    "select g, avg(infera_predict_multi_list('mc', f1, f2, f3, f4)[2]) "
    "from big group by g order by g",
    "select g, count(*) c, avg(infera_predict('gbt', f1, f2, f3, f4)) p,"
    " max(infera_predict('gbt', f1, f2, f3, f4)) mx from big "
    "where f1 > 1.0 group by g order by g",
    "select count(*), sum(f1) from big "
    "where infera_predict('gbtw', f1, f2, f3, f4) > 0.0",
    "select g, count(*) c, avg(infera_predict('gbc', f1, f2, f3, f4))"
    " al, min(infera_predict('gbc', f1, f2, f3, f4)) ml from big "
    "group by g order by g",
    "select g, avg(infera_predict('mb', f1, f2, f3, f4)) p from big "
    "group by g order by g",
    "select g, sum(h) from big group by g order by g",
    "select g, stddev(f1) sd, var_pop(f2) vp, count_if(f1 > 4.0) ci, "
    "bool_and(f1 >= 0.0) ba, bool_or(f2 > 9.0) bo, "
    "product(1.0 + f3 / 1000.0) pr, avg(h) ah from big group by g order by g",
    "select g, count(distinct h) cd, sum(distinct h) sd, "
    "avg(distinct h) ad from big group by g order by g",
    "create table big as select x % 64 as g, x % 5 as h, "
    "(x % 100)::float / 10.0 as f1, ((x + 3) % 50)::float / 5.0 as f2, "
    "((x * 7) % 30)::float / 3.0 as f3, ((x * 11) % 90)::float / 9.0 "
    "as f4 from range(32768) r(x)",
    "select g, count(*) from big where f1 between 1 and 2 and not (f2 < 0.5 "
    "or cast(f3 as integer) % 2 = 1) group by g having max(f4) >= abs(-3.5)",
]

TABLE = ("create table t as select x % 7 as g, x % 3 as h, (x % 100)::float / 10.0 as f, "
         "((x * 7) % 31)::float - 15.0 as v, 'k' || (x % 4) as s from range(2000) r(x)")
DIM = "create table d as select x as g, 'name' || x as nm, x * 1.5 as w from range(5) r(x)"

# group-by, HAVING, ORDER BY / LIMIT, a join, windows, and the host
# aggregate families the kernel tier leaves to the host
HOST_QUERIES = [
    "select g, count(*), sum(f), avg(v), min(v), max(f) from t group by g order by g",
    "select g, h, count(*) c from t group by g, h having count(*) > 90 order by g, h",
    "select s, sum(v) sv from t group by s having sum(v) > -100 order by sv desc",
    "select g, f, v from t order by v desc, f limit 7",
    "select g, v from t where f between 2 and 3 order by g, v limit 5 offset 3",
    "select nm, count(*), sum(v * w) from t join d on t.g = d.g group by nm order by nm",
    "select g, f, row_number() over (partition by g order by f, v) rn, "
    "sum(v) over (partition by g order by f rows between 2 preceding and current row) rs "
    "from t where f < 1.0 order by g, f, v",
    "select g, rank() over (order by g) r from t where h = 0 and f < 3 order by g, r",
    "select g, var_pop(v), stddev(f), count(distinct h), median(v) from t "
    "group by g order by g",
    "select count(*), sum(g), min(f), max(v) from t where v > 0",
    "select g % 2 as p, avg(f * 2.0 + v) from t group by g % 2 order by p",
    "select distinct h, g % 2 from t order by h, 2",
    "with q as (select g, sum(v) sv from t group by g) select * from q where sv > 0 order by g",
]


SQLLOGIC_FILES = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "sqllogic", "*.test")))

# one statement of each construct the parser knows
CONSTRUCTS = [
    "select g, sum(v) over (partition by g order by f desc, v rows between 2 preceding and "
    "current row) s, avg(v) over (order by f range between unbounded preceding and 3 "
    "following) a, count(*) over () c, rank() over (order by g rows 1 preceding) r from t",
    "select g, h, sum(v) from t group by grouping sets ((g, h), (g), ()) order by g, h",
    "select g, h, count(*) from t group by rollup (g, h)",
    "select g, h, count(*) from t group by cube (g, h) having count(*) > 1",
    "select case when v > 0 then 'pos' when v < 0 then 'neg' else 'zero' end, "
    "case g when 1 then 'a' end from t",
    "select cast(f as integer), cast(v as decimal(10, 2)), f::varchar, (f + 1)::double, "
    "x::int::varchar, cast(s as varchar(3)) from t",
    "select position('b' in 'abc'), position(s in 'k1' || s), position('a', 'b') from t",
    "select * from t where exists (select 1 from d where d.g = t.g) and g in (select g from d) "
    "and h not in (select 1) and (select max(w) from d) > 1",
    "select g from t union select g from d except select 1 intersect all select 2 "
    "union all select 3 order by 1 limit 2",
    "with q(a, b) as (select g, sum(v) from t group by g), r as (select * from q) "
    "select * from r join q using (a)",
    "copy t to 'out.csv'",
    "copy (select g from t where v > 0) to 'out.parquet' (format parquet)",
    "pragma enable_verification",
    "pragma threads = 4",
    "select ? + ?, f(?, ?)[?] from t where g = ? and s like ?",
    "select t.*, d.*, t.g, d.nm from t, d cross join t t2 left outer join d d2 on t.g = d2.g "
    "right join d d3 on true full join d d4 on false inner join d d5 using (g)",
    "select a = b = c, a < b <> c >= d, a == b != c, 1 < 2 = true from t",
    "select not a in (1), a not in (1, 2), not a between 1 and 2, a not between 1 and 2, "
    "not a like 'x%', a not like 'x%', not not a, not a = b and not c or not d from t",
    "select -1, - -1, -+-x, +-+x, -x::int, -x[1], -2 * -3, 2 - -3, -(1 + 2) from t",
    "select a is null is not null, a || b in (c), a between 1 and 2 is null, a = b is null, "
    "a in (1) = b like c, not a is null and b or c, not a = b = c + d, "
    "a between 1 and 2 || 'x', a like 'b' - 1 from t",
    "select [1, 2, 3][2], [], f()[1][2], list_value(1)[-1] from t",
    "select count(*), count(distinct g), sum(distinct v), f(*) from t",
    "select 1.5, .5, 1., 1e3, 1.e3, 2E-3, 1e+5, 2147483648, -2147483648, 'it''s', \"Q u\" "
    "from t",
    "select x from range(10) r(x) where x % 2 = 1 limit 3 offset 1",
    "select * from (values (1, 'a'), (2, 'b')) v(n, s) order by n desc nulls first, "
    "s asc nulls last",
    "select * from (select g from t) sub(k), read_csv('f.csv') c",
    "explain analyze select g from t",
    "explain with q as (select 1) select * from q",
    "create or replace table u as select * from t",
    "create table if not exists u (a integer, b varchar(10), c decimal(18, 3))",
    "create macro m(a, b) as a + b * 2",
    "create or replace macro m0() as 1",
    "insert into u (a, b) values (1, 'x'), (2, null)",
    "insert into u select * from t",
    "update u set a = a + 1, b = 'y' where a > 0",
    "delete from u where a is not null",
    "delete from u",
    "drop table if exists u",
    "drop table u",
    "set threads = 8",
    "load 'httpfs'",
    "export database 'dir'",
    "import database 'dir'",
    "select 1; select 2;; select 3",
    "select a.b, \"select\" from t where true and false or null",
]

# statements whose every cut, at a token's edge or inside one, must parse or
# fail as the reference's does
PREFIXED = [CONSTRUCTS[i] for i in (0, 1, 5, 6, 7, 9, 17, 19, 23, 26, 33)] + [
    HOST_QUERIES[6], PARSED[11], PARSED[12]]

# the lexer's edge cases, each in a statement; the last ones hold characters
# outside ASCII, which the per-character scanner takes
LEXED = [
    "select 'abc", "select \"abc", "select 1 /* open", "select 1 -- to the end",
    "select 1 --", "select 1e", "select .5", "select 1.e3", "select 1e+", "select 1e-x",
    "select 1.2.3", "select 1..2", "select a.*", "select #", "select $1", "select a : b",
    "select a | b", "select !", "select a != b", "select a ! b", "select \t\r\na\n",
    "select '' || '''' || 'a''b'", "select \"\"", "select /**/ 1 /* a */ /* b */",
    "select 1 /*/ 2 */", "select \x0c 1", "select \x00", "select 1 'a''",
    "select é", "select 日本 from t", "select ²", "select x² from t", "select 'é",
    "select \"日本\" -- ü", "select ٣", "select a ¬ b",
]


def _outcome(parse, sql):
    try:
        return repr(parse(sql))
    except Exception as e:  # the parity check compares the errors themselves
        return f"{type(e).__name__}: {e}"


class _Recorder:
    """A connection that keeps each statement the runner sends it."""

    def __init__(self):
        self.sqls = []

    def execute(self, sql):
        self.sqls.append(sql)
        raise RuntimeError("recorded, not run")


def _statements(path):
    rec = _Recorder()
    SqlLogicRunner(rec).run_file(path)
    return rec.sqls


def _benchmark_texts():
    """Each template of the benchmark's mixes at each of its thresholds."""
    out = []
    for mix, config in (("sql1_mlp", "mlp_classifier_f32"), ("sql4_gbt", "gbt_models_f32")):
        m, c = harness.load("mixes", mix), harness.load("configs", config)
        for name, t in sorted(m["templates"].items()):
            out += [pytest.param(harness.sql_of(c, t, v), id=f"{name}-{v}")
                    for v in harness.values_of(t)]
    return out


_OPERANDS = ["a", "t.b", "1", "2.5", "'s'", "null", "true", "?", '"q"', "t.*", "-1", "f(a)"]
_BINARY = ["or", "and", "=", "==", "<>", "!=", "<", "<=", ">", ">=", "||", "+", "-", "*", "/",
           "%"]
_WORDS = ["select", "from", "where", "and", "or", "not", "in", "is", "null", "between", "like",
          "(", ")", ",", "+", "*", "::", "[", "]", "case", "end", "over", "as"]


def _expression(rng, depth):
    """A random expression over every operator form."""
    if depth <= 0 or rng.random() < 0.2:
        return rng.choice(_OPERANDS)
    a, b, c = (_expression(rng, depth - 1) for _ in range(3))
    neg = rng.choice(["", "not "])
    return rng.choice([
        f"{a} {rng.choice(_BINARY)} {b}", f"{a} {rng.choice(_BINARY)} {b}",
        f"not {a}", f"{rng.choice(['-', '+', '- -', '-+'])}{a}",
        f"{a} is {neg}null", f"{a} {neg}in ({b}, {c})", f"{a} {neg}between {b} and {c}",
        f"{a} {neg}like {b}", f"({a})::{rng.choice(['int', 'decimal(5, 2)'])}",
        f"g({a}, {b})[{c}]", f"case when {a} then {b} else {c} end",
        f"position({a} in {b})", f"cast({a} as double)",
    ])


def _generated(seed, n=150):
    """Statements of random expressions, half of them with a word dropped,
    added or swapped, so that most of that half fail somewhere."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        sql = (f"select {_expression(rng, rng.randint(1, 5))}, {_expression(rng, 2)} "
               f"from t where {_expression(rng, 3)}")
        if rng.random() < 0.5:
            parts = sql.split(" ")
            for _ in range(rng.randint(1, 3)):
                j = rng.randrange(len(parts))
                kind = rng.randrange(3)
                if kind == 0 and len(parts) > 1:
                    del parts[j]
                elif kind == 1:
                    parts.insert(j, rng.choice(_WORDS))
                else:
                    parts[j] = rng.choice(_WORDS)
            sql = " ".join(parts)
        out.append(sql)
    return out


@pytest.mark.parametrize("sql", PARSED)
def test_parse_gives_the_same_ast(sql):
    assert repr(parse_sql(sql)) == repr(ref_parse_sql(sql))


@pytest.mark.parametrize("sql", CONSTRUCTS)
def test_every_construct_parses_to_the_same_ast(sql):
    assert repr(parse_sql(sql)) == repr(ref_parse_sql(sql))


@pytest.mark.parametrize("path", SQLLOGIC_FILES, ids=os.path.basename)
def test_sqllogic_statements_parse_the_same(path):
    sqls = _statements(path)
    assert sqls
    for sql in sqls:
        assert _outcome(parse_sql, sql) == _outcome(ref_parse_sql, sql), sql


@pytest.mark.parametrize("sql", _benchmark_texts())
def test_benchmark_texts_parse_to_the_same_ast(sql):
    assert repr(parse_sql(sql)) == repr(ref_parse_sql(sql))


@pytest.mark.parametrize("seed", range(6))
def test_generated_expressions_parse_the_same(seed):
    for sql in _generated(seed):
        assert _outcome(parse_sql, sql) == _outcome(ref_parse_sql, sql), sql


# once an operator has been applied, a tighter one may not follow it
ENDED = [
    "select a is null * b", "select a in (1) + 2", "select a between 1 and 2 * 3 is null + 1",
    "select a like 'b' || 'c' is null * 2", "select not a is not null / b",
    "select -a is null::int", "select a not in (1) [1]", "select not a = b is null || c",
]


@pytest.mark.parametrize("sql", ["select 1 +", "selec 1", "select (1", "select * from t where",
                                 "select 'abc", "select 1 from t group"] + ENDED + LEXED)
def test_parse_errors_are_byte_equal(sql):
    outcomes = [_outcome(parse, sql) for parse in (parse_sql, ref_parse_sql)]
    assert outcomes[0] == outcomes[1]
    if sql not in LEXED:
        assert outcomes[0].startswith("SqlError")


@pytest.mark.parametrize("sql", PREFIXED)
def test_every_cut_of_a_statement_parses_or_fails_the_same(sql):
    for k in range(len(sql) + 1):
        cut = sql[:k]
        assert _outcome(parse_sql, cut) == _outcome(ref_parse_sql, cut), cut


@pytest.mark.parametrize("sql", LEXED + CONSTRUCTS[:8])
def test_tokens_match_the_reference(sql):
    def ref_fields(t):
        return t.kind, t.text, t.pos, t.upper

    outcomes = []
    for lex, fields in ((tokenize, tuple), (ref_tokenize, ref_fields)):
        try:
            outcomes.append([fields(t) for t in lex(sql)])
        except Exception as e:  # each package raises its own SqlError
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


@pytest.fixture(scope="module")
def conns():
    port, ref = Connection(), RefConnection()
    for conn in (port, ref):
        conn.execute(TABLE)
        conn.execute(DIM)
    return port, ref


def _close(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            if isinstance(y, float) and not isinstance(x, str):
                assert x == pytest.approx(y, rel=1e-12, abs=1e-12, nan_ok=True)
            else:
                assert x == y


@pytest.mark.parametrize("sql", HOST_QUERIES)
def test_host_rows_match(conns, sql):
    port, ref = conns
    got = port.execute(sql)
    want = ref.execute(sql)
    assert port._exec_path == ref._exec_path == "host"
    assert got.names == want.names
    _close(got.rows, want.rows)


def test_mesh_is_refused_with_a_clear_error():
    """set_mesh takes a shard count, a Mesh or None; anything else is
    refused with an error that names the mesh."""
    conn = Connection()
    conn.set_mesh(None)
    with pytest.raises(SqlError, match="mesh"):
        conn.set_mesh("8")


def test_explain_names_the_kernel_tier(monkeypatch):
    """EXPLAIN names the tier the plan takes: kernel K2 where it is on, the
    torch program where it is off (``INFERA_PALLAS_SQL=0`` turns off K2
    only), the host where neither takes the plan."""
    import infera_tpu_torch as itt

    itt.set_device("cpu")
    try:
        conn = Connection()
        conn.execute("create table e as select x % 8 as g, x * 0.5 as f from range(20000) r(x)")
        q = "explain select g, sum(f) from e group by g"
        monkeypatch.setenv("INFERA_PALLAS_SQL", "1")
        assert "kernel K2" in "\n".join(r[0] for r in conn.execute(q).rows)
        monkeypatch.setenv("INFERA_PALLAS_SQL", "0")
        assert "torch program" in "\n".join(r[0] for r in conn.execute(q).rows)
        q = "explain select g, sum(f) from e group by g having g > 1"
        assert "host/hybrid" in "\n".join(r[0] for r in conn.execute(q).rows)
    finally:
        itt.set_device(None)


def test_metrics_record_the_path_and_phases(monkeypatch):
    import infera_tpu_torch as itt
    from infera_tpu_torch.observability import METRICS

    itt.set_device("cpu")
    monkeypatch.setenv("INFERA_PALLAS_SQL", "1")
    try:
        conn = Connection()
        conn.execute("create table e as select x % 8 as g, x * 0.5 as f from range(20000) r(x)")
        rows = conn.execute("select g, sum(f) from e group by g order by g").rows
        m = METRICS.entries[0]
        assert m.path == "device_plan_cuda"
        assert set(m.phases) == {"plan_ms", "upload_ms", "probe_ms", "exec_ms", "assemble_ms"}
        x = np.arange(20000)
        assert [r[1] for r in rows] == [float((x[x % 8 == g] * 0.5).sum()) for g in range(8)]
    finally:
        itt.set_device(None)
