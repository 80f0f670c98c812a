"""sqllogictest-style runner.

The reference's parity bar is its sqllogictest suite run by DuckDB's unittest
runner (upstream test/sql/*.test; SURVEY.md §4 tier 2). This runner
replays the same file format against our SQL engine:

- ``statement ok`` / ``statement error`` (with expected message substring
  after ``----``)
- ``query <types>`` with expected tab-separated rows after ``----``
  (optional ``rowsort`` modifier)
- ``#`` comments, blank-line record separation
- ``${MODELS}`` placeholder substitution so test files can reference the
  synthesized model directory

Rendering matches DuckDB's sqllogictest conventions: booleans as
``true``/``false``, NULL as ``NULL``, empty string as ``(empty)``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from ..errors import SqlError
from ..sql import Connection


@dataclass
class RecordResult:
    kind: str
    sql: str
    ok: bool
    message: str = ""
    line: int = 0


@dataclass
class FileResult:
    path: str
    records: list = field(default_factory=list)

    @property
    def passed(self) -> bool:
        return all(r.ok for r in self.records)

    @property
    def n_passed(self) -> int:
        return sum(1 for r in self.records if r.ok)

    def failures(self) -> list:
        return [r for r in self.records if not r.ok]


def render_value(v, type_code: str) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "true" if v else "false"
    if type_code == "I" and isinstance(v, (int, float)):
        return str(int(v))
    if type_code == "R":
        f = float(v)
        if f != f:
            return "nan"
        if f.is_integer() and abs(f) < 1e15:
            return f"{f:.1f}"
        return repr(f)
    # T (text) and anything else
    if isinstance(v, (bytes, bytearray)):
        s = v.decode("utf-8", "replace")
    elif isinstance(v, list):
        s = "[" + ", ".join(render_value(x, "R") for x in v) + "]"
    elif isinstance(v, float):
        return render_value(v, "R")
    else:
        s = str(v)
    return "(empty)" if s == "" else s


def _render_rows(table, type_codes: str) -> list:
    out = []
    cols = list(table.columns.values())
    for i in range(table.num_rows):
        vals = []
        for j, col in enumerate(cols):
            code = type_codes[j] if j < len(type_codes) else "T"
            vals.append(render_value(col.value(i), code))
        out.append("\t".join(vals))
    return out


class SqlLogicRunner:
    def __init__(self, connection: Connection | None = None,
                 substitutions: dict | None = None):
        self.conn = connection or Connection()
        self.substitutions = substitutions or {}

    def _substitute(self, sql: str) -> str:
        for key, val in self.substitutions.items():
            sql = sql.replace("${" + key + "}", str(val))
        return sql

    def run_text(self, text: str, path: str = "<memory>") -> FileResult:
        result = FileResult(path)
        lines = text.split("\n")
        i = 0
        n = len(lines)
        while i < n:
            line = lines[i]
            stripped = line.strip()
            if not stripped or stripped.startswith("#"):
                i += 1
                continue
            if stripped.startswith("--"):  # .slt SQL-style comment line
                i += 1
                continue
            if stripped.startswith("require "):
                i += 1
                continue
            if stripped == "----":  # stray separator: skip it + its block
                i += 1
                while i < len(lines) and lines[i].strip():
                    i += 1
                continue
            m = re.match(r"statement\s+(ok|error)\s*$", stripped)
            if m:
                i, rec = self._run_statement(lines, i, m.group(1) == "error")
                result.records.append(rec)
                continue
            m = re.match(r"query\s+([A-Z]+)(\s+\w+)?\s*$", stripped)
            if m:
                modifier = (m.group(2) or "").strip()
                i, rec = self._run_query(lines, i, m.group(1), modifier)
                result.records.append(rec)
                continue
            # loose statement (pragma / load on their own)
            start_i = i
            i, rec = self._run_loose(lines, i)
            if i == start_i:  # defensive: never loop in place
                i += 1
                continue
            result.records.append(rec)
        return result

    def run_file(self, path: str) -> FileResult:
        with open(path) as f:
            return self.run_text(f.read(), path)

    # -- record runners ---------------------------------------------------

    def _collect_sql(self, lines: list, i: int) -> tuple:
        sql_lines = []
        while i < len(lines):
            s = lines[i]
            if not s.strip() or s.strip() == "----":
                break
            sql_lines.append(s)
            i += 1
        return "\n".join(sql_lines), i

    def _run_statement(self, lines: list, i: int, expect_error: bool):
        start = i
        i += 1
        sql, i = self._collect_sql(lines, i)
        expected_error = None
        if i < len(lines) and lines[i].strip() == "----":
            i += 1
            err_lines = []
            while i < len(lines) and lines[i].strip():
                err_lines.append(lines[i])
                i += 1
            expected_error = "\n".join(err_lines).strip()
        sql = self._substitute(sql)
        try:
            self.conn.execute(sql)
            if expect_error:
                return i, RecordResult("statement", sql, False,
                                       "expected an error but statement succeeded", start)
            return i, RecordResult("statement", sql, True, line=start)
        except (SqlError, Exception) as e:
            if not expect_error:
                return i, RecordResult("statement", sql, False, f"unexpected error: {e}", start)
            msg = str(e)
            if expected_error and expected_error not in msg:
                return i, RecordResult(
                    "statement", sql, False,
                    f"error mismatch:\n  expected substring: {expected_error}\n  actual: {msg}",
                    start,
                )
            return i, RecordResult("statement", sql, True, line=start)

    def _run_query(self, lines: list, i: int, type_codes: str, modifier: str):
        start = i
        i += 1
        sql, i = self._collect_sql(lines, i)
        expected: list = []
        if i < len(lines) and lines[i].strip() == "----":
            i += 1
            while i < len(lines) and lines[i].strip():
                expected.append(lines[i].rstrip("\n"))
                i += 1
        sql = self._substitute(sql)
        try:
            res = self.conn.execute(sql)
        except Exception as e:
            return i, RecordResult("query", sql, False, f"unexpected error: {e}", start)
        if res.table is None:
            return i, RecordResult("query", sql, False, "statement returned no result", start)
        actual = _render_rows(res.table, type_codes)
        exp = [e.rstrip() for e in expected]
        act = [a.rstrip() for a in actual]
        if modifier == "rowsort":
            exp = sorted(exp)
            act = sorted(act)
        if exp != act:
            return i, RecordResult(
                "query", sql, False,
                "result mismatch:\n  expected: " + repr(exp) + "\n  actual:   " + repr(act),
                start,
            )
        return i, RecordResult("query", sql, True, line=start)

    def _run_loose(self, lines: list, i: int):
        start = i
        sql, i = self._collect_sql(lines, i)
        sql = self._substitute(sql)
        try:
            self.conn.execute(sql)
            return i, RecordResult("statement", sql, True, line=start)
        except Exception as e:
            return i, RecordResult("statement", sql, False, f"unexpected error: {e}", start)
