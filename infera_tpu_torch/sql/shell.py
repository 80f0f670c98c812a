"""Interactive SQL shell (the UX analog of running the reference inside the
DuckDB CLI). Usage: ``python -m infera_tpu.sql.shell``.

Multi-line statements terminate with ';'. Meta commands: .tables, .timer,
.help, .quit.
"""

from __future__ import annotations

import sys
import time

from ..columnar import format_sql_value
from ..errors import SqlError
from .executor import Connection


def _print_table(result) -> None:
    table = result.table
    if table is None:
        print("OK")
        return
    names = table.names
    rows = [[format_sql_value(v) if v is not None else "NULL" for v in table.row(i)]
            for i in range(table.num_rows)]
    widths = [max(len(n), *(len(r[j]) for r in rows)) if rows else len(n)
              for j, n in enumerate(names)]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    print(sep)
    print("|" + "|".join(f" {n:<{w}} " for n, w in zip(names, widths)) + "|")
    print(sep)
    for r in rows:
        print("|" + "|".join(f" {v:<{w}} " for v, w in zip(r, widths)) + "|")
    print(sep)
    print(f"{table.num_rows} row{'s' if table.num_rows != 1 else ''}")


def main() -> int:
    conn = Connection()
    timer = False
    buffer = ""
    print("infera_tpu SQL shell — ';' ends a statement, .help for commands")
    while True:
        try:
            prompt = "infera> " if not buffer else "   ...> "
            line = input(prompt)
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        stripped = line.strip()
        if not buffer and stripped.startswith("."):
            if stripped in (".quit", ".exit"):
                return 0
            if stripped == ".tables":
                for name in sorted(conn.catalog.tables):
                    print(name)
                continue
            if stripped == ".timer":
                timer = not timer
                print(f"timer {'on' if timer else 'off'}")
                continue
            if stripped == ".help":
                print(".tables  list tables\n.timer   toggle timing\n"
                      ".quit    exit")
                continue
            print(f"unknown command {stripped}")
            continue
        buffer += ("\n" if buffer else "") + line
        if not stripped.endswith(";"):
            continue
        sql, buffer = buffer, ""
        t0 = time.perf_counter()
        try:
            result = conn.execute(sql)
        except (SqlError, Exception) as e:  # noqa: BLE001 - REPL surface
            print(f"Error: {e}")
            continue
        _print_table(result)
        if timer:
            print(f"({(time.perf_counter() - t0) * 1e3:.1f} ms)")


if __name__ == "__main__":
    sys.exit(main())
