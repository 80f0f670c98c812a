"""The port's ``testing/e2e_eval.py`` on the CPU against ``infera_tpu``'s.

Each subcommand runs at a small size through both packages. The port must
print the same JSON lines in the same order under the same ``step`` keys
(each line with at least the reference's fields), take the same paths
(the port's names: on the CPU ``device_plan``, ``device_join_plan``,
``host`` and ``shuffle_join``, as ``infera_tpu``'s on its CPU), keep the
reference's asserts (the outer joins' counts) and give the same counts:
groups, outer-join rows, output width and exact pair counts. Times are not
compared.
"""

import json

import pytest

import infera_tpu_torch as itt
from infera_tpu.testing import e2e_eval as ref_e2e
from infera_tpu_torch.registry import MODELS
from infera_tpu_torch.testing import e2e_eval as port_e2e

SIZES = {"sql": dict(n=1 << 15), "outer_join": dict(n=(1 << 15) + 77),
         "int8": dict(n=4096, width=32), "mobilenet": dict(iters=1),
         "window": dict(n=1 << 12), "shuffle_join": dict(n=1 << 15)}
# fields that hold counts and paths, compared exactly; the rest are times
EXACT = ("kind", "precision", "it", "path", "groups", "rows", "c", "cw", "n", "n_out",
         "pairs", "count_exact")


@pytest.fixture()
def on_cpu(clean_registry):
    itt.set_device("cpu")
    MODELS.clear()
    yield
    MODELS.clear()
    itt.set_device(None)


def _lines(capsys) -> list:
    out = capsys.readouterr().out
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("cmd", sorted(SIZES))
def test_subcommand_matches_reference(cmd, capsys, on_cpu):
    port_e2e.CMDS[cmd](**SIZES[cmd])
    port = _lines(capsys)
    ref_e2e.CMDS[cmd](**SIZES[cmd])
    ref = _lines(capsys)
    assert [p["step"] for p in port] == [r["step"] for r in ref]
    for p, r in zip(port, ref):
        assert set(r) <= set(p), (p["step"], set(r) - set(p))
        for key in EXACT:
            if key in r:
                assert p[key] == r[key], (p["step"], key, p[key], r[key])
    if cmd == "shuffle_join":
        exact = next(p for p in port if p["step"] == "shuffle_join_exact")
        assert exact["count_exact"] and exact["sv_rel"] < 1e-9 and exact["sw_rel"] < 1e-6


def test_paths_are_the_ports_names(capsys, on_cpu):
    port_e2e.eval_sql(n=1 << 15)
    port_e2e.eval_outer_join(n=1 << 15)
    paths = {p["path"] for p in _lines(capsys) if "path" in p}
    assert paths == {"device_plan", "device_join_plan"}


def test_outer_join_keeps_the_reference_assert(on_cpu, monkeypatch):
    """A join that drops the unmatched fact rows fails the count assert."""
    from infera_tpu_torch.sql import Connection

    real = Connection.execute

    def inner(self, sql, *a, **kw):
        return real(self, sql.replace("left join", "join").replace("full join", "join"), *a, **kw)

    monkeypatch.setattr(Connection, "execute", inner)
    with pytest.raises(AssertionError):
        port_e2e.eval_outer_join(n=1 << 14)


def test_main_runs_a_subcommand(capsys, on_cpu, monkeypatch):
    monkeypatch.setitem(port_e2e.CMDS, "window", lambda: port_e2e.eval_window(n=1 << 10))
    port_e2e.main(["window"])
    last = _lines(capsys)[-1]
    assert last["step"] == "window" and last["done"] is True
