"""The plain reference and the comparison that decides ``correct``.

Plain torch (f64, TF32 off) over the benchmark's own inputs: the table's
host arrays and the weights it drew. It recomputes each model, the filter,
the grouping and every aggregate, and imports nothing of the program.

Where f32 rounding in the program may decide a row either way (a
prediction within its rounding bound of a threshold), the reference does
not guess: it carries both outcomes and gives each aggregate of each group
the interval of values those outcomes allow. An answer is judged by how far each of its numbers lies outside
that interval: counts in rows, every other aggregate relative to the
interval's magnitude. Where no row is in doubt the interval is a point.
"""

from __future__ import annotations

import importlib
import math
from dataclasses import dataclass

import numpy as np
import torch

_U = 2.0 ** -24          # unit roundoff of f32
_OPS = {">": torch.gt, ">=": torch.ge, "<": torch.lt, "<=": torch.le}


def model_kind(kind: str):
    return importlib.import_module(f"perfbench.models.{kind}")


def feature_names(config: dict) -> list:
    """The table's feature columns in order: a drawn group's ``names``, or
    a one-hot group's ``prefix`` numbered from 1 (``soil_type1`` ...)."""
    names = []
    for group in config["table"]["columns"]:
        names += group.get("names") or [f"{group['prefix']}{i}"
                                        for i in range(1, group["count"] + 1)]
    return names


def key_counts(config: dict) -> list:
    """Rows of each key value: the published ``counts``, scaled to the
    table's rows by largest remainder where the rows are cut."""
    n, counts = config["table"]["rows"], config["table"]["key"]["counts"]
    total = sum(counts)
    exact = [c * n / total for c in counts]
    out = [math.floor(e) for e in exact]
    for i in sorted(range(len(out)), key=lambda i: out[i] - exact[i])[:n - sum(out)]:
        out[i] += 1
    return out


def model_outputs(config: dict, params: dict, features: np.ndarray, needed: set, device,
                  block: int = 1 << 20) -> dict:
    """{(model, output): (value, err)} over every row, on ``device``, each
    model run in blocks of ``block`` rows; err may be None."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    specs = {m["name"]: m for m in config["models"]}
    out = {}
    for name, output in sorted(needed, key=str):
        spec = specs[name]
        kind = model_kind(spec["kind"])
        parts = []
        for lo in range(0, features.shape[1], block):
            x = torch.as_tensor(features[:spec["features"], lo:lo + block].T.copy(),
                                device=device)
            parts.append(kind.reference(spec, params[name], x, output))
        out[(name, output)] = tuple(None if p[0] is None else torch.cat(p)
                                    for p in zip(*parts))
    return out


@dataclass
class Expected:
    """The reference's answer to one query: for every group that may
    appear, the lowest and highest value each output column but the key may
    take ([groups, aggregates], the count first), and which groups must
    appear."""
    keys: np.ndarray        # [G] int64 key values, ascending
    lo: np.ndarray          # [G, A] f64, the count first
    hi: np.ndarray
    required: np.ndarray    # [G] bool
    kept_rows: int          # rows the WHERE surely keeps


def expected(config: dict, template: dict, value, features: np.ndarray, keys: np.ndarray,
             outs: dict, device) -> Expected:
    """The interval answer of ``template`` at its parameter ``value``."""
    n = keys.shape[0]
    key = config["table"]["key"]
    g = torch.as_tensor(keys - key["first"], device=device)      # the group's index
    n_groups = len(key["counts"])
    pred = template.get("prediction")
    names = feature_names(config)

    def column(name):
        if name == "prediction":
            return outs[(pred["model"], pred.get("output"))]
        if name == key["name"]:
            return torch.as_tensor(keys, device=device).double(), None
        return torch.as_tensor(features[names.index(name)], device=device).double(), None

    sure = torch.ones(n, dtype=torch.bool, device=device)
    where_doubt = torch.zeros(n, dtype=torch.bool, device=device)
    where = template.get("where")
    if where is not None:
        x, err = column(where["column"])
        if where["column"] == "prediction":
            # the program's f32 prediction: its summation bound, its own
            # rounding, and the threshold's rounding to f32
            where_doubt = (x - value).abs() <= err + _U * x.abs() + _U * abs(value)
        sure = _OPS[where["op"]](x, value) & ~where_doubt

    aggs = template["aggregates"]
    vals = [None if func == "count" else column(expr)[0] for func, expr in aggs]
    idx = torch.nonzero(where_doubt).flatten()
    d_g = g[idx].cpu().numpy()

    count0 = torch.bincount(g[sure], minlength=n_groups).double().cpu().numpy()
    c_lo = count0
    c_hi = count0 + np.bincount(d_g, minlength=n_groups)
    lo_cols, hi_cols = [], []
    for (func, _), v in zip(aggs, vals):
        if func == "count":
            lo_c, hi_c = c_lo, c_hi
        else:
            # a doubtful row counts with its value or not at all
            opts = [[float(x), None] for x in v[idx].cpu().numpy()]
            lo_c, hi_c = _aggregate(func, v[sure], g[sure], n_groups, d_g, opts, c_lo)
        lo_cols.append(lo_c)
        hi_cols.append(hi_c)
    lo, hi = np.stack(lo_cols, 1), np.stack(hi_cols, 1)
    present = c_hi > 0
    return Expected(keys=np.nonzero(present)[0].astype(np.int64) + key["first"],
                    lo=lo[present], hi=hi[present], required=(c_lo > 0)[present],
                    kept_rows=int(count0.sum()))


def _aggregate(func, vs, gs, n_groups, d_g, opts, c_lo) -> tuple:
    """(lowest, highest) of ``func`` per group: the sure rows' values
    ``vs`` in groups ``gs`` on the device, then each doubtful row's
    options."""
    if func in ("sum", "avg"):
        s0 = torch.zeros(n_groups, dtype=torch.float64, device=vs.device).index_add_(0, gs, vs)
        s0 = s0.cpu().numpy()
        if func == "avg":
            return _avg_bounds(s0, c_lo, d_g, opts)
        s_lo, s_hi = s0.copy(), s0.copy()
        for grp, o in zip(d_g, opts):
            vals = [0.0 if x is None else x for x in o]
            s_lo[grp] += min(vals)
            s_hi[grp] += max(vals)
        return s_lo, s_hi
    big = func == "max"
    fill = -math.inf if big else math.inf
    m0 = torch.full((n_groups,), fill, dtype=torch.float64, device=vs.device)
    m0 = m0.scatter_reduce(0, gs, vs, "amax" if big else "amin").cpu().numpy()
    m_lo, m_hi = m0.copy(), m0.copy()
    for grp, o in zip(d_g, opts):
        vals = [x for x in o if x is not None]
        # the extreme can reach any value the row may take, and is forced
        # past the least extreme one only when the row surely counts
        if big:
            m_hi[grp] = max(m_hi[grp], max(vals))
            if None not in o:
                m_lo[grp] = max(m_lo[grp], min(vals))
        else:
            m_lo[grp] = min(m_lo[grp], min(vals))
            if None not in o:
                m_hi[grp] = min(m_hi[grp], max(vals))
    return m_lo, m_hi


def _avg_bounds(s0, c_lo, d_g, opts) -> tuple:
    """(lowest, highest) average per group. The sure rows, and each row that
    surely counts at its lowest (highest) value, are in; of the rows that
    may be left out, the lowest average takes a run of the smallest values
    and the highest a run of the largest, so trying every such run finds
    both ends exactly."""
    c_sure = c_lo.copy()
    by_group: dict = {}
    for grp, o in zip(d_g, opts):
        by_group.setdefault(int(grp), []).append(o)
    with np.errstate(divide="ignore", invalid="ignore"):
        lo = s0 / c_sure
    hi = lo.copy()
    for grp, rows in by_group.items():
        for pick, out in ((min, lo), (max, hi)):
            s, c = s0[grp], c_sure[grp]
            for o in rows:
                if None not in o:
                    s += pick(o)
            optional = sorted((pick(x for x in o if x is not None) for o in rows if None in o),
                              reverse=pick is max)
            best = s / c if c else None
            for v in optional:
                s, c = s + v, c + 1
                best = s / c if best is None else pick(best, s / c)
            out[grp] = best
    return lo, hi


def judge(exp: Expected, rows: list) -> tuple:
    """(wrong shape, count gap in rows, largest relative gap of any other
    aggregate) of one answer: its keys must be ascending, hold every group
    the reference requires and no group it rules out."""
    if not rows:
        return True, math.inf, math.inf
    arr = np.asarray(rows, dtype=np.float64)
    keys = arr[:, 0].astype(np.int64)
    if arr.shape[1] != exp.lo.shape[1] + 1 or np.any(np.diff(keys) <= 0):
        return True, math.inf, math.inf
    pos = np.searchsorted(exp.keys, keys)
    if np.any(pos >= len(exp.keys)) or np.any(exp.keys[np.minimum(pos, len(exp.keys) - 1)]
                                              != keys):
        return True, math.inf, math.inf
    if np.count_nonzero(exp.required[pos]) != np.count_nonzero(exp.required):
        return True, math.inf, math.inf
    got, lo, hi = arr[:, 1:], exp.lo[pos], exp.hi[pos]
    if not np.all(np.isfinite(got)):
        return True, math.inf, math.inf
    outside = np.maximum(lo - got, got - hi).clip(min=0.0)
    count_gap = float(outside[:, 0].max())
    scale = np.maximum(np.maximum(np.abs(lo[:, 1:]), np.abs(hi[:, 1:])), 1e-300)
    agg_gap = float((outside[:, 1:] / scale).max()) if got.shape[1] > 1 else 0.0
    return False, count_gap, agg_gap
