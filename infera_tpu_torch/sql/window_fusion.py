"""Windowed-subquery fusion: the port's copy of
``infera_tpu/sql/window_fusion.py``.

The classic analytics shape

    SELECT g, avg(w) FROM (
        SELECT g, sum(v) OVER (PARTITION BY p ORDER BY k) AS w FROM t
    ) sub GROUP BY g

would execute the inner projection on the host (windows materialize all
[n] rows) before the outer aggregate could fuse. This module flattens the
subquery into the outer SELECT — window expressions substitute into the
aggregate arguments — so the whole query lowers through
``sql/device_plan``: the window computes on the device inside the torch
program (one stable sort and segmented scans, ``_Lowerer._lower_window``)
and only the [G] group table returns to the host. The standalone route of
``ops/window.py`` (``INFERA_WINDOW_DEVICE``) stays opt-in because its
[n]-row result comes back; here the consumer is fused.

Eligibility is conservative; any ineligible shape returns None and the
host path keeps full semantics.
"""

from __future__ import annotations

import copy
import dataclasses

from . import ast as A


def _contains_window(e) -> bool:
    return A.contains_node(e, lambda x: isinstance(x, A.WindowFunc))


def _rewrite(e, mapping: dict, sub_names: set, star: bool):
    """Substitute subquery output names with their defining expressions.
    Raises KeyError when a reference cannot be resolved (no mapping entry
    and no passthrough Star)."""
    if isinstance(e, A.ColumnRef):
        qual = e.table.lower() if e.table else None
        if qual is None or qual in sub_names:
            repl = mapping.get(e.name.lower())
            if repl is not None:
                return copy.deepcopy(repl)
            if not star:
                raise KeyError(e.name)
            # passthrough base column: strip the subquery alias
            return A.ColumnRef(e.name, None)
        # a qualifier that is NOT the subquery alias cannot be valid
        # through the subquery boundary — flattening would silently bind
        # it against the base table while the host path raises the
        # Binder Error
        raise KeyError(f"{e.table}.{e.name}")
    if not dataclasses.is_dataclass(e) or not isinstance(e, A.Expr):
        return e
    kwargs = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, A.Expr):
            kwargs[f.name] = _rewrite(v, mapping, sub_names, star)
        elif isinstance(v, list):
            kwargs[f.name] = [
                _rewrite(x, mapping, sub_names, star)
                if isinstance(x, A.Expr) else
                A.OrderItem(_rewrite(x.expr, mapping, sub_names, star),
                            x.ascending, x.nulls_first)
                if isinstance(x, A.OrderItem) else x
                for x in v]
        else:
            kwargs[f.name] = v
    return type(e)(**kwargs)


def flatten_windowed_scan(sel: A.Select):
    """Rewritten Select over the base table, or None when ineligible."""
    sub = sel.from_
    if not isinstance(sub, A.SubqueryRef) or sub.column_aliases:
        return None
    inner = sub.query
    if not isinstance(inner, A.Select):
        return None
    if not isinstance(inner.from_, (A.BaseTable, A.TableFunction)):
        return None
    if (inner.where is not None or inner.group_by or inner.having
            or inner.distinct or inner.order_by
            or inner.limit is not None or inner.offset is not None
            or getattr(inner, "group_sets", None)
            or getattr(sel, "group_sets", None)):
        return None
    mapping: dict = {}
    star = False
    has_window = False
    for item in inner.items:
        e = item.expr
        if isinstance(e, A.Star):
            if e.table is not None:
                return None
            star = True
            continue
        name = item.alias or (e.name if isinstance(e, A.ColumnRef) else None)
        if name is None:
            return None
        mapping[name.lower()] = e
        if _contains_window(e):
            has_window = True
    if not has_window:
        return None  # plain subqueries keep their existing execution
    sub_names = {sub.alias.lower()} if sub.alias else set()

    try:
        items = [A.SelectItem(
            _rewrite(i.expr, mapping, sub_names, star), i.alias)
            for i in sel.items]
        where = (None if sel.where is None
                 else _rewrite(sel.where, mapping, sub_names, star))
        group_by = [_rewrite(g, mapping, sub_names, star)
                    for g in sel.group_by]
        having = (None if sel.having is None
                  else _rewrite(sel.having, mapping, sub_names, star))
        order_by = [A.OrderItem(
            _rewrite(oi.expr, mapping, sub_names, star),
            oi.ascending, oi.nulls_first) for oi in sel.order_by]
    except KeyError:
        return None
    # window expressions may only appear inside aggregate arguments /
    # group keys of the flattened query (the fused plan computes them
    # per-row before the aggregate tail); a bare windowed select item
    # would need the [n]-row output — keep those on the host
    return A.Select(items=items, from_=inner.from_, where=where,
                    group_by=group_by, having=having, order_by=order_by,
                    limit=sel.limit, offset=sel.offset,
                    distinct=sel.distinct)
