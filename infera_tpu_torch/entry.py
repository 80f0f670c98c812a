"""Entry points: one forward step and a dry run of every parallel form.

Counterpart of ``__graft_entry__.py``.

- ``entry()`` -> (fn, args): the forward step of config 2's MLP
  (32 -> 128 -> 128 -> 16) through the ONNX engine, over 1,024 seeded rows.
- ``dryrun_multichip(n_devices)``: builds ``(dp, mp)`` meshes of
  ``n_devices`` shards and runs one step of each parallel form with the
  reference's asserts: 1, the data-parallel query step (sharded inference,
  filter, ``all_to_all`` shuffle with the skew split, grouped aggregate,
  ``psum``) and SQL on a meshed ``Connection`` (the mesh tiers
  ``device_plan_mesh``, ``device_join_plan_mesh`` and ``shuffle_join_mesh``;
  MODE, HLL, windows and ``string_agg``), each answer held to host math;
  2, tensor parallel; 3, pipeline parallel; 4, expert parallel; 5, ring
  attention. A section fails by raising.

Both run on the port's device (the card unless the caller asks for the CPU,
``device="cpu"``); on one card the shards are logical, all on ``cuda:0``.

    python -m infera_tpu_torch.entry [N_DEVICES] [--cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def entry(device=None):
    """(forward, (x,)): config 2's MLP compiled by the port's ONNX engine on
    ``device`` (default: the port's device), and 1,024 rows of 32 features
    from ``default_rng(0)``."""
    from .device import using_device
    from .onnx import builder
    from .onnx.executor import compile_model_bytes

    with using_device(device) as dev:
        model = compile_model_bytes(
            builder.mlp_model(in_dim=32, hidden=(128, 128), out_dim=16).serialize(), "mlp",
            device=dev)

    def forward(x):
        return model._run_graph(x)[0]

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1024, 32)).astype(np.float32)).to(dev)
    return forward, (x,)


def _f32(rng, shape, scale=None):
    a = rng.standard_normal(shape).astype(np.float32)
    return a * np.float32(scale) if scale is not None else a


def _dp_and_sql(mesh, n_devices: int) -> None:
    import tempfile

    from .onnx.builder import write_reference_test_models
    from .parallel.pipeline import example_inputs, make_distributed_query_step
    from .registry import MODELS
    from .sql import Connection
    from .sql.device_plan import MIN_DEVICE_ROWS

    # 1. dp: the whole distributed query step at real per-shard row counts
    n_rows = 4096 * n_devices
    n_groups = 8
    cap = n_rows // n_devices  # exact capacity (worst-case skew)
    step = make_distributed_query_step(mesh, n_groups=n_groups, cap=cap, skew_split=True)
    params, x, keys = example_inputs(mesh, n_rows, in_dim=8, out_dim=4, n_groups=n_groups)
    sums, counts, total = (t.cpu().numpy() for t in step(params, x, keys))
    assert sums.shape == (n_groups,) and counts.shape == (n_groups,)
    assert np.isfinite(sums).all() and np.isfinite(counts).all()
    assert 0.0 <= float(total) <= n_rows

    # 1b. a SQL statement through Connection.execute on the mesh: the fused
    # group-by with infera_predict over the partial-table exchange, held to
    # the host's answer
    with tempfile.TemporaryDirectory() as models:
        write_reference_test_models(models)
        conn = Connection()
        conn.set_mesh(mesh)
        n_sql = MIN_DEVICE_ROWS * 2 + 7  # not divisible by the mesh
        conn.execute(f"select infera_load_model('linear', '{models}/linear.onnx')")
        conn.execute(
            f"create table obs as select x % 5 as g, "
            f"2199023255553 + x as v, (x * x) % 61 as dv, "
            f"(x % 100)::float / 10.0 as f1, ((x + 3) % 50)::float / 5.0 as f2, "
            f"((x * 7) % 30)::float / 3.0 as f3 from range({n_sql}) r(x)")
        q = ("select g, count(*) c, avg(infera_predict('linear', f1, f2, f3)) p "
             "from obs where f1 > 2.0 group by g order by g")
        rows = conn.execute(q).rows
        assert conn._exec_path == "device_plan_mesh", conn._exec_path
        assert len(rows) == 5 and sum(r[1] for r in rows) < n_sql
        # exact and decomposed aggregates ride the same exchange: int64 sums
        # past 2^53, stddev partials, the DISTINCT presence matrix
        erows = conn.execute(
            "select g, sum(v) s, stddev(f1) sd, count(distinct dv) dc "
            "from obs group by g order by g").rows
        assert conn._exec_path == "device_plan_mesh", conn._exec_path
        xs = np.arange(n_sql, dtype=np.int64)
        f1h = (xs % 100).astype(np.float32) / np.float32(10.0)
        for key, s, sd, dc in erows:
            m = (xs % 5) == key
            assert s == sum(2199023255553 + int(i) for i in xs[m])
            assert abs(sd - float(np.std(f1h[m], ddof=1))) <= 1e-3 * sd
            assert dc == len(np.unique(((xs * xs) % 61)[m]))
        host = Connection()
        host.catalog = conn.catalog
        host.set_mesh(None)
        hrows = host.execute(q).rows
        assert [r[:2] for r in rows] == [r[:2] for r in hrows]
        assert all(abs(a[2] - b[2]) <= 1e-4 * max(1.0, abs(b[2])) for a, b in zip(rows, hrows))

        # 1c. an outer join across the exchange, a median, and a big x big
        # duplicate-key join through the pre-aggregated shuffle join
        conn.execute("create table dim as select x as k, (x * 2)::float as w from range(60) r(x)")
        conn.execute(f"create table fact as select x % 100 as k, "
                     f"(x % 40)::float / 4.0 as v from range({n_sql}) r(x)")
        orows = conn.execute("select count(*) c, count(w) cw, avg(w) aw "
                             "from fact left join dim on fact.k = dim.k").rows
        assert conn._exec_path == "device_join_plan_mesh", conn._exec_path
        ks = xs % 100
        matched = ks < 60
        c, cw, aw = orows[0]
        assert c == n_sql and cw == int(matched.sum())
        assert abs(aw - float((ks[matched] * 2.0).mean())) < 1e-5 * aw
        mrows = conn.execute("select median(v) from fact").rows
        assert conn._exec_path == "device_plan_mesh", conn._exec_path
        vh = (xs % 40) / 4.0
        assert abs(mrows[0][0] - float(np.median(vh))) < 1e-6
        conn.execute(f"create table fb as select (x * 3) % 120 as k, "
                     f"(x % 90)::float / 9.0 as w from range({n_sql}) r(x)")
        srows = conn.execute("select count(*) c, sum(w) sw, sum(v * w) svw from fact "
                             "join fb on fact.k = fb.k").rows
        assert conn._exec_path == "shuffle_join_mesh", conn._exec_path
        kb = (xs * 3) % 120
        wb = (xs % 90) / 9.0
        cntb = np.bincount(kb, minlength=128)
        swb = np.zeros(128)
        np.add.at(swb, kb, wb)
        assert srows[0][0] == int(cntb[ks].sum())  # exact pair count
        assert abs(srows[0][1] - float(swb[ks].sum())) <= 1e-6 * abs(float(swb[ks].sum()))
        vwant = float((vh * swb[ks]).sum())
        assert abs(srows[0][2] - vwant) <= 1e-6 * abs(vwant)

        # 1d. MODE over the probed-domain counts, HLL registers across the
        # exchange, a windowed subquery, and string_agg on the host
        mrows2 = conn.execute("select g, mode(dv) m, approx_count_distinct(dv) a from obs "
                              "group by g order by g").rows
        assert conn._exec_path == "device_plan_mesh", conn._exec_path
        dvh = (xs * xs) % 61
        for key, mv, appx in mrows2:
            m = (xs % 5) == key
            vals, cnts = np.unique(dvh[m], return_counts=True)
            assert cnts[vals == mv][0] == cnts.max()
            assert abs(appx - len(vals)) <= max(2, 0.05 * len(vals))
        wrows = conn.execute(
            "select g, avg(w) from (select g, sum(f1) over (partition by "
            "dv order by f2, f1) as w from obs) sub group by g order by g").rows
        assert len(wrows) == 5 and all(r[1] > 0 for r in wrows)
        conn.execute("create table sg as select x % 3 as g, 's' || x as s from range(9) r(x)")
        grows = conn.execute("select g, string_agg(s, ',') from sg group by g order by g").rows
        assert grows[0][1] == "s0,s3,s6" and grows[2][1] == "s2,s5,s8"
        MODELS.clear()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One step of each parallel form on ``n_devices``-shard meshes of
    ``device`` (default: the port's device), with the reference's asserts."""
    from .device import using_device
    from .parallel.mesh import make_mesh
    from .parallel.pipeline import (
        make_ep_inference_step,
        make_pp_inference_step,
        make_tp_inference_step,
    )
    from .parallel.ring_attention import make_ring_attention_step

    with using_device(device) as dev:
        _dp_and_sql(make_mesh(n_devices, device=dev), n_devices)
        if n_devices < 2:
            return
        rng = np.random.default_rng(0)

        # 2. tp: the Megatron column/row-sharded MLP on the mp axis
        mp = 2 if n_devices % 2 == 0 else n_devices
        mesh_tp = make_mesh(n_devices, mp=mp, device=dev)
        d_in, hidden, d_out = 8, 4 * mp, 4
        w1 = _f32(rng, (d_in, hidden))
        b1 = np.zeros(hidden, np.float32)
        w2 = _f32(rng, (hidden, d_out))
        b2 = np.zeros(d_out, np.float32)
        xt = _f32(rng, (mesh_tp.shape["dp"] * 4, d_in))
        y_tp = make_tp_inference_step(mesh_tp)(((w1, b1), (w2, b2)), xt).cpu().numpy()
        assert y_tp.shape == (xt.shape[0], d_out) and np.isfinite(y_tp).all()

        # 3. pp: the GPipe microbatch pipeline, one stage an mp shard
        n_stages = mp
        mesh_pp = make_mesh(n_devices, mp=n_stages, device=dev)
        d = 8
        W = _f32(rng, (n_stages, d, d), 0.3)
        B = np.zeros((n_stages, d), np.float32)
        xp = _f32(rng, (3, 4, d))
        y_pp = make_pp_inference_step(mesh_pp, n_stages, n_micro=3)((W, B), xp).cpu().numpy()
        assert y_pp.shape == xp.shape and np.isfinite(y_pp).all()

        # 4. ep: MoE-style expert routing through all_to_all on the mp axis
        n_experts = mp
        mesh_ep = make_mesh(n_devices, mp=n_experts, device=dev)
        EW = _f32(rng, (n_experts, d, d), 0.3)
        EB = np.zeros((n_experts, d), np.float32)
        n_tok = 8 * n_experts
        xe = _f32(rng, (n_tok, d))
        eid = rng.integers(0, n_experts, n_tok).astype(np.int32)
        y_ep, routed = make_ep_inference_step(mesh_ep, n_experts, cap=n_tok)(EW, EB, xe, eid)
        assert tuple(y_ep.shape) == (n_tok, d)
        assert int(routed) == n_tok

        # 5. sp: sequence-parallel ring attention at a real sequence length
        mesh_sp = make_mesh(n_devices, mp=mp, device=dev)
        seq = max(1024, 8 * mp)
        q, kk, vv = (_f32(rng, (seq, d)) for _ in range(3))
        y_sp = make_ring_attention_step(mesh_sp, causal=True)(q, kk, vv).cpu().numpy()
        assert y_sp.shape == (seq, d) and np.isfinite(y_sp).all()


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    n = int(next((a for a in argv if not a.startswith("-")), 8))
    dryrun_multichip(n, device="cpu" if "--cpu" in argv else None)
    print(f"dryrun_multichip({n}) passed")


if __name__ == "__main__":
    main()
