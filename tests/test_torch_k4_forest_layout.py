"""K4's forest walk inside the fused SQL kernel (``csrc/fused_sql.cu``
``forest_walk``), on the CPU.

The card walks each row's trees ``TREES_IN_FLIGHT`` at a time, level by
level, over the compact records of ``fused_sql.forest_records`` (8 bytes a
node, nodes numbered level by level, a leaf's children itself, a regressor's
leaf weight in the threshold's place) and the row's features staged once in
a tile; then it adds each group's leaf weights in tree order. A numpy model
of that walk is held here bit for bit against ``forest_plain``, the plain
version, on config 4's shape and on the trees that stress the layout, so a
change to the records or to the walk's order shows before it reaches the
card. Then the records' range checks, the choice between shared and device
memory, and one config-4-shaped query against ``infera_tpu``."""

import dataclasses
import re

import numpy as np
import pytest
import torch

import chip_smoke
import infera_tpu as it
import infera_tpu_torch as itt
from infera_tpu.columnar import Column as RefColumn
from infera_tpu.columnar import Table as RefTable
from infera_tpu.columnar import types as RT
from infera_tpu.sql import Connection as RefConnection
from infera_tpu_torch.columnar import Column, Table
from infera_tpu_torch.columnar import types as T
from infera_tpu_torch.onnx import builder, ml_ops, proto
from infera_tpu_torch.ops import _kernels
from infera_tpu_torch.ops import fused_sql as fs
from infera_tpu_torch.registry import MODELS as PORT_MODELS
from infera_tpu_torch.sql import Connection
from infera_tpu_torch.sql import device_plan as dp
from test_torch_cuda_kernels import _shuffled_tree_model


def _cu_const(name: str) -> int:
    src = (_kernels.CSRC / "fused_sql.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


# --------------------------------------------------------------------------- forests


def _model_slot(model, d_in):
    """A forest slot as the planner builds it from an ONNX tree ensemble."""
    node = model.graph.nodes[0]
    clf = node.op_type == "TreeEnsembleClassifier"
    if clf:
        n_out = len(node.attr("classlabels_int64s"))
        if n_out == 2:
            n_out = 1
    else:
        n_out = int(node.attr("n_targets", 1))
    packed = ml_ops._PackedTrees(node, n_out, "class" if clf else "target")
    tables = packed.kernel_forest(d_in)
    assert tables is not None
    slot = fs.ForestSlot(node=tables["node"], weights=packed.weights,
                         max_depth=tables["max_depth"], strict=tables["strict"],
                         features=[[(fs.COL, k)] for k in range(d_in)])
    if clf:
        slot.classifier = True
        slot.binary = n_out == 1
        slot.labels = np.asarray(node.attr("classlabels_int64s"), np.float32)
        slot.class_bias = np.linspace(-0.05, 0.05, n_out).astype(np.float32)
    return slot


def _random_slot(rng, n_trees, d_in, n_out=1, classifier=False, strict=False, out_col=0):
    """Unbalanced trees: leaves at depths 1 to 6 (tree 0's root has a leaf
    as its true child), node ids permuted per tree but for the root, leaf
    weights on a few targets or classes."""
    trees = []
    for t in range(n_trees):
        nodes = []

        def grow(depth, force_leaf=False):
            i = len(nodes)
            nodes.append(None)
            if force_leaf or depth == 6 or (depth >= 1 and rng.random() < 0.3):
                nodes[i] = (-1, 0.0, 0, 0)
                return i
            f = int(rng.integers(d_in))
            th = float(rng.standard_normal())
            a = grow(depth + 1, force_leaf=(t == 0 and depth == 0))
            b = grow(depth + 1)
            nodes[i] = (f, th, a, b)
            return i

        grow(0)
        trees.append(nodes)
    M = max(len(n) for n in trees) + 3          # unused ids past the last node
    node = np.zeros((n_trees, M, 4), np.int32)
    node[:, :, 0] = -1
    weights = np.zeros((n_trees, M, n_out), np.float32)
    depth = 0
    for t, nodes in enumerate(trees):
        perm = np.concatenate([[0], 1 + rng.permutation(M - 1)])
        for i, (f, th, a, b) in enumerate(nodes):
            k = perm[i]
            node[t, k] = (f, np.float32(th).view(np.int32), perm[a], perm[b])
            if f < 0:
                weights[t, k] = rng.standard_normal(n_out).astype(np.float32)

        def d(i):
            f, _th, a, b = nodes[i]
            return 0 if f < 0 else 1 + max(d(a), d(b))

        depth = max(depth, d(0))
    slot = fs.ForestSlot(node=node, weights=weights, max_depth=depth, strict=strict,
                         features=[[(fs.COL, k)] for k in range(d_in)], out_col=out_col)
    if classifier:
        slot.classifier = True
        slot.binary = n_out == 1
        slot.labels = (np.arange(2 if n_out == 1 else n_out) * 3 + 1).astype(np.float32)
    return slot


def _features(rng, d_in, n, nonfinite=False):
    x = rng.standard_normal((d_in, n)).astype(np.float32)
    if nonfinite:
        x[0, ::7] = np.nan
        x[1 % d_in, 3::11] = np.inf
        x[2 % d_in, 5::13] = -np.inf
        x[:, 17] = np.nan                     # a row of nothing but NaN
    return x


# --------------------------------------------------------------------------- the model


def walk_model(slot, feats, k_g=fs.TREES_IN_FLIGHT):
    """The kernel's walk over ``forest_records`` in numpy: the row's
    features staged once, a row with a non-finite feature holding NaN in
    every other feature (the one-hot rule, applied once and not at each
    node); per group of ``k_g`` trees (the last one masked), ``max_depth``
    levels, every tree of the group loading its record, then the row's
    feature from the tile (a leaf's clamped to the last feature; its
    children are itself), the compare, the child; then the group's leaf
    weights (a regressor's from its leaf record) added to the sums in tree
    order, one f32 rounding an add. Returns the sums [n_out or 1, n] f32."""
    rec, w = fs.forest_records(slot)
    n_trees = rec.shape[0]
    d_in, n = feats.shape
    cols = np.arange(n)
    bad = ~np.isfinite(feats)
    tile = np.where(bad.sum(axis=0) > bad, np.float32(np.nan), feats)
    acc = np.zeros((slot.n_out if slot.classifier else 1, n), np.float32)
    for t0 in range(0, n_trees, k_g):
        trees = np.minimum(t0 + np.arange(k_g), n_trees - 1)
        k = np.zeros((k_g, n), np.int64)
        for _ in range(slot.max_depth):
            r = rec[trees[:, None], k]                                  # [k_g, n, 2]
            f = (r[..., 1] & fs.LEAF_FEATURE).astype(np.int64)
            v = tile[np.minimum(f, d_in - 1), cols]
            th = r[..., 0].view(np.float32)
            with np.errstate(invalid="ignore"):
                go = v < th if slot.strict else v <= th
            k = np.where(go, (r[..., 1] >> 16) & 0xFF, r[..., 1] >> 24).astype(np.int64)
        for i in range(k_g):
            if t0 + i >= n_trees:
                continue
            if slot.classifier:
                leaf = w[trees[i], k[i]].T
            else:
                leaf = rec[trees[i], k[i], 0].view(np.float32)[None]
            acc = (acc + leaf).astype(np.float32)
    return acc


def _tables(slot):
    return fs._pack_forest(slot, [], 0, "cpu")[2]


def _assert_model_equals_plain(slot, feats, k_g=fs.TREES_IN_FLIGHT):
    """The model's sums and the prediction from them equal forest_plain's
    bit for bit: a regressor's value (its base and logistic in the same torch
    ops), each class sum of a classifier (forest_plain of the same forest
    read as a regressor of that column) and its label."""
    acc = walk_model(slot, feats, k_g)
    x = torch.as_tensor(feats)
    want = fs.forest_plain(slot, _tables(slot), x)
    if not slot.classifier:
        y = torch.as_tensor(acc[0]) + torch.tensor(slot.bias, dtype=torch.float32)
        y = 1.0 / (1.0 + torch.exp(-y)) if slot.logistic else y
        assert torch.equal(y, want)
        return
    for c in range(slot.n_out):
        col = dataclasses.replace(slot, classifier=False, out_col=c, bias=0.0, logistic=False,
                                  class_bias=None, binary=False, labels=None)
        got = torch.as_tensor(acc[c]) + torch.tensor(0.0, dtype=torch.float32)
        assert torch.equal(got, fs.forest_plain(col, _tables(col), x)), f"class {c}"
    scores = torch.as_tensor(acc.T.copy())
    if slot.class_bias is not None:
        scores = scores + torch.as_tensor(slot.class_bias)
    if slot.binary:
        scores = torch.cat([-scores, scores], dim=1)
    idx = torch.argmax(scores, dim=1)
    assert torch.equal(torch.as_tensor(slot.labels)[idx], want)


CONFIG4 = {
    "reg": lambda: _model_slot(builder.gbt_regressor_model(**chip_smoke.GBT), 16),
    "clf3": lambda: _model_slot(builder.gbt_classifier_model(**chip_smoke.GBC), 16),
    "reg_shuffled": lambda: _model_slot(_shuffled_tree_model(
        builder.gbt_regressor_model(**chip_smoke.GBT), 4), 16),
    "clf_shuffled_lt": lambda: _model_slot(_shuffled_tree_model(
        builder.gbt_classifier_model(**chip_smoke.GBC), 6, "BRANCH_LT"), 16),
}


@pytest.mark.parametrize("nonfinite", [False, True])
@pytest.mark.parametrize("kind", list(CONFIG4))
def test_walk_of_config4_forests_equals_plain(kind, nonfinite):
    """64 trees of depth 6 over 16 features, in heap layout and with node ids
    permuted per tree, rows with NaN and +-inf features."""
    slot = CONFIG4[kind]()
    assert (slot.n_trees, slot.max_depth, len(slot.features)) == (64, 6, 16)
    assert slot.strict == kind.endswith("_lt")
    _assert_model_equals_plain(slot, _features(np.random.default_rng(1), 16, 3000, nonfinite))


RANDOM = {
    "unbalanced": dict(n_trees=40, d_in=9),
    "strict": dict(n_trees=40, d_in=9, strict=True),
    "multi_target": dict(n_trees=24, d_in=5, n_out=3, out_col=2),
    "trees61": dict(n_trees=61, d_in=7),
    "clf3": dict(n_trees=30, d_in=6, n_out=3, classifier=True),
    "binary": dict(n_trees=30, d_in=6, n_out=1, classifier=True),
    "clf6": dict(n_trees=61, d_in=6, n_out=6, classifier=True),
}


@pytest.mark.parametrize("k_g", [4, fs.TREES_IN_FLIGHT])
@pytest.mark.parametrize("kind", list(RANDOM))
def test_walk_of_unbalanced_forests_equals_plain(kind, k_g):
    """Leaves at depths 1 to 6, permuted ids with unused ones between them,
    a strict forest, a multi-target regressor keeping column 2, 61 trees
    (the last group masked), classifiers of 3, 1 (binary) and 6 classes;
    rows with non-finite features; groups of 4 and of TREES_IN_FLIGHT."""
    rng = np.random.default_rng(sorted(RANDOM).index(kind))
    slot = _random_slot(rng, **RANDOM[kind])
    depths = _leaf_depths(slot)
    assert min(depths) == 1 and max(depths) == 6
    _assert_model_equals_plain(slot, _features(rng, len(slot.features), 2000, True), k_g)


def _leaf_depths(slot):
    out = []
    for t in range(slot.n_trees):
        stack = [(0, 0)]
        while stack:
            nd, d = stack.pop()
            if slot.node[t, nd, 0] < 0:
                out.append(d)
            else:
                stack += [(slot.node[t, nd, 2], d + 1), (slot.node[t, nd, 3], d + 1)]
    return out


# --------------------------------------------------------------------------- the records


def test_records_number_each_level_in_one_run():
    """A heap-layout tree keeps its ids; a permuted one is numbered level by
    level again, so a level of a tree is one run of records; a leaf's
    children are itself and a regressor's leaf holds its weight."""
    slot = CONFIG4["reg"]()
    shuffled = CONFIG4["reg_shuffled"]()
    rec, w = fs.forest_records(slot)
    rec2, _ = fs.forest_records(shuffled)
    assert w is None and rec.shape == (64, 127, 2) and rec.dtype == np.uint32
    assert np.array_equal(rec, rec2)
    feat = rec[..., 1] & 0xFFFF
    tc, fc = (rec[..., 1] >> 16) & 0xFF, rec[..., 1] >> 24
    j = np.arange(127)
    internal = j < 63
    assert (feat[:, ~internal] == fs.LEAF_FEATURE).all() and (feat[:, internal] < 16).all()
    assert (tc[:, internal] == 2 * j[internal] + 1).all()
    assert (fc[:, internal] == 2 * j[internal] + 2).all()
    assert (tc[:, ~internal] == j[~internal]).all() and (fc[:, ~internal] == j[~internal]).all()
    assert np.array_equal(rec[:, ~internal, 0].view(np.float32), slot.weights[:, 63:, 0])
    assert np.array_equal(rec[:, internal, 0].view(np.int32), slot.node[:, :63, 1])
    # D's tables are the records alone: 64 x 127 x 8 B
    assert slot.smem_bytes() == (65024, 0)
    clf = CONFIG4["clf3"]()
    assert clf.smem_bytes() == (65024, 64 * 127 * 3 * 4)


def test_records_refuse_what_does_not_fit_their_fields():
    """A child past 255 (a tree of 511 nodes) or a feature past 65,534
    raises; nothing wraps."""
    node = np.zeros((1, 511, 4), np.int32)
    node[:, :, 0] = -1
    node[0, :255, 0] = 0
    node[0, :255, 2] = 2 * np.arange(255) + 1
    node[0, :255, 3] = 2 * np.arange(255) + 2
    deep = fs.ForestSlot(node=node, weights=np.zeros((1, 511, 1), np.float32), max_depth=8,
                         strict=False, features=[[(fs.COL, 0)]])
    with pytest.raises(ValueError, match="256"):
        fs.forest_records(deep)
    wide = fs.ForestSlot(node=np.array([[[65535, 0, 1, 2], [-1, 0, 0, 0], [-1, 0, 0, 0]]],
                                       np.int32),
                         weights=np.zeros((1, 3, 1), np.float32), max_depth=1, strict=False,
                         features=[[(fs.COL, 0)]])
    with pytest.raises(ValueError, match="65534"):
        fs.forest_records(wide)
    ok = dataclasses.replace(wide, node=wide.node.copy())
    ok.node[0, 0, 0] = 65534
    assert (fs.forest_records(ok)[0][0, 0, 1] & 0xFFFF) == 65534


def test_source_shares_the_walk_constants():
    assert _cu_const("kTreesInFlight") == fs.TREES_IN_FLIGHT
    assert _cu_const("kOutChunk") == fs.OUT_CHUNK
    assert _cu_const("kSlotDesc") == fs._SLOT_DESC
    src = (_kernels.CSRC / "fused_sql.cu").read_text()
    assert "constexpr unsigned kLeaf = 0xFFFFu;" in src
    assert re.search(r"F_FEAT, F_LABEL_OFF, F_REC_SMEM, F_W_SMEM\s*\}", src)
    assert fs.F_REC_SMEM == 14 and fs.F_W_SMEM == 15 and fs._SLOT_DESC == 17
    assert re.search(r"H_SM_TOTAL,\s*H_SM_FTILE\s*//[^\n]*\n\s*\};", src)
    assert fs.H_FTILE == 43 < fs._HEADER
    # the walk reads the tile and adds the leaves with __fadd_rn
    walk = src[src.index("__device__ void forest_walk("):src.index("// jnp.argmax over scores")]
    assert "__fadd_rn" in walk and "row_feature<kTile>(x, nd[i].y & kLeaf)" in walk


# --------------------------------------------------------------------------- the route


def _plans(monkeypatch, tmp_path, queries, extra_models=()):
    """The port's plans of ``queries`` over chip_smoke's config-4 table (at
    MIN_DEVICE_ROWS rows), on the CPU with the kernel tier on."""
    monkeypatch.setenv("INFERA_PALLAS_SQL", "1")
    itt.set_device("cpu")
    PORT_MODELS.clear()
    models = [("gbt", builder.gbt_regressor_model(**chip_smoke.GBT)),
              ("gbc", builder.gbt_classifier_model(**chip_smoke.GBC)), *extra_models]
    for name, m in models:
        proto.save_model_file(m, tmp_path / f"{name}.onnx")
        itt.load_model(name, str(tmp_path / f"{name}.onnx"))
    n = dp.MIN_DEVICE_ROWS
    x = np.random.default_rng(1).standard_normal((n, 16)).astype(np.float32)
    conn = Connection()
    cols = {f"c{k}": Column(np.ascontiguousarray(x[:, k]), T.FLOAT) for k in range(16)}
    cols["g"] = Column(np.arange(n, dtype=np.int64) % 64, T.BIGINT)
    conn.register_table("wide", Table(cols))
    plans = {}
    for key, q in queries.items():
        conn.execute(q)
        assert conn._exec_path == "device_plan_cuda"
        plans[key] = list(conn._device_plan_cache.values())[-1][1]
    return plans


def test_d_and_e_walk_from_shared_memory_at_two_blocks_an_sm(clean_registry, monkeypatch,
                                                              tmp_path):
    """Queries D and E: the feature tile (16 KB), the records (65,024 B) in
    shared memory, E's leaf weights (97,536 B) in device memory, and each
    plan within one block's share of an SM that two blocks share."""
    try:
        plans = _plans(monkeypatch, tmp_path, {"D": chip_smoke.SQL_D, "E": chip_smoke.SQL_E})
        for key, packed in plans.items():
            lay = packed.smem
            (slot,) = packed.plan.forests
            rec, w = lay["forests"][0]
            assert lay["ftile"] >= 0 and rec >= 0 and w == -1
            assert packed.smem_bytes <= fs.TWO_BLOCK_SMEM, key
            assert 80_000 < packed.smem_bytes
            words = packed.words.numpy()
            d = words[words[fs.H_PREDS]:][:fs._SLOT_DESC]
            assert (d[fs.F_REC_SMEM], d[fs.F_W_SMEM], d[fs.F_NODES]) == (rec, -1, 127)
            assert words[fs.H_FTILE] == lay["ftile"]
            assert fs.forest_routes(packed) == [{"records": "shared", "weights":
                                                 "shared" if key == "D" else "device",
                                                 "features": "tile"}]
    finally:
        PORT_MODELS.clear()
        itt.set_device(None)


def test_a_512_tree_forest_walks_from_device_memory(clean_registry, monkeypatch, tmp_path):
    """512 trees of depth 6 (over 8 features, inside kernel_forest's 2 MiB
    strip limit) are 520 KB of records: they stay in device memory, the plan
    keeps its feature tile and K2 still takes it."""
    big = builder.gbt_regressor_model(**chip_smoke.GBT512)
    try:
        (packed,) = _plans(monkeypatch, tmp_path, {"big": chip_smoke.SQL_D512},
                           [("gbt512", big)]).values()
        assert fs.smem_fits(packed.plan)
        assert packed.smem["forests"] == [(-1, -1)] and packed.smem["ftile"] >= 0
        assert fs.forest_routes(packed)[0]["records"] == "device"
        assert packed.plan.forests[0].smem_bytes()[0] == 512 * 127 * 8
    finally:
        PORT_MODELS.clear()
        itt.set_device(None)


def _full_forest_plan(n_trees, d_in=16, depth=6):
    """A plan of one regressor of full trees (config 4's shape at 64)."""
    m = 2 ** (depth + 1) - 1
    node = np.zeros((n_trees, m, 4), np.int32)
    inner = np.arange(m // 2)
    node[:, :, 0] = -1
    node[:, inner, 0] = inner % d_in
    node[:, inner, 2], node[:, inner, 3] = 2 * inner + 1, 2 * inner + 2
    slot = fs.ForestSlot(node=node, weights=np.ones((n_trees, m, 1), np.float32),
                         max_depth=depth, strict=False,
                         features=[[(fs.COL, k)] for k in range(d_in)])
    return fs.FusedPlan(where=None, keys=[[(fs.COL, 0)]], sums=[[(fs.PRED, 0)]], mins=[],
                        maxs=[], strides=[1], n_groups=64, preds=[slot])


@pytest.mark.parametrize("n_trees,route", [(64, "shared"), (91, "shared"), (92, "device"),
                                           (128, "device")])
def test_records_take_shared_memory_only_at_two_blocks_an_sm(n_trees, route):
    """Depth-6 forests over 16 features: the records go to shared memory
    while the plan still fits two blocks an SM with them (up to 91 trees),
    else to device memory, where two blocks walk them; either way K2 takes
    the plan and keeps its feature tile."""
    plan = _full_forest_plan(n_trees)
    lay = fs.smem_layout(plan, *fs._sizes(plan))
    (rec, _w), = lay["forests"]
    assert (rec >= 0) == (route == "shared") and lay["ftile"] >= 0 and fs.smem_fits(plan)
    assert lay["total"] <= fs.TWO_BLOCK_SMEM
    packed = fs.pack_plan(plan, "cpu")
    assert fs.forest_routes(packed)[0]["records"] == route


def test_layout_of_wide_classifiers_and_wide_inputs():
    """A 6-class forest takes no shared memory for its class sums (a walk per
    four classes keeps them in registers); a forest whose feature tile would
    not fit runs each node's program (no tile) and walks its records from
    device memory."""
    rng = np.random.default_rng(3)
    clf6 = _random_slot(rng, n_trees=8, d_in=6, n_out=6, classifier=True)
    plan = fs.FusedPlan(where=None, keys=[], sums=[[(fs.PRED, 0)]], mins=[], maxs=[],
                        strides=[], n_groups=1, preds=[clf6])
    lay = fs.smem_layout(plan, *fs._sizes(plan))
    rec_bytes, w_bytes = clf6.smem_bytes()
    (rec, w), = lay["forests"]
    assert rec == lay["ftile"] + fs._align16(4 * 6 * fs.SLOT_ROWS) and w == rec + rec_bytes
    assert lay["total"] == w + fs._align16(w_bytes)
    wide = _random_slot(rng, n_trees=4, d_in=240, n_out=1)
    plan = fs.FusedPlan(where=None, keys=[], sums=[[(fs.PRED, 0)]], mins=[], maxs=[],
                        strides=[], n_groups=1, preds=[wide])
    lay = fs.smem_layout(plan, *fs._sizes(plan))
    assert lay["ftile"] == -1 and lay["forests"] == [(-1, -1)] and fs.smem_fits(plan)
    packed = fs.pack_plan(plan, "cpu")
    assert fs.forest_routes(packed) == [{"records": "device", "weights": "device",
                                         "features": "programs"}]


# --------------------------------------------------------------------------- against infera_tpu


@pytest.mark.parametrize("query", ["D", "E"])
def test_config4_query_matches_infera_tpu(clean_registry, monkeypatch, tmp_path, query):
    """chip_smoke's query D or E over its config-4 forest, at MIN_DEVICE_ROWS
    rows: the port's kernel tier (K2's plain version on the CPU) against
    infera_tpu's device_plan_pallas (its Pallas kernel in interpret mode):
    rows rel 1e-5, labels exact."""
    monkeypatch.setenv("INFERA_PALLAS_SQL", "1")
    itt.set_device("cpu")
    PORT_MODELS.clear()
    try:
        n = dp.MIN_DEVICE_ROWS
        x = np.random.default_rng(1).standard_normal((n, 16)).astype(np.float32)
        g = np.arange(n, dtype=np.int64) % 64
        port, ref = Connection(), RefConnection()
        port.register_table("wide", Table({**{f"c{k}": Column(np.ascontiguousarray(x[:, k]),
                                                               T.FLOAT) for k in range(16)},
                                           "g": Column(g, T.BIGINT)}))
        ref.register_table("wide", RefTable({**{f"c{k}": RefColumn(np.ascontiguousarray(
            x[:, k]), RT.FLOAT) for k in range(16)}, "g": RefColumn(g, RT.BIGINT)}))
        model = builder.gbt_regressor_model(**chip_smoke.GBT) if query == "D" else \
            builder.gbt_classifier_model(**chip_smoke.GBC)
        name = "gbt" if query == "D" else "gbc"
        proto.save_model_file(model, tmp_path / f"{name}.onnx")
        it.load_model(name, str(tmp_path / f"{name}.onnx"))
        itt.load_model(name, str(tmp_path / f"{name}.onnx"))
        q = chip_smoke.SQL_D if query == "D" else chip_smoke.SQL_E
        rows = port.execute(q).rows
        assert port._exec_path == "device_plan_cuda"
        want = ref.execute(q).rows
        assert ref._exec_path == "device_plan_pallas"
        assert len(rows) == len(want) > 0
        for a, b in zip(rows, want):
            assert a[:2] == b[:2]
            if query == "E":
                assert a == b
            else:
                np.testing.assert_allclose(a[2:], b[2:], rtol=1e-5)
    finally:
        PORT_MODELS.clear()
        itt.set_device(None)
