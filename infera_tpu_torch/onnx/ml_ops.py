"""ai.onnx.ml operators in PyTorch (TreeEnsemble*, Linear*, Scaler, ...).

Counterpart of ``infera_tpu/onnx/ml_ops.py``; the numpy table builders of
``_PackedTrees`` are copied unchanged. An ensemble evaluates one of two ways:

1. **GEMM evaluation** (default for ensembles that fit): the whole forest is
   three batched matmuls per row tile (Hummingbird-style). ``X @ A`` gathers
   every tested feature value through a one-hot selection matrix (exact: one
   1.0 coefficient per column, and TF32 is off), a comparison against the
   threshold vector gives the 0/1 decision vector ``S``, ``S @ C`` scores
   every leaf against its root-to-leaf path (+1 true ancestor, -1 false
   ancestor), and the unique leaf whose score equals its count of true
   ancestors is dotted with the leaf-weight table. Integer-valued f32
   arithmetic keeps it exact against the traversal. A non-finite feature
   reaches every node through the one-hot product (``inf * 0`` is NaN), so
   a row holding one sees NaN at every node that tests another feature, as
   in ``infera_tpu``.

2. **Gather-based level-synchronous traversal** (for forests too large for
   the GEMM tables): node tables packed into dense [n_trees, max_nodes]
   matrices; ``max_depth`` steps of gathers, no data-dependent control flow.

Selection: ``INFERA_TREE_MODE`` = ``auto`` (default) | ``gemm`` | ``gather``,
read at every evaluation.

The SQL kernel tier runs the forest inside K2 as kernel K4
(``ops/fused_sql.py``) over the walk tables of ``_PackedTrees.kernel_forest``;
it takes every forest that ``infera_tpu``'s strip packing
(``_build_pallas_forest``, copied here for its refusals) takes.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..errors import OnnxError
from .ops import register

# branch-mode codes for the packed node table
_MODES = {
    "BRANCH_LEQ": 0,
    "BRANCH_LT": 1,
    "BRANCH_GTE": 2,
    "BRANCH_GT": 3,
    "BRANCH_EQ": 4,
    "BRANCH_NEQ": 5,
    "LEAF": 6,
}


def _branch(md: torch.Tensor, xv: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    """The decision of each node under its branch mode; False for a leaf."""
    out = torch.zeros_like(xv, dtype=torch.bool)
    for code, cmp in ((0, torch.le), (1, torch.lt), (2, torch.ge), (3, torch.gt),
                      (4, torch.eq), (5, torch.ne)):
        out = torch.where(md == code, cmp(xv, th), out)
    return out


class _PackedTrees:
    """Dense node tables for one tree ensemble."""

    def __init__(self, node, n_out: int, weights_key: str):
        tree_ids = np.asarray(node.attr("nodes_treeids"), np.int64)
        node_ids = np.asarray(node.attr("nodes_nodeids"), np.int64)
        feats = np.asarray(node.attr("nodes_featureids"), np.int64)
        modes = [m if isinstance(m, str) else m.decode() for m in node.attr("nodes_modes")]
        values = np.asarray(node.attr("nodes_values"), np.float32)
        true_ids = np.asarray(node.attr("nodes_truenodeids"), np.int64)
        false_ids = np.asarray(node.attr("nodes_falsenodeids"), np.int64)

        trees = np.unique(tree_ids)
        self.n_trees = len(trees)
        tree_index = {t: i for i, t in enumerate(trees)}
        max_nodes = int(node_ids.max()) + 1 if len(node_ids) else 1

        shape = (self.n_trees, max_nodes)
        self.feature = np.zeros(shape, np.int32)
        self.threshold = np.zeros(shape, np.float32)
        self.true_child = np.zeros(shape, np.int32)
        self.false_child = np.zeros(shape, np.int32)
        self.mode = np.full(shape, _MODES["LEAF"], np.int32)

        for k in range(len(tree_ids)):
            t = tree_index[tree_ids[k]]
            nd = node_ids[k]
            self.feature[t, nd] = feats[k]
            self.threshold[t, nd] = values[k]
            self.true_child[t, nd] = true_ids[k]
            self.false_child[t, nd] = false_ids[k]
            m = modes[k]
            if m not in _MODES:
                raise OnnxError(f"unsupported tree branch mode {m}")
            self.mode[t, nd] = _MODES[m]

        # leaf payout table [n_trees, max_nodes, n_out]
        w_tree = np.asarray(node.attr(f"{weights_key}_treeids"), np.int64)
        w_node = np.asarray(node.attr(f"{weights_key}_nodeids"), np.int64)
        w_id = np.asarray(node.attr(f"{weights_key}_ids"), np.int64)
        w_val = np.asarray(node.attr(f"{weights_key}_weights"), np.float32)
        self.weights = np.zeros((self.n_trees, max_nodes, n_out), np.float32)
        for k in range(len(w_tree)):
            t = tree_index[w_tree[k]]
            self.weights[t, w_node[k], w_id[k]] += w_val[k]

        # max depth bound: a binary tree with M nodes has depth <= M, but
        # realistic exports are balanced; walk to compute the true depth.
        self.max_depth = self._compute_depth(max_nodes)
        self.max_nodes = max_nodes

        # Heap-layout detection: when every internal node's children are
        # 2i+1 / 2i+2 (complete trees — the layout xgboost/sklearn exports
        # and our builder emit), child ids come from arithmetic instead of
        # two table gathers per level (~40% of traversal gathers saved).
        internal = self.mode != _MODES["LEAF"]
        idx = np.arange(max_nodes)[None, :]
        self.heap_layout = bool(
            np.all(np.where(internal, self.true_child == 2 * idx + 1, True))
            and np.all(np.where(internal, self.false_child == 2 * idx + 2, True))
        )
        self._device_tables: dict = {}

    def _compute_depth(self, max_nodes: int) -> int:
        depth = np.zeros((self.n_trees, max_nodes), np.int32)
        maxd = 0
        for t in range(self.n_trees):
            # BFS from root 0
            frontier = [0]
            d = 0
            seen = set()
            while frontier and d <= max_nodes:
                nxt = []
                for nd in frontier:
                    if nd in seen:
                        continue
                    seen.add(nd)
                    if self.mode[t, nd] != _MODES["LEAF"]:
                        nxt.append(int(self.true_child[t, nd]))
                        nxt.append(int(self.false_child[t, nd]))
                frontier = nxt
                if frontier:
                    d += 1
            maxd = max(maxd, d)
        del depth
        return maxd

    def _on(self, key, device: torch.device, build):
        """A torch copy of some tables on ``device``, built once per device."""
        ent = self._device_tables.get((key, device))
        if ent is None:
            ent = build()
            self._device_tables[(key, device)] = ent
        return ent

    def traverse(self, x: torch.Tensor) -> torch.Tensor:
        """Level-synchronous traversal. x: [N, d] → leaf node ids [N, T]."""
        dev = x.device
        t_feature, t_threshold, t_true, t_false, t_mode = self._on(
            "walk", dev, lambda: tuple(
                torch.as_tensor(a.reshape(-1), device=dev)
                for a in (self.feature.astype(np.int64), self.threshold,
                          self.true_child.astype(np.int64),
                          self.false_child.astype(np.int64), self.mode)))
        n = x.shape[0]
        cur = torch.zeros((n, self.n_trees), dtype=torch.int64, device=dev)
        tree_off = torch.arange(self.n_trees, device=dev)[None, :] * self.max_nodes

        only_leq = bool((self.mode[self.mode != _MODES["LEAF"]] == 0).all())
        for _ in range(self.max_depth):
            flat = tree_off + cur
            f = t_feature[flat]                      # [N, T]
            th = t_threshold[flat]
            md = t_mode[flat]
            xv = torch.gather(x, 1, f)
            go_true = xv <= th if only_leq else _branch(md, xv, th)
            if self.heap_layout:
                nxt = 2 * cur + torch.where(go_true, 1, 2)
            else:
                nxt = torch.where(go_true, t_true[flat], t_false[flat])
            cur = torch.where(md == _MODES["LEAF"], cur, nxt)
        return cur

    def payout(self, cur: torch.Tensor) -> torch.Tensor:
        """Sum leaf weights over trees: [N, T] leaf ids → [N, n_out]."""
        n_out = self.weights.shape[2]
        dev = cur.device
        w = self._on("payout", dev,
                     lambda: torch.as_tensor(self.weights.reshape(-1, n_out), device=dev))
        tree_off = torch.arange(self.n_trees, device=dev)[None, :] * self.max_nodes
        return w[tree_off + cur].sum(dim=1)          # [N, T, n_out] → [N, n_out]

    # ---- GEMM (matmul-only) evaluation --------------------------------

    # device-side f32 bytes we allow the path-score matrix C [T, I, L] to
    # occupy before falling back to the gather traversal (64 MiB)
    _GEMM_C_LIMIT = 64 << 20

    def _build_gemm_tables(self):
        """DFS every tree once; emit per-tree internal/leaf numbering, the
        ±1 ancestry matrix C, true-ancestor counts D, and leaf weights W.
        Returns None when the forest is too large for dense path tables."""
        leaf_code = _MODES["LEAF"]
        per_tree = []
        max_i = max_l = 0
        for t in range(self.n_trees):
            internal, leaves = [], []
            stack = [(0, ())]
            steps = 0
            while stack:
                nd, anc = stack.pop()
                steps += 1
                if steps > 4 * self.max_nodes:  # malformed/cyclic table
                    return None
                if self.mode[t, nd] == leaf_code:
                    leaves.append((nd, anc))
                    continue
                i = len(internal)
                internal.append(nd)
                stack.append((int(self.false_child[t, nd]), anc + ((i, -1),)))
                stack.append((int(self.true_child[t, nd]), anc + ((i, 1),)))
            per_tree.append((internal, leaves))
            max_i = max(max_i, len(internal))
            max_l = max(max_l, len(leaves))
        max_i = max(max_i, 1)
        max_l = max(max_l, 1)
        if self.n_trees * max_i * max_l * 4 > self._GEMM_C_LIMIT:
            return None

        n_out = self.weights.shape[2]
        feat = np.zeros((self.n_trees, max_i), np.int32)
        thresh = np.zeros((self.n_trees, max_i), np.float32)
        mode = np.full((self.n_trees, max_i), _MODES["LEAF"], np.int32)
        C = np.zeros((self.n_trees, max_i, max_l), np.int8)
        D = np.full((self.n_trees, max_l), -1, np.float32)
        W = np.zeros((self.n_trees, max_l, n_out), np.float32)
        for t, (internal, leaves) in enumerate(per_tree):
            for i, nd in enumerate(internal):
                feat[t, i] = self.feature[t, nd]
                thresh[t, i] = self.threshold[t, nd]
                mode[t, i] = self.mode[t, nd]
            for li, (nd, anc) in enumerate(leaves):
                D[t, li] = sum(1 for _, d in anc if d == 1)
                W[t, li] = self.weights[t, nd]
                for i, d in anc:
                    C[t, i, li] = d
        only_leq = bool((mode[mode != leaf_code] == _MODES["BRANCH_LEQ"]).all())
        return {"feat": feat, "thresh": thresh, "mode": mode, "C": C,
                "D": D, "W": W, "only_leq": only_leq}

    @property
    def gemm(self):
        if not hasattr(self, "_gemm"):
            self._gemm = self._build_gemm_tables()
        return self._gemm

    def _gemm_eval_tile(self, x: torch.Tensor) -> torch.Tensor:
        """One row tile through the three-matmul forest: [n, F] → [n, n_out]."""
        g = self.gemm
        dev = x.device
        n_feat = x.shape[1]

        def build():
            # A[t, i, f]: one-hot feature selector — X @ A reproduces every
            # tested feature value exactly (single 1.0 coefficient per column)
            feat = torch.as_tensor(g["feat"].astype(np.int64), device=dev)
            sel = torch.nn.functional.one_hot(feat, n_feat).to(torch.float32)
            return (sel, torch.as_tensor(g["thresh"], device=dev),
                    torch.as_tensor(g["mode"], device=dev),
                    torch.as_tensor(g["C"], device=dev).to(torch.float32),
                    torch.as_tensor(g["D"], device=dev), torch.as_tensor(g["W"], device=dev))

        sel, th, md, C, D, W = self._on(("gemm", n_feat), dev, build)
        xa = torch.einsum("nf,tif->nti", x, sel)
        s = (xa <= th if g["only_leq"] else _branch(md, xa, th)).to(torch.float32)
        # leaf l is reached iff its path score equals its true-ancestor
        # count (integer-valued f32 arithmetic → exact equality)
        score = torch.einsum("nti,til->ntl", s, C)
        hit = (score == D).to(torch.float32)
        return torch.einsum("ntl,tlo->no", hit, W)

    _GEMM_TILE = 4096

    def gemm_eval(self, x: torch.Tensor) -> torch.Tensor:
        """Forest output [N, n_out] via matmuls only, tiled over rows so the
        [n, T, I] / [n, T, L] intermediates stay small at any N."""
        n = x.shape[0]
        tile = self._GEMM_TILE
        if n <= 2 * tile:
            return self._gemm_eval_tile(x)
        return torch.cat([self._gemm_eval_tile(x[i:i + tile]) for i in range(0, n, tile)])

    # ---- in-kernel forest tables --------------------------------------

    # each chunk of trees fits one 128-lane MXU strip: sum(internal) <= 128
    # and sum(leaves) <= 128, so the whole chunk evaluates as two
    # [128,128]-class matmuls per row tile inside the SQL kernel
    _PALLAS_STRIP = 128
    _PALLAS_TABLE_LIMIT = 2 << 20  # f32 bytes across all chunk constants

    def _build_pallas_forest(self, n_features: int):
        """Strip-packed GEMM-forest tables of ``infera_tpu``'s SQL kernel,
        copied unchanged: the port's K4 walks node tables instead
        (``kernel_forest``) but takes exactly the forests these tables take.
        Trees are DFS-numbered exactly as _build_gemm_tables, then greedily
        packed into chunks whose internal and leaf counts both fit a
        128-row strip. Returns None whenever the forest doesn't fit the
        strip packing."""
        leaf_code = _MODES["LEAF"]
        used = {int(m) for m in np.unique(self.mode)} - {leaf_code}
        if used not in ({_MODES["BRANCH_LEQ"]}, {_MODES["BRANCH_LT"]}):
            return None
        strict = used == {_MODES["BRANCH_LT"]}
        strip = self._PALLAS_STRIP
        trees = []
        for t in range(self.n_trees):
            internal, leaves = [], []
            stack = [(0, ())]
            steps = 0
            while stack:
                nd, anc = stack.pop()
                steps += 1
                if steps > 4 * self.max_nodes:
                    return None
                if self.mode[t, nd] == leaf_code:
                    leaves.append((nd, anc))
                    continue
                i = len(internal)
                internal.append(nd)
                stack.append((int(self.false_child[t, nd]),
                              anc + ((i, -1),)))
                stack.append((int(self.true_child[t, nd]),
                              anc + ((i, 1),)))
            if len(internal) > strip or len(leaves) > strip:
                return None
            trees.append((internal, leaves))
        n_out = self.weights.shape[2]
        if n_out > strip:
            return None
        # greedy strip packing
        chunks, cur, ci, cl = [], [], 0, 0
        for t, (internal, leaves) in enumerate(trees):
            if ci + len(internal) > strip or cl + len(leaves) > strip:
                chunks.append(cur)
                cur, ci, cl = [], 0, 0
            cur.append(t)
            ci += len(internal)
            cl += len(leaves)
        if cur:
            chunks.append(cur)
        nch = len(chunks)
        sel = np.zeros((nch * strip, n_features), np.float32)
        # padded internal rows: sel row is zero -> xa = 0; th = -BIG makes
        # the decision 0 under both <= and <
        th = np.full((nch * strip, 1), -np.float32(1 << 30), np.float32)
        # padded leaf rows: C row zero -> score 0; D = -1 never hits
        d_all = np.full((nch * strip, 1), -1.0, np.float32)
        wT = np.zeros((nch * n_out, strip), np.float32)
        c_mats: list = []
        c_idx: list = []
        uniq: dict = {}
        for c, tlist in enumerate(chunks):
            C = np.zeros((strip, strip), np.float32)  # [leaf, internal]
            io = lo = 0
            for t in tlist:
                internal, leaves = trees[t]
                for i, nd in enumerate(internal):
                    f = int(self.feature[t, nd])
                    if f >= n_features:
                        return None
                    sel[c * strip + io + i, f] = 1.0
                    th[c * strip + io + i, 0] = self.threshold[t, nd]
                for li, (nd, anc) in enumerate(leaves):
                    d_all[c * strip + lo + li, 0] = float(
                        sum(1 for _, d in anc if d == 1))
                    wT[c * n_out:(c + 1) * n_out, lo + li] = \
                        self.weights[t, nd]
                    for i, d in anc:
                        C[lo + li, io + i] = d
                io += len(internal)
                lo += len(leaves)
            key = C.tobytes()
            ui = uniq.get(key)
            if ui is None:
                ui = len(c_mats)
                uniq[key] = ui
                c_mats.append(C)
            c_idx.append(ui)
        c_all = np.concatenate(c_mats, axis=0)
        total = sel.nbytes + th.nbytes + d_all.nbytes + wT.nbytes \
            + c_all.nbytes
        if total > self._PALLAS_TABLE_LIMIT:
            return None
        return {"sel": sel, "th": th, "C": c_all, "c_idx": tuple(c_idx),
                "D": d_all, "wT": wT, "n_chunks": nch, "n_out": n_out,
                "strict": strict, "strip": strip}

    def pallas_forest(self, n_features: int):
        # one attribute holds key and tables: planners on several threads
        # share this object and never see a key without its tables
        ent = getattr(self, "_pallas_forest", None)
        if ent is None or ent[0] != n_features:
            ent = (n_features, self._build_pallas_forest(n_features))
            self._pallas_forest = ent
        return ent[1]

    def kernel_forest(self, n_features: int):
        """K4's walk tables over ``n_features`` inputs, or None for a forest
        that ``infera_tpu``'s in-kernel strip packing refuses (a branch mode
        other than all-LEQ or all-LT, a tree over 128 internal nodes or 128
        leaves, more than 128 outputs, a feature index past the inputs, a
        cyclic table, strip tables over 2 MiB). ``node`` [T, max_nodes, 4]
        int32 holds per node (feature or -1 for a leaf, the threshold's f32
        bits, true child, false child); the leaf weights are ``weights``."""
        tables = self.pallas_forest(n_features)
        if tables is None:
            return None
        leaf = self.mode == _MODES["LEAF"]
        node = np.stack([np.where(leaf, -1, self.feature), self.threshold.view(np.int32),
                         self.true_child, self.false_child], axis=-1).astype(np.int32)
        return {"node": np.ascontiguousarray(node), "max_depth": self.max_depth,
                "strict": tables["strict"]}

    def evaluate(self, x: torch.Tensor) -> torch.Tensor:
        """Dispatch: GEMM when the path tables fit (INFERA_TREE_MODE=auto),
        else gather traversal. [N, F] → [N, n_out] summed over trees."""
        pref = os.environ.get("INFERA_TREE_MODE", "auto")
        if pref != "gather" and self.gemm is not None:
            return self.gemm_eval(x)
        if pref == "gemm" and self.gemm is None:
            raise OnnxError("INFERA_TREE_MODE=gemm but the ensemble exceeds "
                            "the GEMM path-table limit")
        return self.payout(self.traverse(x))


def _post_transform(y: torch.Tensor, kind) -> torch.Tensor:
    if kind in (None, "NONE", b"NONE"):
        return y
    if isinstance(kind, bytes):
        kind = kind.decode()
    if kind == "SOFTMAX":
        return torch.softmax(y, dim=-1)
    if kind == "LOGISTIC":
        return torch.sigmoid(y)
    if kind == "SOFTMAX_ZERO":
        # ONNX Runtime semantics: zero scores stay zero; softmax over the rest
        nz = y != 0
        shifted = torch.where(nz, y, -math.inf)
        m = torch.amax(shifted, dim=-1, keepdim=True)
        e = torch.where(nz, torch.exp(shifted - torch.where(torch.isfinite(m), m, 0.0)), 0.0)
        s = torch.sum(e, dim=-1, keepdim=True)
        return torch.where(s > 0, e / torch.where(s > 0, s, 1.0), 0.0)
    if kind == "PROBIT":
        # probit(p) = sqrt(2) * erfinv(2p - 1)  (inverse standard-normal CDF)
        return float(np.float32(np.sqrt(2.0))) * torch.erfinv(2.0 * y - 1.0)
    raise OnnxError(f"unsupported post_transform {kind}")


def _f32(x) -> torch.Tensor:
    return x.to(torch.float32)


def _row(values, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.float32), device=like.device)


@register("TreeEnsembleRegressor", domain="ai.onnx.ml")
def _tree_regressor(node, inputs, ctx):
    x = _f32(inputs[0])
    n_targets = int(node.attr("n_targets", 1))
    packed = _cached_pack(node, n_targets, "target")
    y = packed.evaluate(x)
    base = node.attr("base_values")
    if base:
        y = y + _row(base, y)
    agg = node.attr("aggregate_function", "SUM")
    if isinstance(agg, bytes):
        agg = agg.decode()
    if agg == "AVERAGE":
        y = y / packed.n_trees
    elif agg not in ("SUM", None):
        raise OnnxError(f"unsupported aggregate_function {agg}")
    return [_post_transform(y, node.attr("post_transform", "NONE"))]


def _labels(labels_int, idx: torch.Tensor) -> torch.Tensor:
    if labels_int is None:
        return idx  # string labels surface as indices
    return torch.as_tensor(np.asarray(labels_int, np.int64), device=idx.device)[idx]


@register("TreeEnsembleClassifier", domain="ai.onnx.ml")
def _tree_classifier(node, inputs, ctx):
    x = _f32(inputs[0])
    labels_int = node.attr("classlabels_int64s")
    labels_str = node.attr("classlabels_strings")
    n_classes = len(labels_int or labels_str or [])
    if n_classes == 0:
        raise OnnxError("TreeEnsembleClassifier without class labels")
    packed = _cached_pack(node, n_classes, "class")
    scores = packed.evaluate(x)
    base = node.attr("base_values")
    if base:
        scores = scores + _row(base, scores)
    # binary ensembles may emit a single score column
    if n_classes == 2 and scores.shape[1] == 1:
        scores = torch.cat([-scores, scores], dim=1)
    scores = _post_transform(scores, node.attr("post_transform", "NONE"))
    return [_labels(labels_int, torch.argmax(scores, dim=-1)), scores]


def _cached_pack(node, n_out: int, key: str) -> _PackedTrees:
    # cache on the Node object itself: id()-keyed global dicts can collide
    # when ids are reused after garbage collection
    entry = getattr(node, "_infera_packed_trees", None)
    if entry is None or entry[0] != (n_out, key):
        entry = ((n_out, key), _PackedTrees(node, n_out, key))
        node._infera_packed_trees = entry
    return entry[1]


def _linear(node, x: torch.Tensor, n_rows: int) -> torch.Tensor:
    coeff = _row(node.attr("coefficients"), x).reshape(n_rows, -1)
    y = torch.matmul(x, coeff.T)
    inter = node.attr("intercepts")
    if inter:
        y = y + _row(inter, y)
    return _post_transform(y, node.attr("post_transform", "NONE"))


@register("LinearRegressor", domain="ai.onnx.ml")
def _linear_regressor(node, inputs, ctx):
    return [_linear(node, _f32(inputs[0]), int(node.attr("targets", 1)))]


@register("LinearClassifier", domain="ai.onnx.ml")
def _linear_classifier(node, inputs, ctx):
    labels_int = node.attr("classlabels_ints")
    labels_str = node.attr("classlabels_strings")
    scores = _linear(node, _f32(inputs[0]), len(labels_int or labels_str or []))
    return [_labels(labels_int, torch.argmax(scores, dim=-1)), scores]


@register("Scaler", domain="ai.onnx.ml")
def _scaler(node, inputs, ctx):
    x = _f32(inputs[0])
    offset = node.attr("offset")
    scale = node.attr("scale")
    if offset:
        x = x - _row(offset, x)
    if scale:
        x = x * _row(scale, x)
    return [x]


@register("Normalizer", domain="ai.onnx.ml")
def _normalizer(node, inputs, ctx):
    x = _f32(inputs[0])
    norm = node.attr("norm", "MAX")
    if isinstance(norm, bytes):
        norm = norm.decode()
    if norm == "MAX":
        d = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    elif norm == "L1":
        d = torch.sum(torch.abs(x), dim=-1, keepdim=True)
    elif norm == "L2":
        d = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    else:
        raise OnnxError(f"unsupported norm {norm}")
    return [x / torch.where(d == 0, 1.0, d)]


@register("ZipMap", domain="ai.onnx.ml")
def _zipmap(node, inputs, ctx):
    # map output is represented by its score tensor
    return [inputs[0]]


@register("ArrayFeatureExtractor", domain="ai.onnx.ml")
def _array_feature_extractor(node, inputs, ctx):
    x = inputs[0]
    idx = inputs[1].to(device=x.device, dtype=torch.int64).reshape(-1)
    return [torch.index_select(x, -1, idx)]
