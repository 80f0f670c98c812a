"""Programmatic ONNX model construction for tests and benchmarks.

The reference ships tiny committed .onnx files (test/models/README.md:
linear.onnx = y = 2x1 - x2 + 0.5x3 + 0.25 over input [1,3]; multi_output.onnx
= Identity over [1,4]). We synthesize semantically identical models with our
own protobuf writer so the repo carries no binary blobs, plus larger MLP /
multi-output / tree-ensemble models for the benchmark configs in
BASELINE.json.
"""

from __future__ import annotations

import numpy as np

from .proto import (
    Attribute,
    DataType,
    Graph,
    Model,
    Node,
    Tensor,
    ValueInfo,
    save_model_file,
)


def linear_model() -> Model:
    """y = 2*x1 - 1*x2 + 0.5*x3 + 0.25, input [1,3] → output [1,1].

    Matches the reference test model (SURVEY.md §2.3; weights verified from
    test/models/linear.onnx bytes): Z = MatMul(X, W); Y = Add(Z, B).
    """
    w = np.array([[2.0], [-1.0], [0.5]], dtype=np.float32)
    b = np.array([0.25], dtype=np.float32)
    g = Graph(
        name="LinearModel",
        nodes=[
            Node(op_type="MatMul", inputs=["X", "W"], outputs=["Z"]),
            Node(op_type="Add", inputs=["Z", "B"], outputs=["Y"]),
        ],
        initializers={"W": Tensor.from_array("W", w), "B": Tensor.from_array("B", b)},
        inputs=[ValueInfo(name="X", elem_type=DataType.FLOAT, shape=[1, 3])],
        outputs=[ValueInfo(name="Y", elem_type=DataType.FLOAT, shape=[1, 1])],
    )
    return Model(graph=g, opset_imports=[("", 13)])


def multi_output_model() -> Model:
    """Identity over [1,4] (reference test/models/multi_output.onnx)."""
    g = Graph(
        name="MultiOutputModel",
        nodes=[Node(op_type="Identity", inputs=["X"], outputs=["Y"])],
        inputs=[ValueInfo(name="X", elem_type=DataType.FLOAT, shape=[1, 4])],
        outputs=[ValueInfo(name="Y", elem_type=DataType.FLOAT, shape=[1, 4])],
    )
    return Model(graph=g, opset_imports=[("", 13)])


def mlp_model(
    in_dim: int = 16,
    hidden: tuple = (64, 64),
    out_dim: int = 8,
    seed: int = 0,
    softmax: bool = True,
    dynamic_batch: bool = True,
) -> Model:
    """An MLP classifier for the BASELINE.json config-2 benchmark."""
    rng = np.random.default_rng(seed)
    nodes = []
    inits = {}
    prev = "X"
    dims = [in_dim, *hidden, out_dim]
    for li in range(len(dims) - 1):
        w = rng.standard_normal((dims[li], dims[li + 1]), dtype=np.float32)
        w *= np.float32(1.0 / np.sqrt(dims[li]))
        b = rng.standard_normal(dims[li + 1], dtype=np.float32) * np.float32(0.1)
        inits[f"W{li}"] = Tensor.from_array(f"W{li}", w)
        inits[f"B{li}"] = Tensor.from_array(f"B{li}", b)
        nodes.append(Node(op_type="Gemm", inputs=[prev, f"W{li}", f"B{li}"],
                          outputs=[f"H{li}"]))
        if li < len(dims) - 2:
            nodes.append(Node(op_type="Relu", inputs=[f"H{li}"], outputs=[f"A{li}"]))
            prev = f"A{li}"
        else:
            prev = f"H{li}"
    if softmax:
        nodes.append(
            Node(op_type="Softmax", inputs=[prev], outputs=["Y"],
                 attributes={"axis": Attribute.make("axis", -1)})
        )
    else:
        nodes.append(Node(op_type="Identity", inputs=[prev], outputs=["Y"]))
    batch_dim = -1 if dynamic_batch else 1
    g = Graph(
        name="MlpClassifier",
        nodes=nodes,
        initializers=inits,
        inputs=[ValueInfo(name="X", elem_type=DataType.FLOAT, shape=[batch_dim, in_dim])],
        outputs=[ValueInfo(name="Y", elem_type=DataType.FLOAT, shape=[batch_dim, out_dim])],
    )
    return Model(graph=g, opset_imports=[("", 13)])


def gbt_regressor_model(
    n_features: int = 16,
    n_trees: int = 32,
    depth: int = 5,
    seed: int = 0,
) -> Model:
    """A gradient-boosted-trees regressor (ai.onnx.ml TreeEnsembleRegressor)
    with complete binary trees in heap layout, for the BASELINE.json config-4
    benchmark. Random thresholds/features/leaf weights."""
    rng = np.random.default_rng(seed)
    n_internal = (1 << depth) - 1
    n_nodes = (1 << (depth + 1)) - 1

    nodes_treeids, nodes_nodeids, nodes_featureids = [], [], []
    nodes_modes, nodes_values = [], []
    nodes_true, nodes_false = [], []
    target_treeids, target_nodeids, target_ids, target_weights = [], [], [], []

    for t in range(n_trees):
        for nd in range(n_nodes):
            nodes_treeids.append(t)
            nodes_nodeids.append(nd)
            if nd < n_internal:
                nodes_featureids.append(int(rng.integers(0, n_features)))
                nodes_modes.append("BRANCH_LEQ")
                nodes_values.append(float(rng.standard_normal()))
                nodes_true.append(2 * nd + 1)
                nodes_false.append(2 * nd + 2)
            else:
                nodes_featureids.append(0)
                nodes_modes.append("LEAF")
                nodes_values.append(0.0)
                nodes_true.append(0)
                nodes_false.append(0)
                target_treeids.append(t)
                target_nodeids.append(nd)
                target_ids.append(0)
                target_weights.append(float(rng.standard_normal()) * 0.1)

    attrs = {
        "n_targets": Attribute.make("n_targets", 1),
        "nodes_treeids": Attribute.make("nodes_treeids", nodes_treeids),
        "nodes_nodeids": Attribute.make("nodes_nodeids", nodes_nodeids),
        "nodes_featureids": Attribute.make("nodes_featureids", nodes_featureids),
        "nodes_modes": Attribute.make("nodes_modes", nodes_modes),
        "nodes_values": Attribute.make("nodes_values", nodes_values),
        "nodes_truenodeids": Attribute.make("nodes_truenodeids", nodes_true),
        "nodes_falsenodeids": Attribute.make("nodes_falsenodeids", nodes_false),
        "target_treeids": Attribute.make("target_treeids", target_treeids),
        "target_nodeids": Attribute.make("target_nodeids", target_nodeids),
        "target_ids": Attribute.make("target_ids", target_ids),
        "target_weights": Attribute.make("target_weights", target_weights),
        "base_values": Attribute.make("base_values", [0.5]),
        "post_transform": Attribute.make("post_transform", "NONE"),
    }
    g = Graph(
        name="GbtRegressor",
        nodes=[Node(op_type="TreeEnsembleRegressor", domain="ai.onnx.ml",
                    inputs=["X"], outputs=["Y"], attributes=attrs)],
        inputs=[ValueInfo(name="X", elem_type=DataType.FLOAT,
                          shape=[-1, n_features])],
        outputs=[ValueInfo(name="Y", elem_type=DataType.FLOAT, shape=[-1, 1])],
    )
    return Model(graph=g, opset_imports=[("", 13), ("ai.onnx.ml", 3)])


def gbt_classifier_model(
    n_features: int = 8,
    n_trees: int = 8,
    depth: int = 4,
    n_classes: int = 3,
    labels: list | None = None,
    seed: int = 0,
) -> Model:
    """A gradient-boosted-trees CLASSIFIER (ai.onnx.ml
    TreeEnsembleClassifier) with complete heap-layout trees — the config-4
    companion to gbt_regressor_model. ``labels`` default to
    [10, 20, 30, ...] so the label-mapping path (not just argmax index)
    is exercised."""
    rng = np.random.default_rng(seed)
    n_internal = (1 << depth) - 1
    n_nodes = (1 << (depth + 1)) - 1
    labels = labels if labels is not None else \
        [10 * (i + 1) for i in range(n_classes)]

    nodes_treeids, nodes_nodeids, nodes_featureids = [], [], []
    nodes_modes, nodes_values = [], []
    nodes_true, nodes_false = [], []
    c_treeids, c_nodeids, c_ids, c_weights = [], [], [], []

    for t in range(n_trees):
        for nd in range(n_nodes):
            nodes_treeids.append(t)
            nodes_nodeids.append(nd)
            if nd < n_internal:
                nodes_featureids.append(int(rng.integers(0, n_features)))
                nodes_modes.append("BRANCH_LEQ")
                nodes_values.append(float(rng.standard_normal()))
                nodes_true.append(2 * nd + 1)
                nodes_false.append(2 * nd + 2)
            else:
                nodes_featureids.append(0)
                nodes_modes.append("LEAF")
                nodes_values.append(0.0)
                nodes_true.append(0)
                nodes_false.append(0)
                for cid in range(n_classes):
                    c_treeids.append(t)
                    c_nodeids.append(nd)
                    c_ids.append(cid)
                    c_weights.append(float(rng.standard_normal()) * 0.1)

    attrs = {
        "classlabels_int64s": Attribute.make("classlabels_int64s", labels),
        "nodes_treeids": Attribute.make("nodes_treeids", nodes_treeids),
        "nodes_nodeids": Attribute.make("nodes_nodeids", nodes_nodeids),
        "nodes_featureids": Attribute.make("nodes_featureids",
                                           nodes_featureids),
        "nodes_modes": Attribute.make("nodes_modes", nodes_modes),
        "nodes_values": Attribute.make("nodes_values", nodes_values),
        "nodes_truenodeids": Attribute.make("nodes_truenodeids", nodes_true),
        "nodes_falsenodeids": Attribute.make("nodes_falsenodeids",
                                             nodes_false),
        "class_treeids": Attribute.make("class_treeids", c_treeids),
        "class_nodeids": Attribute.make("class_nodeids", c_nodeids),
        "class_ids": Attribute.make("class_ids", c_ids),
        "class_weights": Attribute.make("class_weights", c_weights),
        "post_transform": Attribute.make("post_transform", "SOFTMAX"),
    }
    g = Graph(
        name="GbtClassifier",
        nodes=[Node(op_type="TreeEnsembleClassifier", domain="ai.onnx.ml",
                    inputs=["X"], outputs=["label", "scores"],
                    attributes=attrs)],
        inputs=[ValueInfo(name="X", elem_type=DataType.FLOAT,
                          shape=[-1, n_features])],
        outputs=[ValueInfo(name="label", elem_type=DataType.INT64,
                           shape=[-1]),
                 ValueInfo(name="scores", elem_type=DataType.FLOAT,
                           shape=[-1, n_classes])],
    )
    return Model(graph=g, opset_imports=[("", 13), ("ai.onnx.ml", 3)])


def mobilenet_like_model(seed: int = 0, n_classes: int = 1000) -> Model:
    """MobileNetV3-Small topology at the REAL input shape (round-3 depth).

    Offline stand-in for the HuggingFace mobilenetv3 model the reference's
    test_advanced_features.test downloads
    (upstream test/sql/test_advanced_features.test:47-58): fixed
    input of 1*224*224*3 floats (the pinned 602,112-byte blob). Round 2
    shipped a 4-stage sketch; this is the full v3-small layer table
    (Howard et al. 2019, Table 2): stem conv + 11 inverted-residual bneck
    blocks (expand 1x1 → depthwise 3x3/5x5 → squeeze-excite with
    hardsigmoid gating → linear project, residual when stride 1 and
    cin==cout), 576-wide conv head, pooled 1024-wide classifier —
    ~2.5M params, so compile/perf behavior is exercised at real depth
    under one jit.
    """
    rng = np.random.default_rng(seed)
    nodes = []
    inits = {}
    uid = [0]

    def conv(inp, out, cin, cout, k, stride, group=1):
        idx = uid[0]
        uid[0] += 1
        wshape = (cout, cin // group, k, k)
        w = (rng.standard_normal(wshape, dtype=np.float32)
             * np.float32(1.0 / np.sqrt(cin * k * k / group)))
        b = rng.standard_normal(cout, dtype=np.float32) * np.float32(0.05)
        inits[f"CW{idx}"] = Tensor.from_array(f"CW{idx}", w)
        inits[f"CB{idx}"] = Tensor.from_array(f"CB{idx}", b)
        pad = (k - 1) // 2
        nodes.append(Node(
            op_type="Conv", inputs=[inp, f"CW{idx}", f"CB{idx}"], outputs=[out],
            attributes={
                "kernel_shape": Attribute.make("kernel_shape", [k, k]),
                "strides": Attribute.make("strides", [stride, stride]),
                "pads": Attribute.make("pads", [pad, pad, pad, pad]),
                "group": Attribute.make("group", group),
            }))

    def act(op, inp, out):
        nodes.append(Node(op_type=op, inputs=[inp], outputs=[out]))

    def squeeze_excite(inp, out, ch, tag):
        """SE: gap → 1x1 reduce (ch/4) → relu → 1x1 expand → hardsigmoid →
        channel-scale (v3 uses the hard gate)."""
        red = max(ch // 4, 8)
        nodes.append(Node(op_type="GlobalAveragePool", inputs=[inp],
                          outputs=[f"{tag}_gap"]))
        conv(f"{tag}_gap", f"{tag}_r", ch, red, 1, 1)
        act("Relu", f"{tag}_r", f"{tag}_ra")
        conv(f"{tag}_ra", f"{tag}_e", red, ch, 1, 1)
        act("HardSigmoid", f"{tag}_e", f"{tag}_g")
        nodes.append(Node(op_type="Mul", inputs=[inp, f"{tag}_g"],
                          outputs=[out]))

    def bneck(bi, inp, cin, exp, cout, k, stride, se, nl):
        """Inverted residual: expand → depthwise → [SE] → linear project."""
        tag = f"b{bi}"
        cur = inp
        if exp != cin:
            conv(cur, f"{tag}_x", cin, exp, 1, 1)
            act(nl, f"{tag}_x", f"{tag}_xa")
            cur = f"{tag}_xa"
        conv(cur, f"{tag}_d", exp, exp, k, stride, group=exp)
        act(nl, f"{tag}_d", f"{tag}_da")
        cur = f"{tag}_da"
        if se:
            squeeze_excite(cur, f"{tag}_se", exp, tag)
            cur = f"{tag}_se"
        conv(cur, f"{tag}_p", exp, cout, 1, 1)  # linear bottleneck
        cur = f"{tag}_p"
        if stride == 1 and cin == cout:
            nodes.append(Node(op_type="Add", inputs=[inp, cur],
                              outputs=[f"{tag}_o"]))
            cur = f"{tag}_o"
        return cur

    # stem: 3→16 s2 hardswish (224→112)
    conv("X", "c0", 3, 16, 3, 2)
    act("HardSwish", "c0", "a0")
    # the 11 v3-small bneck rows: (exp, out, k, stride, SE, NL)
    table = [
        (16, 16, 3, 2, True, "Relu"),
        (72, 24, 3, 2, False, "Relu"),
        (88, 24, 3, 1, False, "Relu"),
        (96, 40, 5, 2, True, "HardSwish"),
        (240, 40, 5, 1, True, "HardSwish"),
        (240, 40, 5, 1, True, "HardSwish"),
        (120, 48, 5, 1, True, "HardSwish"),
        (144, 48, 5, 1, True, "HardSwish"),
        (288, 96, 5, 2, True, "HardSwish"),
        (576, 96, 5, 1, True, "HardSwish"),
        (576, 96, 5, 1, True, "HardSwish"),
    ]
    prev = "a0"
    cin = 16
    for bi, (exp, cout, k, stride, se, nl) in enumerate(table):
        prev = bneck(bi, prev, cin, exp, cout, k, stride, se, nl)
        cin = cout
    # head: 1x1 conv to 576 + SE-free hardswish, pool, 1024-wide classifier
    conv(prev, "h0", cin, 576, 1, 1)
    act("HardSwish", "h0", "h0a")
    nodes.append(Node(op_type="GlobalAveragePool", inputs=["h0a"],
                      outputs=["gap"]))
    conv("gap", "h1", 576, 1024, 1, 1)
    act("HardSwish", "h1", "h1a")
    nodes.append(Node(op_type="Flatten", inputs=["h1a"], outputs=["flat"],
                      attributes={"axis": Attribute.make("axis", 1)}))
    w = (rng.standard_normal((1024, n_classes), dtype=np.float32)
         * np.float32(1.0 / np.sqrt(1024)))
    b = rng.standard_normal(n_classes, dtype=np.float32) * np.float32(0.05)
    inits["FW"] = Tensor.from_array("FW", w)
    inits["FB"] = Tensor.from_array("FB", b)
    nodes.append(Node(op_type="Gemm", inputs=["flat", "FW", "FB"],
                      outputs=["Y"]))
    g = Graph(
        name="MobilenetLike",
        nodes=nodes,
        initializers=inits,
        inputs=[ValueInfo(name="X", elem_type=DataType.FLOAT,
                          shape=[1, 3, 224, 224])],
        outputs=[ValueInfo(name="Y", elem_type=DataType.FLOAT,
                           shape=[1, n_classes])],
    )
    return Model(graph=g, opset_imports=[("", 17)])


def if_model(static_cond: bool | None = None) -> Model:
    """y = If(mean(X) > 0) ? 2*X + 1 : -X  over input [-1, 4].

    Branch subgraphs capture X from the outer scope (ONNX scoping rules).
    With ``static_cond`` set, the condition is an initializer so the branch
    folds at trace time; otherwise it is computed from X and lowers to
    lax.cond. Covers tract's control-flow opset (engine.rs:49-55)."""
    two = Tensor.from_array("two", np.float32(2.0))
    one = Tensor.from_array("one", np.float32(1.0))
    then_g = Graph(
        name="then",
        nodes=[
            Node(op_type="Mul", inputs=["X", "two"], outputs=["t0"]),
            Node(op_type="Add", inputs=["t0", "one"], outputs=["then_out"]),
        ],
        outputs=[ValueInfo(name="then_out", elem_type=DataType.FLOAT,
                           shape=[-1, 4])],
    )
    else_g = Graph(
        name="else",
        nodes=[Node(op_type="Neg", inputs=["X"], outputs=["else_out"])],
        outputs=[ValueInfo(name="else_out", elem_type=DataType.FLOAT,
                           shape=[-1, 4])],
    )
    inits = {"two": two, "one": one,
             "zero": Tensor.from_array("zero", np.float32(0.0))}
    nodes = []
    if static_cond is None:
        nodes.append(Node(op_type="ReduceMean", inputs=["X"], outputs=["m"],
                          attributes={"keepdims": Attribute.make("keepdims", 0)}))
        nodes.append(Node(op_type="Greater", inputs=["m", "zero"],
                          outputs=["cond"]))
    else:
        inits["cond"] = Tensor.from_array(
            "cond", np.asarray(static_cond, np.bool_))
    nodes.append(Node(
        op_type="If", inputs=["cond"], outputs=["Y"],
        attributes={"then_branch": Attribute.make("then_branch", then_g),
                    "else_branch": Attribute.make("else_branch", else_g)}))
    g = Graph(
        name="IfModel", nodes=nodes, initializers=inits,
        inputs=[ValueInfo(name="X", elem_type=DataType.FLOAT, shape=[-1, 4])],
        outputs=[ValueInfo(name="Y", elem_type=DataType.FLOAT, shape=[-1, 4])],
    )
    return Model(graph=g, opset_imports=[("", 17)])


def loop_model(trips: int = 5, scan_output: bool = False) -> Model:
    """v_{k+1} = v_k + X for ``trips`` iterations starting at v_0 = X
    (so Y = (trips+1) * X), input [-1, 4].

    Without scan_output the Loop lowers to lax.while_loop; with it, the body
    also emits ReduceSum(v) per iteration (shape [1]) and the Loop lowers to
    lax.scan with a static trip count."""
    body_nodes = [
        Node(op_type="Identity", inputs=["c_in"], outputs=["c_out"]),
        Node(op_type="Add", inputs=["v_in", "X"], outputs=["v_out"]),
    ]
    body_outputs = [
        ValueInfo(name="c_out", elem_type=DataType.BOOL, shape=[]),
        ValueInfo(name="v_out", elem_type=DataType.FLOAT, shape=[-1, 4]),
    ]
    if scan_output:
        body_nodes.append(Node(op_type="ReduceSum", inputs=["v_out"],
                               outputs=["s_out"],
                               attributes={"keepdims": Attribute.make("keepdims", 0)}))
        body_outputs.append(ValueInfo(name="s_out", elem_type=DataType.FLOAT,
                                      shape=[]))
    body = Graph(
        name="loop_body",
        nodes=body_nodes,
        inputs=[
            ValueInfo(name="i", elem_type=DataType.INT64, shape=[]),
            ValueInfo(name="c_in", elem_type=DataType.BOOL, shape=[]),
            ValueInfo(name="v_in", elem_type=DataType.FLOAT, shape=[-1, 4]),
        ],
        outputs=body_outputs,
    )
    inits = {
        "M": Tensor.from_array("M", np.asarray(trips, np.int64)),
        "keep_going": Tensor.from_array("keep_going", np.asarray(True, np.bool_)),
    }
    outputs = [ValueInfo(name="Y", elem_type=DataType.FLOAT, shape=[-1, 4])]
    loop_outputs = ["Y"]
    if scan_output:
        loop_outputs.append("S")
        outputs.append(ValueInfo(name="S", elem_type=DataType.FLOAT,
                                 shape=[trips]))
    g = Graph(
        name="LoopModel",
        nodes=[Node(op_type="Loop", inputs=["M", "keep_going", "X"],
                    outputs=loop_outputs,
                    attributes={"body": Attribute.make("body", body)})],
        initializers=inits,
        inputs=[ValueInfo(name="X", elem_type=DataType.FLOAT, shape=[-1, 4])],
        outputs=outputs,
    )
    return Model(graph=g, opset_imports=[("", 17)])


def scan_model() -> Model:
    """Cumulative sum over axis 0 via Scan: state s [4] + scan input row;
    outputs the final sum [4] and the running cumsum [N, 4]."""
    body = Graph(
        name="scan_body",
        nodes=[
            Node(op_type="Add", inputs=["s_in", "x_t"], outputs=["s_out"]),
            Node(op_type="Identity", inputs=["s_out"], outputs=["y_t"]),
        ],
        inputs=[
            ValueInfo(name="s_in", elem_type=DataType.FLOAT, shape=[4]),
            ValueInfo(name="x_t", elem_type=DataType.FLOAT, shape=[4]),
        ],
        outputs=[
            ValueInfo(name="s_out", elem_type=DataType.FLOAT, shape=[4]),
            ValueInfo(name="y_t", elem_type=DataType.FLOAT, shape=[4]),
        ],
    )
    g = Graph(
        name="ScanModel",
        nodes=[Node(
            op_type="Scan", inputs=["S0", "X"], outputs=["SF", "Y"],
            attributes={"body": Attribute.make("body", body),
                        "num_scan_inputs": Attribute.make("num_scan_inputs", 1)})],
        initializers={"S0": Tensor.from_array("S0", np.zeros(4, np.float32))},
        inputs=[ValueInfo(name="X", elem_type=DataType.FLOAT, shape=[-1, 4])],
        outputs=[
            ValueInfo(name="SF", elem_type=DataType.FLOAT, shape=[4]),
            ValueInfo(name="Y", elem_type=DataType.FLOAT, shape=[-1, 4]),
        ],
    )
    return Model(graph=g, opset_imports=[("", 17)])


def write_reference_test_models(directory) -> dict:
    """Write linear.onnx and multi_output.onnx into `directory`.

    Returns {model_name: path}. Used by the parity test-suite in place of the
    reference's committed binaries.
    """
    import os

    os.makedirs(directory, exist_ok=True)
    paths = {}
    for name, model in (("linear", linear_model()), ("multi_output", multi_output_model())):
        p = os.path.join(directory, f"{name}.onnx")
        save_model_file(model, p)
        paths[name] = p
    return paths


def transformer_encoder_model(
    seq: int = 16,
    d_model: int = 64,
    n_heads: int = 4,
    n_layers: int = 2,
    n_classes: int = 8,
    seed: int = 0,
) -> Model:
    """A real multi-head transformer encoder (pre-LN, GELU FFN, mean-pool
    classifier) over a flat [batch, seq*d_model] float input.

    Exercises the full attention op chain — LayerNormalization, batched
    MatMul with head reshapes/transposes, Softmax, Gelu, residuals — as ONE
    ONNX graph through the engine (the reference executes whatever tract
    parses, upstream infera/src/engine.rs:49-55; transformer exports
    are the dominant real-world ONNX family). The flat input keeps the SQL
    blob path natural: batch is inferred from the dynamic dim
    (engine.rs:221-238 semantics)."""
    rng = np.random.default_rng(seed)
    dh = d_model // n_heads
    nodes = []
    inits = {}

    def wtensor(name, shape, scale):
        arr = (rng.standard_normal(shape, dtype=np.float32)
               * np.float32(scale))
        inits[name] = Tensor.from_array(name, arr)
        return name

    def ctensor(name, arr):
        inits[name] = Tensor.from_array(name, np.asarray(arr))
        return name

    def node(op, ins, outs, **attrs):
        nodes.append(Node(op_type=op, inputs=ins, outputs=outs,
                          attributes={k: Attribute.make(k, v)
                                      for k, v in attrs.items()}))

    ctensor("shape_bsd", np.asarray([-1, seq, d_model], np.int64))
    ctensor("shape_heads", np.asarray([-1, seq, n_heads, dh], np.int64))
    ctensor("shape_flat", np.asarray([-1, seq, d_model], np.int64))
    ctensor("scale", np.asarray(1.0 / np.sqrt(dh), np.float32))
    node("Reshape", ["X", "shape_bsd"], ["H0"])
    h = "H0"
    for li in range(n_layers):
        p = f"L{li}_"
        # --- attention block (pre-LN) ---
        wtensor(p + "ln1_g", (d_model,), 1.0)
        wtensor(p + "ln1_b", (d_model,), 0.1)
        node("LayerNormalization", [h, p + "ln1_g", p + "ln1_b"],
             [p + "ln1"], epsilon=1e-5)
        for nm in ("q", "k", "v"):
            wtensor(p + f"W{nm}", (d_model, d_model),
                    1.0 / np.sqrt(d_model))
            node("MatMul", [p + "ln1", p + f"W{nm}"], [p + nm])
            node("Reshape", [p + nm, "shape_heads"], [p + nm + "h"])
            # [B, s, h, dh] -> [B, h, s, dh]
            node("Transpose", [p + nm + "h"], [p + nm + "t"],
                 perm=[0, 2, 1, 3])
        # scores = Q @ K^T * scale
        node("Transpose", [p + "kt"], [p + "ktt"], perm=[0, 1, 3, 2])
        node("MatMul", [p + "qt", p + "ktt"], [p + "sc0"])
        node("Mul", [p + "sc0", "scale"], [p + "sc"])
        node("Softmax", [p + "sc"], [p + "attn"], axis=-1)
        node("MatMul", [p + "attn", p + "vt"], [p + "ctx0"])
        node("Transpose", [p + "ctx0"], [p + "ctx1"], perm=[0, 2, 1, 3])
        node("Reshape", [p + "ctx1", "shape_flat"], [p + "ctx"])
        wtensor(p + "Wo", (d_model, d_model), 1.0 / np.sqrt(d_model))
        node("MatMul", [p + "ctx", p + "Wo"], [p + "proj"])
        node("Add", [h, p + "proj"], [p + "res1"])
        # --- FFN block (pre-LN, GELU) ---
        wtensor(p + "ln2_g", (d_model,), 1.0)
        wtensor(p + "ln2_b", (d_model,), 0.1)
        node("LayerNormalization",
             [p + "res1", p + "ln2_g", p + "ln2_b"], [p + "ln2"],
             epsilon=1e-5)
        wtensor(p + "W1", (d_model, 4 * d_model), 1.0 / np.sqrt(d_model))
        wtensor(p + "b1", (4 * d_model,), 0.05)
        node("MatMul", [p + "ln2", p + "W1"], [p + "ff0"])
        node("Add", [p + "ff0", p + "b1"], [p + "ff1"])
        node("Gelu", [p + "ff1"], [p + "ff2"])
        wtensor(p + "W2", (4 * d_model, d_model),
                1.0 / np.sqrt(4 * d_model))
        wtensor(p + "b2", (d_model,), 0.05)
        node("MatMul", [p + "ff2", p + "W2"], [p + "ff3"])
        node("Add", [p + "ff3", p + "b2"], [p + "ff4"])
        node("Add", [p + "res1", p + "ff4"], [p + "out"])
        h = p + "out"
    # mean-pool over seq -> classifier
    node("ReduceMean", [h], ["pooled"], axes=[1], keepdims=0)
    wtensor("Wcls", (d_model, n_classes), 1.0 / np.sqrt(d_model))
    wtensor("bcls", (n_classes,), 0.05)
    node("MatMul", ["pooled", "Wcls"], ["logits"])
    node("Add", ["logits", "bcls"], ["Y"])
    g = Graph(
        name="TransformerEncoder",
        nodes=nodes,
        initializers=inits,
        inputs=[ValueInfo(name="X", elem_type=DataType.FLOAT,
                          shape=[-1, seq * d_model])],
        outputs=[ValueInfo(name="Y", elem_type=DataType.FLOAT,
                           shape=[-1, n_classes])],
    )
    return Model(graph=g)
