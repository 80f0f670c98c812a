// K2, K2', K4 and K5: the fused SQL plan over a stacked feature-major table block.
//
// Replaces infera_tpu/ops/pallas_sql.py:71 `build_fused_plan_call` (its core
// slots: count, sum/avg, min/max and the key guard), the in-kernel MLP of
// infera_tpu/sql/device_plan.py:633 `_lower_mlp` (K2') and the in-kernel
// forest of infera_tpu/sql/device_plan.py:734 `_lower_tree_tables` (K4), both
// of which run inside it, and the fact->dimension join plan of
// infera_tpu/ops/pallas_sql.py:668 `execute_fused_join_plan` (K5).
//
// For every row r < n of xc [C, n_pad] f32:
//   mask = where(r) != 0                                 (NaN counts as true)
//   key  = (sum_k int32(key_k(r)) * stride_k) mod G      (int32 wrap, floor mod)
// and group `key` of the selected rows gets: the row count (int64), each sum
// slot (f64), each min and max slot (f32, NaN propagates as jnp.minimum does,
// empty groups stay at +-inf) and per key the raw-key min and max. Flag bit k
// says key k held a fractional value; bit K a key with |value| >= 2^24.
//
// Programs, not closures. The TPU kernel ran Python closures that JAX traced;
// here the planner emits one postfix program per slot (the WHERE predicate,
// each key, each sum/min/max input, each MLP feature) and this kernel
// interprets them per row, one row per thread, with the stack in registers.
// Arithmetic uses __fadd_rn / __fmul_rn / __fdiv_rn so that nvcc cannot fuse
// a*b+c into an FMA: every slot value equals the plain version's separate
// torch ops bit for bit (exp and log differ from torch's by the last bits of
// their libraries). `%` is floor-mod like jnp.mod, `round` is rintf (half to
// even like jnp.round).
//
// K2': each `infera_predict` is an MLP slot. On every tile, before the slot
// programs run, the block evaluates the slot's feature programs into a
// 64-row activation tile and runs the layer stack on it with the weights
// resident in shared memory, then an optional softmax over the classes, and
// keeps output column `oc` as the slot's prediction. An f32 slot runs
// mlp_stack_ffma (mlp_tile.cuh: every warp on every layer, the narrow last
// layer included; each output summed from 0 in input order, so the f32
// predictions equal the plain version's, and K6's, bit for bit). A bf16 slot
// runs mlp_stack_bf16 (mma_tile.cuh: mma.sync m16n8k16, bf16 operands and
// f32 sums, as the TPU's jnp.dot(bf16, bf16, preferred_element_type=f32))
// over its features rounded to bf16 in an A tile [64][mma_stride(d_in)] and
// pack_mma_blob's weights. The 128-column f32 passes and the tensor-core
// layers live only in the kernel's kWide instance (below), which a plan
// with a bf16 slot or an f32 layer of 128 columns or more launches.
//
// The TPU kernel ran the MLP over a dense [C, N] block, every row. Here,
// where the WHERE reads no prediction (header word H_KEPT), each thread
// evaluates the WHERE for its row once, before the slots; a warp ballot and
// each warp's count before it list the tile's kept rows in row order in
// kslot, and the MLP slots run on ceil(kept / 64) sub-tiles of that list,
// zeros past its end, each prediction scattered back to pred[j][row]. The
// slot phase reads the kept flag and does not run the WHERE again. A row's
// sum does not depend on its place in the sub-tile, so the predictions are
// the same bits either way. A dropped row's prediction is not written, and
// nothing that a selected row reads uses it. A WHERE that reads a
// prediction, a plan without a WHERE, and every forest slot run over every
// row.
//
// Bound on the H100 (main path, 1,048,576 rows), counted on the rows the
// WHERE keeps: with the 4-32-1 MLP of the SQL flagship the work is ~0.3 G
// operations and the 5 read columns are 21 MB, so it is bound by bytes
// (~0.006 ms at 3.35 TB/s); with the bench MLP (32-128-128-16 softmax) in
// f32 by f32 operations (47.2 G operations over all rows, ~0.70 ms at 67
// TFLOP/s, half that where the WHERE keeps half the rows), in bf16 by the 33
// columns' bytes (at 989 TFLOP/s the operations take less). It reads a
// feature that is a bare column straight from the block (mlp_feature) and
// interprets any other feature program with a switch, one feature a thread
// at a time, and its block's steps (features, a barrier, each layer and a
// barrier, the softmax) run in series, so it stays far from either bound.
//
// K4: each `infera_predict` of a tree ensemble is a forest slot. The TPU
// kernel ran the forest as strip-packed one-hot and ancestry matmuls for the
// MXU; the function is "per tree, the leaf the row's decisions reach; add the
// leaf weights", so here one thread takes one row of the 256-row tile and
// walks every tree, adding the leaf weights in tree order with __fadd_rn, as
// forest_plain does, so the two agree bit for bit. Per tile, the thread first
// evaluates its row's feature programs once into its column of a
// feature-major tile feat[d_in][kRows] in shared memory (bare columns read
// straight from the block, eight loads in flight), then applies the
// non-finite rule below to that column once; the walk reads feat[f][r], one
// bank per row whatever feature a node tests. The trees are
// compact 8-byte node records (ops/fused_sql.py forest_records): the
// threshold's bits (a regressor's leaf: its weight), the feature (0xFFFF: a
// leaf) and two one-byte children, a leaf's children itself; each tree is
// numbered level by level, so a warp reads one level of one tree from one run
// of records. Each persistent block copies the records into shared memory
// once, before its first tile, where the plan still fits two blocks an SM
// with them (D and E: 64 x 127 records, 65 KB); a larger forest keeps them
// in device memory and walks the same layout through __ldg. A thread
// walks kTreesInFlight trees at once, level by level, issuing all their
// record loads and then all their feature loads before it uses one, so the
// loads of a level overlap; a tree at its leaf loops on it. A classifier's
// leaf weights [T * M][n_out] are read after its group's walk, from shared
// memory where the plan still fits two blocks an SM, else from device
// memory; it walks the forest once per kOutChunk classes, their sums in
// registers, then takes the first-index argmax (a NaN wins, as jnp.argmax)
// and its label map. A row that holds a non-finite feature sees
// NaN at every node that tests another feature: the TPU kernel's one-hot
// select (and the host's GEMM forest) multiplies every feature by 0 or 1,
// and inf * 0 is NaN. A plan whose feature tile does not fit runs each
// visited node's feature program instead, one tree at a time, from device
// memory. K4 lives in the kernel's kWide instance (below): eight trees in
// flight spilled at 80 registers.
//
// Bound of K4 on the H100 (config 4: 64 trees of depth 6 over 16 features,
// 1,048,576 rows): the 17 columns it reads are 71.3 MB (0.021 ms at 3.35
// TB/s), the 64 x 6 compares and 64 adds per row 0.47 G operations (0.007 ms
// at 67 TFLOP/s): bound by bytes. The walk is bound by shared memory
// instead: 448 record and 384 feature loads a row, each a wavefront or more
// a warp, and the d_in feature programs a row.
//
// K5: a join plan carries the fact key's block row, the largest dim key and
// the dim block's shape in its header, and the launch two more device
// arrays: the dense key lookup (int32, -1 where no dim row holds the key) and
// the dim table's own block [D][n_dim]. The TPU kernel's XLA prologue built a
// joined [C, n_pad] block (fact rows, gathered dim rows, the match mask)
// before the kernel ran; here nothing is built. Once per tile, before the
// prediction slots, each thread converts its row's fact key toward zero (the
// planner's +-2^24 guard keeps it exact in f32), looks it up through __ldg
// and keeps the dim row, or -1, in a [kRows] array in shared memory. The
// programs then read it: DIM d loads column d of that dim row (row 0 for an
// unmatched row, as the TPU gathers), MATCHED is 1 or 0, and SEL is a true
// select (c != 0 ? a : b), so a NaN in an unmatched row's dim row never
// reaches a sum. An MLP's or a forest's feature may read a dim column too.
//
// Bound of K5 on the H100 (config 3: 1,048,576 fact rows joined to a
// 1,048,576-row dimension, four K2' slots of an 8->4 map): each used fact
// column, the 4 MiB lookup and each used dim column read once are about 50 MB
// (0.015 ms at 3.35 TB/s); the operations are a few hundred a row. It is
// bound by bytes; the kernel gathers the lookup and the dim rows at random,
// one 4-byte load a row each, so it is bound by the latency of those loads
// and of the interpreter, as K2 is.
//
// K2 b-e, the aggregate tail of infera_tpu/ops/pallas_sql.py (:264-363) and
// of the sum-slot families of infera_tpu/sql/device_plan.py (:951-1045). The
// TPU kernel had f32 alone, so it carried int64 columns as eight byte-limb
// rows summed in Neumaier pairs (b), compared int64 extremes as four 16-bit
// words in a lexicographic cascade (e), counted DISTINCT values with one-hot
// MXU matmuls per 128-value bank (c), and kept arg_min/arg_max as (value,
// row) lane pairs with NaN at 2^30 (d). The H100 has int64 and f64, so:
//  b. an int sum slot reads its row of the int64 block xi [I][n] into shared
//     memory per tile; the reduction adds it as unsigned long long (wrap
//     modulo 2^64 is exact whatever the order; signed overflow would be
//     undefined) and adds |v| in f64 to the slot's estimate row, which the
//     host holds to the SUM(BIGINT) overflow rule. var, count_if, product
//     and bool_and/or are programs on the sum, min and max slots.
//  c. a DISTINCT/MODE slot's value, when it is an integer in [0, v_dom), adds
//     1 to cell [group][value] of its int32 counts in device memory with
//     atomicAdd (G x v_dom reaches 1 MiB, over a block's shared memory;
//     integer adds commute, so the counts are exact and the same every run);
//     any other selected value sets the slot's flag bit. The fold of the
//     counts (distinct count and sum, or the mode) is torch ops on the host.
//  d. an arg slot keeps per group one 64-bit word: the order-preserving
//     32-bit key of the f32 value (-0.0 read as +0.0, as the host's np.less
//     ties them) above 24 bits of row id (2^24 - 1 - id for a max), reduced
//     by min or max, so the smallest row id wins a tie; a NaN sets the slot's
//     flag bit (the host's order lets a NaN win only as its group's first
//     row, so the host answers).
//  e. an int min or max slot keeps an int64 extreme per group.
// The per-block accumulators live in shared memory beside the core slots and
// are folded in block order like them.
//
// Bound of K2 b-e on the H100 (1,048,576 rows): each reads one or two
// columns (4 or 8 bytes a row) and does a few operations a row, so each is
// bound by bytes (about 0.002-0.01 ms at 3.35 TB/s); the kernel spends its
// time in the interpreter (its stack lives in local memory) and the
// latency of the programs' loads, and, for c, in the atomics on a few hot
// cells.
//
// The tile's reduction (warp_fold, combine_by_group below). The TPU kernel
// accumulated a tile as a masked one-hot sum over 128 lanes; here each warp
// folds its 32 rows per group (__match_any_sync; the lowest lane of a group
// folds its peers' values in lane order, or a fixed xor-shuffle tree where
// all the warp's selected rows share one group, as in every one-group plan),
// writing the fold over the group's own rows, and then one thread per
// (column, group) adds the 8 warps' folds in warp order. The serial depth of
// a tile is a warp's largest group (at most 32 steps) and 8 adds, not the
// 256 rows a group's thread once scanned.
//
// Grid and cross-block accumulation: blocks run in any order, so each
// persistent block keeps its own accumulators in shared memory and writes
// them to partials; a second kernel folds them, one warp per output element,
// each lane over the blocks in block order, then a fixed shuffle tree. The
// grid is the blocks resident on the card at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the plan's shared
// memory), so no block waits for a second wave; __launch_bounds__ asks for 3
// blocks an SM (2 in the kWide instance). No atomics on values: sums repeat
// bit for bit from run to run at one grid size.
#include "mma_tile.cuh"

#include <limits.h>
#include <math.h>

namespace infera {
namespace sql {

constexpr int kRows = 256;      // rows of a tile, one per thread (== kThreads)
constexpr int kMaxStack = 16;   // MAX_STACK in ops/fused_sql.py
constexpr int kSlotDesc = 17;   // words of a prediction slot's descriptor; the last is its kind
constexpr int kOutChunk = 4;    // class sums a forest walk keeps in registers
constexpr int kTreesInFlight = 8;  // trees a thread walks at once (TREES_IN_FLIGHT)
constexpr unsigned kLeaf = 0xFFFFu;  // a leaf record's feature (LEAF_FEATURE)
static_assert(kRows == kThreads, "one row per thread in the slot phase");
static_assert(kRows % kTileRows == 0, "MLP sub-tiles");

// opcodes: ops/fused_sql.py
enum Op {
  COL = 0, CONST, PRED, NEG, NOT, ADD, SUB, MUL, DIV, MOD, EQ, NE, LT, LE, GT, GE, AND, OR,
  BETWEEN, CAST_INT, CAST_FLOAT, ABS, SQRT, FLOOR, CEIL, ROUND, EXP, LOG, DIM, MATCHED, SEL,
  LOG2
};

// header words of the plan: ops/fused_sql.py pack_plan
enum Hdr {
  H_WORDS = 0, H_K, H_S, H_M, H_X, H_WHERE, H_J, H_G, H_NPROG, H_PROGS, H_CODE, H_CONSTS,
  H_STRIDES, H_PREDS, H_JOIN_KEY, H_JOIN_KMAX, H_JOIN_NDIM, H_JOIN_NCOLS, H_I, H_IS, H_D, H_A,
  H_TAIL, H_KEPT,
  H_SM_BLOB = 24, H_SM_ACT0, H_SM_ACT1, H_SM_PRED, H_SM_VALS, H_SM_KRAW, H_SM_KSLOT, H_SM_RIDX,
  H_SM_CNT, H_SM_SUMS, H_SM_MM, H_SM_FLAGS, H_SM_IVALS, H_SM_AVALS, H_SM_IACC, H_SM_IEST,
  H_SM_AACC, H_SM_LEAD, H_SM_TOTAL,
  H_SM_FTILE  // K4's feature tile [d_in][kRows] f32, -1: none (each node's program runs)
};
static_assert(H_TAIL == 22 && H_KEPT == 23 && H_SM_TOTAL == 42,
              "header layout of ops/fused_sql.py");

// the tail's slots (ops/fused_sql.py pack_plan): kTailDesc words each at
// plan[H_TAIL], int slots {block row, kind, estimate row or -1}, then
// DISTINCT/MODE slots {v_dom, first element of its counts}, then arg slots
// {is_min}
constexpr int kTailDesc = 4;
enum IntKind { KIND_SUM = 0, KIND_MIN, KIND_MAX };
constexpr int kRowBits = 24;                                   // ROW_BITS
constexpr unsigned long long kArgEmptyMin = 1ull << 62;        // ARG_EMPTY_MIN
constexpr unsigned long long kRowMask = (1ull << kRowBits) - 1;

// K2 d's word of a row: the f32 value's order key above its row id
__device__ inline unsigned long long arg_word(float v, long long row, bool is_min) {
  const unsigned u = __float_as_uint(v == 0.f ? 0.f : v);  // -0.0 ties +0.0
  const unsigned key = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  const unsigned long long low = is_min ? (unsigned long long)row : kRowMask - row;
  return ((unsigned long long)key << kRowBits) | low;
}

__device__ inline long long int_fold(long long acc, long long v, int kind) {
  if (kind == KIND_SUM) return (long long)((unsigned long long)acc + (unsigned long long)v);
  return kind == KIND_MIN ? (v < acc ? v : acc) : (v > acc ? v : acc);
}

__device__ inline long long int_start(int kind) {
  return kind == KIND_SUM ? 0 : (kind == KIND_MIN ? LLONG_MAX : LLONG_MIN);
}

// a prediction slot's kind (the descriptor's last word) and a forest slot's
// descriptor words: ops/fused_sql.py pack_plan
enum SlotKind { SLOT_MLP = 0, SLOT_FOREST = 1 };
enum ForestDesc {
  F_TREES = 0, F_NODES, F_DEPTH, F_NOUT, F_DIN, F_NODE_OFF, F_W_OFF, F_STRICT, F_BIAS, F_LOGISTIC,
  F_MODE, F_CBIAS_OFF, F_FEAT, F_LABEL_OFF, F_REC_SMEM, F_W_SMEM
};

__device__ inline float b2f(bool b) { return b ? 1.f : 0.f; }

// What a program reads: the table block x [C][n_pad] and, for a join plan,
// the dim block [D][n_dim] and the tile's dim rows (-1: no match) in shared
// memory.
struct Src {
  const float* x;
  long long n_pad;
  const float* dim;
  long long n_dim;
  const int* ridx;
};

// Program `prog` of the plan on one row; pred points at the tile's
// predictions [J][kRows] and r is the row's index in the tile.
__device__ float run_program(const int* __restrict__ plan, int prog, const Src& src,
                             long long row, const float* __restrict__ pred, int r) {
  const int* pt = plan + plan[H_PROGS] + 2 * prog;
  const int* code = plan + plan[H_CODE] + 2 * pt[0];
  const int len = pt[1];
  const float* consts = reinterpret_cast<const float*>(plan + plan[H_CONSTS]);
  float st[kMaxStack];
  int sp = 0;
  for (int i = 0; i < len; ++i) {
    const int op = code[2 * i];
    const int arg = code[2 * i + 1];
    switch (op) {
      case COL: st[sp++] = __ldg(src.x + (long long)arg * src.n_pad + row); break;
      case CONST: st[sp++] = consts[arg]; break;
      case PRED: st[sp++] = pred[arg * kRows + r]; break;
      case DIM: st[sp++] = __ldg(src.dim + (long long)arg * src.n_dim + max(src.ridx[r], 0)); break;
      case MATCHED: st[sp++] = b2f(src.ridx[r] >= 0); break;
      case SEL: {
        const float b = st[--sp];
        const float a = st[--sp];
        st[sp - 1] = st[sp - 1] != 0.f ? a : b;  // NaN selects a, as != 0 is its truth
        break;
      }
      case NEG: st[sp - 1] = -st[sp - 1]; break;
      case NOT: st[sp - 1] = b2f(st[sp - 1] == 0.f); break;
      case CAST_INT: st[sp - 1] = truncf(st[sp - 1]); break;
      case CAST_FLOAT: break;
      case ABS: st[sp - 1] = fabsf(st[sp - 1]); break;
      case SQRT: st[sp - 1] = __fsqrt_rn(st[sp - 1]); break;
      case FLOOR: st[sp - 1] = floorf(st[sp - 1]); break;
      case CEIL: st[sp - 1] = ceilf(st[sp - 1]); break;
      case ROUND: st[sp - 1] = rintf(st[sp - 1]); break;
      case EXP: st[sp - 1] = expf(st[sp - 1]); break;
      case LOG: st[sp - 1] = logf(st[sp - 1]); break;
      case LOG2: st[sp - 1] = log2f(st[sp - 1]); break;
      case BETWEEN: {
        const float hi = st[--sp];
        const float lo = st[--sp];
        const float v = st[sp - 1];
        st[sp - 1] = b2f(v >= lo && v <= hi);
        break;
      }
      default: {
        const float b = st[--sp];
        const float a = st[sp - 1];
        float v;
        switch (op) {
          case ADD: v = __fadd_rn(a, b); break;
          case SUB: v = __fsub_rn(a, b); break;
          case MUL: v = __fmul_rn(a, b); break;
          case DIV: v = __fdiv_rn(a, b); break;
          case MOD: {
            // jnp.mod: C's fmod (exact), moved to the divisor's sign
            v = fmodf(a, b);
            if (v != 0.f && ((v < 0.f) != (b < 0.f))) v = __fadd_rn(v, b);
            break;
          }
          case EQ: v = b2f(a == b); break;
          case NE: v = b2f(a != b); break;
          case LT: v = b2f(a < b); break;
          case LE: v = b2f(a <= b); break;
          case GT: v = b2f(a > b); break;
          case GE: v = b2f(a >= b); break;
          case AND: v = b2f(a != 0.f && b != 0.f); break;
          default: v = b2f(a != 0.f || b != 0.f); break;  // OR
        }
        st[sp - 1] = v;
      }
    }
  }
  return st[0];
}

// acc = min(acc, v) / max(acc, v) with NaN propagating (jnp.minimum/maximum)
__device__ inline float min_nan(float acc, float v) { return (v < acc || v != v) ? v : acc; }
__device__ inline float max_nan(float acc, float v) { return (v > acc || v != v) ? v : acc; }

// Rows 0..M-1 of the min/max block are min slots, M..M+X-1 max slots, then
// K raw-key minima and K raw-key maxima.
__device__ inline bool mm_is_min(int c, int M, int X, int K) {
  return c < M || (c >= M + X && c < M + X + K);
}

template <typename T>
__device__ inline T* at(unsigned char* smem, const int* plan, int which) {
  return reinterpret_cast<T*>(smem + plan[which]);
}

// Feature program `prog` of an MLP slot on row t of the tile (table row
// `row`): a bare column, a program that is one COL op, is read straight
// from the block (the same __ldg the interpreter makes, so the same bits);
// any other program runs in run_program.
__device__ inline int bare_column(const int* plan, int prog) {
  const int* pt = plan + plan[H_PROGS] + 2 * prog;
  const int* code = plan + plan[H_CODE] + 2 * pt[0];
  return pt[1] == 1 && code[0] == COL ? code[1] : -1;
}

__device__ inline float mlp_feature(const int* plan, int prog, const Src& src, long long row,
                                    const float* pred, int t) {
  const int c = bare_column(plan, prog);
  if (c >= 0) return __ldg(src.x + (long long)c * src.n_pad + row);
  return run_program(plan, prog, src, row, pred, t);
}

// MLP slot j (descriptor md) on sub-tile `sub` of the tile's rows: entries
// 64 sub .. 64 sub + 63 of `rows` (the tile's rows that the WHERE keeps, in
// row order; nullptr: every row, entry p is row p), of which the first
// `count` are rows. Row t's prediction goes to pred[j][t]; rows past `count`
// are zeros in the activation tile and write nothing. A feature may read an
// earlier slot. f32 layers run on the f32 cores (mlp_stack_ffma), bf16
// layers on the tensor cores (mlp_stack_bf16, only in the kWide instance).
template <bool kWide>
__device__ void mlp_slot(const int* plan, const int* md, int j, unsigned char* smem,
                         const Src& src, long long row0, const int* rows, int count, int sub) {
  unsigned char* s_blob = smem + plan[H_SM_BLOB];
  float* act0 = at<float>(smem, plan, H_SM_ACT0);
  float* act1 = at<float>(smem, plan, H_SM_ACT1);
  float* pred = at<float>(smem, plan, H_SM_PRED);
  MlpDims d;
  d.n_layers = md[0];
  for (int i = 0; i <= kMaxLayers; ++i) d.dim[i] = i <= d.n_layers ? md[1 + i] : 0;
  const int d_in = d.dim[0];
  const bool mma = kWide && md[12] != 0;
  const int feat = md[13];
  // this thread's row of the sub-tile: its entry p of the list, its row t
  // of the tile (-1 past count), and every (kThreads / 64)-th feature of it,
  // each feature's program recognised once (mlp_feature)
  const int r = threadIdx.x & (kTileRows - 1);
  const int p = sub * kTileRows + r;
  const int t = p < count ? (rows != nullptr ? rows[p] : p) : -1;
  constexpr int kFeatStep = kThreads / kTileRows;
  const float* h;
  if (mma) {
    // the A tile [64][mma_stride(d_in)] bf16 (RN), zero from d_in on, a
    // pair of features a 4-byte word
    unsigned char* a0 = reinterpret_cast<unsigned char*>(act0);
    unsigned char* a1 = reinterpret_cast<unsigned char*>(act1);
    __nv_bfloat16* a = mma_input(d, a0, a1);
    const int sa = mma_stride(d_in);
    for (int k = 2 * (threadIdx.x / kTileRows); k < sa; k += 2 * kFeatStep) {
      const float lo = t >= 0 && k < d_in ? mlp_feature(plan, feat + k, src, row0 + t, pred, t)
                                          : 0.f;
      const float hi = t >= 0 && k + 1 < d_in
                           ? mlp_feature(plan, feat + k + 1, src, row0 + t, pred, t)
                           : 0.f;
      *reinterpret_cast<unsigned*>(a + r * sa + k) = bf16x2_bits(lo, hi);
    }
    __syncthreads();
    h = mlp_stack_bf16(d, s_blob + 4 * md[10], a0, a1);
  } else {
    for (int k = threadIdx.x / kTileRows; k < d_in; k += kFeatStep)
      act0[k * kActStride + r] = t >= 0 ? mlp_feature(plan, feat + k, src, row0 + t, pred, t) : 0.f;
    __syncthreads();
    h = mlp_stack_ffma<Block, kWide>(d, reinterpret_cast<const float*>(s_blob) + md[10], act0,
                                     act1, Block());
  }
  if (threadIdx.x < kTileRows && t >= 0) {
    const int C = d.dim[d.n_layers];
    const int oc = md[14];
    float v = h[oc * kActStride + r];
    if (md[11]) {
      // softmax over the classes, as jax.nn.softmax: exp(x - max) / sum
      float m = h[r];
      for (int c = 1; c < C; ++c) m = fmaxf(m, h[c * kActStride + r]);
      float s = 0.f;
      for (int c = 0; c < C; ++c) s = __fadd_rn(s, expf(__fsub_rn(h[c * kActStride + r], m)));
      v = __fdiv_rn(expf(__fsub_rn(v, m)), s);
    }
    pred[j * kRows + t] = v;
  }
  __syncthreads();
}

__device__ inline bool is_finite(float v) { return fabsf(v) < INFINITY; }  // false for NaN

// K4's node record (ops/fused_sql.py forest_records): x the threshold's f32
// bits (a regressor's leaf: the leaf weight of its kept column), y the
// feature (kLeaf: a leaf) | true child << 16 | false child << 24. A tree's
// nodes are numbered level by level, so a warp's 32 rows read one level of
// one tree from one run of records; a leaf's children are itself.
template <bool kShared>
__device__ __forceinline__ uint2 node_record(const uint2* rec, int i) {
  if constexpr (kShared) return rec[i];
  else return __ldg(rec + i);
}

// Where K4 reads a row's feature f: its column of the feature tile
// (tile[f * kRows], one bank per row whatever f), or without a tile the
// feature program `prog + f` (a leaf reads nothing).
struct RowFeatures {
  const float* tile;
  const int* plan;
  int prog;
  const Src* src;
  long long row;
  const float* pred;
  int r;
  int last;  // d_in - 1
};

template <bool kTile>
__device__ __forceinline__ float row_feature(const RowFeatures& x, unsigned f) {
  if constexpr (kTile) return x.tile[min((int)f, x.last) * kRows];
  else return f == kLeaf ? 0.f : run_program(x.plan, x.prog + f, *x.src, x.row, x.pred, x.r);
}

// A row with a non-finite feature sees NaN at every node that tests
// another feature (the one-hot product of the TPU kernel and of the host's
// GEMM forest: inf * 0 is NaN): feature value v under the row's count of
// non-finite features.
__device__ __forceinline__ float one_hot_value(float v, int nonfin) {
  return nonfin > (is_finite(v) ? 0 : 1) ? __int_as_float(0x7fc00000) : v;
}

// K4's walk for one row over forest fd's records `rec` (shared memory:
// kShared) and a classifier's leaf weights w [T * M][n_out] (shared or
// device memory, one generic load; through __ldg query E ran slower on an
// H100): kG trees at a time, `depth` levels, each level issuing the
// group's record loads and then its feature loads before it uses any;
// a tree that has reached its leaf loops on it. The last group's trees past
// T walk the last tree and add nothing. Then the group's leaf weights are
// added in tree order with __fadd_rn, as forest_plain adds them: a
// regressor's (from its leaf records) to acc[0], a classifier's classes
// [c0, c0 + nc) to acc.
// The tile holds the features with one_hot_value applied; without it the
// walk applies it at each node (nonfin counts the row's non-finite
// features). kStrict compares with <, else <=.
template <int kG, bool kShared, bool kTile, bool kStrict>
__device__ void forest_walk(const int* fd, const uint2* __restrict__ rec, const float* w,
                            const RowFeatures& x, int nonfin, int c0, int nc,
                            float (&acc)[kOutChunk]) {
  const int T = fd[F_TREES], M = fd[F_NODES], depth = fd[F_DEPTH], n_out = fd[F_NOUT];
  const bool regressor = fd[F_MODE] == 0;
  for (int t0 = 0; t0 < T; t0 += kG) {
    int base[kG], k[kG];
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      base[i] = min(t0 + i, T - 1) * M;
      k[i] = 0;
    }
    for (int level = 0; level < depth; ++level) {
      uint2 nd[kG];
      float v[kG];
#pragma unroll
      for (int i = 0; i < kG; ++i) nd[i] = node_record<kShared>(rec, base[i] + k[i]);
#pragma unroll
      for (int i = 0; i < kG; ++i) v[i] = row_feature<kTile>(x, nd[i].y & kLeaf);
#pragma unroll
      for (int i = 0; i < kG; ++i) {
        const float f = kTile ? v[i] : one_hot_value(v[i], nonfin);
        const float th = __uint_as_float(nd[i].x);
        k[i] = (kStrict ? f < th : f <= th) ? (nd[i].y >> 16) & 0xFFu : nd[i].y >> 24;
      }
    }
    if (regressor) {
      float lw[kG];
#pragma unroll
      for (int i = 0; i < kG; ++i)
        lw[i] = __uint_as_float(node_record<kShared>(rec, base[i] + k[i]).x);
#pragma unroll
      for (int i = 0; i < kG; ++i)
        if (t0 + i < T) acc[0] = __fadd_rn(acc[0], lw[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kG; ++i) {
        if (t0 + i >= T) break;
        const float* wl = w + (long long)(base[i] + k[i]) * n_out + c0;
#pragma unroll
        for (int c = 0; c < kOutChunk; ++c)
          if (c < nc) acc[c] = __fadd_rn(acc[c], wl[c]);
      }
    }
  }
}

// jnp.argmax over scores seen one at a time: the first maximum, a NaN wins.
__device__ inline void argmax_step(float v, int c, float& best, int& idx) {
  if (c == 0 || (best == best && (v > best || v != v))) {
    best = v;
    idx = c;
  }
}

// Forest slot j (descriptor fd, K4) on the tile's rows, one per thread: its
// prediction goes to pred[j][r]. The row's features are evaluated once, into
// its column of the feature tile where the plan has one (counting the
// non-finite ones); the walk reads the records from shared memory where the
// plan placed them there, else from device memory.
__device__ void forest_slot(const int* plan, const int* fd, int j, unsigned char* smem,
                            const int* __restrict__ trees, const Src& src, long long n,
                            long long row0) {
  float* pred = at<float>(smem, plan, H_SM_PRED);
  const int r = threadIdx.x;
  const long long row = row0 + r;
  float out = 0.f;
  if (row < n) {
    const int d_in = fd[F_DIN], mode = fd[F_MODE], prog = fd[F_FEAT];
    float* tile = plan[H_SM_FTILE] >= 0 ? at<float>(smem, plan, H_SM_FTILE) + r : nullptr;
    const RowFeatures x{tile, plan, prog, &src, row, pred, r, d_in - 1};
    int nonfin = 0;
    if (tile != nullptr) {
      // bare columns kStage at a time, every load issued before the first
      // store; then any other feature program
      constexpr int kStage = 8;
      for (int f0 = 0; f0 < d_in; f0 += kStage) {
        float v[kStage];
#pragma unroll
        for (int i = 0; i < kStage; ++i) {
          const int c = f0 + i < d_in ? bare_column(plan, prog + f0 + i) : -1;
          v[i] = c >= 0 ? __ldg(src.x + (long long)c * src.n_pad + row) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kStage; ++i)
          if (f0 + i < d_in) tile[(f0 + i) * kRows] = v[i];
      }
      for (int f = 0; f < d_in; ++f)
        if (bare_column(plan, prog + f) < 0)
          tile[f * kRows] = run_program(plan, prog + f, src, row, pred, r);
      for (int f = 0; f < d_in; ++f) nonfin += is_finite(tile[f * kRows]) ? 0 : 1;
      if (nonfin > 0)
        for (int f = 0; f < d_in; ++f) tile[f * kRows] = one_hot_value(tile[f * kRows], nonfin);
    } else {
      for (int f = 0; f < d_in; ++f)
        nonfin += is_finite(mlp_feature(plan, prog + f, src, row, pred, r)) ? 0 : 1;
    }
    const bool rec_shared = tile != nullptr && fd[F_REC_SMEM] >= 0;
    const uint2* rec = reinterpret_cast<const uint2*>(
        rec_shared ? smem + fd[F_REC_SMEM]
                   : reinterpret_cast<const unsigned char*>(trees + fd[F_NODE_OFF]));
    const float* w = fd[F_W_SMEM] >= 0   ? reinterpret_cast<const float*>(smem + fd[F_W_SMEM])
                     : fd[F_W_OFF] >= 0 ? reinterpret_cast<const float*>(trees + fd[F_W_OFF])
                                        : nullptr;  // a regressor's lie in its records
    const bool strict = fd[F_STRICT] != 0;
    constexpr int kG = kTreesInFlight;
    auto walk = [&](int c0, int nc, float (&acc)[kOutChunk]) {
      if (tile == nullptr) {
        if (strict) forest_walk<1, false, false, true>(fd, rec, w, x, nonfin, c0, nc, acc);
        else forest_walk<1, false, false, false>(fd, rec, w, x, nonfin, c0, nc, acc);
      } else if (rec_shared) {
        if (strict) forest_walk<kG, true, true, true>(fd, rec, w, x, 0, c0, nc, acc);
        else forest_walk<kG, true, true, false>(fd, rec, w, x, 0, c0, nc, acc);
      } else {
        if (strict) forest_walk<kG, false, true, true>(fd, rec, w, x, 0, c0, nc, acc);
        else forest_walk<kG, false, true, false>(fd, rec, w, x, 0, c0, nc, acc);
      }
    };
    if (mode == 0) {
      // regressor: the kept column plus its base, then an optional logistic
      float acc[kOutChunk] = {0.f, 0.f, 0.f, 0.f};
      walk(0, 1, acc);
      out = __fadd_rn(acc[0], __int_as_float(fd[F_BIAS]));
      if (fd[F_LOGISTIC]) out = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-out)));
    } else {
      // classifier: per-class base, (binary expansion), argmax, label map;
      // one walk per kOutChunk classes, their sums in registers
      const int n_out = fd[F_NOUT];
      const float* cbias =
          fd[F_CBIAS_OFF] >= 0 ? reinterpret_cast<const float*>(trees + fd[F_CBIAS_OFF]) : nullptr;
      float best = 0.f;
      int idx = 0;
      auto score = [&](float s, int c) {
        if (cbias != nullptr) s = __fadd_rn(s, __ldg(cbias + c));
        if (mode == 2) {
          argmax_step(-s, 0, best, idx);
          argmax_step(s, 1, best, idx);
        } else {
          argmax_step(s, c, best, idx);
        }
      };
      for (int c0 = 0; c0 < n_out; c0 += kOutChunk) {
        const int nc = min(kOutChunk, n_out - c0);
        float acc[kOutChunk] = {0.f, 0.f, 0.f, 0.f};
        walk(c0, nc, acc);
#pragma unroll
        for (int i = 0; i < kOutChunk; ++i)
          if (i < nc) score(acc[i], c0 + i);
      }
      out = fd[F_LABEL_OFF] >= 0
                ? __ldg(reinterpret_cast<const float*>(trees + fd[F_LABEL_OFF]) + idx)
                : (float)idx;
    }
  }
  pred[j * kRows + r] = out;
}

// ------------------------------------------------------------ the tile's reduction
//
// After the slot phase every selected row t of the tile holds its values in
// shared memory (vals, kraw, ivals, avals) and its group in a register (-1:
// not selected). warp_fold: within each warp, __match_any_sync gives the
// lanes of each group; the lowest of them, the group's leader, folds their
// values in lane order and writes the fold back over the rows of the group,
// so the fold needs no memory of its own: a row that is its group's only
// row keeps its value; otherwise an f64 sum is split over the words of the
// leader's row (low) and of the group's second row t2 (high), a raw key's
// minimum stays at the leader's row and its maximum goes to t2, and an int
// sum's f64 estimate goes to t2's int64 word. A warp whose selected rows
// all share one group (every warp of a one-group plan) folds with a fixed
// __shfl_xor_sync tree instead. kslot[t] says what row t holds: -1, or for
// a leader group | count << 16 | lane of t2 << 22. The leaders also enter
// their lane in lead[warp][group]. combine_by_group then adds the 8 warps'
// folds of each (column, group) in warp order, one thread per pair; a
// plan with no room for lead takes combine_by_column, one thread per
// column over every leader in warp order. No two threads write one
// accumulator, and no value is added with an atomic: the sums repeat bit
// for bit from run to run.

constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ inline int lead_info(int g, int count, int lane2) {
  return g | (count << 16) | (lane2 << 22);
}

__device__ inline void put_f64(float* row, int t, int t2, double v) {
  int* w = reinterpret_cast<int*>(row);
  w[t] = __double2loint(v);
  w[t2] = __double2hiint(v);
}

__device__ inline double get_f64(const float* row, int t, int t2, int count) {
  if (count == 1) return (double)row[t];
  const int* w = reinterpret_cast<const int*>(row);
  return __hiloint2double(w[t2], w[t]);
}

template <typename T>
__device__ inline T xor_tree(T v, int op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T u = __shfl_xor_sync(kFull, v, o);
    switch (op) {
      case 0: v = v + u; break;                        // f64 or wrapping sum
      case 1: v = u < v ? u : v; break;                // integer min
      default: v = u > v ? u : v; break;               // integer max
    }
  }
  return v;
}

__device__ inline float xor_tree_mm(float v, int op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(kFull, v, o);
    switch (op) {
      case 0: v = min_nan(v, u); break;
      case 1: v = max_nan(v, u); break;
      case 2: v = fminf(v, u); break;
      default: v = fmaxf(v, u); break;
    }
  }
  return v;
}

__device__ void warp_fold(const int* plan, int slot, float* vals, float* kraw, long long* ivals,
                          unsigned long long* avals, int* kslot, unsigned char* lead) {
  const int K = plan[H_K], S = plan[H_S], M = plan[H_M], X = plan[H_X], G = plan[H_G];
  const int I = plan[H_I], A = plan[H_A];
  const int* idesc = plan + plan[H_TAIL];
  const int* adesc = idesc + kTailDesc * (I + plan[H_D]);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int base = t - lane;
  const unsigned sel = __ballot_sync(kFull, slot >= 0);
  const unsigned peers = __match_any_sync(kFull, slot);
  kslot[t] = -1;
  if (sel == 0) return;  // uniform across the warp
  const int first = __ffs(sel) - 1;
  if (__shfl_sync(kFull, peers, first) == sel) {
    // one group: fixed xor trees over the warp, unselected lanes neutral
    const bool on = slot >= 0;
    const int count = __popc(sel);
    const int l2 = count > 1 ? __ffs(sel & (sel - 1)) - 1 : first;
    const int t0 = base + first, t2 = base + l2;
    for (int s = 0; s < S; ++s) {
      const double v = xor_tree(on ? (double)vals[s * kRows + t] : 0.0, 0);
      if (lane == first && count > 1) put_f64(vals + s * kRows, t0, t2, v);
    }
    for (int c = 0; c < M + X; ++c) {
      float* row = vals + (S + c) * kRows;
      const bool mn = c < M;
      const float v = xor_tree_mm(on ? row[t] : (mn ? INFINITY : -INFINITY), mn ? 0 : 1);
      if (lane == first) row[t0] = v;
    }
    for (int k = 0; k < K; ++k) {
      float* row = kraw + k * kRows;
      const float lo = xor_tree_mm(on ? row[t] : INFINITY, 2);
      const float hi = xor_tree_mm(on ? row[t] : -INFINITY, 3);
      if (lane == first) {
        row[t0] = lo;
        row[t2] = hi;
      }
    }
    for (int i = 0; i < I; ++i) {
      long long* row = ivals + i * kRows;
      const int kind = idesc[kTailDesc * i + 1];
      const long long v = on ? row[t] : int_start(kind);
      long long f;
      if (kind == KIND_SUM) {
        f = (long long)xor_tree((unsigned long long)v, 0);
        const double e = xor_tree(on ? fabs((double)v) : 0.0, 0);
        if (lane == first && count > 1) row[t2] = __double_as_longlong(e);
      } else {
        f = xor_tree(v, kind == KIND_MIN ? 1 : 2);
      }
      if (lane == first) row[t0] = f;
    }
    for (int a = 0; a < A; ++a) {
      unsigned long long* row = avals + a * kRows;
      const bool is_min = adesc[kTailDesc * a] != 0;
      const unsigned long long v = xor_tree(on ? row[t] : (is_min ? ~0ull : 0ull), is_min ? 1 : 2);
      if (lane == first) row[t0] = v;
    }
    __syncwarp();
    if (lane == first) {
      kslot[t0] = lead_info(slot, count, l2);
      if (lead != nullptr) lead[(t >> 5) * G + slot] = (unsigned char)lane;
    }
    return;
  }
  if (slot < 0 || (peers & ((1u << lane) - 1)) != 0) return;  // not a leader
  // the leader folds its group's rows in lane order
  const int count = __popc(peers);
  kslot[t] = lead_info(slot, count, count > 1 ? __ffs(peers & (peers - 1)) - 1 : lane);
  if (lead != nullptr) lead[(t >> 5) * G + slot] = (unsigned char)lane;
  if (count == 1) return;  // its row is its fold
  const int t2 = base + __ffs(peers & (peers - 1)) - 1;
  for (int s = 0; s < S; ++s) {
    const float* row = vals + s * kRows;
    double acc = 0.0;
    for (unsigned m = peers; m; m &= m - 1) acc += (double)row[base + __ffs(m) - 1];
    put_f64(vals + s * kRows, t, t2, acc);
  }
  for (int c = 0; c < M + X; ++c) {
    float* row = vals + (S + c) * kRows;
    float acc = row[t];
    for (unsigned m = peers & (peers - 1); m; m &= m - 1) {
      const float v = row[base + __ffs(m) - 1];
      acc = c < M ? min_nan(acc, v) : max_nan(acc, v);
    }
    row[t] = acc;
  }
  for (int k = 0; k < K; ++k) {
    float* row = kraw + k * kRows;
    float lo = row[t], hi = row[t];
    for (unsigned m = peers & (peers - 1); m; m &= m - 1) {
      const float v = row[base + __ffs(m) - 1];
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
    row[t] = lo;
    row[t2] = hi;
  }
  for (int i = 0; i < I; ++i) {
    long long* row = ivals + i * kRows;
    const int kind = idesc[kTailDesc * i + 1];
    long long acc = row[t];
    double est = fabs((double)acc);
    for (unsigned m = peers & (peers - 1); m; m &= m - 1) {
      const long long v = row[base + __ffs(m) - 1];
      acc = int_fold(acc, v, kind);
      est += fabs((double)v);
    }
    row[t] = acc;
    if (kind == KIND_SUM) row[t2] = __double_as_longlong(est);
  }
  for (int a = 0; a < A; ++a) {
    unsigned long long* row = avals + a * kRows;
    const bool is_min = adesc[kTailDesc * a] != 0;
    unsigned long long acc = row[t];
    for (unsigned m = peers & (peers - 1); m; m &= m - 1) {
      const unsigned long long w = row[base + __ffs(m) - 1];
      if (is_min ? w < acc : w > acc) acc = w;
    }
    row[t] = acc;
  }
}

// Column c of the fold at leader row t (kslot info `info`) into group g's
// accumulator. Columns: 0 the count, then S sums, M + X min/max slots, K
// raw-key minima, K raw-key maxima, I int slots (with an int sum's
// estimate), A arg slots.
__device__ inline void add_column(const int* plan, int c, int t, int info, const float* vals,
                                  const float* kraw, const long long* ivals,
                                  const unsigned long long* avals, long long* cnt, double* sums,
                                  float* mm, long long* iacc, double* iest,
                                  unsigned long long* aacc) {
  const int K = plan[H_K], S = plan[H_S], M = plan[H_M], X = plan[H_X], G = plan[H_G];
  const int I = plan[H_I];
  const int g = info & 0xffff;
  const int count = (info >> 16) & 63;
  const int t2 = (t & ~31) + ((info >> 22) & 31);
  if (c == 0) {
    cnt[g] += count;
    return;
  }
  c -= 1;
  if (c < S) {
    sums[c * G + g] += get_f64(vals + c * kRows, t, t2, count);
    return;
  }
  c -= S;
  if (c < M + X) {
    float& acc = mm[c * G + g];
    const float v = vals[(S + c) * kRows + t];
    acc = c < M ? min_nan(acc, v) : max_nan(acc, v);
    return;
  }
  c -= M + X;
  if (c < 2 * K) {
    const int k = c < K ? c : c - K;
    const float v = kraw[k * kRows + (c < K ? t : t2)];
    float& acc = mm[(M + X + c) * G + g];
    acc = c < K ? fminf(acc, v) : fmaxf(acc, v);
    return;
  }
  c -= 2 * K;
  const int* idesc = plan + plan[H_TAIL];
  if (c < I) {
    const int* id = idesc + kTailDesc * c;
    const long long* row = ivals + c * kRows;
    iacc[c * G + g] = int_fold(iacc[c * G + g], row[t], id[1]);
    if (id[1] == KIND_SUM)
      iest[id[2] * G + g] += count == 1 ? fabs((double)row[t]) : __longlong_as_double(row[t2]);
    return;
  }
  c -= I;
  const int* adesc = idesc + kTailDesc * (I + plan[H_D]);
  const unsigned long long w = avals[c * kRows + t];
  unsigned long long& acc = aacc[c * G + g];
  if (adesc[kTailDesc * c] ? w < acc : w > acc) acc = w;
}

__device__ inline int n_columns(const int* plan) {
  return 1 + plan[H_S] + plan[H_M] + plan[H_X] + 2 * plan[H_K] + plan[H_I] + plan[H_A];
}

// One thread per (column, group): the 8 warps' folds of the group in warp
// order, each found through lead (a stale byte names a row whose kslot
// is not this group's leader, and is passed over).
__device__ void combine_by_group(const int* plan, const float* vals, const float* kraw,
                                 const long long* ivals, const unsigned long long* avals,
                                 const int* kslot, const unsigned char* lead, long long* cnt,
                                 double* sums, float* mm, long long* iacc, double* iest,
                                 unsigned long long* aacc) {
  const int G = plan[H_G];
  const int items = n_columns(plan) * G;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int c = it / G;
    const int g = it - c * G;
    for (int w = 0; w < kWarps; ++w) {
      const int t = 32 * w + (lead[w * G + g] & 31);
      const int info = kslot[t];
      if (info < 0 || (info & 0xffff) != g) continue;
      add_column(plan, c, t, info, vals, kraw, ivals, avals, cnt, sums, mm, iacc, iest, aacc);
    }
  }
}

// One thread per column: every leader of the tile in warp order.
__device__ void combine_by_column(const int* plan, const float* vals, const float* kraw,
                                  const long long* ivals, const unsigned long long* avals,
                                  const int* kslot, long long* cnt, double* sums, float* mm,
                                  long long* iacc, double* iest, unsigned long long* aacc) {
  const int cols = n_columns(plan);
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    for (int t = 0; t < kRows; ++t) {
      const int info = kslot[t];
      if (info >= 0)
        add_column(plan, c, t, info, vals, kraw, ivals, avals, cnt, sums, mm, iacc, iest, aacc);
    }
  }
}

// Two instances. kWide = false asks for 3 blocks an SM: ptxas keeps it in
// 80 registers without a spill (left free the kernel took 104, 2 blocks an
// SM; at 4 blocks, 64 registers, it spilled), so 24 warps an SM hide the
// latency of the programs' loads. It runs every plan but those below, its
// f32 layers on the narrow and thin tiles alone (the flagship's 4-32-1 MLP,
// the join's 8-4 map). kWide = true adds the 128-column passes' 4 x 8
// register tile and the tensor-core layers (32 accumulators and 16
// fragment registers a warp in flight), which at 80 registers spilled: it
// asks for 2 blocks an SM (128 registers), as K1 bf16 does, and runs a plan
// with a bf16 slot or an f32 layer of 128 columns or more, and every plan
// with a forest slot: K4's trees in flight spilled at 80 registers, and its
// records hold D's and E's plans (about 89 KB) to 2 blocks an SM anyway;
// the other instance holds no forest code. Query B's f32 plan (about 170
// KB of shared memory) fits one block an SM either way, its bf16 plan
// (about 93 KB) two.
template <bool kWide>
__global__ void __launch_bounds__(kThreads, kWide ? 2 : 3)
fused_sql_kernel(const float* __restrict__ x, long long n_pad, long long n,
                 const int* __restrict__ gplan, const float* __restrict__ blob, int blob_words16,
                 const int* __restrict__ trees, const int* __restrict__ lookup,
                 const float* __restrict__ dim, const long long* __restrict__ xi,
                 long long xi_stride, int* __restrict__ dmat, long long* __restrict__ part_cnt,
                 double* __restrict__ part_sum, float* __restrict__ part_mm,
                 long long* __restrict__ part_int, double* __restrict__ part_iest,
                 unsigned long long* __restrict__ part_arg, int* __restrict__ part_flags) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* plan = reinterpret_cast<int*>(smem);
  const int n_words = __ldg(gplan + H_WORDS);
  for (int i = threadIdx.x; i < n_words; i += kThreads) plan[i] = gplan[i];
  __syncthreads();
  const int K = plan[H_K], S = plan[H_S], M = plan[H_M], X = plan[H_X];
  const int J = plan[H_J], G = plan[H_G];
  const int has_where = plan[H_WHERE];
  const bool kept_only = plan[H_KEPT] != 0;  // MLP slots on the rows the WHERE keeps
  const int R = M + X + 2 * K;
  const int SMX = S + M + X;
  const int I = plan[H_I], IS = plan[H_IS], D = plan[H_D], A = plan[H_A];
  const int* idesc = plan + plan[H_TAIL];           // int slots
  const int* ddesc = idesc + kTailDesc * I;         // DISTINCT/MODE slots
  const int* adesc = ddesc + kTailDesc * D;         // arg slots
  const int* strides = plan + plan[H_STRIDES];
  if (blob_words16 > 0) copy_words16(at<float>(smem, plan, H_SM_BLOB), blob, blob_words16);
  // K4: the records and leaf weights the plan places in shared memory, once
  // per block (ordered before the first tile by the barrier below)
  for (int j = 0; kWide && j < J; ++j) {
    const int* fd = plan + plan[H_PREDS] + j * kSlotDesc;
    if (fd[kSlotDesc - 1] != SLOT_FOREST) continue;
    const int nodes = fd[F_TREES] * fd[F_NODES];
    if (fd[F_REC_SMEM] >= 0)
      copy_words16(smem + fd[F_REC_SMEM], trees + fd[F_NODE_OFF], (8 * nodes + 15) / 16);
    if (fd[F_W_SMEM] >= 0)
      copy_words16(smem + fd[F_W_SMEM], trees + fd[F_W_OFF], (4 * nodes * fd[F_NOUT] + 15) / 16);
  }
  float* pred = at<float>(smem, plan, H_SM_PRED);
  float* vals = at<float>(smem, plan, H_SM_VALS);    // [S + M + X][kRows]
  float* kraw = at<float>(smem, plan, H_SM_KRAW);    // [K][kRows]
  // [kRows]: the kept rows' list before the slot phase, then a leader's
  // fold (warp_fold)
  int* kslot = at<int>(smem, plan, H_SM_KSLOT);
  long long* cnt = at<long long>(smem, plan, H_SM_CNT);
  double* sums = at<double>(smem, plan, H_SM_SUMS);  // [S][G]
  float* mm = at<float>(smem, plan, H_SM_MM);        // [R][G]
  int* flags = at<int>(smem, plan, H_SM_FLAGS);
  int* ridx = at<int>(smem, plan, H_SM_RIDX);        // [kRows]: dim row, -1 if none (K5)
  long long* ivals = at<long long>(smem, plan, H_SM_IVALS);  // [I][kRows]
  unsigned long long* avals = at<unsigned long long>(smem, plan, H_SM_AVALS);  // [A][kRows]
  long long* iacc = at<long long>(smem, plan, H_SM_IACC);    // [I][G]
  double* iest = at<double>(smem, plan, H_SM_IEST);          // [IS][G]
  unsigned long long* aacc = at<unsigned long long>(smem, plan, H_SM_AACC);  // [A][G]
  // [kWarps][G]: each warp's leader lane of a group; over the tile's dead
  // MLP and prediction rows, or absent (-1) where a plan has no room for it
  unsigned char* lead = plan[H_SM_LEAD] >= 0 ? smem + plan[H_SM_LEAD] : nullptr;
  const int join_key = plan[H_JOIN_KEY];             // fact key's block row, -1: no join
  const int kmax = plan[H_JOIN_KMAX];
  const Src src{x, n_pad, dim, join_key >= 0 ? (long long)plan[H_JOIN_NDIM] : 0, ridx};
  for (int g = threadIdx.x; g < G; g += kThreads) {
    cnt[g] = 0;
    for (int s = 0; s < S; ++s) sums[s * G + g] = 0.0;
    for (int c = 0; c < R; ++c) mm[c * G + g] = mm_is_min(c, M, X, K) ? INFINITY : -INFINITY;
    for (int i = 0; i < I; ++i) iacc[i * G + g] = int_start(idesc[kTailDesc * i + 1]);
    for (int i = 0; i < IS; ++i) iest[i * G + g] = 0.0;
    for (int a = 0; a < A; ++a) aacc[a * G + g] = adesc[kTailDesc * a] ? kArgEmptyMin : 0ull;
  }
  if (threadIdx.x == 0) *flags = 0;
  __syncthreads();

  const int p_key = has_where;
  const int p_val = p_key + K;
  const int p_dist = p_val + SMX;
  const int p_arg = p_dist + D;
  const long long n_tiles = (n + kRows - 1) / kRows;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * kRows;
    if (join_key >= 0) {
      // K5's prologue: the row's dim row through the dense key lookup
      const long long row = row0 + threadIdx.x;
      int ri = -1;
      if (row < n) {
        const int fk = __float2int_rz(__ldg(x + (long long)join_key * n_pad + row));
        if (fk >= 0 && fk <= kmax) ri = __ldg(lookup + fk);
      }
      ridx[threadIdx.x] = ri;
      __syncthreads();
    }
    // the rows the MLP slots run on: every row of the tile, or where the
    // WHERE reads no prediction, the rows it keeps, listed in row order in
    // kslot (a warp ballot, then each warp's count before it)
    int count = (int)min((long long)kRows, n - row0);
    bool keep = false;
    if (kept_only) {
      const int t = threadIdx.x;
      keep = row0 + t < n && run_program(plan, 0, src, row0 + t, pred, t) != 0.f;  // NaN: true
      const unsigned b = __ballot_sync(kFull, keep);
      int* warp_kept = reinterpret_cast<int*>(pred);  // [kWarps], before a slot writes pred
      if ((t & 31) == 0) warp_kept[t >> 5] = __popc(b);
      __syncthreads();
      int before = 0;
      count = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int c = warp_kept[w];
        if (w < (t >> 5)) before += c;
        count += c;
      }
      if (keep) kslot[before + __popc(b & ((1u << (t & 31)) - 1))] = t;
      __syncthreads();
    }
    // prediction slots, in order: a feature may read an earlier slot
    for (int j = 0; j < J; ++j) {
      const int* md = plan + plan[H_PREDS] + j * kSlotDesc;
      if (md[kSlotDesc - 1] == SLOT_FOREST) {
        // the other instance holds no forest code: a forest plan launched
        // there (wide_instance decides) fails rather than keep stale values
        if constexpr (kWide) forest_slot(plan, md, j, smem, trees, src, n, row0);
        else __trap();
        __syncthreads();
        continue;
      }
      for (int sub = 0; sub * kTileRows < count; ++sub)  // count is uniform across the block
        mlp_slot<kWide>(plan, md, j, smem, src, row0, kept_only ? kslot : nullptr, count, sub);
    }
    // slot phase: one row per thread
    const int t = threadIdx.x;
    const long long row = row0 + t;
    int slot = -1;
    int fl = 0;
    const bool selected =
        kept_only ? keep
                  : row < n && (!has_where || run_program(plan, 0, src, row, pred, t) != 0.f);
    if (selected) {
      unsigned comb = 0;
      for (int k = 0; k < K; ++k) {
        const float r = run_program(plan, p_key + k, src, row, pred, t);
        const int ri = __float2int_rz(r);  // toward zero, saturating, NaN -> 0
        const float rt = __int2float_rn(ri);
        if (r != rt) fl |= 1 << k;
        if (fabsf(r) >= 16777216.f) fl |= 1 << K;
        comb += (unsigned)ri * (unsigned)strides[k];  // int32 wrap-around
        kraw[k * kRows + t] = rt;
      }
      int g = (int)comb % G;
      slot = g < 0 ? g + G : g;
      for (int s = 0; s < SMX; ++s)
        vals[s * kRows + t] = run_program(plan, p_val + s, src, row, pred, t);
      for (int d = 0; d < D; ++d) {
        // K2 c: the value's count in its group, if it is an integer in [0, v_dom)
        const int* dd = ddesc + kTailDesc * d;
        const float v = run_program(plan, p_dist + d, src, row, pred, t);
        const float vt = truncf(v);
        if (v == vt && v >= 0.f && v < (float)dd[0])
          atomicAdd(dmat + dd[1] + (long long)slot * dd[0] + (int)vt, 1);
        else
          fl |= 1 << (K + 1 + d);
      }
      for (int a = 0; a < A; ++a) {
        // K2 d: the row's word; a NaN flags the slot and takes no part
        const bool is_min = adesc[kTailDesc * a] != 0;
        const float v = run_program(plan, p_arg + a, src, row, pred, t);
        unsigned long long w;
        if (v != v) {
          fl |= 1 << (K + 1 + D + a);
          w = is_min ? kArgEmptyMin : 0ull;
        } else {
          w = arg_word(v, row, is_min);
        }
        avals[a * kRows + t] = w;
      }
      for (int i = 0; i < I; ++i)  // K2 b, e: the row's int64 value
        ivals[i * kRows + t] = __ldg(xi + (long long)idesc[kTailDesc * i] * xi_stride + row);
    }
    if (fl) atomicOr(flags, fl);
    __syncthreads();
    // the tile's reduction: each warp folds its rows per group in lane
    // order, then the warps' folds enter the block's accumulators in warp
    // order (warp_fold, combine)
    warp_fold(plan, slot, vals, kraw, ivals, avals, kslot, lead);
    __syncthreads();
    if (lead != nullptr)
      combine_by_group(plan, vals, kraw, ivals, avals, kslot, lead, cnt, sums, mm, iacc, iest,
                       aacc);
    else
      combine_by_column(plan, vals, kraw, ivals, avals, kslot, cnt, sums, mm, iacc, iest, aacc);
    __syncthreads();
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    part_cnt[(long long)blockIdx.x * G + g] = cnt[g];
    for (int s = 0; s < S; ++s) part_sum[((long long)blockIdx.x * S + s) * G + g] = sums[s * G + g];
    for (int c = 0; c < R; ++c) part_mm[((long long)blockIdx.x * R + c) * G + g] = mm[c * G + g];
    for (int i = 0; i < I; ++i)
      part_int[((long long)blockIdx.x * I + i) * G + g] = iacc[i * G + g];
    for (int i = 0; i < IS; ++i)
      part_iest[((long long)blockIdx.x * IS + i) * G + g] = iest[i * G + g];
    for (int a = 0; a < A; ++a)
      part_arg[((long long)blockIdx.x * A + a) * G + g] = aacc[a * G + g];
  }
  if (threadIdx.x == 0) part_flags[blockIdx.x] = *flags;
}

// One warp per output element: lane l adds the partials of blocks l, l +
// 32, ... in block order, then a fixed __shfl_xor_sync tree adds the 32
// lanes, so the fold repeats bit for bit. The sections of the output, in
// order: G counts, S x G sums, R x G min/max rows, I x G int slots, IS x G
// estimates, A x G arg words, the flag word.
__global__ void fused_sql_fold(const int* __restrict__ plan,
                               const long long* __restrict__ part_cnt,
                               const double* __restrict__ part_sum,
                               const float* __restrict__ part_mm,
                               const long long* __restrict__ part_int,
                               const double* __restrict__ part_iest,
                               const unsigned long long* __restrict__ part_arg,
                               const int* __restrict__ part_flags, int n_blocks, int G, int S,
                               int R, int I, int IS, int A, long long* __restrict__ cnt,
                               double* __restrict__ sums, float* __restrict__ mm,
                               long long* __restrict__ ints, double* __restrict__ iest,
                               unsigned long long* __restrict__ args, int* __restrict__ flags) {
  const int M = plan[H_M], X = plan[H_X], K = plan[H_K];
  const int* idesc = plan + plan[H_TAIL];
  const int* adesc = idesc + kTailDesc * (I + plan[H_D]);
  const int lane = threadIdx.x & 31;
  long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;  // uniform in a warp
  if (i < G) {
    long long c = 0;
    for (int b = lane; b < n_blocks; b += 32) c += part_cnt[(long long)b * G + i];
    c = xor_tree(c, 0);
    if (lane == 0) cnt[i] = c;
    return;
  }
  i -= G;
  if (i < (long long)S * G) {
    double s = 0.0;
    for (int b = lane; b < n_blocks; b += 32) s += part_sum[(long long)b * S * G + i];
    s = xor_tree(s, 0);
    if (lane == 0) sums[i] = s;
    return;
  }
  i -= (long long)S * G;
  if (i < (long long)R * G) {
    const bool is_min = mm_is_min((int)(i / G), M, X, K);
    float v = is_min ? INFINITY : -INFINITY;
    for (int b = lane; b < n_blocks; b += 32) {
      const float p = part_mm[(long long)b * R * G + i];
      v = is_min ? min_nan(v, p) : max_nan(v, p);
    }
    v = xor_tree_mm(v, is_min ? 0 : 1);
    if (lane == 0) mm[i] = v;
    return;
  }
  i -= (long long)R * G;
  if (i < (long long)I * G) {
    const int kind = idesc[kTailDesc * (int)(i / G) + 1];
    long long v = int_start(kind);
    for (int b = lane; b < n_blocks; b += 32)
      v = int_fold(v, part_int[(long long)b * I * G + i], kind);
    v = kind == KIND_SUM ? (long long)xor_tree((unsigned long long)v, 0)
                         : xor_tree(v, kind == KIND_MIN ? 1 : 2);
    if (lane == 0) ints[i] = v;
    return;
  }
  i -= (long long)I * G;
  if (i < (long long)IS * G) {
    double s = 0.0;
    for (int b = lane; b < n_blocks; b += 32) s += part_iest[(long long)b * IS * G + i];
    s = xor_tree(s, 0);
    if (lane == 0) iest[i] = s;
    return;
  }
  i -= (long long)IS * G;
  if (i < (long long)A * G) {
    const bool is_min = adesc[kTailDesc * (int)(i / G)] != 0;
    unsigned long long w = is_min ? kArgEmptyMin : 0ull;
    for (int b = lane; b < n_blocks; b += 32) {
      const unsigned long long p = part_arg[(long long)b * A * G + i];
      if (is_min ? p < w : p > w) w = p;
    }
    w = xor_tree(w, is_min ? 1 : 2);
    if (lane == 0) args[i] = w;
    return;
  }
  if (i == (long long)A * G) {
    unsigned f = 0;
    for (int b = lane; b < n_blocks; b += 32) f |= (unsigned)part_flags[b];
    f = __reduce_or_sync(kFull, f);
    if (lane == 0) flags[0] = (int)f;
  }
}

}  // namespace sql
}  // namespace infera

namespace infera {
namespace sql {

// cudaFuncSetAttribute once per device and instance for the largest dynamic
// shared memory asked so far, not on every launch
template <bool kWide>
inline cudaError_t allow_smem(int smem_bytes) {
  static int allowed[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && smem_bytes <= allowed[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(fused_sql_kernel<kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes);
  if (e == cudaSuccess && dev < 64) allowed[dev] = smem_bytes;
  return e;
}

// The words of infera_fused_sql_launch's argument block (ops/fused_sql.py
// _launch_words).
enum Arg {
  A_XC = 0, A_NPAD, A_N, A_PLAN, A_BLOB, A_BLOB_FLOATS, A_TREES, A_LOOKUP, A_DIM, A_XI,
  A_XI_STRIDE, A_DMAT, A_PART, A_NBLOCKS = A_PART + 7, A_SMEM, A_G, A_S, A_R, A_I, A_IS, A_A,
  A_OUT, A_WIDE = A_OUT + 7, A_WORDS
};
static_assert(A_WORDS == 35, "argument block of ops/fused_sql.py");

}  // namespace sql
}  // namespace infera

extern "C" {

// K2 (and K2', K4, K5 inside it) and the fold of its partials, launched on
// one stream from one argument block `a` of int64 words (enum Arg):
//   xc: [C, n_pad] f32, rows [0, n) used. plan: int32 words of
//   ops/fused_sql.py pack_plan, which also lays out the shared memory
//   (smem). blob: the MLP weights, f32 (blob_floats, a multiple of 4, 0
//   without an MLP). trees: the forest slots' tables, int32 words, 16-byte
//   aligned sections. lookup and dim: a join plan's key lookup (int32
//   [kmax + 1]) and dim block (f32 [D][n_dim]), 0 without a join. xi: the
//   int64 block the int slots read ([rows][xi_stride]), 0 without int slots.
//   dmat: the DISTINCT/MODE counts, int32, zeroed by the caller.
//   The 7 partials: [n_blocks][G] int64, [n_blocks][S][G] f64,
//   [n_blocks][R][G] f32, [n_blocks][I][G] int64, [n_blocks][IS][G] f64,
//   [n_blocks][A][G] uint64, [n_blocks] int32.
//   The 7 outputs of the fold: [G] int64 counts, [S][G] f64 sums, [R][G]
//   f32 min/max rows, [I][G] int64 int slots, [IS][G] f64 estimates, [A][G]
//   uint64 arg words and the [1] int32 flag word.
//   wide: 1 for the kernel's kWide instance (ops/fused_sql.py wide_instance).
// parts: 1 the kernel, 2 the fold, 3 both (a caller timing each alone).
// Returns a cudaError_t.
int infera_fused_sql_launch(const long long* a, int parts, void* stream) {
  using namespace infera::sql;
  const int smem = (int)a[A_SMEM], n_blocks = (int)a[A_NBLOCKS];
  const bool wide = a[A_WIDE] != 0;
  cudaError_t e = wide ? allow_smem<true>(smem) : allow_smem<false>(smem);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long* p = a + A_PART;
  auto kernel = wide ? fused_sql_kernel<true> : fused_sql_kernel<false>;
  if (parts & 1) kernel<<<n_blocks, infera::kThreads, smem, s>>>(
      (const float*)a[A_XC], a[A_NPAD], a[A_N], (const int*)a[A_PLAN], (const float*)a[A_BLOB],
      (int)(a[A_BLOB_FLOATS] / 4), (const int*)a[A_TREES], (const int*)a[A_LOOKUP],
      (const float*)a[A_DIM], (const long long*)a[A_XI], a[A_XI_STRIDE], (int*)a[A_DMAT],
      (long long*)p[0], (double*)p[1], (float*)p[2], (long long*)p[3], (double*)p[4],
      (unsigned long long*)p[5], (int*)p[6]);
  e = cudaGetLastError();
  if (e != cudaSuccess || !(parts & 2)) return (int)e;
  const int G = (int)a[A_G], S = (int)a[A_S], R = (int)a[A_R], I = (int)a[A_I];
  const int IS = (int)a[A_IS], A = (int)a[A_A];
  const long long* o = a + A_OUT;
  const long long total = (long long)G * (1 + S + R + I + IS + A) + 1;  // a warp each
  fused_sql_fold<<<(unsigned)((32 * total + 255) / 256), 256, 0, s>>>(
      (const int*)a[A_PLAN], (const long long*)p[0], (const double*)p[1], (const float*)p[2],
      (const long long*)p[3], (const double*)p[4], (const unsigned long long*)p[5],
      (const int*)p[6], n_blocks, G, S, R, I, IS, A, (long long*)o[0], (double*)o[1],
      (float*)o[2], (long long*)o[3], (double*)o[4], (unsigned long long*)o[5], (int*)o[6]);
  return (int)cudaGetLastError();
}

// Blocks of fused_sql_kernel's instance `wide` resident on one SM at `smem`
// bytes of dynamic shared memory (registers, shared memory and threads all
// counted), into *blocks. Returns a cudaError_t.
int infera_fused_sql_occupancy(int smem, int wide, int* blocks) {
  using namespace infera::sql;
  cudaError_t e = wide ? allow_smem<true>(smem) : allow_smem<false>(smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, wide ? fused_sql_kernel<true> : fused_sql_kernel<false>, infera::kThreads, smem);
}

const char* infera_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
