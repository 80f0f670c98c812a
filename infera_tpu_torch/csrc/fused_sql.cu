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
// [d_in][64-row] activation tile (rounded to bf16 in bf16 mode) and runs the
// layer stack of mlp_tile.cuh on it with the weights resident in shared memory
// (hidden outputs rounded to bf16 in bf16 mode), then an optional softmax
// over the classes, and keeps output column `oc` as the slot's prediction.
//
// Bound on the H100 (main path, 1,048,576 rows): with the 4-32-1 MLP of the
// SQL flagship the work is ~0.3 G operations and the 5 read columns are 21 MB,
// so it is bound by bytes (~0.006 ms at 3.35 TB/s); with the bench MLP
// (32-128-128-16 softmax) it is bound by f32 operations (47.2 G operations
// over all rows, ~0.70 ms at 67 TFLOP/s, half that where the WHERE keeps half
// the rows; at the bf16 tensor-core rate the 33 columns' bytes bound it). This first
// version runs the layers on the f32 CUDA cores (mlp_tile.cuh), interprets
// programs with a switch, and reduces groups with one thread per group, so it
// is far from either bound; wgmma for the MLP is the next design.
//
// K4: each `infera_predict` of a tree ensemble is a forest slot. The TPU
// kernel ran the forest as strip-packed one-hot and ancestry matmuls for the
// MXU; the function is "per tree, the leaf the row's decisions reach; add the
// leaf weights", so here one thread takes one row of the 256-row tile and
// walks every tree over node records {feature or -1, threshold bits, true
// child, false child} (ml_ops._PackedTrees.kernel_forest), adding the leaf
// weights in tree order with __fadd_rn, as forest_plain does, so the two agree
// bit for bit. The tables stay in device memory and are read through the
// read-only path (__ldg), where every block finds them in L2: no forest that
// the TPU kernel's 2 MiB strip limit takes is refused for want of shared
// memory. A classifier walks the forest once per 4 classes and keeps the
// first-index argmax (a NaN wins, as jnp.argmax) before its label map. A row
// that holds a non-finite feature sees NaN at every node that tests another
// feature: the TPU kernel's one-hot select (and the host's GEMM forest)
// multiplies every feature by 0 or 1, and inf * 0 is NaN.
//
// Bound of K4 on the H100 (config 4: 64 trees of depth 6 over 16 features,
// 1,048,576 rows): the 17 columns it reads are 71.3 MB (0.021 ms at 3.35
// TB/s), the 64 x 6 compares and 64 adds per row 0.47 G operations (0.007 ms
// at 67 TFLOP/s): bound by bytes. This first version interprets each visited
// node's feature program and chases one record per level, so it is bound by
// the latency of those dependent loads, far from either bound; staging the
// features and the tables in shared memory and walking trees across a warp
// are the next design.
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
// bound by bytes; this first version gathers the lookup and the dim rows at
// random, one 4-byte load a row each, so it is bound by the latency of those
// loads and of the interpreter, as K2 is.
//
// K2 b-e, the aggregate tail of infera_tpu/ops/pallas_sql.py (:264-363) and
// of the sum-slot families of infera_tpu/sql/device_plan.py (:951-1045). The
// TPU kernel had f32 alone, so it carried int64 columns as eight byte-limb
// rows summed in Neumaier pairs (b), compared int64 extremes as four 16-bit
// words in a lexicographic cascade (e), counted DISTINCT values with one-hot
// MXU matmuls per 128-value bank (c), and kept arg_min/arg_max as (value,
// row) lane pairs with NaN at 2^30 (d). The H100 has int64 and f64, so:
//  b. an int sum slot reads its row of the int64 block xi [I][n] into shared
//     memory per tile; the group's thread adds it as unsigned long long (wrap
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
// bound by bytes (about 0.002-0.01 ms at 3.35 TB/s); this first version
// spends its time in the interpreter, the one-thread-per-group reduction
// and, for c, the atomics on a few hot cells.
//
// Cross-block accumulation: blocks run in any order, so each (persistent)
// block keeps its own accumulators in shared memory, one thread per group
// adding the tile's rows in row order, and writes them to partials; a second
// kernel folds the partials in block order. No atomics on values: sums repeat
// bit for bit from run to run at one grid size.
#include "mlp_tile.cuh"

#include <limits.h>
#include <math.h>

namespace infera {
namespace sql {

constexpr int kRows = 256;      // rows of a tile, one per thread (== kThreads)
constexpr int kMaxStack = 16;   // MAX_STACK in ops/fused_sql.py
constexpr int kSlotDesc = 16;   // words of a prediction slot's descriptor; the last is its kind
constexpr int kOutChunk = 4;    // classes a forest walk adds up at once, in registers
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
  H_TAIL,
  H_SM_BLOB = 24, H_SM_ACT0, H_SM_ACT1, H_SM_PRED, H_SM_VALS, H_SM_KRAW, H_SM_KSLOT, H_SM_RIDX,
  H_SM_CNT, H_SM_SUMS, H_SM_MM, H_SM_FLAGS, H_SM_IVALS, H_SM_AVALS, H_SM_IACC, H_SM_IEST,
  H_SM_AACC, H_SM_TOTAL
};
static_assert(H_TAIL == 22 && H_SM_TOTAL == 41, "header layout of ops/fused_sql.py");

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
  F_TREES = 0, F_NODES, F_DEPTH, F_NOUT, F_DIN, F_NODE_OFF, F_W_OFF, F_STRICT, F_OUT_COL, F_BIAS,
  F_LOGISTIC, F_MODE, F_CBIAS_OFF, F_FEAT, F_LABEL_OFF
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

// MLP slot j (descriptor md) on rows [rbase, rbase + 64) of the tile: its
// predictions go to pred[j][sub * 64 + r]. A feature may read an earlier slot.
__device__ void mlp_slot(const int* plan, const int* md, int j, unsigned char* smem,
                         const Src& src, long long n, long long rbase, int sub) {
  float* s_blob = at<float>(smem, plan, H_SM_BLOB);
  float* act0 = at<float>(smem, plan, H_SM_ACT0);
  float* act1 = at<float>(smem, plan, H_SM_ACT1);
  float* pred = at<float>(smem, plan, H_SM_PRED);
  MlpDims d;
  d.n_layers = md[0];
  for (int i = 0; i <= kMaxLayers; ++i) d.dim[i] = i <= d.n_layers ? md[1 + i] : 0;
  const int d_in = d.dim[0];
  const bool bf16 = md[12] != 0;
  const int feat = md[13];
  for (int i = threadIdx.x; i < kTileRows * d_in; i += kThreads) {
    const int k = i / kTileRows;
    const int r = i - k * kTileRows;
    const long long row = rbase + r;
    float v = row < n ? run_program(plan, feat + k, src, row, pred, sub * kTileRows + r) : 0.f;
    if (bf16) v = round_bf16(v);
    act0[k * kActStride + r] = v;
  }
  __syncthreads();
  const float* w = s_blob + md[10];
  const float* h = bf16 ? mlp_stack_f32<true>(d, w, act0, act1)
                        : mlp_stack_f32<false>(d, w, act0, act1);
  if (threadIdx.x < kTileRows) {
    const int r = threadIdx.x;
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
    pred[j * kRows + sub * kTileRows + r] = v;
  }
  __syncthreads();
}

__device__ inline bool is_finite(float v) { return fabsf(v) < INFINITY; }  // false for NaN

// K4's walk for one row: adds to acc[0, nc) the weights of classes
// [c0, c0 + nc) of the leaf each tree of forest fd reaches, tree by tree.
// nonfin counts the row's non-finite features.
__device__ __forceinline__ void forest_sums(const int* plan, const int* fd,
                                            const int* __restrict__ trees, const Src& src,
                                            long long row, const float* pred, int r, int nonfin,
                                            int c0, int nc, float (&acc)[kOutChunk]) {
  const int T = fd[F_TREES], M = fd[F_NODES], depth = fd[F_DEPTH], n_out = fd[F_NOUT];
  const int feat = fd[F_FEAT];
  const bool strict = fd[F_STRICT] != 0;
  const int4* nodes = reinterpret_cast<const int4*>(trees + fd[F_NODE_OFF]);
  const float* w = reinterpret_cast<const float*>(trees + fd[F_W_OFF]);
  for (int t = 0; t < T; ++t) {
    const int4* tree = nodes + (long long)t * M;
    int k = 0;
    for (int level = 0; level < depth; ++level) {
      const int4 nd = __ldg(tree + k);
      if (nd.x < 0) break;  // a leaf
      float v = run_program(plan, feat + nd.x, src, row, pred, r);
      // another feature of the row is non-finite: the one-hot product is NaN
      if (nonfin > (is_finite(v) ? 0 : 1)) v = __int_as_float(0x7fc00000);
      const float th = __int_as_float(nd.y);
      k = (strict ? v < th : v <= th) ? nd.z : nd.w;
    }
    const float* wl = w + ((long long)t * M + k) * n_out + c0;
#pragma unroll
    for (int i = 0; i < kOutChunk; ++i)
      if (i < nc) acc[i] = __fadd_rn(acc[i], __ldg(wl + i));
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
// prediction goes to pred[j][r].
__device__ void forest_slot(const int* plan, const int* fd, int j, float* pred,
                            const int* __restrict__ trees, const Src& src, long long n,
                            long long row0) {
  const int r = threadIdx.x;
  const long long row = row0 + r;
  float out = 0.f;
  if (row < n) {
    const int d_in = fd[F_DIN], feat = fd[F_FEAT], mode = fd[F_MODE];
    int nonfin = 0;
    for (int f = 0; f < d_in; ++f)
      nonfin += is_finite(run_program(plan, feat + f, src, row, pred, r)) ? 0 : 1;
    if (mode == 0) {
      // regressor: the kept column plus its base, then an optional logistic
      float acc[kOutChunk] = {0.f, 0.f, 0.f, 0.f};
      forest_sums(plan, fd, trees, src, row, pred, r, nonfin, fd[F_OUT_COL], 1, acc);
      out = __fadd_rn(acc[0], __int_as_float(fd[F_BIAS]));
      if (fd[F_LOGISTIC]) out = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-out)));
    } else {
      // classifier: per-class base, (binary expansion), argmax, label map
      const int n_out = fd[F_NOUT];
      const float* cbias =
          fd[F_CBIAS_OFF] >= 0 ? reinterpret_cast<const float*>(trees + fd[F_CBIAS_OFF]) : nullptr;
      float best = 0.f;
      int idx = 0;
      for (int c0 = 0; c0 < n_out; c0 += kOutChunk) {
        const int nc = min(kOutChunk, n_out - c0);
        float acc[kOutChunk] = {0.f, 0.f, 0.f, 0.f};
        forest_sums(plan, fd, trees, src, row, pred, r, nonfin, c0, nc, acc);
#pragma unroll
        for (int i = 0; i < kOutChunk; ++i) {
          if (i >= nc) continue;
          float s = acc[i];
          if (cbias != nullptr) s = __fadd_rn(s, __ldg(cbias + c0 + i));
          if (mode == 2) {
            argmax_step(-s, 0, best, idx);
            argmax_step(s, 1, best, idx);
          } else {
            argmax_step(s, c0 + i, best, idx);
          }
        }
      }
      out = fd[F_LABEL_OFF] >= 0
                ? __ldg(reinterpret_cast<const float*>(trees + fd[F_LABEL_OFF]) + idx)
                : (float)idx;
    }
  }
  pred[j * kRows + r] = out;
}

__global__ void __launch_bounds__(kThreads)
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
  const int R = M + X + 2 * K;
  const int SMX = S + M + X;
  const int I = plan[H_I], IS = plan[H_IS], D = plan[H_D], A = plan[H_A];
  const int* idesc = plan + plan[H_TAIL];           // int slots
  const int* ddesc = idesc + kTailDesc * I;         // DISTINCT/MODE slots
  const int* adesc = ddesc + kTailDesc * D;         // arg slots
  const int* strides = plan + plan[H_STRIDES];
  if (blob_words16 > 0) copy_words16(at<float>(smem, plan, H_SM_BLOB), blob, blob_words16);
  float* pred = at<float>(smem, plan, H_SM_PRED);
  float* vals = at<float>(smem, plan, H_SM_VALS);    // [S + M + X][kRows]
  float* kraw = at<float>(smem, plan, H_SM_KRAW);    // [K][kRows]
  int* kslot = at<int>(smem, plan, H_SM_KSLOT);      // [kRows]: group, -1 if not selected
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
    // prediction slots, in order: a feature may read an earlier slot
    for (int j = 0; j < J; ++j) {
      const int* md = plan + plan[H_PREDS] + j * kSlotDesc;
      if (md[kSlotDesc - 1] == SLOT_FOREST) {
        forest_slot(plan, md, j, pred, trees, src, n, row0);
        __syncthreads();
        continue;
      }
      for (int sub = 0; sub < kRows / kTileRows; ++sub) {
        const long long rbase = row0 + sub * kTileRows;
        if (rbase >= n) break;  // uniform across the block
        mlp_slot(plan, md, j, smem, src, n, rbase, sub);
      }
    }
    // slot phase: one row per thread
    const int t = threadIdx.x;
    const long long row = row0 + t;
    int slot = -1;
    int fl = 0;
    if (row < n && (!has_where || run_program(plan, 0, src, row, pred, t) != 0.f)) {
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
    kslot[t] = slot;
    if (fl) atomicOr(flags, fl);
    __syncthreads();
    // reduction: one thread per group, rows in order
    for (int g = threadIdx.x; g < G; g += kThreads) {
      for (int r = 0; r < kRows; ++r) {
        if (kslot[r] != g) continue;
        cnt[g] += 1;
        for (int s = 0; s < S; ++s) sums[s * G + g] += (double)vals[s * kRows + r];
        for (int c = 0; c < M; ++c) mm[c * G + g] = min_nan(mm[c * G + g], vals[(S + c) * kRows + r]);
        for (int c = 0; c < X; ++c)
          mm[(M + c) * G + g] = max_nan(mm[(M + c) * G + g], vals[(S + M + c) * kRows + r]);
        for (int k = 0; k < K; ++k) {
          const float v = kraw[k * kRows + r];
          mm[(M + X + k) * G + g] = fminf(mm[(M + X + k) * G + g], v);
          mm[(M + X + K + k) * G + g] = fmaxf(mm[(M + X + K + k) * G + g], v);
        }
      }
      // the int and arg slots in a pass of their own, which a plan without
      // them skips: the loop above runs on one thread for one group
      if (I + A == 0) continue;
      for (int r = 0; r < kRows; ++r) {
        if (kslot[r] != g) continue;
        for (int i = 0; i < I; ++i) {
          const int* id = idesc + kTailDesc * i;
          const long long v = ivals[i * kRows + r];
          iacc[i * G + g] = int_fold(iacc[i * G + g], v, id[1]);
          if (id[1] == KIND_SUM) iest[id[2] * G + g] += fabs((double)v);
        }
        for (int a = 0; a < A; ++a) {
          const unsigned long long w = avals[a * kRows + r];
          unsigned long long& acc = aacc[a * G + g];
          if (adesc[kTailDesc * a] ? w < acc : w > acc) acc = w;
        }
      }
    }
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

// One thread per output element adds the blocks' partials in block order.
// The sections of the output, in order: G counts, S x G sums, R x G min/max
// rows, I x G int slots, IS x G estimates, A x G arg words, the flag word.
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
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < G) {
    long long c = 0;
    for (int b = 0; b < n_blocks; ++b) c += part_cnt[(long long)b * G + i];
    cnt[i] = c;
    return;
  }
  i -= G;
  if (i < (long long)S * G) {
    double s = 0.0;
    for (int b = 0; b < n_blocks; ++b) s += part_sum[(long long)b * S * G + i];
    sums[i] = s;
    return;
  }
  i -= (long long)S * G;
  if (i < (long long)R * G) {
    const bool is_min = mm_is_min((int)(i / G), M, X, K);
    float v = is_min ? INFINITY : -INFINITY;
    for (int b = 0; b < n_blocks; ++b) {
      const float p = part_mm[(long long)b * R * G + i];
      v = is_min ? min_nan(v, p) : max_nan(v, p);
    }
    mm[i] = v;
    return;
  }
  i -= (long long)R * G;
  if (i < (long long)I * G) {
    const int kind = idesc[kTailDesc * (int)(i / G) + 1];
    long long v = int_start(kind);
    for (int b = 0; b < n_blocks; ++b) v = int_fold(v, part_int[(long long)b * I * G + i], kind);
    ints[i] = v;
    return;
  }
  i -= (long long)I * G;
  if (i < (long long)IS * G) {
    double s = 0.0;
    for (int b = 0; b < n_blocks; ++b) s += part_iest[(long long)b * IS * G + i];
    iest[i] = s;
    return;
  }
  i -= (long long)IS * G;
  if (i < (long long)A * G) {
    const bool is_min = adesc[kTailDesc * (int)(i / G)] != 0;
    unsigned long long w = is_min ? kArgEmptyMin : 0ull;
    for (int b = 0; b < n_blocks; ++b) {
      const unsigned long long p = part_arg[(long long)b * A * G + i];
      if (is_min ? p < w : p > w) w = p;
    }
    args[i] = w;
    return;
  }
  if (i == (long long)A * G) {
    int f = 0;
    for (int b = 0; b < n_blocks; ++b) f |= part_flags[b];
    flags[0] = f;
  }
}

}  // namespace sql
}  // namespace infera

extern "C" {

// xc: [C, n_pad] f32, rows [0, n) used. plan: int32 words of
// ops/fused_sql.py pack_plan, which also lays out the shared memory
// (smem_bytes). blob: the MLP weights, f32 (blob_floats, a multiple of 4, 0
// without an MLP). trees: the forest slots' tables, int32 words, 16-byte
// aligned sections. lookup and dim: a join plan's key lookup (int32
// [kmax + 1]) and dim block (f32 [D][n_dim]), null without a join. xi: the
// int64 block the int slots read ([rows][xi_stride]), null without int
// slots. dmat: the DISTINCT/MODE counts, int32, zeroed by the caller.
// Partials: [n_blocks][G] int64, [n_blocks][S][G] f64, [n_blocks][R][G] f32,
// [n_blocks][I][G] int64, [n_blocks][IS][G] f64, [n_blocks][A][G] uint64,
// [n_blocks] int32. Returns a cudaError_t.
int infera_fused_sql(const void* xc, long long n_pad, long long n, const void* plan,
                     const void* blob, long long blob_floats, const void* trees,
                     const void* lookup, const void* dim, const void* xi, long long xi_stride,
                     void* dmat, void* part_cnt, void* part_sum, void* part_mm, void* part_int,
                     void* part_iest, void* part_arg, void* part_flags, int n_blocks,
                     int smem_bytes, void* stream) {
  using namespace infera::sql;
  cudaError_t e = cudaFuncSetAttribute(fused_sql_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  fused_sql_kernel<<<n_blocks, infera::kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)xc, n_pad, n, (const int*)plan, (const float*)blob, (int)(blob_floats / 4),
      (const int*)trees, (const int*)lookup, (const float*)dim, (const long long*)xi, xi_stride,
      (int*)dmat, (long long*)part_cnt, (double*)part_sum, (float*)part_mm,
      (long long*)part_int, (double*)part_iest, (unsigned long long*)part_arg,
      (int*)part_flags);
  return (int)cudaGetLastError();
}

// The fold of the partials into [G] int64 counts, [S][G] f64 sums, [R][G]
// f32 min/max rows, [I][G] int64 int slots, [IS][G] f64 estimates, [A][G]
// uint64 arg words and the [1] int32 flag word; launched after
// infera_fused_sql on the same stream, with the same plan words.
int infera_fused_sql_fold(const void* plan, const void* part_cnt, const void* part_sum,
                          const void* part_mm, const void* part_int, const void* part_iest,
                          const void* part_arg, const void* part_flags, int n_blocks, int G,
                          int S, int R, int I, int IS, int A, void* cnt, void* sums, void* mm,
                          void* ints, void* iest, void* args, void* flags, void* stream) {
  using namespace infera::sql;
  const long long total = (long long)G * (1 + S + R + I + IS + A) + 1;
  fused_sql_fold<<<(unsigned)((total + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const int*)plan, (const long long*)part_cnt, (const double*)part_sum,
      (const float*)part_mm, (const long long*)part_int, (const double*)part_iest,
      (const unsigned long long*)part_arg, (const int*)part_flags, n_blocks, G, S, R, I, IS, A,
      (long long*)cnt, (double*)sums, (float*)mm, (long long*)ints, (double*)iest,
      (unsigned long long*)args, (int*)flags);
  return (int)cudaGetLastError();
}

const char* infera_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
