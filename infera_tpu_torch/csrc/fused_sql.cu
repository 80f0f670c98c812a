// K2 and K2': the fused SQL plan over a stacked feature-major table block.
//
// Replaces infera_tpu/ops/pallas_sql.py:71 `build_fused_plan_call` (its core
// slots: count, sum/avg, min/max and the key guard) and the in-kernel MLP of
// infera_tpu/sql/device_plan.py:633 `_lower_mlp` (K2'), which runs inside it.
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
// Cross-block accumulation: blocks run in any order, so each (persistent)
// block keeps its own accumulators in shared memory, one thread per group
// adding the tile's rows in row order, and writes them to partials; a second
// kernel folds the partials in block order. No atomics on values: sums repeat
// bit for bit from run to run at one grid size.
#include "mlp_tile.cuh"

#include <math.h>

namespace infera {
namespace sql {

constexpr int kRows = 256;      // rows of a tile, one per thread (== kThreads)
constexpr int kMaxStack = 16;   // MAX_STACK in ops/fused_sql.py
constexpr int kMlpDesc = 16;
static_assert(kRows == kThreads, "one row per thread in the slot phase");
static_assert(kRows % kTileRows == 0, "MLP sub-tiles");

// opcodes: ops/fused_sql.py
enum Op {
  COL = 0, CONST, PRED, NEG, NOT, ADD, SUB, MUL, DIV, MOD, EQ, NE, LT, LE, GT, GE, AND, OR,
  BETWEEN, CAST_INT, CAST_FLOAT, ABS, SQRT, FLOOR, CEIL, ROUND, EXP, LOG
};

// header words of the plan: ops/fused_sql.py pack_plan
enum Hdr {
  H_WORDS = 0, H_K, H_S, H_M, H_X, H_WHERE, H_J, H_G, H_NPROG, H_PROGS, H_CODE, H_CONSTS,
  H_STRIDES, H_MLPS,
  H_SM_BLOB = 16, H_SM_ACT0, H_SM_ACT1, H_SM_PRED, H_SM_VALS, H_SM_KRAW, H_SM_KSLOT, H_SM_CNT,
  H_SM_SUMS, H_SM_MM, H_SM_FLAGS, H_SM_TOTAL
};

__device__ inline float b2f(bool b) { return b ? 1.f : 0.f; }

// Program `prog` of the plan on one row; pred points at the tile's
// predictions [J][kRows] and r is the row's index in the tile.
__device__ float run_program(const int* __restrict__ plan, int prog,
                             const float* __restrict__ x, long long n_pad, long long row,
                             const float* __restrict__ pred, int r) {
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
      case COL: st[sp++] = __ldg(x + (long long)arg * n_pad + row); break;
      case CONST: st[sp++] = consts[arg]; break;
      case PRED: st[sp++] = pred[arg * kRows + r]; break;
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

// The MLP slots on rows [rbase, rbase + 64) of the tile: predictions of
// slot j go to pred[j][sub * 64 + r]. A feature may read an earlier slot.
__device__ void mlp_slots(const int* plan, unsigned char* smem, const float* __restrict__ x,
                          long long n_pad, long long n, long long rbase, int sub) {
  const int J = plan[H_J];
  float* s_blob = at<float>(smem, plan, H_SM_BLOB);
  float* act0 = at<float>(smem, plan, H_SM_ACT0);
  float* act1 = at<float>(smem, plan, H_SM_ACT1);
  float* pred = at<float>(smem, plan, H_SM_PRED);
  for (int j = 0; j < J; ++j) {
    const int* md = plan + plan[H_MLPS] + j * kMlpDesc;
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
      float v = row < n ? run_program(plan, feat + k, x, n_pad, row, pred, sub * kTileRows + r)
                        : 0.f;
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
}

__global__ void __launch_bounds__(kThreads)
fused_sql_kernel(const float* __restrict__ x, long long n_pad, long long n,
                 const int* __restrict__ gplan, const float* __restrict__ blob, int blob_words16,
                 long long* __restrict__ part_cnt, double* __restrict__ part_sum,
                 float* __restrict__ part_mm, int* __restrict__ part_flags) {
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
  const int* strides = plan + plan[H_STRIDES];
  if (J > 0) copy_words16(at<float>(smem, plan, H_SM_BLOB), blob, blob_words16);
  const float* pred = at<float>(smem, plan, H_SM_PRED);
  float* vals = at<float>(smem, plan, H_SM_VALS);    // [S + M + X][kRows]
  float* kraw = at<float>(smem, plan, H_SM_KRAW);    // [K][kRows]
  int* kslot = at<int>(smem, plan, H_SM_KSLOT);      // [kRows]: group, -1 if not selected
  long long* cnt = at<long long>(smem, plan, H_SM_CNT);
  double* sums = at<double>(smem, plan, H_SM_SUMS);  // [S][G]
  float* mm = at<float>(smem, plan, H_SM_MM);        // [R][G]
  int* flags = at<int>(smem, plan, H_SM_FLAGS);
  for (int g = threadIdx.x; g < G; g += kThreads) {
    cnt[g] = 0;
    for (int s = 0; s < S; ++s) sums[s * G + g] = 0.0;
    for (int c = 0; c < R; ++c) mm[c * G + g] = mm_is_min(c, M, X, K) ? INFINITY : -INFINITY;
  }
  if (threadIdx.x == 0) *flags = 0;
  __syncthreads();

  const int p_key = has_where;
  const int p_val = p_key + K;
  const long long n_tiles = (n + kRows - 1) / kRows;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * kRows;
    if (J > 0) {
      for (int sub = 0; sub < kRows / kTileRows; ++sub) {
        const long long rbase = row0 + sub * kTileRows;
        if (rbase >= n) break;  // uniform across the block
        mlp_slots(plan, smem, x, n_pad, n, rbase, sub);
      }
    }
    // slot phase: one row per thread
    const int t = threadIdx.x;
    const long long row = row0 + t;
    int slot = -1;
    int fl = 0;
    if (row < n && (!has_where || run_program(plan, 0, x, n_pad, row, pred, t) != 0.f)) {
      unsigned comb = 0;
      for (int k = 0; k < K; ++k) {
        const float r = run_program(plan, p_key + k, x, n_pad, row, pred, t);
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
        vals[s * kRows + t] = run_program(plan, p_val + s, x, n_pad, row, pred, t);
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
    }
    __syncthreads();
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    part_cnt[(long long)blockIdx.x * G + g] = cnt[g];
    for (int s = 0; s < S; ++s) part_sum[((long long)blockIdx.x * S + s) * G + g] = sums[s * G + g];
    for (int c = 0; c < R; ++c) part_mm[((long long)blockIdx.x * R + c) * G + g] = mm[c * G + g];
  }
  if (threadIdx.x == 0) part_flags[blockIdx.x] = *flags;
}

// One thread per output element adds the blocks' partials in block order.
__global__ void fused_sql_fold(const long long* __restrict__ part_cnt,
                               const double* __restrict__ part_sum,
                               const float* __restrict__ part_mm,
                               const int* __restrict__ part_flags, int n_blocks, int G, int S,
                               int M, int X, int K, long long* __restrict__ cnt,
                               double* __restrict__ sums, float* __restrict__ mm,
                               int* __restrict__ flags) {
  const int R = M + X + 2 * K;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < G) {
    long long c = 0;
    for (int b = 0; b < n_blocks; ++b) c += part_cnt[(long long)b * G + i];
    cnt[i] = c;
  } else if (i < G + S * G) {
    const int j = i - G;
    double s = 0.0;
    for (int b = 0; b < n_blocks; ++b) s += part_sum[(long long)b * S * G + j];
    sums[j] = s;
  } else if (i < G + S * G + R * G) {
    const int j = i - G - S * G;
    const bool is_min = mm_is_min(j / G, M, X, K);
    float v = is_min ? INFINITY : -INFINITY;
    for (int b = 0; b < n_blocks; ++b) {
      const float p = part_mm[(long long)b * R * G + j];
      v = is_min ? min_nan(v, p) : max_nan(v, p);
    }
    mm[j] = v;
  } else if (i == G + S * G + R * G) {
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
// (smem_bytes). blob: the MLP weights, f32. Partials: [n_blocks][G] int64,
// [n_blocks][S][G] f64, [n_blocks][R][G] f32, [n_blocks] int32. Returns a
// cudaError_t.
int infera_fused_sql(const void* xc, long long n_pad, long long n, const void* plan,
                     const void* blob, long long blob_floats, void* part_cnt, void* part_sum,
                     void* part_mm, void* part_flags, int n_blocks, int smem_bytes,
                     void* stream) {
  using namespace infera::sql;
  cudaError_t e = cudaFuncSetAttribute(fused_sql_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  fused_sql_kernel<<<n_blocks, infera::kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)xc, n_pad, n, (const int*)plan, (const float*)blob, (int)(blob_floats / 4),
      (long long*)part_cnt, (double*)part_sum, (float*)part_mm, (int*)part_flags);
  return (int)cudaGetLastError();
}

// The fold of the partials into [G] int64 counts, [S][G] f64 sums, [R][G]
// f32 min/max rows and the [1] int32 flag word; launched after
// infera_fused_sql on the same stream.
int infera_fused_sql_fold(const void* part_cnt, const void* part_sum, const void* part_mm,
                          const void* part_flags, int n_blocks, int G, int S, int M, int X, int K,
                          void* cnt, void* sums, void* mm, void* flags, void* stream) {
  using namespace infera::sql;
  const int total = G + S * G + (M + X + 2 * K) * G + 1;
  fused_sql_fold<<<(total + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const long long*)part_cnt, (const double*)part_sum, (const float*)part_mm,
      (const int*)part_flags, n_blocks, G, S, M, X, K, (long long*)cnt, (double*)sums,
      (float*)mm, (int*)flags);
  return (int)cudaGetLastError();
}

const char* infera_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
