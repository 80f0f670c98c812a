// K8a and K8b: the profiling kernels of the row-major fused query (K7a).
//
// K8a replaces infera_tpu/testing/profile_query.py `exp_empty`'s kernel: the
// f32 column sums [d0] of a bf16 table x [N, d0], K7a's grid and tile load
// with no compute behind it, so its time is the floor of K7a's load loop.
// K8b replaces `exp_variants`' `make(variant)`: the bf16 query in stages, one
// kernel with the stage as an argument, writing out [128] f32 as the TPU
// kernel fills its acc_ref [1, 128]:
//   scan:       the column sums of x in [0:d0] (K8a's function);
//   mm1:        the sums of layer 1's f32 output (bias, no ReLU) in [0:dout1];
//   mm_all:     the sums of the f32 logits in [0:C], hidden layers relu -> bf16;
//   tail_nomax: over rows with h[:, 0] > 0, per class the count of rows whose
//               score equals the row's maximum (tied classes all count) in
//               [0:C] and the sum of h[:, 0] over them in [C:2C];
//   full:       the same with the first-index argmax: K7a bf16's function and
//               arithmetic (the same load, layers, tail and fold order), so
//               its counts equal K7a's and its sums are K7a's bits.
//
// Bound on the H100 at the profiling shapes (N = 1,048,576, the 32 -> 128 ->
// 128 -> 16 MLP): K8a, scan and mm1 by the table's bytes, 67 MB at 3.35 TB/s =
// 0.020 ms; mm_all, tail_nomax and full by the bf16 tensor-core rate, 2 * N *
// 22,528 operations at 989 TFLOP/s = 0.048 ms (K7a bf16's bound). None uses the
// tensor cores: they run K7a's f32-core arithmetic, which is what they measure.
//
// Design: one kernel runs every stage (K8a is its scan stage): K7a's
// persistent grid (the wrapper gives it K7a's block count for the MLP) over
// 64-row tiles, each loaded with K7a's ring (load_rows_tile, query_tile.cuh)
// and run through K7a's mlp_stack_f32. The stage is a run-time argument, not a
// template parameter: ptxas gave a template's stages 61 to 101 registers and
// spilled one, so they ran differently compiled layer loops and mm_all read
// slower than full; compiled once, the layer loop is the same code in every
// stage. The TPU grid is rows // tile_n and drops a
// ragged tail; these kernels sum every row, which is the same function at every
// size the TPU experiments run (rows % tile_n == 0). A column of a tile is
// summed by one warp in a fixed shuffle tree (f32), four columns' trees
// interleaved, added to the block's f64 sums; each block writes its partials
// [kOut] and a fold kernel adds them in block order. No float atomics, so the
// results repeat bit for bit.
//
// What bounds K8a now: with the ring the table's bytes arrive ahead of the
// tile that needs them, so it is no longer the latency of the load. One block
// an SM (K7a's grid) runs each tile's steps one after another, and the time
// a tile is that chain: the wait for its own words, their transposition, a
// barrier, the column sums, a barrier (PERF.md has the measured split).
#include "query_tile.cuh"

namespace infera {

enum : int { kScan = 0, kMm1 = 1, kMmAll = 2, kTailNoMax = 3, kFull = 4 };
constexpr int kOut = 128;  // K8b's output width, the TPU kernel's acc_ref [1, 128]

// Block scratch after the weights: acc [kOut] f64 (the block's running sums)
// and mx [kTileRows] f32 (a row's maximum score, tail_nomax).
constexpr int kProfileScratch = kOut * 8 + kTileRows * 4;
static_assert(kTileRows == 64, "add_column_sums reads a tile column as two warp-wide halves");

// acc[c] += the sum of h[c][r] over the tile's rows r < rows, for c < width:
// a warp per column, its lanes over rows (neighbouring words of the
// [feature][row] tile), a fixed xor-shuffle tree in f32. A warp takes its
// columns four at a time, their trees interleaved, so that four shuffle
// chains are in flight where one would wait on the next.
__device__ inline void add_column_sums(const float* __restrict__ h, int width, int rows,
                                       double* __restrict__ acc) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kAtOnce = 4;
  const int lane = threadIdx.x & 31;
  for (int c0 = threadIdx.x >> 5; c0 < width; c0 += kAtOnce * kWarps) {
    float v[kAtOnce];
#pragma unroll
    for (int u = 0; u < kAtOnce; ++u) {
      const int c = c0 + u * kWarps;
      const float* col = h + c * kActStride;
      v[u] = c < width ? (lane < rows ? col[lane] : 0.f) + (lane + 32 < rows ? col[lane + 32] : 0.f)
                       : 0.f;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kAtOnce; ++u) v[u] += __shfl_xor_sync(0xffffffffu, v[u], o);
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kAtOnce; ++u)
        if (c0 + u * kWarps < width) acc[c0 + u * kWarps] += (double)v[u];
    }
  }
}

// The TPU's tail_nomax over one tile of scores h [C][kActStride]: a kept row
// (in range, score0 > 0) counts for every class whose score equals the row's
// maximum. Ends with a barrier.
__device__ inline void tail_nomax_tile(TailScratch t, float* __restrict__ mx,
                                       const float* __restrict__ h, int C, long long row0,
                                       long long n) {
  if (threadIdx.x < kTileRows) {
    const int r = threadIdx.x;
    const float v0 = h[r];
    float m = v0;
    for (int c = 1; c < C; ++c) m = fmaxf(m, h[c * kActStride + r]);
    t.pred[r] = row0 + r < n && v0 > 0.f ? 0 : -1;
    t.val[r] = v0;
    mx[r] = m;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    long long cnt = 0;
    double sum = 0.0;
    for (int r = 0; r < kTileRows; ++r) {
      if (t.pred[r] >= 0 && h[c * kActStride + r] == mx[r]) {
        ++cnt;
        sum += (double)t.val[r];
      }
    }
    t.blk_cnt[c] += cnt;
    t.blk_sum[c] += sum;
  }
  __syncthreads();
}

// variant: kScan, kMm1 or kMmAll (column sums of the layers' output: d has
// n_layers 0, 1 or all of them, with dim[0] = d0), kTailNoMax or kFull (the
// whole MLP). part: [gridDim.x][kOut] f64.
__global__ void __launch_bounds__(kThreads)
stage_kernel(int variant, const __nv_bfloat16* __restrict__ x, long long n,
             const float* __restrict__ blob, int blob_words16, MlpDims d, int widest,
             int stages, double* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d0 = d.dim[0];
  const int C = d.dim[d.n_layers];
  const bool tail = variant == kTailNoMax || variant == kFull;
  float* s_blob = reinterpret_cast<float*>(smem_raw);
  unsigned char* p = smem_raw + 16 * blob_words16;
  double* acc = reinterpret_cast<double*>(p);
  float* mx = reinterpret_cast<float*>(acc + kOut);
  TailScratch t = carve_tail(p + kProfileScratch, C);
  float* act0 = reinterpret_cast<float*>(p + kProfileScratch + tail_bytes(C));
  float* act1 = act0 + widest * kActStride;
  const long long n_tiles = (n + kTileRows - 1) / kTileRows;
  const RowRing<__nv_bfloat16> ring{
      x, n, d0, stages, reinterpret_cast<unsigned char*>(act1 + widest * kActStride), n_tiles};
  copy_words16(s_blob, blob, blob_words16);
  for (int c = threadIdx.x; c < kOut; c += kThreads) acc[c] = 0.0;
  tail_init(t, C);
  ring_start(ring);
  __syncthreads();

  int j = 0;  // this block's tile count
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++j) {
    const long long row0 = tile * kTileRows;
    load_rows_tile<__nv_bfloat16, true>(ring, j, row0, act0);
    __syncthreads();
    // n_layers 0 (scan) returns act0, the loaded tile
    const float* h = mlp_stack_f32<true>(d, s_blob, act0, act1);
    if (variant == kFull) {
      tail_tile(t, h, C, row0, n);
    } else if (variant == kTailNoMax) {
      tail_nomax_tile(t, mx, h, C, row0, n);
    } else {
      add_column_sums(h, C, (int)min((long long)kTileRows, n - row0), acc);
    }
    __syncthreads();
  }
  if (tail) {
    for (int c = threadIdx.x; c < C; c += kThreads) {
      acc[c] = (double)t.blk_cnt[c];
      acc[C + c] = t.blk_sum[c];
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < kOut; c += kThreads)
    part[(long long)blockIdx.x * kOut + c] = acc[c];
}

// out[c] = the blocks' partials of column c (c < width) added in block order.
__global__ void fold_stage_kernel(const double* __restrict__ part, int n_blocks, int width,
                                  float* __restrict__ out) {
  for (int c = threadIdx.x; c < width; c += blockDim.x) {
    double s = 0.0;
    for (int b = 0; b < n_blocks; ++b) s += part[(long long)b * kOut + c];
    out[c] = (float)s;
  }
}

inline cudaError_t launch_stage(int variant, const void* x, long long n, const void* blob,
                               long long blob_floats, const MlpDims& d, int widest, int stages,
                               void* part, int n_blocks, int smem_bytes, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e != cudaSuccess) return e;
  stage_kernel<<<n_blocks, kThreads, smem_bytes, s>>>(variant, (const __nv_bfloat16*)x, n,
                                                      (const float*)blob, (int)(blob_floats / 4),
                                                      d, widest, stages, (double*)part);
  return cudaGetLastError();
}

inline int fold_stage(const void* part, int n_blocks, int width, void* out, cudaStream_t s) {
  fold_stage_kernel<<<1, kThreads, 0, s>>>((const double*)part, n_blocks, width, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace infera

extern "C" {

// K8b, and K8a as its scan stage. variant: 0 scan, 1 mm1, 2 mm_all, 3
// tail_nomax, 4 full. x: [n, dims[0]] bf16, dims[0] <= 128; blob, dims,
// n_layers: the stage's layers in the f32 blob layout of mlp_tile.cuh
// (n_layers 0 for scan). stages: K7a's ring of row-major tiles
// (query_tile.cuh). part: [n_blocks, 128] f64 scratch; out: [128] f32.
// Returns a cudaError_t.
int infera_profile_stage(int variant, const void* x, long long n, const void* blob,
                         long long blob_floats, const int* dims, int n_layers, int widest,
                         int stages, void* part, void* out, int n_blocks, int smem_bytes,
                         void* stream) {
  const infera::MlpDims d = infera::make_dims(dims, n_layers);
  cudaStream_t s = (cudaStream_t)stream;
  if (variant < infera::kScan || variant > infera::kFull) return (int)cudaErrorInvalidValue;
  cudaError_t e = infera::launch_stage(variant, x, n, blob, blob_floats, d, widest, stages, part,
                                       n_blocks, smem_bytes, s);
  if (e != cudaSuccess) return (int)e;
  return infera::fold_stage(part, n_blocks, infera::kOut, out, s);
}

const char* infera_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
