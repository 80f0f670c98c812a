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
// 22,528 operations at 989 TFLOP/s = 0.048 ms (K7a bf16's bound). They run K7a
// bf16's code, which is what they measure: its layers on the tensor cores
// (mma.sync, mma_tile.cuh).
//
// Design: one kernel runs every stage (K8a is its scan stage): K7a's
// persistent grid (the wrapper gives it K7a bf16's block count for the MLP)
// over 64-row tiles, each loaded into the bf16 A tile with K7a's ring
// (load_rows_tile_bf16, query_tile.cuh) and run through K7a's
// mlp_stack_bf16. The stage is a run-time argument, not a template
// parameter: ptxas gave a template's stages 61 to 101 registers and spilled
// one, so they ran differently compiled layer loops and mm_all read slower
// than full; compiled once, the layer loop is the same code in every stage,
// and __launch_bounds__(256, 2) holds it to K7a's 128 registers. The TPU grid
// is rows // tile_n and drops a ragged tail; these kernels sum every row,
// which is the same function at every size the TPU experiments run (rows %
// tile_n == 0). A column of a tile is summed by one warp in a fixed shuffle
// tree (f32), added to the block's f64 sums (scan reads the bf16 A tile, a
// warp two neighbouring columns as one word); each block writes its partials
// [kOut] and a fold kernel adds them in block order. No float atomics, so
// the results repeat bit for bit.
//
// What bounds K8a now: with the ring the table's bytes arrive ahead of the
// tile that needs them, so it is not the latency of the load; the time a
// tile is its serial chain in a block (the wait for its own words, their
// copy into the A tile, a barrier, the column sums, a barrier), and K7a
// bf16's grid now holds two blocks an SM, so one block's chain runs beside
// the other's.
#include "query_tile.cuh"

namespace infera {

enum : int { kScan = 0, kMm1 = 1, kMmAll = 2, kTailNoMax = 3, kFull = 4 };
constexpr int kOut = 128;  // K8b's output width, the TPU kernel's acc_ref [1, 128]

// Block scratch after the weights: acc [kOut] f64 (the block's running sums)
// and mx [kTileRows] f32 (a row's maximum score, tail_nomax).
constexpr int kProfileScratch = kOut * 8 + kTileRows * 4;
static_assert(kTileRows == 64, "the column sums read a tile column as two warp-wide halves");

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

// acc[c] += the sum of a[r][c] over the tile's rows, for c < width, over the
// bf16 A tile a [64][mma_stride(width)] (rows past n are zero): a warp per
// pair of neighbouring columns (one word a row), its lanes over rows, each
// column's sum a fixed xor-shuffle tree in f32.
__device__ inline void add_column_sums_bf16(const __nv_bfloat16* __restrict__ a, int width,
                                            double* __restrict__ acc) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int sa = mma_stride(width);
  for (int c = 2 * (threadIdx.x >> 5); c < width; c += 2 * kWarps) {
    const unsigned lo = *reinterpret_cast<const unsigned*>(a + lane * sa + c);
    const unsigned hi = *reinterpret_cast<const unsigned*>(a + (lane + 32) * sa + c);
    float v0 = bf16_lo(lo) + bf16_lo(hi);
    float v1 = bf16_hi(lo) + bf16_hi(hi);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v0 += __shfl_xor_sync(0xffffffffu, v0, o);
      v1 += __shfl_xor_sync(0xffffffffu, v1, o);
    }
    if (lane == 0) {
      acc[c] += (double)v0;
      if (c + 1 < width) acc[c + 1] += (double)v1;
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
// whole MLP). blob: the bf16 layout of mma_tile.cuh. part: [gridDim.x][kOut]
// f64.
__global__ void __launch_bounds__(kThreads, 2)
stage_kernel(int variant, const __nv_bfloat16* __restrict__ x, long long n,
             const unsigned char* __restrict__ blob, int blob_words16, MlpDims d, int stages,
             double* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d0 = d.dim[0];
  const int C = d.dim[d.n_layers];
  const bool tail = variant == kTailNoMax || variant == kFull;
  unsigned char* p = smem_raw + 16 * blob_words16;
  double* acc = reinterpret_cast<double*>(p);
  float* mx = reinterpret_cast<float*>(acc + kOut);
  TailScratch t = carve_tail(p + kProfileScratch, C);
  unsigned char* act0 = p + kProfileScratch + tail_bytes(C);
  unsigned char* act1 = act0 + mma_tile_bytes(d);
  __nv_bfloat16* in = mma_input(d, act0, act1);
  const long long n_tiles = (n + kTileRows - 1) / kTileRows;
  const RowRing<__nv_bfloat16> ring{x, n, d0, stages, act1 + mma_out_bytes(d), n_tiles};
  copy_words16(smem_raw, blob, blob_words16);
  for (int c = threadIdx.x; c < kOut; c += kThreads) acc[c] = 0.0;
  tail_init(t, C);
  ring_start(ring);
  __syncthreads();

  int j = 0;  // this block's tile count
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++j) {
    const long long row0 = tile * kTileRows;
    load_rows_tile_bf16<__nv_bfloat16>(ring, j, row0, in);
    __syncthreads();
    if (d.n_layers == 0) {
      add_column_sums_bf16(in, d0, acc);
    } else {
      const float* h = mlp_stack_bf16(d, smem_raw, act0, act1);
      if (variant == kFull) {
        tail_tile(t, h, C, row0, n);
      } else if (variant == kTailNoMax) {
        tail_nomax_tile(t, mx, h, C, row0, n);
      } else {
        add_column_sums(h, C, (int)min((long long)kTileRows, n - row0), acc);
      }
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
                               long long blob_words, const MlpDims& d, int stages, void* part,
                               int n_blocks, int smem_bytes, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e != cudaSuccess) return e;
  stage_kernel<<<n_blocks, kThreads, smem_bytes, s>>>(variant, (const __nv_bfloat16*)x, n,
                                                      (const unsigned char*)blob,
                                                      (int)(blob_words / 4), d, stages,
                                                      (double*)part);
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
// n_layers: the stage's layers, blob as int32 words in the bf16 layout of
// mma_tile.cuh (n_layers 0 for scan). stages: K7a's ring of row-major tiles
// (query_tile.cuh). part: [n_blocks, 128] f64 scratch; out: [128] f32.
// Returns a cudaError_t.
int infera_profile_stage(int variant, const void* x, long long n, const void* blob,
                         long long blob_words, const int* dims, int n_layers, int stages,
                         void* part, void* out, int n_blocks, int smem_bytes, void* stream) {
  const infera::MlpDims d = infera::make_dims(dims, n_layers);
  cudaStream_t s = (cudaStream_t)stream;
  if (variant < infera::kScan || variant > infera::kFull) return (int)cudaErrorInvalidValue;
  cudaError_t e = infera::launch_stage(variant, x, n, blob, blob_words, d, stages, part, n_blocks,
                                       smem_bytes, s);
  if (e != cudaSuccess) return (int)e;
  return infera::fold_stage(part, n_blocks, infera::kOut, out, s);
}

// Blocks of the stage kernel resident on one SM at `smem` bytes of dynamic
// shared memory, into *blocks. Returns a cudaError_t.
int infera_profile_stage_occupancy(int smem, int* blocks) {
  cudaError_t e = cudaFuncSetAttribute(infera::stage_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, infera::stage_kernel,
                                                            infera::kThreads, smem);
}

const char* infera_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
