// K1, K7a, K3 and K7b: the fused inference query.
//
//   scan x -> ReLU MLP -> argmax over classes (first index on ties)
//   -> keep rows with score0 > 0 -> per class: count of kept rows, sum of score0
//
// K1 replaces infera_tpu/ops/pallas_query.py `_query_kernel_columnar` /
// `fused_mlp_query_columnar` (a feature-major table x [d0, N]; f32, or bf16
// operands with f32 accumulation). K7a replaces `_query_kernel` /
// `fused_mlp_query`: the same function over a row-major table x [N, d0].
// K3 replaces `_query_kernel_columnar_int8_shift` /
// `fused_mlp_query_columnar_int8_shift` (int8 x int8 -> int32 layers with
// shift-only requantization between them). K7b replaces
// `_query_kernel_columnar_int8` / `fused_mlp_query_columnar_int8`: K3's layers
// with the static-calibration epilogue t = f32(y) * comb + bq, hidden layers
// requantized as clip(rint(t), 0, 127).
//
// Bound on the H100 at the main path's shapes (N = 1,048,576, a
// 32 -> 128 -> 128 -> 16 MLP, 2 * N * 22,528 = 47.2 G operations):
//   K1, K7a f32:  f32 operations, ~0.70 ms at 67 TFLOP/s (table: 134 MB, 0.04 ms).
//   K1, K7a bf16: bf16 tensor-core rate, ~0.048 ms at 989 TFLOP/s (table:
//                 67 MB, 0.02 ms).
//   K3, K7b:      int8 tensor-core rate, ~0.024 ms at 1,979 TOP/s (table:
//                 34 MB, 0.01 ms).
// Design: as fused_mlp.cu, the layer stack runs on a 64-row tile in shared
// memory with the weights resident per persistent block, and the table is
// read once. A feature-major f32 or bf16 table is read one row per thread and
// feature, so neighbouring threads read neighbouring addresses. K7a's 64-row
// tile is one contiguous run of 64 * d0 elements, copied ahead into a ring of
// buffers in shared memory (cp.async) and unpacked by the thread that copied
// each word (query_tile.cuh).
//
// bf16 mode (query_bf16_kernel) runs its layers on the tensor cores: warp-level
// mma.sync m16n8k16 with bf16 operands and f32 accumulators, the operands read
// from padded, bank-conflict-free shared memory with ldmatrix (mma_tile.cuh),
// as the TPU kernel's jnp.dot(bf16, bf16, preferred_element_type=f32). Its
// load writes the bf16 A tile [row][k] directly (a bf16 table's word is a
// 16-byte copy). Weights at bf16 and no f32 activation tiles halve its shared
// memory (about 96 KB at the bench MLP), and __launch_bounds__(256, 2) keeps
// it at 128 registers, so two blocks share an SM: one block's load and tail
// run beside the other's layers. What bounds it now is no longer the f32
// cores but a block's serial chain: the load, a barrier, three layers with a
// barrier each and the tail's per-class loop over the tile's rows (at the
// bench MLP it takes about 9 times its tensor-core bound); wgmma and warp
// specialisation, which overlap those steps, are the next design. f32
// mode stays on the f32 cores (fmaf over register tiles, mlp_tile.cuh's
// mlp_stack_ffma): TF32 would change its results. Its weights alone take 91
// KB of shared memory at the bench MLP, so a second block cannot share the
// SM; instead a block of 512 threads runs two halves of 256, each on its own
// tiles with its own activations and named barrier, over one copy of the
// weights (232,000 B at the bench MLP), so that one half's load, barriers
// and tail run beside the other half's FMAs. Every warp of a half works on
// every layer, the narrow last one included. An MLP whose two halves do not
// fit runs one half, with K7a's ring; at two halves K7a loads without it
// (the scalar path), the other half's layers hiding the latency.
//
// K3 and K7b (query_int8_kernel) run their layers on the tensor cores too:
// mma.sync m16n8k32, s8 x s8 -> s32, with mma_tile.cuh's ldmatrix addressing
// counted in bytes (imma_tile.cuh). s32 sums are exact in any order, so
// their outputs do not depend on the order of the products. The load
// transposes the int8 table into the A tile [row][k] a word at a time (4
// rows x 4 features per __byte_perm transposition), from a ring of staging
// buffers that cp.async fills a tile ahead. Their shared memory is about 53
// KB at the bench MLP and __launch_bounds__(256, 3) holds them to 80
// registers, so three blocks share an SM and the grid is sized by the
// kernel's measured occupancy: one block's load and tail overlap the
// others' layers, while a block's own chain stays serial.
//
// Cross-tile accumulation: the TPU grid runs in order and keeps the per-class
// accumulators resident. Here blocks run in any order, so every block keeps
// its own counts (int64) and sums (f64, summed in row order) and writes them to
// partials [n_blocks, C]; a second kernel folds the partials in block order.
// No float atomics, so the sums are the same from run to run.
#include "imma_tile.cuh"
#include "query_tile.cuh"

namespace infera {

// ---------------------------------------------------------------- K1, K7a in f32

// f32 mode on the f32 cores, `halves` (blockDim.x / kThreads) tile groups a
// block (mlp_tile.cuh's Half). Shared memory: the f32 weights and biases
// once, then each half's tail scratch, act0 and act1, then (one half only)
// K7a's ring; the wrapper passes stages = 0 with two halves, whose tiles
// take the scalar load. At most 128 registers a thread, so that a block of
// two halves fits an SM.
template <typename TIn, bool kRowMajor>
__global__ void __launch_bounds__(kMaxHalves * kThreads, 1)
query_f32_kernel(const TIn* __restrict__ x, long long n, const float* __restrict__ blob,
                 int blob_words16, MlpDims d, int widest, int stages,
                 long long* __restrict__ part_cnt, double* __restrict__ part_sum) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Half g = this_half();
  const int C = d.dim[d.n_layers];
  float* s_blob = reinterpret_cast<float*>(smem_raw);
  unsigned char* own = smem_raw + 16 * blob_words16 +
                       g.h * (tail_bytes(C) + 8 * widest * kActStride);
  TailScratch t = carve_tail(own, C);
  float* act0 = reinterpret_cast<float*>(own + tail_bytes(C));
  float* act1 = act0 + widest * kActStride;
  const int d0 = d.dim[0];
  const long long n_tiles = (n + kTileRows - 1) / kTileRows;
  // K7a only: the ring of row-major tiles (query_tile.cuh)
  const RowRing<TIn> ring{x, n, d0, stages,
                          reinterpret_cast<unsigned char*>(act1 + widest * kActStride), n_tiles};
  copy_words16(s_blob, blob, blob_words16, threadIdx.x, blockDim.x);
  tail_init(t, C, g);
  if (kRowMajor) ring_start(ring, g);
  __syncthreads();

  int j = 0;  // this half's tile count
  for (long long tile = g.index(); tile < n_tiles; tile += g.step(), ++j) {
    const long long row0 = tile * kTileRows;
    if (kRowMajor) {
      load_rows_tile<TIn>(ring, j, row0, act0, g);
    } else {
      for (int i = g.tid(); i < kTileRows * d0; i += kThreads) {
        const int k = i / kTileRows;
        const int r = i - k * kTileRows;
        const long long row = row0 + r;
        act0[k * kActStride + r] = row < n ? load_f32(x + (long long)k * n + row) : 0.f;
      }
    }
    g.sync();
    const float* h = mlp_stack_ffma(d, s_blob, act0, act1, g);
    tail_tile(t, h, C, row0, n, g);
  }
  tail_store(t, C, part_cnt, part_sum, g);
}

// ---------------------------------------------------------------- K1, K7a in bf16

// bf16 mode on the tensor cores (mma_tile.cuh). Shared memory: the bf16
// weights and f32 biases, the tail's scratch, act0 (an A tile), act1 (an A
// tile or the scores), then K7a's ring. At most 128 registers a thread, so
// that two blocks share an SM.
template <typename TIn, bool kRowMajor>
__global__ void __launch_bounds__(kThreads, 2)
query_bf16_kernel(const TIn* __restrict__ x, long long n, const unsigned char* __restrict__ blob,
                  int blob_words16, MlpDims d, int stages, long long* __restrict__ part_cnt,
                  double* __restrict__ part_sum) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = d.dim[d.n_layers];
  TailScratch t = carve_tail(smem_raw + 16 * blob_words16, C);
  unsigned char* act0 = smem_raw + 16 * blob_words16 + tail_bytes(C);
  unsigned char* act1 = act0 + mma_tile_bytes(d);
  __nv_bfloat16* in = mma_input(d, act0, act1);
  const int d0 = d.dim[0];
  const long long n_tiles = (n + kTileRows - 1) / kTileRows;
  // K7a only: the ring of row-major tiles (query_tile.cuh)
  const RowRing<TIn> ring{x, n, d0, stages, act1 + mma_out_bytes(d), n_tiles};
  copy_words16(smem_raw, blob, blob_words16);
  tail_init(t, C);
  if (kRowMajor) ring_start(ring);
  __syncthreads();

  int j = 0;  // this block's tile count
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++j) {
    const long long row0 = tile * kTileRows;
    if (kRowMajor)
      load_rows_tile_bf16<TIn>(ring, j, row0, in);
    else
      load_cols_tile_bf16<TIn>(x, n, d0, row0, in);
    __syncthreads();
    const float* h = mlp_stack_bf16(d, smem_raw, act0, act1);
    tail_tile(t, h, C, row0, n);
  }
  tail_store(t, C, part_cnt, part_sum);
}

// ---------------------------------------------------------------- K3 (shifts), K7b (static)

// Blocks of the int8 kernel that registers must leave room for on one SM:
// at most 80 registers a thread. Shared memory (53,696 B at the bench MLP)
// allows four, but at 64 registers the kernel ran slower (measured on the
// H100), and at two blocks slower still.
constexpr int kInt8MinBlocks = 3;

// K3 (kStatic = false) and K7b (kStatic = true) over xq [d0, N] int8, the
// layers on the tensor cores (imma_tile.cuh). Shared memory: the int8
// weights and epilogue rows, the tail's scratch, act0, act1, then the
// load's ring of staging buffers.
template <bool kStatic>
__global__ void __launch_bounds__(kThreads, kInt8MinBlocks)
query_int8_kernel(const int8_t* __restrict__ xq, long long n,
                  const unsigned char* __restrict__ blob, int blob_words16, MlpDims d,
                  int need_sl_mask, int stages, long long* __restrict__ part_cnt,
                  double* __restrict__ part_sum) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = d.dim[d.n_layers];
  TailScratch t = carve_tail(smem_raw + 16 * blob_words16, C);
  unsigned char* act0 = smem_raw + 16 * blob_words16 + tail_bytes(C);
  unsigned char* act1 = act0 + imma_act_bytes(d, 1);
  unsigned char* in = (d.n_layers & 1) ? act0 : act1;
  const long long n_tiles = (n + kTileRows - 1) / kTileRows;
  // the ring of staging buffers (imma_tile.cuh) after the tiles
  const ColRing ring{xq, n, d.dim[0], stages, act1 + imma_act_bytes(d, 0), n_tiles};
  copy_words16(smem_raw, blob, blob_words16);
  tail_init(t, C);
  col_ring_start(ring);
  __syncthreads();

  int j = 0;  // this block's tile count
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++j) {
    const long long row0 = tile * kTileRows;
    load_cols_tile_int8(ring, j, row0, in);
    __syncthreads();
    const float* h = mlp_stack_int8<kStatic>(d, smem_raw, act0, act1, need_sl_mask);
    tail_tile(t, h, C, row0, n);
  }
  tail_store(t, C, part_cnt, part_sum);
}

// ---------------------------------------------------------------- fold of the partials

// One thread per class adds the blocks' partials in block order.
__global__ void fold_partials_kernel(const long long* __restrict__ part_cnt,
                                     const double* __restrict__ part_sum, int n_blocks, int C,
                                     long long* __restrict__ counts, float* __restrict__ sums) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    long long cnt = 0;
    double sum = 0.0;
    for (int b = 0; b < n_blocks; ++b) {
      cnt += part_cnt[(long long)b * C + c];
      sum += part_sum[(long long)b * C + c];
    }
    counts[c] = cnt;
    sums[c] = (float)sum;
  }
}

template <typename Kernel>
inline cudaError_t set_smem(Kernel k, int smem_bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

template <typename TIn, bool kRowMajor>
cudaError_t launch_query_f32(const void* x, long long n, const void* blob, long long blob_floats,
                             MlpDims d, int widest, int stages, void* part_cnt, void* part_sum,
                             int n_blocks, int halves, int smem_bytes, cudaStream_t stream) {
  cudaError_t e = set_smem(query_f32_kernel<TIn, kRowMajor>, smem_bytes);
  if (e != cudaSuccess) return e;
  query_f32_kernel<TIn, kRowMajor><<<n_blocks, halves * kThreads, smem_bytes, stream>>>(
      (const TIn*)x, n, (const float*)blob, (int)(blob_floats / 4), d, widest, stages,
      (long long*)part_cnt, (double*)part_sum);
  return cudaGetLastError();
}

inline cudaError_t fold(const void* part_cnt, const void* part_sum, int n_blocks, int C,
                        void* counts, void* sums, cudaStream_t s) {
  fold_partials_kernel<<<1, kThreads, 0, s>>>((const long long*)part_cnt,
                                              (const double*)part_sum, n_blocks, C,
                                              (long long*)counts, (float*)sums);
  return cudaGetLastError();
}

template <bool kRowMajor>
int query_f32(const void* x, int x_bf16, long long n, const void* blob, long long blob_floats,
              const int* dims, int n_layers, int widest, int stages, void* part_cnt,
              void* part_sum, void* counts, void* sums, int n_blocks, int halves, int smem_bytes,
              void* stream) {
  const MlpDims d = make_dims(dims, n_layers);
  cudaStream_t s = (cudaStream_t)stream;
  if (halves < 1 || halves > kMaxHalves) return (int)cudaErrorInvalidValue;
  cudaError_t e =
      x_bf16 ? launch_query_f32<__nv_bfloat16, kRowMajor>(x, n, blob, blob_floats, d, widest,
                                                           stages, part_cnt, part_sum, n_blocks,
                                                           halves, smem_bytes, s)
             : launch_query_f32<float, kRowMajor>(x, n, blob, blob_floats, d, widest, stages,
                                                  part_cnt, part_sum, n_blocks, halves,
                                                  smem_bytes, s);
  if (e != cudaSuccess) return (int)e;
  // one row of partials a half, in row order
  return (int)fold(part_cnt, part_sum, n_blocks * halves, d.dim[n_layers], counts, sums, s);
}

// the f32 kernel of a table type and layout
template <typename TIn>
inline auto f32_kernel(int row_major) {
  return row_major ? query_f32_kernel<TIn, true> : query_f32_kernel<TIn, false>;
}

// the bf16 kernel of a table type and layout
template <typename TIn>
inline auto bf16_kernel(int row_major) {
  return row_major ? query_bf16_kernel<TIn, true> : query_bf16_kernel<TIn, false>;
}

template <typename TIn>
cudaError_t launch_query_bf16(const void* x, int row_major, long long n, const void* blob,
                              long long blob_words, MlpDims d, int stages, void* part_cnt,
                              void* part_sum, int n_blocks, int smem_bytes, cudaStream_t stream) {
  const auto k = bf16_kernel<TIn>(row_major);
  cudaError_t e = set_smem(k, smem_bytes);
  if (e != cudaSuccess) return e;
  k<<<n_blocks, kThreads, smem_bytes, stream>>>((const TIn*)x, n, (const unsigned char*)blob,
                                                (int)(blob_words / 4), d, stages,
                                                (long long*)part_cnt, (double*)part_sum);
  return cudaGetLastError();
}

template <bool kStatic>
int query_int8(const void* xq, long long n, const void* blob, long long blob_words,
               const int* dims, int n_layers, int need_sl_mask, int stages, void* part_cnt,
               void* part_sum, void* counts, void* sums, int n_blocks, int smem_bytes,
               void* stream) {
  const MlpDims d = make_dims(dims, n_layers);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = set_smem(query_int8_kernel<kStatic>, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  query_int8_kernel<kStatic><<<n_blocks, kThreads, smem_bytes, s>>>(
      (const int8_t*)xq, n, (const unsigned char*)blob, (int)(blob_words / 4), d, need_sl_mask,
      stages, (long long*)part_cnt, (double*)part_sum);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)fold(part_cnt, part_sum, n_blocks, d.dim[n_layers], counts, sums, s);
}

}  // namespace infera

extern "C" {

// K1 in f32. x: [d0, n] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); blob: the
// f32 layout of mlp_tile.cuh; `halves` (1 or 2) tile groups a block of
// halves x 256 threads, and partials [n_blocks * halves, C]. Outputs counts
// [C] int64 and sums [C] f32. Returns a cudaError_t.
int infera_fused_query_f32(const void* x, int x_bf16, long long n, const void* blob,
                           long long blob_floats, const int* dims, int n_layers, int widest,
                           void* part_cnt, void* part_sum, void* counts, void* sums, int n_blocks,
                           int halves, int smem_bytes, void* stream) {
  return infera::query_f32<false>(x, x_bf16, n, blob, blob_floats, dims, n_layers, widest, 0,
                                  part_cnt, part_sum, counts, sums, n_blocks, halves, smem_bytes,
                                  stream);
}

// K7a in f32: K1 over a row-major table x [n, d0]; the same arguments, and
// the ring's buffers (`stages`, each [64][ring_stride(d0)] bytes after the
// activation tiles; 0: the scalar load; one half only).
int infera_fused_query_rows(const void* x, int x_bf16, long long n, const void* blob,
                            long long blob_floats, const int* dims, int n_layers, int widest,
                            int stages, void* part_cnt, void* part_sum, void* counts, void* sums,
                            int n_blocks, int halves, int smem_bytes, void* stream) {
  if (halves > 1 && stages > 0) return (int)cudaErrorInvalidValue;
  return infera::query_f32<true>(x, x_bf16, n, blob, blob_floats, dims, n_layers, widest, stages,
                                 part_cnt, part_sum, counts, sums, n_blocks, halves, smem_bytes,
                                 stream);
}

// Blocks of the f32 kernel for (x_bf16, row_major) resident on one SM at
// `halves` x 256 threads and `smem` bytes of dynamic shared memory, into
// *blocks. Returns a cudaError_t.
int infera_fused_query_f32_occupancy(int x_bf16, int row_major, int halves, int smem,
                                     int* blocks) {
  using namespace infera;
  cudaError_t e;
  if (x_bf16) {
    const auto k = f32_kernel<__nv_bfloat16>(row_major);
    e = set_smem(k, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, halves * kThreads, smem);
  } else {
    const auto k = f32_kernel<float>(row_major);
    e = set_smem(k, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, halves * kThreads, smem);
  }
  return (int)e;
}

// K1 (row_major = 0, x [d0, n]) and K7a (row_major = 1, x [n, d0], with
// its ring's `stages`) in bf16 mode, on the tensor cores. x: f32 (x_bf16 =
// 0, rounded to bf16 at load) or bf16; blob: int32 words in the layout of
// mma_tile.cuh. Outputs as K1's. Returns a cudaError_t.
int infera_fused_query_bf16(const void* x, int x_bf16, int row_major, long long n,
                            const void* blob, long long blob_words, const int* dims, int n_layers,
                            int stages, void* part_cnt, void* part_sum, void* counts, void* sums,
                            int n_blocks, int smem_bytes, void* stream) {
  using namespace infera;
  const MlpDims d = make_dims(dims, n_layers);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e =
      x_bf16 ? launch_query_bf16<__nv_bfloat16>(x, row_major, n, blob, blob_words, d, stages,
                                                 part_cnt, part_sum, n_blocks, smem_bytes, s)
             : launch_query_bf16<float>(x, row_major, n, blob, blob_words, d, stages, part_cnt,
                                        part_sum, n_blocks, smem_bytes, s);
  if (e != cudaSuccess) return (int)e;
  return (int)fold(part_cnt, part_sum, n_blocks, d.dim[n_layers], counts, sums, s);
}

// Blocks of the bf16 kernel for (x_bf16, row_major) resident on one SM at
// `smem` bytes of dynamic shared memory (registers, shared memory and
// threads all counted), into *blocks. Returns a cudaError_t.
int infera_fused_query_bf16_occupancy(int x_bf16, int row_major, int smem, int* blocks) {
  using namespace infera;
  cudaError_t e;
  if (x_bf16) {
    const auto k = bf16_kernel<__nv_bfloat16>(row_major);
    e = set_smem(k, smem);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, kThreads, smem);
  } else {
    const auto k = bf16_kernel<float>(row_major);
    e = set_smem(k, smem);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, kThreads, smem);
  }
  return (int)e;
}

// K3. xq: [d0, n] int8. blob: int32 words as laid out in imma_tile.cuh. Bit l
// of need_sl_mask says whether hidden layer l applies its left shifts;
// `stages`: the load's staging buffers (imma_tile.cuh), each
// int8_stage_bytes(d0) after the activation tiles (0: the byte path).
int infera_fused_query_int8_shift(const void* xq, long long n, const void* blob,
                                  long long blob_words, const int* dims, int n_layers,
                                  int need_sl_mask, int stages, void* part_cnt, void* part_sum,
                                  void* counts, void* sums, int n_blocks, int smem_bytes,
                                  void* stream) {
  return infera::query_int8<false>(xq, n, blob, blob_words, dims, n_layers, need_sl_mask, stages,
                                   part_cnt, part_sum, counts, sums, n_blocks, smem_bytes, stream);
}

// K7b. xq: [d0, n] int8. blob: K3's layout with the epilogue rows (comb, 0,
// bq) of every layer as float bits; `stages` as K3's.
int infera_fused_query_int8_static(const void* xq, long long n, const void* blob,
                                   long long blob_words, const int* dims, int n_layers,
                                   int stages, void* part_cnt, void* part_sum, void* counts,
                                   void* sums, int n_blocks, int smem_bytes, void* stream) {
  return infera::query_int8<true>(xq, n, blob, blob_words, dims, n_layers, 0, stages, part_cnt,
                                  part_sum, counts, sums, n_blocks, smem_bytes, stream);
}

// Blocks of K3 (is_static = 0) or K7b (1) resident on one SM at `smem`
// bytes of dynamic shared memory (registers, shared memory and threads all
// counted), into *blocks. Returns a cudaError_t.
int infera_fused_query_int8_occupancy(int is_static, int smem, int* blocks) {
  using namespace infera;
  const auto k = is_static ? query_int8_kernel<true> : query_int8_kernel<false>;
  cudaError_t e = set_smem(k, smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, kThreads, smem);
  return (int)e;
}

const char* infera_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
