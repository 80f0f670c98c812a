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
// read once. A feature-major table is read one row per thread and feature, so
// neighbouring threads read neighbouring addresses. K7a's 64-row tile is one
// contiguous run of 64 * d0 elements, copied ahead into a ring of buffers in
// shared memory (cp.async, about 20 KB in flight on each SM while the block
// computes the tile before) and transposed by the thread that copied each
// word into the feature-major activation tile (query_tile.cuh). bf16 mode
// rounds its operands to bf16 exactly where the TPU kernel does and
// multiplies them on the f32 cores (a bf16 x bf16 product is exact in f32);
// K3 and K7b use __dp4a (4 int8 products per instruction). None uses the
// tensor cores yet, so all are far from their bounds, and K7a's layers, not
// its load, set its pace (K8b splits it by stage): wgmma and warp
// specialisation are the next design.
//
// Cross-tile accumulation: the TPU grid runs in order and keeps the per-class
// accumulators resident. Here blocks run in any order, so every block keeps
// its own counts (int64) and sums (f64, summed in row order) and writes them to
// partials [n_blocks, C]; a second kernel folds the partials in block order.
// No float atomics, so the sums are the same from run to run.
#include "query_tile.cuh"

namespace infera {

// ---------------------------------------------------------------- K1, K7a (f32, bf16)

template <typename TIn, bool kBf16, bool kRowMajor>
__global__ void __launch_bounds__(kThreads)
query_f32_kernel(const TIn* __restrict__ x, long long n, const float* __restrict__ blob,
                 int blob_words16, MlpDims d, int widest, int stages,
                 long long* __restrict__ part_cnt, double* __restrict__ part_sum) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = d.dim[d.n_layers];
  float* s_blob = reinterpret_cast<float*>(smem_raw);
  TailScratch t = carve_tail(smem_raw + 16 * blob_words16, C);
  float* act0 = reinterpret_cast<float*>(smem_raw + 16 * blob_words16 + tail_bytes(C));
  float* act1 = act0 + widest * kActStride;
  const int d0 = d.dim[0];
  const long long n_tiles = (n + kTileRows - 1) / kTileRows;
  // K7a only: the ring of row-major tiles (query_tile.cuh)
  const RowRing<TIn> ring{x, n, d0, stages,
                          reinterpret_cast<unsigned char*>(act1 + widest * kActStride), n_tiles};
  copy_words16(s_blob, blob, blob_words16);
  tail_init(t, C);
  if (kRowMajor) ring_start(ring);
  __syncthreads();

  int j = 0;  // this block's tile count
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++j) {
    const long long row0 = tile * kTileRows;
    if (kRowMajor) {
      load_rows_tile<TIn, kBf16>(ring, j, row0, act0);
    } else {
      for (int i = threadIdx.x; i < kTileRows * d0; i += kThreads) {
        const int k = i / kTileRows;
        const int r = i - k * kTileRows;
        const long long row = row0 + r;
        float v = row < n ? load_f32(x + (long long)k * n + row) : 0.f;
        if (kBf16) v = round_bf16(v);
        act0[k * kActStride + r] = v;
      }
    }
    __syncthreads();
    const float* h = mlp_stack_f32<kBf16>(d, s_blob, act0, act1);
    tail_tile(t, h, C, row0, n);
  }
  tail_store(t, C, part_cnt, part_sum);
}

// ---------------------------------------------------------------- K3 (shifts), K7b (static)

// One int8 layer on packed activations in [div4(din)][kActStride] int32 words.
// Hidden, K3: q = clip(((y << sl) + bias_pre) >> sr, 0, 127); K7b: q =
// clip(rint(f32(y) * comb + bq), 0, 127); written packed to out_q. Last: h =
// y * comb + bias in f32, to out_h. The f32 multiply and add are written as
// two roundings (no contraction into an FMA), as the TPU kernel writes them and
// the plain version computes them; rintf rounds half to even, as jnp.rint
// does. f32(y) is exact while |y| <= 127 * 127 * din < 2^24 (K7b's wrapper
// checks din).
template <bool kLast, bool kStatic>
__device__ inline void dense_int8(const int* __restrict__ in, int din4,
                                  const int* __restrict__ w, const int* __restrict__ epi,
                                  int doutp, bool need_sl, int* __restrict__ out_q,
                                  float* __restrict__ out_h) {
  const int tr = threadIdx.x & 15;
  const int tc = threadIdx.x >> 4;
  for (int cbase = 0; cbase < doutp; cbase += 128) {
    const int c0 = cbase + 8 * tc;
    if (c0 >= doutp) break;
    int acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0;
#pragma unroll 4
    for (int k = 0; k < din4; ++k) {
      const int4 a = *reinterpret_cast<const int4*>(in + k * kActStride + 4 * tr);
      const int4 b0 = *reinterpret_cast<const int4*>(w + k * doutp + c0);
      const int4 b1 = *reinterpret_cast<const int4*>(w + k * doutp + c0 + 4);
      const int av[4] = {a.x, a.y, a.z, a.w};
      const int bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    if (kLast) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float comb = __int_as_float(epi[c0 + j]);
        const float bias = __int_as_float(epi[2 * doutp + c0 + j]);
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), comb), bias);
        *reinterpret_cast<float4*>(out_h + (c0 + j) * kActStride + 4 * tr) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        int word[4] = {0, 0, 0, 0};
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int c = c0 + 4 * jj + b;
          if (kStatic) {
            const float comb = __int_as_float(epi[c]);
            const float bq = __int_as_float(epi[2 * doutp + c]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float t =
                  __fadd_rn(__fmul_rn(__int2float_rn(acc[i][4 * jj + b]), comb), bq);
              // ReLU folds into the clip's floor
              const int q = (int)fminf(fmaxf(rintf(t), 0.f), 127.f);
              word[i] |= q << (8 * b);
            }
          } else {
            const int sl = epi[c];
            const int sr = min(epi[doutp + c], 31);
            const int bx = epi[2 * doutp + c];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              int y = acc[i][4 * jj + b];
              // int32 wrap-around like jnp.left_shift; >> is arithmetic
              if (need_sl) y = (int)((unsigned)y << sl);
              y += bx;
              const int q = min(max(y >> sr, 0), 127);
              word[i] |= q << (8 * b);
            }
          }
        }
        *reinterpret_cast<int4*>(out_q + (c0 / 4 + jj) * kActStride + 4 * tr) =
            make_int4(word[0], word[1], word[2], word[3]);
      }
    }
  }
}

// K3 (kStatic = false) and K7b (kStatic = true) over xq [d0, N] int8.
template <bool kStatic>
__global__ void __launch_bounds__(kThreads)
query_int8_kernel(const int8_t* __restrict__ xq, long long n, const int* __restrict__ blob,
                  int blob_words16, MlpDims d, int widest4, int need_sl_mask,
                  long long* __restrict__ part_cnt, double* __restrict__ part_sum) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = d.n_layers;
  const int C = d.dim[L];
  int* s_blob = reinterpret_cast<int*>(smem_raw);
  TailScratch t = carve_tail(smem_raw + 16 * blob_words16, C);
  int* act0 = reinterpret_cast<int*>(smem_raw + 16 * blob_words16 + tail_bytes(C));
  int* act1 = act0 + widest4 * kActStride;
  float* hbuf = reinterpret_cast<float*>(act1 + widest4 * kActStride);  // [pad8(C)][kActStride]
  copy_words16(s_blob, blob, blob_words16);
  tail_init(t, C);
  __syncthreads();

  int e_base = 0;
  for (int l = 0; l < L; ++l) e_base += div4(d.dim[l]) * pad8(d.dim[l + 1]);

  const int d0 = d.dim[0];
  const int d04 = div4(d0);
  const long long n_tiles = (n + kTileRows - 1) / kTileRows;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * kTileRows;
    // pack 4 consecutive features of one row into one word (zero beyond d0)
    for (int i = threadIdx.x; i < kTileRows * d04; i += kThreads) {
      const int k4 = i / kTileRows;
      const int r = i - k4 * kTileRows;
      const long long row = row0 + r;
      unsigned word = 0;
      if (row < n) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int f = 4 * k4 + b;
          if (f < d0) word |= (unsigned)(uint8_t)xq[(long long)f * n + row] << (8 * b);
        }
      }
      act0[k4 * kActStride + r] = (int)word;
    }
    __syncthreads();
    int* cur = act0;
    int* nxt = act1;
    int wl = 0;
    int el = e_base;
    for (int l = 0; l < L; ++l) {
      const int din4 = div4(d.dim[l]);
      const int doutp = pad8(d.dim[l + 1]);
      if (l + 1 < L) {
        dense_int8<false, kStatic>(cur, din4, s_blob + wl, s_blob + el, doutp,
                                   (need_sl_mask >> l) & 1, nxt, nullptr);
      } else {
        dense_int8<true, kStatic>(cur, din4, s_blob + wl, s_blob + el, doutp, false, nullptr,
                                  hbuf);
      }
      __syncthreads();
      wl += din4 * doutp;
      el += 3 * doutp;
      int* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    tail_tile(t, hbuf, C, row0, n);
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

template <typename TIn, bool kBf16, bool kRowMajor>
cudaError_t launch_query_f32(const void* x, long long n, const void* blob, long long blob_floats,
                             MlpDims d, int widest, int stages, void* part_cnt, void* part_sum,
                             int n_blocks, int smem_bytes, cudaStream_t stream) {
  cudaError_t e = set_smem(query_f32_kernel<TIn, kBf16, kRowMajor>, smem_bytes);
  if (e != cudaSuccess) return e;
  query_f32_kernel<TIn, kBf16, kRowMajor><<<n_blocks, kThreads, smem_bytes, stream>>>(
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
int query_f32(const void* x, int x_bf16, int compute_bf16, long long n, const void* blob,
              long long blob_floats, const int* dims, int n_layers, int widest, int stages,
              void* part_cnt, void* part_sum, void* counts, void* sums, int n_blocks,
              int smem_bytes, void* stream) {
  const MlpDims d = make_dims(dims, n_layers);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (x_bf16) {
    e = compute_bf16
            ? launch_query_f32<__nv_bfloat16, true, kRowMajor>(x, n, blob, blob_floats, d, widest,
                                                               stages, part_cnt, part_sum,
                                                               n_blocks, smem_bytes, s)
            : launch_query_f32<__nv_bfloat16, false, kRowMajor>(x, n, blob, blob_floats, d,
                                                                widest, stages, part_cnt,
                                                                part_sum, n_blocks, smem_bytes, s);
  } else {
    e = compute_bf16
            ? launch_query_f32<float, true, kRowMajor>(x, n, blob, blob_floats, d, widest, stages,
                                                       part_cnt, part_sum, n_blocks, smem_bytes, s)
            : launch_query_f32<float, false, kRowMajor>(x, n, blob, blob_floats, d, widest,
                                                        stages, part_cnt, part_sum, n_blocks,
                                                        smem_bytes, s);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)fold(part_cnt, part_sum, n_blocks, d.dim[n_layers], counts, sums, s);
}

template <bool kStatic>
int query_int8(const void* xq, long long n, const void* blob, long long blob_ints,
               const int* dims, int n_layers, int widest4, int need_sl_mask, void* part_cnt,
               void* part_sum, void* counts, void* sums, int n_blocks, int smem_bytes,
               void* stream) {
  const MlpDims d = make_dims(dims, n_layers);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = set_smem(query_int8_kernel<kStatic>, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  query_int8_kernel<kStatic><<<n_blocks, kThreads, smem_bytes, s>>>(
      (const int8_t*)xq, n, (const int*)blob, (int)(blob_ints / 4), d, widest4, need_sl_mask,
      (long long*)part_cnt, (double*)part_sum);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)fold(part_cnt, part_sum, n_blocks, d.dim[n_layers], counts, sums, s);
}

}  // namespace infera

extern "C" {

// K1. x: [d0, n] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); compute_bf16 selects
// the bf16 mode. Outputs counts [C] int64 and sums [C] f32. Returns a
// cudaError_t.
int infera_fused_query_f32(const void* x, int x_bf16, int compute_bf16, long long n,
                           const void* blob, long long blob_floats, const int* dims, int n_layers,
                           int widest, void* part_cnt, void* part_sum, void* counts, void* sums,
                           int n_blocks, int smem_bytes, void* stream) {
  return infera::query_f32<false>(x, x_bf16, compute_bf16, n, blob, blob_floats, dims, n_layers,
                                  widest, 0, part_cnt, part_sum, counts, sums, n_blocks,
                                  smem_bytes, stream);
}

// K7a: K1 over a row-major table x [n, d0]; the same arguments, and the
// ring's buffers (`stages`, each [64][ring_stride(d0)] bytes after the
// activation tiles; 0: the scalar load).
int infera_fused_query_rows(const void* x, int x_bf16, int compute_bf16, long long n,
                            const void* blob, long long blob_floats, const int* dims,
                            int n_layers, int widest, int stages, void* part_cnt,
                            void* part_sum, void* counts, void* sums, int n_blocks,
                            int smem_bytes, void* stream) {
  return infera::query_f32<true>(x, x_bf16, compute_bf16, n, blob, blob_floats, dims, n_layers,
                                 widest, stages, part_cnt, part_sum, counts, sums, n_blocks,
                                 smem_bytes, stream);
}

// K3. xq: [d0, n] int8. blob: int32 words as laid out in mlp_tile.cuh. Bit l
// of need_sl_mask says whether hidden layer l applies its left shifts.
int infera_fused_query_int8_shift(const void* xq, long long n, const void* blob,
                                  long long blob_ints, const int* dims, int n_layers,
                                  int widest4, int need_sl_mask, void* part_cnt, void* part_sum,
                                  void* counts, void* sums, int n_blocks, int smem_bytes,
                                  void* stream) {
  return infera::query_int8<false>(xq, n, blob, blob_ints, dims, n_layers, widest4,
                                   need_sl_mask, part_cnt, part_sum, counts, sums, n_blocks,
                                   smem_bytes, stream);
}

// K7b. xq: [d0, n] int8. blob: K3's layout with the epilogue rows (comb, 0,
// bq) of every layer as float bits.
int infera_fused_query_int8_static(const void* xq, long long n, const void* blob,
                                   long long blob_ints, const int* dims, int n_layers,
                                   int widest4, void* part_cnt, void* part_sum, void* counts,
                                   void* sums, int n_blocks, int smem_bytes, void* stream) {
  return infera::query_int8<true>(xq, n, blob, blob_ints, dims, n_layers, widest4, 0, part_cnt,
                                  part_sum, counts, sums, n_blocks, smem_bytes, stream);
}

const char* infera_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
