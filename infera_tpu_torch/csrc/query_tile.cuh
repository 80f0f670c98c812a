// Shared pieces of the fused query kernels (fused_query.cu: K1, K7a, K3, K7b;
// profile_query.cu: K8a, K8b): K7a's load of a row-major tile and the query's
// tail (argmax, the score0 > 0 filter, per-class count and sum per block).
#pragma once

#include "mlp_tile.cuh"

namespace infera {

// Row stride of K7a's staging tile [kTileRows][stage_stride(d0)]: odd, so the
// transposing read (consecutive rows on consecutive threads) hits 32 banks.
__host__ __device__ inline int stage_stride(int d0) { return d0 | 1; }

// K7a's load of the tile at row0 of a row-major table x [n, d0]: the tile's
// rows are one contiguous run of rows * d0 elements, read linearly into the
// staging tile stage [kTileRows][stage_stride(d0)], then transposed into the
// feature-major activation tile act [d0][kActStride]; rows past n are zero.
// kBf16 rounds every value to bf16. Ends without a barrier.
template <typename TIn, bool kBf16>
__device__ inline void load_rows_tile(const TIn* __restrict__ x, long long n, long long row0,
                                      int d0, float* __restrict__ stage,
                                      float* __restrict__ act) {
  const int ss = stage_stride(d0);
  const int rows = (int)min((long long)kTileRows, n - row0);
  const TIn* src = x + row0 * d0;
  for (int i = threadIdx.x; i < rows * d0; i += kThreads) {
    const int r = i / d0;
    stage[r * ss + (i - r * d0)] = load_f32(src + i);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTileRows * d0; i += kThreads) {
    const int k = i / kTileRows;
    const int r = i - k * kTileRows;
    float v = r < rows ? stage[r * ss + k] : 0.f;
    if (kBf16) v = round_bf16(v);
    act[k * kActStride + r] = v;
  }
}

struct TailScratch {
  long long* blk_cnt;  // [pad8(C)]
  double* blk_sum;     // [pad8(C)]
  int* pred;           // [kTileRows]: class of a kept row, -1 otherwise
  float* val;          // [kTileRows]: score0
};

__device__ inline TailScratch carve_tail(unsigned char* p, int C) {
  TailScratch t;
  t.blk_cnt = reinterpret_cast<long long*>(p);
  t.blk_sum = reinterpret_cast<double*>(t.blk_cnt + pad8(C));
  t.pred = reinterpret_cast<int*>(t.blk_sum + pad8(C));
  t.val = reinterpret_cast<float*>(t.pred + kTileRows);
  return t;
}

__host__ __device__ inline int tail_bytes(int C) {
  return pad8(C) * 16 + kTileRows * 8;
}

__device__ inline void tail_init(TailScratch t, int C) {
  for (int c = threadIdx.x; c < C; c += kThreads) {
    t.blk_cnt[c] = 0;
    t.blk_sum[c] = 0.0;
  }
}

// h: [C][kActStride] f32 scores of one tile. Ends with a barrier.
__device__ inline void tail_tile(TailScratch t, const float* h, int C, long long row0,
                                 long long n) {
  if (threadIdx.x < kTileRows) {
    const int r = threadIdx.x;
    const float v0 = h[r];
    int pred = -1;
    if (row0 + r < n && v0 > 0.f) {
      float best = v0;
      pred = 0;
      for (int c = 1; c < C; ++c) {
        const float v = h[c * kActStride + r];
        if (v > best) {
          best = v;
          pred = c;
        }
      }
    }
    t.pred[r] = pred;
    t.val[r] = v0;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    long long cnt = 0;
    double sum = 0.0;
    for (int r = 0; r < kTileRows; ++r) {
      if (t.pred[r] == c) {
        ++cnt;
        sum += (double)t.val[r];
      }
    }
    t.blk_cnt[c] += cnt;
    t.blk_sum[c] += sum;
  }
  __syncthreads();
}

__device__ inline void tail_store(TailScratch t, int C, long long* part_cnt, double* part_sum) {
  for (int c = threadIdx.x; c < C; c += kThreads) {
    part_cnt[(long long)blockIdx.x * C + c] = t.blk_cnt[c];
    part_sum[(long long)blockIdx.x * C + c] = t.blk_sum[c];
  }
}

}  // namespace infera
