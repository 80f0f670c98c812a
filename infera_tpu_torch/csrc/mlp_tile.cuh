// Shared pieces of the fused-MLP kernels (fused_mlp.cu, fused_query.cu, fused_sql.cu,
// profile_query.cu).
//
// A block of kThreads threads owns a tile of kTileRows table rows and runs the
// whole layer stack on it while the activations stay in shared memory. The
// weights of every layer are copied into shared memory once per block; the
// block then walks over row tiles (a persistent grid), so the weights are read
// from device memory once per block, not once per tile.
//
// This file's layers run on the f32 cores: K6, K1 and K7a in f32 (TF32 would
// change their results), K2' in fused_sql.cu (f32, and bf16 by rounding
// operands that are exact in f32). They are bound by the f32 FMA rate and by
// the shared-memory reads that feed it; the register tile below gives 32 FMAs
// for three 16-byte reads. K1 and K7a in bf16, and K8b, run their layers on
// the tensor cores instead (mma_tile.cuh), and so do K3 and K7b in int8
// (imma_tile.cuh).
//
// Activations live feature-major in shared memory: act[feature][row], with a
// row stride of kActStride words. One thread owns a 4-row x 8-column register
// tile of a layer's output (rows 4*tr..4*tr+3, columns c0..c0+7 of a
// 128-column pass), so each step of the reduction reads one 16-byte activation
// vector and two 16-byte weight vectors for 32 multiply-adds.
//
// Weight blob layout of the f32 kernels (built on the host by the Python
// wrappers): W_0 .. W_{L-1} as [din][pad8(dout)], then b_0 .. b_{L-1} as
// [pad8(dout)], zero-padded. The tensor-core kernels' blobs are laid out in
// mma_tile.cuh (bf16) and imma_tile.cuh (int8).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace infera {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;
// +4 words keeps every activation row 16-byte aligned and moves the rows of a
// transposing load onto different banks.
constexpr int kActStride = kTileRows + 4;
constexpr int kMaxLayers = 8;

struct MlpDims {
  int n_layers;
  int dim[kMaxLayers + 1];  // dim[0]: input width; dim[l + 1]: output width of layer l
};

__host__ __device__ inline int pad8(int n) { return (n + 7) & ~7; }

inline MlpDims make_dims(const int* dims, int n_layers) {
  MlpDims d;
  d.n_layers = n_layers;
  for (int i = 0; i <= kMaxLayers; ++i) d.dim[i] = i <= n_layers ? dims[i] : 0;
  return d;
}

__device__ inline float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ inline float load_f32(const float* p) { return *p; }
__device__ inline float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// out[c][r] = act(sum_k in[k][r] * w[k][c] + bias[c]) for every c < doutp and
// every row of the tile. kHidden applies ReLU (NaN passes through, as
// jnp.maximum does); kRoundBf16 then rounds the result to bf16.
template <bool kHidden, bool kRoundBf16>
__device__ inline void dense_f32(const float* __restrict__ in, int din,
                                 const float* __restrict__ w,
                                 const float* __restrict__ bias, int doutp,
                                 float* __restrict__ out) {
  const int tr = threadIdx.x & 15;
  const int tc = threadIdx.x >> 4;
  for (int cbase = 0; cbase < doutp; cbase += 128) {
    const int c0 = cbase + 8 * tc;
    if (c0 >= doutp) break;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < din; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(in + k * kActStride + 4 * tr);
      const float4 b0 = *reinterpret_cast<const float4*>(w + k * doutp + c0);
      const float4 b1 = *reinterpret_cast<const float4*>(w + k * doutp + c0 + 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float bj = bias[c0 + j];
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float t = acc[i][j] + bj;
        if (kHidden) t = t < 0.f ? 0.f : t;
        if (kRoundBf16) t = round_bf16(t);
        v[i] = t;
      }
      *reinterpret_cast<float4*>(out + (c0 + j) * kActStride + 4 * tr) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The f32 layer stack over one tile held in act0. Returns the buffer that
// holds the last layer's output, [pad8(dout)][kActStride] f32.
template <bool kRoundBf16>
__device__ inline float* mlp_stack_f32(const MlpDims& d, const float* s_blob,
                                       float* act0, float* act1) {
  int w_off = 0;
  int b_off = 0;
  for (int l = 0; l < d.n_layers; ++l) w_off += d.dim[l] * pad8(d.dim[l + 1]);
  float* cur = act0;
  float* nxt = act1;
  int wl = 0;
  for (int l = 0; l < d.n_layers; ++l) {
    const int din = d.dim[l];
    const int doutp = pad8(d.dim[l + 1]);
    if (l + 1 < d.n_layers)
      dense_f32<true, kRoundBf16>(cur, din, s_blob + wl, s_blob + w_off + b_off, doutp, nxt);
    else
      dense_f32<false, false>(cur, din, s_blob + wl, s_blob + w_off + b_off, doutp, nxt);
    __syncthreads();
    wl += din * doutp;
    b_off += doutp;
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur;
}

// Copy n 16-byte words from device memory into shared memory.
__device__ inline void copy_words16(void* dst, const void* src, int n) {
  int4* d = reinterpret_cast<int4*>(dst);
  const int4* s = reinterpret_cast<const int4*>(src);
  for (int i = threadIdx.x; i < n; i += kThreads) d[i] = s[i];
}

}  // namespace infera
