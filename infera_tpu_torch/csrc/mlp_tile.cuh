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
// K6, K1 and K7a in f32 run the stack of mlp_stack_ffma below instead
// (K2' keeps mlp_stack_f32). Two changes, neither of which touches how an
// output is summed (from 0, one fmaf per input in input order, then the
// bias), so their results are mlp_stack_f32's bit for bit:
//   - every warp works on every layer: a layer's 128-column passes keep the
//     4 x 8 tile, and its narrow rest (the 16 classes of the bench MLP)
//     takes a 4 x 2 tile dealt over the group's warps, where the 4 x 8 tile
//     left that layer to one warp of eight;
//   - two tiles in flight on each SM: a block of 2 x kThreads threads holds
//     one copy of the weights and two halves (Half), each with its own
//     activation tiles, its own tiles of the table and its own named
//     barrier, so one half's load, barriers and tail run beside the other
//     half's FMAs.
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

// ---------------------------------------------------------------- the f32 stack of K6, K1, K7a

// The threads that run one tile: a whole block of kThreads threads (Block:
// every kernel but K6, K1 and K7a in f32), or one half of a block of
// halves x kThreads threads (Half). A group's tiles are index(), then steps
// of step(); index() is also its row of a kernel's partials.
struct Block {
  __device__ int tid() const { return threadIdx.x; }
  __device__ long long index() const { return blockIdx.x; }
  __device__ long long step() const { return gridDim.x; }
  __device__ void sync() const { __syncthreads(); }
};

// Tile groups a block of the f32 kernels holds at most.
constexpr int kMaxHalves = 2;

// Half h of a block of `halves` halves: warps 8h .. 8h + 7. Half h of block
// b takes tiles halves * b + h, then steps of halves * gridDim.x, and
// synchronises only its own warps, on named barrier 1 + h (barrier 0 is
// __syncthreads'). With one half it is the whole block.
struct Half {
  int h;
  int halves;
  __device__ int tid() const { return threadIdx.x & (kThreads - 1); }
  __device__ long long index() const { return (long long)halves * blockIdx.x + h; }
  __device__ long long step() const { return (long long)halves * gridDim.x; }
  __device__ void sync() const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + h), "r"(kThreads) : "memory");
  }
};

__device__ inline Half this_half() {
  return Half{(int)(threadIdx.x / kThreads), (int)(blockDim.x / kThreads)};
}

// Register tiles of mlp_stack_ffma: kRows x kCols outputs a thread, kLanes
// lanes of a warp along the rows (32 / kLanes along the columns). A layer's
// 128-column passes take the wide tile, its rest of fewer than 128 columns
// the narrow one, or the thin one when the rest is one 8-column group.
// At the bench MLP's 16 classes the narrow tile gives 128 threads work, one
// warp of four on each scheduler, and a warp's step of the reduction reads
// one 128-byte run of activations and 32 bytes of weights for 8 FMAs a
// thread: a 2 x 2 tile on all eight warps would read twice the wavefronts
// for the same FMAs.
constexpr int kWideRows = 4;
constexpr int kWideCols = 8;
constexpr int kWideLanes = 16;
constexpr int kNarrowRows = 4;
constexpr int kNarrowCols = 2;
constexpr int kNarrowLanes = 8;
constexpr int kThinRows = 2;
constexpr int kThinCols = 2;
constexpr int kThinLanes = 16;
constexpr int kPassCols = 128;

template <int N>
__device__ inline void load_vec(const float* p, float (&v)[N]) {
  static_assert(N == 2 || N == 4 || N == 8, "2, 4 or 8 floats");
  if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  } else {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + q);
      v[q] = a.x;
      v[q + 1] = a.y;
      v[q + 2] = a.z;
      v[q + 3] = a.w;
    }
  }
}

template <int N>
__device__ inline void store_vec(float* p, const float (&v)[N]) {
  static_assert(N == 2 || N == 4, "2 or 4 floats");
  if constexpr (N == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Columns c_begin .. c_end - 1 of a layer (out[c][r] = act(sum_k in[k][r] *
// w[k][c] + bias[c]) for every row of the tile), dealt to the kThreads
// threads of a group in units of an RM x CN register tile. Unit u goes to
// thread u mod kThreads: lane u & 31 of warp slot u >> 5, whose warp covers
// RL * RM rows and (32 / RL) * CN columns, the tile's row spans first. Each
// output is summed as dense_f32 sums it: from 0, one fmaf per input in input
// order, then the bias, then ReLU.
template <bool kHidden, int RM, int CN, int RL>
__device__ inline void dense_units(const float* __restrict__ in, int din,
                                   const float* __restrict__ w, const float* __restrict__ bias,
                                   int doutp, int c_begin, int c_end, float* __restrict__ out,
                                   int tid) {
  constexpr int kRowWarps = kTileRows / (RL * RM);  // warp slots along the tile's rows
  constexpr int kColLanes = 32 / RL;
  static_assert(kRowWarps * RL * RM == kTileRows && kColLanes * RL == 32, "tile shape");
  const int units = (kTileRows / RM) * ((c_end - c_begin) / CN);
  for (int u = tid; u < units; u += kThreads) {
    const int lane = u & 31;
    const int slot = u >> 5;
    const int r = RM * ((slot % kRowWarps) * RL + lane % RL);
    const int c = c_begin + CN * ((slot / kRowWarps) * kColLanes + lane / RL);
    float acc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < din; ++k) {
      float av[RM];
      float bv[CN];
      load_vec(in + k * kActStride + r, av);
      load_vec(w + k * doutp + c, bv);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const float bj = bias[c + j];
      float v[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        float t = acc[i][j] + bj;
        if (kHidden) t = t < 0.f ? 0.f : t;
        v[i] = t;
      }
      store_vec(out + (c + j) * kActStride + r, v);
    }
  }
}

// One layer over every warp of the group: the 128-column passes with the
// wide tile, then the rest with the narrow (or thin) one.
template <bool kHidden>
__device__ inline void dense_ffma(const float* __restrict__ in, int din,
                                  const float* __restrict__ w, const float* __restrict__ bias,
                                  int doutp, float* __restrict__ out, int tid) {
  const int wide = doutp / kPassCols * kPassCols;
  if (wide > 0)
    dense_units<kHidden, kWideRows, kWideCols, kWideLanes>(in, din, w, bias, doutp, 0, wide, out,
                                                           tid);
  if (doutp - wide >= 16)  // the rest: 16 columns or more, else one 8-column group
    dense_units<kHidden, kNarrowRows, kNarrowCols, kNarrowLanes>(in, din, w, bias, doutp, wide,
                                                                 doutp, out, tid);
  else if (doutp > wide)
    dense_units<kHidden, kThinRows, kThinCols, kThinLanes>(in, din, w, bias, doutp, wide, doutp,
                                                           out, tid);
}

// mlp_stack_f32 for K6, K1 and K7a in f32: the same layers and the same
// bits, every warp of the group on every layer, and the group's own barrier
// after each layer.
template <typename G>
__device__ inline float* mlp_stack_ffma(const MlpDims& d, const float* s_blob, float* act0,
                                        float* act1, const G& g) {
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
      dense_ffma<true>(cur, din, s_blob + wl, s_blob + w_off + b_off, doutp, nxt, g.tid());
    else
      dense_ffma<false>(cur, din, s_blob + wl, s_blob + w_off + b_off, doutp, nxt, g.tid());
    g.sync();
    wl += din * doutp;
    b_off += doutp;
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur;
}

// Copy n 16-byte words from device memory into shared memory, thread tid of
// `threads`.
__device__ inline void copy_words16(void* dst, const void* src, int n, int tid, int threads) {
  int4* d = reinterpret_cast<int4*>(dst);
  const int4* s = reinterpret_cast<const int4*>(src);
  for (int i = tid; i < n; i += threads) d[i] = s[i];
}

// ... by the kThreads threads of a block.
__device__ inline void copy_words16(void* dst, const void* src, int n) {
  copy_words16(dst, src, n, threadIdx.x, kThreads);
}

}  // namespace infera
