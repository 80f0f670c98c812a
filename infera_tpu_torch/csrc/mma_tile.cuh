// The bf16 layer stack on the tensor cores (fused_query.cu: K1 and K7a in bf16
// mode; profile_query.cu: K8b), with warp-level mma.sync.
//
// The TPU kernel's layer is jnp.dot(bf16, bf16, preferred_element_type=f32),
// then bias, ReLU and a cast to bf16: here each layer is a run of
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (bf16 operands, f32
// accumulators in registers), then the same epilogue in f32.
//
// Shared-memory operands, all bf16 with k contiguous:
//   A (activations): the 64-row tile as [64][mma_stride(din)];
//   B (weights):     W^T as [pad8(dout)][mma_stride(din)] (the .col operand).
// mma_stride(k) = pad16(k) + 8: k is padded to 16 with zeros, and the 8 extra
// values (16 bytes) make a row an odd number of 16-byte words, so the 8 row
// addresses of an ldmatrix fall on 8 different 16-byte bank groups.
//
// Warps: 8 warps as 2 x 4. Warp w takes rows 32 (w & 1) .. + 31 (two m16
// tiles) and, of each pass of 16 n8 tiles (128 output columns), the tiles
// (w >> 1) + {0, 4, 8, 12}. A k16 step is then 2 ldmatrix.x4 for A (one an
// m16 tile), 2 for B (two n8 tiles each) and 8 mma: 0.5 ldmatrix an mma, the
// fewest of the 8-warp splits (1 x 8 and 4 x 2 need 5 for 8). The n tiles are
// dealt round-robin, so a narrow last layer (16 classes: 2 tiles) still keeps
// four warps busy; a tile past the layer's width is not multiplied, and its
// ldmatrix reads the last tile's rows instead of memory past the weights.
//
// Epilogues: a hidden layer adds the bias in f32, applies ReLU (NaN passes
// through, as jnp.maximum does), rounds to bf16 and stores each lane's two
// neighbouring columns (C fragment columns 2 (lane % 4) + {0, 1}) as one
// bf16x2 word into the next A tile; it zeroes that tile's columns
// pad8(dout) .. pad16(dout), the k padding of the next layer. The last layer
// writes f32 scores + bias into h [pad8(C)][kActStride], the layout the
// query's tail reads.
//
// Weight blob (built by ops/fused_query.py `pack_mma_blob`): per layer W^T as
// above, then per layer the biases as f32 [pad8(dout)]; every part a whole
// number of 16-byte words.
//
// Tiles: act0 holds an A tile at the widest layer input; act1 holds an A
// tile or the last layer's h, whichever is larger. Layers alternate between
// them and the last one writes act1, so the first layer's input (the load's
// target, `mma_input`) is act0 for an odd layer count and act1 for an even
// one; h lies over a dead A tile.
#pragma once

#include "mlp_tile.cuh"

namespace infera {

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }
__host__ __device__ inline int mma_stride(int k) { return pad16(k) + 8; }

// bytes of the weights (W^T of every layer) before the biases
__host__ __device__ inline int mma_weight_bytes(const MlpDims& d) {
  int b = 0;
  for (int l = 0; l < d.n_layers; ++l) b += 2 * pad8(d.dim[l + 1]) * mma_stride(d.dim[l]);
  return b;
}

// bytes of an A tile at the widest layer input (dim[0] with no layer)
__host__ __device__ inline int mma_tile_bytes(const MlpDims& d) {
  int k = d.dim[0];
  for (int l = 1; l < d.n_layers; ++l) k = k > d.dim[l] ? k : d.dim[l];
  return 2 * kTileRows * mma_stride(k);
}

// bytes of act1: an A tile or h [pad8(C)][kActStride] f32
__host__ __device__ inline int mma_out_bytes(const MlpDims& d) {
  const int h = 4 * pad8(d.dim[d.n_layers]) * kActStride;
  const int a = mma_tile_bytes(d);
  return a > h ? a : h;
}

// the first layer's input tile: the last layer writes act1
__device__ inline __nv_bfloat16* mma_input(const MlpDims& d, unsigned char* act0,
                                           unsigned char* act1) {
  return reinterpret_cast<__nv_bfloat16*>((d.n_layers & 1) ? act0 : act1);
}

__device__ inline unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ inline void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 operands, f32 accumulators
__device__ inline void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                unsigned b1) {
  // not volatile: a function of its registers, which ptxas may schedule
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline unsigned bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ inline float relu_nan(float t) { return t < 0.f ? 0.f : t; }

// One layer: out = act(in [64][mma_stride(din)] x W^T [pad8(dout)][..]^T + bias).
// Hidden: bf16 into the next A tile [64][mma_stride(dout)]; last (kLast): f32
// into h [pad8(dout)][kActStride]. Ends without a barrier.
template <bool kLast>
__device__ inline void dense_mma(const __nv_bfloat16* __restrict__ in, int din,
                                 const __nv_bfloat16* __restrict__ w,
                                 const float* __restrict__ bias, int dout, void* __restrict__ out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row (A, C) or column (B)
  const int tg = lane & 3;   // fragment column pair
  const int wm = warp & 1;
  const int wn = warp >> 1;
  const int sa = mma_stride(din);
  const int ksteps = pad16(din) >> 4;
  const int nt = pad8(dout) >> 3;
  // ldmatrix rows: A lanes 0-15 rows 0-15 at k, lanes 16-31 rows 0-15 at k + 8;
  // B lanes 0-7 / 8-15 tile q at k / k + 8, lanes 16-23 / 24-31 tile q + 1
  const unsigned a_addr = smem_u32(in + (32 * wm + (lane & 15)) * sa + ((lane >> 4) << 3));
  const unsigned a_next = 16 * sa * 2;  // bytes to the warp's second m16 tile
  for (int t0 = wn; t0 < nt; t0 += 16) {
    // tiles t0 + 4 j, j = 0..3; x4 loads j = 0, 1 (q = 0) and j = 2, 3 (q = 1)
    unsigned b_addr[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int tile = min(t0 + 4 * (2 * q + (lane >> 4)), nt - 1);
      b_addr[q] = smem_u32(w + (8 * tile + (lane & 7)) * sa + (((lane >> 3) & 1) << 3));
    }
    bool live[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) live[j] = t0 + 4 * j < nt;
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll 2
    for (int ks = 0; ks < ksteps; ++ks) {
      unsigned a[2][4], b[2][4];
      ldmatrix_x4(a[0], a_addr + 32 * ks);
      ldmatrix_x4(a[1], a_addr + a_next + 32 * ks);
      ldmatrix_x4(b[0], b_addr[0] + 32 * ks);
      ldmatrix_x4(b[1], b_addr[1] + 32 * ks);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!live[j]) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma_bf16(acc[i][j], a[i], b[j >> 1][2 * (j & 1)], b[j >> 1][2 * (j & 1) + 1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!live[j]) continue;
      const int col = 8 * (t0 + 4 * j) + 2 * tg;
      const float b0 = bias[col];
      const float b1 = bias[col + 1];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 32 * wm + 16 * i + g;
        const float* c = acc[i][j];
        if (kLast) {
          float* h = reinterpret_cast<float*>(out);
          h[col * kActStride + row] = c[0] + b0;
          h[(col + 1) * kActStride + row] = c[1] + b1;
          h[col * kActStride + row + 8] = c[2] + b0;
          h[(col + 1) * kActStride + row + 8] = c[3] + b1;
        } else {
          __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out);
          const int so = mma_stride(dout);
          *reinterpret_cast<unsigned*>(o + row * so + col) =
              bf16x2_bits(relu_nan(c[0] + b0), relu_nan(c[1] + b1));
          *reinterpret_cast<unsigned*>(o + (row + 8) * so + col) =
              bf16x2_bits(relu_nan(c[2] + b0), relu_nan(c[3] + b1));
        }
      }
    }
  }
  if (!kLast && pad8(dout) != pad16(dout) && threadIdx.x < kTileRows) {
    __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out);
    *reinterpret_cast<uint4*>(o + threadIdx.x * mma_stride(dout) + pad8(dout)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// The bf16 layer stack over the tile in mma_input(d, act0, act1) (n_layers
// >= 1). Returns h, the last layer's f32 scores [pad8(C)][kActStride] (act1).
__device__ inline const float* mlp_stack_bf16(const MlpDims& d, const unsigned char* s_blob,
                                              unsigned char* act0, unsigned char* act1) {
  const __nv_bfloat16* w = reinterpret_cast<const __nv_bfloat16*>(s_blob);
  const float* bias = reinterpret_cast<const float*>(s_blob + mma_weight_bytes(d));
  unsigned char* cur = reinterpret_cast<unsigned char*>(mma_input(d, act0, act1));
  unsigned char* nxt = cur == act0 ? act1 : act0;
  for (int l = 0; l < d.n_layers; ++l) {
    const int din = d.dim[l];
    const int dout = d.dim[l + 1];
    const __nv_bfloat16* a = reinterpret_cast<const __nv_bfloat16*>(cur);
    if (l + 1 < d.n_layers)
      dense_mma<false>(a, din, w, bias, dout, nxt);
    else
      dense_mma<true>(a, din, w, bias, dout, nxt);
    __syncthreads();
    w += pad8(dout) * mma_stride(din);
    bias += pad8(dout);
    unsigned char* t = cur;
    cur = nxt;
    nxt = t;
  }
  return reinterpret_cast<const float*>(cur);
}

}  // namespace infera
