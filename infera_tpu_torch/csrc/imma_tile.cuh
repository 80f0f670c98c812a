// The int8 layer stack on the tensor cores (fused_query.cu: K3 and K7b), with
// warp-level mma.sync, and the load of a feature-major int8 table into its
// first A tile.
//
// The TPU kernels' layer is jnp.dot(int8, int8, preferred_element_type=int32)
// followed by an epilogue: here each layer is a run of
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (s8 operands, s32
// accumulators, no .satfinite: int32 wraps as jnp does). s32 sums are exact,
// so the order of the products does not change a bit of the result.
//
// mma_tile.cuh's ldmatrix addressing carries over byte for byte: with k
// counted in bytes, ldmatrix.x4 over an int8 [row][k] tile hands lane l the
// m16n8k32 A fragment (rows l / 4 and l / 4 + 8, bytes 4 (l % 4) .. + 3 of k
// 0-15 and 16-31), and over W^T [n][k] the B fragment; a k32 step is 32
// bytes, as a bf16 k16 step is. Shared-memory operands, k contiguous:
//   A (activations): the 64-row tile as [64][imma_astride(din)] bytes,
//     imma_astride(k) = pad32(k) + 16: zeros from din to pad32(din), and 16
//     more bytes that make a row an odd number of 16-byte words, so the 8 row
//     addresses of an ldmatrix fall on 8 different bank groups;
//   B (weights): W^T as [pad8(dout)][imma_wstride(din)] bytes, zero-padded,
//     imma_wstride(k) = the odd number of 16-byte words that holds k bytes
//     (no padding to 32: where pad16(din) is an odd number of 16-byte words
//     the last k32 step's upper half reads the next row, or the epilogue
//     rows after the last one, and multiplies them by the A tile's zeros).
// Warps and tiles as dense_mma: 8 warps as 2 x 4, two m16 tiles a warp, n8
// tiles dealt round-robin (a 16-class last layer keeps four warps busy), a
// tile past the layer's width clamped to the last one and not multiplied;
// but a warp multiplies kImmaTiles n8 tiles at once (dense_mma: four), and
// takes the next ones in a second pass over its A fragments.
//
// Epilogues (the C fragment gives a lane rows g, g + 8 and columns 2 tg,
// 2 tg + 1, g = lane / 4, tg = lane % 4), per output column from the
// layer's three epilogue rows:
//   K3 hidden:  q = clip(((y << sl) + bias_pre) >> sr, 0, 127), the left
//               shift unsigned (int32 wrap-around like jnp.left_shift), >>
//               arithmetic, sr capped at 31;
//   K7b hidden: q = clip(rint(f32(y) * comb + bq), 0, 127), the multiply
//               and the add rounded apart (__fmul_rn, __fadd_rn: no FMA, as
//               the TPU kernel writes them and the plain version computes
//               them), rounded to an integer half to even as by jnp.rint; f32(y)
//               is exact while |y| <= 127 * 127 * din < 2^24 (the wrapper
//               checks din);
//   last:       h = f32(y) * comb + bias, the same two roundings, into h
//               [pad8(C)][kActStride] f32, the layout the query's tail reads.
// A hidden layer stores a lane's two neighbouring columns as one 16-bit
// word into the next A tile and zeroes that tile's k padding pad8(dout) ..
// pad32(dout).
//
// Blob (ops/fused_query.py `_int8_blob`): W^T of every layer as above, then
// per layer its three epilogue rows as int32 [3][pad8(dout)]: (sl, sr,
// bias_pre) for a K3 hidden layer, (comb, 0, bq) or (comb, 0, bias) as
// float bits otherwise. Every part is a whole number of 16-byte words.
//
// Tiles: layer l reads act0 when n_layers - l is odd and act1 otherwise, and
// the last layer writes h into act1, so the first layer's input (the load's
// target) is act0 for an odd layer count and act1 for an even one; each
// buffer is sized by the A tiles it holds (act1 also by h).
#pragma once

#include "query_tile.cuh"

namespace infera {

__host__ __device__ inline int pad32(int n) { return (n + 31) & ~31; }
__host__ __device__ inline int imma_astride(int k) { return pad32(k) + 16; }
__host__ __device__ inline int imma_wstride(int k) { return 16 * (((k + 15) >> 4) | 1); }

// bytes of the weights (W^T of every layer) before the epilogue rows
__host__ __device__ inline int imma_weight_bytes(const MlpDims& d) {
  int b = 0;
  for (int l = 0; l < d.n_layers; ++l) b += pad8(d.dim[l + 1]) * imma_wstride(d.dim[l]);
  return b;
}

// bytes of act0 (odd = 1) or act1 (odd = 0): the A tiles of the layers
// whose input lies there, and for act1 the last layer's h
__host__ __device__ inline int imma_act_bytes(const MlpDims& d, int odd) {
  int b = odd ? 0 : 4 * pad8(d.dim[d.n_layers]) * kActStride;
  for (int l = 0; l < d.n_layers; ++l) {
    const int a = kTileRows * imma_astride(d.dim[l]);
    if (((d.n_layers - l) & 1) == odd && a > b) b = a;
  }
  return b;
}

// c += a (16 x 32, row) * b (32 x 8, col), s8 operands, s32 accumulators
__device__ inline void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A hidden layer's requantized byte of the s32 sum y, from its column's
// epilogue constants e0, e1, e2: (sl, sr, bias_pre) for K3, (comb, 0, bq)
// as float bits for K7b
template <bool kStatic>
__device__ inline int requant(int y, int e0, int e1, int e2, bool need_sl) {
  if (kStatic) {
    // F2I rounds half to even, turns NaN into 0 and saturates, so with the
    // clip it gives clip(rint(t), 0, 127) (ReLU folds into the clip)
    const float t = __fadd_rn(__fmul_rn(__int2float_rn(y), __int_as_float(e0)),
                              __int_as_float(e2));
    return min(max(__float2int_rn(t), 0), 127);
  }
  if (need_sl) y = (int)((unsigned)y << e0);
  return min(max((y + e2) >> min(e1, 31), 0), 127);
}

// n8 tiles a warp multiplies at once. Each adds 8 accumulator registers:
// at two the kernel fits three blocks an SM (80 registers) without a spill,
// where four spilled (ptxas -v, for the H100).
constexpr int kImmaTiles = 2;

// One layer: in [64][imma_astride(din)] x W^T [pad8(dout)][imma_wstride(din)]^T,
// then the epilogue. Hidden: bytes into the next A tile [64][imma_astride(dout)];
// last (kLast): f32 into h [pad8(dout)][kActStride]. Ends without a barrier.
template <bool kLast, bool kStatic>
__device__ inline void dense_imma(const unsigned char* __restrict__ in, int din,
                                  const unsigned char* __restrict__ w,
                                  const int* __restrict__ epi, int dout, bool need_sl,
                                  unsigned char* __restrict__ out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int wm = warp & 1;
  const int wn = warp >> 1;
  const int sa = imma_astride(din);
  const int sw = imma_wstride(din);
  const int ksteps = pad32(din) >> 5;
  const int doutp = pad8(dout);
  const int nt = doutp >> 3;
  // ldmatrix rows: A lanes 0-15 rows 0-15 at k, lanes 16-31 rows 0-15 at k + 16;
  // B lanes 0-7 / 8-15 tile q at k / k + 16, lanes 16-23 / 24-31 tile q + 1
  const unsigned a_addr = smem_u32(in + (32 * wm + (lane & 15)) * sa + ((lane >> 4) << 4));
  const unsigned a_next = 16 * sa;  // bytes to the warp's second m16 tile
  for (int t0 = wn; t0 < nt; t0 += 4 * kImmaTiles) {
    // tiles t0 + 4 j, j < kImmaTiles; x4 load q takes j = 2 q, 2 q + 1
    unsigned b_addr[kImmaTiles / 2];
#pragma unroll
    for (int q = 0; q < kImmaTiles / 2; ++q) {
      const int tile = min(t0 + 4 * (2 * q + (lane >> 4)), nt - 1);
      b_addr[q] = smem_u32(w + (8 * tile + (lane & 7)) * sw + (((lane >> 3) & 1) << 4));
    }
    bool live[kImmaTiles];
#pragma unroll
    for (int j = 0; j < kImmaTiles; ++j) live[j] = t0 + 4 * j < nt;
    int acc[2][kImmaTiles][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kImmaTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    for (int ks = 0; ks < ksteps; ++ks) {
      unsigned a[2][4], b[kImmaTiles / 2][4];
      ldmatrix_x4(a[0], a_addr + 32 * ks);
      ldmatrix_x4(a[1], a_addr + a_next + 32 * ks);
#pragma unroll
      for (int q = 0; q < kImmaTiles / 2; ++q) ldmatrix_x4(b[q], b_addr[q] + 32 * ks);
#pragma unroll
      for (int j = 0; j < kImmaTiles; ++j) {
        if (!live[j]) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma_s8(acc[i][j], a[i], b[j >> 1][2 * (j & 1)], b[j >> 1][2 * (j & 1) + 1]);
      }
    }
#pragma unroll
    for (int j = 0; j < kImmaTiles; ++j) {
      if (!live[j]) continue;
      const int col = 8 * (t0 + 4 * j) + 2 * tg;
      // the two columns' epilogue rows, one 8-byte load each
      const int2 e0 = *reinterpret_cast<const int2*>(epi + col);
      const int2 e1 = *reinterpret_cast<const int2*>(epi + doutp + col);
      const int2 e2 = *reinterpret_cast<const int2*>(epi + 2 * doutp + col);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 32 * wm + 16 * i + g;
        const int* c = acc[i][j];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int y0 = c[2 * hh];
          const int y1 = c[2 * hh + 1];
          if (kLast) {
            float* h = reinterpret_cast<float*>(out) + row + 8 * hh;
            h[col * kActStride] = __fadd_rn(__fmul_rn(__int2float_rn(y0), __int_as_float(e0.x)),
                                            __int_as_float(e2.x));
            h[(col + 1) * kActStride] =
                __fadd_rn(__fmul_rn(__int2float_rn(y1), __int_as_float(e0.y)),
                          __int_as_float(e2.y));
          } else {
            const int q0 = requant<kStatic>(y0, e0.x, e1.x, e2.x, need_sl);
            const int q1 = requant<kStatic>(y1, e0.y, e1.y, e2.y, need_sl);
            *reinterpret_cast<unsigned short*>(out + (row + 8 * hh) * imma_astride(dout) + col) =
                (unsigned short)__byte_perm(q0, q1, 0x0040);
          }
        }
      }
    }
  }
  if (!kLast) {
    // the next layer's k padding, in 8-byte words
    const int z = (pad32(dout) - doutp) >> 3;
    const int so = imma_astride(dout);
    for (int i = threadIdx.x; i < kTileRows * z; i += kThreads) {
      const int r = i / z;
      *reinterpret_cast<uint2*>(out + r * so + doutp + 8 * (i - r * z)) = make_uint2(0u, 0u);
    }
  }
}

// The int8 layer stack over the tile the load wrote (n_layers >= 1). Bit l of
// need_sl_mask: K3's hidden layer l applies its left shifts. Returns h, the
// last layer's f32 scores [pad8(C)][kActStride] (act1).
template <bool kStatic>
__device__ inline const float* mlp_stack_int8(const MlpDims& d, const unsigned char* s_blob,
                                              unsigned char* act0, unsigned char* act1,
                                              int need_sl_mask) {
  const unsigned char* w = s_blob;
  const int* epi = reinterpret_cast<const int*>(s_blob + imma_weight_bytes(d));
  unsigned char* cur = (d.n_layers & 1) ? act0 : act1;
  unsigned char* nxt = cur == act0 ? act1 : act0;
  for (int l = 0; l < d.n_layers; ++l) {
    const int din = d.dim[l];
    const int dout = d.dim[l + 1];
    if (l + 1 < d.n_layers)
      dense_imma<false, kStatic>(cur, din, w, epi, dout, (need_sl_mask >> l) & 1, nxt);
    else
      dense_imma<true, kStatic>(cur, din, w, epi, dout, false, nxt);
    __syncthreads();
    w += pad8(dout) * imma_wstride(din);
    epi += 3 * pad8(dout);
    unsigned char* t = cur;
    cur = nxt;
    nxt = t;
  }
  return reinterpret_cast<const float*>(cur);
}

// K3's and K7b's load of a feature-major int8 table x [d0, n]: rows row0 ..
// row0 + 63 into the A tile a [64][imma_astride(d0)], features d0 ..
// pad32(d0) and rows past n zero.
//
// A block walks its tiles j = 0, 1, ... (tile blockIdx.x + j * gridDim.x)
// with a ring of `stages` staging buffers in shared memory, as K7a's ring
// (query_tile.cuh): before it transposes tile j it has issued the copies of
// tiles j + 1 .. j + stages - 1, so their bytes are in flight while tile j
// is transposed and computed. A buffer holds, for each feature f, the
// kStageWords aligned 4-byte words that cover bytes f n + row0 .. + 63 of
// the table (f n + row0 is unaligned where n is odd), copied with
// cp.async, one commit group a tile. A thread then takes 4 rows and 4
// features: it funnel-shifts each feature's two words around its 4 bytes
// into place, transposes the 4 x 4 byte block in registers (__byte_perm)
// and writes each row's 4 features as one word. The transposition reads
// words other threads copied, so a barrier follows the wait. A warp takes 8
// feature groups of 4 rows each: with a buffer's rows 17 words apart its
// reads fall on 32 banks, and its writes on 16 (two lanes a bank, rows 4
// apart lying a half bank row from each other). A tile whose words
// could reach past its feature's row (within 4 bytes of n), a table whose
// base is not 4-byte aligned, and every tile where no buffer fits (stages =
// 0) take the byte path: a thread packs 4 features of one row into a word,
// read straight from device memory.
constexpr int kStageWords = 17;

__host__ __device__ inline int int8_stage_bytes(int d0) {
  return (4 * kStageWords * d0 + 15) & ~15;
}

struct ColRing {
  const int8_t* x;
  long long n;
  int d0;
  int stages;          // buffers; 0: every tile takes the byte path
  unsigned char* buf;  // [stages][int8_stage_bytes(d0)]
  long long n_tiles;
};

__device__ inline void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Does tile go through the ring? (uniform across the block)
__device__ inline bool col_ring_tile(const ColRing g, long long tile) {
  return g.stages > 0 && tile < g.n_tiles && tile * kTileRows + kTileRows + 4 <= g.n &&
         (reinterpret_cast<unsigned long long>(g.x) & 3) == 0;
}

// Issue this thread's copies of this block's tile j into its buffer and
// commit them as one group (an empty group where the tile takes the byte
// path).
__device__ inline void col_ring_issue(const ColRing g, int j) {
  const long long tile = blockIdx.x + (long long)j * gridDim.x;
  if (col_ring_tile(g, tile)) {
    unsigned* dst = reinterpret_cast<unsigned*>(g.buf + (j % g.stages) * int8_stage_bytes(g.d0));
    const unsigned* xw = reinterpret_cast<const unsigned*>(g.x);
    const long long row0 = tile * kTileRows;
    for (int c = threadIdx.x; c < kStageWords * g.d0; c += kThreads) {
      const int f = c / kStageWords;
      cp_async4(dst + c, xw + (((long long)f * g.n + row0) >> 2) + (c - kStageWords * f));
    }
  }
  cp_async_commit();
}

// Before the loop over tiles: issue tiles 0 .. stages - 2.
__device__ inline void col_ring_start(const ColRing g) {
  for (int j = 0; j + 1 < g.stages; ++j) col_ring_issue(g, j);
}

// 4 words of 4 bytes, word j = bytes (j, 0..3), transposed in place: word i
// becomes bytes (0..3, i)
__device__ inline void transpose4x4(unsigned (&v)[4]) {
  const unsigned t0 = __byte_perm(v[0], v[1], 0x5140);
  const unsigned t1 = __byte_perm(v[2], v[3], 0x5140);
  const unsigned t2 = __byte_perm(v[0], v[1], 0x7362);
  const unsigned t3 = __byte_perm(v[2], v[3], 0x7362);
  v[0] = __byte_perm(t0, t1, 0x5410);
  v[1] = __byte_perm(t0, t1, 0x7632);
  v[2] = __byte_perm(t2, t3, 0x5410);
  v[3] = __byte_perm(t2, t3, 0x7632);
}

// Tile j of this block (row0 = its first row) into the A tile a: the ring's
// next copies, the wait for this tile's and a barrier, then the
// transposition; or the byte path. Ends without a barrier.
__device__ inline void load_cols_tile_int8(const ColRing g, int j, long long row0,
                                           unsigned char* __restrict__ a) {
  const long long tile = blockIdx.x + (long long)j * gridDim.x;
  if (g.stages > 0) {
    col_ring_issue(g, j + g.stages - 1);
    cp_async_wait(g.stages - 1);
  }
  const int d0 = g.d0;
  const int sa = imma_astride(d0);
  const int k32 = pad32(d0);
  if (col_ring_tile(g, tile)) {
    __syncthreads();  // every thread's copies of this tile have landed
    const unsigned* st =
        reinterpret_cast<const unsigned*>(g.buf + (j % g.stages) * int8_stage_bytes(d0));
    const int n4 = (int)(g.n & 3);  // feature f's bytes start f * n4 mod 4 bytes into a word
    for (int i = threadIdx.x; i < 16 * (k32 >> 2); i += kThreads) {
      const int fg = (i & 7) + 8 * (i >> 7);  // features 4 fg .. 4 fg + 3
      const int rq = (i >> 3) & 15;           // rows 4 rq .. 4 rq + 3
      unsigned v[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int f = 4 * fg + jj;
        v[jj] = 0u;
        if (f < d0) {
          const unsigned* w = st + kStageWords * f + rq;
          v[jj] = __funnelshift_r(w[0], w[1], 8 * ((f * n4) & 3));
        }
      }
      transpose4x4(v);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<unsigned*>(a + (4 * rq + r) * sa + 4 * fg) = v[r];
    }
    return;
  }
  for (int i = threadIdx.x; i < kTileRows * (k32 >> 2); i += kThreads) {
    const int r = i & (kTileRows - 1);
    const int k4 = i >> 6;
    const long long row = row0 + r;
    unsigned word = 0u;
    if (row < g.n) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int f = 4 * k4 + b;
        if (f < d0) word |= (unsigned)(uint8_t)g.x[(long long)f * g.n + row] << (8 * b);
      }
    }
    *reinterpret_cast<unsigned*>(a + r * sa + 4 * k4) = word;
  }
}

}  // namespace infera
