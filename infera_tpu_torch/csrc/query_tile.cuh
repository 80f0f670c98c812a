// Shared pieces of the fused query kernels (fused_query.cu: K1, K7a, K3, K7b;
// profile_query.cu: K8a, K8b): K7a's load of a row-major tile, K1's load of
// a feature-major tile into the tensor cores' A layout, and the query's tail
// (argmax, the score0 > 0 filter, per-class count and sum per block).
#pragma once

#include "mma_tile.cuh"

namespace infera {

// K7a's load of a row-major table x [n, d0] (K8a and K8b run the same code).
//
// The 64 rows of a tile are one contiguous run of 64 * d0 elements. A block
// walks its tiles j = 0, 1, ... (tile blockIdx.x + j * gridDim.x) with a ring
// of `stages` buffers in shared memory: before it unpacks tile j it has
// issued the copies of tiles j + 1 .. j + stages - 1, so their bytes are in
// flight while tile j is unpacked and computed. The tile's 16-byte words
// are dealt to the threads by row first (word w of row r to item 64 w + r);
// a thread copies its words with cp.async.cg, one commit group a tile, waits
// for its own words of tile j with cp.async.wait_group and unpacks them
// itself. f32 mode (load_rows_tile) transposes a word's 4 f32 values into 4
// rows of the feature-major activation tile act [d0][kActStride]. bf16 mode
// (load_rows_tile_bf16) writes the tensor cores' A tile [64][mma_stride(d0)]
// (mma_tile.cuh): a bf16 word (8 features of a row) is one 16-byte copy, an
// f32 word two bf16x2 words rounded to nearest even, and the k padding
// d0 .. pad16(d0) is zero. No thread reads another's words, so neither the
// wait nor the refill of a buffer needs a barrier; the caller's barrier after
// the load is the tile's only one. A buffer keeps each row at a stride of an
// odd number of 16-byte words, and 32 threads take 32 neighbouring rows of
// one word, so the copies' writes and the unpacking's reads (and a bf16
// tile's writes, whose rows are an odd number of words too) are free of bank
// conflicts. A table whose base is not 16-byte aligned, a row of d0 elements
// that is not a multiple of 16 bytes (stages = 0), and the ragged last tile
// take a scalar path in the same loop: each value read from device memory
// straight into the tile. Rows past n are zero. The load is a copy, so its
// values are the scalar path's bit for bit.

// Bytes of a ring buffer's row: d0 elements of `elem` bytes padded to an odd
// number of 16-byte words.
__host__ __device__ inline int ring_stride(int d0, int elem) {
  return 16 * (((d0 * elem + 15) / 16) | 1);
}

template <typename TIn>
struct RowRing {
  const TIn* x;
  long long n;
  int d0;
  int stages;          // buffers; 0: every tile takes the scalar path
  unsigned char* buf;  // [stages][kTileRows][ring_stride(d0)]
  long long n_tiles;
};

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most `pending` of this thread's newest groups are in flight
__device__ inline void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// Does tile j of this block go through the ring? (uniform across the block)
template <typename TIn>
__device__ inline bool ring_tile(const RowRing<TIn> g, long long tile) {
  return g.stages > 0 && tile < g.n_tiles && (tile + 1) * kTileRows <= g.n &&
         (g.d0 * (int)sizeof(TIn)) % 16 == 0 &&
         (reinterpret_cast<unsigned long long>(g.x) & 15) == 0;
}

// Issue this thread's copies of its group's tile j (a whole block's, or a
// half's: mlp_tile.cuh) into its buffer and commit them as one group (an
// empty group where the tile takes the scalar path).
template <typename TIn, typename G = Block>
__device__ inline void ring_issue(const RowRing<TIn> g, int j, const G& grp = G()) {
  const long long tile = grp.index() + (long long)j * grp.step();
  if (ring_tile(g, tile)) {
    const int words = g.d0 * (int)sizeof(TIn) / 16;  // 16-byte words of a row
    const int stride = ring_stride(g.d0, (int)sizeof(TIn));
    unsigned char* dst = g.buf + (j % g.stages) * kTileRows * stride;
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(g.x + tile * kTileRows * g.d0);
    for (int i = grp.tid(); i < kTileRows * words; i += kThreads) {
      const int r = i & (kTileRows - 1);
      const int w = i / kTileRows;
      cp_async16(dst + r * stride + 16 * w, src + r * (16 * words) + 16 * w);
    }
  }
  cp_async_commit();
}

// Before the loop over tiles: issue tiles 0 .. stages - 2.
template <typename TIn, typename G = Block>
__device__ inline void ring_start(const RowRing<TIn> g, const G& grp = G()) {
  for (int j = 0; j + 1 < g.stages; ++j) ring_issue(g, j, grp);
}

__device__ inline void put4(float* act, int k, int r, float4 v) {
  act[k * kActStride + r] = v.x;
  act[(k + 1) * kActStride + r] = v.y;
  act[(k + 2) * kActStride + r] = v.z;
  act[(k + 3) * kActStride + r] = v.w;
}

__device__ inline void transpose_word(const float* p, float* act, int k, int r) {
  put4(act, k, r, *reinterpret_cast<const float4*>(p));
}

// the f32 of the first and of the second bf16 of a word: a bf16 is the high
// half of its f32
__device__ inline float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ inline float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

__device__ inline void transpose_word(const __nv_bfloat16* p, float* act, int k, int r) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  put4(act, k, r, make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y)));
  put4(act, k + 4, r, make_float4(bf16_lo(u.z), bf16_hi(u.z), bf16_lo(u.w), bf16_hi(u.w)));
}

// a ring word into the A tile at its (row, k): 8 bf16 as they are, 4 f32
// rounded to bf16
__device__ inline void put_word_bf16(const __nv_bfloat16* p, __nv_bfloat16* a) {
  *reinterpret_cast<uint4*>(a) = *reinterpret_cast<const uint4*>(p);
}

__device__ inline void put_word_bf16(const float* p, __nv_bfloat16* a) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  *reinterpret_cast<uint2*>(a) = make_uint2(bf16x2_bits(v.x, v.y), bf16x2_bits(v.z, v.w));
}

// Start the copies of tile j + stages - 1 into the buffer tile j - 1 left
// (this thread's own words, read in the last call) and wait for this
// thread's words of tile j.
template <typename TIn, typename G = Block>
__device__ inline void ring_advance(const RowRing<TIn> g, int j, const G& grp = G()) {
  if (g.stages > 0) {
    ring_issue(g, j + g.stages - 1, grp);
    cp_async_wait(g.stages - 1);
  }
}

// Tile j of this thread's group (row0 = its first row) into the f32 tile
// act [d0][kActStride]: ring_advance, then transpose this thread's words.
// Ends without a barrier.
template <typename TIn, typename G = Block>
__device__ inline void load_rows_tile(const RowRing<TIn> g, int j, long long row0,
                                      float* __restrict__ act, const G& grp = G()) {
  const long long tile = grp.index() + (long long)j * grp.step();
  ring_advance(g, j, grp);
  const int d0 = g.d0;
  if (ring_tile(g, tile)) {
    constexpr int kPer = 16 / (int)sizeof(TIn);  // values of a 16-byte word
    const int words = d0 / kPer;
    const int stride = ring_stride(d0, (int)sizeof(TIn));
    const unsigned char* b = g.buf + (j % g.stages) * kTileRows * stride;
    for (int i = grp.tid(); i < kTileRows * words; i += kThreads) {
      const int r = i & (kTileRows - 1);
      const int w = i / kTileRows;
      transpose_word(reinterpret_cast<const TIn*>(b + r * stride + 16 * w), act, kPer * w, r);
    }
    return;
  }
  const int rows = (int)min((long long)kTileRows, g.n - row0);
  const TIn* src = g.x + row0 * d0;
  for (int i = grp.tid(); i < kTileRows * d0; i += kThreads) {
    const int k = i / kTileRows;
    const int r = i - k * kTileRows;
    act[k * kActStride + r] = r < rows ? load_f32(src + (long long)r * d0 + k) : 0.f;
  }
}

// Tile j of this block into the bf16 A tile a [64][mma_stride(d0)]:
// ring_advance, then copy this thread's words; zeros past d0 and past n.
// Ends without a barrier.
template <typename TIn>
__device__ inline void load_rows_tile_bf16(const RowRing<TIn> g, int j, long long row0,
                                           __nv_bfloat16* __restrict__ a) {
  const long long tile = blockIdx.x + (long long)j * gridDim.x;
  ring_advance(g, j);
  const int d0 = g.d0;
  const int kp = pad16(d0);
  const int sa = mma_stride(d0);
  if (ring_tile(g, tile)) {
    constexpr int kPer = 16 / (int)sizeof(TIn);
    const int words = d0 / kPer;
    const int stride = ring_stride(d0, (int)sizeof(TIn));
    const unsigned char* b = g.buf + (j % g.stages) * kTileRows * stride;
    for (int i = threadIdx.x; i < kTileRows * words; i += kThreads) {
      const int r = i & (kTileRows - 1);
      const int w = i / kTileRows;
      put_word_bf16(reinterpret_cast<const TIn*>(b + r * stride + 16 * w), a + r * sa + kPer * w);
    }
    // the k padding: d0 is a multiple of 4 here, so whole bf16x2 words
    const int pairs = (kp - d0) >> 1;
    for (int i = threadIdx.x; i < kTileRows * pairs; i += kThreads) {
      const int r = i / pairs;
      *reinterpret_cast<unsigned*>(a + r * sa + d0 + 2 * (i - r * pairs)) = 0u;
    }
    return;
  }
  const int rows = (int)min((long long)kTileRows, g.n - row0);
  const TIn* src = g.x + row0 * d0;
  for (int i = threadIdx.x; i < kTileRows * kp; i += kThreads) {
    const int r = i / kp;
    const int k = i - r * kp;
    const float v = r < rows && k < d0 ? load_f32(src + (long long)r * d0 + k) : 0.f;
    a[r * sa + k] = __float2bfloat16_rn(v);
  }
}

// K1's load: rows row0 .. row0 + 63 of the feature-major table x [d0, n]
// into the A tile a [64][mma_stride(d0)]. A thread takes 8 features of a row
// (8 loads, each from 32 neighbouring rows across the warp) and writes them as
// one 16-byte word; zeros past d0 and past n. Ends without a barrier.
template <typename TIn>
__device__ inline void load_cols_tile_bf16(const TIn* __restrict__ x, long long n, int d0,
                                           long long row0, __nv_bfloat16* __restrict__ a) {
  const int groups = pad16(d0) >> 3;
  const int sa = mma_stride(d0);
  for (int i = threadIdx.x; i < kTileRows * groups; i += kThreads) {
    const int r = i & (kTileRows - 1);
    const int k0 = 8 * (i / kTileRows);
    const long long row = row0 + r;
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = row < n && k0 + u < d0 ? load_f32(x + (long long)(k0 + u) * n + row) : 0.f;
    *reinterpret_cast<uint4*>(a + r * sa + k0) =
        make_uint4(bf16x2_bits(v[0], v[1]), bf16x2_bits(v[2], v[3]), bf16x2_bits(v[4], v[5]),
                   bf16x2_bits(v[6], v[7]));
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

template <typename G = Block>
__device__ inline void tail_init(TailScratch t, int C, const G& grp = G()) {
  for (int c = grp.tid(); c < C; c += kThreads) {
    t.blk_cnt[c] = 0;
    t.blk_sum[c] = 0.0;
  }
}

// h: [C][kActStride] f32 scores of one tile. Ends with the group's barrier.
template <typename G = Block>
__device__ inline void tail_tile(TailScratch t, const float* h, int C, long long row0,
                                 long long n, const G& grp = G()) {
  if (grp.tid() < kTileRows) {
    const int r = grp.tid();
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
  grp.sync();
  for (int c = grp.tid(); c < C; c += kThreads) {
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
  grp.sync();
}

// the group's counts and sums into its row index() of the partials
template <typename G = Block>
__device__ inline void tail_store(TailScratch t, int C, long long* part_cnt, double* part_sum,
                                  const G& grp = G()) {
  for (int c = grp.tid(); c < C; c += kThreads) {
    part_cnt[grp.index() * C + c] = t.blk_cnt[c];
    part_sum[grp.index() * C + c] = t.blk_sum[c];
  }
}

}  // namespace infera
