// Shared pieces of the fused query kernels (fused_query.cu: K1, K7a, K3, K7b;
// profile_query.cu: K8a, K8b): K7a's load of a row-major tile and the query's
// tail (argmax, the score0 > 0 filter, per-class count and sum per block).
#pragma once

#include "mlp_tile.cuh"

namespace infera {

// K7a's load of a row-major table x [n, d0] (K8a and K8b run the same code).
//
// The 64 rows of a tile are one contiguous run of 64 * d0 elements. A block
// walks its tiles j = 0, 1, ... (tile blockIdx.x + j * gridDim.x) with a ring
// of `stages` buffers in shared memory: before it transposes tile j it has
// issued the copies of tiles j + 1 .. j + stages - 1, so their bytes are in
// flight while tile j is transposed and computed. The tile's 16-byte words
// are dealt to the threads by row first (word w of row r to item 64 w + r);
// a thread copies its words with cp.async.cg, one commit group a tile, waits
// for its own words of tile j with cp.async.wait_group and transposes them
// itself: it writes the 8 bf16 or 4 f32 values of a word into 8 or 4 rows of
// the feature-major activation tile act [d0][kActStride]. No thread reads
// another's words, so neither the wait nor the refill of a buffer needs a
// barrier; the caller's barrier after the load is the tile's only one. A
// buffer keeps each row at a stride of an odd number of 16-byte words, and
// 32 threads take 32 neighbouring rows of one word, so the copies' writes,
// the transposition's reads and its writes are free of bank conflicts. A
// table whose base is not 16-byte aligned, a row of d0 elements that is not
// a multiple of 16 bytes (stages = 0), and the ragged last tile take a
// scalar path in the same loop: each value read from device memory straight
// into act. Rows past n are zero; kBf16 rounds an f32 table's values to bf16.
// The load is a copy, so its values are the scalar path's bit for bit.

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

// Issue this thread's copies of this block's tile j into its buffer and
// commit them as one group (an empty group where the tile takes the scalar
// path).
template <typename TIn>
__device__ inline void ring_issue(const RowRing<TIn> g, int j) {
  const long long tile = blockIdx.x + (long long)j * gridDim.x;
  if (ring_tile(g, tile)) {
    const int words = g.d0 * (int)sizeof(TIn) / 16;  // 16-byte words of a row
    const int stride = ring_stride(g.d0, (int)sizeof(TIn));
    unsigned char* dst = g.buf + (j % g.stages) * kTileRows * stride;
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(g.x + tile * kTileRows * g.d0);
    for (int i = threadIdx.x; i < kTileRows * words; i += kThreads) {
      const int r = i & (kTileRows - 1);
      const int w = i / kTileRows;
      cp_async16(dst + r * stride + 16 * w, src + r * (16 * words) + 16 * w);
    }
  }
  cp_async_commit();
}

// Before the loop over tiles: issue tiles 0 .. stages - 2.
template <typename TIn>
__device__ inline void ring_start(const RowRing<TIn> g) {
  for (int j = 0; j + 1 < g.stages; ++j) ring_issue(g, j);
}

__device__ inline void put4(float* act, int k, int r, float4 v, bool bf) {
  act[k * kActStride + r] = bf ? round_bf16(v.x) : v.x;
  act[(k + 1) * kActStride + r] = bf ? round_bf16(v.y) : v.y;
  act[(k + 2) * kActStride + r] = bf ? round_bf16(v.z) : v.z;
  act[(k + 3) * kActStride + r] = bf ? round_bf16(v.w) : v.w;
}

__device__ inline void transpose_word(const float* p, float* act, int k, int r, bool bf) {
  put4(act, k, r, *reinterpret_cast<const float4*>(p), bf);
}

// the f32 of the first and of the second bf16 of a word: a bf16 is the high
// half of its f32
__device__ inline float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ inline float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

__device__ inline void transpose_word(const __nv_bfloat16* p, float* act, int k, int r,
                                      bool bf) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  put4(act, k, r, make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y)), bf);
  put4(act, k + 4, r, make_float4(bf16_lo(u.z), bf16_hi(u.z), bf16_lo(u.w), bf16_hi(u.w)), bf);
}

// Tile j of this block (row0 = its first row) into act: issue tile
// j + stages - 1 into the buffer tile j - 1 left (this thread's own words,
// read in the last call), wait for this thread's words of tile j, transpose
// them. Ends without a barrier.
template <typename TIn, bool kBf16>
__device__ inline void load_rows_tile(const RowRing<TIn> g, int j, long long row0,
                                      float* __restrict__ act) {
  const long long tile = blockIdx.x + (long long)j * gridDim.x;
  if (g.stages > 0) {
    ring_issue(g, j + g.stages - 1);
    cp_async_wait(g.stages - 1);
  }
  const int d0 = g.d0;
  // a bf16 value is already a bf16: only an f32 table is rounded
  constexpr bool kRound = kBf16 && sizeof(TIn) == 4;
  if (ring_tile(g, tile)) {
    constexpr int kPer = 16 / (int)sizeof(TIn);  // values of a 16-byte word
    const int words = d0 / kPer;
    const int stride = ring_stride(d0, (int)sizeof(TIn));
    const unsigned char* b = g.buf + (j % g.stages) * kTileRows * stride;
    for (int i = threadIdx.x; i < kTileRows * words; i += kThreads) {
      const int r = i & (kTileRows - 1);
      const int w = i / kTileRows;
      transpose_word(reinterpret_cast<const TIn*>(b + r * stride + 16 * w), act, kPer * w, r,
                     kRound);
    }
    return;
  }
  const int rows = (int)min((long long)kTileRows, g.n - row0);
  const TIn* src = g.x + row0 * d0;
  for (int i = threadIdx.x; i < kTileRows * d0; i += kThreads) {
    const int k = i / kTileRows;
    const int r = i - k * kTileRows;
    float v = r < rows ? load_f32(src + (long long)r * d0 + k) : 0.f;
    if (kRound) v = round_bf16(v);
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
