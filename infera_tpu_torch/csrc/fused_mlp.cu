// K6: row-major fused ReLU MLP with an optional final softmax.
//
// Replaces infera_tpu/ops/pallas_mlp.py `_mlp_kernel` / `fused_mlp` (the
// engine's predict path for MLP-shaped ONNX graphs).
//
// Bound on the H100 at the main path's shapes (N = 1,048,576 rows, a
// 32 -> 128 -> 128 -> 16 MLP with softmax): 2 * N * 22,528 = 47.2 GFLOP of f32
// multiply-adds on the CUDA cores (no TF32: the f32 path is the parity path),
// about 0.70 ms at 67 TFLOP/s; it moves 134 MB in and 67 MB out, about 0.06 ms
// at 3.35 TB/s. So it is bound by f32 operations.
//
// Design against that bound: the whole layer stack runs on a 64-row tile in
// shared memory, so no intermediate activation touches device memory; the
// weights (90 KB at the main path's widths) are loaded into shared memory once
// per persistent block; each thread keeps a register tile (mlp_tile.cuh's
// mlp_stack_ffma), so every shared memory load feeds 8 or 4 FMAs, and every
// warp works on every layer, the 16-class last one included. A block of 512
// threads runs two halves of 256 over one copy of the weights (230,464 B of
// shared memory at the main path's widths), each on its own tiles with its
// own activation tiles and named barrier, so one half's load, softmax and
// store run beside the other half's FMAs; an MLP whose two halves do not fit
// runs one. Each output is summed as before (from 0, one fmaf per input in
// input order, then the bias), so K6's outputs do not depend on the launch
// shape. Not done yet: tensor cores (TF32 would break the 1e-5 parity bound;
// bf16/3xTF32 splitting is a later design).
#include "mlp_tile.cuh"

namespace infera {

// `halves` (blockDim.x / kThreads) tile groups a block (Half). Shared
// memory: the weights and biases once, then each half's act0 and act1.
__global__ void __launch_bounds__(kMaxHalves * kThreads, 1)
fused_mlp_kernel(const float* __restrict__ x, long long n, const float* __restrict__ blob,
                 int blob_words16, MlpDims d, int widest, int softmax,
                 float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Half g = this_half();
  float* s_blob = reinterpret_cast<float*>(smem_raw);
  float* act0 = s_blob + 4 * blob_words16 + g.h * 2 * widest * kActStride;
  float* act1 = act0 + widest * kActStride;
  copy_words16(s_blob, blob, blob_words16, threadIdx.x, blockDim.x);
  __syncthreads();

  const int d0 = d.dim[0];
  const int dout = d.dim[d.n_layers];
  const int tid = g.tid();
  const long long n_tiles = (n + kTileRows - 1) / kTileRows;
  for (long long tile = g.index(); tile < n_tiles; tile += g.step()) {
    const long long row0 = tile * kTileRows;
    // row-major [rows, d0] -> feature-major tile; consecutive threads read
    // consecutive addresses of device memory
    for (int i = tid; i < kTileRows * d0; i += kThreads) {
      const int r = i / d0;
      const int k = i - r * d0;
      const long long row = row0 + r;
      act0[k * kActStride + r] = row < n ? x[row * d0 + k] : 0.f;
    }
    g.sync();
    float* h = mlp_stack_ffma(d, s_blob, act0, act1, g);
    if (softmax && tid < kTileRows) {
      // softmax over the classes of one row, in f32, as jax.nn.softmax:
      // exp(x - max) / sum(exp(x - max))
      const int r = tid;
      float m = h[r];
      for (int c = 1; c < dout; ++c) m = fmaxf(m, h[c * kActStride + r]);
      float s = 0.f;
      for (int c = 0; c < dout; ++c) {
        const float e = expf(h[c * kActStride + r] - m);
        h[c * kActStride + r] = e;
        s += e;
      }
      for (int c = 0; c < dout; ++c) h[c * kActStride + r] = h[c * kActStride + r] / s;
    }
    g.sync();
    for (int i = tid; i < kTileRows * dout; i += kThreads) {
      const int r = i / dout;
      const int c = i - r * dout;
      const long long row = row0 + r;
      if (row < n) out[row * dout + c] = h[c * kActStride + r];
    }
    g.sync();
  }
}

}  // namespace infera

extern "C" {

// `halves` (1 or 2): tile groups a block of halves x 256 threads. Returns a
// cudaError_t: 0 when the launch was accepted.
int infera_fused_mlp(const void* x, long long n, const void* blob, long long blob_floats,
                     const int* dims, int n_layers, int widest, int softmax, void* out,
                     int n_blocks, int halves, int smem_bytes, void* stream) {
  using namespace infera;
  if (halves < 1 || halves > kMaxHalves) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(fused_mlp_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  fused_mlp_kernel<<<n_blocks, halves * kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)x, n, (const float*)blob, (int)(blob_floats / 4), make_dims(dims, n_layers),
      widest, softmax, (float*)out);
  return (int)cudaGetLastError();
}

// Blocks of K6 resident on one SM at `halves` x 256 threads and `smem`
// bytes of dynamic shared memory, into *blocks. Returns a cudaError_t.
int infera_fused_mlp_occupancy(int halves, int smem, int* blocks) {
  using namespace infera;
  cudaError_t e = cudaFuncSetAttribute(fused_mlp_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fused_mlp_kernel,
                                                      halves * kThreads, smem);
  return (int)e;
}

const char* infera_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
