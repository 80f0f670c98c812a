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
// per persistent block; each thread keeps a 4x8 register tile, so every shared
// memory load feeds 8 or 4 FMAs. Not done yet: tensor cores (TF32 would break
// the 1e-5 parity bound; bf16/3xTF32 splitting is a later design) and
// overlapping the next tile's load with this tile's math.
#include "mlp_tile.cuh"

namespace infera {

__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const float* __restrict__ x, long long n, const float* __restrict__ blob,
                 int blob_words16, MlpDims d, int widest, int softmax,
                 float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_blob = reinterpret_cast<float*>(smem_raw);
  float* act0 = s_blob + 4 * blob_words16;
  float* act1 = act0 + widest * kActStride;
  copy_words16(s_blob, blob, blob_words16);
  __syncthreads();

  const int d0 = d.dim[0];
  const int dout = d.dim[d.n_layers];
  const long long n_tiles = (n + kTileRows - 1) / kTileRows;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * kTileRows;
    // row-major [rows, d0] -> feature-major tile; consecutive threads read
    // consecutive addresses of device memory
    for (int i = threadIdx.x; i < kTileRows * d0; i += kThreads) {
      const int r = i / d0;
      const int k = i - r * d0;
      const long long row = row0 + r;
      act0[k * kActStride + r] = row < n ? x[row * d0 + k] : 0.f;
    }
    __syncthreads();
    float* h = mlp_stack_f32<false>(d, s_blob, act0, act1);
    if (softmax && threadIdx.x < kTileRows) {
      // softmax over the classes of one row, in f32, as jax.nn.softmax:
      // exp(x - max) / sum(exp(x - max))
      const int r = threadIdx.x;
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
    __syncthreads();
    for (int i = threadIdx.x; i < kTileRows * dout; i += kThreads) {
      const int r = i / dout;
      const int c = i - r * dout;
      const long long row = row0 + r;
      if (row < n) out[row * dout + c] = h[c * kActStride + r];
    }
    __syncthreads();
  }
}

}  // namespace infera

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted.
int infera_fused_mlp(const void* x, long long n, const void* blob, long long blob_floats,
                     const int* dims, int n_layers, int widest, int softmax, void* out,
                     int n_blocks, int smem_bytes, void* stream) {
  using namespace infera;
  cudaError_t e = cudaFuncSetAttribute(fused_mlp_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  fused_mlp_kernel<<<n_blocks, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)x, n, (const float*)blob, (int)(blob_floats / 4), make_dims(dims, n_layers),
      widest, softmax, (float*)out);
  return (int)cudaGetLastError();
}

const char* infera_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
