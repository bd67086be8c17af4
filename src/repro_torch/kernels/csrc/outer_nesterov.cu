// Fused outer Nesterov step on one contiguous float32 tensor, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/outer_nesterov.py:
// outer_nesterov (body _nesterov_kernel). Per element:
//   b' = mu*b + d
//   p' = p - lr*(mu*b' + d)
//
// What bounds it: bytes. Three float32 reads (p, d, b) and two writes
// (p, b) per element, 20 B, against 5 flops. The design is the fused AdamW
// kernel's: one pass over the flat leaf as it lies in memory (no (rows,
// 128) padding copy), float4 accesses when every pointer is 16-byte
// aligned, a masked scalar tail, a grid-stride loop over a bounded grid.
// Outputs may alias inputs (the tree-level update runs in place).
//
// Arithmetic keeps _nesterov_kernel's operation order with no contraction
// (built with --fmad=false), so it agrees bit for bit with the plain
// PyTorch version in kernels/ref.py.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void nesterov_one(float& p, float d, float& b,
                                             float lr, float mu) {
  float b_new = mu * b + d;
  p = p - lr * (mu * b_new + d);
  b = b_new;
}

__global__ void nesterov_kernel(const float* p, const float* d,
                                const float* b, float* p_out, float* b_out,
                                int64_t n, int64_t n_vec, float lr,
                                float mu) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = tid; i < n_vec; i += stride) {
    float4 pp = reinterpret_cast<const float4*>(p)[i];
    float4 dd = reinterpret_cast<const float4*>(d)[i];
    float4 bb = reinterpret_cast<const float4*>(b)[i];
    nesterov_one(pp.x, dd.x, bb.x, lr, mu);
    nesterov_one(pp.y, dd.y, bb.y, lr, mu);
    nesterov_one(pp.z, dd.z, bb.z, lr, mu);
    nesterov_one(pp.w, dd.w, bb.w, lr, mu);
    reinterpret_cast<float4*>(p_out)[i] = pp;
    reinterpret_cast<float4*>(b_out)[i] = bb;
  }
  for (int64_t i = 4 * n_vec + tid; i < n; i += stride) {
    float pp = p[i], bb = b[i];
    nesterov_one(pp, d[i], bb, lr, mu);
    p_out[i] = pp;
    b_out[i] = bb;
  }
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

// Launches one fused outer Nesterov step over n elements on `stream` of
// `device`. Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_outer_nesterov_f32(
    const float* p, const float* d, const float* b, float* p_out,
    float* b_out, long long n, float lr, float mu, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  const bool vec = aligned16(p) && aligned16(d) && aligned16(b) &&
                   aligned16(p_out) && aligned16(b_out);
  const int64_t n_vec = vec ? n / 4 : 0;
  const int64_t work = n_vec > n - 4 * n_vec ? n_vec : n - 4 * n_vec;
  const int threads = 256;
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks > 8192) blocks = 8192;
  if (blocks < 1) blocks = 1;
  nesterov_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      p, d, b, p_out, b_out, (int64_t)n, n_vec, lr, mu);
  return (int)cudaGetLastError();
}
