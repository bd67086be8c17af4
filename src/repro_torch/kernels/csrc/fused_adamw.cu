// Fused AdamW step on one contiguous float32 tensor, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_adamw.py:fused_adamw
// (body _adamw_kernel). Per element:
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + (1-b2)*g*g
//   p' = p - lr*((m'/c1) / (sqrt(v'/c2) + eps) + wd*p)
//
// What bounds it: bytes. Four float32 reads (p, g, m, v) and three writes
// (p, m, v) per element, 28 B, against ~20 flops: three orders of magnitude
// below the card's ridge point, so the only lever is to move each byte
// once. The design:
//   * one pass, no intermediate ever leaves registers;
//   * the flat leaf as it lies in memory: no (rows, 128) pad-and-reshape
//     copy as the TPU layout needed; the ragged tail is masked here;
//   * 16-byte float4 loads and stores when every pointer is 16-byte
//     aligned (a replica's slice of a stacked leaf usually is), scalar
//     accesses otherwise and for the last n % 4 elements;
//   * a grid-stride loop over a bounded grid, so a leaf of any size is one
//     launch.
// Outputs may alias inputs (the tree-level update runs in place): every
// element is read and written by the same thread, so no __restrict__.
//
// Arithmetic keeps _adamw_kernel's operation order, with IEEE division and
// sqrtf and no contraction (built with --fmad=false), so it agrees bit for
// bit with the plain PyTorch version in kernels/ref.py.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Scalars {
  float lr, c1, c2, b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ void adamw_one(float& p, float g, float& m,
                                          float& v, const Scalars& s) {
  float m_new = s.b1 * m + s.omb1 * g;
  float v_new = s.b2 * v + s.omb2 * g * g;
  float step = (m_new / s.c1) / (sqrtf(v_new / s.c2) + s.eps) + s.wd * p;
  p = p - s.lr * step;
  m = m_new;
  v = v_new;
}

__global__ void adamw_kernel(const float* p, const float* g, const float* m,
                             const float* v, float* p_out, float* m_out,
                             float* v_out, int64_t n, int64_t n_vec,
                             Scalars s) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = tid; i < n_vec; i += stride) {
    float4 pp = reinterpret_cast<const float4*>(p)[i];
    float4 gg = reinterpret_cast<const float4*>(g)[i];
    float4 mm = reinterpret_cast<const float4*>(m)[i];
    float4 vv = reinterpret_cast<const float4*>(v)[i];
    adamw_one(pp.x, gg.x, mm.x, vv.x, s);
    adamw_one(pp.y, gg.y, mm.y, vv.y, s);
    adamw_one(pp.z, gg.z, mm.z, vv.z, s);
    adamw_one(pp.w, gg.w, mm.w, vv.w, s);
    reinterpret_cast<float4*>(p_out)[i] = pp;
    reinterpret_cast<float4*>(m_out)[i] = mm;
    reinterpret_cast<float4*>(v_out)[i] = vv;
  }
  for (int64_t i = 4 * n_vec + tid; i < n; i += stride) {
    float pp = p[i], mm = m[i], vv = v[i];
    adamw_one(pp, g[i], mm, vv, s);
    p_out[i] = pp;
    m_out[i] = mm;
    v_out[i] = vv;
  }
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

// Launches one fused AdamW step over n elements on `stream` of `device`.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_fused_adamw_f32(
    const float* p, const float* g, const float* m, const float* v,
    float* p_out, float* m_out, float* v_out, long long n, float lr,
    float c1, float c2, float b1, float omb1, float b2, float omb2,
    float eps, float wd, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  const bool vec = aligned16(p) && aligned16(g) && aligned16(m) &&
                   aligned16(v) && aligned16(p_out) && aligned16(m_out) &&
                   aligned16(v_out);
  const int64_t n_vec = vec ? n / 4 : 0;
  const int64_t work = n_vec > n - 4 * n_vec ? n_vec : n - 4 * n_vec;
  const int threads = 256;
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks > 8192) blocks = 8192;
  if (blocks < 1) blocks = 1;
  Scalars s{lr, c1, c2, b1, omb1, b2, omb2, eps, wd};
  adamw_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      p, g, m, v, p_out, m_out, v_out, (int64_t)n, n_vec, s);
  return (int)cudaGetLastError();
}
