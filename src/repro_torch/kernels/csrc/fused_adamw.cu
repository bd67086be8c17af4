// Fused AdamW steps on one contiguous tensor, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/fused_adamw.py:
//   fused_adamw        (body _adamw_kernel): p, g, m, v at one storage
//                      dtype, float32 or bfloat16; p, m, v written back;
//   fused_adamw_mixed  (body _adamw_mixed_kernel): bf16 g, m, v and the
//                      float32 master w; the master, m, v and the bf16
//                      working copy p written, all in one pass.
// Per element, in float32 whatever the storage:
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + (1-b2)*g*g
//   w' = w - lr*((m'/c1) / (sqrt(v'/c2) + eps) + wd*w)
// where w is p in fused_adamw and the master in fused_adamw_mixed. Each
// output is rounded to its own dtype; bf16 by __float2bfloat16_rn (to
// nearest, ties to even, as torch's Tensor.to and jnp's astype round).
//
// What bounds them: bytes. float32 fused_adamw moves 28 B per element (4
// reads, 3 writes), bf16 fused_adamw 14 B, fused_adamw_mixed 20 B (bf16
// g, m, v and f32 w in; f32 w, bf16 m, v, p out), against ~20 flops: far
// below the card's ridge point, so the only lever is to move each byte
// once. The design:
//   * one pass, no intermediate ever leaves registers;
//   * the flat leaf as it lies in memory: no (rows, 128) pad-and-reshape
//     copy as the TPU layout needed; the ragged tail is masked here;
//   * four elements per access (16 B of float32, 8 B of bf16) when every
//     pointer is aligned to it (a replica's slice of a stacked leaf
//     usually is), scalar accesses otherwise and for the last n % 4;
//   * a grid-stride loop over a bounded grid, so a leaf of any size is one
//     launch.
// Outputs may alias inputs (the tree-level updates run in place): every
// element is read and written by the same thread, so no __restrict__.
//
// Arithmetic keeps _adamw_kernel's operation order, with IEEE division and
// sqrtf and no contraction (built with --fmad=false), so it agrees bit for
// bit with the plain PyTorch versions in kernels/ref.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

struct Scalars {
  float lr, c1, c2, b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ void adamw_one(float& w, float g, float& m,
                                          float& v, const Scalars& s) {
  float m_new = s.b1 * m + s.omb1 * g;
  float v_new = s.b2 * v + s.omb2 * g * g;
  float step = (m_new / s.c1) / (sqrtf(v_new / s.c2) + s.eps) + s.wd * w;
  w = w - s.lr * step;
  m = m_new;
  v = v_new;
}

// Four consecutive elements as float32: element i4 of the tensor viewed
// in groups of four.
__device__ __forceinline__ void load4(const float* p, int64_t i4,
                                      float o[4]) {
  float4 t = reinterpret_cast<const float4*>(p)[i4];
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}

__device__ __forceinline__ void load4(const bf16* p, int64_t i4,
                                      float o[4]) {
  uint2 t = reinterpret_cast<const uint2*>(p)[i4];
  __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&t.x);
  __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&t.y);
  o[0] = __low2float(lo); o[1] = __high2float(lo);
  o[2] = __low2float(hi); o[3] = __high2float(hi);
}

__device__ __forceinline__ void store4(float* p, int64_t i4,
                                       const float o[4]) {
  reinterpret_cast<float4*>(p)[i4] = make_float4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ void store4(bf16* p, int64_t i4,
                                       const float o[4]) {
  __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(o[0]),
                                         __float2bfloat16_rn(o[1]));
  __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(o[2]),
                                         __float2bfloat16_rn(o[3]));
  uint2 t;
  t.x = *reinterpret_cast<uint32_t*>(&lo);
  t.y = *reinterpret_cast<uint32_t*>(&hi);
  reinterpret_cast<uint2*>(p)[i4] = t;
}

__device__ __forceinline__ float load1(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load1(const bf16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store1(float* p, int64_t i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void store1(bf16* p, int64_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

// One kernel body for both entry points. W: type of the authoritative
// params w (read and written); S: type of g, m, v; P: type of the extra
// working copy p_out, written only when WORKING is true (the mixed step).
template <typename W, typename S, typename P, bool WORKING>
__global__ void adamw_kernel(const W* w, const S* g, const S* m, const S* v,
                             W* w_out, S* m_out, S* v_out, P* p_out,
                             int64_t n, int64_t n_vec, Scalars s) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = tid; i < n_vec; i += stride) {
    float ww[4], gg[4], mm[4], vv[4];
    load4(w, i, ww);
    load4(g, i, gg);
    load4(m, i, mm);
    load4(v, i, vv);
#pragma unroll
    for (int j = 0; j < 4; ++j) adamw_one(ww[j], gg[j], mm[j], vv[j], s);
    store4(w_out, i, ww);
    store4(m_out, i, mm);
    store4(v_out, i, vv);
    if constexpr (WORKING) store4(p_out, i, ww);
  }
  for (int64_t i = 4 * n_vec + tid; i < n; i += stride) {
    float ww = load1(w, i), mm = load1(m, i), vv = load1(v, i);
    adamw_one(ww, load1(g, i), mm, vv, s);
    store1(w_out, i, ww);
    store1(m_out, i, mm);
    store1(v_out, i, vv);
    if constexpr (WORKING) store1(p_out, i, ww);
  }
}

// Aligned for a four-element access of T.
template <typename T>
inline bool aligned4(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) % (4 * sizeof(T))) == 0;
}

template <typename W, typename S, typename P, bool WORKING>
int launch(const W* w, const S* g, const S* m, const S* v, W* w_out,
           S* m_out, S* v_out, P* p_out, long long n, const Scalars& s,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  const bool vec = aligned4<W>(w) && aligned4<S>(g) && aligned4<S>(m) &&
                   aligned4<S>(v) && aligned4<W>(w_out) &&
                   aligned4<S>(m_out) && aligned4<S>(v_out) &&
                   (!WORKING || aligned4<P>(p_out));
  const int64_t n_vec = vec ? n / 4 : 0;
  const int64_t work = n_vec > n - 4 * n_vec ? n_vec : n - 4 * n_vec;
  const int threads = 256;
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks > 8192) blocks = 8192;
  if (blocks < 1) blocks = 1;
  adamw_kernel<W, S, P, WORKING>
      <<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
          w, g, m, v, w_out, m_out, v_out, p_out, (int64_t)n, n_vec, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches one fused AdamW step over n elements on `stream` of `device`:
// p, g, m, v and the outputs all float32 (repro_fused_adamw_f32) or all
// bfloat16 (repro_fused_adamw_bf16). Returns the cudaError_t of the launch
// (0 on success).
extern "C" int repro_fused_adamw_f32(
    const float* p, const float* g, const float* m, const float* v,
    float* p_out, float* m_out, float* v_out, long long n, float lr,
    float c1, float c2, float b1, float omb1, float b2, float omb2,
    float eps, float wd, int device, void* stream) {
  Scalars s{lr, c1, c2, b1, omb1, b2, omb2, eps, wd};
  return launch<float, float, float, false>(p, g, m, v, p_out, m_out, v_out,
                                            nullptr, n, s, device, stream);
}

extern "C" int repro_fused_adamw_bf16(
    const bf16* p, const bf16* g, const bf16* m, const bf16* v, bf16* p_out,
    bf16* m_out, bf16* v_out, long long n, float lr, float c1, float c2,
    float b1, float omb1, float b2, float omb2, float eps, float wd,
    int device, void* stream) {
  Scalars s{lr, c1, c2, b1, omb1, b2, omb2, eps, wd};
  return launch<bf16, bf16, bf16, false>(p, g, m, v, p_out, m_out, v_out,
                                         nullptr, n, s, device, stream);
}

// Launches one mixed-precision AdamW step over n elements: bf16 g, m, v
// and the float32 master w in; the float32 master, bf16 m and v, and the
// bf16 working copy p out. Returns the cudaError_t of the launch.
extern "C" int repro_fused_adamw_mixed(
    const bf16* g, const bf16* m, const bf16* v, const float* w, bf16* p_out,
    bf16* m_out, bf16* v_out, float* w_out, long long n, float lr, float c1,
    float c2, float b1, float omb1, float b2, float omb2, float eps, float wd,
    int device, void* stream) {
  Scalars s{lr, c1, c2, b1, omb1, b2, omb2, eps, wd};
  return launch<float, bf16, bf16, true>(w, g, m, v, w_out, m_out, v_out,
                                         p_out, n, s, device, stream);
}
