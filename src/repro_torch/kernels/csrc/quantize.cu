// Quantize→dequantize round trip of outer gradients, for Hopper (sm_90a):
// the simulated low-precision transport of streaming DiLoCo.
//
// Replaces the TPU kernel src/repro/kernels/quantize.py:fake_quant (body
// _fake_quant_kernel). The operand is a contiguous float32 matrix of
// `rows` rows of `n` entries (a replica's flattened outer gradient per
// row), written to `out` (which may be the input). Two modes:
//   int4  each row is cut into blocks of 128 consecutive entries, the last
//         one ragged; per block
//           amax  = max |x|          (a NaN anywhere makes it NaN)
//           scale = amax * inv_levels (the caller's pre-rounded f32 1/7)
//           q     = rint(x / (scale > 0 ? scale : 1))  (IEEE division)
//           out   = clip(q, -7, 7) * scale            (a NaN passes)
//         so a block holding a NaN or an infinity comes out all NaN, as
//         in the JAX package (an infinite scale gives 0 * inf);
//   bf16  every entry rounded to bfloat16 (to nearest, ties to even) and
//         widened back.
// Blocks restart at each row: a block never mixes two replicas' entries,
// the JAX package's vmap over the replicas.
//
// What bounds it: bytes. One float32 read and one write per entry (8 B)
// against about seven operations. The design for int4: one warp owns one
// 128-entry block, each lane four entries at lane + 32*j (coalesced 128 B
// loads); the block's max is a shuffle reduction whose max lets a NaN win
// (CUDA's fmaxf would drop it); a grid-stride loop over a bounded grid
// takes any size in one launch. No shared memory, one pass over the data.
//
// Built with --fmad=false; rintf and __fdiv_rn round as torch.round and
// IEEE division do, so the result agrees bit for bit with the plain
// PyTorch version in kernels/ref.py (NaN payloads aside).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// max that propagates NaN, as torch.amax and jnp.max do
__device__ __forceinline__ float nanmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// clip to [-levels, levels] that lets a NaN through, as jnp.clip does
__device__ __forceinline__ float clip(float q, float levels) {
  return q < -levels ? -levels : (q > levels ? levels : q);
}

__global__ void fake_quant_int4_kernel(const float* x, float* out,
                                       int64_t rows, int64_t n, int64_t nb,
                                       float inv_levels, float levels) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int64_t total = rows * nb;
  // warp-uniform loop: every lane of a warp takes the same blocks
  for (int64_t b = warp; b < total; b += n_warps) {
    const int64_t row = b / nb;
    const int64_t col0 = (b - row * nb) * BLOCK;
    const float* xr = x + row * n;
    float* outr = out + row * n;
    float v[4];
    float amax = 0.0f;  // the padding's zeros: no block's max is below 0
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t col = col0 + lane + 32 * j;
      v[j] = col < n ? xr[col] : 0.0f;
      amax = nanmax(amax, fabsf(v[j]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = nanmax(amax, __shfl_xor_sync(FULL, amax, o));
    const float scale = amax * inv_levels;
    const float div = scale > 0.0f ? scale : 1.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t col = col0 + lane + 32 * j;
      if (col < n)
        outr[col] = clip(rintf(__fdiv_rn(v[j], div)), levels) * scale;
    }
  }
}

__device__ __forceinline__ float bf16_round(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}

__global__ void fake_quant_bf16_kernel(const float* x, float* out,
                                       int64_t n, int64_t n_vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = tid; i < n_vec; i += stride) {
    float4 a = reinterpret_cast<const float4*>(x)[i];
    a.x = bf16_round(a.x);
    a.y = bf16_round(a.y);
    a.z = bf16_round(a.z);
    a.w = bf16_round(a.w);
    reinterpret_cast<float4*>(out)[i] = a;
  }
  for (int64_t i = 4 * n_vec + tid; i < n; i += stride)
    out[i] = bf16_round(x[i]);
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

inline unsigned grid_for(int64_t threads_needed) {
  int64_t blocks = (threads_needed + THREADS - 1) / THREADS;
  if (blocks > 8192) blocks = 8192;
  if (blocks < 1) blocks = 1;
  return (unsigned)blocks;
}

}  // namespace

// Launches one round trip over a (rows, n) float32 matrix on `stream` of
// `device`: mode 0 = int4 (blocks of 128 per row), 1 = bf16. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_fake_quant_f32(const float* x, float* out,
                                    long long rows, long long n, int mode,
                                    float inv_levels, float levels,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0 || n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0) {
    const int64_t nb = (n + BLOCK - 1) / BLOCK;
    fake_quant_int4_kernel<<<grid_for(rows * nb * 32), THREADS, 0, s>>>(
        x, out, rows, n, nb, inv_levels, levels);
  } else if (mode == 1) {
    const int64_t total = rows * n;
    const int64_t n_vec = aligned16(x) && aligned16(out) ? total / 4 : 0;
    const int64_t tail = total - 4 * n_vec;
    fake_quant_bf16_kernel<<<grid_for(n_vec > tail ? n_vec : tail), THREADS,
                             0, s>>>(x, out, total, n_vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
