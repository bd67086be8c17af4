// Low-precision outer-gradient transport for Hopper (sm_90a): the
// quantize→dequantize round trip of streaming DiLoCo, and the packed int4
// wire codecs of the async transport.
//
// 1. fake_quant (replaces the TPU kernel src/repro/kernels/quantize.py:
// fake_quant, body _fake_quant_kernel). The operand is a contiguous
// float32 matrix of `rows` rows of `n` entries (a replica's flattened
// outer gradient per row), written to `out` (which may be the input). Two
// modes:
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
// 2. quantize_pack_int4 (replaces quantize.py:quantize_pack_int4, body
// _quantize_pack_kernel) and unpack_dequantize_int4 (replaces
// quantize.py:unpack_dequantize_int4, body _unpack_dequant_kernel): the
// sender and receiver of ONE packed int4 wire buffer over a flat float32
// vector of n entries, laid out as
//   [ceil(n/2) code bytes][zero padding to 4 bytes][one f32 scale per
//    started 128-entry block]
// Byte b holds entry 2b in its low nibble and 2b+1 in its high one (4-bit
// two's complement). The quantization is fake_quant's; the code of a NaN
// quotient is 0 (JAX's float -> int cast), and codes past n are 0. The
// sender writes the code bytes (never past ceil(n/2): the scales follow),
// the padding and the scales straight into the wire, and, when asked, the
// local values clip(q) * scale. The receiver sign-extends each nibble,
// ((nib ^ 8) - 8), and multiplies by its block's scale.
//
// What bounds them: bytes. The sender reads 4 B and writes 0.53 B per
// entry (4 more with the local values); the receiver reads 0.53 B and
// writes 4. The sender's design: a thread owns 8 consecutive entries (two
// float4 loads, one 32-bit word of codes), so sixteen lanes of a warp own
// one 128-entry block and its max is a four-step shuffle reduction inside
// each half-warp; the loop runs over whole warps so that every lane takes
// part in the shuffles. The receiver's: a thread owns 4 entries (one
// 16-bit load of codes, one float4 store), so a warp's stores cover 512
// contiguous bytes (with 8 entries a thread, each store instruction left
// a hole in every 32-byte sector, and the receiver reached half its
// bound). The ragged tail and unaligned pointers take byte and scalar
// accesses.
//
// 3. unpack_dequantize_reduce (replaces quantize.py:
// unpack_dequantize_reduce, body _unpack_dequant_reduce_kernel): the
// sharded transport's deferred consumer. One region of the gathered wire,
// k rows of the layout above (row j at `wire + j * stride`), is decoded
// and mask-reduced in one pass: out[e] = sum_j m[j] * code_j[e] *
// scale_j[e / 128], summed in replica order, acc = m[0]*v_0, then
// acc + m[j]*v_j, every product rounded (the plain version's order). A
// zero mask entry still multiplies: 0 * NaN and 0 * inf are NaN, as the
// JAX reduce's m * vals. What bounds it: bytes, 0.53 B read per entry and
// replica, 4 B written. A thread owns 4 entries: per replica one 16-bit
// load of codes and the block's scale, a float4 store at the end; the k
// partial sums stay in registers.
//
// 4. The unfused codec pieces on the (R, 128) block layout (replace
// quantize.py:quantize_int4, dequantize_int4, pack_int4, unpack_int4;
// bodies _quantize_kernel, _dequantize_kernel, _pack_kernel,
// _unpack_kernel):
//   quantize_int4    f32 blocks -> int8 codes clip(rint(x / s), -7, 7)
//                    and f32 scales s = amax * inv_levels (a NaN gives
//                    code 0); one warp a block, a thread 4 entries (a
//                    float4 load, one 32-bit store of codes);
//   dequantize_int4  codes * the row's scale; a thread 4 entries;
//   pack_int4        codes -> nibble-packed bytes (lane 2j low, 2j+1
//                    high); a thread 8 codes in, one 32-bit word out;
//   unpack_int4      the inverse, sign-extended by (nib ^ 8) - 8; a thread
//                    4 bytes in, 8 codes out.
// All bound by bytes; each warp's stores cover whole sectors.
//
// Built with --fmad=false; rintf and __fdiv_rn round as torch.round and
// IEEE division do, so the results agree bit for bit with the plain
// PyTorch versions in kernels/ref.py (NaN payloads aside).
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

// The sender: see the header. One thread per 8 entries (an "octet").
__global__ void quantize_pack_int4_kernel(const float* __restrict__ x,
                                          uint8_t* __restrict__ codes,
                                          float* __restrict__ scales,
                                          float* __restrict__ local,
                                          int64_t n, int64_t n_oct,
                                          int64_t cb, int pad, bool vec,
                                          float inv_levels, float levels) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  if (tid < pad) codes[cb + tid] = 0;
  // whole warps: every lane of a warp runs the same iterations
  const int64_t n_iter = (n_oct + 31) / 32 * 32;
  for (int64_t o = tid; o < n_iter; o += stride) {
    const int64_t e0 = o * 8;
    float v[8];
    if (vec && e0 + 8 <= n) {
      const float4 a = *reinterpret_cast<const float4*>(x + e0);
      const float4 b = *reinterpret_cast<const float4*>(x + e0 + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = e0 + j < n ? x[e0 + j] : 0.0f;
    }
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = nanmax(amax, fabsf(v[j]));
    // the 16 lanes of a half-warp hold one block
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      amax = nanmax(amax, __shfl_xor_sync(FULL, amax, off));
    if (o >= n_oct) continue;
    const float scale = amax * inv_levels;
    const float div = scale > 0.0f ? scale : 1.0f;
    float q[8];
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      q[j] = clip(rintf(__fdiv_rn(v[j], div)), levels);
      const int c = q[j] != q[j] ? 0 : (int)q[j];
      word |= (uint32_t)(c & 0xF) << (4 * j);
    }
    const int64_t b0 = 4 * o;
    if (b0 + 4 <= cb) {
      *reinterpret_cast<uint32_t*>(codes + b0) = word;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (b0 + i < cb) codes[b0 + i] = (uint8_t)(word >> (8 * i));
    }
    if ((o & 15) == 0) scales[o >> 4] = scale;
    if (local != nullptr) {
      if (vec && e0 + 8 <= n) {
        *reinterpret_cast<float4*>(local + e0) =
            make_float4(q[0] * scale, q[1] * scale, q[2] * scale,
                        q[3] * scale);
        *reinterpret_cast<float4*>(local + e0 + 4) =
            make_float4(q[4] * scale, q[5] * scale, q[6] * scale,
                        q[7] * scale);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (e0 + j < n) local[e0 + j] = q[j] * scale;
      }
    }
  }
}

// The receiver: see the header. One thread per 4 entries (2 code bytes),
// so a warp owns one 128-entry block: its stores are 512 contiguous bytes.
__global__ void unpack_dequantize_int4_kernel(
    const uint8_t* __restrict__ codes, const float* __restrict__ scales,
    float* __restrict__ out, int64_t n, int64_t n_quad, int64_t cb,
    bool vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < n_quad; t += stride) {
    const int64_t b0 = 2 * t;
    uint32_t word = 0;
    if (b0 + 2 <= cb) {
      word = *reinterpret_cast<const uint16_t*>(codes + b0);
    } else if (b0 < cb) {
      word = codes[b0];
    }
    const float scale = scales[t >> 5];
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nib = (int)((word >> (4 * j)) & 0xFu);
      v[j] = (float)((nib ^ 8) - 8) * scale;
    }
    const int64_t e0 = 4 * t;
    if (vec && e0 + 4 <= n) {
      *reinterpret_cast<float4*>(out + e0) = make_float4(v[0], v[1], v[2],
                                                         v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (e0 + j < n) out[e0 + j] = v[j];
    }
  }
}

// The sharded transport's deferred consumer: see the header. One thread
// per 4 entries (2 code bytes of each replica's row).
__global__ void unpack_dequantize_reduce_kernel(
    const uint8_t* __restrict__ wire, int64_t stride, int64_t scale_off,
    const float* __restrict__ m, float* __restrict__ out, int k,
    int64_t n, int64_t n_quad, int64_t cb, bool vec) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < n_quad; t += step) {
    const int64_t b0 = 2 * t;
    float acc[4];
    for (int j = 0; j < k; ++j) {
      const uint8_t* row = wire + j * stride;
      uint32_t word = 0;
      if (b0 + 2 <= cb) {
        word = *reinterpret_cast<const uint16_t*>(row + b0);
      } else if (b0 < cb) {
        word = row[b0];
      }
      const float scale =
          reinterpret_cast<const float*>(row + scale_off)[t >> 5];
      const float mj = m[j];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int nib = (int)((word >> (4 * q)) & 0xFu);
        const float p = mj * ((float)((nib ^ 8) - 8) * scale);
        acc[q] = j == 0 ? p : acc[q] + p;
      }
    }
    const int64_t e0 = 4 * t;
    if (vec && e0 + 4 <= n) {
      *reinterpret_cast<float4*>(out + e0) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (e0 + q < n) out[e0 + q] = acc[q];
    }
  }
}

// quantize_int4: one warp per 128-entry block, a thread 4 entries.
__global__ void quantize_int4_kernel(const float* __restrict__ x,
                                     int8_t* __restrict__ codes,
                                     float* __restrict__ scales,
                                     int64_t rows, bool vec,
                                     float inv_levels, float levels) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t r = warp; r < rows; r += n_warps) {
    const int64_t e0 = r * BLOCK + 4 * lane;
    float v[4];
    if (vec) {
      const float4 a = *reinterpret_cast<const float4*>(x + e0);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = x[e0 + j];
    }
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) amax = nanmax(amax, fabsf(v[j]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = nanmax(amax, __shfl_xor_sync(FULL, amax, o));
    const float scale = amax * inv_levels;
    const float div = scale > 0.0f ? scale : 1.0f;
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float q = clip(rintf(__fdiv_rn(v[j], div)), levels);
      const int c = q != q ? 0 : (int)q;
      word |= (uint32_t)(uint8_t)(int8_t)c << (8 * j);
    }
    if (vec) {
      *reinterpret_cast<uint32_t*>(codes + e0) = word;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) codes[e0 + j] = (int8_t)(word >> (8 * j));
    }
    if (lane == 0) scales[r] = scale;
  }
}

// dequantize_int4: a thread 4 entries of one row.
__global__ void dequantize_int4_kernel(const int8_t* __restrict__ codes,
                                       const float* __restrict__ scales,
                                       float* __restrict__ out,
                                       int64_t n_quad, bool vec) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < n_quad; t += step) {
    const int64_t e0 = 4 * t;
    const float s = scales[t >> 5];
    float v[4];
    if (vec) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(codes + e0);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = (float)(int8_t)(w >> (8 * j)) * s;
      *reinterpret_cast<float4*>(out + e0) = make_float4(v[0], v[1], v[2],
                                                         v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) out[e0 + j] = (float)codes[e0 + j] * s;
    }
  }
}

// pack_int4: a thread 8 codes in, 4 bytes out.
__global__ void pack_int4_kernel(const int8_t* __restrict__ codes,
                                 uint8_t* __restrict__ out, int64_t n_oct,
                                 bool vec) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       o < n_oct; o += step) {
    int c[8];
    if (vec) {
      const uint2 a = *reinterpret_cast<const uint2*>(codes + 8 * o);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = (int)(int8_t)(a.x >> (8 * j));
        c[4 + j] = (int)(int8_t)(a.y >> (8 * j));
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) c[j] = codes[8 * o + j];
    }
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      word |= (uint32_t)((c[2 * j] & 0xF) | ((c[2 * j + 1] & 0xF) << 4))
              << (8 * j);
    if (vec) {
      *reinterpret_cast<uint32_t*>(out + 4 * o) = word;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) out[4 * o + j] = (uint8_t)(word >> (8 * j));
    }
  }
}

// unpack_int4: a thread 4 bytes in, 8 sign-extended codes out.
__global__ void unpack_int4_kernel(const uint8_t* __restrict__ in,
                                   int8_t* __restrict__ out, int64_t n_quad,
                                   bool vec) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < n_quad; t += step) {
    uint32_t w = 0;
    if (vec) {
      w = *reinterpret_cast<const uint32_t*>(in + 4 * t);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) w |= (uint32_t)in[4 * t + j] << (8 * j);
    }
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int nib = (int)((w >> (4 * j)) & 0xFu);
      const uint32_t c = (uint32_t)(uint8_t)(int8_t)((nib ^ 8) - 8);
      if (j < 4) lo |= c << (8 * j); else hi |= c << (8 * (j - 4));
    }
    if (vec) {
      *reinterpret_cast<uint2*>(out + 8 * t) = make_uint2(lo, hi);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        out[8 * t + j] = (int8_t)(lo >> (8 * j));
        out[8 * t + 4 + j] = (int8_t)(hi >> (8 * j));
      }
    }
  }
}

inline bool aligned(const void* ptr, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) & (bytes - 1)) == 0;
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

// The packed int4 wire's sections for n entries: code bytes, padding.
static inline void wire_sections(long long n, int64_t* cb, int* pad) {
  *cb = (n + 1) / 2;
  *pad = (int)((4 - (*cb % 4)) % 4);
}

// Encodes the flat float32 vector x of n entries into `wire` (4-byte
// aligned, (ceil(n/2) + pad + 4 * ceil(n/128)) bytes) on `stream` of
// `device`, and writes the local values to `local` unless it is null.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_quantize_pack_int4(const float* x, uint8_t* wire,
                                        float* local, long long n,
                                        float inv_levels, float levels,
                                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  if (reinterpret_cast<uintptr_t>(wire) & 3u)
    return (int)cudaErrorMisalignedAddress;
  int64_t cb;
  int pad;
  wire_sections(n, &cb, &pad);
  const int64_t nb = (n + BLOCK - 1) / BLOCK;
  const int64_t n_oct = nb * (BLOCK / 8);
  const bool vec = aligned16(x) && (local == nullptr || aligned16(local));
  quantize_pack_int4_kernel<<<grid_for((n_oct + 31) / 32 * 32), THREADS, 0,
                              (cudaStream_t)stream>>>(
      x, wire, reinterpret_cast<float*>(wire + cb + pad), local, n, n_oct,
      cb, pad, vec, inv_levels, levels);
  return (int)cudaGetLastError();
}

// Decodes the packed int4 wire of n entries (4-byte aligned) into the
// float32 vector `out` on `stream` of `device`. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int repro_unpack_dequantize_int4(const uint8_t* wire, float* out,
                                            long long n, int device,
                                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  if (reinterpret_cast<uintptr_t>(wire) & 3u)
    return (int)cudaErrorMisalignedAddress;
  int64_t cb;
  int pad;
  wire_sections(n, &cb, &pad);
  const int64_t n_quad = (n + 3) / 4;
  unpack_dequantize_int4_kernel<<<grid_for(n_quad), THREADS, 0,
                                  (cudaStream_t)stream>>>(
      wire, reinterpret_cast<const float*>(wire + cb + pad), out, n, n_quad,
      cb, aligned16(out));
  return (int)cudaGetLastError();
}

// Sums the k gathered wires of one region of n entries (row j at `wire +
// j * stride` bytes; 4-byte aligned rows) weighted by the device mask `m`
// (k,) into the float32 vector `out` on `stream` of `device`. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_unpack_dequantize_reduce(const uint8_t* wire,
                                              long long stride,
                                              const float* m, float* out,
                                              int k, long long n,
                                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  if (k <= 0 || !aligned(wire, 4) || (stride & 3))
    return (int)cudaErrorMisalignedAddress;
  int64_t cb;
  int pad;
  wire_sections(n, &cb, &pad);
  const int64_t n_quad = (n + 3) / 4;
  unpack_dequantize_reduce_kernel<<<grid_for(n_quad), THREADS, 0,
                                    (cudaStream_t)stream>>>(
      wire, stride, cb + pad, m, out, k, n, n_quad, cb, aligned16(out));
  return (int)cudaGetLastError();
}

// quantize_int4 over `rows` blocks of 128 float32 entries: int8 codes
// (rows, 128) and float32 scales (rows,). Returns the launch's error.
extern "C" int repro_quantize_int4(const float* x, int8_t* codes,
                                   float* scales, long long rows,
                                   float inv_levels, float levels,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0) return (int)cudaSuccess;
  quantize_int4_kernel<<<grid_for(rows * 32), THREADS, 0,
                         (cudaStream_t)stream>>>(
      x, codes, scales, rows, aligned16(x) && aligned(codes, 4), inv_levels,
      levels);
  return (int)cudaGetLastError();
}

// dequantize_int4 of (rows, 128) int8 codes by the rows' float32 scales.
extern "C" int repro_dequantize_int4(const int8_t* codes,
                                     const float* scales, float* out,
                                     long long rows, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0) return (int)cudaSuccess;
  const int64_t n_quad = rows * 32;
  dequantize_int4_kernel<<<grid_for(n_quad), THREADS, 0,
                           (cudaStream_t)stream>>>(
      codes, scales, out, n_quad, aligned(codes, 4) && aligned16(out));
  return (int)cudaGetLastError();
}

// pack_int4 of (rows, 128) int8 codes into (rows, 64) bytes.
extern "C" int repro_pack_int4(const int8_t* codes, uint8_t* out,
                               long long rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0) return (int)cudaSuccess;
  const int64_t n_oct = rows * 16;
  pack_int4_kernel<<<grid_for(n_oct), THREADS, 0, (cudaStream_t)stream>>>(
      codes, out, n_oct, aligned(codes, 8) && aligned(out, 4));
  return (int)cudaGetLastError();
}

// unpack_int4 of (rows, 64) bytes into (rows, 128) int8 codes.
extern "C" int repro_unpack_int4(const uint8_t* in, int8_t* out,
                                 long long rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0) return (int)cudaSuccess;
  const int64_t n_quad = rows * 16;
  unpack_int4_kernel<<<grid_for(n_quad), THREADS, 0,
                       (cudaStream_t)stream>>>(
      in, out, n_quad, aligned(in, 4) && aligned(out, 8));
  return (int)cudaGetLastError();
}
