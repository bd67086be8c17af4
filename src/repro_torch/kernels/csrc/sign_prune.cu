// Per-neuron sign pruning of outer gradients, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sign_prune.py:sign_prune (body
// _prune_kernel). For each row of an (R, C) float32 matrix:
//   1. elect the sign: +1 if pos >= neg, else -1, where pos and neg are
//      the sums of |x| over the positive and the negative entries;
//   2. find the magnitude threshold by exactly 26 bisection steps from
//      lo = 0, hi = max|x| * f32(1 + 1e-6) + f32(1e-30):
//        mid = 0.5 * (lo + hi); if count(|x| >= mid) > keep: lo = mid
//        else hi = mid;
//   3. keep x where sign(x) equals the elected sign and |x| >= hi, zero
//      it elsewhere (0 has sign 0: it agrees with neither sign).
// keep = max(round((1 - frac) * C), 1) is computed by the caller.
//
// What the TPU layout does not survive: the Pallas kernel holds block_rows
// whole rows in VMEM. The port's rows are a leaf's leading dim against the
// rest, and their lengths differ by four orders of magnitude (diloco_150m:
// 896 columns for the embedding and the norms, 32000 for the head,
// 917,504 for the attention weights, 3,211,264 = 12.8 MB for the MLP
// weights, far beyond one SM's 228 KB of shared memory). So two regimes:
//   * resident rows (C <= the caller's limit): one block per row; the row
//     is read from memory once into shared memory, and the 28 sweeps
//     (statistics, 26 counts, the mask) run over shared memory, each
//     closed by a block reduction; one launch;
//   * long rows: a (chunks, rows) grid of blocks shares each row. A
//     statistics launch writes each chunk's partial pos, neg and max; each
//     of the 26 count launches first rebuilds (lo, hi) from the previous
//     launch's per-chunk integer counts and the previous (lo, hi), the same
//     in every block of the row, then counts its chunk at the new mid; the
//     mask launch does the last step and writes the row. 28 launches, each
//     a pass over the matrix (in L2 where it fits).
// Per-row float sums are taken in a fixed order (per thread, then a
// shuffle tree, then across warps, then across chunks in order), so a run
// repeats itself; counts are integers and the max is exact, so the
// threshold does not depend on the order at all. The sign election differs
// from another summation order only on a row whose two masses tie to the
// last bit.
//
// Arithmetic: the bisection's f32 adds and multiplies, and hi0's multiply
// then add, round as in the plain PyTorch version (built with
// --fmad=false: no contraction), so the threshold and the output agree bit
// for bit with kernels/ref.py. A NaN in a row makes its max NaN (as
// torch.amax does), every comparison false, and the row all zeros.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ITERS = 26;
constexpr int LONG_THREADS = 256;

// max that propagates NaN, as torch.amax and jnp.max do
__device__ __forceinline__ float nanmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

struct Stats {
  float pos, neg, mx;
};

__device__ __forceinline__ void add_stat(Stats& s, float a) {
  float mg = fabsf(a);
  if (a > 0.0f) s.pos += mg;
  if (a < 0.0f) s.neg += mg;
  s.mx = nanmax(s.mx, mg);
}

__device__ __forceinline__ Stats warp_stats(Stats s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s.pos += __shfl_down_sync(0xffffffffu, s.pos, o);
    s.neg += __shfl_down_sync(0xffffffffu, s.neg, o);
    s.mx = nanmax(s.mx, __shfl_down_sync(0xffffffffu, s.mx, o));
  }
  return s;
}

__device__ __forceinline__ int warp_sum(int c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  return c;
}

// Block-wide sums of Stats, in a fixed order; the result is returned to
// every thread. `buf` holds one Stats per warp. blockDim.x % 32 == 0.
__device__ Stats block_stats(Stats s, Stats* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  s = warp_stats(s);
  __syncthreads();                 // buf may still be read from a last use
  if (lane == 0) buf[warp] = s;
  __syncthreads();
  if (warp == 0) {
    Stats t = lane < warps ? buf[lane] : Stats{0.0f, 0.0f, 0.0f};
    t = warp_stats(t);
    if (lane == 0) buf[0] = t;
  }
  __syncthreads();
  return buf[0];
}

__device__ int block_count(int c, int* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  c = warp_sum(c);
  __syncthreads();
  if (lane == 0) buf[warp] = c;
  __syncthreads();
  if (warp == 0) {
    int t = lane < warps ? buf[lane] : 0;
    t = warp_sum(t);
    if (lane == 0) buf[0] = t;
  }
  __syncthreads();
  return buf[0];
}

__device__ __forceinline__ float hi0(float mx, float scale, float floor_) {
  return mx * scale + floor_;
}

__device__ __forceinline__ void bisect_step(float& lo, float& hi, float mid,
                                            long long cnt, long long keep) {
  if (cnt > keep) lo = mid;
  else hi = mid;
}

__device__ __forceinline__ float masked(float a, float elected, float hi) {
  const bool agrees = elected > 0.0f ? a > 0.0f : a < 0.0f;
  return (agrees && fabsf(a) >= hi) ? a : 0.0f;
}

// ---------------------------------------------------------------------------
// resident rows: one block per row, the row in shared memory
// ---------------------------------------------------------------------------

__global__ void prune_resident(const float* x, float* out, int64_t cols,
                               long long keep, float scale, float floor_,
                               float* row_sign, float* row_hi) {
  extern __shared__ float row[];
  __shared__ Stats sbuf[32];
  __shared__ int cbuf[32];
  const int64_t r = blockIdx.x;
  const float* xr = x + r * cols;
  Stats s{0.0f, 0.0f, 0.0f};
  for (int64_t j = threadIdx.x; j < cols; j += blockDim.x) {
    float a = xr[j];
    row[j] = a;
    add_stat(s, a);
  }
  s = block_stats(s, sbuf);        // its barriers also publish `row`
  float lo = 0.0f, hi = hi0(s.mx, scale, floor_);
  for (int it = 0; it < ITERS; ++it) {
    const float mid = 0.5f * (lo + hi);
    int c = 0;
    for (int64_t j = threadIdx.x; j < cols; j += blockDim.x)
      c += fabsf(row[j]) >= mid;
    bisect_step(lo, hi, mid, block_count(c, cbuf), keep);
  }
  const float elected = s.pos >= s.neg ? 1.0f : -1.0f;
  if (threadIdx.x == 0 && row_sign != nullptr) {
    row_sign[r] = elected;
    row_hi[r] = hi;
  }
  float* outr = out + r * cols;
  for (int64_t j = threadIdx.x; j < cols; j += blockDim.x)
    outr[j] = masked(row[j], elected, hi);
}

// ---------------------------------------------------------------------------
// long rows: grid (chunks, rows); per-chunk partials in a workspace
// ---------------------------------------------------------------------------

struct Long {
  const float* x;
  float* out;
  int64_t cols, chunk;
  int chunks;
  long long keep;
  float scale, floor_;
  Stats* stats;                    // (rows, chunks)
  int* cnt;                        // (2, rows, chunks), by step parity
  float2* lohi;                    // (2, rows): (lo, hi) by step parity
  int64_t rows;
  float* row_sign;                 // (rows,) or null
  float* row_hi;                   // (rows,) or null
};

__device__ __forceinline__ int64_t chunk_begin(const Long& a) {
  return (int64_t)blockIdx.x * a.chunk;
}
__device__ __forceinline__ int64_t chunk_end(const Long& a) {
  int64_t e = chunk_begin(a) + a.chunk;
  return e < a.cols ? e : a.cols;
}

__global__ void long_stats(Long a) {
  __shared__ Stats sbuf[32];
  const int64_t r = blockIdx.y;
  const float* xr = a.x + r * a.cols;
  Stats s{0.0f, 0.0f, 0.0f};
  for (int64_t j = chunk_begin(a) + threadIdx.x; j < chunk_end(a);
       j += blockDim.x)
    add_stat(s, xr[j]);
  s = block_stats(s, sbuf);
  if (threadIdx.x == 0) a.stats[r * a.chunks + blockIdx.x] = s;
}

// The row's totals over its chunks, in chunk order within each lane, then
// a shuffle tree: warp 0 computes, every thread gets the result.
__device__ Stats row_totals(const Long& a, int64_t r, Stats* buf) {
  if (threadIdx.x < 32) {
    Stats t{0.0f, 0.0f, 0.0f};
    for (int c = threadIdx.x; c < a.chunks; c += 32) {
      Stats u = a.stats[r * a.chunks + c];
      t.pos += u.pos;
      t.neg += u.neg;
      t.mx = nanmax(t.mx, u.mx);
    }
    t = warp_stats(t);
    if (threadIdx.x == 0) buf[0] = t;
  }
  __syncthreads();
  return buf[0];
}

// (lo, hi) before count step `it`: from the statistics for it = 0, else by
// the decision of step it - 1 from its (lo, hi) and its per-chunk counts.
__device__ float2 state_before(const Long& a, int it, int64_t r, Stats* sbuf,
                               int* cbuf) {
  if (it == 0) {
    Stats t = row_totals(a, r, sbuf);
    return make_float2(0.0f, hi0(t.mx, a.scale, a.floor_));
  }
  const int par = (it - 1) & 1;
  if (threadIdx.x < 32) {
    const int* cnt = a.cnt + (par * a.rows + r) * a.chunks;
    int c = 0;
    for (int k = threadIdx.x; k < a.chunks; k += 32) c += cnt[k];
    c = warp_sum(c);
    if (threadIdx.x == 0) cbuf[0] = c;
  }
  __syncthreads();
  float2 s = a.lohi[par * a.rows + r];
  const float mid = 0.5f * (s.x + s.y);
  bisect_step(s.x, s.y, mid, cbuf[0], a.keep);
  return s;
}

__global__ void long_count(Long a, int it, bool vec) {
  __shared__ Stats sbuf[32];
  __shared__ int cbuf[32];
  const int64_t r = blockIdx.y;
  const float2 s = state_before(a, it, r, sbuf, cbuf);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    a.lohi[(it & 1) * a.rows + r] = s;
  const float mid = 0.5f * (s.x + s.y);
  const float* xr = a.x + r * a.cols;
  int c = 0;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int64_t j = chunk_begin(a) / 4 + threadIdx.x; j < chunk_end(a) / 4;
         j += blockDim.x) {
      float4 t = x4[j];
      c += (fabsf(t.x) >= mid) + (fabsf(t.y) >= mid) + (fabsf(t.z) >= mid) +
           (fabsf(t.w) >= mid);
    }
  } else {
    for (int64_t j = chunk_begin(a) + threadIdx.x; j < chunk_end(a);
         j += blockDim.x)
      c += fabsf(xr[j]) >= mid;
  }
  c = block_count(c, cbuf);
  if (threadIdx.x == 0)
    a.cnt[((it & 1) * a.rows + r) * a.chunks + blockIdx.x] = c;
}

__global__ void long_mask(Long a) {
  __shared__ Stats sbuf[32];
  __shared__ int cbuf[32];
  const int64_t r = blockIdx.y;
  const float hi = state_before(a, ITERS, r, sbuf, cbuf).y;
  const Stats t = row_totals(a, r, sbuf);
  const float elected = t.pos >= t.neg ? 1.0f : -1.0f;
  if (blockIdx.x == 0 && threadIdx.x == 0 && a.row_sign != nullptr) {
    a.row_sign[r] = elected;
    a.row_hi[r] = hi;
  }
  const float* xr = a.x + r * a.cols;
  float* outr = a.out + r * a.cols;
  for (int64_t j = chunk_begin(a) + threadIdx.x; j < chunk_end(a);
       j += blockDim.x)
    outr[j] = masked(xr[j], elected, hi);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Prunes each of `rows` rows of `cols` float32 entries with the row held in
// shared memory (cols * 4 bytes of it, at most the card's opt-in limit):
// one launch, one block of `threads` threads per row (a multiple of 32, at
// most 1024). `out` may be `x`. When `row_sign` is not null, each row's
// elected sign and final threshold hi are written to row_sign[r] and
// row_hi[r]. Returns the cudaError_t (0 on success).
extern "C" int repro_sign_prune_resident_f32(
    const float* x, float* out, long long rows, long long cols,
    long long keep, float scale, float floor_, int threads, float* row_sign,
    float* row_hi, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0 || cols <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)cols * sizeof(float);
  err = cudaFuncSetAttribute(prune_resident,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  prune_resident<<<(unsigned)rows, threads, smem, (cudaStream_t)stream>>>(
      x, out, (int64_t)cols, keep, scale, floor_, row_sign, row_hi);
  return (int)cudaGetLastError();
}

// Prunes long rows: `chunk` entries per block (a multiple of 4), a
// workspace of rows * chunks Stats (12 B each), 2 * rows * chunks ints and
// 2 * rows float2, where chunks = ceil(cols / chunk). 28 launches
// (statistics, 26 counts, mask) on `stream`, in order; rows <= 65535.
// `out` may be `x`; `row_sign`, `row_hi` as for the resident form. Returns
// the first cudaError_t (0 on success).
extern "C" int repro_sign_prune_long_f32(
    const float* x, float* out, long long rows, long long cols,
    long long keep, float scale, float floor_, long long chunk, void* stats,
    void* cnt, void* lohi, float* row_sign, float* row_hi, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0 || cols <= 0) return (int)cudaSuccess;
  Long a;
  a.x = x;
  a.out = out;
  a.cols = cols;
  a.chunk = chunk;
  a.chunks = (int)((cols + chunk - 1) / chunk);
  a.keep = keep;
  a.scale = scale;
  a.floor_ = floor_;
  a.stats = static_cast<Stats*>(stats);
  a.cnt = static_cast<int*>(cnt);
  a.lohi = static_cast<float2*>(lohi);
  a.rows = rows;
  a.row_sign = row_sign;
  a.row_hi = row_hi;
  const bool vec = aligned16(x) && cols % 4 == 0 && chunk % 4 == 0;
  const dim3 grid((unsigned)a.chunks, (unsigned)rows);
  cudaStream_t st = (cudaStream_t)stream;
  long_stats<<<grid, LONG_THREADS, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int it = 0; it < ITERS; ++it) {
    long_count<<<grid, LONG_THREADS, 0, st>>>(a, it, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  long_mask<<<grid, LONG_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}
