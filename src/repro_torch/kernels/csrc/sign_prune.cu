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
// What bounds it: bytes. Each entry has to be read once and written once;
// the work per entry is a few compares. The TPU kernel holds block_rows
// whole rows in VMEM and sweeps them 28 times. The port's rows are a
// leaf's leading dim against the rest, from 896 to 3,211,264 columns
// (12.8 MB, far beyond an SM's 228 KB), so three regimes:
//   * warp rows (C <= WARP_MAX_COLS): one warp a row, the row in
//     registers (at most 32 entries a lane), 8 rows a block; the
//     statistics and the 26 counts are warp reductions, no barrier;
//   * block rows (other rows up to the caller's resident limit): one
//     block a row, the row in shared memory, the threshold from the
//     multi-level resolve below (three block histograms instead of 26
//     block count reductions);
//   * long rows: a (chunks, rows) grid of blocks shares each row, and the
//     row is streamed from device memory five times in five launches:
//     statistics, three count passes (9, 9 and 8 levels), the mask.
//
// The multi-level resolve. From any (lo, hi), the mids that the next b
// bisection steps can visit are the 2^b - 1 nodes of a binary tree. In
// order of position k = 1 .. 2^b - 1 (t[0] = lo, t[2^b] = hi), node k of
// half width s (its lowest set bit) is t[k] = 0.5 * (t[k - s] + t[k + s]),
// the plain version's own f32 arithmetic on the same operands, and lies
// in [t[k - s], t[k + s]]: the table is sorted. (Where an interval's ends
// add past FLT_MAX its mid is infinite: that happens only while hi is
// still hi0, on the tree's right edge, so the infinities are the table's
// tail, and no entry reaches them: hi0 is above the row's max.) One pass
// bins each |x| in [lo, hi) by the number of nodes it reaches,
// bin(|x|) = #{k : t[k] <= |x|}, and puts |x| >= hi in the top bin; then
// count(|x| >= t[k]) is the sum of the bins >= k, exactly, for every node,
// and a walk down the tree takes the b decisions that the 26-step loop
// takes. The bins are integers, so blocks add theirs into a per-row
// histogram with atomics and the result does not depend on their order.
// Passes after the first bin only the entries inside (lo, hi), about
// 1 / 2^b of a row. A row whose max is NaN or infinite is not binned: its
// threshold is NaN or infinite whatever the counts. An entry's bin comes
// from the index estimate e = (|x| - lo) 2^b / (hi - lo): floor(e), where
// e is further from an integer than the table's measured distance from
// the even grid (plus the estimate's rounding), which needs no table
// look-up; else corrected against the table; a b-step search where (lo,
// hi) is too narrow for an estimate.
//
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
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ITERS = 26;
// The resolve's passes: 9, 9 and 8 of the 26 bisection steps each, bins
// for the widest.
constexpr int PASSES = 3;
constexpr int NB = 512;

__host__ __device__ constexpr int levels(int pass) {
  return pass + 1 < PASSES ? 9 : 8;
}
static_assert((PASSES - 1) * levels(0) + levels(PASSES - 1) == ITERS &&
                  (1 << levels(0)) == NB,
              "the passes resolve the 26 steps, NB bins for the widest");

constexpr int LONG_THREADS = 256;
constexpr int WARP_MAX_COLS = 1024;         // warp rows: 32 entries a lane
constexpr int WARP_ROWS = 8;                // warp rows a block
constexpr int WARP_MIN_BLOCKS = 4;          // warp-row blocks an SM: 64 regs
constexpr int BATCH = 4;                    // loads in flight a thread
constexpr unsigned FULL = 0xffffffffu;

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

__device__ __forceinline__ void merge(Stats& s, const Stats& u) {
  s.pos += u.pos;
  s.neg += u.neg;
  s.mx = nanmax(s.mx, u.mx);
}

// A warp's Stats summed down a shuffle tree, the result in lane 0.
__device__ __forceinline__ Stats warp_stats(Stats s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s.pos += __shfl_down_sync(FULL, s.pos, o);
    s.neg += __shfl_down_sync(FULL, s.neg, o);
    s.mx = nanmax(s.mx, __shfl_down_sync(FULL, s.mx, o));
  }
  return s;
}

// The sum of c over the warp, in every lane.
__device__ __forceinline__ unsigned warp_sum(unsigned c) {
  return __reduce_add_sync(FULL, c);
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

__device__ __forceinline__ float hi0(float mx, float scale, float floor_) {
  return mx * scale + floor_;
}

__device__ __forceinline__ float masked(float a, float elected, float hi) {
  const bool agrees = elected > 0.0f ? a > 0.0f : a < 0.0f;
  return (agrees && fabsf(a) >= hi) ? a : 0.0f;
}

// ---------------------------------------------------------------------------
// the multi-level resolve
// ---------------------------------------------------------------------------

// t[0 .. 2^b]: lo, the 2^b - 1 nodes of the next b bisection steps from
// (lo, hi) in order, hi. Each node is computed as the plain loop reaches
// it: descending from the root, mid = 0.5 * (lo + hi) at every step. The
// nodes' largest distance from the even grid lo + k (hi - lo) / 2^b
// (rounded up to a float; NaN or infinite where the grid is) goes into
// *dev by a warp max and one atomicMax a warp: the index estimate's
// margin.
__device__ void build_table(float* t, int b, float lo, float hi,
                            unsigned* dev) {
  const int n = 1 << b;
  const double w = (double)hi - (double)lo;
  unsigned dmax = 0;               // d >= 0 or NaN: their bits order
  for (int k = threadIdx.x; k <= n; k += blockDim.x) {
    if (k == 0 || k == n) {
      t[k] = k == 0 ? lo : hi;
      continue;
    }
    float l = lo, h = hi;
    for (int pos = n >> 1, s = n >> 2;; s >>= 1) {
      const float mid = 0.5f * (l + h);
      if (pos == k) {
        t[k] = mid;
        const double g = (double)lo + (double)k * (w * (1.0 / n));
        const float d = __double2float_ru(fabs((double)mid - g));
        dmax = max(dmax, __float_as_uint(d));
        break;
      }
      if (k > pos) {
        l = mid;
        pos += s;
      } else {
        h = mid;
        pos -= s;
      }
    }
  }
  dmax = __reduce_max_sync(FULL, dmax);
  if ((threadIdx.x & 31) == 0) atomicMax(dev, dmax);
}

// How a pass bins an entry a in [lo, hi): the table t of its b levels;
// with `est`, from the index estimate e = (a - lo) * inv: floor(e) where
// e lies more than `margin` from an integer (the nodes' distance from the
// even grid plus the estimate's own rounding, 4 ulps of 2^b: then every
// node is on the side of a that floor(e) says), else corrected against
// the table (exact from any start); without `est`, by a b-step search of
// the table. The estimate needs (lo, hi) wider than 2^-10 of hi and 2^-100
// (no subnormal rounding); its floor is used where the margin is < 0.25.
struct Pass {
  const float* t;
  int b;
  float lo, hi, inv, margin;
  bool est;
};

__device__ __forceinline__ Pass make_pass(const float* t, int b, float lo,
                                          float hi, unsigned dev) {
  Pass p{t, b, lo, hi, 0.0f, 1.0f, false};
  const float w = hi - lo;
  if (isfinite(w) && w > hi * 0x1p-10f && w > 0x1p-100f) {
    p.est = true;
    p.inv = (float)(1 << b) / w;
    // in grid steps: inv's own rounding covered by 2^-20
    const float m = __uint_as_float(dev) * p.inv * (1.0f + 0x1p-20f) +
                    (float)(1 << b) * 0x1p-21f;
    if (m < 0.25f) p.margin = m;                  // NaN: no floor
  }
  return p;
}

// bin(a) = #{k in 1 .. 2^b - 1 : t[k] <= a} of the sorted table.
__device__ __forceinline__ int bin_of(const Pass& p, float a) {
  const int n = (1 << p.b) - 1;
  int j = 0;
  if (p.est) {
    const float e = (a - p.lo) * p.inv;
    const float f = floorf(e);
    const float r = e - f;
    if (r > p.margin && r < 1.0f - p.margin) return min((int)f, n);
    j = (int)fminf(fmaxf(e, 0.0f), (float)n);
    while (j < n && p.t[j + 1] <= a) ++j;
    while (j > 0 && p.t[j] > a) --j;
  } else {
    for (int s = 1 << (p.b - 1); s >= 1; s >>= 1)
      if (p.t[j + s] <= a) j += s;
  }
  return j;
}

// One warp (all 32 lanes): b bisection steps from (lo, hi), each count
// read off the pass's histogram h of 2^b bins (bin k: the entries that
// reach exactly k nodes; bin 2^b - 1 also holds those >= hi). At node k of
// half width s, count(|x| >= t[k]) = (the count at the interval's upper
// end) + h[k] + ... + h[k + s - 1].
__device__ float2 walk(const unsigned* h, int b, float lo, float hi,
                       long long keep) {
  const int lane = threadIdx.x & 31;
  unsigned above = 0;
  int k = 1 << (b - 1);
  for (int s = 1 << (b - 1); s >= 1; s >>= 1) {
    const float mid = 0.5f * (lo + hi);
    unsigned part = 0;
    for (int j = lane; j < s; j += 32) part += h[k + j];
    part = warp_sum(part);
    const unsigned c = above + part;
    if ((long long)c > keep) {
      lo = mid;
      k += s >> 1;
    } else {
      hi = mid;
      above = c;
      k -= s >> 1;
    }
  }
  return make_float2(lo, hi);
}

// Bins one entry of pass p into `h` (shared memory), or counts it in
// `above` when it is >= hi.
__device__ __forceinline__ void bin_entry(float v, const Pass& p,
                                          unsigned* h, unsigned& above) {
  const float m = fabsf(v);
  if (m >= p.hi) {
    ++above;
  } else if (m >= p.lo) {
    const int j = bin_of(p, m);
    if (j) atomicAdd(&h[j], 1u);
  }
}

// ---------------------------------------------------------------------------
// warp rows: one warp a row, the row in registers
// ---------------------------------------------------------------------------

// EPL >= cols / 32 entries a lane.
template <int EPL>
__global__ void __launch_bounds__(32 * WARP_ROWS, WARP_MIN_BLOCKS)
    prune_warp_rows(const float* x, float* out, int64_t rows, int cols,
                    long long keep, float scale, float floor_,
                    float* row_sign, float* row_hi) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * WARP_ROWS + (threadIdx.x >> 5);
  if (r >= rows) return;                    // the whole warp
  const float* xr = x + r * cols;
  // every load issued before any is used (from an address inside the
  // row, past its end the last entry's, replaced by NaN, which no count
  // takes)
  float v[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i)
    v[i] = xr[min(lane + 32 * i, cols - 1)];
  Stats s{0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    if (lane + 32 * i < cols) add_stat(s, v[i]);
    else v[i] = __int_as_float(0x7fc00000);
  }
  s = warp_stats(s);
  const float pos = __shfl_sync(FULL, s.pos, 0);
  const float neg = __shfl_sync(FULL, s.neg, 0);
  float lo = 0.0f, hi = hi0(__shfl_sync(FULL, s.mx, 0), scale, floor_);
  for (int it = 0; it < ITERS; ++it) {
    const float mid = 0.5f * (lo + hi);
    unsigned c[4] = {0, 0, 0, 0};  // four chains of adds, not one
#pragma unroll
    for (int i = 0; i < EPL; ++i) c[i % 4] += fabsf(v[i]) >= mid;
    const unsigned n = warp_sum(c[0] + c[1] + c[2] + c[3]);
    if ((long long)n > keep) lo = mid;
    else hi = mid;
  }
  const float elected = pos >= neg ? 1.0f : -1.0f;
  if (lane == 0 && row_sign != nullptr) {
    row_sign[r] = elected;
    row_hi[r] = hi;
  }
  float* outr = out + r * cols;
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const int j = lane + 32 * i;
    if (j < cols) outr[j] = masked(v[i], elected, hi);
  }
}

// ---------------------------------------------------------------------------
// the resolve over the entries a block holds: three passes
// ---------------------------------------------------------------------------

// A block's resolve state, at the start of its dynamic shared memory: the
// table, the histogram (or a copy of the previous pass's), the walk's
// result and the table's distance from its grid.
struct Resolve {
  float t[NB + 1];
  unsigned h[NB];
  float2 state;
  unsigned dev;
};
constexpr size_t RESOLVE_SMEM = (sizeof(Resolve) + 15) / 16 * 16;

// The threshold of the row whose entries this block holds, for every
// thread: `each(f)` calls f(v) on each entry the thread holds (NaN
// padding counts nowhere). sh.dev is 0 and published on entry.
template <class Each>
__device__ float block_resolve(Each each, float hi, long long keep,
                               Resolve& sh) {
  float lo = 0.0f;
  for (int p = 0; p < PASSES; ++p) {
    const int b = levels(p), n = (1 << b) - 1;
    build_table(sh.t, b, lo, hi, &sh.dev);
    for (int i = threadIdx.x; i < NB; i += blockDim.x) sh.h[i] = 0;
    __syncthreads();
    if (isfinite(hi)) {
      const Pass pass = make_pass(sh.t, b, lo, hi, sh.dev);
      unsigned above = 0;
      each([&](float v) { bin_entry(v, pass, sh.h, above); });
      above = warp_sum(above);
      if ((threadIdx.x & 31) == 0 && above) atomicAdd(&sh.h[n], above);
    }
    __syncthreads();               // every thread has read sh.dev
    if (threadIdx.x < 32) {
      const float2 w = walk(sh.h, b, lo, hi, keep);
      if (threadIdx.x == 0) {
        sh.state = w;
        sh.dev = 0;                // for the next pass's table
      }
    }
    __syncthreads();
    lo = sh.state.x;
    hi = sh.state.y;
  }
  return hi;
}

// ---------------------------------------------------------------------------
// block rows: one block a row, the row in shared memory after the resolve
// ---------------------------------------------------------------------------

__global__ void prune_block_rows(const float* x, float* out, int64_t cols,
                                 bool vec, long long keep, float scale,
                                 float floor_, float* row_sign,
                                 float* row_hi) {
  extern __shared__ float4 smem[];
  Resolve& sh = *reinterpret_cast<Resolve*>(smem);
  float4* row4 = smem + RESOLVE_SMEM / sizeof(float4);
  float* row = reinterpret_cast<float*>(row4);
  __shared__ Stats sbuf[32];
  const int64_t r = blockIdx.x;
  if (threadIdx.x == 0) sh.dev = 0;
  const float* xr = x + r * cols;
  Stats s{0.0f, 0.0f, 0.0f};
  // BATCH loads in flight a thread, each batch issued before it is used
  const int64_t step = blockDim.x;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const int64_t n4 = cols / 4;
    for (int64_t j = threadIdx.x; j < n4; j += BATCH * step) {
      float4 v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (j + u * step < n4) v[u] = x4[j + u * step];
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (j + u * step < n4) {
          row4[j + u * step] = v[u];
          add_stat(s, v[u].x);
          add_stat(s, v[u].y);
          add_stat(s, v[u].z);
          add_stat(s, v[u].w);
        }
    }
  } else {
    for (int64_t j = threadIdx.x; j < cols; j += BATCH * step) {
      float v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (j + u * step < cols) v[u] = xr[j + u * step];
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (j + u * step < cols) {
          row[j + u * step] = v[u];
          add_stat(s, v[u]);
        }
    }
  }
  s = block_stats(s, sbuf);        // its barriers also publish `row`
  const float hi = block_resolve(
      [&](auto f) {
        for (int64_t j = threadIdx.x; j < cols; j += blockDim.x) f(row[j]);
      },
      hi0(s.mx, scale, floor_), keep, sh);
  const float elected = s.pos >= s.neg ? 1.0f : -1.0f;
  if (threadIdx.x == 0 && row_sign != nullptr) {
    row_sign[r] = elected;
    row_hi[r] = hi;
  }
  float* outr = out + r * cols;
  if (vec) {
    float4* o4 = reinterpret_cast<float4*>(outr);
    for (int64_t j = threadIdx.x; j < cols / 4; j += blockDim.x) {
      const float4 v = row4[j];
      o4[j] = make_float4(masked(v.x, elected, hi), masked(v.y, elected, hi),
                          masked(v.z, elected, hi), masked(v.w, elected, hi));
    }
  } else {
    for (int64_t j = threadIdx.x; j < cols; j += blockDim.x)
      outr[j] = masked(row[j], elected, hi);
  }
}

// ---------------------------------------------------------------------------
// long rows: grid (chunks, rows); per-chunk statistics and per-row
// histograms in a workspace
// ---------------------------------------------------------------------------

struct Long {
  const float* x;
  float* out;
  int64_t cols, chunk, rows;
  int chunks;
  bool vec;                        // float4 loads and stores
  long long keep;
  float scale, floor_;
  Stats* stats;                    // (rows, chunks)
  unsigned* hist;                  // (PASSES, rows, NB)
  float2* lohi;                    // (PASSES, rows): (lo, hi) at each pass
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

// f(j, x4[j]) over this block's chunk of row r as float4s (the row
// 16-byte aligned), in a fixed order per thread: BATCH loads issued
// before any is used.
template <class F>
__device__ __forceinline__ void each4(const Long& a, int64_t r, F f) {
  const float4* x4 = reinterpret_cast<const float4*>(a.x + r * a.cols);
  const int64_t e = chunk_end(a) / 4, step = blockDim.x;
  for (int64_t j = chunk_begin(a) / 4 + threadIdx.x; j < e;
       j += BATCH * step) {
    float4 v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (j + u * step < e) v[u] = x4[j + u * step];
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (j + u * step < e) f(j + u * step, v[u]);
  }
}

// f(value) over this block's chunk of row r, in a fixed order per thread.
template <class F>
__device__ __forceinline__ void each(const Long& a, int64_t r, F f) {
  if (a.vec) {
    each4(a, r, [&](int64_t, float4 v) {
      f(v.x);
      f(v.y);
      f(v.z);
      f(v.w);
    });
  } else {
    const float* xr = a.x + r * a.cols;
    for (int64_t j = chunk_begin(a) + threadIdx.x; j < chunk_end(a);
         j += blockDim.x)
      f(xr[j]);
  }
}

__device__ __forceinline__ unsigned* row_hist(const Long& a, int pass,
                                              int64_t r) {
  return a.hist + ((int64_t)pass * a.rows + r) * NB;
}

// Statistics of each chunk; the blocks of chunk 0 also zero their row's
// histograms for the count passes.
__global__ void long_stats(Long a) {
  __shared__ Stats sbuf[32];
  const int64_t r = blockIdx.y;
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < PASSES * NB; i += blockDim.x)
      row_hist(a, i / NB, r)[i % NB] = 0;
  Stats s{0.0f, 0.0f, 0.0f};
  if (a.vec) {                     // four chains of adds, one a component
    Stats sy = s, sz = s, sw = s;
    each4(a, r, [&](int64_t, float4 v) {
      add_stat(s, v.x);
      add_stat(sy, v.y);
      add_stat(sz, v.z);
      add_stat(sw, v.w);
    });
    merge(s, sy);
    merge(s, sz);
    merge(s, sw);
  } else {
    each(a, r, [&](float v) { add_stat(s, v); });
  }
  s = block_stats(s, sbuf);
  if (threadIdx.x == 0) a.stats[r * a.chunks + blockIdx.x] = s;
}

// The row's totals over its chunks, in chunk order within each lane, then
// a shuffle tree: warp 0 computes, every thread gets the result.
__device__ Stats row_totals(const Long& a, int64_t r, Stats* buf) {
  if (threadIdx.x < 32) {
    Stats t{0.0f, 0.0f, 0.0f};
    for (int c = threadIdx.x; c < a.chunks; c += 32)
      merge(t, a.stats[r * a.chunks + c]);
    t = warp_stats(t);
    if (threadIdx.x == 0) buf[0] = t;
  }
  __syncthreads();
  return buf[0];
}

// (lo, hi) at the start of pass `pass` (PASSES: after the last): from the
// statistics for pass 0, else by walking the previous pass's histogram
// (copied into sh.h in one round of loads) from its (lo, hi). The same in
// every block of the row.
__device__ float2 state_at(const Long& a, int pass, int64_t r, Stats* sbuf,
                           Resolve& sh) {
  if (pass == 0)
    return make_float2(0.0f, hi0(row_totals(a, r, sbuf).mx, a.scale,
                                 a.floor_));
  if (threadIdx.x < 32) {
    const unsigned* gh = row_hist(a, pass - 1, r);
    for (int i = threadIdx.x; i < NB; i += 32) sh.h[i] = gh[i];
    __syncwarp();
    const float2 s = a.lohi[(int64_t)(pass - 1) * a.rows + r];
    const float2 w = walk(sh.h, levels(pass - 1), s.x, s.y, a.keep);
    if (threadIdx.x == 0) sh.state = w;
  }
  __syncthreads();
  return sh.state;
}

__global__ void long_count(Long a, int pass) {
  extern __shared__ float4 smem[];
  Resolve& sh = *reinterpret_cast<Resolve*>(smem);
  __shared__ Stats sbuf[32];
  const int64_t r = blockIdx.y;
  if (threadIdx.x == 0) sh.dev = 0;   // published by state_at's barrier
  const float2 s = state_at(a, pass, r, sbuf, sh);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    a.lohi[(int64_t)pass * a.rows + r] = s;
  const float lo = s.x, hi = s.y;
  if (!isfinite(hi)) return;       // the threshold is hi's NaN or infinity
  const int b = levels(pass), n = (1 << b) - 1;
  build_table(sh.t, b, lo, hi, &sh.dev);
  for (int i = threadIdx.x; i < NB; i += blockDim.x) sh.h[i] = 0;
  __syncthreads();
  const Pass p = make_pass(sh.t, b, lo, hi, sh.dev);
  unsigned above = 0;
  each(a, r, [&](float v) { bin_entry(v, p, sh.h, above); });
  above = warp_sum(above);
  if ((threadIdx.x & 31) == 0 && above) atomicAdd(&sh.h[n], above);
  __syncthreads();
  unsigned* gh = row_hist(a, pass, r);
  for (int j = threadIdx.x + 1; j <= n; j += blockDim.x)
    if (sh.h[j]) atomicAdd(&gh[j], sh.h[j]);
}

__global__ void long_mask(Long a) {
  extern __shared__ float4 smem[];
  Resolve& sh = *reinterpret_cast<Resolve*>(smem);
  __shared__ Stats sbuf[32];
  const int64_t r = blockIdx.y;
  const float hi = state_at(a, PASSES, r, sbuf, sh).y;
  const Stats t = row_totals(a, r, sbuf);
  const float elected = t.pos >= t.neg ? 1.0f : -1.0f;
  if (blockIdx.x == 0 && threadIdx.x == 0 && a.row_sign != nullptr) {
    a.row_sign[r] = elected;
    a.row_hi[r] = hi;
  }
  float* outr = a.out + r * a.cols;
  if (a.vec) {
    float4* o4 = reinterpret_cast<float4*>(outr);
    each4(a, r, [&](int64_t j, float4 v) {
      o4[j] = make_float4(masked(v.x, elected, hi), masked(v.y, elected, hi),
                          masked(v.z, elected, hi), masked(v.w, elected, hi));
    });
  } else {
    const float* xr = a.x + r * a.cols;
    for (int64_t j = chunk_begin(a) + threadIdx.x; j < chunk_end(a);
         j += blockDim.x)
      outr[j] = masked(xr[j], elected, hi);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// The statistics, the PASSES count passes and the mask over `a.rows` rows,
// in order on `st`.
cudaError_t run_long(const Long& a, cudaStream_t st) {
  const dim3 grid((unsigned)a.chunks, (unsigned)a.rows);
  long_stats<<<grid, LONG_THREADS, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  for (int p = 0; p < PASSES && err == cudaSuccess; ++p) {
    long_count<<<grid, LONG_THREADS, RESOLVE_SMEM, st>>>(a, p);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  long_mask<<<grid, LONG_THREADS, RESOLVE_SMEM, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Prunes each of `rows` rows of `cols` float32 entries in one launch: a
// warp a row with the row in registers when cols <= WARP_MAX_COLS, else a
// block a row with the row in shared memory (cols * 4 bytes of it, at
// most the card's opt-in limit less ~4 KB of the resolve's). `out` may be
// `x`. When `row_sign` is not null, each row's elected sign and final
// threshold hi are written to row_sign[r] and row_hi[r]. Returns the
// cudaError_t (0 on success).
extern "C" int repro_sign_prune_resident_f32(
    const float* x, float* out, long long rows, long long cols,
    long long keep, float scale, float floor_, float* row_sign,
    float* row_hi, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0 || cols <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (cols <= WARP_MAX_COLS) {
    const unsigned blocks = (unsigned)((rows + WARP_ROWS - 1) / WARP_ROWS);
    const int epl = (int)((cols + 31) / 32);
    auto kernel = epl <= 4    ? prune_warp_rows<4>
                  : epl <= 8  ? prune_warp_rows<8>
                  : epl <= 16 ? prune_warp_rows<16>
                  : epl <= 28 ? prune_warp_rows<28>   // diloco's 896
                              : prune_warp_rows<WARP_MAX_COLS / 32>;
    kernel<<<blocks, 32 * WARP_ROWS, 0, st>>>(x, out, (int64_t)rows,
                                              (int)cols, keep, scale, floor_,
                                              row_sign, row_hi);
    return (int)cudaGetLastError();
  }
  const size_t smem = RESOLVE_SMEM + (size_t)cols * sizeof(float);
  const bool vec = aligned16(x) && aligned16(out) && cols % 4 == 0;
  err = cudaFuncSetAttribute(prune_block_rows,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  long long threads = 32 * ((cols + 255) / 256);   // ~8 entries a thread
  if (threads > 1024) threads = 1024;
  prune_block_rows<<<(unsigned)rows, (unsigned)threads, smem, st>>>(
      x, out, (int64_t)cols, vec, keep, scale, floor_, row_sign, row_hi);
  return (int)cudaGetLastError();
}

// CUDA launches of one long-row pruning.
extern "C" int repro_sign_prune_long_launches(void) { return PASSES + 2; }

// Bytes of the workspace that repro_sign_prune_long_f32 takes for `rows`
// rows of `cols` entries, `chunk` entries a block.
extern "C" long long repro_sign_prune_long_workspace(long long rows,
                                                     long long cols,
                                                     long long chunk) {
  const long long chunks = (cols + chunk - 1) / chunk;
  return (long long)(round16((size_t)rows * chunks * sizeof(Stats)) +
                     round16((size_t)PASSES * rows * NB * sizeof(unsigned)) +
                     round16((size_t)PASSES * rows * sizeof(float2)));
}

// Prunes long rows: `chunk` entries a block (a multiple of 4), a workspace
// of repro_sign_prune_long_workspace(rows, cols, chunk) bytes (16-byte
// aligned; no need to clear it), PASSES + 2 launches on `stream`, in
// order; rows <= 65535, cols < 2^31. `out` may be `x`; `row_sign`,
// `row_hi` as for the resident form. Returns the first cudaError_t (0 on
// success).
extern "C" int repro_sign_prune_long_f32(
    const float* x, float* out, long long rows, long long cols,
    long long keep, float scale, float floor_, long long chunk, void* work,
    float* row_sign, float* row_hi, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0 || cols <= 0) return (int)cudaSuccess;
  Long a;
  a.x = x;
  a.out = out;
  a.cols = cols;
  a.chunk = chunk;
  a.rows = rows;
  a.chunks = (int)((cols + chunk - 1) / chunk);
  a.vec = aligned16(x) && aligned16(out) && cols % 4 == 0 && chunk % 4 == 0;
  a.keep = keep;
  a.scale = scale;
  a.floor_ = floor_;
  char* w = static_cast<char*>(work);
  a.stats = reinterpret_cast<Stats*>(w);
  w += round16((size_t)rows * a.chunks * sizeof(Stats));
  a.hist = reinterpret_cast<unsigned*>(w);
  w += round16((size_t)PASSES * rows * NB * sizeof(unsigned));
  a.lohi = reinterpret_cast<float2*>(w);
  a.row_sign = row_sign;
  a.row_hi = row_hi;
  return (int)run_long(a, (cudaStream_t)stream);
}
