// Flash attention, forward and backward, float32, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py:
//   repro_flash_fwd_f32      flash_attention  (_attn_kernel): o only
//   repro_flash_fwd_lse_f32  _fwd_lse         (_attn_kernel_fwd): o and the
//                            per-row logsumexp lse = m + log(l)
//   repro_flash_bwd_dq_f32   _bwd, first call  (_bwd_dq_kernel)
//   repro_flash_bwd_dkv_f32  _bwd, second call (_bwd_dkv_kernel)
//
// Layout: q, o, dO, dq (B, H, Sq, D); k, v, dk, dv (B, G, Sk, D), H % G == 0,
// query head h reads kv head h / (H / G). Each tensor comes with its batch,
// head and sequence strides (elements; the last dim is contiguous, every
// row 16-byte aligned), so the model's (B, S, H, D) buffers are read in
// place. lse and delta = rowsum(dO * o) are contiguous (B, H, Sq).
//
// Semantics are those of the Pallas kernels, not their blocking: scores
// s = (q * scale) . k; a key at absolute position kp is visible from a
// query at qp = q_off + row iff kp < Sk, (causal) kp <= qp and (window)
// kp > qp - window, where q_off = q_offset + (Sk - Sq if causal and
// Sq != Sk); masked scores are -1e30 in the forward and p = 0 in the
// backward; tiles with no visible key are skipped. Rows past Sq and Sk
// are masked, never padded by a copy.
//
// The forward, flash_fwd_kernel: what bounds it is operations. At
// diloco_400m's layer (B 8, H = G = 12, S 1024, d 128, causal) it does 4 d
// flops per visible (query, key) pair, 25.8 GFLOP, against ~201 MB of
// device memory (0.060 ms at 3.35 TB/s). On f32 CUDA cores those flops
// take 0.385 ms at 67 TFLOP/s; this kernel runs them on the tensor cores
// as three TF32 products each, 77.4 GFLOP: 0.156 ms at the card's 495
// TFLOP/s, ~0.25 ms at the ~311 TFLOP/s that mma.sync reaches on an H100.
// The design:
//   * split TF32: each f32 operand x = big + small, big = rna(x), small =
//     rna(x - big) (rna: cvt.rna.tf32.f32's rounding), and each m16n8k8
//     product is three MMAs, big.small + small.big + big.big, into f32:
//     ~2^-22 of the product, where one TF32 pass (2^-11) misses the
//     kernels' 2e-5 tolerance 30-400 times over;
//   * the tensor cores round each MMA's sum toward zero, so S sums each
//     16-wide slice of d from zero and adds the slices in f32, and P V
//     sums each key tile from zero and folds it into O with the softmax
//     correction in one fmaf (one long accumulator chain drifted to 2e-5
//     from the plain version with scores of std 8;
//     tests/test_torch_flash_tf32.py emulates both on the CPU);
//   * 8 warps, each owning 16 rows of a 128-row query tile: the online
//     softmax runs on the MMA accumulators with quad shuffles, and P goes
//     from the S accumulators into the A fragments of P V in registers,
//     never through shared memory;
//   * K and V stream through a two-stage cp.async ring of 32-key tiles
//     (zero-filled past Sk): tile j + 1 loads while tile j is computed;
//     q is staged once per block, pre-scaled; rows are padded so that the
//     16-byte fragment reads are free of bank conflicts;
//   * the q-tiles with the most live key tiles are launched first.
// On the card it issues its MMAs at ~40 % of the TF32 rate that mma.sync
// reaches (tools/flash_probe.py; PERF.md). ptxas (-Xptxas -v, sm_90a),
// d 128: 255 registers, 20 bytes of spill stores and loads; d 64: 189
// registers, no spills;
// 144,384 (d 128) or 78,848 (d 64) bytes of dynamic shared memory, one
// block per SM.
//
// The backward kernels (dq, dk/dv) keep the first, simple tiled design on
// f32 CUDA cores (no TF32 rounding):
//   * 256 threads as a 16 x 16 grid; a thread owns 4 rows of the tile
//     (ty * 4 + i) and, of a score tile, the 4 columns tx + 16 * j, of an
//     output tile the D / 16 columns tx * 4 + 64 * jj + e;
//   * the q tile (or, in dk/dv, the k and v tiles) stays in shared memory
//     for the whole block; the other operand's tiles stream through shared
//     memory, rows padded to D + 4 floats so that the 16-byte reads of a
//     score product and of an output product are free of bank conflicts;
//   * p and dS go through shared memory to the second product of the
//     tile.
// dk and dv are summed over the GQA group inside dkv: a block owns one kv
// tile and loops over the group's query heads, so no per-query-head
// (B, H, Sk, D) intermediates are written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per backward tile
constexpr int BK = 64;         // key rows per backward tile
constexpr int THREADS = 256;   // 16 x 16
constexpr int PLD = 64 + 4;    // row stride of a (64 x 64) score tile
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, s;
};

struct Attn {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;     // (B, H, Sq)
  const float* delta;   // (B, H, Sq)
  float* out;           // o (forward) or dq
  float* lse_out;       // forward with lse only
  float* dk;
  float* dv;
  Strides sq, sk, sv, sdo, sout, sdk, sdv;
  int H, G, Sq, Sk;
  float scale;
  int causal, window, q_off;
};

__device__ __forceinline__ bool visible(const Attn& a, int qp, int kp) {
  return kp < a.Sk && (!a.causal || kp <= qp) &&
         (a.window <= 0 || kp > qp - a.window);
}

// Tile-level skip of the Pallas kernels: a (query tile, key tile) pair is
// live unless causality or the window masks all of it.
__device__ __forceinline__ bool live(const Attn& a, int q0, int k0,
                                     int bq = BQ, int bk = BK) {
  const int q_first = a.q_off + q0, q_last = q_first + bq - 1;
  if (a.causal && k0 > q_last) return false;
  if (a.window > 0 && k0 + bk - 1 <= q_first - a.window) return false;
  return true;
}

// dst[64][D + 4] <- rows row0 .. row0 + 63 of src (row stride `ld`) times
// `mul`; rows at or past `n_rows` are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ld, int row0,
                                          int n_rows, float mul) {
  constexpr int V4 = D / 4;
  for (int idx = threadIdx.x; idx < 64 * V4; idx += THREADS) {
    const int r = idx / V4, c = (idx % V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) {
      x = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * ld
                                           + c);
      x.x *= mul;
      x.y *= mul;
      x.z *= mul;
      x.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) = x;
  }
}

// acc[i][j] += A[ra + i] . B[rb + 16 j], rows of D floats (stride D + 4).
template <int D>
__device__ __forceinline__ void mm_nt(float (&acc)[4][4], const float* A,
                                      const float* B, int ra, int rb) {
#pragma unroll 4
  for (int kk = 0; kk < D; kk += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(A + (ra + i) * (D + 4) + kk);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(B + (rb + 16 * j) * (D + 4)
                                              + kk);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(x[i].x, y[j].x, s);
        s = fmaf(x[i].y, y[j].y, s);
        s = fmaf(x[i].z, y[j].z, s);
        s = fmaf(x[i].w, y[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][4 jj + e] += sum_kk P[ra + i][kk] * M[kk][tx * 4 + 64 jj + e]:
// P a (64 x 64) tile of stride PLD, M a (64 x D) tile of stride D + 4.
template <int D>
__device__ __forceinline__ void mm_nn(float (&acc)[4][D / 16],
                                      const float* P, const float* M,
                                      int ra, int tx) {
#pragma unroll 2
  for (int kk = 0; kk < 64; kk += 4) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 t = *reinterpret_cast<const float4*>(P + (ra + i) * PLD
                                                        + kk);
      p[i][0] = t.x;
      p[i][1] = t.y;
      p[i][2] = t.z;
      p[i][3] = t.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int jj = 0; jj < D / 64; ++jj) {
        const float4 m = *reinterpret_cast<const float4*>(
            M + (kk + u) * (D + 4) + tx * 4 + 64 * jj);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * jj + 0] = fmaf(p[i][u], m.x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(p[i][u], m.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(p[i][u], m.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(p[i][u], m.w, acc[i][4 * jj + 3]);
        }
      }
  }
}

// Rows ra .. ra + 3 of acc (columns as in mm_nn) times `mul[i]` into the
// (rows x D) tensor at `dst` (row stride ld), rows at or past n_rows
// dropped.
template <int D>
__device__ __forceinline__ void store_rows(float* dst, long long ld,
                                           const float (&acc)[4][D / 16],
                                           const float (&mul)[4], int row0,
                                           int ra, int tx, int n_rows) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ra + i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj) {
      float4 x = make_float4(acc[i][4 * jj] * mul[i],
                             acc[i][4 * jj + 1] * mul[i],
                             acc[i][4 * jj + 2] * mul[i],
                             acc[i][4 * jj + 3] * mul[i]);
      *reinterpret_cast<float4*>(dst + (long long)row * ld + tx * 4
                                 + 64 * jj) = x;
    }
  }
}

// ---------------------------------------------------------------------------
// forward: a 1-d grid of ceil(Sq / FBQ) * H * B blocks, q-tile major and
// the last q-tile first (under the causal mask it has the most live key
// tiles); 8 warps, each owning 16 query rows
// ---------------------------------------------------------------------------

constexpr int FBQ = 128;       // query rows per forward block, 16 a warp
constexpr int FBK = 32;        // key rows per pipeline stage
constexpr int STAGES = 2;      // K/V tiles in the cp.async ring
static_assert(FBQ / 16 * 32 == THREADS, "a warp per 16 query rows");

// Row strides of the staged tiles (floats). q and K rows are read as
// 16-byte (g, 4t) fragments, which a stride of 16 mod 32 keeps free of
// bank conflicts; V rows as 16-byte (2t, 4g) fragments, which a stride of
// 4 mod 32 keeps free of them.
template <int D> constexpr int FWD_LDK = D + 16;
template <int D> constexpr int FWD_LDV = D + 4;

// cvt.rna.tf32.f32's rounding (to the nearest tf32, ties away from zero)
// as the add and mask that the PTX conversion compiles to; the conversion
// adds a select that keeps a NaN or infinity's low bits, which an MMA
// ignores anyway (2 instructions instead of 4). An f32 register handed
// straight to a tf32 MMA would be truncated instead.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small to about 2^-22 |x|: big its tf32 rounding, small the
// tf32 rounding of the (exact) remainder.
template <int N>
struct Split {
  uint32_t big[N], small[N];
  __device__ __forceinline__ explicit Split(const float (&x)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      big[i] = tf32_rna(x[i]);
      small[i] = tf32_rna(x[i] - __uint_as_float(big[i]));
    }
  }
};

__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b in split TF32: three MMAs into the f32 accumulator, the small
// terms first (the small . small term, ~2^-22 of the product, is dropped).
__device__ __forceinline__ void mma3(float (&c)[4], const Split<4>& a,
                                     const Split<2>& b) {
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.big);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Stage key rows k0 .. k0 + FBK - 1 of k and v; rows at or past Sk are
// zero-filled (src-size 0), never read.
template <int D>
__device__ __forceinline__ void load_kv(float* Kt, float* Vt, const float* k,
                                        const float* v, const Attn& a,
                                        int k0) {
  constexpr int V4 = D / 4;
  static_assert(FBK * V4 % THREADS == 0, "whole rounds of 16-byte chunks");
#pragma unroll
  for (int it = 0; it < FBK * V4 / THREADS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int r = idx / V4, c = (idx % V4) * 4;
    const bool in = k0 + r < a.Sk;
    const long long row = in ? k0 + r : 0;
    cp_async16(Kt + r * FWD_LDK<D> + c, k + row * a.sk.s + c, in);
    cp_async16(Vt + r * FWD_LDV<D> + c, v + row * a.sv.s + c, in);
  }
}

// Fragment layout (PTX m16n8k8 tf32; lane = 4 g + t): A (row, col) at
// (g | g + 8, t | t + 4), B (k, n) at (t | t + 4, g), C at (g | g + 8,
// 2t | 2t + 1). The order of a dot product's terms is free, so each
// product reads its k index through a permutation:
//   S = (q scale) K^T, k = head dim: k-step pair kp covers d = 16 kp + 4t
//   + {0, 1} (first step) and + {2, 3} (second), one float4 of q and of K
//   per thread;
//   O += P V, k = key: logical t, t + 4 is key 2t, 2t + 1 of the 8-key
//   group, exactly the columns of the S accumulator, so P goes from the
//   accumulator into the A fragment in registers; V's B fragment reads
//   rows 2t and 2t + 1. Output n-tile 4 mm + r, column g holds d = 32 mm +
//   4 g + r, so one float4 of a V row feeds four n-tiles and a thread's
//   accumulators cover d = 32 mm + 8 t .. + 7 of its rows.
template <int D, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(Attn a) {
  constexpr int LDK = FWD_LDK<D>, LDV = FWD_LDV<D>;
  constexpr int NKP = D / 16, NJ = FBK / 8, NM = D / 32;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [FBQ][LDK], scaled
  float* Ks = Qs + FBQ * LDK;                     // [STAGES][FBK][LDK]
  float* Vs = Ks + STAGES * FBK * LDK;            // [STAGES][FBK][LDV]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_q = (a.Sq + FBQ - 1) / FBQ, bh_n = gridDim.x / n_q;
  const int bh = blockIdx.x % bh_n;
  const int q0 = (n_q - 1 - (int)blockIdx.x / bh_n) * FBQ;
  const int h = bh % a.H, b = bh / a.H;
  const int gk = h / (a.H / a.G);
  const float* k = a.k + b * a.sk.b + gk * a.sk.h;
  const float* v = a.v + b * a.sv.b + gk * a.sv.h;
  const int r0 = q0 + 16 * warp;                 // the warp's first row
  const int qa = a.q_off + r0, qb = qa + 15;     // its absolute positions

  // the q tile, scaled, rows at or past Sq zero (visible to every warp
  // after the first barrier of the loop)
  {
    constexpr int V4 = D / 4;
    const float* q = a.q + b * a.sq.b + h * a.sq.h;
    for (int idx = threadIdx.x; idx < FBQ * V4; idx += THREADS) {
      const int r = idx / V4, c = (idx % V4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < a.Sq) {
        x = *reinterpret_cast<const float4*>(
            q + (long long)(q0 + r) * a.sq.s + c);
        x.x *= a.scale;
        x.y *= a.scale;
        x.z *= a.scale;
        x.w *= a.scale;
      }
      *reinterpret_cast<float4*>(Qs + r * LDK + c) = x;
    }
  }
  const float* Qw = Qs + (16 * warp + g) * LDK + 4 * t;

  // the live key tiles form one range
  const int n_kv = (a.Sk + FBK - 1) / FBK;
  int lo = 0, hi = n_kv - 1;
  while (lo <= hi && !live(a, q0, lo * FBK, FBQ, FBK)) ++lo;
  while (hi >= lo && !live(a, q0, hi * FBK, FBQ, FBK)) --hi;

  float o[D / 8][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c][e] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (lo + i <= hi)
      load_kv<D>(Ks + i * FBK * LDK, Vs + i * FBK * LDV, k, v, a,
                 (lo + i) * FBK);
    cp_async_commit();
  }
  for (int kb = lo; kb <= hi; ++kb) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();     // tile kb landed; every warp is done with kb - 1
    {
      const int nb = kb + STAGES - 1, st = (nb - lo) % STAGES;
      if (nb <= hi)
        load_kv<D>(Ks + st * FBK * LDK, Vs + st * FBK * LDV, k, v, a,
                   nb * FBK);
      cp_async_commit();
    }
    const int k0 = kb * FBK;
    // a warp whose rows are past Sq, or see none of this tile
    if (r0 >= a.Sq || (a.causal && k0 > qb) ||
        (a.window > 0 && k0 + FBK - 1 <= qa - a.window))
      continue;
    const float* Kt = Ks + ((kb - lo) % STAGES) * FBK * LDK + g * LDK + 4 * t;
    const float* Vt = Vs + ((kb - lo) % STAGES) * FBK * LDV + 2 * t * LDV
                      + 4 * g;

    // S = (q scale) K^T
    float s[NJ][4];
#pragma unroll
    for (int kp = 0; kp < NKP; ++kp) {
      const float4 x0 = *reinterpret_cast<const float4*>(Qw + 16 * kp);
      const float4 x1 = *reinterpret_cast<const float4*>(Qw + 8 * LDK
                                                         + 16 * kp);
      const Split<4> qa0({x0.x, x1.x, x0.y, x1.y});
      const Split<4> qa1({x0.z, x1.z, x0.w, x1.w});
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 y = *reinterpret_cast<const float4*>(
            Kt + 8 * j * LDK + 16 * kp);
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma3(c, qa0, Split<2>({y.x, y.y}));
        mma3(c, qa1, Split<2>({y.z, y.w}));
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = kp ? s[j][e] + c[e] : c[e];
      }
    }

    // masks, only where this warp's rows see part of the tile
    if (!(k0 + FBK <= a.Sk && (!a.causal || k0 + FBK - 1 <= qa) &&
          (a.window <= 0 || k0 > qb - a.window))) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(a, qa + g + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1)))
            s[j][e] = NEG_INF;
    }

    // online softmax on the accumulators; a row's 4 threads share a quad.
    // l stays a per-thread partial sum until the end.
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[i] = expf(m[i] - mx);
      m[i] = mx;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          s[j][e] = expf(s[j][e] - mx);
          rs += s[j][e];
        }
      l[i] = l[i] * corr[i] + rs;
    }

    // O = O corr + P V, P straight from the S accumulators: the tile's
    // P V from zero in all D / 8 n-tiles at once (independent MMA chains),
    // then folded into O
    float c[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const Split<4> pj({s[j][0], s[j][2], s[j][1], s[j][3]});
#pragma unroll
      for (int mm = 0; mm < NM; ++mm) {
        const float4 v0 = *reinterpret_cast<const float4*>(
            Vt + 8 * j * LDV + 32 * mm);
        const float4 v1 = *reinterpret_cast<const float4*>(
            Vt + (8 * j + 1) * LDV + 32 * mm);
        mma3(c[4 * mm + 0], pj, Split<2>({v0.x, v1.x}));
        mma3(c[4 * mm + 1], pj, Split<2>({v0.y, v1.y}));
        mma3(c[4 * mm + 2], pj, Split<2>({v0.z, v1.z}));
        mma3(c[4 * mm + 3], pj, Split<2>({v0.w, v1.w}));
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[n][e] = fmaf(o[n][e], corr[e >> 1], c[n][e]);
  }

  float* out = a.out + b * a.sout.b + h * a.sout.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li = fmaxf(li, 1e-30f);
    const float inv = 1.f / li;
    const int row = r0 + g + 8 * i;
    if (row >= a.Sq) continue;
    if (LSE && t == 0)
      a.lse_out[((long long)b * a.H + h) * a.Sq + row] = m[i] + logf(li);
    float* dst = out + (long long)row * a.sout.s + 8 * t;
#pragma unroll
    for (int mm = 0; mm < NM; ++mm) {
      *reinterpret_cast<float4*>(dst + 32 * mm) = make_float4(
          o[4 * mm][2 * i] * inv, o[4 * mm + 1][2 * i] * inv,
          o[4 * mm + 2][2 * i] * inv, o[4 * mm + 3][2 * i] * inv);
      *reinterpret_cast<float4*>(dst + 32 * mm + 4) = make_float4(
          o[4 * mm][2 * i + 1] * inv, o[4 * mm + 1][2 * i + 1] * inv,
          o[4 * mm + 2][2 * i + 1] * inv, o[4 * mm + 3][2 * i + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// dq: grid (ceil(Sq / 64), H, B); kv tiles sequential inside the block
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(Attn a) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [BQ][D + 4], scaled
  float* dOs = Qs + BQ * (D + 4);                 // [BQ][D + 4]
  float* Ks = dOs + BQ * (D + 4);                 // [BK][D + 4]
  float* Vs = Ks + BK * (D + 4);                  // [BK][D + 4]
  float* Ss = Vs + BK * (D + 4);                  // [BQ][PLD]: dS
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16, ra = ty * 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const float* k = a.k + b * a.sk.b + g * a.sk.h;
  const float* v = a.v + b * a.sv.b + g * a.sv.h;
  load_tile<D>(Qs, a.q + b * a.sq.b + h * a.sq.h, a.sq.s, q0, a.Sq,
               a.scale);
  load_tile<D>(dOs, a.dout + b * a.sdo.b + h * a.sdo.h, a.sdo.s, q0, a.Sq,
               1.f);
  const long long row_base = ((long long)b * a.H + h) * a.Sq;
  float lse[4], dl[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ra + i;
    lse[i] = row < a.Sq ? a.lse[row_base + row] : 0.f;
    dl[i] = row < a.Sq ? a.delta[row_base + row] : 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }
  const int n_kv = (a.Sk + BK - 1) / BK;
  for (int kb = 0; kb < n_kv; ++kb) {
    const int k0 = kb * BK;
    if (!live(a, q0, k0)) continue;
    __syncthreads();
    load_tile<D>(Ks, k, a.sk.s, k0, a.Sk, 1.f);
    load_tile<D>(Vs, v, a.sv.s, k0, a.Sk, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    mm_nt<D>(s, Qs, Ks, ra, tx);
    mm_nt<D>(dp, dOs, Vs, ra, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = a.q_off + q0 + ra + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = visible(a, qp, k0 + tx + 16 * j)
                            ? expf(s[i][j] - lse[i]) : 0.f;
        Ss[(ra + i) * PLD + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    }
    __syncthreads();
    mm_nn<D>(acc, Ss, Ks, ra, tx);
  }
  const float mul[4] = {a.scale, a.scale, a.scale, a.scale};
  store_rows<D>(a.out + b * a.sout.b + h * a.sout.h, a.sout.s, acc, mul,
                q0, ra, tx, a.Sq);
}

// ---------------------------------------------------------------------------
// dk, dv: grid (ceil(Sk / 64), G, B); the group's query heads and the query
// tiles sequential inside the block
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(Attn a) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [BK][D + 4]
  float* Vs = Ks + BK * (D + 4);                  // [BK][D + 4]
  float* Qs = Vs + BK * (D + 4);                  // [BQ][D + 4], scaled
  float* dOs = Qs + BQ * (D + 4);                 // [BQ][D + 4]
  float* Ps = dOs + BQ * (D + 4);                 // [BK][PLD]: p^T
  float* Ss = Ps + BK * PLD;                      // [BK][PLD]: dS^T
  float* lse_s = Ss + BK * PLD;                   // [BQ]
  float* dl_s = lse_s + BQ;                       // [BQ]
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16, ra = ty * 4;
  const int k0 = blockIdx.x * BK, g = blockIdx.y, b = blockIdx.z;
  const int rep = a.H / a.G;
  load_tile<D>(Ks, a.k + b * a.sk.b + g * a.sk.h, a.sk.s, k0, a.Sk, 1.f);
  load_tile<D>(Vs, a.v + b * a.sv.b + g * a.sv.h, a.sv.s, k0, a.Sk, 1.f);
  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk[i][c] = dv[i][c] = 0.f;
  const int n_q = (a.Sq + BQ - 1) / BQ;
  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    const float* q = a.q + b * a.sq.b + h * a.sq.h;
    const float* dout = a.dout + b * a.sdo.b + h * a.sdo.h;
    const long long row_base = ((long long)b * a.H + h) * a.Sq;
    for (int qb = 0; qb < n_q; ++qb) {
      const int q0 = qb * BQ;
      if (!live(a, q0, k0)) continue;
      __syncthreads();
      load_tile<D>(Qs, q, a.sq.s, q0, a.Sq, a.scale);
      load_tile<D>(dOs, dout, a.sdo.s, q0, a.Sq, 1.f);
      if (threadIdx.x < BQ) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < a.Sq ? a.lse[row_base + row] : 0.f;
        dl_s[threadIdx.x] = row < a.Sq ? a.delta[row_base + row] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      mm_nt<D>(s, Ks, Qs, ra, tx);     // s^T: key rows x query columns
      mm_nt<D>(dp, Vs, dOs, ra, tx);   // dp^T
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j, row = q0 + qc;
        const int qp = a.q_off + row;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = row < a.Sq && visible(a, qp, k0 + ra + i);
          const float p = ok ? expf(s[i][j] - lse_s[qc]) : 0.f;
          Ps[(ra + i) * PLD + qc] = p;
          Ss[(ra + i) * PLD + qc] = p * (dp[i][j] - dl_s[qc]);
        }
      }
      __syncthreads();
      mm_nn<D>(dv, Ps, dOs, ra, tx);   // dv += p^T . dO
      mm_nn<D>(dk, Ss, Qs, ra, tx);    // dk += dS^T . (q * scale)
    }
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<D>(a.dk + b * a.sdk.b + g * a.sdk.h, a.sdk.s, dk, one, k0, ra,
                tx, a.Sk);
  store_rows<D>(a.dv + b * a.sdv.b + g * a.sdv.h, a.sdv.s, dv, one, k0, ra,
                tx, a.Sk);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

enum Kind { FWD = 0, FWD_LSE = 1, BWD_DQ = 2, BWD_DKV = 3 };

template <int D>
constexpr size_t smem_bytes(Kind kind) {
  return sizeof(float) *
         (kind == BWD_DKV ? 4 * 64 * (D + 4) + 2 * 64 * PLD + 2 * BQ
          : kind == BWD_DQ ? 4 * 64 * (D + 4) + 64 * PLD
                           : (FBQ + STAGES * FBK) * FWD_LDK<D>
                                 + STAGES * FBK * FWD_LDV<D>);
}
static_assert(smem_bytes<128>(FWD) <= 232448, "forward stages overflow");

template <typename K>
cudaError_t launch(K kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   const Attn& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t run(Kind kind, const Attn& a, int B, cudaStream_t stream) {
  const dim3 rows((a.Sq + BQ - 1) / BQ, a.H, B);
  const dim3 fwd(((a.Sq + FBQ - 1) / FBQ) * a.H * B);
  const size_t smem = smem_bytes<D>(kind);
  switch (kind) {
    case FWD:
      return launch(flash_fwd_kernel<D, false>, fwd, smem, stream, a);
    case FWD_LSE:
      return launch(flash_fwd_kernel<D, true>, fwd, smem, stream, a);
    case BWD_DQ:
      return launch(flash_dq_kernel<D>, rows, smem, stream, a);
    case BWD_DKV:
      return launch(flash_dkv_kernel<D>, dim3((a.Sk + BK - 1) / BK, a.G, B),
                    smem, stream, a);
  }
  return cudaErrorInvalidValue;
}

// st: batch, head and sequence strides of q, k, v, dO, out (o or dq), dk,
// dv, in that order (21 values; zeros for tensors a kernel does not take).
int dispatch(Kind kind, const float* q, const float* k, const float* v,
             const float* dout, const float* lse, const float* delta,
             float* out, float* lse_out, float* dk, float* dv,
             const long long* st, int B, int H, int G, int Sq, int Sk, int D,
             float scale, int causal, int window, int q_off, int device,
             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || H <= 0 || G <= 0 || H % G != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  Attn a{q, k, v, dout, lse, delta, out, lse_out, dk, dv,
         {st[0], st[1], st[2]}, {st[3], st[4], st[5]},
         {st[6], st[7], st[8]}, {st[9], st[10], st[11]},
         {st[12], st[13], st[14]}, {st[15], st[16], st[17]},
         {st[18], st[19], st[20]},
         H, G, Sq, Sk, scale, causal, window, q_off};
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64) return (int)run<64>(kind, a, B, s);
  if (D == 128) return (int)run<128>(kind, a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Each returns the cudaError_t of its launch (0 on success).
#define REPRO_FLASH_ARGS                                                    \
  const float *q, const float *k, const float *v, const float *dout,       \
      const float *lse, const float *delta, float *out, float *lse_out,    \
      float *dk, float *dv, const long long *st, int B, int H, int G,      \
      int Sq, int Sk, int D, float scale, int causal, int window,          \
      int q_off, int device, void *stream
#define REPRO_FLASH_PASS                                                    \
  q, k, v, dout, lse, delta, out, lse_out, dk, dv, st, B, H, G, Sq, Sk, D, \
      scale, causal, window, q_off, device, stream

extern "C" int repro_flash_fwd_f32(REPRO_FLASH_ARGS) {
  return dispatch(FWD, REPRO_FLASH_PASS);
}
extern "C" int repro_flash_fwd_lse_f32(REPRO_FLASH_ARGS) {
  return dispatch(FWD_LSE, REPRO_FLASH_PASS);
}
extern "C" int repro_flash_bwd_dq_f32(REPRO_FLASH_ARGS) {
  return dispatch(BWD_DQ, REPRO_FLASH_PASS);
}
extern "C" int repro_flash_bwd_dkv_f32(REPRO_FLASH_ARGS) {
  return dispatch(BWD_DKV, REPRO_FLASH_PASS);
}
