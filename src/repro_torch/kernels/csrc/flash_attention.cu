// Flash attention, forward and backward, for Hopper (sm_90a), on float32 or
// bfloat16 operands.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py:
//   repro_flash_fwd_f32      flash_attention  (_attn_kernel): o only
//   repro_flash_fwd_lse_f32  _fwd_lse         (_attn_kernel_fwd): o and the
//                            per-row logsumexp lse = m + log(l)
//   repro_flash_bwd_dq_f32   _bwd, first call  (_bwd_dq_kernel)
//   repro_flash_bwd_dkv_f32  _bwd, second call (_bwd_dkv_kernel)
// and the same four as _bf16: as the Pallas kernels, q, k, v and
// dO of any float dtype are converted to f32 where they are staged, every
// product and sum is f32, and o, dq, dk and dv are written in the
// operands' dtype; lse and delta are f32 whatever the operands' dtype. A
// bf16 or f16 tile is loaded through registers (8 bytes a thread-chunk)
// and stored to shared memory as f32, so the f32 pipeline's split-TF32
// products run unchanged; f32 tiles keep their cp.async ring.
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
// The backward kernels, flash_dq_kernel and flash_dkv_kernel: bound by
// operations too. At the 400m layer dq does 6 d flops per visible pair
// (S, dP, dS K: 38.7 GFLOP) and dk/dv 8 d (S^T, dP^T, P^T dO, dS^T q:
// 51.6 GFLOP), against ~0.25 and ~0.30 GB of device memory (0.075, 0.090
// ms at 3.35 TB/s); as three TF32 products each they take 0.234 and
// 0.313 ms at 495 TFLOP/s. They keep the JAX package's split (dq over key
// tiles; dk/dv over the group's query heads and query tiles, the GQA sum
// inside the block; no atomics, so both are deterministic) and take the
// forward's pieces:
//   * all five products in split TF32, three mma.sync m16n8k8 each; small
//     is x - big as it is (SplitT: truncated by the MMA, where the
//     forward's Split rounds it), which the backward's 5e-4 tolerance
//     leaves room for and which saves an add and a mask per operand;
//   * the score products (S, dP, S^T, dP^T) sum each 16-wide slice of d
//     from a fresh accumulator and add the slices in f32, and each query
//     or key tile's dS K, P^T dO and dS^T q is summed from zero and added
//     to the running f32 sum once;
//   * dq has the forward's shape: 8 warps x 16 query rows of a 128-row
//     block, K and V streaming through a two-stage cp.async ring of
//     32-key tiles; P and dS = P (dP - delta) are made on the S and dP
//     accumulators and go into the A fragments of dS K in registers;
//   * dk/dv: a block of 64 keys and two warpgroups over the same keys,
//     16 a warp, q, dO, lse and delta streaming through a two-stage ring
//     of 32-query tiles (q scaled in place once landed). With key rows as
//     the MMA's M dimension, S^T and dP^T come out in the accumulator
//     layout that the A fragments of P^T dO and dS^T q read. Warpgroup 0
//     computes S^T, P^T and dV; warpgroup 1 computes dP^T and, with P^T
//     handed over through shared memory behind a named barrier, dS^T and
//     dK. Each warp holds one 16 x D accumulator (64 registers at d 128)
//     and issues two of the four products; no product is computed twice;
//   * the staged tiles are unpadded and swizzled (swz): K (dq), q and dO
//     (dk/dv) are read both as (g, 4t) and as (2t, 4g) fragments, which
//     no row padding keeps free of bank conflicts at once;
//   * p = __expf(s - lse): the tolerance leaves room for its few ulp,
//     and expf cost dk/dv 4 % (tools/flash_ab.py);
//   * the heaviest tiles first: the last q-tiles for dq, the first
//     kv-tiles for dk/dv; tiles that the mask hides are skipped.
// On the card the pair issues its MMAs at ~42 % of the TF32 rate that
// mma.sync reaches, as the forward does (PERF.md). ptxas (-Xptxas -v, sm_90a), no spills: dq 239 registers
// (d 128) or 187 (d 64), dk/dv 252 or 176; dynamic shared memory: dq
// 196,608 or 98,304 bytes, dk/dv 139,776 or 74,240; one block per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;   // 8 warps
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, s;
};

// T: the operands' element type (float or __nv_bfloat16)
template <typename T>
struct Attn {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  const float* lse;     // (B, H, Sq)
  const float* delta;   // (B, H, Sq)
  T* out;               // o (forward) or dq
  float* lse_out;       // forward with lse only
  T* dk;
  T* dv;
  Strides sq, sk, sv, sdo, sout, sdk, sdv;
  int H, G, Sq, Sk;
  float scale;
  int causal, window, q_off;
};

template <typename T>
__device__ __forceinline__ bool visible(const Attn<T>& a, int qp, int kp) {
  return kp < a.Sk && (!a.causal || kp <= qp) &&
         (a.window <= 0 || kp > qp - a.window);
}

// Tile-level skip of the Pallas kernels: a (query tile, key tile) pair is
// live unless causality or the window masks all of it.
template <typename T>
__device__ __forceinline__ bool live(const Attn<T>& a, int q0, int k0,
                                     int bq, int bk) {
  const int q_first = a.q_off + q0, q_last = q_first + bq - 1;
  if (a.causal && k0 > q_last) return false;
  if (a.window > 0 && k0 + bk - 1 <= q_first - a.window) return false;
  return true;
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

// Four consecutive elements as f32, and back in the element type
// (round to nearest even).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<const uint32_t*>(&a),
      *reinterpret_cast<const uint32_t*>(&b));
}

// Stage four elements of src at dst as f32: a 16-byte cp.async for f32
// (zero-filled unless `in`), a load through registers otherwise (nothing
// read unless `in`).
template <typename T>
__device__ __forceinline__ void stage4(float* dst, const T* src, bool in) {
  if constexpr (std::is_same_v<T, float>) {
    cp_async16(dst, src, in);
  } else {
    *reinterpret_cast<float4*>(dst) =
        in ? load4(src) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Stage key rows k0 .. k0 + FBK - 1 of k and v; rows at or past Sk are
// zero-filled (src-size 0), never read.
template <typename T, int D>
__device__ __forceinline__ void load_kv(float* Kt, float* Vt, const T* k,
                                        const T* v, const Attn<T>& a,
                                        int k0) {
  constexpr int V4 = D / 4;
  static_assert(FBK * V4 % THREADS == 0, "whole rounds of 16-byte chunks");
#pragma unroll
  for (int it = 0; it < FBK * V4 / THREADS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int r = idx / V4, c = (idx % V4) * 4;
    const bool in = k0 + r < a.Sk;
    const long long row = in ? k0 + r : 0;
    stage4(Kt + r * FWD_LDK<D> + c, k + row * a.sk.s + c, in);
    stage4(Vt + r * FWD_LDV<D> + c, v + row * a.sv.s + c, in);
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
template <typename T, int D, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(Attn<T> a) {
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
  const T* k = a.k + b * a.sk.b + gk * a.sk.h;
  const T* v = a.v + b * a.sv.b + gk * a.sv.h;
  const int r0 = q0 + 16 * warp;                 // the warp's first row
  const int qa = a.q_off + r0, qb = qa + 15;     // its absolute positions

  // the q tile, scaled, rows at or past Sq zero (visible to every warp
  // after the first barrier of the loop)
  {
    constexpr int V4 = D / 4;
    const T* q = a.q + b * a.sq.b + h * a.sq.h;
    for (int idx = threadIdx.x; idx < FBQ * V4; idx += THREADS) {
      const int r = idx / V4, c = (idx % V4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < a.Sq) {
        x = load4(q + (long long)(q0 + r) * a.sq.s + c);
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
      load_kv<T, D>(Ks + i * FBK * LDK, Vs + i * FBK * LDV, k, v, a,
                    (lo + i) * FBK);
    cp_async_commit();
  }
  for (int kb = lo; kb <= hi; ++kb) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();     // tile kb landed; every warp is done with kb - 1
    {
      const int nb = kb + STAGES - 1, st = (nb - lo) % STAGES;
      if (nb <= hi)
        load_kv<T, D>(Ks + st * FBK * LDK, Vs + st * FBK * LDV, k, v, a,
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

  T* out = a.out + b * a.sout.b + h * a.sout.h;
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
    T* dst = out + (long long)row * a.sout.s + 8 * t;
#pragma unroll
    for (int mm = 0; mm < NM; ++mm) {
      store4(dst + 32 * mm, make_float4(
          o[4 * mm][2 * i] * inv, o[4 * mm + 1][2 * i] * inv,
          o[4 * mm + 2][2 * i] * inv, o[4 * mm + 3][2 * i] * inv));
      store4(dst + 32 * mm + 4, make_float4(
          o[4 * mm][2 * i + 1] * inv, o[4 * mm + 1][2 * i + 1] * inv,
          o[4 * mm + 2][2 * i + 1] * inv, o[4 * mm + 3][2 * i + 1] * inv));
    }
  }
}

// ---------------------------------------------------------------------------
// backward: the pieces shared by dq and dk/dv
// ---------------------------------------------------------------------------

constexpr int BKV = 64;        // key rows per dk/dv block, 16 a warp
constexpr int BQT = 32;        // query rows per dk/dv pipeline stage
constexpr int P_BAR = 1;       // named barrier: P^T handed to warpgroup 1
static_assert(BKV / 16 * 2 * 32 == THREADS, "two warpgroups over the keys");

// Backward tiles are staged unpadded, D floats a row, with the 16-byte
// chunk c of row r at chunk c ^ swz(r). Staged operands are read in two
// patterns (K in dq, q and dO in dk/dv in both), and this swizzle keeps
// both free of bank conflicts (no padding does: (g, 4t) reads need a row
// stride of 16 mod 32 floats, (2t, 4g) reads one that is not 0 or 16 mod
// 32):
//   (g, 4t): lane g t reads chunk 4 kp + t of row g; rows g and g ^ 1 have
//            swz values that differ in bit 2, so a quarter-warp (g = 2i,
//            2i + 1) covers the 8 bank quads once;
//   (2t, 4g): lane g t reads chunk 8 mm + g of row 2t (or 2t + 1); the
//            four even (odd) rows have swz values that differ in bits 1-2.
__device__ __forceinline__ int swz(int r) {
  return (r & 6) ^ ((r & 1) * 6);
}

// Float offset of chunk `c` (16-byte index) of staged row `r`.
template <int D>
__device__ __forceinline__ int at(int r, int c) {
  return r * D + ((c ^ swz(r)) << 2);
}

// Stage rows row0 .. row0 + R - 1 of src (row stride ld) into dst; rows
// at or past n_rows are zero-filled, never read.
template <int D, int R, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           long long ld, int row0,
                                           int n_rows) {
  constexpr int V4 = D / 4;
  static_assert(R * V4 % THREADS == 0, "whole rounds of 16-byte chunks");
#pragma unroll
  for (int it = 0; it < R * V4 / THREADS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int r = idx / V4, c = idx % V4;
    const bool in = row0 + r < n_rows;
    const long long row = in ? row0 + r : 0;
    stage4(dst + at<D>(r, c), src + row * ld + 4 * c, in);
  }
}

// The chunks this thread staged with stage_rows<D, R>, times `mul`, once
// they have landed (its own copies: visible to it after the wait).
template <int D, int R>
__device__ __forceinline__ void scale_rows(float* dst, float mul) {
  constexpr int V4 = D / 4;
#pragma unroll
  for (int it = 0; it < R * V4 / THREADS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    float4* p = reinterpret_cast<float4*>(dst + at<D>(idx / V4, idx % V4));
    float4 x = *p;
    x.x *= mul;
    x.y *= mul;
    x.z *= mul;
    x.w *= mul;
    *p = x;
  }
}

// The backward's split: big = rna(x) as in Split, small = x - big as it
// is (exact in f32): an MMA reads a tf32 operand's top 19 bits, so small
// is truncated to tf32, ~2^-21 |x| (Split rounds it, ~2^-22; its extra
// add and mask per element cost the pair 6 % at the 400m layer,
// tools/flash_ab.py).
template <int N>
struct SplitT {
  uint32_t big[N], small[N];
  __device__ __forceinline__ explicit SplitT(const float (&x)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      big[i] = tf32_rna(x[i]);
      small[i] = __float_as_uint(x[i] - __uint_as_float(big[i]));
    }
  }
};

// c += a . b in split TF32: big.small, small.big, big.big.
__device__ __forceinline__ void mma3(float (&c)[4], const SplitT<4>& a,
                                     const SplitT<2>& b) {
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.big);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(s), "l"(src), "r"(full ? 4 : 0) : "memory");
}

// A thread's two row pointers for (g, 4t) reads of staged row r: chunk
// 4 kp + t sits at p[kp & 1] + 32 (kp >> 1) (and row r + 8 at + 8 D).
template <int D>
struct RowA {
  const float* p[2];
  __device__ __forceinline__ RowA(const float* tile, int r, int t) {
    const int c = t ^ swz(r);
    p[0] = tile + r * D + 4 * c;
    p[1] = tile + r * D + 4 * (c ^ 4);
  }
  __device__ __forceinline__ float4 operator()(int kp, int row_off) const {
    return *reinterpret_cast<const float4*>(p[kp & 1] + 32 * (kp >> 1)
                                            + row_off * D);
  }
};

// A thread's two row pointers for (2t, 4g) reads: rows 2t and 2t + 1 of
// the tile, chunk g; row 8 j + 2t, d 32 mm + 4 g at p[0] + 8 j D + 32 mm.
template <int D>
struct RowB {
  const float* p[2];
  __device__ __forceinline__ RowB(const float* tile, int g, int t) {
    p[0] = tile + 2 * t * D + 4 * (g ^ swz(2 * t));
    p[1] = tile + (2 * t + 1) * D + 4 * (g ^ swz(2 * t + 1));
  }
};

// s[j] = A B^T over d for the warp's 16 rows (A: rows r, r + 8 through
// `ra`) and the 8 rows 8 j + g of a 32-row tile (through `rb`): the
// forward's S product. Each 16-wide slice of d is summed from a fresh
// accumulator and the slices are added in f32. The loop over pairs of
// slices stays rolled: unrolled, dq spilled 72 bytes and ran 17 % slower
// (tools/flash_ab.py).
template <int D>
__device__ __forceinline__ void score(float (&s)[4][4], const RowA<D>& ra,
                                      const RowA<D>& rb) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 1
  for (int k2 = 0; k2 < D / 32; ++k2)
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int kp = 2 * k2 + p;
    const float4 x0 = ra(kp, 0), x1 = ra(kp, 8);
    const SplitT<4> a0({x0.x, x1.x, x0.y, x1.y});
    const SplitT<4> a1({x0.z, x1.z, x0.w, x1.w});
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 y = rb(kp, 8 * j);
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma3(c, a0, SplitT<2>({y.x, y.y}));
      mma3(c, a1, SplitT<2>({y.z, y.w}));
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += c[e];
    }
  }
}

// acc += X B over the tile's 32 rows: X a 16 x 32 tile in accumulator
// layout (x[j] covers columns 8 j .. 8 j + 7), B the tile's (32 x D)
// operand read through `rb`. As the forward's P V: accumulator column 2t |
// 2t + 1 of x[j] is logical k t | t + 4, so x goes into the A fragments in
// registers, split once; n-tile 4 mm + r, column g is d = 32 mm + 4 g + r,
// so one float4 of a B row feeds four n-tiles, and acc[4 mm + r] holds d
// = 32 mm + 8 t + r (+ 4) of the warp's rows g (g + 8). Each group of four
// n-tiles sums the whole tile from zero and is added to acc in f32.
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           const float (&x)[4][4],
                                           const RowB<D>& rb) {
  const SplitT<4> xa[4] = {
      SplitT<4>({x[0][0], x[0][2], x[0][1], x[0][3]}),
      SplitT<4>({x[1][0], x[1][2], x[1][1], x[1][3]}),
      SplitT<4>({x[2][0], x[2][2], x[2][1], x[2][3]}),
      SplitT<4>({x[3][0], x[3][2], x[3][1], x[3][3]})};
#pragma unroll
  for (int mm = 0; mm < D / 32; ++mm) {
    float c[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[r][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 v0 = *reinterpret_cast<const float4*>(
          rb.p[0] + 8 * j * D + 32 * mm);
      const float4 v1 = *reinterpret_cast<const float4*>(
          rb.p[1] + 8 * j * D + 32 * mm);
      mma3(c[0], xa[j], SplitT<2>({v0.x, v1.x}));
      mma3(c[1], xa[j], SplitT<2>({v0.y, v1.y}));
      mma3(c[2], xa[j], SplitT<2>({v0.z, v1.z}));
      mma3(c[3], xa[j], SplitT<2>({v0.w, v1.w}));
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * mm + r][e] += c[r][e];
  }
}

// Rows `row` (accumulator e = 0, 1) and `row + 8` (e = 2, 3) of acc times
// `mul` into dst (row stride ld), rows at or past n_rows dropped.
template <int D, typename T>
__device__ __forceinline__ void store_acc(T* dst, long long ld,
                                          const float (&acc)[D / 8][4],
                                          float mul, int row, int t,
                                          int n_rows) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row + 8 * i >= n_rows) continue;
    T* p = dst + (long long)(row + 8 * i) * ld + 8 * t;
#pragma unroll
    for (int mm = 0; mm < D / 32; ++mm) {
      store4(p + 32 * mm, make_float4(
          acc[4 * mm][2 * i] * mul, acc[4 * mm + 1][2 * i] * mul,
          acc[4 * mm + 2][2 * i] * mul, acc[4 * mm + 3][2 * i] * mul));
      store4(p + 32 * mm + 4, make_float4(
          acc[4 * mm][2 * i + 1] * mul, acc[4 * mm + 1][2 * i + 1] * mul,
          acc[4 * mm + 2][2 * i + 1] * mul,
          acc[4 * mm + 3][2 * i + 1] * mul));
    }
  }
}

// ---------------------------------------------------------------------------
// dq: a 1-d grid of ceil(Sq / FBQ) * H * B blocks, the last q-tile first,
// as the forward; 8 warps, each owning 16 query rows; K and V stream
// through a cp.async ring of FBK-key tiles
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_kernel(Attn<T> a) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [FBQ][D], scaled
  float* dOs = Qs + FBQ * D;                      // [FBQ][D]
  float* Ks = dOs + FBQ * D;                      // [STAGES][FBK][D]
  float* Vs = Ks + STAGES * FBK * D;              // [STAGES][FBK][D]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_q = (a.Sq + FBQ - 1) / FBQ, bh_n = gridDim.x / n_q;
  const int bh = blockIdx.x % bh_n;
  const int q0 = (n_q - 1 - (int)blockIdx.x / bh_n) * FBQ;
  const int h = bh % a.H, b = bh / a.H;
  const int gk = h / (a.H / a.G);
  const T* k = a.k + b * a.sk.b + gk * a.sk.h;
  const T* v = a.v + b * a.sv.b + gk * a.sv.h;
  const int r0 = q0 + 16 * warp;                 // the warp's first row
  const int qa = a.q_off + r0, qb = qa + 15;     // its absolute positions

  // the live key tiles form one range; their first loads go out first
  const int n_kv = (a.Sk + FBK - 1) / FBK;
  int lo = 0, hi = n_kv - 1;
  while (lo <= hi && !live(a, q0, lo * FBK, FBQ, FBK)) ++lo;
  while (hi >= lo && !live(a, q0, hi * FBK, FBQ, FBK)) --hi;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (lo + i <= hi) {
      stage_rows<D, FBK>(Ks + i * FBK * D, k, a.sk.s, (lo + i) * FBK, a.Sk);
      stage_rows<D, FBK>(Vs + i * FBK * D, v, a.sv.s, (lo + i) * FBK, a.Sk);
    }
    cp_async_commit();
  }

  // q (scaled) and dO, rows at or past Sq zero (visible to every warp
  // after the first barrier of the loop)
  {
    constexpr int V4 = D / 4;
    const T* q = a.q + b * a.sq.b + h * a.sq.h;
    const T* dout = a.dout + b * a.sdo.b + h * a.sdo.h;
    for (int idx = threadIdx.x; idx < FBQ * V4; idx += THREADS) {
      const int r = idx / V4, c = idx % V4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
      if (q0 + r < a.Sq) {
        x = load4(q + (long long)(q0 + r) * a.sq.s + 4 * c);
        y = load4(dout + (long long)(q0 + r) * a.sdo.s + 4 * c);
        x.x *= a.scale;
        x.y *= a.scale;
        x.z *= a.scale;
        x.w *= a.scale;
      }
      *reinterpret_cast<float4*>(Qs + at<D>(r, c)) = x;
      *reinterpret_cast<float4*>(dOs + at<D>(r, c)) = y;
    }
  }
  const RowA<D> qr(Qs, 16 * warp + g, t), dor(dOs, 16 * warp + g, t);
  float lse[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    const long long at_row = ((long long)b * a.H + h) * a.Sq + row;
    lse[i] = row < a.Sq ? a.lse[at_row] : 0.f;
    dl[i] = row < a.Sq ? a.delta[at_row] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  for (int kb = lo; kb <= hi; ++kb) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();     // tile kb landed; every warp is done with kb - 1
    {
      const int nb = kb + STAGES - 1, st = (nb - lo) % STAGES;
      if (nb <= hi) {
        stage_rows<D, FBK>(Ks + st * FBK * D, k, a.sk.s, nb * FBK, a.Sk);
        stage_rows<D, FBK>(Vs + st * FBK * D, v, a.sv.s, nb * FBK, a.Sk);
      }
      cp_async_commit();
    }
    const int k0 = kb * FBK;
    // a warp whose rows are past Sq, or see none of this tile
    if (r0 >= a.Sq || (a.causal && k0 > qb) ||
        (a.window > 0 && k0 + FBK - 1 <= qa - a.window))
      continue;
    const float* Kt = Ks + ((kb - lo) % STAGES) * FBK * D;
    const float* Vt = Vs + ((kb - lo) % STAGES) * FBK * D;

    // S = (q scale) K^T and dP = dO V^T
    float s[4][4], dp[4][4];
    score<D>(s, qr, RowA<D>(Kt, g, t));
    score<D>(dp, dor, RowA<D>(Vt, g, t));

    // dS = P (dP - delta), P = exp(S - lse) where visible, else 0
    const bool full = k0 + FBK <= a.Sk && (!a.causal || k0 + FBK - 1 <= qa)
                      && (a.window <= 0 || k0 > qb - a.window);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const bool ok = full || visible(a, qa + g + 8 * i,
                                        k0 + 8 * j + 2 * t + (e & 1));
        const float p = ok ? __expf(s[j][e] - lse[i]) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[i]);
      }

    // dQ += dS K, dS straight from the accumulators
    accumulate<D>(acc, s, RowB<D>(Kt, g, t));
  }
  cp_async_wait<0>();

  store_acc<D>(a.out + b * a.sout.b + h * a.sout.h, a.sout.s, acc, a.scale,
               r0 + g, t, a.Sq);
}

// ---------------------------------------------------------------------------
// dk, dv: a 1-d grid of ceil(Sk / BKV) * G * B blocks, kv-tile major and
// the first kv-tile first (under the causal mask it has the most live
// query tiles); the group's query heads and their query tiles stream
// through a cp.async ring of BQT-row tiles. Two warpgroups over the same
// 64 keys, 16 a warp: warpgroup 0 computes S^T = K (q scale)^T, P^T =
// exp(S^T - lse) and dV += P^T dO; warpgroup 1 computes dP^T = V dO^T,
// takes P^T from warpgroup 0 through shared memory (named barrier P_BAR),
// and computes dS^T = P^T (dP^T - delta) and dK += dS^T (q scale). With
// key rows as the MMA's M dimension, P^T and dS^T come out in the
// accumulator layout that the A fragments of the second products read.
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_kernel(Attn<T> a) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [BKV][D]
  float* Vs = Ks + BKV * D;                       // [BKV][D]
  float* Qs = Vs + BKV * D;                       // [STAGES][BQT][D], scaled
  float* dOs = Qs + STAGES * BQT * D;             // [STAGES][BQT][D]
  float* Ls = dOs + STAGES * BQT * D;             // [STAGES][2][BQT]
  float4* Ps = reinterpret_cast<float4*>(Ls + STAGES * 2 * BQT);
                                                  // [4 warps][4][32 lanes]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wg = warp / 4, w = warp % 4;
  const int n_kv = (a.Sk + BKV - 1) / BKV, gb_n = gridDim.x / n_kv;
  const int gb = blockIdx.x % gb_n;
  const int k0 = ((int)blockIdx.x / gb_n) * BKV;
  const int gk = gb % a.G, b = gb / a.G;
  const int rep = a.H / a.G;
  const int kw = k0 + 16 * w;                    // the warp's first key

  // the live query tiles of each head form one range; the ring walks the
  // group's heads, each over that range
  const int n_qt = (a.Sq + BQT - 1) / BQT;
  int lo = 0, hi = n_qt - 1;
  while (lo <= hi && !live(a, lo * BQT, k0, BQT, BKV)) ++lo;
  while (hi >= lo && !live(a, hi * BQT, k0, BQT, BKV)) --hi;
  const int nq = hi - lo + 1, n_it = rep * nq;
  auto stage = [&](int it, int st) {
    const int h = gk * rep + it / nq, q0 = (lo + it % nq) * BQT;
    stage_rows<D, BQT>(Qs + st * BQT * D, a.q + b * a.sq.b + h * a.sq.h,
                       a.sq.s, q0, a.Sq);
    stage_rows<D, BQT>(dOs + st * BQT * D,
                       a.dout + b * a.sdo.b + h * a.sdo.h, a.sdo.s, q0,
                       a.Sq);
    if (threadIdx.x < 2 * BQT) {
      const int r = threadIdx.x % BQT, row = q0 + r;
      const float* src = threadIdx.x < BQT ? a.lse : a.delta;
      const bool in = row < a.Sq;
      cp_async4(Ls + st * 2 * BQT + threadIdx.x,
                src + ((long long)b * a.H + h) * a.Sq + (in ? row : 0), in);
    }
  };

  // K and V (rows at or past Sk zero) land with the first group
  stage_rows<D, BKV>(Ks, a.k + b * a.sk.b + gk * a.sk.h, a.sk.s, k0, a.Sk);
  stage_rows<D, BKV>(Vs, a.v + b * a.sv.b + gk * a.sv.h, a.sv.s, k0, a.Sk);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_it) stage(i, i);
    cp_async_commit();
  }
  const RowA<D> ar(wg ? Vs : Ks, 16 * w + g, t);

  float acc[D / 8][4];       // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it % STAGES;
    float* Qt = Qs + st * BQT * D;
    cp_async_wait<STAGES - 2>();
    scale_rows<D, BQT>(Qt, a.scale);
    __syncthreads();     // tile it landed, scaled; all done with it - 1
    {
      const int nb = it + STAGES - 1;
      if (nb < n_it) stage(nb, nb % STAGES);
      cp_async_commit();
    }
    const float* dOt = dOs + st * BQT * D;
    const float* L = Ls + st * 2 * BQT;
    const int q0 = (lo + it % nq) * BQT;
    const int qa = a.q_off + q0, qz = qa + BQT - 1;
    // the warp's keys see none of this tile / all of it
    const bool skip = kw >= a.Sk || (a.causal && kw > qz) ||
                      (a.window > 0 && kw + 15 <= qa - a.window);
    const bool full = kw + 16 <= a.Sk && q0 + BQT <= a.Sq &&
                      (!a.causal || kw + 15 <= qa) &&
                      (a.window <= 0 || kw > qz - a.window);
    float4* Pw = Ps + w * 4 * 32 + lane;
    float x[4][4];
    if (wg == 0) {
      if (!skip) {
        score<D>(x, ar, RowA<D>(Qt, g, t));      // S^T
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(
              L + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * t + (e & 1);
            const bool ok = full || (q0 + col < a.Sq &&
                                     visible(a, qa + col,
                                             kw + g + 8 * (e >> 1)));
            x[j][e] = ok ? __expf(x[j][e] - ((e & 1) ? l2.y : l2.x)) : 0.f;
          }
          Pw[32 * j] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
        }
      }
      __threadfence_block();
      asm volatile("bar.arrive %0, %1;" :: "n"(P_BAR), "n"(THREADS)
                   : "memory");
      if (!skip) accumulate<D>(acc, x, RowB<D>(dOt, g, t));   // dV
    } else {
      if (!skip) score<D>(x, ar, RowA<D>(dOt, g, t));        // dP^T
      asm volatile("bar.sync %0, %1;" :: "n"(P_BAR), "n"(THREADS)
                   : "memory");
      if (!skip) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 p = Pw[32 * j];
          const float2 d2 = *reinterpret_cast<const float2*>(
              L + BQT + 8 * j + 2 * t);
          x[j][0] = p.x * (x[j][0] - d2.x);
          x[j][1] = p.y * (x[j][1] - d2.y);
          x[j][2] = p.z * (x[j][2] - d2.x);
          x[j][3] = p.w * (x[j][3] - d2.y);
        }
        accumulate<D>(acc, x, RowB<D>(Qt, g, t));            // dK
      }
    }
  }
  cp_async_wait<0>();

  if (wg == 0)
    store_acc<D>(a.dv + b * a.sdv.b + gk * a.sdv.h, a.sdv.s, acc, 1.f,
                 kw + g, t, a.Sk);
  else
    store_acc<D>(a.dk + b * a.sdk.b + gk * a.sdk.h, a.sdk.s, acc, 1.f,
                 kw + g, t, a.Sk);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

enum Kind { FWD = 0, FWD_LSE = 1, BWD_DQ = 2, BWD_DKV = 3 };

template <int D>
constexpr size_t smem_bytes(Kind kind) {
  return sizeof(float) *
         (kind == BWD_DKV ? (2 * BKV + 2 * STAGES * BQT) * D
                                + STAGES * 2 * BQT + 4 * 4 * 32 * 4
          : kind == BWD_DQ ? (2 * FBQ + 2 * STAGES * FBK) * D
                           : (FBQ + STAGES * FBK) * FWD_LDK<D>
                                 + STAGES * FBK * FWD_LDV<D>);
}
static_assert(smem_bytes<128>(FWD) <= 232448, "forward stages overflow");
static_assert(smem_bytes<128>(BWD_DQ) <= 232448, "dq stages overflow");
static_assert(smem_bytes<128>(BWD_DKV) <= 232448, "dk/dv stages overflow");

template <typename K, typename T>
cudaError_t launch(K kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   const Attn<T>& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run(Kind kind, const Attn<T>& a, int B, cudaStream_t stream) {
  const dim3 rows(((a.Sq + FBQ - 1) / FBQ) * a.H * B);
  const dim3 keys(((a.Sk + BKV - 1) / BKV) * a.G * B);
  const size_t smem = smem_bytes<D>(kind);
  switch (kind) {
    case FWD:
      return launch(flash_fwd_kernel<T, D, false>, rows, smem, stream, a);
    case FWD_LSE:
      return launch(flash_fwd_kernel<T, D, true>, rows, smem, stream, a);
    case BWD_DQ:
      return launch(flash_dq_kernel<T, D>, rows, smem, stream, a);
    case BWD_DKV:
      return launch(flash_dkv_kernel<T, D>, keys, smem, stream, a);
  }
  return cudaErrorInvalidValue;
}

// st: batch, head and sequence strides of q, k, v, dO, out (o or dq), dk,
// dv, in that order (21 values; zeros for tensors a kernel does not take).
template <typename T>
int dispatch(Kind kind, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* delta,
             void* out, float* lse_out, void* dk, void* dv,
             const long long* st, int B, int H, int G, int Sq, int Sk, int D,
             float scale, int causal, int window, int q_off, int device,
             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || H <= 0 || G <= 0 || H % G != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  Attn<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<const T*>(dout), lse,
            delta, static_cast<T*>(out), lse_out, static_cast<T*>(dk),
            static_cast<T*>(dv),
         {st[0], st[1], st[2]}, {st[3], st[4], st[5]},
         {st[6], st[7], st[8]}, {st[9], st[10], st[11]},
         {st[12], st[13], st[14]}, {st[15], st[16], st[17]},
         {st[18], st[19], st[20]},
         H, G, Sq, Sk, scale, causal, window, q_off};
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64) return (int)run<T, 64>(kind, a, B, s);
  if (D == 128) return (int)run<T, 128>(kind, a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Each returns the cudaError_t of its launch (0 on success). q, k, v, dO,
// out, dk and dv are of the entry point's element type; lse and delta f32.
#define REPRO_FLASH_ARGS                                                    \
  const void *q, const void *k, const void *v, const void *dout,           \
      const float *lse, const float *delta, void *out, float *lse_out,     \
      void *dk, void *dv, const long long *st, int B, int H, int G,        \
      int Sq, int Sk, int D, float scale, int causal, int window,          \
      int q_off, int device, void *stream
#define REPRO_FLASH_PASS                                                    \
  q, k, v, dout, lse, delta, out, lse_out, dk, dv, st, B, H, G, Sq, Sk, D, \
      scale, causal, window, q_off, device, stream
#define REPRO_FLASH_ENTRIES(SUFFIX, T)                                      \
  extern "C" int repro_flash_fwd_##SUFFIX(REPRO_FLASH_ARGS) {               \
    return dispatch<T>(FWD, REPRO_FLASH_PASS);                              \
  }                                                                         \
  extern "C" int repro_flash_fwd_lse_##SUFFIX(REPRO_FLASH_ARGS) {           \
    return dispatch<T>(FWD_LSE, REPRO_FLASH_PASS);                          \
  }                                                                         \
  extern "C" int repro_flash_bwd_dq_##SUFFIX(REPRO_FLASH_ARGS) {            \
    return dispatch<T>(BWD_DQ, REPRO_FLASH_PASS);                           \
  }                                                                         \
  extern "C" int repro_flash_bwd_dkv_##SUFFIX(REPRO_FLASH_ARGS) {           \
    return dispatch<T>(BWD_DKV, REPRO_FLASH_PASS);                          \
  }

REPRO_FLASH_ENTRIES(f32, float)
REPRO_FLASH_ENTRIES(bf16, __nv_bfloat16)
