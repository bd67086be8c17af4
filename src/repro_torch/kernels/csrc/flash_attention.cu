// Flash attention, forward and backward, for Hopper (sm_90a), on float32 or
// bfloat16 operands.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py:
//   repro_flash_fwd_f32      flash_attention  (_attn_kernel): o only
//   repro_flash_fwd_lse_f32  _fwd_lse         (_attn_kernel_fwd): o and the
//                            per-row logsumexp lse = m + log(l)
//   repro_flash_bwd_dq_f32   _bwd, first call  (_bwd_dq_kernel)
//   repro_flash_bwd_dkv_f32  _bwd, second call (_bwd_dkv_kernel)
// and the same four as _bf16. As the Pallas kernels, each computes p and
// every product at f32 accuracy whatever the operands' dtype and writes o,
// dq, dk and dv in the operands' dtype; lse and delta are f32. On f32
// operands the kernels below run split TF32 on mma.sync. On bf16 operands
// all four are kernels of their own, on the bf16 tensor cores
// (flash_fwd_bf16_kernel, flash_dq_bf16_kernel, flash_dkv_bf16_kernel:
// see "bf16 operands" below).
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
//
// bf16 operands, flash_fwd_bf16_kernel, flash_dq_bf16_kernel and
// flash_dkv_bf16_kernel: bound by operations. At the 400m layer the
// forward's products are 25.8 GFLOP, dq's 38.7 and dk/dv's 51.6, against
// ~0.10, ~0.13 and ~0.15 GB of device memory (0.030, 0.039, 0.045 ms at
// 3.35 TB/s). The bf16 tensor cores multiply two bf16 values exactly into
// an f32 sum at 989 TFLOP/s, so q K^T, dO V^T, K q^T and V dO^T take one
// bf16 product each; P V, dS K, P^T dO and dS^T q have an f32 operand
// that the kernel computes, split into two bf16 parts (below): 38.7, 51.6
// and 77.4 GFLOP on the tensor cores, 0.039, 0.052 and 0.078 ms at their
// peak. What held the first port back was its staging (bf16 tiles
// widened to f32 through registers, then three TF32 MMAs a product: nine
// bf16 MMAs' worth for dq's three products, where four do). The design:
//   * q, k, v and dO stay bf16 from device memory to the tensor cores:
//     16-byte cp.async copies, each tile loaded one tile ahead into a
//     three-stage ring of 64-row tiles stored with the 128-byte swizzle
//     that wgmma reads without bank conflicts (half the f32 staging's
//     bytes, so the ring is deeper);
//   * wgmma m64nNk16 (bf16 operands, f32 accumulators), two warpgroups:
//     the score products read both operands from shared memory (K-major),
//     the second products take the split f32 operand as A fragments in
//     registers, straight from the accumulators, and the bf16 tile MN-major
//     as B: no tile needs a transposed copy (dq reads the K tile of S as
//     dS K's B, as the forward reads V);
//   * accuracy, decided by emulating these MMAs on the CPU
//     (tests/test_torch_flash_bf16_mma.py): the split x = hi + lo, hi =
//     bf16(x), lo = bf16(x - hi), holds x to ~2^-17 of itself (one bf16
//     pass, p or dS rounded to bf16 as PyTorch's bf16 attention does,
//     misses the absolute tolerance 1.9-61 times over where a sum nearly
//     cancels); the scale multiplies q K^T's f32 result (the Pallas kernel
//     scales q first: one f32 rounding a score apart); the tensor cores
//     round each MMA's sum toward zero, yet one chain over all of d, all
//     keys or all the group's queries stays within the f32 kernels'
//     tolerance of float64 at scores of std 8, far below the bf16 outputs'
//     rounding, so these chains are long where the f32 kernels' restart
//     every slice;
//   * each warpgroup issues tile j + 1's score products with tile j's
//     second product and runs its softmax (or forms dS) while that one is
//     on the tensor cores. ptxas waits after every wgmma of a kernel when
//     it finds one in a branch it cannot prove uniform (C7520: a draft
//     with the products under per-tile conditions ran the forward at
//     0.22-0.28 ms a call);
//     here the loops are peeled, so every wgmma is issued in straight-line
//     code and each chain goes out without a wait inside it (the warp index
//     is broadcast, which keeps the branches warp-uniform and saves dk/dv
//     25 registers: tools/flash_ab.py --bf16);
//   * p = 2^((s - m) log2 e) on ex2.approx (0.119 against 0.134 ms for
//     expf by burst, tools/flash_ab.py --bf16; its ~2^-22 error a term is
//     far below the tolerance); dq's p = 2^(s scale log2 e - lse log2 e),
//     one fma before the ex2;
//   * dq keeps the forward's shape: 128 query rows a block, 64 a
//     warpgroup (the rows are wgmma's M), K and V through the ring of
//     64-key tiles, S and dP one accumulator each, dS made on them and
//     split into the A fragments of dS K, the dq accumulator one chain of
//     m64nDk16 over all keys; no atomics, no fusion into dk/dv, so
//     bit-reproducible;
//   * dk/dv keeps the f32 kernel's shape: 64 keys as M, warpgroup 0 S^T,
//     P^T and dV, warpgroup 1 dP^T, dS^T and dK with P^T handed over
//     through shared memory; no atomics, so bit-reproducible; the GQA sum
//     inside the block; the heaviest tiles first; query tiles the mask
//     hides skipped. In the forward and dq both warpgroups walk the
//     block's live tiles, so under the causal mask the first one computes
//     one tile it cannot see (masked to p = 0).
// ptxas (-Xptxas -v, sm_90a), no spills, no C7520: the forward 213-214
// registers (d 128) or 165-168 (d 64), dq 239 or 173, dk/dv 211 or 162;
// dynamic shared memory: the forward 132,096 or 66,560 bytes, dq 164,864
// or 82,944, dk/dv 150,016 or 84,480; one block per SM. On the card
// (PERF.md, chip_smoke.py phase 6, tools/flash_ab.py --bf16) the forward
// runs at ~215 TFLOP/s of its useful 25.8 GFLOP, dq at ~250 of its 38.7
// and dk/dv at ~136 of its 51.6 by burst.
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

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// Stage key rows k0 .. k0 + FBK - 1 of k and v; rows at or past Sk are
// zero-filled (src-size 0), never read.
template <int D>
__device__ __forceinline__ void load_kv(float* Kt, float* Vt, const float* k,
                                        const float* v,
                                        const Attn<float>& a, int k0) {
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
flash_fwd_kernel(Attn<float> a) {
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
template <int D, int R>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
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
    cp_async16(dst + at<D>(r, c), src + row * ld + 4 * c, in);
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
template <int D>
__device__ __forceinline__ void store_acc(float* dst, long long ld,
                                          const float (&acc)[D / 8][4],
                                          float mul, int row, int t,
                                          int n_rows) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row + 8 * i >= n_rows) continue;
    float* p = dst + (long long)(row + 8 * i) * ld + 8 * t;
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

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_kernel(Attn<float> a) {
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
  const float* k = a.k + b * a.sk.b + gk * a.sk.h;
  const float* v = a.v + b * a.sv.b + gk * a.sv.h;
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
    const float* q = a.q + b * a.sq.b + h * a.sq.h;
    const float* dout = a.dout + b * a.sdo.b + h * a.sdo.h;
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

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_kernel(Attn<float> a) {
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
// bf16 operands: the forward and dk/dv on the bf16 tensor cores (wgmma)
// ---------------------------------------------------------------------------
//
// flash_fwd_bf16_kernel and flash_dkv_bf16_kernel keep q, k, v and dO bf16
// from device memory to the tensor cores: 16-byte cp.async copies into a
// two-stage ring of swizzled tiles, read by wgmma (m64nNk16, bf16
// operands, f32 accumulators). A tile of R rows of D bf16 is stored as
// D / 64 blocks of R rows x 128 bytes, 16-byte chunk c of row r at chunk
// c ^ (r % 8) (the 128-byte swizzle, on a 1024-byte aligned base): the
// same tile is a K-major operand (rows as M or N, d as the k dimension:
// q, K, V and dO in the score products) and an MN-major one (rows as the
// k dimension, d as N: V, dO and q in the second products), so no tile
// needs a transposed copy.

constexpr int WBQ = 128;     // query rows per bf16 forward block, 64 a warpgroup
constexpr int WBK = 64;      // key rows per forward tile
constexpr int WBKV = 64;     // key rows per bf16 dk/dv block
constexpr int WBQT = 64;     // query rows per bf16 dk/dv tile
constexpr int WSTAGES = 3;   // tiles in the bf16 kernels' cp.async rings

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(full ? 16 : 0) : "memory");
}

// cp.async writes through the generic proxy, wgmma reads through the
// async one: each thread fences its landed copies before the barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Byte offset of 16-byte chunk c of row r in a swizzled tile of R rows.
template <int R>
__device__ __forceinline__ uint32_t sw(int r, int c) {
  return (c >> 3) * (R * 128) + r * 128 + (((c ^ r) & 7) << 4);
}

// Stage rows row0 .. row0 + R - 1 of src (row stride ld) into the tile at
// dst; rows at or past n_rows are zero-filled, never read.
template <int D, int R>
__device__ __forceinline__ void stage_bf16(uint32_t dst,
                                           const __nv_bfloat16* src,
                                           long long ld, int row0,
                                           int n_rows) {
  constexpr int C = D / 8;
  static_assert(R * C % THREADS == 0, "whole rounds of 16-byte chunks");
#pragma unroll
  for (int it = 0; it < R * C / THREADS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int r = idx / C, c = idx % C;
    const bool in = row0 + r < n_rows;
    cp_async16(dst + sw<R>(r, c),
               src + (long long)(in ? row0 + r : 0) * ld + 8 * c, in);
  }
}

// The shared-memory matrix descriptor of wgmma: start address, leading
// and stride byte offsets (16-byte units), 128-byte swizzle. SBO is 1024
// (8 rows of 128 bytes) in both uses.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// A K-major operand: rows from `tile` on as M or N, d as the k dimension
// (LBO unused). Its slice d = 16 ks .. 16 ks + 15 in a tile of R rows is
// the descriptor plus kstep<R>(ks) (16-byte units of the start address).
__device__ __forceinline__ uint64_t kmajor(uint32_t tile) {
  return wg_desc(tile, 16);
}
template <int R>
__device__ __forceinline__ constexpr uint64_t kstep(int ks) {
  return ((ks >> 2) * (R * 128) + (ks & 3) * 32) >> 4;
}

// An MN-major operand: a tile of R rows as the k dimension, all of d as N
// (LBO: the stride of the 64-wide column blocks). Rows 16 kk .. 16 kk +
// 15 are the descriptor plus 128 kk (2048 bytes a slice).
template <int R>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile) {
  return wg_desc(tile, R * 128);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across its issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[i][e]) :: "memory");
}

#define WG_ACC8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d = A B (first == 1: d's old value is dropped) or d += A B, m64n64k16:
// A (64 x 16) and B (16 x 64) bf16 in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int first) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24)
      : "l"(da), "l"(db), "r"(first));
}

// d += A B, m64nNk16 (N = 64 or 128, the head dim): A (64 x 16) bf16
// fragments in registers, B (16 x N) bf16 in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24), WG_ACC8(32),
        WG_ACC8(40), WG_ACC8(48), WG_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef WG_ACC8

// Accumulator layout of m64nNk16 (f32): warp w of the warpgroup holds
// rows 16 w + g (d[4 j], d[4 j + 1]) and 16 w + g + 8 (d[4 j + 2], d[4 j +
// 3]) at columns 8 j + 2t and 8 j + 2t + 1 (lane = 4 g + t). The A
// register fragment of a 16-wide k slice is mma.sync m16n8k16's: a[0]
// (row g, k 2t, 2t + 1), a[1] (row g + 8, the same k), a[2] and a[3] at
// k + 8. So accumulator columns 16 kk .. 16 kk + 15 (n8 blocks 2 kk and
// 2 kk + 1) are slice kk's A fragment as they lie, two to a register.
//
// An f32 operand x that the kernel computes (p, p^T, dS^T) is split into
// hi = bf16(x) and lo = bf16(x - hi) (x - hi is exact in f32): hi + lo
// holds x to ~2^-17 of itself, and the product takes two bf16 MMAs, lo
// then hi, into the f32 accumulator. One pass (p rounded to bf16, as
// PyTorch's bf16 attention does) errs by 2^-9 a term, beyond the
// kernels' absolute tolerance wherever the sum nearly cancels
// (tests/test_torch_flash_bf16_mma.py).
template <int NC>
struct SplitBF16 {
  uint32_t hi[NC / 16][4], lo[NC / 16][4];
  __device__ __forceinline__ void set(const float (&x)[NC / 2]) {
#pragma unroll
    for (int kk = 0; kk < NC / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = x[8 * kk + 2 * r], x1 = x[8 * kk + 2 * r + 1];
        const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(h);
        const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x,
                                                       x1 - hf.y);
        hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
        lo[kk][r] = *reinterpret_cast<const uint32_t*>(&l);
      }
  }
  __device__ __forceinline__ void fence() {
    fence_regs(hi);
    fence_regs(lo);
  }
};

// d += x B over a tile's WB rows (the k dimension): x's split fragments
// as A, B (descriptor db) an MN-major bf16 tile; lo then hi for each
// 16-row slice.
template <int WB, int N>
__device__ __forceinline__ void wgmma_split(float (&d)[N],
                                            const SplitBF16<WB>& x,
                                            uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < WB / 16; ++kk) {
    wgmma_rs(d, x.lo[kk], db + 128 * kk);
    wgmma_rs(d, x.hi[kk], db + 128 * kk);
  }
}

// d = A B^T over the head dim (a score product): A (descriptor da) 64
// rows of a K-major tile of RA rows, B (db) a K-major tile of 64 rows;
// one chain of D / 16 wgmma from zero. The descriptors are warp-uniform
// values stepped by constants, so that they stay in uniform registers and
// the chain is issued without a wait between its wgmma.
template <int D, int RA>
__device__ __forceinline__ void wgmma_scores(float (&d)[32], uint64_t da,
                                             uint64_t db) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_ss(d, da + kstep<RA>(ks), db + kstep<64>(ks), ks == 0);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rows `row` (d[4 n], d[4 n + 1]) and `row + 8` (d[4 n + 2], d[4 n + 3])
// of a warpgroup accumulator over the head dim, times mul[0] and mul[1],
// into dst as bf16 pairs (row stride ld), rows at or past n_rows dropped.
template <int D>
__device__ __forceinline__ void store_wg(__nv_bfloat16* dst, long long ld,
                                         const float (&d)[D / 2],
                                         const float (&mul)[2], int row,
                                         int t, int n_rows) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row + 8 * i >= n_rows) continue;
    __nv_bfloat16* p = dst + (long long)(row + 8 * i) * ld + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * n) = __floats2bfloat162_rn(
          d[4 * n + 2 * i] * mul[i], d[4 * n + 2 * i + 1] * mul[i]);
  }
}

// The bf16 forward: a 1-d grid of ceil(Sq / WBQ) * H * B blocks, the last
// q-tile first, as the f32 forward. Two warpgroups, each owning 64 rows
// of the 128-row query tile (q staged once); K and V stream through a
// three-stage ring of 64-key tiles, each loaded one tile ahead, and both
// warpgroups walk the block's live tiles (under the causal mask the first
// warpgroup's last one is all masked). Per tile a warpgroup computes S =
// q K^T in D / 16 wgmma (one accumulator chain over d, then times the
// scale: the Pallas kernel scales q in f32 first, one f32 rounding a score
// apart), runs the online softmax on the accumulators (quad shuffles, as
// the f32 kernel; p = 2^((s - m) log2 e)), multiplies O by the correction
// and adds P V into O: P from the S accumulators split into A fragments
// (hi, lo), V from shared memory, two wgmma a 16-key slice, one chain over
// all keys (the long chains stay within 2e-5 of float64 where the scores
// are large, below the bf16 output's rounding;
// tests/test_torch_flash_bf16_mma.py). The P V of tile j is issued with
// the S of tile j + 1, so that each warpgroup's softmax runs while its
// previous tile's P V is on the tensor cores; the ring keeps tile j's V
// until then. The loop is peeled (the first tile's S alone, the last
// tile's P V alone) and every branch is warp-uniform, so that ptxas
// issues each chain of wgmma without a wait between them.
template <int D, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_bf16_kernel(Attn<__nv_bfloat16> a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr uint32_t KVB = WBK * D * 2;          // bytes of a K or V tile
  constexpr float LOG2E = 1.4426950408889634f;
  const uint32_t Qs = (smem_u32(smem) + 1023) & ~1023u;   // [WBQ][D]
  const uint32_t KVs = Qs + WBQ * D * 2;         // [WSTAGES][K, V][WBK][D]
  // the warp index broadcast, so that the compiler knows it (and all that
  // depends on it) to be warp-uniform
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32, wg = warp / 4, w = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int n_q = (a.Sq + WBQ - 1) / WBQ, bh_n = gridDim.x / n_q;
  const int bh = blockIdx.x % bh_n;
  const int q0 = (n_q - 1 - (int)blockIdx.x / bh_n) * WBQ;
  const int h = bh % a.H, b = bh / a.H;
  const int gk = h / (a.H / a.G);
  const __nv_bfloat16* k = a.k + b * a.sk.b + gk * a.sk.h;
  const __nv_bfloat16* v = a.v + b * a.sv.b + gk * a.sv.h;
  const int rw = q0 + 64 * wg + 16 * w;          // the warp's rows
  const int wa = a.q_off + rw, wb = wa + 15;

  // the live key tiles form one range
  const int n_kv = (a.Sk + WBK - 1) / WBK;
  int lo = 0, hi = n_kv - 1;
  while (lo <= hi && !live(a, q0, lo * WBK, WBQ, WBK)) ++lo;
  while (hi >= lo && !live(a, q0, hi * WBK, WBQ, WBK)) --hi;
  auto kv = [&](int kb) { return KVs + ((kb - lo) % WSTAGES) * 2 * KVB; };
  // tile kb landed (after every copy this thread issued), tile kb + 1 on
  // its way into the stage of tile kb - 2, whose P V has completed
  auto next = [&](int kb) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    if (kb + 1 <= hi) {
      const uint32_t st = kv(kb + 1);
      stage_bf16<D, WBK>(st, k, a.sk.s, (kb + 1) * WBK, a.Sk);
      stage_bf16<D, WBK>(st + KVB, v, a.sv.s, (kb + 1) * WBK, a.Sk);
    }
    cp_async_commit();
  };

  float o[D / 2], s[WBK / 2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float corr[2];
  SplitBF16<WBK> p;                              // P of the last tile
  const uint64_t dq = kmajor(Qs + 64 * wg * 128);
  auto scores = [&](int kb) {                    // S = q K^T, issued
#pragma unroll
    for (int i = 0; i < WBK / 2; ++i) s[i] = 0.f;
    fence_regs(s);
    wg_fence();
    wgmma_scores<D, WBQ>(s, dq, kmajor(kv(kb)));
    wg_commit();
  };
  auto pv = [&](int kb) {                        // O += P V of tile kb
    fence_regs(o);
    p.fence();
    wg_fence();
    wgmma_split(o, p, mnmajor<WBK>(kv(kb) + KVB));
    wg_commit();
  };
  // S (landed) times the scale, masked, into P (in s); m, l and the
  // correction corr of O updated. A row's 4 threads share a quad; l
  // stays a per-thread partial sum until the end.
  auto softmax = [&](int kb) {
    fence_regs(s);
    const int k0 = kb * WBK;
    // masks only where this warp's rows see part of the tile
    const bool full = k0 + WBK <= a.Sk && (!a.causal || k0 + WBK - 1 <= wa)
                      && (a.window <= 0 || k0 > wb - a.window);
#pragma unroll
    for (int j = 0; j < WBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[4 * j + e] *= a.scale;
    if (!full) {
#pragma unroll
      for (int j = 0; j < WBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * j + e] = visible(a, wa + g + 8 * (e >> 1),
                                 k0 + 8 * j + 2 * t + (e & 1))
                             ? s[4 * j + e] : NEG_INF;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < WBK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[i] = ex2((m[i] - mx) * LOG2E);
      m[i] = mx;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < WBK / 8; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          s[4 * j + e] = ex2((s[4 * j + e] - mx) * LOG2E);
          rs += s[4 * j + e];
        }
      l[i] = l[i] * corr[i] + rs;
    }
  };

  // q (rows at or past Sq zero) lands with the first K/V tile
  stage_bf16<D, WBQ>(Qs, a.q + b * a.sq.b + h * a.sq.h, a.sq.s, q0, a.Sq);
  if (lo <= hi) {
    stage_bf16<D, WBK>(kv(lo), k, a.sk.s, lo * WBK, a.Sk);
    stage_bf16<D, WBK>(kv(lo) + KVB, v, a.sv.s, lo * WBK, a.Sk);
  }
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  if (lo <= hi) {
    next(lo);
    scores(lo);
    wg_wait<0>();
    softmax(lo);                                 // O is 0: no correction
    p.set(s);
    for (int kb = lo + 1; kb <= hi; ++kb) {
      next(kb);
      scores(kb);
      pv(kb - 1);
      wg_wait<1>();
      softmax(kb);
      wg_wait<0>();
      fence_regs(o);
      p.fence();
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * n + e] *= corr[e >> 1];
      p.set(s);
    }
    pv(hi);
    wg_wait<0>();
    fence_regs(o);
    p.fence();
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li = fmaxf(li, 1e-30f);
    inv[i] = 1.f / li;
    const int row = rw + g + 8 * i;
    if (LSE && t == 0 && row < a.Sq)
      a.lse_out[((long long)b * a.H + h) * a.Sq + row] = m[i] + logf(li);
  }
  store_wg<D>(a.out + b * a.sout.b + h * a.sout.h, a.sout.s, o, inv,
              rw + g, t, a.Sq);
}

// The bf16 dq: a 1-d grid of ceil(Sq / WBQ) * H * B blocks, the last
// q-tile first, as the forward. Two warpgroups, each owning 64 rows of
// the 128-row query tile (q and dO staged once); K and V stream through a
// three-stage ring of 64-key tiles, each loaded one tile ahead, and both
// warpgroups walk the block's live tiles (under the causal mask the first
// warpgroup's last one is all masked). Per tile a warpgroup computes S =
// q K^T and dP = dO V^T (D / 16 wgmma each, both operands K-major from
// shared memory, one chain over d), then p = 2^((S scale - lse) log2 e)
// where visible (0 elsewhere) and dS = p (dP - delta) on the
// accumulators, and adds dS K into dq: dS split into A fragments (hi, lo),
// K read MN-major as B from the tile S read K-major (as the forward reads
// V), two wgmma a 16-key slice, one chain over all keys; the scale
// multiplies dq at the store. Tile j's dS K is issued with tile j + 1's S
// and dP, so that each warpgroup forms dS while the previous tile's
// product is on the tensor cores; the ring keeps tile j's K until then.
// The loop is peeled and every branch is warp-uniform, as in the forward.
// No atomics: bit-reproducible.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_bf16_kernel(Attn<__nv_bfloat16> a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr uint32_t KVB = WBK * D * 2;          // bytes of a K or V tile
  constexpr uint32_t QB = WBQ * D * 2;           // bytes of the q or dO tile
  constexpr float LOG2E = 1.4426950408889634f;
  const uint32_t Qs = (smem_u32(smem) + 1023) & ~1023u;   // [WBQ][D]
  const uint32_t dOs = Qs + QB;                  // [WBQ][D]
  const uint32_t KVs = dOs + QB;                 // [WSTAGES][K, V][WBK][D]
  // the warp index broadcast, so that the compiler knows it (and all that
  // depends on it) to be warp-uniform
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32, wg = warp / 4, w = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int n_q = (a.Sq + WBQ - 1) / WBQ, bh_n = gridDim.x / n_q;
  const int bh = blockIdx.x % bh_n;
  const int q0 = (n_q - 1 - (int)blockIdx.x / bh_n) * WBQ;
  const int h = bh % a.H, b = bh / a.H;
  const int gk = h / (a.H / a.G);
  const __nv_bfloat16* k = a.k + b * a.sk.b + gk * a.sk.h;
  const __nv_bfloat16* v = a.v + b * a.sv.b + gk * a.sv.h;
  const int rw = q0 + 64 * wg + 16 * w;          // the warp's rows
  const int wa = a.q_off + rw, wb = wa + 15;

  // the live key tiles form one range
  const int n_kv = (a.Sk + WBK - 1) / WBK;
  int lo = 0, hi = n_kv - 1;
  while (lo <= hi && !live(a, q0, lo * WBK, WBQ, WBK)) ++lo;
  while (hi >= lo && !live(a, q0, hi * WBK, WBQ, WBK)) --hi;
  auto kv = [&](int kb) { return KVs + ((kb - lo) % WSTAGES) * 2 * KVB; };
  // tile kb landed (after every copy this thread issued), tile kb + 1 on
  // its way into the stage of tile kb - 2, whose dS K has completed
  auto next = [&](int kb) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    if (kb + 1 <= hi) {
      const uint32_t st = kv(kb + 1);
      stage_bf16<D, WBK>(st, k, a.sk.s, (kb + 1) * WBK, a.Sk);
      stage_bf16<D, WBK>(st + KVB, v, a.sv.s, (kb + 1) * WBK, a.Sk);
    }
    cp_async_commit();
  };

  // lse (times log2 e) and delta of the thread's rows rw + g and rw + g +
  // 8; rows at or past Sq read 0 (their q and dO are 0: dS = 0)
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rw + g + 8 * i;
    const long long at_row = ((long long)b * a.H + h) * a.Sq + row;
    lse2[i] = row < a.Sq ? a.lse[at_row] * LOG2E : 0.f;
    dl[i] = row < a.Sq ? a.delta[at_row] : 0.f;
  }
  const float sl2 = a.scale * LOG2E;

  float acc[D / 2], s[WBK / 2], dp[WBK / 2];
  SplitBF16<WBK> ds;                             // dS of the last tile
  const uint64_t qd = kmajor(Qs + 64 * wg * 128);
  const uint64_t dod = kmajor(dOs + 64 * wg * 128);
  auto scores = [&](int kb) {                    // S = q K^T, dP = dO V^T
#pragma unroll
    for (int i = 0; i < WBK / 2; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wg_fence();
    wgmma_scores<D, WBQ>(s, qd, kmajor(kv(kb)));
    wgmma_scores<D, WBQ>(dp, dod, kmajor(kv(kb) + KVB));
    wg_commit();
  };
  auto dsk = [&](int kb) {                       // dq += dS K of tile kb
    fence_regs(acc);
    ds.fence();
    wg_fence();
    wgmma_split(acc, ds, mnmajor<WBK>(kv(kb)));
    wg_commit();
  };
  // the landed S and dP into dS (in s), masked to 0 where not visible
  auto grads = [&](int kb) {
    fence_regs(s);
    fence_regs(dp);
    const int k0 = kb * WBK;
    // masks only where this warp's rows see part of the tile
    const bool full = k0 + WBK <= a.Sk && (!a.causal || k0 + WBK - 1 <= wa)
                      && (a.window <= 0 || k0 > wb - a.window);
#pragma unroll
    for (int j = 0; j < WBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = ex2(s[4 * j + e] * sl2 - lse2[i]);
        if (!full &&
            !visible(a, wa + g + 8 * i, k0 + 8 * j + 2 * t + (e & 1)))
          p = 0.f;
        s[4 * j + e] = p * (dp[4 * j + e] - dl[i]);
      }
  };

  // q and dO (rows at or past Sq zero) land with the first K/V tile
  stage_bf16<D, WBQ>(Qs, a.q + b * a.sq.b + h * a.sq.h, a.sq.s, q0, a.Sq);
  stage_bf16<D, WBQ>(dOs, a.dout + b * a.sdo.b + h * a.sdo.h, a.sdo.s, q0,
                     a.Sq);
  if (lo <= hi) {
    stage_bf16<D, WBK>(kv(lo), k, a.sk.s, lo * WBK, a.Sk);
    stage_bf16<D, WBK>(kv(lo) + KVB, v, a.sv.s, lo * WBK, a.Sk);
  }
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  if (lo <= hi) {
    next(lo);
    scores(lo);
    wg_wait<0>();
    grads(lo);
    ds.set(s);
    for (int kb = lo + 1; kb <= hi; ++kb) {
      next(kb);
      scores(kb);
      dsk(kb - 1);
      wg_wait<1>();
      grads(kb);
      wg_wait<0>();
      fence_regs(acc);
      ds.fence();
      ds.set(s);
    }
    dsk(hi);
    wg_wait<0>();
    fence_regs(acc);
    ds.fence();
  }

  const float mul[2] = {a.scale, a.scale};
  store_wg<D>(a.out + b * a.sout.b + h * a.sout.h, a.sout.s, acc, mul,
              rw + g, t, a.Sq);
}

// The bf16 dk, dv: a 1-d grid of ceil(Sk / WBKV) * G * B blocks, the
// first kv-tile first, as the f32 kernel; the group's query heads and
// their query tiles (q, dO, lse, delta) stream through a three-stage ring
// of 64-query tiles, each loaded one tile ahead. Two warpgroups over the
// same 64 keys, the key rows the MMAs' M: warpgroup 0 computes S^T = K q^T
// (times the scale), P^T = exp(S^T - lse) and dV += P^T dO; warpgroup 1
// computes dP^T = V dO^T, takes P^T from warpgroup 0 through shared memory
// (named barrier P_BAR), and computes dS^T = P^T (dP^T - delta) and dK +=
// dS^T q (scaled once at the store). The score products read both operands
// from shared memory (D / 16 wgmma); P^T and dS^T go from their
// accumulators into A fragments split hi and lo (two wgmma a 16-query
// slice, one chain over all the group's queries), and tile j's second
// product is issued with tile j + 1's score product, the loop peeled as in
// the forward. No atomics, the GQA sum inside the block: bit-reproducible.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_bf16_kernel(Attn<__nv_bfloat16> a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr uint32_t TB = 64 * D * 2;            // bytes of a 64-row tile
  static_assert(WBKV == 64 && WBQT == 64, "64-row tiles");
  const uint32_t s0 = smem_u32(smem), base = (s0 + 1023) & ~1023u;
  const uint32_t Ks = base, Vs = Ks + TB;        // [WBKV][D] each
  const uint32_t QdO = Vs + TB;                  // [WSTAGES][q, dO][WBQT][D]
  float* Ls = reinterpret_cast<float*>(smem + (base - s0) + 2 * TB
                                       + WSTAGES * 2 * TB);
                                                 // [WSTAGES][lse, delta][WBQT]
  float4* Ps = reinterpret_cast<float4*>(Ls + WSTAGES * 2 * WBQT);
                                                 // [4 warps][8][32 lanes]
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32, wg = warp / 4, w = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int n_kv = (a.Sk + WBKV - 1) / WBKV, gb_n = gridDim.x / n_kv;
  const int gb = blockIdx.x % gb_n;
  const int k0 = ((int)blockIdx.x / gb_n) * WBKV;
  const int gk = gb % a.G, b = gb / a.G;
  const int rep = a.H / a.G;
  const int kw = k0 + 16 * w;                    // the warp's first key

  // the live query tiles of each head form one range; the ring walks the
  // group's heads, each over that range
  const int n_qt = (a.Sq + WBQT - 1) / WBQT;
  int lo = 0, hi = n_qt - 1;
  while (lo <= hi && !live(a, lo * WBQT, k0, WBQT, WBKV)) ++lo;
  while (hi >= lo && !live(a, hi * WBQT, k0, WBQT, WBKV)) --hi;
  const int nq = hi - lo + 1, n_it = rep * nq;
  auto qdo = [&](int it) { return QdO + (it % WSTAGES) * 2 * TB; };
  auto stage = [&](int it) {
    const int h = gk * rep + it / nq, q0 = (lo + it % nq) * WBQT;
    stage_bf16<D, WBQT>(qdo(it), a.q + b * a.sq.b + h * a.sq.h, a.sq.s, q0,
                        a.Sq);
    stage_bf16<D, WBQT>(qdo(it) + TB, a.dout + b * a.sdo.b + h * a.sdo.h,
                        a.sdo.s, q0, a.Sq);
    if (threadIdx.x < 2 * WBQT) {
      const int r = threadIdx.x % WBQT, row = q0 + r;
      const float* src = threadIdx.x < WBQT ? a.lse : a.delta;
      const bool in = row < a.Sq;
      cp_async4(Ls + (it % WSTAGES) * 2 * WBQT + threadIdx.x,
                src + ((long long)b * a.H + h) * a.Sq + (in ? row : 0), in);
    }
  };
  // tile it landed, tile it + 1 on its way into the stage of tile it - 2
  auto next = [&](int it) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    if (it + 1 < n_it) stage(it + 1);
    cp_async_commit();
  };

  float acc[D / 2];          // dV (warpgroup 0) or dK (warpgroup 1)
  float x[WBQT / 2];
  SplitBF16<WBQT> y;         // P^T or dS^T of the last tile
  const uint64_t da = kmajor(wg ? Vs : Ks);      // the score product's A
  // S^T = K q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1), issued
  auto scores = [&](int it) {
#pragma unroll
    for (int i = 0; i < WBQT / 2; ++i) x[i] = 0.f;
    fence_regs(x);
    wg_fence();
    wgmma_scores<D, WBKV>(x, da, kmajor(qdo(it) + (wg ? TB : 0)));
    wg_commit();
  };
  // dV += P^T dO (warpgroup 0) or dK += dS^T q (warpgroup 1) of tile it
  auto second = [&](int it) {
    fence_regs(acc);
    y.fence();
    wg_fence();
    wgmma_split(acc, y, mnmajor<WBQT>(qdo(it) + (wg ? 0 : TB)));
    wg_commit();
  };
  // the landed scores into P^T (warpgroup 0, handed to warpgroup 1) or
  // dS^T (warpgroup 1), in x
  auto grads = [&](int it) {
    fence_regs(x);
    const float* L = Ls + (it % WSTAGES) * 2 * WBQT;
    const int q0 = (lo + it % nq) * WBQT;
    const int qa = a.q_off + q0, qz = qa + WBQT - 1;
    // the warp's keys see all of this tile
    const bool full = kw + 16 <= a.Sk && q0 + WBQT <= a.Sq &&
                      (!a.causal || kw + 15 <= qa) &&
                      (a.window <= 0 || kw > qz - a.window);
    float4* Pw = Ps + w * 8 * 32 + lane;
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < WBQT / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(L + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const bool ok = full || (q0 + col < a.Sq &&
                                   visible(a, qa + col,
                                           kw + g + 8 * (e >> 1)));
          x[4 * j + e] = ok ? __expf(x[4 * j + e] * a.scale
                                     - ((e & 1) ? l2.y : l2.x))
                            : 0.f;
        }
        Pw[32 * j] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2],
                                 x[4 * j + 3]);
      }
      __threadfence_block();
      asm volatile("bar.arrive %0, %1;" :: "n"(P_BAR), "n"(THREADS)
                   : "memory");
    } else {
      asm volatile("bar.sync %0, %1;" :: "n"(P_BAR), "n"(THREADS)
                   : "memory");
#pragma unroll
      for (int j = 0; j < WBQT / 8; ++j) {
        const float4 p = Pw[32 * j];
        const float2 d2 = *reinterpret_cast<const float2*>(
            L + WBQT + 8 * j + 2 * t);
        x[4 * j] = p.x * (x[4 * j] - d2.x);
        x[4 * j + 1] = p.y * (x[4 * j + 1] - d2.y);
        x[4 * j + 2] = p.z * (x[4 * j + 2] - d2.x);
        x[4 * j + 3] = p.w * (x[4 * j + 3] - d2.y);
      }
    }
  };

  // K and V (rows at or past Sk zero) land with the first query tile
  stage_bf16<D, WBKV>(Ks, a.k + b * a.sk.b + gk * a.sk.h, a.sk.s, k0, a.Sk);
  stage_bf16<D, WBKV>(Vs, a.v + b * a.sv.b + gk * a.sv.h, a.sv.s, k0, a.Sk);
  if (n_it > 0) stage(0);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  if (n_it > 0) {
    next(0);
    scores(0);
    wg_wait<0>();
    grads(0);
    y.set(x);
    for (int it = 1; it < n_it; ++it) {
      next(it);
      scores(it);
      second(it - 1);
      wg_wait<1>();
      grads(it);
      wg_wait<0>();
      fence_regs(acc);
      y.fence();
      y.set(x);
    }
    second(n_it - 1);
    wg_wait<0>();
    fence_regs(acc);
    y.fence();
  }

  const float mul[2] = {wg ? a.scale : 1.f, wg ? a.scale : 1.f};
  if (wg == 0)
    store_wg<D>(a.dv + b * a.sdv.b + gk * a.sdv.h, a.sdv.s, acc, mul,
                kw + g, t, a.Sk);
  else
    store_wg<D>(a.dk + b * a.sdk.b + gk * a.sdk.h, a.sdk.s, acc, mul,
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

// The bf16 kernels: bf16 tiles, 1024 bytes of slack to align the
// swizzled tiles, and dk/dv's lse, delta and P^T hand-over.
template <int D>
constexpr size_t smem_bytes_bf16(Kind kind) {
  return 1024 + (kind == BWD_DKV
                     ? 2 * (2 * WBKV + WSTAGES * 2 * WBQT) * D
                           + sizeof(float) * (WSTAGES * 2 * WBQT
                                              + 4 * 8 * 32 * 4)
                 : kind == BWD_DQ ? 2 * (2 * WBQ + WSTAGES * 2 * WBK) * D
                                  : 2 * (WBQ + WSTAGES * 2 * WBK) * D);
}
static_assert(smem_bytes_bf16<128>(FWD) <= 232448, "forward stages overflow");
static_assert(smem_bytes_bf16<128>(BWD_DQ) <= 232448, "dq stages overflow");
static_assert(smem_bytes_bf16<128>(BWD_DKV) <= 232448,
              "dk/dv stages overflow");

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
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    // wgmma; the grids are the f32 kernels'
    static_assert(WBQ == FBQ && WBKV == BKV, "the f32 kernels' grids");
    const size_t smem = smem_bytes_bf16<D>(kind);
    switch (kind) {
      case FWD:
        return launch(flash_fwd_bf16_kernel<D, false>, rows, smem, stream, a);
      case FWD_LSE:
        return launch(flash_fwd_bf16_kernel<D, true>, rows, smem, stream, a);
      case BWD_DQ:
        return launch(flash_dq_bf16_kernel<D>, rows, smem, stream, a);
      case BWD_DKV:
        return launch(flash_dkv_bf16_kernel<D>, keys, smem, stream, a);
    }
  } else {
    const size_t smem = smem_bytes<D>(kind);
    switch (kind) {
      case FWD:
        return launch(flash_fwd_kernel<D, false>, rows, smem, stream, a);
      case FWD_LSE:
        return launch(flash_fwd_kernel<D, true>, rows, smem, stream, a);
      case BWD_DQ:
        return launch(flash_dq_kernel<D>, rows, smem, stream, a);
      case BWD_DKV:
        return launch(flash_dkv_kernel<D>, keys, smem, stream, a);
    }
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
