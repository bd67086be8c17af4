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
// What bounds it: operations. A (64 x 64) tile pair does 2 * 64 * 64 * D
// flops per product against 2 * 64 * D floats loaded, so at D = 128 the
// forward does ~50 flops per byte of device memory it reads, far above
// the card's f32 ridge (67 TFLOP/s over 3.35 TB/s = 20). The scores never
// reach device memory in either pass. This first version keeps to
// float32 CUDA cores (no tensor cores, so no TF32 rounding, as the rest of
// the port) with a simple tiled design:
//   * 256 threads as a 16 x 16 grid; a thread owns 4 rows of the tile
//     (ty * 4 + i) and, of a score tile, the 4 columns tx + 16 * j, of an
//     output tile the D / 16 columns tx * 4 + 64 * jj + e;
//   * the q tile (or, in dk/dv, the k and v tiles) stays in shared memory
//     for the whole block; the other operand's tiles stream through shared
//     memory, rows padded to D + 4 floats so that the 16-byte reads of a
//     score product and of an output product are free of bank conflicts;
//   * the online softmax runs in registers; row maxima and sums are
//     shuffles across the 16 threads of a row group;
//   * probabilities (or dS) go through shared memory to the second
//     product of the tile.
// dk and dv are summed over the GQA group inside dkv: a block owns one kv
// tile and loops over the group's query heads, so no per-query-head
// (B, H, Sk, D) intermediates are written. Later work: wgmma, TMA and a
// pipeline of tiles.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // key rows per tile
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
__device__ __forceinline__ bool live(const Attn& a, int q0, int k0) {
  const int q_first = a.q_off + q0, q_last = q_first + BQ - 1;
  if (a.causal && k0 > q_last) return false;
  if (a.window > 0 && k0 + BK - 1 <= q_first - a.window) return false;
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

// Reductions over the 16 threads of a row group (lanes 0-15 or 16-31).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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
// forward: grid (ceil(Sq / 64), H, B)
// ---------------------------------------------------------------------------

template <int D, bool LSE>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(Attn a) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [BQ][D + 4], scaled
  float* Ks = Qs + BQ * (D + 4);                  // [BK][D + 4]
  float* Vs = Ks + BK * (D + 4);                  // [BK][D + 4]
  float* Ps = Vs + BK * (D + 4);                  // [BQ][PLD]
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16, ra = ty * 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const float* k = a.k + b * a.sk.b + g * a.sk.h;
  const float* v = a.v + b * a.sv.b + g * a.sv.h;
  load_tile<D>(Qs, a.q + b * a.sq.b + h * a.sq.h, a.sq.s, q0, a.Sq,
               a.scale);

  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }
  const int n_kv = (a.Sk + BK - 1) / BK;
  for (int kb = 0; kb < n_kv; ++kb) {
    const int k0 = kb * BK;
    if (!live(a, q0, k0)) continue;
    __syncthreads();      // the previous tile's readers are done
    load_tile<D>(Ks, k, a.sk.s, k0, a.Sk, 1.f);
    load_tile<D>(Vs, v, a.sv.s, k0, a.Sk, 1.f);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    mm_nt<D>(s, Qs, Ks, ra, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = a.q_off + q0 + ra + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!visible(a, qp, k0 + tx + 16 * j)) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ra + i) * PLD + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    mm_nn<D>(acc, Ps, Vs, ra, tx);
  }
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / li;
    const int row = q0 + ra + i;
    if (LSE && tx == 0 && row < a.Sq)
      a.lse_out[((long long)b * a.H + h) * a.Sq + row] = m[i] + logf(li);
  }
  store_rows<D>(a.out + b * a.sout.b + h * a.sout.h, a.sout.s, acc, inv,
                q0, ra, tx, a.Sq);
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
                           : 3 * 64 * (D + 4) + 64 * PLD);
}

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
  const size_t smem = smem_bytes<D>(kind);
  switch (kind) {
    case FWD:
      return launch(flash_fwd_kernel<D, false>, rows, smem, stream, a);
    case FWD_LSE:
      return launch(flash_fwd_kernel<D, true>, rows, smem, stream, a);
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
