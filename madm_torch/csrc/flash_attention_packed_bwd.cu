// K5: packed-head flash-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel madm_tpu/ops/flash_attention.py::_packed_bwd_kernel
// (pallas_call in _packed_bwd_impl), the backward of K4
// (flash_attention_packed.cu).  For o = softmax(q k^T * scale) v on the
// packed self-attention shapes (Sq == Sk, S % 64 == 0, D <= 64) and the
// incoming gradient dO it computes, as the TPU kernel does, from q, k, v and
// dO alone (no saved output or statistics):
//   P     = softmax(q k^T * scale)       (row statistics recomputed)
//   dP    = dO V^T,  delta = rowsum(dP * P)
//   dS    = P * (dP - delta)
//   dQ    = dS K * scale,  dK = dS^T Q * scale,  dV = P^T dO
// on contiguous [B, S, H, D] tensors, G heads to a block.
//
// The TPU kernel walks the q blocks of a head group in order and accumulates
// dK'/dV' in the packed block-diagonal [G*S, G*D] layout (3x the MACs on
// zeros).  Hopper blocks run in parallel in no order, so this port follows
// FlashAttention-2's split, without atomics and deterministic:
//   1. dq kernel: parallel over q tiles of G heads; a first pass over the K/V
//      tiles finds each row's max, sum and delta = rowsum(dP * P) (online,
//      rescaled as the max moves) and writes the base-2 log-sum-exp and delta
//      to fp32 scratch [B, H, S]; a second pass accumulates dQ;
//   2. dkdv kernel: parallel over K/V tiles of G heads, loops over the q tiles
//      with their statistics and keeps dK/dV in registers.
// As in K4, a block stages whole [rows, G*D] slabs of its G heads by cp.async
// (double-buffered streamed tiles), D zero-padded to DP in shared memory; a
// ragged last group's missing head is neither loaded nor computed.
//
// Bound on the H100: 10*H*S^2*D operations (the TPU kernel's useful count)
// against ~8*S*H*D elements moved: bound by operations.  This body does 18
// (the statistics pass, then the score and dP products again in both
// kernels): the price of recomputing the statistics, as the TPU kernel does.
//
// Rounding points follow the TPU kernel: q is scaled by scale*log2(e) and
// rounded to the input type for the scores; P and dS are rounded to the input
// type before the dV, dQ and dK products; dq, dk and dv leave fp32
// accumulators in the input type.
//
// Two bodies:
// - bf16: tensor cores through mma.sync m16n8k16; 4 warps per head, each
//   owning 16 rows (queries in the dq kernel, keys in the dkdv kernel).
//   Fragments of the row-side operands stay in registers; operands read
//   along their rows come from the row-major slabs by ldmatrix.trans.
// - float32 (the parity path and the toy widths): one thread per (row, head),
//   SIMT fp32 FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;  // rows a block owns (queries in dq, keys in dkdv)
constexpr int kTile = 32;  // rows of a streamed tile
constexpr int kWarpsPerHead = kRows / 16;

// the most heads a block takes at a padded head dim: the packing rule's
// G = min(128 // D, 4) (4 warps a head, so at most 512 threads)
constexpr int max_group(int dp) { return dp <= 32 ? 4 : dp <= 48 ? 3 : 2; }

// ------------------------------------------------------------ primitives
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t scale_pair(uint32_t x, float s) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&x);
  return pack_bf16(__low2float(v) * s, __high2float(v) * s);
}

// rows [r0, r0 + n) of the G-head group at h0 into a [n][ls] slab (see K4)
template <int DP>
__device__ __forceinline__ void stage_slab(bf16* dst, int ls, const bf16* __restrict__ src,
                                           int b, int s, int r0, int n, int h, int h0, int gv,
                                           int d) {
  const int c8 = d / 8;
  const int per_row = gv * c8;
  const bf16* base = src + (((long long)b * s + r0) * h + h0) * d;
  for (int e = threadIdx.x; e < n * per_row; e += blockDim.x) {
    const int r = e / per_row, rem = e - r * per_row;
    const int j = rem / c8, c = rem - j * c8;
    cp_async16(dst + r * ls + j * DP + c * 8, base + (long long)r * h * d + rem * 8);
  }
}

// statistics of rows [r0, r0 + kTile) of the valid heads into [G][kTile]
__device__ __forceinline__ void stage_stats(float* dst, const float* __restrict__ src, int b,
                                            int s, int r0, int h, int h0, int gv) {
  constexpr int c4 = kTile / 4;
  for (int e = threadIdx.x; e < gv * c4; e += blockDim.x) {
    const int j = e / c4, c = e - j * c4;
    cp_async16(dst + j * kTile + 4 * c, src + ((long long)b * h + h0 + j) * s + r0 + 4 * c);
  }
}

__device__ __forceinline__ void zero_smem(unsigned char* p, size_t bytes) {
  uint4* q = reinterpret_cast<uint4*>(p);
  for (size_t e = threadIdx.x; e < bytes / 16; e += blockDim.x) q[e] = make_uint4(0, 0, 0, 0);
}

// ------------------------------------------------------- bf16: dq kernel
template <int DP>
__global__ void __launch_bounds__(128 * max_group(DP))
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ dout, float* __restrict__ lse2,
              float* __restrict__ delta, bf16* __restrict__ dq, int s, int h, int d, int g,
              float qscale, float scale) {
  constexpr int NT = kTile / 8, DT = DP / 8, KS = DP / 16;
  static_assert(DP % 16 == 0, "tile shape");
  const int ls = g * DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][ls]
  bf16* Gs = Qs + kRows * ls;                    // [kRows][ls]  dO
  bf16* Ks0 = Gs + kRows * ls;                   // [2][kTile][ls]
  bf16* Vs0 = Ks0 + 2 * kTile * ls;              // [2][kTile][ls]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;
  const int q0 = blockIdx.x * kRows, h0 = blockIdx.y * g, b = blockIdx.z;
  const int gv = min(g, h - h0);
  const int hj = warp / kWarpsPerHead, wr = 16 * (warp % kWarpsPerHead);
  const bool live = hj < gv;

  zero_smem(smem_raw, sizeof(bf16) * (2 * kRows + 4 * kTile) * ls);
  __syncthreads();
  const int nt = s / kTile;
  stage_slab<DP>(Qs, ls, q, b, s, q0, kRows, h, h0, gv, d);
  stage_slab<DP>(Gs, ls, dout, b, s, q0, kRows, h, h0, gv, d);
  stage_slab<DP>(Ks0, ls, k, b, s, 0, kTile, h, h0, gv, d);
  stage_slab<DP>(Vs0, ls, v, b, s, 0, kTile, h, h0, gv, d);
  cp_async_commit();

  uint32_t qf[KS][4], gf[KS][4];
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // rows gr, gr+8: running max,
  float l0 = 0.f, l1 = 0.f, t0 = 0.f, t1 = 0.f;   // this thread's sums of P and P*dP

  for (int step = 0; step < 2 * nt; ++step) {
    const int buf = step & 1;
    const bf16* Ks = Ks0 + buf * kTile * ls;
    const bf16* Vs = Vs0 + buf * kTile * ls;
    if (step + 1 < 2 * nt) {
      const int nxt = ((step + 1) % nt) * kTile;
      stage_slab<DP>(Ks0 + (buf ^ 1) * kTile * ls, ls, k, b, s, nxt, kTile, h, h0, gv, d);
      stage_slab<DP>(Vs0 + (buf ^ 1) * kTile * ls, ls, v, b, s, nxt, kTile, h, h0, gv, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (live) {
      if (step == 0) {
        const bf16* qr0 = Qs + (wr + gr) * ls + hj * DP + 2 * tg;
        const bf16* gr0 = Gs + (wr + gr) * ls + hj * DP + 2 * tg;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          qf[kk][0] = scale_pair(ld32(qr0 + 16 * kk), qscale);
          qf[kk][1] = scale_pair(ld32(qr0 + 8 * ls + 16 * kk), qscale);
          qf[kk][2] = scale_pair(ld32(qr0 + 16 * kk + 8), qscale);
          qf[kk][3] = scale_pair(ld32(qr0 + 8 * ls + 16 * kk + 8), qscale);
          gf[kk][0] = ld32(gr0 + 16 * kk);
          gf[kk][1] = ld32(gr0 + 8 * ls + 16 * kk);
          gf[kk][2] = ld32(gr0 + 16 * kk + 8);
          gf[kk][3] = ld32(gr0 + 8 * ls + 16 * kk + 8);
        }
      }
      float sc[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int at = (8 * j + gr) * ls + hj * DP + 16 * kk + 2 * tg;
          mma_bf16_16816(sc[j], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3], ld32(Ks + at),
                         ld32(Ks + at + 8));
          mma_bf16_16816(dp[j], gf[kk][0], gf[kk][1], gf[kk][2], gf[kk][3], ld32(Vs + at),
                         ld32(Vs + at + 8));
        }
      }
      if (step < nt) {  // online max, sum of P and sum of P * dP
        float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
          mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
        const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
        l0 *= a0;
        t0 *= a0;
        l1 *= a1;
        t1 *= a1;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p0 = exp2f(sc[j][e] - n0), p1 = exp2f(sc[j][2 + e] - n1);
            l0 += p0;
            t0 += p0 * dp[j][e];
            l1 += p1;
            t1 += p1 * dp[j][2 + e];
          }
        m0 = n0;
        m1 = n1;
        if (step == nt - 1) {  // whole rows: log2-sum-exp and delta
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            l0 += __shfl_xor_sync(0xffffffffu, l0, off);
            l1 += __shfl_xor_sync(0xffffffffu, l1, off);
            t0 += __shfl_xor_sync(0xffffffffu, t0, off);
            t1 += __shfl_xor_sync(0xffffffffu, t1, off);
          }
          t0 /= l0;  // delta
          t1 /= l1;
          m0 += log2f(l0);  // base-2 log-sum-exp of the scaled scores
          m1 += log2f(l1);
          if (tg == 0) {
            const long long at = ((long long)b * h + h0 + hj) * s + q0 + wr + gr;
            lse2[at] = m0;
            lse2[at + 8] = m1;
            delta[at] = t0;
            delta[at + 8] = t1;
          }
        }
      } else {  // dS = P * (dP - delta) rounded to bf16; dQ += dS K
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          uint32_t a[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {  // a[x]: n-tile 2kk + x/2, rows gr (x even) or gr+8
            const int j = 2 * kk + (x >> 1), e = 2 * (x & 1);
            const float mm = (x & 1) ? m1 : m0, dd = (x & 1) ? t1 : t0;
            a[x] = pack_bf16(exp2f(sc[j][e] - mm) * (dp[j][e] - dd),
                             exp2f(sc[j][e + 1] - mm) * (dp[j][e + 1] - dd));
          }
          const int key = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
          for (int jj = 0; jj < DT / 2; ++jj) {
            uint32_t bk[4];
            ldmatrix_x4_trans(bk, Ks + key * ls + hj * DP + 16 * jj + 8 * (lane >> 4));
            mma_bf16_16816(acc[2 * jj], a[0], a[1], a[2], a[3], bk[0], bk[1]);
            mma_bf16_16816(acc[2 * jj + 1], a[0], a[1], a[2], a[3], bk[2], bk[3]);
          }
        }
      }
    }
    __syncthreads();
  }

  if (!live) return;
  const int r0 = q0 + wr + gr;
  bf16* o0 = dq + (((long long)b * s + r0) * h + h0 + hj) * d;
  bf16* o1 = o0 + 8LL * h * d;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int c = 8 * j + 2 * tg;
    if (c >= d) continue;
    *reinterpret_cast<__nv_bfloat162*>(o0 + c) =
        __floats2bfloat162_rn(acc[j][0] * scale, acc[j][1] * scale);
    *reinterpret_cast<__nv_bfloat162*>(o1 + c) =
        __floats2bfloat162_rn(acc[j][2] * scale, acc[j][3] * scale);
  }
}

// ----------------------------------------------------- bf16: dkdv kernel
template <int DP>
__global__ void __launch_bounds__(128 * max_group(DP))
dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse2, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int s, int h, int d, int g,
                float qscale, float scale) {
  constexpr int NQ = kTile / 8, DT = DP / 8, KS = DP / 16;
  static_assert(DP % 16 == 0, "tile shape");
  const int ls = g * DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [kRows][ls]
  bf16* Vs = Ks + kRows * ls;                    // [kRows][ls]
  bf16* Qs0 = Vs + kRows * ls;                   // [2][kTile][ls]
  bf16* Gs0 = Qs0 + 2 * kTile * ls;              // [2][kTile][ls]  dO
  float* Ls0 = reinterpret_cast<float*>(Gs0 + 2 * kTile * ls);  // [2][g][kTile]
  float* Ds0 = Ls0 + 2 * g * kTile;                               // [2][g][kTile]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;
  const int k0 = blockIdx.x * kRows, h0 = blockIdx.y * g, b = blockIdx.z;
  const int gv = min(g, h - h0);
  const int hj = warp / kWarpsPerHead, wr = 16 * (warp % kWarpsPerHead);
  const bool live = hj < gv;

  zero_smem(smem_raw, sizeof(bf16) * (2 * kRows + 4 * kTile) * ls);
  __syncthreads();
  const int nt = s / kTile;
  stage_slab<DP>(Ks, ls, k, b, s, k0, kRows, h, h0, gv, d);
  stage_slab<DP>(Vs, ls, v, b, s, k0, kRows, h, h0, gv, d);
  stage_slab<DP>(Qs0, ls, q, b, s, 0, kTile, h, h0, gv, d);
  stage_slab<DP>(Gs0, ls, dout, b, s, 0, kTile, h, h0, gv, d);
  stage_stats(Ls0, lse2, b, s, 0, h, h0, gv);
  stage_stats(Ds0, delta, b, s, 0, h, h0, gv);
  cp_async_commit();

  uint32_t kf[KS][4], vf[KS][4];
  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int t = 0; t < nt; ++t) {
    const int buf = t & 1;
    const bf16* Qs = Qs0 + buf * kTile * ls;
    const bf16* Gs = Gs0 + buf * kTile * ls;
    const float* Ls = Ls0 + buf * g * kTile + hj * kTile;
    const float* Ds = Ds0 + buf * g * kTile + hj * kTile;
    if (t + 1 < nt) {
      const int nxt = (t + 1) * kTile, o = (buf ^ 1);
      stage_slab<DP>(Qs0 + o * kTile * ls, ls, q, b, s, nxt, kTile, h, h0, gv, d);
      stage_slab<DP>(Gs0 + o * kTile * ls, ls, dout, b, s, nxt, kTile, h, h0, gv, d);
      stage_stats(Ls0 + o * g * kTile, lse2, b, s, nxt, h, h0, gv);
      stage_stats(Ds0 + o * g * kTile, delta, b, s, nxt, h, h0, gv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (live) {
      if (t == 0) {
        const bf16* kr0 = Ks + (wr + gr) * ls + hj * DP + 2 * tg;
        const bf16* vr0 = Vs + (wr + gr) * ls + hj * DP + 2 * tg;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          kf[kk][0] = ld32(kr0 + 16 * kk);
          kf[kk][1] = ld32(kr0 + 8 * ls + 16 * kk);
          kf[kk][2] = ld32(kr0 + 16 * kk + 8);
          kf[kk][3] = ld32(kr0 + 8 * ls + 16 * kk + 8);
          vf[kk][0] = ld32(vr0 + 16 * kk);
          vf[kk][1] = ld32(vr0 + 8 * ls + 16 * kk);
          vf[kk][2] = ld32(vr0 + 16 * kk + 8);
          vf[kk][3] = ld32(vr0 + 8 * ls + 16 * kk + 8);
        }
      }
      // S^T = K Qs^T and dP^T = V dO^T: this warp's 16 keys x kTile queries
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const int at = (8 * j + gr) * ls + hj * DP + 16 * kk + 2 * tg;
          mma_bf16_16816(st[j], kf[kk][0], kf[kk][1], kf[kk][2], kf[kk][3],
                         scale_pair(ld32(Qs + at), qscale), scale_pair(ld32(Qs + at + 8), qscale));
          mma_bf16_16816(dpt[j], vf[kk][0], vf[kk][1], vf[kk][2], vf[kk][3], ld32(Gs + at),
                         ld32(Gs + at + 8));
        }
      }
      // P^T and dS^T in place; element e of n-tile j is query 8j + 2tg + (e & 1)
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * tg + (e & 1);
          const float p = exp2f(st[j][e] - Ls[col]);
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - Ds[col]);
        }
      // dV += P^T dO and dK += dS^T Q, 16 queries per step
#pragma unroll
      for (int kq = 0; kq < kTile / 16; ++kq) {
        const uint32_t p0 = pack_bf16(st[2 * kq][0], st[2 * kq][1]);
        const uint32_t p1 = pack_bf16(st[2 * kq][2], st[2 * kq][3]);
        const uint32_t p2 = pack_bf16(st[2 * kq + 1][0], st[2 * kq + 1][1]);
        const uint32_t p3 = pack_bf16(st[2 * kq + 1][2], st[2 * kq + 1][3]);
        const uint32_t s0 = pack_bf16(dpt[2 * kq][0], dpt[2 * kq][1]);
        const uint32_t s1 = pack_bf16(dpt[2 * kq][2], dpt[2 * kq][3]);
        const uint32_t s2 = pack_bf16(dpt[2 * kq + 1][0], dpt[2 * kq + 1][1]);
        const uint32_t s3 = pack_bf16(dpt[2 * kq + 1][2], dpt[2 * kq + 1][3]);
        const int qrow = 16 * kq + (lane & 7) + 8 * ((lane >> 3) & 1);
        const int col = hj * DP + 8 * (lane >> 4);
#pragma unroll
        for (int jj = 0; jj < DT / 2; ++jj) {
          uint32_t bg[4], bq[4];
          ldmatrix_x4_trans(bg, Gs + qrow * ls + col + 16 * jj);
          ldmatrix_x4_trans(bq, Qs + qrow * ls + col + 16 * jj);
          mma_bf16_16816(dva[2 * jj], p0, p1, p2, p3, bg[0], bg[1]);
          mma_bf16_16816(dva[2 * jj + 1], p0, p1, p2, p3, bg[2], bg[3]);
          mma_bf16_16816(dka[2 * jj], s0, s1, s2, s3, bq[0], bq[1]);
          mma_bf16_16816(dka[2 * jj + 1], s0, s1, s2, s3, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();
  }

  if (!live) return;
  const int r0 = k0 + wr + gr;
  const long long at0 = (((long long)b * s + r0) * h + h0 + hj) * d, at1 = at0 + 8LL * h * d;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int c = 8 * j + 2 * tg;
    if (c >= d) continue;
    *reinterpret_cast<__nv_bfloat162*>(dk + at0 + c) =
        __floats2bfloat162_rn(dka[j][0] * scale, dka[j][1] * scale);
    *reinterpret_cast<__nv_bfloat162*>(dk + at1 + c) =
        __floats2bfloat162_rn(dka[j][2] * scale, dka[j][3] * scale);
    *reinterpret_cast<__nv_bfloat162*>(dv + at0 + c) = __floats2bfloat162_rn(dva[j][0], dva[j][1]);
    *reinterpret_cast<__nv_bfloat162*>(dv + at1 + c) = __floats2bfloat162_rn(dva[j][2], dva[j][3]);
  }
}

// ------------------------------------------------------------ fp32 bodies
// one thread per (query row, head): statistics, then dQ; K/V tiles in shared memory
template <int DP>
__global__ void __launch_bounds__(256)
dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               float* __restrict__ lse2, float* __restrict__ delta, float* __restrict__ dq,
               int s, int h, int d, int g, float qscale, float scale) {
  extern __shared__ float fsmem[];
  const int ld = g * DP;
  float* Ks = fsmem;               // [kTile][ld]
  float* Vs = fsmem + kTile * ld;  // [kTile][ld]
  const int tid = threadIdx.x;
  const int hj = tid / kRows, row = blockIdx.x * kRows + tid % kRows;
  const int h0 = blockIdx.y * g, b = blockIdx.z;
  const int gv = min(g, h - h0);
  const bool live = hj < gv;
  const long long at = (((long long)b * s + row) * h + h0 + hj) * d;

  float qr[DP], gr[DP], acc[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    const bool ok = live && c < d;
    qr[c] = ok ? q[at + c] * qscale : 0.f;
    gr[c] = ok ? dout[at + c] : 0.f;
    acc[c] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f, t = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < s; k0 += kTile) {
      __syncthreads();
      for (int e = tid; e < kTile * ld; e += blockDim.x) {
        const int r = e / ld, rem = e - r * ld, j = rem / DP, c = rem - j * DP;
        const bool ok = j < gv && c < d;
        const long long src = (((long long)b * s + k0 + r) * h + h0 + j) * d + c;
        Ks[e] = ok ? k[src] : 0.f;
        Vs[e] = ok ? v[src] : 0.f;
      }
      __syncthreads();
      if (!live) continue;
      for (int r = 0; r < kTile; ++r) {
        const float* kr = Ks + r * ld + hj * DP;
        const float* vr = Vs + r * ld + hj * DP;
        float sc = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < DP; ++c) {
          sc = fmaf(qr[c], kr[c], sc);
          dp = fmaf(gr[c], vr[c], dp);
        }
        if (pass == 0) {
          const float mn = fmaxf(m, sc), a = exp2f(m - mn), p = exp2f(sc - mn);
          l = l * a + p;
          t = t * a + p * dp;
          m = mn;
        } else {
          const float ds = exp2f(sc - m) * (dp - t);
#pragma unroll
          for (int c = 0; c < DP; ++c) acc[c] = fmaf(ds, kr[c], acc[c]);
        }
      }
    }
    if (pass == 0) {
      t /= l;
      m += log2f(l);
      if (live) {
        const long long st = ((long long)b * h + h0 + hj) * s + row;
        lse2[st] = m;
        delta[st] = t;
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int c = 0; c < DP; ++c)
    if (c < d) dq[at + c] = acc[c] * scale;
}

// one thread per (key row, head): dK and dV over the q tiles in shared memory
template <int DP>
__global__ void __launch_bounds__(256)
dkdv_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse2, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int s, int h, int d, int g,
                 float qscale, float scale) {
  extern __shared__ float fsmem[];
  const int ld = g * DP;
  float* Qs = fsmem;                    // [kTile][ld]
  float* Gs = Qs + kTile * ld;          // [kTile][ld]
  float* Ls = Gs + kTile * ld;          // [g][kTile]
  float* Ds = Ls + g * kTile;           // [g][kTile]
  const int tid = threadIdx.x;
  const int hj = tid / kRows, row = blockIdx.x * kRows + tid % kRows;
  const int h0 = blockIdx.y * g, b = blockIdx.z;
  const int gv = min(g, h - h0);
  const bool live = hj < gv;
  const long long at = (((long long)b * s + row) * h + h0 + hj) * d;

  float kr[DP], vr[DP], dka[DP], dva[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    const bool ok = live && c < d;
    kr[c] = ok ? k[at + c] : 0.f;
    vr[c] = ok ? v[at + c] : 0.f;
    dka[c] = dva[c] = 0.f;
  }
  for (int q0 = 0; q0 < s; q0 += kTile) {
    __syncthreads();
    for (int e = tid; e < kTile * ld; e += blockDim.x) {
      const int r = e / ld, rem = e - r * ld, j = rem / DP, c = rem - j * DP;
      const bool ok = j < gv && c < d;
      const long long src = (((long long)b * s + q0 + r) * h + h0 + j) * d + c;
      Qs[e] = ok ? q[src] : 0.f;
      Gs[e] = ok ? dout[src] : 0.f;
    }
    for (int e = tid; e < g * kTile; e += blockDim.x) {
      const int j = e / kTile, r = e - j * kTile;
      const long long src = ((long long)b * h + h0 + j) * s + q0 + r;
      Ls[e] = j < gv ? lse2[src] : 0.f;
      Ds[e] = j < gv ? delta[src] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int r = 0; r < kTile; ++r) {
      const float* qq = Qs + r * ld + hj * DP;
      const float* gg = Gs + r * ld + hj * DP;
      float sc = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        sc = fmaf(qq[c] * qscale, kr[c], sc);
        dp = fmaf(gg[c], vr[c], dp);
      }
      const float p = exp2f(sc - Ls[hj * kTile + r]);
      const float ds = p * (dp - Ds[hj * kTile + r]);
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        dva[c] = fmaf(p, gg[c], dva[c]);
        dka[c] = fmaf(ds, qq[c], dka[c]);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int c = 0; c < DP; ++c)
    if (c < d) {
      dk[at + c] = dka[c] * scale;
      dv[at + c] = dva[c];
    }
}

// ------------------------------------------------------------------ host
struct Args {
  const void *q, *k, *v, *dout;
  float *lse2, *delta;
  void *dq, *dk, *dv;
  int b, s, h, d, g;
  float qscale, scale;
  cudaStream_t st;
};

template <typename K>
cudaError_t set_smem(K kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DP>
cudaError_t launch_mma(const Args& a) {
  if (a.g > max_group(DP)) return cudaErrorInvalidValue;
  const int ls = a.g * DP + 8;
  const size_t s1 = sizeof(bf16) * (2 * kRows + 4 * kTile) * ls;
  const size_t s2 = s1 + sizeof(float) * 4 * a.g * kTile;
  auto k1 = dq_mma_kernel<DP>;
  auto k2 = dkdv_mma_kernel<DP>;
  cudaError_t err = set_smem(k1, s1);
  if (err == cudaSuccess) err = set_smem(k2, s2);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.s / kRows, (a.h + a.g - 1) / a.g, a.b);
  const int threads = 32 * kWarpsPerHead * a.g;
  const bf16 *q = static_cast<const bf16*>(a.q), *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v), *g = static_cast<const bf16*>(a.dout);
  k1<<<grid, threads, s1, a.st>>>(q, k, v, g, a.lse2, a.delta, static_cast<bf16*>(a.dq), a.s,
                                  a.h, a.d, a.g, a.qscale, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2<<<grid, threads, s2, a.st>>>(q, k, v, g, a.lse2, a.delta, static_cast<bf16*>(a.dk),
                                  static_cast<bf16*>(a.dv), a.s, a.h, a.d, a.g, a.qscale,
                                  a.scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_simt(const Args& a) {
  const size_t s1 = sizeof(float) * 2 * kTile * a.g * DP;
  const size_t s2 = s1 + sizeof(float) * 2 * a.g * kTile;
  auto k1 = dq_simt_kernel<DP>;
  auto k2 = dkdv_simt_kernel<DP>;
  cudaError_t err = set_smem(k1, s1);
  if (err == cudaSuccess) err = set_smem(k2, s2);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.s / kRows, (a.h + a.g - 1) / a.g, a.b);
  const float *q = static_cast<const float*>(a.q), *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v), *g = static_cast<const float*>(a.dout);
  k1<<<grid, kRows * a.g, s1, a.st>>>(q, k, v, g, a.lse2, a.delta, static_cast<float*>(a.dq),
                                      a.s, a.h, a.d, a.g, a.qscale, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2<<<grid, kRows * a.g, s2, a.st>>>(q, k, v, g, a.lse2, a.delta, static_cast<float*>(a.dk),
                                      static_cast<float*>(a.dv), a.s, a.h, a.d, a.g, a.qscale,
                                      a.scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

const char* madm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, dout, dq, dk, dv: contiguous
// [B, S, H, D]; lse2 and delta: fp32 scratch [B, H, S] (written by the dq
// kernel, read by the dkdv kernel).  1 <= g <= 4, S % 64 == 0, D <= 64; bf16
// also needs D % 8 == 0 and 16-byte aligned tensors (scratch included).
// Returns the cudaError_t of the launches (0 = success,
// cudaErrorInvalidValue for input outside these bounds); the kernels run on
// `stream`.
int madm_packed_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                              const void* dout, void* lse2, void* delta, void* dq, void* dk,
                              void* dv, int b, int s, int h, int d, int g, float scale,
                              void* stream) {
  const Args a{q, k, v, dout, static_cast<float*>(lse2), static_cast<float*>(delta), dq, dk, dv,
               b, s, h, d, g, scale * 1.4426950408889634f, scale,
               static_cast<cudaStream_t>(stream)};
  if (g < 1 || g > 4 || d < 1 || d > 64 || s % kRows != 0 || b < 1 || h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    const bool ok = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                    aligned16(dout) && aligned16(dq) && aligned16(dk) && aligned16(dv) &&
                    aligned16(lse2) && aligned16(delta);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err;
    if (d <= 16) err = launch_mma<16>(a);
    else if (d <= 32) err = launch_mma<32>(a);
    else if (d <= 48) err = launch_mma<48>(a);
    else err = launch_mma<64>(a);
    return static_cast<int>(err);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (d <= 8) err = launch_simt<8>(a);
  else if (d <= 16) err = launch_simt<16>(a);
  else if (d <= 32) err = launch_simt<32>(a);
  else if (d <= 48) err = launch_simt<48>(a);
  else err = launch_simt<64>(a);
  return static_cast<int>(err);
}

}  // extern "C"
