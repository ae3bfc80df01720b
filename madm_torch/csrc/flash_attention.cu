// K1: flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel madm_tpu/ops/flash_attention.py::_attn_kernel
// (pallas_call in _flash_attention_fwd_impl).  Computes
//   o = softmax(q k^T * scale) v
// per (batch, head) on [B, S, H, D] tensors read through their strides (the
// head dim must be unit-stride), so the caller does no transposes.
//
// Bound on the H100: at the UNet shapes (S=4096, D=40..160; Sk=77 cross) the
// work is 4*Sq*Sk*D operations per head against ~(2*Sq + 2*Sk)*D elements
// moved, far above the card's ~295 ops/byte ridge: it is bound by
// operations, which only wgmma delivers at the card's rate.  The TPU kernel
// kept a head's whole K/V in VMEM; a Hopper block has 227 KB of shared
// memory, so K/V stream through it in tiles with an online softmax (running
// max and sum in fp32, base-2 exponent with scale*log2(e) folded into q, as
// the TPU kernel did), divided by the sum once, after the last PV product.
// The S x S scores never reach device memory.
//
// Two bodies, chosen from the dtype:
// - bf16 (every attention of the model): warp-specialised TMA + wgmma.  A
//   producer warp (one issuing thread) loads the block's Q once and then K
//   and V tiles by TMA into a ring of shared-memory stages, each with a full
//   and an empty mbarrier.  Consumer warpgroups own 64 query rows each (two
//   a block where 128-row tiles still give 132 blocks, else one, so that
//   more blocks run):
//   - q is rescaled in shared memory to bf16(q * scale * log2(e)), the TPU
//     kernel's rounding point, and its columns past D zeroed;
//   - S = Qs K^T by wgmma m64nBKk16 with both operands K-major in shared
//     memory, as TMA wrote them;
//   - the online softmax runs in the accumulator registers, P is packed to
//     bf16 in registers and is the register A operand of O += P V, with V
//     read MN-major where TMA put it: no transposes, no shared-memory P;
//   - the output is normalised after PV, as on the TPU, and stored from the
//     registers; the fp32 row log-sum-exp (natural log of the scaled scores)
//     goes to lse [B, H, Sq] when asked: K3 (flash_attention_bwd.cu)
//     recomputes P = exp(s - lse) from it.
//   Tiles are [rows][64] boxes with the 128-byte swizzle.  D=40 rows are 80
//   bytes, which no swizzle span fits, so D is boxed as 64 columns and the
//   products run over D padded to 48 (3 k-steps); the columns past D are
//   TMA's zeros or, where the heads lie side by side (every call site: the
//   80-byte head stride is not a legal TMA stride, so the map sees a row as
//   one H*D vector), the next head's values, which the zeroed q columns
//   cancel in QK^T and which land in output columns that are not stored.
//   This costs 64/40 of the minimal bytes (from L2: the neighbouring head's
//   block reads them too) and 48/40 of the products, against a second,
//   unswizzled layout for one head dim.  Keys past Sk (TMA zero-fills rows
//   past the end) are masked to -inf; a 77-key cross-attention is one
//   80-key tile.  The VAE's single-head D=512 attention computes its scores
//   once: two warpgroups share 64 query rows, each takes half of the QK^T
//   reduction and half of the output columns, and they add their fp32
//   partial scores through shared memory in warpgroup order, so both form
//   the same P (K and V rings of one stage: 64 KB a tile).
// - float32 (the parity path): SIMT fp32 FMA on a 16x16 thread grid,
//   register tiles of RI query rows x CJ keys and RI rows x DJ head columns;
//   D=512 uses 32-row query tiles so its fp32 output accumulator stays in
//   registers (32 x 512 over 256 threads).  This body does not use the
//   tensor cores.  It writes lse as the bf16 body does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <chrono>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16: tx = key / head-dim lane, ty = query lane
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, s, h;  // element strides of batch, sequence and head; head dim is unit-stride
};

template <int DPAD, int BQ, int BK>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (DPAD + 1) + BK * (DPAD + 1) + BK * DPAD + BQ * (BK + 1));
}

template <int DPAD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 float* __restrict__ o, float* __restrict__ lse, int nh, int sq, int sk, int d,
                 Strides qs, Strides ks, Strides vs, Strides os, float qscale) {
  constexpr int RI = BQ / 16;    // query rows per thread
  constexpr int CJ = BK / 16;    // keys per thread (score tile)
  constexpr int DJ = DPAD / 16;  // head-dim columns per thread (output tile)
  constexpr int QLD = DPAD + 1;  // odd strides keep the column reads conflict-free
  constexpr int KLD = DPAD + 1;
  constexpr int VLD = DPAD;
  constexpr int PLD = BK + 1;
  static_assert(BQ % 16 == 0 && BK % 16 == 0 && DPAD % 16 == 0, "tile shape");

  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][QLD]  q * scale * log2(e), fp32
  float* Ks = Qs + BQ * QLD;    // [BK][KLD]
  float* Vs = Ks + BK * KLD;    // [BK][VLD]
  float* Ps = Vs + BK * VLD;    // [BQ][PLD]  exp2(s - m) of the current tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  for (int e = tid; e < BQ * DPAD; e += kThreads) {
    const int r = e / DPAD, c = e - r * DPAD;
    float x = 0.f;
    if (q0 + r < sq && c < d) x = qb[(long long)(q0 + r) * qs.s + c] * qscale;
    Qs[r * QLD + c] = x;
  }

  float acc[RI][DJ];
  float m_run[RI], l_run[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m_run[i] = -CUDART_INF_F;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < sk; k0 += BK) {
    __syncthreads();  // Qs written (first tile); Ks/Vs/Ps free (later tiles)
    for (int e = tid; e < BK * DPAD; e += kThreads) {
      const int r = e / DPAD, c = e - r * DPAD;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < sk && c < d) {
        kx = kb[(long long)(k0 + r) * ks.s + c];
        vx = vb[(long long)(k0 + r) * vs.s + c];
      }
      Ks[r * KLD + c] = kx;
      Vs[r * VLD + c] = vx;
    }
    __syncthreads();

    // scores of this tile, log2 domain
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DPAD; ++c) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + 16 * i) * QLD + c];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = Ks[(tx + 16 * j) * KLD + c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax: the 16 threads of one query row are one half-warp
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        if (k0 + tx + 16 * j >= sk) s[i][j] = -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // every tile holds at least one unmasked key, so m_new is finite
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = exp2f(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        Ps[(ty + 16 * i) * PLD + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V over this tile
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty + 16 * i) * PLD + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * VLD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  // normalise after PV (as the TPU kernel does) and store
  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    const float inv = 1.f / l_run[i];
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) ob[(long long)r * os.s + c] = acc[i][j] * inv;
    }
    if (lse != nullptr && tx == 0)
      lse[((long long)b * nh + h) * sq + r] = (m_run[i] + log2f(l_run[i])) * kLn2;
  }
}

// ------------------------------------------------- bf16 body: TMA + wgmma
using namespace hopper;
typedef __nv_bfloat16 bf16;

struct FwdArgs {
  int sq, sk, d, rank4;  // rank4: bit 0 q, bit 1 k, bit 2 v use a rank-4 map (else flat heads)
  long long o_sb, o_ss, o_sh;
};

// DN: D padded to 16 (the QK^T reduction and the PV width); BK keys a tile;
// NWG consumer warpgroups; SPLITD: the warpgroups share 64 query rows and
// split D (the QK^T reduction and the output columns), else each owns 64
// rows.  Shared memory: Q, the K and V rings, the partial scores (SPLITD),
// the barriers, and 1024 bytes to align the base.
template <int DN, int BK, int NWG, bool SPLITD, int STAGES>
struct FwdTile {
  static constexpr int NCH = (DN + 63) / 64;  // 64-column chunks of a row
  static constexpr int BQ = SPLITD ? 64 : 64 * NWG;
  static constexpr int Q_BYTES = NCH * BQ * 128;
  static constexpr int KV_BYTES = NCH * BK * 128;
  static constexpr int PART_BYTES = SPLITD ? NWG * 64 * BK * 4 : 0;
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES + PART_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 4 * STAGES);
  static constexpr int THREADS = 128 * NWG + 32;  // consumer warpgroups, one producer warp
};

template <int DN, int BK, int NWG, bool SPLITD, int STAGES>
__global__ void __launch_bounds__(FwdTile<DN, BK, NWG, SPLITD, STAGES>::THREADS, 1)
flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                     float* __restrict__ lse, FwdArgs a, float qscale) {
  using L = FwdTile<DN, BK, NWG, SPLITD, STAGES>;
  constexpr int NCH = L::NCH, BQ = L::BQ;
  constexpr int KS = DN / 16;                      // k-steps of QK^T
  constexpr int KS_W = SPLITD ? KS / NWG : KS;     // this warpgroup's
  constexpr int NO = SPLITD ? DN / NWG : DN;       // output columns of a warpgroup
  static_assert(DN % 16 == 0 && BK % 16 == 0, "tile shape");
  static_assert(!SPLITD || (KS % NWG == 0 && NO % 64 == 0), "D split");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sK = sQ + L::Q_BYTES;                  // [STAGES]
  unsigned char* sV = sK + STAGES * L::KV_BYTES;        // [STAGES]
  float* sPart = reinterpret_cast<float*>(sV + STAGES * L::KV_BYTES);
  uint64_t* barQ = reinterpret_cast<uint64_t*>(sQ + L::BAR_OFF);
  uint64_t* fullK = barQ + 1;
  uint64_t* fullV = fullK + STAGES;
  uint64_t* emptyK = fullV + STAGES;
  uint64_t* emptyV = emptyK + STAGES;

  const int tid = threadIdx.x, wg = tid / 128;
  const int q0 = blockIdx.x * BQ, hh = blockIdx.y, b = blockIdx.z;
  const int ntiles = (a.sk + BK - 1) / BK;
  if (tid == 0) {
    mbar_init(barQ, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(fullK + s, 1);
      mbar_init(fullV + s, 1);
      mbar_init(emptyK + s, NWG);
      mbar_init(emptyV + s, NWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == NWG) {  // the producer warp: one thread issues every load
    if (tid == NWG * 128) {
      const bool r4q = a.rank4 & 1, r4k = a.rank4 & 2, r4v = a.rank4 & 4;
      const int cq = r4q ? 0 : hh * a.d, ck = r4k ? 0 : hh * a.d, cv = r4v ? 0 : hh * a.d;
      mbar_expect_tx(barQ, L::Q_BYTES);
      for (int c = 0; c < NCH; ++c) tma_load(sQ + c * BQ * 128, &tq, barQ, cq + 64 * c, q0, hh, b, r4q);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES, ph = (j / STAGES) & 1;
        mbar_wait(emptyK + s, ph ^ 1);
        mbar_expect_tx(fullK + s, L::KV_BYTES);
        for (int c = 0; c < NCH; ++c)
          tma_load(sK + s * L::KV_BYTES + c * BK * 128, &tk, fullK + s, ck + 64 * c, j * BK, hh, b, r4k);
        mbar_wait(emptyV + s, ph ^ 1);
        mbar_expect_tx(fullV + s, L::KV_BYTES);
        for (int c = 0; c < NCH; ++c)
          tma_load(sV + s * L::KV_BYTES + c * BK * 128, &tv, fullV + s, cv + 64 * c, j * BK, hh, b, r4v);
      }
    }
  } else {  // consumers
    const int t = tid % 128, warp = t / 32, lane = t % 32, g = lane / 4, tg = lane % 4;
    mbar_wait(barQ, 0);
    // q * scale * log2(e) rounded to bf16 in place (the TPU kernel's rounding
    // point); columns past D zeroed, so that what a flat map brought of the
    // next head adds nothing to the scores
    for (int e = tid; e < NCH * BQ * 8; e += NWG * 128) {
      const int c = e / (BQ * 8), r = (e / 8) % BQ;
      const int col = c * 64 + (((e % 8) ^ (r & 7)) * 8);
      uint4* p = reinterpret_cast<uint4*>(sQ + e * 16);
      uint4 raw = *p;
      bf16* x = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        x[i] = col < a.d ? __float2bfloat16(__bfloat162float(x[i]) * qscale) : __float2bfloat16(0.f);
      *p = raw;
    }
    fence_async_smem();
    named_sync(1, NWG * 128);

    float oacc[NO / 2];
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) oacc[i] = 0.f;
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // rows g and g+8 of this warp
    float l0 = 0.f, l1 = 0.f;                       // this thread's share of the row sums
    const uint32_t qa = smem_addr(sQ) + (SPLITD ? 0 : wg * 64 * 128);
    const int ks0 = SPLITD ? wg * KS_W : 0;
    const int oc0 = SPLITD ? wg * NO : 0;  // first output column of this warpgroup

    for (int j = 0; j < ntiles; ++j) {
      const int s = j % STAGES, ph = (j / STAGES) & 1;
      // S = Qs K^T, log2 domain
      float sacc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
      mbar_wait(fullK + s, ph);
      const uint32_t ka = smem_addr(sK + s * L::KV_BYTES);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < KS_W; ++i) {
        const int k = ks0 + i;
        wgmma_ss<BK>(sacc, desc(qa + (k / 4) * BQ * 128 + (k % 4) * 32, 16),
                     desc(ka + (k / 4) * BK * 128 + (k % 4) * 32, 16), i > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sacc);
      if (t == 0) mbar_arrive(emptyK + s);
      if constexpr (SPLITD) {  // sum the partial scores, in warpgroup order on every warpgroup
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sPart[(wg * (BK / 2) + i) * 128 + t] = sacc[i];
        named_sync(2, NWG * 128);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          float tot = 0.f;
#pragma unroll
          for (int w = 0; w < NWG; ++w) tot += sPart[(w * (BK / 2) + i) * 128 + t];
          sacc[i] = tot;
        }
        named_sync(2, NWG * 128);
      }
      if ((j + 1) * BK > a.sk) {  // keys past Sk (TMA's zero rows) are masked, not zero
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          const int key = j * BK + 8 * n + 2 * tg;
          if (key >= a.sk) sacc[4 * n] = sacc[4 * n + 2] = -CUDART_INF_F;
          if (key + 1 >= a.sk) sacc[4 * n + 1] = sacc[4 * n + 3] = -CUDART_INF_F;
        }
      }
      // online softmax; a row's columns are spread over the 4 threads of a group
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        mx0 = fmaxf(mx0, fmaxf(sacc[4 * n], sacc[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(sacc[4 * n + 2], sacc[4 * n + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);  // finite: a tile has a live key
      const float al0 = exp2f(m0 - n0), al1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        sacc[4 * n] = exp2f(sacc[4 * n] - n0);
        sacc[4 * n + 1] = exp2f(sacc[4 * n + 1] - n0);
        sacc[4 * n + 2] = exp2f(sacc[4 * n + 2] - n1);
        sacc[4 * n + 3] = exp2f(sacc[4 * n + 3] - n1);
        ps0 += sacc[4 * n] + sacc[4 * n + 1];
        ps1 += sacc[4 * n + 2] + sacc[4 * n + 3];
      }
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
#pragma unroll
      for (int n = 0; n < NO / 8; ++n) {
        oacc[4 * n] *= al0;
        oacc[4 * n + 1] *= al0;
        oacc[4 * n + 2] *= al1;
        oacc[4 * n + 3] *= al1;
      }
      // P in bf16 as the register A operand: two 8-key groups a k-step
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
      // O += P V, V read MN-major where TMA put it
      mbar_wait(fullV + s, ph);
      const uint32_t va = smem_addr(sV + s * L::KV_BYTES) + (oc0 / 64) * BK * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<NO>(oacc, pa[kk], desc(va + kk * 2048, BK * 128), 1);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(oacc);
      fence_regs(pa);
      if (t == 0) mbar_arrive(emptyV + s);
    }

    // row sums across the group, normalise after PV, store
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    const int r0 = q0 + (SPLITD ? 0 : 64 * wg) + 16 * warp + g, r1 = r0 + 8;
    if (lse != nullptr && oc0 == 0 && tg == 0) {
      float* lb = lse + ((long long)b * gridDim.y + hh) * a.sq;
      if (r0 < a.sq) lb[r0] = (m0 + log2f(l0)) * kLn2;
      if (r1 < a.sq) lb[r1] = (m1 + log2f(l1)) * kLn2;
    }
    bf16* ob = o + b * a.o_sb + hh * a.o_sh;
#pragma unroll
    for (int n = 0; n < NO / 8; ++n) {
      const int c = oc0 + 8 * n + 2 * tg;  // D % 8 == 0: c < D implies c + 1 < D
      if (c >= a.d) continue;
      if (r0 < a.sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * a.o_ss + c) =
            __floats2bfloat162_rn(oacc[4 * n] * i0, oacc[4 * n + 1] * i0);
      if (r1 < a.sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r1 * a.o_ss + c) =
            __floats2bfloat162_rn(oacc[4 * n + 2] * i1, oacc[4 * n + 3] * i1);
    }
  }
}

// The TMA body's variant for a shape; attention_plan() in
// madm_torch/ops/flash_attention.py makes the same choice.
struct FwdPlan {
  int dn, bk, nwg, splitd, stages, bq, smem;
};

// two consumer warpgroups (128 query rows) a block where that still gives
// 132 blocks, the H100's SMs; else one, so that more blocks run
inline bool fills(int b, int sq, int h) { return (long long)(sq + 127) / 128 * h * b >= 132; }

inline FwdPlan fwd_plan(int b, int sq, int sk, int h, int d) {
  FwdPlan p{};
  p.dn = d <= 48 ? 48 : d <= 80 ? 80 : d <= 160 ? 160 : 512;
  p.splitd = p.dn == 512;
  p.bk = p.splitd ? 64 : sk <= 80 ? 80 : p.dn == 160 ? 64 : 128;
  p.nwg = p.splitd || fills(b, sq, h) ? 2 : 1;
  p.stages = p.splitd ? 1 : 2;
  p.bq = p.splitd ? 64 : 64 * p.nwg;
  return p;
}

template <int DN, int BK, int NWG, bool SPLITD, int STAGES>
cudaError_t launch_tma(const void* q, const void* k, const void* v, void* o, float* lse, int b, int sq,
                       int sk, int h, int d, Strides qs, Strides ks, Strides vs, Strides os,
                       float qscale, cudaStream_t stream) {
  using L = FwdTile<DN, BK, NWG, SPLITD, STAGES>;
  CUtensorMap mq, mk, mv;
  if (!cached_bf16_map(&mq, q, b, sq, h, d, qs.b, qs.s, qs.h, L::BQ) ||
      !cached_bf16_map(&mk, k, b, sk, h, d, ks.b, ks.s, ks.h, BK) ||
      !cached_bf16_map(&mv, v, b, sk, h, d, vs.b, vs.s, vs.h, BK))
    return cudaErrorInvalidValue;
  constexpr auto kern = flash_fwd_tma_kernel<DN, BK, NWG, SPLITD, STAGES>;
  cudaError_t err = set_smem_once<kern>(L::SMEM);
  if (err != cudaSuccess) return err;
  const FwdArgs a{sq, sk, d,
                  (flat_heads(h, d, qs.h) ? 0 : 1) | (flat_heads(h, d, ks.h) ? 0 : 2) |
                      (flat_heads(h, d, vs.h) ? 0 : 4),
                  os.b, os.s, os.h};
  dim3 grid((sq + L::BQ - 1) / L::BQ, h, b);
  kern<<<grid, L::THREADS, L::SMEM, stream>>>(mq, mk, mv, static_cast<bf16*>(o), lse, a, qscale);
  return cudaGetLastError();
}

template <int DN, int BK>
cudaError_t launch_tma_rows(int nwg, const void* q, const void* k, const void* v, void* o, float* lse,
                            int b, int sq, int sk, int h, int d, Strides qs, Strides ks, Strides vs,
                            Strides os, float qscale, cudaStream_t st) {
  if (nwg == 1) return launch_tma<DN, BK, 1, false, 2>(q, k, v, o, lse, b, sq, sk, h, d, qs, ks, vs, os, qscale, st);
  return launch_tma<DN, BK, 2, false, 2>(q, k, v, o, lse, b, sq, sk, h, d, qs, ks, vs, os, qscale, st);
}

template <int DN, int BK, int NWG, bool SPLITD, int STAGES>
int tma_smem() { return FwdTile<DN, BK, NWG, SPLITD, STAGES>::SMEM; }

cudaError_t dispatch_tma(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                         int sq, int sk, int h, int d, Strides qs, Strides ks, Strides vs, Strides os,
                         float qscale, cudaStream_t st) {
#define ARGS p.nwg, q, k, v, o, lse, b, sq, sk, h, d, qs, ks, vs, os, qscale, st
  const FwdPlan p = fwd_plan(b, sq, sk, h, d);
  if (p.splitd)
    return launch_tma<512, 64, 2, true, 1>(q, k, v, o, lse, b, sq, sk, h, d, qs, ks, vs, os, qscale, st);
  if (p.dn == 48) return p.bk == 80 ? launch_tma_rows<48, 80>(ARGS) : launch_tma_rows<48, 128>(ARGS);
  if (p.dn == 80) return p.bk == 80 ? launch_tma_rows<80, 80>(ARGS) : launch_tma_rows<80, 128>(ARGS);
  return p.bk == 80 ? launch_tma_rows<160, 80>(ARGS) : launch_tma_rows<160, 64>(ARGS);
#undef ARGS
}

int plan_smem(const FwdPlan& p) {
  if (p.splitd) return tma_smem<512, 64, 2, true, 1>();
#define S(DN, BK) (p.nwg == 1 ? tma_smem<DN, BK, 1, false, 2>() : tma_smem<DN, BK, 2, false, 2>())
  if (p.dn == 48) return p.bk == 80 ? S(48, 80) : S(48, 128);
  if (p.dn == 80) return p.bk == 80 ? S(80, 80) : S(80, 128);
  return p.bk == 80 ? S(160, 80) : S(160, 64);
#undef S
}

template <int DPAD, int BQ, int BK>
cudaError_t launch_simt(const float* q, const float* k, const float* v, float* o, float* lse, int b,
                        int sq, int sk, int h, int d, Strides qs, Strides ks, Strides vs, Strides os,
                        float qscale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DPAD, BQ, BK>();
  auto kern = flash_fwd_kernel<DPAD, BQ, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  kern<<<grid, kThreads, smem, stream>>>(q, k, v, o, lse, h, sq, sk, d, qs, ks, vs, os, qscale);
  return cudaGetLastError();
}

cudaError_t dispatch_simt(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                          int sq, int sk, int h, int d, Strides qs, Strides ks, Strides vs, Strides os,
                          float qscale, cudaStream_t st) {
#define ARGS static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), \
             static_cast<float*>(o), lse, b, sq, sk, h, d, qs, ks, vs, os, qscale, st
  if (d <= 48) return launch_simt<48, 64, 64>(ARGS);
  if (d <= 64) return launch_simt<64, 64, 64>(ARGS);
  if (d <= 80) return launch_simt<80, 64, 64>(ARGS);
  if (d <= 128) return launch_simt<128, 64, 32>(ARGS);
  if (d <= 160) return launch_simt<160, 64, 32>(ARGS);
  if (d <= 512) return launch_simt<512, 32, 32>(ARGS);
#undef ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* madm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  lse is null
// or a contiguous fp32 [B, H, Sq].  bf16 needs what TMA needs: D % 8 == 0,
// 16-byte aligned bases, S and B strides of a multiple of 8 elements, and
// heads side by side (head stride D) or a head stride of a multiple of 8.
// Returns the cudaError_t of the launch (0 = success, cudaErrorInvalidValue
// for input outside these bounds); the kernel runs on `stream`.
int madm_flash_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                             void* lse, int b, int sq, int sk, int h, int d,
                             long long q_sb, long long q_ss, long long q_sh,
                             long long k_sb, long long k_ss, long long k_sh,
                             long long v_sb, long long v_ss, long long v_sh,
                             long long o_sb, long long o_ss, long long o_sh,
                             float scale, void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  const float qscale = scale * 1.4426950408889634f;  // fold log2(e): softmax in base 2
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d < 1 || d > 512)
    err = cudaErrorInvalidValue;
  else if (dtype == 0)
    err = dispatch_simt(q, k, v, o, static_cast<float*>(lse), b, sq, sk, h, d, qs, ks, vs, os, qscale, st);
  else if (dtype == 1 && d % 8 == 0)
    err = dispatch_tma(q, k, v, o, static_cast<float*>(lse), b, sq, sk, h, d, qs, ks, vs, os, qscale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The bf16 body's launch plan for a shape, for holding attention_plan() to
// it: out = {padded D, q rows a block, keys a tile, consumer warpgroups,
// D split over them, ring stages, dynamic shared memory bytes}.
void madm_flash_attention_fwd_plan(int b, int sq, int sk, int h, int d, int* out) {
  const FwdPlan p = fwd_plan(b, sq, sk, h, d);
  const int v[7] = {p.dn, p.bq, p.bk, p.nwg, p.splitd, p.stages, plan_smem(p)};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}

// Host nanoseconds to get one bf16 tensor map of a [1, s, h, d] tensor at
// `base`, the mean of `iters`: encoded each time, or from the table of
// encoded maps (`cached`).  A forward call gets three.
double madm_tensor_map_encode_ns(const void* base, int s, int h, int d, int iters, int cached) {
  CUtensorMap m;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (!(cached ? cached_bf16_map : bf16_map)(&m, base, 1, s, h, d, (long long)s * h * d,
                                              (long long)h * d, d, 128))
      return -1.0;
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::nano>(t1 - t0).count() / iters;
}

}  // extern "C"
