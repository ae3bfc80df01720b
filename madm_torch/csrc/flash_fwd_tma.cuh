// The bf16 flash-attention forward body for Hopper (sm_90a), shared by K1
// (flash_attention.cu) and K4 (flash_attention_packed.cu): warp-specialised
// TMA + wgmma on the pieces of hopper.cuh.
//
// A producer warp (one issuing thread) loads the block's Q once and then K
// and V tiles by TMA into a ring of shared-memory stages, each with a full
// and an empty mbarrier.  Consumer warpgroups own 64 query rows each (two a
// block where 128-row tiles still give 132 blocks, else one, so that more
// blocks run):
// - q is rescaled in shared memory to bf16(q * scale * log2(e)), the TPU
//   kernels' rounding point, and its columns past D zeroed;
// - S = Qs K^T by wgmma m64nBKk16 with both operands K-major in shared
//   memory, as TMA wrote them;
// - the softmax runs in the accumulator registers, P is packed to bf16 in
//   registers and is the register A operand of O += P V, with V read
//   MN-major where TMA put it: no transposes, no shared-memory P;
// - the output is stored from the registers; the fp32 row log-sum-exp
//   (natural log of the scaled scores) goes to lse [B, H, Sq] when asked:
//   K3 (flash_attention_bwd.cu) recomputes P = exp(s - lse) from it.
// Tiles are [rows][64] boxes with the 128-byte swizzle.  D=40 rows are 80
// bytes, which no swizzle span fits, so D is boxed as 64 columns and the
// products run over D padded to 48 (3 k-steps); the columns past D are
// TMA's zeros or, where the heads lie side by side (every call site: the
// 80-byte head stride is not a legal TMA stride, so the map sees a row as
// one H*D vector), the next head's values, which the zeroed q columns
// cancel in QK^T and which land in output columns that are not stored.
// This costs 64/40 of the minimal bytes (from L2: the neighbouring head's
// block reads them too) and 48/40 of the products, against a second,
// unswizzled layout for one head dim.  Keys past Sk (TMA zero-fills rows
// past the end) are masked to -inf; a 77-key cross-attention is one 80-key
// tile.  The VAE's single-head D=512 attention computes its scores once:
// two warpgroups share 64 query rows, each takes half of the QK^T
// reduction and half of the output columns, and they add their fp32
// partial scores through shared memory in warpgroup order, so both form
// the same P (K and V rings of one stage: 64 KB a tile).
//
// Two softmax modes, a template switch:
// - one pass (K1): online max and sum, O rescaled as the max moves, divided
//   by the sum once after the last PV product, as _attn_kernel does;
// - two passes (K4, TWO_PASS): _packed_attn_kernel multiplies the
//   normaliser 1/sum into P BEFORE the PV product and rounds P to bf16.
//   Streaming keys cannot know the sum before the first PV, so the block
//   walks its keys twice: pass 1 streams K tiles only (S = Qs K^T, online
//   max m and sum l in fp32), pass 2 streams K and V, recomputes S and
//   accumulates bf16(exp2(s - m) * (1/l)) V; nothing is divided after PV.
//   The K ring's stages and phases run on across the two passes (2 Sk/BK
//   K tiles), the V ring's over pass 2 alone (Sk/BK): the producer issues
//   no V load in pass 1.  6 instead of 4 operations per (q, k, d) and two
//   exponentials per score: the price of the TPU's rounding point.  The
//   exponentials, not the products, bound it: 2 H S^2 of them take 0.07 ms
//   at [1,4096,8,40] at MUFU's rate, so this mode takes each by one
//   ex2.approx and runs two blocks an SM where registers allow.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

// Everything here has internal linkage in each library that includes it:
// with external names, two libraries loaded into one process (a tree and
// the checkout it is timed against) would share the static locals of the
// same template instantiation (the dynamic linker unifies them), such as
// set_smem_once's record that one library's kernel has its shared-memory
// attribute, and the other library's launch would then fail.
namespace {
namespace fwd_tma {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr float kLn2 = 0.6931471805599453f;

// 2^x by one MUFU.EX2 (denormal results flush to zero, which a bf16 P of a
// softmax row never needs); exp2f adds a range fix-up around it
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct Strides {
  long long b, s, h;  // element strides of batch, sequence and head; head dim is unit-stride
};

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

// The body of both kernels below; the maps are their __grid_constant__
// parameters, whose addresses TMA takes.
template <int DN, int BK, int NWG, bool SPLITD, int STAGES, bool TWO_PASS>
__device__ __forceinline__ void fwd_tma_body(const CUtensorMap& tq, const CUtensorMap& tk,
                                             const CUtensorMap& tv, bf16* __restrict__ o,
                                             float* __restrict__ lse, const FwdArgs& a, float qscale) {
  using L = FwdTile<DN, BK, NWG, SPLITD, STAGES>;
  constexpr int NCH = L::NCH, BQ = L::BQ;
  constexpr int KS = DN / 16;                      // k-steps of QK^T
  constexpr int KS_W = SPLITD ? KS / NWG : KS;     // this warpgroup's
  constexpr int NO = SPLITD ? DN / NWG : DN;       // output columns of a warpgroup
  static_assert(DN % 16 == 0 && BK % 16 == 0, "tile shape");
  static_assert(!SPLITD || (KS % NWG == 0 && NO % 64 == 0), "D split");
  static_assert(!(SPLITD && TWO_PASS), "the two-pass mode owns its rows");

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
  const int nk = TWO_PASS ? 2 * ntiles : ntiles;  // K tiles streamed (the K ring's turns)
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
      for (int it = 0; it < nk; ++it) {
        const int j = it < ntiles ? it : it - ntiles;  // key tile
        const int s = it % STAGES, ph = (it / STAGES) & 1;
        mbar_wait(emptyK + s, ph ^ 1);
        mbar_expect_tx(fullK + s, L::KV_BYTES);
        for (int c = 0; c < NCH; ++c)
          tma_load(sK + s * L::KV_BYTES + c * BK * 128, &tk, fullK + s, ck + 64 * c, j * BK, hh, b, r4k);
        if (TWO_PASS && it < ntiles) continue;  // pass 1 reads no V
        const int sv = j % STAGES, pv = (j / STAGES) & 1;  // the V ring turns once a PV tile
        mbar_wait(emptyV + sv, pv ^ 1);
        mbar_expect_tx(fullV + sv, L::KV_BYTES);
        for (int c = 0; c < NCH; ++c)
          tma_load(sV + sv * L::KV_BYTES + c * BK * 128, &tv, fullV + sv, cv + 64 * c, j * BK, hh, b, r4v);
      }
    }
  } else {  // consumers
    const int t = tid % 128, warp = t / 32, lane = t % 32, g = lane / 4, tg = lane % 4;
    mbar_wait(barQ, 0);
    // q * scale * log2(e) rounded to bf16 in place (the TPU kernels'
    // rounding point); columns past D zeroed, so that what a flat map
    // brought of the next head adds nothing to the scores
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

    // S = Qs K^T of key tile j from the K ring's turn `it`, log2 domain,
    // keys past Sk at -inf; the K stage goes back as soon as S is formed
    auto scores = [&](int it, int j, float (&sacc)[BK / 2]) {
      const int s = it % STAGES, ph = (it / STAGES) & 1;
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
    };
    // the new row maxima of a tile; a row's columns are spread over the 4
    // threads of a group.  Finite: every tile holds a live key.
    auto tile_max = [&](const float (&sacc)[BK / 2], float& n0, float& n1) {
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
      n0 = fmaxf(m0, mx0);
      n1 = fmaxf(m1, mx1);
    };

    int it = 0;  // the K ring's turn
    float i0 = 1.f, i1 = 1.f;  // the two-pass mode's 1 / row sums
    if constexpr (TWO_PASS) {  // pass 1: row max and sum from the K tiles alone
      for (int j = 0; j < ntiles; ++j, ++it) {
        float sacc[BK / 2];
        scores(it, j, sacc);
        float n0, n1;
        tile_max(sacc, n0, n1);
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          ps0 += ex2(sacc[4 * n] - n0) + ex2(sacc[4 * n + 1] - n0);
          ps1 += ex2(sacc[4 * n + 2] - n1) + ex2(sacc[4 * n + 3] - n1);
        }
        l0 = l0 * ex2(m0 - n0) + ps0;
        l1 = l1 * ex2(m1 - n1) + ps1;
        m0 = n0;
        m1 = n1;
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // whole row sums on every thread of the group
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      i0 = 1.f / l0;
      i1 = 1.f / l1;
    }

    for (int j = 0; j < ntiles; ++j, ++it) {
      float sacc[BK / 2];
      scores(it, j, sacc);
      if constexpr (TWO_PASS) {  // P = exp2(s - m) / l, the final normaliser before PV
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          sacc[4 * n] = ex2(sacc[4 * n] - m0) * i0;
          sacc[4 * n + 1] = ex2(sacc[4 * n + 1] - m0) * i0;
          sacc[4 * n + 2] = ex2(sacc[4 * n + 2] - m1) * i1;
          sacc[4 * n + 3] = ex2(sacc[4 * n + 3] - m1) * i1;
        }
      } else {  // online softmax: O rescaled as the max moves
        float n0, n1;
        tile_max(sacc, n0, n1);
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
      const int sv = j % STAGES, pv = (j / STAGES) & 1;
      mbar_wait(fullV + sv, pv);
      const uint32_t va = smem_addr(sV + sv * L::KV_BYTES) + (oc0 / 64) * BK * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<NO>(oacc, pa[kk], desc(va + kk * 2048, BK * 128), 1);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(oacc);
      fence_regs(pa);
      if (t == 0) mbar_arrive(emptyV + sv);
    }

    if constexpr (!TWO_PASS) {  // row sums across the group; normalise after PV
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      i0 = 1.f / l0;
      i1 = 1.f / l1;
    }
    const float o0 = TWO_PASS ? 1.f : i0, o1 = TWO_PASS ? 1.f : i1;
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
            __floats2bfloat162_rn(oacc[4 * n] * o0, oacc[4 * n + 1] * o0);
      if (r1 < a.sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r1 * a.o_ss + c) =
            __floats2bfloat162_rn(oacc[4 * n + 2] * o1, oacc[4 * n + 3] * o1);
    }
  }
}

// K1: the one-pass mode
template <int DN, int BK, int NWG, bool SPLITD, int STAGES>
__global__ void __launch_bounds__(FwdTile<DN, BK, NWG, SPLITD, STAGES>::THREADS, 1)
flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                     float* __restrict__ lse, FwdArgs a, float qscale) {
  fwd_tma_body<DN, BK, NWG, SPLITD, STAGES, false>(tq, tk, tv, o, lse, a, qscale);
}

// K4: the two-pass mode (its own name, so that profiles and ptxas reports
// tell it from K1).  Two blocks an SM at D <= 48: at 64-key tiles a thread
// needs 85 registers, and four consumer warpgroups on an SM hide more of
// the exponentials' latency than two (12-14% faster than one block of
// 128-key tiles at [B,4096,8,40]); at D=80 two blocks would spill.
template <int DN, int BK, int NWG>
__global__ void __launch_bounds__(FwdTile<DN, BK, NWG, false, 2>::THREADS, DN <= 48 ? 2 : 1)
packed_fwd_tma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                      float* __restrict__ lse, FwdArgs a, float qscale) {
  fwd_tma_body<DN, BK, NWG, false, 2, true>(tq, tk, tv, o, lse, a, qscale);
}

// The body's variant for a shape; forward_plan() and packed_forward_plan()
// in madm_torch/ops/flash_attention.py make the same choice.
struct FwdPlan {
  int dn, bk, nwg, splitd, stages, bq, smem;
};

// two consumer warpgroups (128 query rows) a block where that still gives
// 132 blocks, the H100's SMs; else one, so that more blocks run
inline bool fills(int b, int sq, int h) { return (long long)(sq + 127) / 128 * h * b >= 132; }

template <int DN, int BK, int NWG, bool SPLITD, int STAGES>
int tma_smem() { return FwdTile<DN, BK, NWG, SPLITD, STAGES>::SMEM; }

inline int plan_smem(const FwdPlan& p) {
  if (p.splitd) return tma_smem<512, 64, 2, true, 1>();
#define S(DN, BK) (p.nwg == 1 ? tma_smem<DN, BK, 1, false, 2>() : tma_smem<DN, BK, 2, false, 2>())
  if (p.dn == 48) return p.bk == 80 ? S(48, 80) : S(48, 128);
  if (p.dn == 80) return p.bk == 80 ? S(80, 80) : S(80, 128);
  return p.bk == 80 ? S(160, 80) : S(160, 64);
#undef S
}

inline FwdPlan fwd_plan(int b, int sq, int sk, int h, int d) {
  FwdPlan p{};
  p.dn = d <= 48 ? 48 : d <= 80 ? 80 : d <= 160 ? 160 : 512;
  p.splitd = p.dn == 512;
  p.bk = p.splitd ? 64 : sk <= 80 ? 80 : p.dn == 160 ? 64 : 128;
  p.nwg = p.splitd || fills(b, sq, h) ? 2 : 1;
  p.stages = p.splitd ? 1 : 2;
  p.bq = p.splitd ? 64 : 64 * p.nwg;
  p.smem = plan_smem(p);
  return p;
}

template <auto K, int SMEM, int THREADS>
cudaError_t start(dim3 grid, const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* o,
                  float* lse, const FwdArgs& a, float qscale, cudaStream_t stream) {
  cudaError_t err = set_smem_once<K>(SMEM);
  if (err != cudaSuccess) return err;
  K<<<grid, THREADS, SMEM, stream>>>(mq, mk, mv, static_cast<bf16*>(o), lse, a, qscale);
  return cudaGetLastError();
}

template <int DN, int BK, int NWG, bool SPLITD, int STAGES, bool TWO_PASS>
cudaError_t launch_tma(const void* q, const void* k, const void* v, void* o, float* lse, int b, int sq,
                       int sk, int h, int d, Strides qs, Strides ks, Strides vs, Strides os,
                       float qscale, cudaStream_t stream) {
  using L = FwdTile<DN, BK, NWG, SPLITD, STAGES>;
  static_assert(!TWO_PASS || (!SPLITD && STAGES == 2), "K4's tiles");
  CUtensorMap mq, mk, mv;
  if (!cached_bf16_map(&mq, q, b, sq, h, d, qs.b, qs.s, qs.h, L::BQ) ||
      !cached_bf16_map(&mk, k, b, sk, h, d, ks.b, ks.s, ks.h, BK) ||
      !cached_bf16_map(&mv, v, b, sk, h, d, vs.b, vs.s, vs.h, BK))
    return cudaErrorInvalidValue;
  const FwdArgs a{sq, sk, d,
                  (flat_heads(h, d, qs.h) ? 0 : 1) | (flat_heads(h, d, ks.h) ? 0 : 2) |
                      (flat_heads(h, d, vs.h) ? 0 : 4),
                  os.b, os.s, os.h};
  const dim3 grid((sq + L::BQ - 1) / L::BQ, h, b);
  if constexpr (TWO_PASS)
    return start<packed_fwd_tma_kernel<DN, BK, NWG>, L::SMEM, L::THREADS>(grid, mq, mk, mv, o, lse, a, qscale, stream);
  else
    return start<flash_fwd_tma_kernel<DN, BK, NWG, SPLITD, STAGES>, L::SMEM, L::THREADS>(grid, mq, mk, mv, o, lse,
                                                                                       a, qscale, stream);
}

template <int DN, int BK, bool TWO_PASS>
cudaError_t launch_tma_rows(int nwg, const void* q, const void* k, const void* v, void* o, float* lse,
                            int b, int sq, int sk, int h, int d, Strides qs, Strides ks, Strides vs,
                            Strides os, float qscale, cudaStream_t st) {
  if (nwg == 1)
    return launch_tma<DN, BK, 1, false, 2, TWO_PASS>(q, k, v, o, lse, b, sq, sk, h, d, qs, ks, vs, os, qscale, st);
  return launch_tma<DN, BK, 2, false, 2, TWO_PASS>(q, k, v, o, lse, b, sq, sk, h, d, qs, ks, vs, os, qscale, st);
}

}  // namespace fwd_tma
}  // namespace
