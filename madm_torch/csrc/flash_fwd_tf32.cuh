// K1's fp32 body for Hopper (sm_90a): flash-attention forward in fp32 on
// the tensor cores, "3xTF32", TMA + wgmma on the pieces of hopper.cuh.
// flash_attention.cu launches it for every fp32 call that TMA can address
// (D % 4 == 0, 16-byte aligned bases, stepped strides of a multiple of 4
// elements); the SIMT body there takes the rest.
//
// Bound.  4 H Sq Sk D operations in fp32; on the tensor cores an fp32
// product takes at least three tf32 products (below), 12 H Sq Sk D
// operations at 495 TFLOP/s, far above the bytes moved: bound by
// operations (the bound chip_smoke.py reports; this body does six a score
// and five a P V term at D <= 80, for accuracy).  The SIMT body it
// replaces ran 4 H Sq Sk D FMAs on the CUDA cores (67 TFLOP/s) from shared
// memory.
//
// Accuracy.  A tf32 wgmma reads an fp32 word with 10 explicit mantissa
// bits.  Every operand x is split into hi = x rounded to the nearest tf32
// (its low 13 mantissa bits then zero) and lo = x - hi (exact in fp32,
// |lo| <= 2^-11 |x|), stored rounded to tf32 too, and each product is
// ah bh + ah bl + al bh, the small ones first: the dropped al bl and the
// rounding of each lo are each below 2^-22 |a b| and of either sign
// (clearing the 13 bits instead would err twice as much, always towards
// zero), against 2^-11 for one tf32 product, which the 1e-4 checks of the
// fp32 path would not hold.  Where memory allows, a third piece, lo2 =
// what rounding lo left (x = hi + lo + lo2 exactly), and the products al
// bl and a's lo2 x bh (and ah x b's lo2) take those terms too: q and k at
// D <= 80 (six products a score; a third Q and K tile fit in shared
// memory), P in registers at D <= 160 (five products in P V).  The tensor
// cores' own fp32 accumulation errs more than fp32 over long sums, so they
// are kept short: each k-step's score products go to a fresh accumulator
// (two in turn, the next step's products running while the last is added)
// that is added to the scores in fp32 on the CUDA cores, and P V the same
// way, each k-step (D <= 80; each key tile at D = 160 and 512, where
// registers run short).  With one accumulator for a whole row the outputs
// sat ~10x farther from the CPU twin than the SIMT body's at 4096 keys.
// The toy train steps that chip_smoke.py holds CUDA against CPU (phases
// 11-13) react to changes at fp32 rounding level: a ReLU near 0 (phase
// 13's 'structure' step), gradient norms off by 1e-4 of themselves: they
// measure nearness to the CPU's fp32, not to fp64.  `python -m
// madm_torch.tf32_variants` builds variants of this body: all are as near
// fp64 as this one, yet P in two pieces, three products throughout, or P V
// in one accumulator a key tile each move one of those checks past its
// tolerance; this body (and q and k in two pieces) passes them all.  q * scale * log2(e) is
// formed in fp32 before the split (the bf16 body's rounding point is
// bf16's alone); the softmax is the online base-2 one of the bf16 body
// with exp2f (2 ulp), and P is split in registers like any operand.
//
// Layout.  Tiles are 128-byte-swizzled boxes of [rows][32 fp32] (one
// swizzle row is 32 words = 4 tf32 k-steps), as TMA writes them and as the
// K-major wgmma descriptors read them.  A tf32 wgmma takes its shared
// operands K-major only:
// - S = Q K^T: Q (A) and K (B) are K-major as TMA wrote them; the consumers
//   split each raw tile into a hi copy and a lo copy of the same layout.
// - O += P V: P is the register A operand, straight from the score
//   accumulators; V (B) must be K-major, [D][keys], so the consumers write
//   each raw V tile transposed into Vt hi and lo tiles [key chunk of 32]
//   [D rows][32 keys].  The A fragment holds columns tg and tg + 4 of each
//   8-key step where the accumulator holds keys 2 tg and 2 tg + 1, so each
//   8-key group of Vt is stored in the order (0, 2, 4, 6, 1, 3, 5, 7): P
//   needs no shuffle.
// Every block thread (one or two consumer warpgroups, no producer warp)
// splits.  The ring's items (a K tile, a V tile; at D = 512 Q and K column
// chunks, then V column chunks) are pipelined one deep: an item's products
// are issued, the next item is split into the other of two regions while
// they run, the products are waited for, and one block barrier makes the
// split visible to both warpgroups and frees its raw slot, into which one
// thread then issues the TMA load STAGES items ahead.  (Splitting while
// the products run was faster on the card than splitting after them.)
//
// Shapes.  D pads to 40, 80, 160 (the PV width; the columns past D are
// TMA's zeros) or 512, the main path's head dims.  Q (its pieces) stays in
// shared memory for D <= 160, one warpgroup of 64 rows (two, 128 rows, at
// D <= 40 where that still gives 132 blocks); 64-key tiles at D = 40 (a
// 77-key cross-attention is two, the second masked past key 77), 32 at
// D = 80 and 160, as many ring stages as shared memory holds, up to 3
// (one 80-key tile for 77 keys does not fit beside the third Q and K
// tiles).  At D = 512 a
// 64-row Q is 256 KB in hi and lo, so Q and K stream through the ring in
// 64-column items with V in 64-column items after them; two warpgroups
// share the 64 rows, each takes half of every QK^T item's k-steps and 256
// of the output columns, and their partial scores are summed through shared
// memory in warpgroup order, so both form the same P.  ptxas serializes
// this form's wgmma (C7512: 128 output accumulators a thread leave too few
// registers); P from shared memory and 32-key tiles did not lift that and
// were slower on the card.
//
// Key split.  Where the query tiles give fewer than 132 blocks (D = 512 at
// B = 1, H = 1: 64), the key tiles of each query tile are cut into nsplit
// contiguous runs, one block each, nsplit chosen from ceil(132 / blocks)
// to twice that for the fullest last wave; each block writes its fp32
// partials (o unnormalised, row max m in the log2 domain, row sum l) to the
// workspace, and a combine kernel merges them in split order (no atomics:
// deterministic) and writes o and lse.
//
// f32_plan() states the choice; forward_plan() in
// madm_torch/ops/flash_attention.py makes the same one.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_fwd_tma.cuh"
#include "hopper.cuh"

namespace {
namespace fwd_tf32 {

using namespace hopper;
using fwd_tma::Strides;

constexpr float kLn2 = 0.6931471805599453f;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kSMs = 132;           // H100 SXM

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int cmin(int a, int b) { return a < b ? a : b; }

struct F32Args {
  int b, sq, sk, d, nsplit;
  long long o_sb, o_ss, o_sh;
};

// DN: the padded head dim; BK: keys a tile; NWG: consumer warpgroups;
// SPLITD: the D = 512 form (Q streamed, warpgroups share rows and split D).
// Shared memory: Q's pieces (D <= 160), two split regions, the partial
// scores (SPLITD), STAGES raw ring slots, the barriers, 1024 to align.
template <int DN, int BK, int NWG, bool SPLITD>
struct TfTile {
  static constexpr int KEYS = BK;  // keys a tile
  static constexpr int BQ = SPLITD ? 64 : 64 * NWG;
  static constexpr int DS = SPLITD ? 64 : (DN + 31) / 32 * 32;  // D columns of a QK^T item
  static constexpr int NCHS = DS / 32;                           // 32-column boxes of an item row
  static constexpr int NSC = SPLITD ? DN / DS : 1;               // QK^T items a key tile
  static constexpr int CG = SPLITD ? NWG : 1;                    // column groups of a V item
  static constexpr int NO = SPLITD ? DN / NWG : DN;              // output columns of a warpgroup
  static constexpr int DVW = SPLITD ? 64 : DN;                   // a group's columns in a V item (PV's N)
  static constexpr int NVC = NO / DVW;                           // V items a key tile
  static constexpr int VB = (DVW + 31) / 32;                     // boxes of a group's V row
  static constexpr int KC = (BK + 31) / 32;                      // 32-key chunks of a Vt tile
  static constexpr int QBOX = BQ * 128, KBOX = BK * 128;         // bytes of one [rows][32] box
  static constexpr int S_RAW = (SPLITD ? NCHS * QBOX : 0) + NCHS * KBOX;
  static constexpr int V_RAW = CG * VB * KBOX;
  static constexpr int RAW = cmax(S_RAW, V_RAW);
  static constexpr int V_PIECE = CG * KC * DVW * 128;  // Vt's hi or lo tiles
  static constexpr int V_SPLIT = 2 * V_PIECE;
  static constexpr bool S3 = !SPLITD && DN <= 80;  // q and k in three tf32 pieces (shared memory allowing)
  static constexpr bool P3 = !SPLITD;              // P in three pieces (registers allowing)
  static constexpr int REGION = cmax((S3 ? 3 : 2) * S_RAW, V_SPLIT);
  static constexpr int Q_BYTES = SPLITD ? 0 : (S3 ? 3 : 2) * NCHS * QBOX;
  static constexpr int PART = SPLITD ? NWG * 64 * BK * 4 : 0;
  static constexpr int FIXED = 1024 + Q_BYTES + 2 * REGION + PART;
  static constexpr int STAGES = cmin(3, (kSmemLimit - FIXED - 8 * 4) / RAW);
  static constexpr int BAR_OFF = Q_BYTES + 2 * REGION + PART + STAGES * RAW;
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + STAGES);
  static constexpr int THREADS = 128 * NWG;
  static_assert(STAGES >= 1 && SMEM <= kSmemLimit, "shared memory");
  static_assert(DN % 8 == 0 && BK % 8 == 0 && DVW % 8 == 0 && NO % DVW == 0, "tile shape");
  static_assert(!SPLITD || (DN % DS == 0 && NWG == 2), "the D = 512 form");
};

__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  hi = make_float4(tf32_rn(x.x), tf32_rn(x.y), tf32_rn(x.z), tf32_rn(x.w));
  lo = make_float4(tf32_rn(x.x - hi.x), tf32_rn(x.y - hi.y), tf32_rn(x.z - hi.z), tf32_rn(x.w - hi.w));
}

// x = hi + lo + lo2 exactly: lo2 is what rounding x - hi to lo left (a
// few bits, itself a tf32 word)
__device__ __forceinline__ void split4_3(float4 x, float4& hi, float4& lo, float4& lo2) {
  split4(x, hi, lo);
  lo2 = make_float4(tf32_rn((x.x - hi.x) - lo.x), tf32_rn((x.y - hi.y) - lo.y), tf32_rn((x.z - hi.z) - lo.z),
                    tf32_rn((x.w - hi.w) - lo.w));
}

__device__ __forceinline__ float comp(const float4& v, int m) { return m == 0 ? v.x : m == 1 ? v.y : m == 2 ? v.z : v.w; }

// `units` 16-byte units of src, times `scale`, into hi, lo (and, with
// LO2, lo2) copies of the same layout (src may be hi: each unit is read
// before it is written)
template <bool LO2>
__device__ __forceinline__ void split_units(const unsigned char* src, unsigned char* hi, unsigned char* lo,
                                            unsigned char* lo2, int units, float scale, int tid, int nth) {
  for (int e = tid; e < units; e += nth) {
    float4 x = reinterpret_cast<const float4*>(src)[e];
    x = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    float4 h, l, l2;
    split4_3(x, h, l, l2);
    reinterpret_cast<float4*>(hi)[e] = h;
    reinterpret_cast<float4*>(lo)[e] = l;
    if (LO2) reinterpret_cast<float4*>(lo2)[e] = l2;
  }
}

// A raw V item ([group][box][BK keys][32 columns]) into Vt hi and lo
// ([group][32-key chunk][DVW rows][32 keys], 8-key groups in the order
// 0, 2, 4, 6, 1, 3, 5, 7).  A task is the even or the odd 4 keys of an
// 8-key group x 4 columns: 4 units read, 4 columns x (hi, lo) units written.
template <class L>
__device__ __forceinline__ void split_v(const unsigned char* raw, unsigned char* vt, int tid) {
  constexpr int QUADS = L::DVW / 4, OCTS = L::KEYS / 8;
  constexpr int GROUP = L::KC * L::DVW * 128, HALF = L::V_PIECE;
  for (int e = tid; e < L::CG * OCTS * 2 * QUADS; e += L::THREADS) {
    const int cq = e % QUADS, par = (e / QUADS) % 2, o8 = (e / (2 * QUADS)) % OCTS, w = e / (2 * QUADS * OCTS);
    const int qq = cq % 8;
    const unsigned char* src = raw + ((w * L::VB + cq / 8) * L::KEYS + 8 * o8) * 128;
    float4 r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = par + 2 * i;  // key 8 o8 + row, swizzled by row % 8 = row
      r[i] = *reinterpret_cast<const float4*>(src + row * 128 + ((qq ^ row) << 4));
    }
    unsigned char* dst = vt + w * GROUP + (o8 / 4) * L::DVW * 128;
    const int u = 2 * (o8 % 4) + par;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int n = 4 * cq + m;
      float4 hi, lo;
      split4(make_float4(comp(r[0], m), comp(r[1], m), comp(r[2], m), comp(r[3], m)), hi, lo);
      unsigned char* at = dst + n * 128 + ((u ^ (n & 7)) << 4);
      *reinterpret_cast<float4*>(at) = hi;
      *reinterpret_cast<float4*>(at + HALF) = lo;
    }
  }
}

template <int DN, int BK, int NWG, bool SPLITD>
__global__ void __launch_bounds__(TfTile<DN, BK, NWG, SPLITD>::THREADS, 1)
flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, float* __restrict__ o, float* __restrict__ lse,
                      float* __restrict__ ws, F32Args a, float qscale) {
  using L = TfTile<DN, BK, NWG, SPLITD>;
  constexpr int NTH = L::THREADS, BQ = L::BQ, NCHS = L::NCHS, QBOX = L::QBOX, KBOX = L::KBOX;
  constexpr int DVW = L::DVW, NO = L::NO, NVC = L::NVC, NSC = L::NSC, KC = L::KC;
  constexpr int STAGES = L::STAGES, IPT = NSC + NVC;  // ring items a key tile
  constexpr int KS = SPLITD ? L::DS / 8 / NWG : DN / 8;  // k-steps a warpgroup takes of a QK^T item

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sReg = sQ + L::Q_BYTES;                     // [2] split regions
  float* sPart = reinterpret_cast<float*>(sReg + 2 * L::REGION);
  unsigned char* sRaw = sReg + 2 * L::REGION + L::PART;      // [STAGES] raw slots
  uint64_t* barQ = reinterpret_cast<uint64_t*>(sQ + L::BAR_OFF);
  uint64_t* full = barQ + 1;

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tg = lane % 4;
  const int q0 = blockIdx.x * BQ, hh = blockIdx.y;
  const int b = blockIdx.z / a.nsplit, split = blockIdx.z % a.nsplit;
  const int nkt = (a.sk + BK - 1) / BK;
  const int j0 = split * nkt / a.nsplit, j1 = (split + 1) * nkt / a.nsplit;
  const int nitems = (j1 - j0) * IPT;

  // item `it` of the ring: QK^T items (Q and K columns of one 64-column
  // chunk at D = 512, the whole K tile below), then V items, a key tile at a time
  auto issue = [&](int it) {
    if (it >= nitems) return;
    const int s = it % STAGES, j = j0 + it / IPT, sub = it % IPT;
    unsigned char* dst = sRaw + s * L::RAW;
    uint64_t* bar = full + s;
    if (sub < NSC) {
      mbar_expect_tx(bar, L::S_RAW);
      if constexpr (SPLITD) {
        for (int x = 0; x < NCHS; ++x) tma_load(dst + x * QBOX, &tq, bar, sub * L::DS + 32 * x, q0, hh, b, true);
        dst += NCHS * QBOX;
      }
      for (int x = 0; x < NCHS; ++x) tma_load(dst + x * KBOX, &tk, bar, sub * L::DS + 32 * x, j * BK, hh, b, true);
    } else {
      const int v = sub - NSC;
      mbar_expect_tx(bar, L::V_RAW);
      for (int w = 0; w < L::CG; ++w)
        for (int x = 0; x < L::VB; ++x)
          tma_load(dst + (w * L::VB + x) * KBOX, &tv, bar, w * NO + v * DVW + 32 * x, j * BK, hh, b, true);
    }
  };

  if (tid == 0) {
    mbar_init(barQ, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(full + s, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    if constexpr (!SPLITD) {
      mbar_expect_tx(barQ, NCHS * QBOX);
      for (int x = 0; x < NCHS; ++x) tma_load(sQ + x * QBOX, &tq, barQ, 32 * x, q0, hh, b, true);
    }
    for (int i = 0; i < STAGES; ++i) issue(i);
  }
  if constexpr (!SPLITD) {  // q * scale * log2(e) in fp32, split in place: [hi | lo]
    mbar_wait(barQ, 0);
    split_units<L::S3>(sQ, sQ, sQ + NCHS * QBOX, sQ + 2 * NCHS * QBOX, NCHS * QBOX / 16, qscale, tid, NTH);
  }

  float oacc[NVC][DVW / 2];
#pragma unroll
  for (int v = 0; v < NVC; ++v)
#pragma unroll
    for (int i = 0; i < DVW / 2; ++i) oacc[v][i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // rows g and g+8 of this warp, log2 domain
  float l0 = 0.f, l1 = 0.f;                       // this thread's share of the row sums
  const int oc0 = SPLITD ? wg * NO : 0;           // first output column of this warpgroup

  // The ring's items in order, pipelined one item deep: an item's products
  // are issued, the next item is split into the other region while they
  // run, then they are waited for and one barrier makes the split visible to
  // both warpgroups (and frees the raw slot it was read from).
  auto split_item = [&](int it) {
    const int s = it % STAGES;
    mbar_wait(full + s, (it / STAGES) & 1);
    unsigned char* reg = sReg + (it & 1) * L::REGION;
    const unsigned char* raw = sRaw + s * L::RAW;
    if (it % IPT >= NSC) {
      split_v<L>(raw, reg, tid);
    } else if constexpr (SPLITD) {
      split_units<false>(raw, reg, reg + L::S_RAW, nullptr, NCHS * QBOX / 16, qscale, tid, NTH);
      split_units<false>(raw + NCHS * QBOX, reg + NCHS * QBOX, reg + L::S_RAW + NCHS * QBOX, nullptr,
                         NCHS * KBOX / 16, 1.f, tid, NTH);
    } else {
      split_units<L::S3>(raw, reg, reg + L::S_RAW, reg + 2 * L::S_RAW, NCHS * KBOX / 16, 1.f, tid, NTH);
    }
    fence_async_smem();
  };

  // after an item's products are issued: split the next item while they
  // run, wait for them; then one barrier makes the split visible to both
  // warpgroups and frees the raw slot it was read from
  auto next_item = [&](int it) {
    if (it + 1 < nitems) split_item(it + 1);
    wgmma_wait0();
  };
  auto advance = [&](int it) {
    if (it + 1 >= nitems) return;
    __syncthreads();
    if (tid == 0) issue(it + 1 + STAGES);
  };

  uint32_t ph[BK / 8][4], pl[BK / 8][4], pl2[L::P3 ? BK / 8 : 1][4];  // P's pieces, the register A operand
  split_item(0);
  __syncthreads();
  if (tid == 0) issue(STAGES);
  int it = 0;
  for (int j = j0; j < j1; ++j) {
    float sacc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
#pragma unroll 1
    for (int c = 0; c < NSC; ++c, ++it) {  // S = Qs K^T from tf32 pieces
      const uint32_t reg = smem_addr(sReg + (it & 1) * L::REGION);
      const uint32_t qh = SPLITD ? reg : smem_addr(sQ) + wg * 64 * 128;
      const uint32_t ql = qh + (SPLITD ? L::S_RAW : NCHS * QBOX);
      const uint32_t kh = reg + (SPLITD ? NCHS * QBOX : 0), kl = kh + L::S_RAW;
      const int k0 = SPLITD ? wg * KS : 0;
      // each k-step's products in a fresh accumulator (two, in turn), added
      // to the scores in fp32 once the step is done
      float part[2][BK / 2];
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        const int k = k0 + i;
        const uint32_t qo = (k / 4) * QBOX + (k % 4) * 32, ko = (k / 4) * KBOX + (k % 4) * 32;
        wgmma_fence();
        if (L::S3) {
          const uint32_t ql2 = ql + NCHS * QBOX, kl2 = kl + L::S_RAW;
          wgmma_tf32_ss<BK>(part[i & 1], desc(ql2 + qo, 16), desc(kh + ko, 16), 0);
          wgmma_tf32_ss<BK>(part[i & 1], desc(qh + qo, 16), desc(kl2 + ko, 16), 1);
          wgmma_tf32_ss<BK>(part[i & 1], desc(ql + qo, 16), desc(kl + ko, 16), 1);
        }
        wgmma_tf32_ss<BK>(part[i & 1], desc(ql + qo, 16), desc(kh + ko, 16), L::S3 ? 1 : 0);
        wgmma_tf32_ss<BK>(part[i & 1], desc(qh + qo, 16), desc(kl + ko, 16), 1);
        wgmma_tf32_ss<BK>(part[i & 1], desc(qh + qo, 16), desc(kh + ko, 16), 1);
        wgmma_commit();
        if (i > 0) {
          wgmma_wait<1>();
          fence_regs(part[(i - 1) & 1]);
#pragma unroll
          for (int e = 0; e < BK / 2; ++e) sacc[e] += part[(i - 1) & 1][e];
        }
      }
      next_item(it);
      fence_regs(part[(KS - 1) & 1]);
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) sacc[e] += part[(KS - 1) & 1][e];
      advance(it);
    }
    if constexpr (SPLITD) {  // sum the partial scores, in warpgroup order on every warpgroup
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sPart[(wg * (BK / 2) + i) * 128 + t] = sacc[i];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float tot = 0.f;
#pragma unroll
        for (int w = 0; w < NWG; ++w) tot += sPart[(w * (BK / 2) + i) * 128 + t];
        sacc[i] = tot;
      }
    }
    if ((j + 1) * BK > a.sk) {  // keys past Sk (TMA's zero rows) are masked, not zero
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const int key = j * BK + 8 * n + 2 * tg;
        if (key >= a.sk) sacc[4 * n] = sacc[4 * n + 2] = -CUDART_INF_F;
        if (key + 1 >= a.sk) sacc[4 * n + 1] = sacc[4 * n + 3] = -CUDART_INF_F;
      }
    }
    // online softmax: a row's columns are spread over the 4 threads of a
    // group; every tile holds a live key, so the maxima are finite
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
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
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
    for (int v = 0; v < NVC; ++v)
#pragma unroll
      for (int n = 0; n < DVW / 8; ++n) {
        oacc[v][4 * n] *= al0;
        oacc[v][4 * n + 1] *= al0;
        oacc[v][4 * n + 2] *= al1;
        oacc[v][4 * n + 3] *= al1;
      }
    // P's pieces as the register A operand: a k-step's a0..a3 are keys
    // 2tg (rows g, g+8) and 2tg+1 (rows g, g+8) of its 8-key group
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const float p[4] = {sacc[4 * kk], sacc[4 * kk + 2], sacc[4 * kk + 1], sacc[4 * kk + 3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float hi = tf32_rn(p[e]);
        ph[kk][e] = __float_as_uint(hi);
        pl[kk][e] = __float_as_uint(tf32_rn(p[e] - hi));
        if (L::P3) pl2[kk][e] = __float_as_uint(tf32_rn((p[e] - hi) - __uint_as_float(pl[kk][e])));
      }
    }
#pragma unroll
    for (int v = 0; v < NVC; ++v, ++it) {  // O += P V over this item's columns
      const uint32_t reg = smem_addr(sReg + (it & 1) * L::REGION);
      const uint32_t vh = reg + (SPLITD ? wg : 0) * KC * DVW * 128, vl = vh + L::V_PIECE;
      // P V in fresh accumulators added to O in fp32 once done: each k-step
      // in its own (two in turn) where registers allow (D <= 80), else the
      // item's k-steps in one
      constexpr bool PV_STEP = !SPLITD && DVW <= 80;
      constexpr int NA = PV_STEP ? 2 : 1;
      float otile[NA][DVW / 2];
      auto add_tile = [&](float (&part)[DVW / 2]) {
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < DVW / 2; ++i) oacc[v][i] += part[i];
      };
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint32_t off = (kk / 4) * DVW * 128 + (kk % 4) * 32;
        const bool fresh = PV_STEP || kk == 0;
        if (fresh) wgmma_fence();
        if (L::P3) {
          wgmma_tf32_rs<DVW>(otile[kk % NA], pl2[L::P3 ? kk : 0], desc(vh + off, 16), fresh ? 0 : 1);
          wgmma_tf32_rs<DVW>(otile[kk % NA], pl[kk], desc(vl + off, 16), 1);
        }
        wgmma_tf32_rs<DVW>(otile[kk % NA], pl[kk], desc(vh + off, 16), fresh && !L::P3 ? 0 : 1);
        wgmma_tf32_rs<DVW>(otile[kk % NA], ph[kk], desc(vl + off, 16), 1);
        wgmma_tf32_rs<DVW>(otile[kk % NA], ph[kk], desc(vh + off, 16), 1);
        if (PV_STEP) {
          wgmma_commit();
          if (kk > 0) {
            wgmma_wait<1>();
            add_tile(otile[(kk - 1) % NA]);
          }
        }
      }
      if (!PV_STEP) wgmma_commit();
      next_item(it);
      add_tile(otile[(BK / 8 - 1) % NA]);
      fence_regs(ph);
      fence_regs(pl);
      fence_regs(pl2);
      advance(it);
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {  // row sums across the group
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const bool whole = a.nsplit == 1;  // else unnormalised partials to the workspace
  const float i0 = whole ? 1.f / l0 : 1.f, i1 = whole ? 1.f / l1 : 1.f;
  const int r0 = q0 + (SPLITD ? 0 : 64 * wg) + 16 * warp + g, r1 = r0 + 8;
  const long long rows = (long long)a.b * gridDim.y * a.sq;  // (b, h, row) rows of one split
  const long long row0 = ((long long)b * gridDim.y + hh) * a.sq;
  float* ob = whole ? o + b * a.o_sb + hh * a.o_sh : ws + (split * rows + row0) * a.d;
  const long long rs = whole ? a.o_ss : a.d;
#pragma unroll
  for (int v = 0; v < NVC; ++v)
#pragma unroll
    for (int n = 0; n < DVW / 8; ++n) {
      const int c = oc0 + v * DVW + 8 * n + 2 * tg;  // D % 4 == 0: c < D implies c + 1 < D
      if (c >= a.d) continue;
      if (r0 < a.sq) *reinterpret_cast<float2*>(ob + r0 * rs + c) = make_float2(oacc[v][4 * n] * i0, oacc[v][4 * n + 1] * i0);
      if (r1 < a.sq)
        *reinterpret_cast<float2*>(ob + r1 * rs + c) = make_float2(oacc[v][4 * n + 2] * i1, oacc[v][4 * n + 3] * i1);
    }
  if (oc0 == 0 && tg == 0) {
    if (whole) {
      if (lse != nullptr) {
        if (r0 < a.sq) lse[row0 + r0] = (m0 + log2f(l0)) * kLn2;
        if (r1 < a.sq) lse[row0 + r1] = (m1 + log2f(l1)) * kLn2;
      }
    } else {
      float* mp = ws + a.nsplit * rows * a.d + split * rows + row0;
      float* lp = mp + a.nsplit * rows;
      if (r0 < a.sq) mp[r0] = m0, lp[r0] = l0;
      if (r1 < a.sq) mp[r1] = m1, lp[r1] = l1;
    }
  }
}

// The key-split partials merged in split order: M = max m_s, L = sum l_s
// 2^(m_s - M), o = (sum o_s 2^(m_s - M)) / L, lse = (M + log2 L) ln 2.  A
// thread per 4 columns of a (b, h, row); o is contiguous, so its units are
// 16-byte aligned.
__global__ void flash_fwd_tf32_combine(const float* __restrict__ ws, float* __restrict__ o,
                                       float* __restrict__ lse, F32Args a, int h) {
  const int dq = a.d / 4;
  const long long rows = (long long)a.b * h * a.sq;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * dq) return;
  const long long rr = idx / dq;
  const int c = (int)(idx % dq) * 4;
  const float* mp = ws + a.nsplit * rows * a.d;
  const float* lp = mp + a.nsplit * rows;
  float mx = -CUDART_INF_F;
  for (int s = 0; s < a.nsplit; ++s) mx = fmaxf(mx, mp[s * rows + rr]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < a.nsplit; ++s) {
    const float w = exp2f(mp[s * rows + rr] - mx);
    l += lp[s * rows + rr] * w;
    const float4 x = *reinterpret_cast<const float4*>(ws + (s * rows + rr) * a.d + c);
    acc = make_float4(acc.x + x.x * w, acc.y + x.y * w, acc.z + x.z * w, acc.w + x.w * w);
  }
  const float inv = 1.f / l;
  const int r = (int)(rr % a.sq), hh = (int)(rr / a.sq % h), b = (int)(rr / a.sq / h);
  *reinterpret_cast<float4*>(o + b * a.o_sb + hh * a.o_sh + r * a.o_ss + c) =
      make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
  if (c == 0 && lse != nullptr) lse[rr] = (mx + log2f(l)) * kLn2;
}

// ------------------------------------------------------------------ plan
struct F32Plan {
  int tma, dn, bq, bk, nwg, splitd, stages, nsplit, smem;
  long long ws;  // workspace bytes (the key split's partials)
};

// whether TMA can address an fp32 [B, S, H, D] tensor at `p` (the SIMT
// body takes it otherwise): D % 4 == 0, a 16-byte aligned base, and every
// stepped stride a positive multiple of 4 elements
inline bool f32_addressable(int b, int h, int d, const void* p, const Strides& s) {
  return d % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.s > 0 && s.s % 4 == 0 &&
         (b == 1 || (s.b > 0 && s.b % 4 == 0)) && (h == 1 || (s.h > 0 && s.h % 4 == 0));
}

// the padded head dim: the main path's 40, 80, 160 and 512 (any other D
// pads to the next of them, so that the library holds few instantiations)
inline int f32_dn(int d) { return d <= 40 ? 40 : d <= 80 ? 80 : d <= 160 ? 160 : 512; }

// every instantiation of the body: (DN, BK, NWG, SPLITD)
#define MADM_TF32_TILES(X)                                                                            \
  X(40, 64, 1, false) X(40, 64, 2, false) X(80, 32, 1, false) X(160, 32, 1, false) X(512, 64, 2, true)

// key splits for `blocks` query blocks over `nkt` key tiles: 1 where they
// fill the card; else from ceil(132 / blocks) to twice that (at most nkt),
// the count whose last wave is fullest, the smallest of equals
inline int f32_nsplit(long long blocks, int nkt) {
  if (blocks >= kSMs) return 1;
  const int lo = (int)((kSMs + blocks - 1) / blocks);
  if (lo >= nkt) return nkt;
  int best = lo;
  long long best_used = blocks * lo, best_slots = (best_used + kSMs - 1) / kSMs * kSMs;
  for (int n = lo + 1; n <= cmin(2 * lo, nkt); ++n) {
    const long long used = blocks * n, slots = (used + kSMs - 1) / kSMs * kSMs;
    if (used * best_slots > best_used * slots) best = n, best_used = used, best_slots = slots;
  }
  return best;
}

inline F32Plan f32_plan(int b, int sq, int sk, int h, int d, bool addressable) {
  F32Plan p{};
  p.tma = addressable && d >= 1 && d <= 512;
  if (!p.tma) return p;
  p.dn = f32_dn(d);
  p.splitd = p.dn == 512;
  p.nwg = p.splitd || (p.dn == 40 && fwd_tma::fills(b, sq, h)) ? 2 : 1;
  p.bq = p.splitd ? 64 : 64 * p.nwg;
  p.bk = p.splitd || p.dn == 40 ? 64 : 32;
#define X(DN, BK, NWG, SD)                                      \
  if (p.dn == DN && p.bk == BK && p.nwg == NWG) {               \
    p.stages = TfTile<DN, BK, NWG, SD>::STAGES;                 \
    p.smem = TfTile<DN, BK, NWG, SD>::SMEM;                     \
  }
  MADM_TF32_TILES(X)
#undef X
  const long long blocks = (long long)((sq + p.bq - 1) / p.bq) * h * b;
  p.nsplit = f32_nsplit(blocks, (sk + p.bk - 1) / p.bk);
  p.ws = p.nsplit > 1 ? 4LL * p.nsplit * b * h * sq * (d + 2) : 0;
  return p;
}

template <int DN, int BK, int NWG, bool SPLITD>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* o, float* lse, void* ws, int b,
                        int sq, int sk, int h, int d, Strides qs, Strides ks, Strides vs, Strides os,
                        int nsplit, float qscale, cudaStream_t stream) {
  using L = TfTile<DN, BK, NWG, SPLITD>;
  CUtensorMap mq, mk, mv;
  if (!cached_f32_map(&mq, q, b, sq, h, d, qs.b, qs.s, qs.h, L::BQ) ||
      !cached_f32_map(&mk, k, b, sk, h, d, ks.b, ks.s, ks.h, BK) ||
      !cached_f32_map(&mv, v, b, sk, h, d, vs.b, vs.s, vs.h, BK))
    return cudaErrorInvalidValue;
  const F32Args a{b, sq, sk, d, nsplit, os.b, os.s, os.h};
  auto kern = flash_fwd_tf32_kernel<DN, BK, NWG, SPLITD>;
  cudaError_t err = set_smem_once<flash_fwd_tf32_kernel<DN, BK, NWG, SPLITD>>(L::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + L::BQ - 1) / L::BQ, h, b * nsplit);
  kern<<<grid, L::THREADS, L::SMEM, stream>>>(mq, mk, mv, static_cast<float*>(o), lse, static_cast<float*>(ws),
                                              a, qscale);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  const long long n = (long long)b * h * sq * (d / 4);
  flash_fwd_tf32_combine<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(static_cast<const float*>(ws),
                                                                         static_cast<float*>(o), lse, a, h);
  return cudaGetLastError();
}

// the plan's body, launched; cudaErrorInvalidValue for a plan without one
// or a workspace `ws` of fewer than the plan's bytes
inline cudaError_t dispatch_tf32(const F32Plan& p, const void* q, const void* k, const void* v, void* o,
                                 float* lse, void* ws, long long ws_bytes, int b, int sq, int sk, int h, int d,
                                 Strides qs, Strides ks, Strides vs, Strides os, float qscale, cudaStream_t st) {
  if (p.nsplit > 1 && (ws == nullptr || ws_bytes < p.ws)) return cudaErrorInvalidValue;
#define X(DN, BK, NWG, SD)                                                                                   \
  if (p.dn == DN && p.bk == BK && p.nwg == NWG)                                                            \
    return launch_tf32<DN, BK, NWG, SD>(q, k, v, o, lse, ws, b, sq, sk, h, d, qs, ks, vs, os, p.nsplit, qscale, \
                                        st);
  MADM_TF32_TILES(X)
#undef X
  return cudaErrorInvalidValue;
}

}  // namespace fwd_tf32
}  // namespace
