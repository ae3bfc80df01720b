// K3's fp32 body for Hopper (sm_90a): the flash-attention backward in fp32
// on the tensor cores, "3xTF32", TMA + wgmma on the pieces of hopper.cuh.
// flash_attention_bwd.cu launches it for every fp32 call whose tensors TMA
// and the body's vector stores can address (D % 4 == 0, 16-byte aligned
// bases; the tensors are contiguous); its SIMT body takes the rest.
//
// Function: K3's (flash_attention_bwd.cu) with the fp32 body's rounding
// points: qs = q * scale * log2(e) formed in fp32 (as K1's fp32 body forms
// it), P = exp2(qs k^T - lse * log2(e)), dP = dO v^T, delta = rowsum(dO o),
// dS = P (dP - delta), dV = P^T dO, dK = dS^T q * scale, dQ = dS k * scale.
//
// Bound.  10 H Sq Sk D fp32 operations.  On the tensor cores an fp32
// product takes three tf32 products (below): 30 H Sq Sk D at 495 TFLOP/s,
// far above the bytes moved: bound by operations.  This body recomputes the
// scores in its dQ kernel (7 products for the function's 5, as the bf16
// body), so it does 21 H Sq Sk D tf32 multiply-adds (42 operations).  The
// SIMT body it replaces ran the same 7 products as FMAs on the CUDA cores
// (67 TFLOP/s) from shared memory.
//
// Accuracy.  Every operand x is split as K1's fp32 body splits it (hi = x
// rounded to the nearest tf32, lo = tf32(x - hi)), and each product is lo
// hi + hi lo + hi hi (the plain 3xTF32: the dropped lo lo and the rounding
// of lo are each below 2^-22 |a b|).  Where the sums are long (D <= 80: Sq
// up to 4096 queries for dK and dV, Sk keys for dQ), each tile's products go
// to a fresh accumulator that is added to the gradient in fp32 on the CUDA
// cores (K1's fp32 body found one tensor-core accumulator over 4096 terms
// ~10x farther from the CPU's fp32); at D = 160 (Sq, Sk <= 256 on the main
// path) the registers hold only the gradients, which accumulate in the
// tensor cores.  ``attention_backward_tf32x3_reference`` in
// madm_torch/ops/flash_attention.py states this arithmetic in plain torch.
//
// Layout.  A tf32 wgmma reads its shared-memory operands K-major only.  Of
// the five products, S = qs k^T and dP = dO v^T reduce over D, the rows'
// inner dimension; dV = P^T dO, dK = dS^T q and dQ = dS k reduce over
// queries or keys, so they need dO, q and k as [D][S] tiles.  The prep
// kernel writes, once a call, every operand's pieces to the workspace:
// qs, dO, k and v as [2][B, S, H, D] (hi, then lo) and q, dO and k
// transposed as [2][B, H, D, S8] (S8 = S rounded up to 8; positions past S
// zero), each group of 8 positions in the order (0, 2, 4, 6, 1, 3, 5, 7):
// the order in which the register A operand (P^T, dS^T or dS, straight
// from the score accumulators, which hold columns 2tg and 2tg + 1 where the
// A fragment holds k = tg and tg + 4) takes its k index, as K1's fp32 body
// stores Vt.  Transposing in the prep kernel, and splitting there, leaves
// the main kernels no shared-memory pass of their own: they load boxes of
// [rows][32 fp32] (128-byte swizzled) by TMA and multiply.
//
// Kernels.  1. bwd_tf32_prep: the pieces, delta and lse2 = lse * log2(e)
// (padded rows: +inf and 0, so that their P is 0).  2. The dK/dV kernel
// (MODE kDkdv): a block owns 64 keys (one consumer warpgroup; its thread 0
// issues the loads) and the query tiles of its split; S^T = K qs^T and dP^T =
// V dO^T by wgmma from shared memory, P^T and dS^T in the accumulators'
// registers, then dV += P^T dOt and dK += dS^T qt with P^T and dS^T as the
// register A operand.  The query loop is split as the bf16 body's until 132
// blocks run; the splits' fp32 partials are added in split order by
// bwd_tf32_reduce.  3. The dQ kernel (MODE kDq): a block owns 64 queries
// and walks the key tiles: S = qs k^T, dP = dO v^T, dS in registers, dQ +=
// dS kt.  Each streams its tiles through a ring of items (a tile's score
// items, then one item a gradient product), its A side (K and V, or qs and
// dO) resident in shared memory at D <= 80 and streamed in 32-column items
// beside the B side's at D = 160, where hi and lo of two [64][160] operands
// would fill the shared memory alone.
//
// f32_bwd_plan() states the choice; backward_plan() in
// madm_torch/ops/flash_attention.py makes the same one.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {
namespace bwd_tf32 {

using namespace hopper;

constexpr float kLog2eF = 1.4426950408889634f;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use
constexpr int kCard = 132;        // H100 SXM SMs
constexpr int kRows = 64;         // A-side rows of a block (one consumer warpgroup)
constexpr int kPrepRows = 32;     // rows of one prep block
constexpr int kMaxD = 160;

constexpr int imax(int a, int b) { return a > b ? a : b; }
constexpr int imin(int a, int b) { return a < b ? a : b; }

enum Mode { kDkdv = 0, kDq = 1 };

// DN: the padded head dim (40, 80, 160); BT: columns of a streamed tile
// (queries for dK/dV, keys for dQ); RES: the A side resident.  Shared
// memory: the resident A side ([A1 hi | A1 lo | A2 hi | A2 lo], NCH boxes
// of [64][32] each), STAGES ring slots, the barriers, 1024 to align.  A
// score item holds [B1 hi | B1 lo | B2 hi | B2 lo] (all NCH boxes of the
// tile's rows, or, streamed, one box each after the A side's four), and the
// tile's lse2 and delta (dK/dV, on the last score item); a product item
// the [DN][32]-boxes of one transposed operand's hi, then lo.
template <int MODE, int DN, int BT, bool RES>
struct BwdTile {
  static constexpr bool DKDV = MODE == kDkdv;
  static constexpr int NCH = (DN + 31) / 32;  // 32-column boxes of a row
  static constexpr int KS = DN / 8;           // k-steps of a score product
  static constexpr int NSC = RES ? 1 : NCH;   // score items a tile
  static constexpr int IPT = NSC + (DKDV ? 2 : 1);
  static constexpr int ABOX = kRows * 128, BBOX = BT * 128, TBOX = DN * 128;  // bytes of a box
  static constexpr int XB = RES ? NCH : 1;  // B-side boxes of one piece in a score item
  static constexpr int A_BYTES = RES ? 4 * NCH * ABOX : 0;
  static constexpr int STATS = DKDV ? 8 * BT : 0;
  static constexpr int S_ITEM = (RES ? 0 : 4 * ABOX) + 4 * XB * BBOX;  // the boxes of a score item
  static constexpr int O_ITEM = 2 * (BT / 32) * TBOX;
  static constexpr int SLOT = (imax(S_ITEM + STATS, O_ITEM) + 1023) / 1024 * 1024;
  static constexpr int STAGES = imin(4, (kSmemMax - 1024 - A_BYTES - 8 * 5) / SLOT);
  static constexpr int BAR_OFF = A_BYTES + STAGES * SLOT;
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + STAGES);
  static constexpr bool FRESH = DN <= 80;  // a tile's products in a fresh accumulator
  static_assert(STAGES >= 2 && SMEM <= kSmemMax, "shared memory");
  static_assert(DN % 8 == 0 && BT % 32 == 0 && (RES || KS % 4 == 0), "tile shape");
};

// the workspace's arrays: what the prep kernel writes and the others read
struct Ws {
  float *lse2, *delta;       // [B, H, sqs]
  float *qs, *dout, *k, *v;  // [2][B, S, H, D]: hi, then lo
  float *qt, *dot, *kt;      // [2][B, H, D, S8]: hi, then lo, 8-groups in the order (0, 2, 4, 6, 1, 3, 5, 7)
  float *dkp, *dvp;          // [nsplit][B, Sk, H, D] partials of a split dK/dV loop
};

struct PrepArgs {
  const float *q, *k, *v, *o, *dout, *lse;
  int b, sq, sk, h, d, sqs;
  float qscale;
};

__device__ __forceinline__ void split_store(float x, float* hi, float* lo, long long i) {
  const float h = tf32_rn(x);
  hi[i] = h;
  lo[i] = tf32_rn(x - h);
}

// One block of 32 rows of one (b, h) of q (as qs, and transposed unscaled),
// dO (also transposed; and delta, lse2), k (also transposed) or v: grid
// (ceil(max(sqs, Sk) / 32), H, 4 B), blockIdx.z % 4 the tensor.  The rows
// pass through shared memory so that both layouts are written coalesced.
__global__ void __launch_bounds__(256) bwd_tf32_prep(PrepArgs a, Ws w) {
  __shared__ float tile[kPrepRows][kMaxD + 1];
  const int kind = blockIdx.z % 4, b = blockIdx.z / 4, hh = blockIdx.y, D = a.d;
  const int s0 = blockIdx.x * kPrepRows;
  const int S = kind < 2 ? a.sq : a.sk;
  if (s0 >= (kind == 1 ? a.sqs : S)) return;  // dO's blocks also pad the stats to sqs rows
  const float* src = kind == 0 ? a.q : kind == 1 ? a.dout : kind == 2 ? a.k : a.v;
  float* flat = kind == 0 ? w.qs : kind == 1 ? w.dout : kind == 2 ? w.k : w.v;
  float* trans = kind == 0 ? w.qt : kind == 1 ? w.dot : kind == 2 ? w.kt : nullptr;
  const float fscale = kind == 0 ? a.qscale : 1.f;
  const long long n = (long long)a.b * S * a.h * D;  // elements of one piece
  for (int e = threadIdx.x; e < kPrepRows * D; e += 256) {
    const int r = e / D, c = e - r * D, s = s0 + r;
    float x = 0.f;
    if (s < S) {
      const long long i = (((long long)b * S + s) * a.h + hh) * D + c;
      x = src[i];
      split_store(x * fscale, flat, flat + n, i);
    }
    tile[r][c] = x;
  }
  __syncthreads();
  if (trans != nullptr) {
    const int s8 = (S + 7) / 8 * 8;
    const long long nt = (long long)a.b * a.h * D * s8;
    for (int e = threadIdx.x; e < D * kPrepRows; e += 256) {
      const int dd = e / kPrepRows, pp = e % kPrepRows, pos = s0 + pp;
      if (pos >= s8) continue;
      const int u = pp % 8, r = pp - u + (u < 4 ? 2 * u : 2 * u - 7);  // position u holds row 0 2 4 6 1 3 5 7
      split_store(tile[r][dd], trans, trans + nt, (((long long)b * a.h + hh) * D + dd) * s8 + pos);
    }
  }
  if (kind == 1) {  // delta = rowsum(dO o) and lse2 of these rows; +inf and 0 past Sq
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < kPrepRows && s0 + r < a.sqs; r += 8) {
      const int s = s0 + r;
      float acc = 0.f;
      if (s < a.sq) {
        const float* op = a.o + (((long long)b * a.sq + s) * a.h + hh) * D;
        for (int c = lane; c < D; c += 32) acc += tile[r][c] * op[c];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        const long long row = ((long long)b * a.h + hh) * a.sqs + s;
        w.delta[row] = acc;
        w.lse2[row] = s < a.sq ? a.lse[((long long)b * a.h + hh) * a.sq + s] * kLog2eF : CUDART_INF_F;
      }
    }
  }
}

struct KArgs {
  int b, sq, sk, h, d, nsplit, sqs;
  float scale;
};

// The dK/dV (MODE kDkdv) or dQ (kDq) kernel.  Maps: ta1, ta2 the A side's
// operands (K, V or qs, dO; 64-row boxes), tb1, tb2 the streamed side's (qs,
// dO or K, V; BT-row boxes), tt1 (and tt2) the transposed operands of the
// gradient products (dOt, then qt; or kt; DN-row boxes); the piece arrays
// hold the lo piece of batch b at batch b + B.  out1 = dK (or dQ), out2 =
// dV; part1, part2 their partials when the query loop is split (nsplit > 1).
// grid (ceil(rows / 64), H, B * nsplit).
template <int MODE, int DN, int BT, bool RES>
__global__ void __launch_bounds__(128, 1)
bwd_tf32_kernel(const __grid_constant__ CUtensorMap ta1, const __grid_constant__ CUtensorMap ta2,
                const __grid_constant__ CUtensorMap tb1, const __grid_constant__ CUtensorMap tb2,
                const __grid_constant__ CUtensorMap tt1, const __grid_constant__ CUtensorMap tt2,
                const float* __restrict__ lse2, const float* __restrict__ delta, float* __restrict__ out1,
                float* __restrict__ out2, float* __restrict__ part1, float* __restrict__ part2, KArgs a) {
  using L = BwdTile<MODE, DN, BT, RES>;
  constexpr bool DKDV = L::DKDV;
  constexpr int NCH = L::NCH, KS = L::KS, NSC = L::NSC, IPT = L::IPT, STAGES = L::STAGES, SLOT = L::SLOT;
  constexpr int ABOX = L::ABOX, BBOX = L::BBOX, TBOX = L::TBOX, XB = L::XB;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sA = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = sA + L::A_BYTES;
  uint64_t* barA = reinterpret_cast<uint64_t*>(sA + L::BAR_OFF);
  uint64_t* full = barA + 1;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, tg = lane % 4;
  const int row0 = blockIdx.x * kRows, hh = blockIdx.y, H = gridDim.y;
  const int b = blockIdx.z / a.nsplit, sp = blockIdx.z % a.nsplit;
  const int nrows = DKDV ? a.sk : a.sq, ncols = DKDV ? a.sq : a.sk;
  const int nt = (ncols + BT - 1) / BT;
  const int t0 = (int)((long long)sp * nt / a.nsplit), t1 = (int)((long long)(sp + 1) * nt / a.nsplit);
  const int nitems = (t1 - t0) * IPT;
  const long long lrow = ((long long)b * H + hh) * a.sqs;

  // item `it` of the ring into its slot: a tile's score items, then its
  // product items (dOt, then qt; or kt)
  auto issue = [&](int it) {
    if (it >= nitems) return;
    const int s = it % STAGES, j = t0 + it / IPT, sub = it % IPT;
    unsigned char* dst = ring + s * SLOT;
    uint64_t* bar = full + s;
    if (sub < NSC) {
      const bool stats = DKDV && sub == NSC - 1;
      mbar_expect_tx(bar, L::S_ITEM + (stats ? L::STATS : 0));
      if constexpr (!RES) {
        for (int x = 0; x < 4; ++x)
          tma_load(dst + x * ABOX, x < 2 ? &ta1 : &ta2, bar, 32 * sub, row0, hh, b + (x & 1) * a.b, true);
        dst += 4 * ABOX;
      }
      for (int x = 0; x < 4; ++x)
        for (int c = 0; c < XB; ++c)
          tma_load(dst + (x * XB + c) * BBOX, x < 2 ? &tb1 : &tb2, bar, 32 * (RES ? c : sub), j * BT, hh,
                   b + (x & 1) * a.b, true);
      if (stats) {
        unsigned char* st = ring + s * SLOT + L::S_ITEM;
        bulk_load(st, lse2 + lrow + j * BT, BT * 4, bar);
        bulk_load(st + BT * 4, delta + lrow + j * BT, BT * 4, bar);
      }
    } else {
      const CUtensorMap* m = sub == NSC ? &tt1 : &tt2;
      mbar_expect_tx(bar, L::O_ITEM);
      for (int x = 0; x < 2; ++x)
        for (int y = 0; y < BT / 32; ++y)
          tma_load(dst + (x * (BT / 32) + y) * TBOX, m, bar, j * BT + 32 * y, 0, hh, b + x * a.b, true);
    }
  };

  if (tid == 0) {
    mbar_init(barA, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(full + s, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    if constexpr (RES) {
      mbar_expect_tx(barA, L::A_BYTES);
      for (int x = 0; x < 4; ++x)
        for (int c = 0; c < NCH; ++c)
          tma_load(sA + (x * NCH + c) * ABOX, x < 2 ? &ta1 : &ta2, barA, 32 * c, row0, hh, b + (x & 1) * a.b,
                   true);
    }
    for (int i = 0; i < STAGES; ++i) issue(i);
  }
  if constexpr (RES) mbar_wait(barA, 0);

  // this thread's rows of the A side (keys for dK/dV, queries for dQ)
  const int r0 = row0 + 16 * warp + g, r1 = r0 + 8;
  float l0 = 0.f, l1 = 0.f, d0 = 0.f, d1 = 0.f;  // dQ: lse2 and delta of rows r0, r1 (< sqs)
  if constexpr (!DKDV) {
    l0 = lse2[lrow + r0], l1 = lse2[lrow + r1];
    d0 = delta[lrow + r0], d1 = delta[lrow + r1];
  }
  float acc1[DN / 2], acc2[DKDV ? DN / 2 : 1];  // dK and dV, or dQ
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DKDV ? DN / 2 : 1); ++i) acc2[i] = 0.f;

  // one gradient product: acc += X B, X (the accumulator-layout P^T, dS^T
  // or dS) split into its tf32 register A fragments, B the item's [DN][BT]
  // transposed hi and lo tiles; then the item's slot is refilled
  int it = 0;
  auto product = [&](float (&acc)[DN / 2], const float (&x)[BT / 2]) {
    uint32_t xh[BT / 8][4], xl[BT / 8][4];
#pragma unroll
    for (int kk = 0; kk < BT / 8; ++kk) {
      const float v4[4] = {x[4 * kk], x[4 * kk + 2], x[4 * kk + 1], x[4 * kk + 3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float h = tf32_rn(v4[e]);
        xh[kk][e] = __float_as_uint(h);
        xl[kk][e] = __float_as_uint(tf32_rn(v4[e] - h));
      }
    }
    const int s = it % STAGES;
    mbar_wait(full + s, (it / STAGES) & 1);
    const uint32_t th = smem_addr(ring + s * SLOT), tl = th + (BT / 32) * TBOX;
    float fresh[L::FRESH ? DN / 2 : 1];
#pragma unroll
    for (int i = 0; i < (L::FRESH ? DN / 2 : 1); ++i) fresh[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 8; ++kk) {
      const uint32_t off = (kk / 4) * TBOX + (kk % 4) * 32;
      if constexpr (L::FRESH) {
        wgmma_tf32_rs<DN>(fresh, xl[kk], desc(th + off, 16), 1);
        wgmma_tf32_rs<DN>(fresh, xh[kk], desc(tl + off, 16), 1);
        wgmma_tf32_rs<DN>(fresh, xh[kk], desc(th + off, 16), 1);
      } else {
        wgmma_tf32_rs<DN>(acc, xl[kk], desc(th + off, 16), 1);
        wgmma_tf32_rs<DN>(acc, xh[kk], desc(tl + off, 16), 1);
        wgmma_tf32_rs<DN>(acc, xh[kk], desc(th + off, 16), 1);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(xh);
    fence_regs(xl);
    if constexpr (L::FRESH) {
      fence_regs(fresh);
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) acc[i] += fresh[i];
    } else {
      fence_regs(acc);
    }
    __syncthreads();
    if (tid == 0) issue(it + STAGES);
    ++it;
  };

  for (int j = t0; j < t1; ++j) {
    // S (S^T) = A1 B1^T and dP (dP^T) = A2 B2^T over D, lo hi + hi lo + hi hi
    float sacc[BT / 2], dpacc[BT / 2];
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) sacc[i] = dpacc[i] = 0.f;
    const unsigned char* stats = nullptr;
#pragma unroll 1
    for (int c = 0; c < NSC; ++c, ++it) {
      const int s = it % STAGES;
      mbar_wait(full + s, (it / STAGES) & 1);
      const uint32_t slot = smem_addr(ring + s * SLOT);
      const uint32_t a1 = RES ? smem_addr(sA) : slot, ap = RES ? NCH * ABOX : ABOX;  // ap: piece to piece
      const uint32_t b1 = slot + (RES ? 0 : 4 * ABOX), bp = XB * BBOX;
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < (RES ? KS : 4); ++i) {
        const int k = (RES ? 0 : 4 * c) + i;
        const uint32_t ao = (RES ? (k / 4) * ABOX : 0) + (k % 4) * 32;
        const uint32_t bo = (RES ? (k / 4) * BBOX : 0) + (k % 4) * 32;
        wgmma_tf32_ss<BT>(sacc, desc(a1 + ap + ao, 16), desc(b1 + bo, 16), 1);
        wgmma_tf32_ss<BT>(sacc, desc(a1 + ao, 16), desc(b1 + bp + bo, 16), 1);
        wgmma_tf32_ss<BT>(sacc, desc(a1 + ao, 16), desc(b1 + bo, 16), 1);
        wgmma_tf32_ss<BT>(dpacc, desc(a1 + 3 * ap + ao, 16), desc(b1 + 2 * bp + bo, 16), 1);
        wgmma_tf32_ss<BT>(dpacc, desc(a1 + 2 * ap + ao, 16), desc(b1 + 3 * bp + bo, 16), 1);
        wgmma_tf32_ss<BT>(dpacc, desc(a1 + 2 * ap + ao, 16), desc(b1 + 2 * bp + bo, 16), 1);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sacc);
      fence_regs(dpacc);
      if (c + 1 < NSC) {
        __syncthreads();
        if (tid == 0) issue(it + STAGES);
      } else {
        stats = ring + s * SLOT + L::S_ITEM;
      }
    }
    // P and dS = P (dP - delta) in the accumulators' registers
    if constexpr (DKDV) {  // rows are keys (those past Sk give 0), columns queries
      const float* sL = reinterpret_cast<const float*>(stats);
      const float* sD = sL + BT;
#pragma unroll
      for (int n = 0; n < BT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * n + 2 * tg + (e & 1);
          const float p = (e < 2 ? r0 : r1) < a.sk ? exp2f(sacc[4 * n + e] - sL[col]) : 0.f;
          sacc[4 * n + e] = p;
          dpacc[4 * n + e] = p * (dpacc[4 * n + e] - sD[col]);
        }
    } else {  // rows are queries, columns keys (those past Sk give 0)
#pragma unroll
      for (int n = 0; n < BT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j * BT + 8 * n + 2 * tg + (e & 1);
          const float p = key < a.sk ? exp2f(sacc[4 * n + e] - (e < 2 ? l0 : l1)) : 0.f;
          dpacc[4 * n + e] = p * (dpacc[4 * n + e] - (e < 2 ? d0 : d1));
        }
    }
    __syncthreads();  // the last score item's slot (and its stats) is free
    if (tid == 0) issue(it - 1 + STAGES);
    if constexpr (DKDV) {
      product(acc2, sacc);   // dV += P^T dO
      product(acc1, dpacc);  // dK += dS^T q
    } else {
      product(acc1, dpacc);  // dQ += dS k
    }
  }

  // dK * scale and dV (or their partials), or dQ * scale; D % 4 == 0: c < D
  // implies c + 1 < D
  const bool whole = a.nsplit == 1;
  const long long rs = (long long)H * a.d;
#pragma unroll
  for (int n = 0; n < DN / 8; ++n) {
    const int c = 8 * n + 2 * tg;
    if (c >= a.d) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (r >= nrows) continue;
      const long long at = ((long long)b * nrows + r) * rs + (long long)hh * a.d + c;
      const int i = 4 * n + 2 * half;
      if (whole) {
        *reinterpret_cast<float2*>(out1 + at) = make_float2(acc1[i] * a.scale, acc1[i + 1] * a.scale);
        if constexpr (DKDV) *reinterpret_cast<float2*>(out2 + at) = make_float2(acc2[i], acc2[i + 1]);
      } else if constexpr (DKDV) {
        const long long pt = (long long)sp * a.b * nrows * rs + at;
        *reinterpret_cast<float2*>(part1 + pt) = make_float2(acc1[i], acc1[i + 1]);
        *reinterpret_cast<float2*>(part2 + pt) = make_float2(acc2[i], acc2[i + 1]);
      }
    }
  }
}

// dK and dV from the nsplit fp32 partials, added in split order
__global__ void bwd_tf32_reduce(const float* __restrict__ dkp, const float* __restrict__ dvp,
                                float* __restrict__ dk, float* __restrict__ dv, long long n, int nsplit,
                                float scale) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float sk = 0.f, sv = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      sk += dkp[s * n + i];
      sv += dvp[s * n + i];
    }
    dk[i] = sk * scale;
    dv[i] = sv;
  }
}

// ------------------------------------------------------------------ plan
// The fp32 plan: the TMA body (tma) or SIMT; the padded head dim, the
// streamed tiles (queries a dK/dV tile, keys a dQ tile), whether the A side
// is resident, the dK/dV splits, ring stages and shared memory of each
// kernel, the stats' padded rows, and the workspace's layout (byte offsets;
// SIMT's workspace is its delta alone).
struct F32BwdPlan {
  int tma, dn, bt_kv, bt_q, res, nsplit, stages_kv, stages_q, smem_kv, smem_q, sqs;
  long long off_delta, off_qs, off_do, off_k, off_v, off_qt, off_dot, off_kt, off_dkp, off_dvp, bytes;
};

// every instantiation: (DN, BT, RES) for both kernels
#define MADM_TF32_BWD_TILES(X) X(40, 64, true) X(80, 32, true) X(160, 32, false)

inline long long up256(long long x) { return (x + 255) / 256 * 256; }

inline F32BwdPlan f32_bwd_plan(int b, int sq, int sk, int h, int d, bool addressable) {
  F32BwdPlan p{};
  p.tma = addressable && d >= 1 && d <= kMaxD && d % 4 == 0;
  if (!p.tma) {
    p.bytes = 4LL * b * h * sq;
    return p;
  }
  p.dn = d <= 40 ? 40 : d <= 80 ? 80 : 160;
  p.bt_kv = p.bt_q = p.dn == 40 ? 64 : 32;
  p.res = p.dn <= 80;
  const int blocks = (sk + kRows - 1) / kRows * h * b, nqt = (sq + p.bt_kv - 1) / p.bt_kv;
  p.nsplit = blocks >= kCard ? 1 : imax(1, imin((kCard + blocks - 1) / blocks, nqt / 2));
#define X(DN, BT, RES)                                     \
  if (p.dn == DN) {                                        \
    p.stages_kv = BwdTile<kDkdv, DN, BT, RES>::STAGES;     \
    p.smem_kv = BwdTile<kDkdv, DN, BT, RES>::SMEM;         \
    p.stages_q = BwdTile<kDq, DN, BT, RES>::STAGES;        \
    p.smem_q = BwdTile<kDq, DN, BT, RES>::SMEM;            \
  }
  MADM_TF32_BWD_TILES(X)
#undef X
  p.sqs = (sq + 63) / 64 * 64;
  const long long nq = (long long)b * sq * h * d, nk = (long long)b * sk * h * d;
  const long long tq = (long long)b * h * d * ((sq + 7) / 8 * 8), tk = (long long)b * h * d * ((sk + 7) / 8 * 8);
  p.off_delta = up256(4LL * b * h * p.sqs);
  p.off_qs = up256(p.off_delta + 4LL * b * h * p.sqs);
  p.off_do = up256(p.off_qs + 8 * nq);
  p.off_k = up256(p.off_do + 8 * nq);
  p.off_v = up256(p.off_k + 8 * nk);
  p.off_qt = up256(p.off_v + 8 * nk);
  p.off_dot = up256(p.off_qt + 8 * tq);
  p.off_kt = up256(p.off_dot + 8 * tq);
  p.off_dkp = up256(p.off_kt + 8 * tk);
  const long long part = p.nsplit > 1 ? 4 * p.nsplit * nk : 0;
  p.off_dvp = p.off_dkp + part;
  p.bytes = p.off_dvp + part;
  return p;
}

struct BwdIn {
  const float *q, *k, *v, *o, *dout, *lse;
  float *dq, *dk, *dv;
  int b, sq, sk, h, d;
  float qscale, scale;
  cudaStream_t st;
};

template <int DN, int BT, bool RES>
cudaError_t launch_tf32(const F32BwdPlan& p, const BwdIn& a, unsigned char* base) {
  using KV = BwdTile<kDkdv, DN, BT, RES>;
  using Q = BwdTile<kDq, DN, BT, RES>;
  auto at = [&](long long off) { return reinterpret_cast<float*>(base + off); };
  const Ws w{at(0), at(p.off_delta), at(p.off_qs), at(p.off_do), at(p.off_k), at(p.off_v),
             at(p.off_qt), at(p.off_dot), at(p.off_kt), at(p.off_dkp), at(p.off_dvp)};
  const PrepArgs pa{a.q, a.k, a.v, a.o, a.dout, a.lse, a.b, a.sq, a.sk, a.h, a.d, p.sqs, a.qscale};
  bwd_tf32_prep<<<dim3((imax(p.sqs, a.sk) + kPrepRows - 1) / kPrepRows, a.h, 4 * a.b), 256, 0, a.st>>>(pa, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int B2 = 2 * a.b, H = a.h, D = a.d;
  const long long sq8 = (a.sq + 7) / 8 * 8, sk8 = (a.sk + 7) / 8 * 8;
  auto flat = [&](CUtensorMap* m, const float* t, int s, int rows) {  // [2B, S, H, D]
    return cached_f32_map(m, t, B2, s, H, D, (long long)s * H * D, (long long)H * D, D, rows);
  };
  auto trans = [&](CUtensorMap* m, const float* t, long long s8) {  // [2B, H, D, S8] as (S8, D, H, 2B)
    return cached_f32_map(m, t, B2, D, H, (int)s8, (long long)H * D * s8, s8, (long long)D * s8, DN);
  };
  CUtensorMap k64, v64, qsb, dob, dott, qtt, qs64, do64, kb, vb, ktt;
  if (!flat(&k64, w.k, a.sk, kRows) || !flat(&v64, w.v, a.sk, kRows) || !flat(&qsb, w.qs, a.sq, BT) ||
      !flat(&dob, w.dout, a.sq, BT) || !trans(&dott, w.dot, sq8) || !trans(&qtt, w.qt, sq8) ||
      !flat(&qs64, w.qs, a.sq, kRows) || !flat(&do64, w.dout, a.sq, kRows) || !flat(&kb, w.k, a.sk, BT) ||
      !flat(&vb, w.v, a.sk, BT) || !trans(&ktt, w.kt, sk8))
    return cudaErrorInvalidValue;

  KArgs ka{a.b, a.sq, a.sk, a.h, a.d, p.nsplit, p.sqs, a.scale};
  constexpr auto kkv = bwd_tf32_kernel<kDkdv, DN, BT, RES>;
  err = set_smem_once<kkv>(KV::SMEM);
  if (err != cudaSuccess) return err;
  kkv<<<dim3((a.sk + kRows - 1) / kRows, H, a.b * p.nsplit), 128, KV::SMEM, a.st>>>(
      k64, v64, qsb, dob, dott, qtt, w.lse2, w.delta, a.dk, a.dv, w.dkp, w.dvp, ka);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.nsplit > 1) {
    const long long n = (long long)a.b * a.sk * H * D;
    bwd_tf32_reduce<<<(unsigned)imin((int)((n + 255) / 256), 4 * kCard), 256, 0, a.st>>>(
        w.dkp, w.dvp, a.dk, a.dv, n, p.nsplit, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  ka.nsplit = 1;
  constexpr auto kq = bwd_tf32_kernel<kDq, DN, BT, RES>;
  err = set_smem_once<kq>(Q::SMEM);
  if (err != cudaSuccess) return err;
  kq<<<dim3((a.sq + kRows - 1) / kRows, H, a.b), 128, Q::SMEM, a.st>>>(
      qs64, do64, kb, vb, ktt, ktt, w.lse2, w.delta, a.dq, nullptr, nullptr, nullptr, ka);
  return cudaGetLastError();
}

// the plan's body, launched; cudaErrorInvalidValue for a plan without one
// or a workspace of fewer than the plan's bytes
inline cudaError_t dispatch_tf32(const F32BwdPlan& p, const BwdIn& a, void* ws, long long ws_bytes) {
  if (ws == nullptr || ws_bytes < p.bytes) return cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(ws);
#define X(DN, BT, RES) \
  if (p.dn == DN) return launch_tf32<DN, BT, RES>(p, a, base);
  MADM_TF32_BWD_TILES(X)
#undef X
  return cudaErrorInvalidValue;
}

}  // namespace bwd_tf32
}  // namespace
