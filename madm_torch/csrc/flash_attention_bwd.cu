// K3: flash-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel madm_tpu/ops/flash_attention.py::_attn_bwd_kernel
// (pallas_call in _flash_attention_bwd_impl).  For o = softmax(q k^T * scale) v
// and the incoming gradient dO it computes
//   P  = exp(q k^T * scale - lse)            (recomputed; lse from K1)
//   dV = P^T dO
//   dP = dO V^T,  delta = rowsum(dO * O) = rowsum(dP * P)
//   dS = P * (dP - delta)
//   dQ = dS K * scale,  dK = dS^T Q * scale
// on contiguous [B, S, H, D] tensors; lse is fp32 [B, H, Sq].  dq, dk and
// dv come out in the input dtype from fp32 accumulators.
//
// Bound on the H100: 10*Sq*Sk*D operations per head (the TPU kernel's own
// count) against ~(4*Sq + 4*Sk)*D elements moved: far above the ~295
// ops/byte ridge, so it is bound by operations.  The TPU kernel walked the
// q blocks of a head in order on one core and accumulated dk/dv in a
// revisited output block; Hopper blocks run in parallel in no order, so this
// port follows FlashAttention-2's split into a dK/dV pass over key tiles and
// a dQ pass over query tiles, without atomics and deterministic: the scores
// are recomputed in both (7 products where an atomic dq would need 5, the
// price of a dq whose rounding does not change from run to run).  P and dS
// never reach device memory.  D > 160 is refused: the only larger head, the
// VAE's D=512 mid-block attention, never trains.
//
// Two bodies, one per dtype:
// - bf16 (the train step): TMA + wgmma, the scheme of K1
//   (flash_attention.cu; the layouts are described in hopper.cuh):
//   1. bwd_prep_kernel, one warp a row: delta = rowsum(dO * O) in fp32,
//      lse2 = lse * log2(e), and bf16(q * scale * log2(e)), K1's rounding
//      of q, into a workspace, so that P is the forward's P;
//   2. dkdv_tma_kernel: a block owns 128 keys (two consumer warpgroups of
//      64; at D=160 one, for registers), K and V resident; a producer warp streams the Qs, Q, dO
//      tiles and lse2/delta of each q tile by TMA through a 2-stage mbarrier
//      ring.  S^T = K Qs^T and dP^T = V dO^T by wgmma from shared memory;
//      P^T and dS^T = P^T (dP^T - delta) are formed in the accumulator
//      registers, rounded to bf16 (as on the TPU) and are the register A
//      operands of dV += P^T dO and dK += dS^T Q, with dO and Q read
//      MN-major where TMA put them: no transposes.  Shapes with few key
//      tiles (the 77-key cross-attentions: one tile a head) split their q
//      tiles over several blocks until 132 run (at least two q tiles a
//      split, the reduction's traffic being the price); each split writes fp32
//      partial dK/dV to the workspace and dkdv_reduce_kernel adds them in
//      split order;
//   3. dq_tma_kernel: a block owns 64 or 128 queries (Qs, dO resident) and
//      streams K/V tiles (one 80-key tile for the cross-attentions):
//      S = Qs K^T, dP = dO V^T, dS in registers as the A operand of
//      dQ += dS K, K read MN-major.
//   Keys past Sk get P = 0 (dQ) or are not stored (dK/dV); query rows past
//   Sq have lse2 = +inf, so P = 0.  D is padded to 48, 80 or 160 and boxed
//   in 64-column chunks as in K1; the resident operand of each reduction
//   over D has its columns past D zeroed in shared memory.  It needs
//   D % 8 == 0 and 16-byte aligned tensors, as every UNet attention has;
//   other bf16 input is refused, not sent to a slower body.
// - float32: 3xTF32 wgmma on TMA (flash_bwd_tf32.cuh, which describes it)
//   for every call whose tensors it can address (D % 4 == 0, 16-byte aligned
//   bases); the rest take the SIMT body: fp32 FMA with the tiles in shared
//   memory, one instantiation padded to D=160, delta from delta_kernel.
//
// The same bf16 kernels are K5's body (madm_packed_attention_bwd_tma below):
// the backward of K4 (flash_attention_packed.cu) on the packed self-attention
// shapes, replacing madm_tpu/ops/flash_attention.py::_packed_bwd_kernel.  K4
// writes the row log-sum-exp in K1's convention, so P, dS, dQ, dK and dV are
// exactly this function on K4's statistics.  The one rounding change
// against the TPU kernel, which recomputes the statistics and takes delta =
// rowsum(dP * P) with fp32 P: delta here is rowsum(dO * O) with K4's bf16 O,
// which differs by the bf16 rounding of P and of O (within K5's tolerance,
// 2^-6 of each gradient's largest entry: the CPU tests and chip_smoke.py
// hold it).  That saves the TPU kernel's statistics pass, 4 of its 10
// operations per (q, k, d).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "flash_bwd_tf32.cuh"
#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSimtThreads = 256;

struct Shape {
  int b, sq, sk, h, d;
};

// --------------------------------------------------------------- delta
// delta[b, h, i] = sum_c dO[b, i, h, c] * O[b, i, h, c]; one warp per row
// (the fp32 body's; the bf16 body's bwd_prep_kernel computes it too)
__global__ void delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                             float* __restrict__ delta, Shape sh) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)sh.b * sh.sq * sh.h) return;  // whole warps leave together
  const float* op = o + row * sh.d;
  const float* gp = dout + row * sh.d;
  float acc = 0.f;
  for (int c = lane; c < sh.d; c += 32) acc += op[c] * gp[c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {  // row enumerates (b, i, h) in memory order
    const int hh = (int)(row % sh.h);
    const long long bi = row / sh.h;
    const int i = (int)(bi % sh.sq), b = (int)(bi / sh.sq);
    delta[((long long)b * sh.h + hh) * sh.sq + i] = acc;
  }
}

// ------------------------------------------------------------ SIMT bodies
template <int DPAD, int BR, int BC>
constexpr size_t simt_smem_bytes() {
  // four [rows][DPAD+1] fp32 tiles, two [BR][BC+1] score tiles, two row vectors
  return sizeof(float) * (2 * BR * (DPAD + 1) + 2 * BC * (DPAD + 1) + 2 * BR * (BC + 1) + 2 * BC);
}

// grid (ceil(Sk / BKV), H, B): dK/dV of BKV keys, looping over q tiles of BQ
template <int DPAD, int BKV, int BQ>
__global__ void __launch_bounds__(kSimtThreads)
dkdv_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                 Shape sh, float qscale, float scale) {
  constexpr int LD = DPAD + 1, LP = BQ + 1;
  constexpr int NACC = BKV * DPAD / kSimtThreads;
  static_assert((BKV * DPAD) % kSimtThreads == 0, "tile shape");
  extern __shared__ float smem[];
  float* Ks = smem;              // [BKV][LD]
  float* Vs = Ks + BKV * LD;     // [BKV][LD]
  float* Qs = Vs + BKV * LD;     // [BQ][LD]
  float* Gs = Qs + BQ * LD;      // [BQ][LD]  dO
  float* Ps = Gs + BQ * LD;      // [BKV][LP]
  float* Ss = Ps + BKV * LP;     // [BKV][LP]  dS
  float* Ls = Ss + BKV * LP;     // [BQ] lse, log2 units
  float* Ds = Ls + BQ;           // [BQ] delta

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BKV, hh = blockIdx.y, b = blockIdx.z;
  const int H = sh.h, D = sh.d;
  const long long srow = (long long)H * D;
  const float* qb = q + ((long long)b * sh.sq * H + hh) * D;
  const float* gb = dout + ((long long)b * sh.sq * H + hh) * D;
  const float* kb = k + ((long long)b * sh.sk * H + hh) * D;
  const float* vb = v + ((long long)b * sh.sk * H + hh) * D;
  const float* lb = lse + ((long long)b * H + hh) * sh.sq;
  const float* db = delta + ((long long)b * H + hh) * sh.sq;

  for (int e = tid; e < BKV * DPAD; e += kSimtThreads) {
    const int r = e / DPAD, c = e - r * DPAD;
    const bool ok = k0 + r < sh.sk && c < D;
    Ks[r * LD + c] = ok ? kb[(k0 + r) * srow + c] : 0.f;
    Vs[r * LD + c] = ok ? vb[(k0 + r) * srow + c] : 0.f;
  }
  float dka[NACC], dva[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) dka[i] = dva[i] = 0.f;

  for (int q0 = 0; q0 < sh.sq; q0 += BQ) {
    __syncthreads();  // K/V written (first tile); Q/dO/P/dS free (later tiles)
    for (int e = tid; e < BQ * DPAD; e += kSimtThreads) {
      const int r = e / DPAD, c = e - r * DPAD;
      const bool ok = q0 + r < sh.sq && c < D;
      Qs[r * LD + c] = ok ? qb[(q0 + r) * srow + c] : 0.f;
      Gs[r * LD + c] = ok ? gb[(q0 + r) * srow + c] : 0.f;
    }
    for (int r = tid; r < BQ; r += kSimtThreads) {
      const bool ok = q0 + r < sh.sq;
      Ls[r] = ok ? lb[q0 + r] * kLog2e : 0.f;
      Ds[r] = ok ? db[q0 + r] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < BKV * BQ; e += kSimtThreads) {
      const int r = e / BQ, c = e - r * BQ;  // key r, query c
      float s = 0.f, dp = 0.f;
      for (int x = 0; x < DPAD; ++x) {
        s = fmaf(Ks[r * LD + x], Qs[c * LD + x], s);
        dp = fmaf(Vs[r * LD + x], Gs[c * LD + x], dp);
      }
      const float p = (q0 + c < sh.sq) ? exp2f(s * qscale - Ls[c]) : 0.f;
      Ps[r * LP + c] = p;
      Ss[r * LP + c] = p * (dp - Ds[c]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int e = tid + i * kSimtThreads, r = e / DPAD, c = e - r * DPAD;
      float av = 0.f, ak = 0.f;
      for (int x = 0; x < BQ; ++x) {
        av = fmaf(Ps[r * LP + x], Gs[x * LD + c], av);
        ak = fmaf(Ss[r * LP + x], Qs[x * LD + c], ak);
      }
      dva[i] += av;
      dka[i] += ak;
    }
  }
  float* dkb = dk + ((long long)b * sh.sk * H + hh) * D;
  float* dvb = dv + ((long long)b * sh.sk * H + hh) * D;
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int e = tid + i * kSimtThreads, r = e / DPAD, c = e - r * DPAD;
    if (k0 + r < sh.sk && c < D) {
      dkb[(k0 + r) * srow + c] = dka[i] * scale;
      dvb[(k0 + r) * srow + c] = dva[i];
    }
  }
}

// grid (ceil(Sq / BQ), H, B): dQ of BQ queries, looping over K/V tiles of BK
template <int DPAD, int BQ, int BK>
__global__ void __launch_bounds__(kSimtThreads)
dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dq, Shape sh, float qscale,
               float scale) {
  constexpr int LD = DPAD + 1, LS = BK + 1;
  constexpr int NACC = BQ * DPAD / kSimtThreads;
  static_assert((BQ * DPAD) % kSimtThreads == 0, "tile shape");
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][LD]
  float* Gs = Qs + BQ * LD;     // [BQ][LD]  dO
  float* Ks = Gs + BQ * LD;     // [BK][LD]
  float* Vs = Ks + BK * LD;     // [BK][LD]
  float* Ss = Vs + BK * LD;     // [BQ][LS]  dS
  float* Ls = Ss + BQ * LS;     // [BQ]
  float* Ds = Ls + BQ;          // [BQ]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ, hh = blockIdx.y, b = blockIdx.z;
  const int H = sh.h, D = sh.d;
  const long long srow = (long long)H * D;
  const float* qb = q + ((long long)b * sh.sq * H + hh) * D;
  const float* gb = dout + ((long long)b * sh.sq * H + hh) * D;
  const float* kb = k + ((long long)b * sh.sk * H + hh) * D;
  const float* vb = v + ((long long)b * sh.sk * H + hh) * D;
  const float* lb = lse + ((long long)b * H + hh) * sh.sq;
  const float* db = delta + ((long long)b * H + hh) * sh.sq;

  for (int e = tid; e < BQ * DPAD; e += kSimtThreads) {
    const int r = e / DPAD, c = e - r * DPAD;
    const bool ok = q0 + r < sh.sq && c < D;
    Qs[r * LD + c] = ok ? qb[(q0 + r) * srow + c] : 0.f;
    Gs[r * LD + c] = ok ? gb[(q0 + r) * srow + c] : 0.f;
  }
  for (int r = tid; r < BQ; r += kSimtThreads) {
    const bool ok = q0 + r < sh.sq;
    Ls[r] = ok ? lb[q0 + r] * kLog2e : 0.f;
    Ds[r] = ok ? db[q0 + r] : 0.f;
  }
  float dqa[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) dqa[i] = 0.f;

  for (int k0 = 0; k0 < sh.sk; k0 += BK) {
    __syncthreads();  // Q/dO written (first tile); K/V/dS free (later tiles)
    for (int e = tid; e < BK * DPAD; e += kSimtThreads) {
      const int r = e / DPAD, c = e - r * DPAD;
      const bool ok = k0 + r < sh.sk && c < D;
      Ks[r * LD + c] = ok ? kb[(k0 + r) * srow + c] : 0.f;
      Vs[r * LD + c] = ok ? vb[(k0 + r) * srow + c] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < BQ * BK; e += kSimtThreads) {
      const int r = e / BK, c = e - r * BK;  // query r, key c
      float s = 0.f, dp = 0.f;
      for (int x = 0; x < DPAD; ++x) {
        s = fmaf(Qs[r * LD + x], Ks[c * LD + x], s);
        dp = fmaf(Gs[r * LD + x], Vs[c * LD + x], dp);
      }
      const float p = (k0 + c < sh.sk) ? exp2f(s * qscale - Ls[r]) : 0.f;
      Ss[r * LS + c] = p * (dp - Ds[r]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int e = tid + i * kSimtThreads, r = e / DPAD, c = e - r * DPAD;
      float a = 0.f;
      for (int x = 0; x < BK; ++x) a = fmaf(Ss[r * LS + x], Ks[x * LD + c], a);
      dqa[i] += a;
    }
  }
  float* dqb = dq + ((long long)b * sh.sq * H + hh) * D;
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int e = tid + i * kSimtThreads, r = e / DPAD, c = e - r * DPAD;
    if (q0 + r < sh.sq && c < D) dqb[(q0 + r) * srow + c] = dqa[i] * scale;
  }
}

// ------------------------------------------------ bf16 bodies: TMA + wgmma
using namespace hopper;

constexpr int kFill = 132;  // the H100's SMs: the dK/dV grid is split until it has this many blocks

// The workspace the wrapper hands in (`delta` of the C entry point), in
// bytes: lse2 = lse * log2(e) and delta as fp32 [B*H, Sqp] (Sqp = Sq rounded
// up to 128; the padding rows hold +inf and 0, so that their P is 0), the
// scaled q = bf16(q * scale * log2(e)) as [B, Sq, H, D], and with NSPLIT > 1
// the fp32 partial dK and dV, [NSPLIT, B, Sk, H, D] each.
// attention_plan() in madm_torch/ops/flash_attention.py lays it out alike.
struct BwdPlan {
  int dn, bq_kv, nwg_kv, nsplit, bk_q, nwg_q, sqp;
  long long off_delta, off_qs, off_dkp, off_dvp, bytes;
};

inline BwdPlan bwd_plan(int b, int sq, int sk, int h, int d) {
  BwdPlan p{};
  p.dn = d <= 48 ? 48 : d <= 80 ? 80 : 160;
  // tiles that keep each consumer within ptxas's 168 registers (hopper.cuh)
  p.bq_kv = p.dn == 48 ? 64 : 32;
  p.nwg_kv = p.dn == 160 ? 1 : 2;
  const int blocks = (sk + 64 * p.nwg_kv - 1) / (64 * p.nwg_kv) * h * b;
  const int nqt = (sq + p.bq_kv - 1) / p.bq_kv;
  p.nsplit = blocks >= kFill ? 1 : std::max(1, std::min((kFill + blocks - 1) / blocks, nqt / 2));
  p.bk_q = sk <= 80 ? 80 : 64;
  p.nwg_q = (long long)(sq + 127) / 128 * h * b >= kFill ? 2 : 1;  // as K1 chooses
  p.sqp = (sq + 127) / 128 * 128;
  const long long rows = (long long)b * h * p.sqp, part = (long long)b * sk * h * d * 4;
  p.off_delta = 4 * rows;
  p.off_qs = 8 * rows;
  p.off_dkp = (p.off_qs + 2LL * b * sq * h * d + 255) / 256 * 256;
  p.off_dvp = p.off_dkp + (p.nsplit > 1 ? p.nsplit * part : 0);
  p.bytes = p.off_dvp + (p.nsplit > 1 ? p.nsplit * part : 0);
  return p;
}

struct BwdArgs {
  int sq, sk, d, sqp, nsplit;
  float scale;
};

// one warp a row (b, h, i), i < Sqp: delta = rowsum(dO * O), lse2, and the
// row of q scaled and rounded as K1 did
__global__ void bwd_prep_kernel(const bf16* __restrict__ q, const bf16* __restrict__ o,
                                const bf16* __restrict__ dout, const float* __restrict__ lse,
                                bf16* __restrict__ qs, float* __restrict__ lse2,
                                float* __restrict__ delta, Shape sh, int sqp, float qscale) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)sh.b * sh.h * sqp) return;  // whole warps leave together
  const long long bh = row / sqp;
  const int i = (int)(row - bh * sqp), hh = (int)(bh % sh.h), b = (int)(bh / sh.h);
  if (i >= sh.sq) {
    if (lane == 0) {
      lse2[row] = CUDART_INF_F;
      delta[row] = 0.f;
    }
    return;
  }
  const long long base = (((long long)b * sh.sq + i) * sh.h + hh) * sh.d;
  float acc = 0.f;
  for (int c = lane; c < sh.d; c += 32) {
    acc += __bfloat162float(o[base + c]) * __bfloat162float(dout[base + c]);
    qs[base + c] = __float2bfloat16(__bfloat162float(q[base + c]) * qscale);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    delta[row] = acc;
    lse2[row] = lse[bh * sh.sq + i] * kLog2e;
  }
}

// zero columns [d, NCH*64) of an [rows][64]-chunked swizzled tile (what a
// flat map brought of the next head), by `nthr` threads from `t`
template <int NCH>
__device__ __forceinline__ void zero_tail(unsigned char* tile, int rows, int d, int t, int nthr) {
  for (int e = t; e < NCH * rows * 8; e += nthr) {
    const int c = e / (rows * 8), r = (e / 8) % rows;
    if (c * 64 + (((e % 8) ^ (r & 7)) * 8) >= d) *reinterpret_cast<uint4*>(tile + e * 16) = make_uint4(0, 0, 0, 0);
  }
}

// dK/dV: a block owns 64 NWG keys (a consumer warpgroup each 64) and the q
// tiles of its split; grid (ceil(Sk / (64 NWG)), H, B * NSPLIT)
template <int DN, int BQ, int NWG>
struct DkdvTile {
  static constexpr int NCH = (DN + 63) / 64, BKV = 64 * NWG, STAGES = 2;
  static constexpr int KV_BYTES = NCH * BKV * 128;
  static constexpr int QT_BYTES = NCH * BQ * 128;  // one of the Qs, Q and dO tiles
  static constexpr int STAGE_BYTES = (3 * QT_BYTES + 2 * BQ * 4 + 1023) / 1024 * 1024;
  static constexpr int BAR_OFF = 2 * KV_BYTES + STAGES * STAGE_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
  static constexpr int THREADS = 128 * NWG + 32;  // consumer warpgroups, one producer warp
};

template <int DN, int BQ, int NWG>
__global__ void __launch_bounds__(128 * NWG + 32, 1)
dkdv_tma_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tqs, const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tg, const float* __restrict__ lse2,
                const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
                float* __restrict__ dkp, float* __restrict__ dvp, BwdArgs a) {
  using L = DkdvTile<DN, BQ, NWG>;
  constexpr int NCH = L::NCH, BKV = L::BKV, STAGES = L::STAGES, KS = DN / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sV = sK + L::KV_BYTES;
  unsigned char* sStage = sV + L::KV_BYTES;  // [STAGES] x {Qs, Q, dO, lse2, delta}
  uint64_t* barKV = reinterpret_cast<uint64_t*>(sK + L::BAR_OFF);
  uint64_t* full = barKV + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, wg = tid / 128;
  const int H = gridDim.y, B = gridDim.z / a.nsplit;
  const int k0 = blockIdx.x * BKV, hh = blockIdx.y, b = blockIdx.z / a.nsplit, sp = blockIdx.z % a.nsplit;
  const int nqt = (a.sq + BQ - 1) / BQ;
  const int t0 = (int)((long long)sp * nqt / a.nsplit), t1 = (int)((long long)(sp + 1) * nqt / a.nsplit);
  if (tid == 0) {
    mbar_init(barKV, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == NWG) {  // the producer warp
    if (tid == NWG * 128) {
      const int col = hh * a.d;
      mbar_expect_tx(barKV, 2 * L::KV_BYTES);
      for (int c = 0; c < NCH; ++c) {
        tma_load(sK + c * BKV * 128, &tk, barKV, col + 64 * c, k0, 0, b, false);
        tma_load(sV + c * BKV * 128, &tv, barKV, col + 64 * c, k0, 0, b, false);
      }
      const long long lrow = ((long long)b * H + hh) * a.sqp;
      for (int j = t0; j < t1; ++j) {
        const int it = j - t0, s = it % STAGES, ph = (it / STAGES) & 1;
        unsigned char* st = sStage + s * L::STAGE_BYTES;
        mbar_wait(empty + s, ph ^ 1);
        mbar_expect_tx(full + s, 3 * L::QT_BYTES + 2 * BQ * 4);
        for (int c = 0; c < NCH; ++c) {
          tma_load(st + c * BQ * 128, &tqs, full + s, col + 64 * c, j * BQ, 0, b, false);
          tma_load(st + L::QT_BYTES + c * BQ * 128, &tq, full + s, col + 64 * c, j * BQ, 0, b, false);
          tma_load(st + 2 * L::QT_BYTES + c * BQ * 128, &tg, full + s, col + 64 * c, j * BQ, 0, b, false);
        }
        bulk_load(st + 3 * L::QT_BYTES, lse2 + lrow + j * BQ, BQ * 4, full + s);
        bulk_load(st + 3 * L::QT_BYTES + BQ * 4, delta + lrow + j * BQ, BQ * 4, full + s);
      }
    }
  } else {  // consumers: warpgroup wg owns keys k0 + 64 wg ...
    const int t = tid % 128, warp = t / 32, lane = t % 32, g = lane / 4, tg4 = lane % 4;
    mbar_wait(barKV, 0);
    zero_tail<NCH>(sK, BKV, a.d, tid, NWG * 128);  // K and V columns past D: the reductions over D
    zero_tail<NCH>(sV, BKV, a.d, tid, NWG * 128);
    fence_async_smem();
    named_sync(1, NWG * 128);

    float dka[DN / 2], dva[DN / 2];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) dka[i] = dva[i] = 0.f;
    const uint32_t ka = smem_addr(sK) + wg * 64 * 128, va = smem_addr(sV) + wg * 64 * 128;
    for (int j = t0; j < t1; ++j) {
      const int it = j - t0, s = it % STAGES, ph = (it / STAGES) & 1;
      unsigned char* st = sStage + s * L::STAGE_BYTES;
      const uint32_t qsa = smem_addr(st), qa = qsa + L::QT_BYTES, ga = qsa + 2 * L::QT_BYTES;
      const float* sL = reinterpret_cast<const float*>(st + 3 * L::QT_BYTES);
      const float* sD = sL + BQ;
      mbar_wait(full + s, ph);
      // S^T = K Qs^T and dP^T = V dO^T: this warpgroup's 64 keys x BQ queries
      float sacc[BQ / 2], dpacc[BQ / 2];
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) sacc[i] = dpacc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < KS; ++k)
        wgmma_ss<BQ>(sacc, desc(ka + (k / 4) * BKV * 128 + (k % 4) * 32, 16),
                     desc(qsa + (k / 4) * BQ * 128 + (k % 4) * 32, 16), k > 0);
#pragma unroll
      for (int k = 0; k < KS; ++k)
        wgmma_ss<BQ>(dpacc, desc(va + (k / 4) * BKV * 128 + (k % 4) * 32, 16),
                     desc(ga + (k / 4) * BQ * 128 + (k % 4) * 32, 16), k > 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sacc);
      fence_regs(dpacc);
      // P^T = exp2(S^T - lse2) and dS^T = P^T (dP^T - delta), query = column
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * n + 2 * tg4 + (e & 1);
          const float p = exp2f(sacc[4 * n + e] - sL[col]);
          sacc[4 * n + e] = p;
          dpacc[4 * n + e] = p * (dpacc[4 * n + e] - sD[col]);
        }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[kk][e] = pack_bf16(sacc[8 * kk + 2 * e], sacc[8 * kk + 2 * e + 1]);
          da[kk][e] = pack_bf16(dpacc[8 * kk + 2 * e], dpacc[8 * kk + 2 * e + 1]);
        }
      // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major where TMA put them
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<DN>(dva, pa[kk], desc(ga + kk * 2048, BQ * 128), 1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<DN>(dka, da[kk], desc(qa + kk * 2048, BQ * 128), 1);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pa);
      fence_regs(da);
      if (t == 0) mbar_arrive(empty + s);
    }

    const int r0 = k0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;
    const long long rs = (long long)H * a.d;
#pragma unroll
    for (int n = 0; n < DN / 8; ++n) {
      const int c = 8 * n + 2 * tg4;  // D % 8 == 0: c < D implies c + 1 < D
      if (c >= a.d) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? r1 : r0;
        if (r >= a.sk) continue;
        const long long at = ((long long)b * a.sk + r) * rs + (long long)hh * a.d + c;
        const float k0v = dka[4 * n + 2 * half], k1v = dka[4 * n + 2 * half + 1];
        const float v0v = dva[4 * n + 2 * half], v1v = dva[4 * n + 2 * half + 1];
        if (a.nsplit == 1) {
          *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(k0v * a.scale, k1v * a.scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + at) = __floats2bfloat162_rn(v0v, v1v);
        } else {
          const long long pt = (long long)sp * B * a.sk * rs + at;
          *reinterpret_cast<float2*>(dkp + pt) = make_float2(k0v, k1v);
          *reinterpret_cast<float2*>(dvp + pt) = make_float2(v0v, v1v);
        }
      }
    }
  }
}

// dK and dV from the NSPLIT fp32 partials, summed in split order
__global__ void dkdv_reduce_kernel(const float* __restrict__ dkp, const float* __restrict__ dvp,
                                   bf16* __restrict__ dk, bf16* __restrict__ dv, long long n,
                                   int nsplit, float scale) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float sk = 0.f, sv = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      sk += dkp[s * n + i];
      sv += dvp[s * n + i];
    }
    dk[i] = __float2bfloat16(sk * scale);
    dv[i] = __float2bfloat16(sv);
  }
}

// dQ: a block owns 64 NWG queries (Qs and dO resident) and loops over the
// key tiles; grid (ceil(Sq / (64 NWG)), H, B)
template <int DN, int BK, int NWG>
struct DqTile {
  static constexpr int NCH = (DN + 63) / 64, BQ = 64 * NWG, STAGES = 2;
  static constexpr int QT_BYTES = NCH * BQ * 128;
  static constexpr int KV_BYTES = NCH * BK * 128;
  static constexpr int BAR_OFF = 2 * QT_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
  static constexpr int THREADS = 128 * NWG + 32;
};

template <int DN, int BK, int NWG>
__global__ void __launch_bounds__(128 * NWG + 32, 1)
dq_tma_kernel(const __grid_constant__ CUtensorMap tqs, const __grid_constant__ CUtensorMap tg,
              const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
              const float* __restrict__ lse2, const float* __restrict__ delta, bf16* __restrict__ dq,
              BwdArgs a) {
  using L = DqTile<DN, BK, NWG>;
  constexpr int NCH = L::NCH, BQ = L::BQ, STAGES = L::STAGES, KS = DN / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sG = sQ + L::QT_BYTES;
  unsigned char* sK = sG + L::QT_BYTES;  // [STAGES] K, then [STAGES] V
  unsigned char* sV = sK + STAGES * L::KV_BYTES;
  uint64_t* barQ = reinterpret_cast<uint64_t*>(sQ + L::BAR_OFF);
  uint64_t* full = barQ + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, wg = tid / 128;
  const int H = gridDim.y;
  const int q0 = blockIdx.x * BQ, hh = blockIdx.y, b = blockIdx.z;
  const int ntiles = (a.sk + BK - 1) / BK;
  if (tid == 0) {
    mbar_init(barQ, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == NWG) {  // the producer warp
    if (tid == NWG * 128) {
      const int col = hh * a.d;
      mbar_expect_tx(barQ, 2 * L::QT_BYTES);
      for (int c = 0; c < NCH; ++c) {
        tma_load(sQ + c * BQ * 128, &tqs, barQ, col + 64 * c, q0, 0, b, false);
        tma_load(sG + c * BQ * 128, &tg, barQ, col + 64 * c, q0, 0, b, false);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES, ph = (j / STAGES) & 1;
        mbar_wait(empty + s, ph ^ 1);
        mbar_expect_tx(full + s, 2 * L::KV_BYTES);
        for (int c = 0; c < NCH; ++c) {
          tma_load(sK + s * L::KV_BYTES + c * BK * 128, &tk, full + s, col + 64 * c, j * BK, 0, b, false);
          tma_load(sV + s * L::KV_BYTES + c * BK * 128, &tv, full + s, col + 64 * c, j * BK, 0, b, false);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns queries q0 + 64 wg ...
    const int t = tid % 128, warp = t / 32, lane = t % 32, g = lane / 4, tg4 = lane % 4;
    mbar_wait(barQ, 0);
    zero_tail<NCH>(sQ, BQ, a.d, tid, NWG * 128);  // Qs and dO columns past D
    zero_tail<NCH>(sG, BQ, a.d, tid, NWG * 128);
    fence_async_smem();
    named_sync(1, NWG * 128);

    const int r0 = q0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;  // < Sqp
    const long long lrow = ((long long)b * H + hh) * a.sqp;
    const float l0 = lse2[lrow + r0], l1 = lse2[lrow + r1];
    const float d0 = delta[lrow + r0], d1 = delta[lrow + r1];
    float dqa[DN / 2];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) dqa[i] = 0.f;
    const uint32_t qa = smem_addr(sQ) + wg * 64 * 128, ga = smem_addr(sG) + wg * 64 * 128;
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % STAGES, ph = (j / STAGES) & 1;
      const uint32_t kt = smem_addr(sK + s * L::KV_BYTES), vt = smem_addr(sV + s * L::KV_BYTES);
      mbar_wait(full + s, ph);
      float sacc[BK / 2], dpacc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sacc[i] = dpacc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < KS; ++k)
        wgmma_ss<BK>(sacc, desc(qa + (k / 4) * BQ * 128 + (k % 4) * 32, 16),
                     desc(kt + (k / 4) * BK * 128 + (k % 4) * 32, 16), k > 0);
#pragma unroll
      for (int k = 0; k < KS; ++k)
        wgmma_ss<BK>(dpacc, desc(ga + (k / 4) * BQ * 128 + (k % 4) * 32, 16),
                     desc(vt + (k / 4) * BK * 128 + (k % 4) * 32, 16), k > 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sacc);
      fence_regs(dpacc);
      // dS = P (dP - delta); keys past Sk get P = 0
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j * BK + 8 * n + 2 * tg4 + (e & 1);
          const float p = key < a.sk ? exp2f(sacc[4 * n + e] - (e < 2 ? l0 : l1)) : 0.f;
          sacc[4 * n + e] = p * (dpacc[4 * n + e] - (e < 2 ? d0 : d1));
        }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) da[kk][e] = pack_bf16(sacc[8 * kk + 2 * e], sacc[8 * kk + 2 * e + 1]);
      // dQ += dS K, K read MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<DN>(dqa, da[kk], desc(kt + kk * 2048, BK * 128), 1);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dqa);
      fence_regs(da);
      if (t == 0) mbar_arrive(empty + s);
    }

    const long long rs = (long long)H * a.d;
#pragma unroll
    for (int n = 0; n < DN / 8; ++n) {
      const int c = 8 * n + 2 * tg4;
      if (c >= a.d) continue;
      if (r0 < a.sq)
        *reinterpret_cast<__nv_bfloat162*>(dq + ((long long)b * a.sq + r0) * rs + hh * a.d + c) =
            __floats2bfloat162_rn(dqa[4 * n] * a.scale, dqa[4 * n + 1] * a.scale);
      if (r1 < a.sq)
        *reinterpret_cast<__nv_bfloat162*>(dq + ((long long)b * a.sq + r1) * rs + hh * a.d + c) =
            __floats2bfloat162_rn(dqa[4 * n + 2] * a.scale, dqa[4 * n + 3] * a.scale);
    }
  }
}

// ------------------------------------------------------------------ host
struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  Shape sh;
  float qscale, scale;
  cudaStream_t st;
};

cudaError_t launch_delta(const Args& a) {
  const long long rows = (long long)a.sh.b * a.sh.sq * a.sh.h;
  const int per_block = kSimtThreads / 32;
  delta_kernel<<<(unsigned)((rows + per_block - 1) / per_block), kSimtThreads, 0, a.st>>>(
      static_cast<const float*>(a.o), static_cast<const float*>(a.dout), a.delta, a.sh);
  return cudaGetLastError();
}

template <int DN, int BQ, int NWG>
cudaError_t launch_dkdv(const CUtensorMap (&m)[5], const float* lse2, const float* delta, void* dk,
                        void* dv, float* dkp, float* dvp, const Shape& sh, const BwdArgs& ba,
                        cudaStream_t st) {
  using L = DkdvTile<DN, BQ, NWG>;
  constexpr auto kern = dkdv_tma_kernel<DN, BQ, NWG>;
  cudaError_t err = set_smem_once<kern>(L::SMEM);
  if (err != cudaSuccess) return err;
  kern<<<dim3((sh.sk + L::BKV - 1) / L::BKV, sh.h, sh.b * ba.nsplit), L::THREADS, L::SMEM, st>>>(
      m[0], m[1], m[2], m[3], m[4], lse2, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), dkp,
      dvp, ba);
  return cudaGetLastError();
}

template <int DN, int BK, int NWG>
cudaError_t launch_dq(const CUtensorMap (&m)[4], const float* lse2, const float* delta, void* dq,
                      const Shape& sh, const BwdArgs& ba, cudaStream_t st) {
  using L = DqTile<DN, BK, NWG>;
  constexpr auto kern = dq_tma_kernel<DN, BK, NWG>;
  cudaError_t err = set_smem_once<kern>(L::SMEM);
  if (err != cudaSuccess) return err;
  kern<<<dim3((sh.sq + L::BQ - 1) / L::BQ, sh.h, sh.b), L::THREADS, L::SMEM, st>>>(
      m[0], m[1], m[2], m[3], lse2, delta, static_cast<bf16*>(dq), ba);
  return cudaGetLastError();
}

template <int DN, int BK>
cudaError_t launch_dq_rows(int nwg, const CUtensorMap (&m)[4], const float* lse2, const float* delta,
                           void* dq, const Shape& sh, const BwdArgs& ba, cudaStream_t st) {
  return nwg == 1 ? launch_dq<DN, BK, 1>(m, lse2, delta, dq, sh, ba, st)
                  : launch_dq<DN, BK, 2>(m, lse2, delta, dq, sh, ba, st);
}

// smem of the two kernels of a plan: {dK/dV, dQ}
void plan_smem(const BwdPlan& p, int* out) {
#define DQ(DN, BK) (p.nwg_q == 1 ? DqTile<DN, BK, 1>::SMEM : DqTile<DN, BK, 2>::SMEM)
  if (p.dn == 48) {
    out[0] = DkdvTile<48, 64, 2>::SMEM;
    out[1] = p.bk_q == 80 ? DQ(48, 80) : DQ(48, 64);
  } else if (p.dn == 80) {
    out[0] = DkdvTile<80, 32, 2>::SMEM;
    out[1] = p.bk_q == 80 ? DQ(80, 80) : DQ(80, 64);
  } else {
    out[0] = DkdvTile<160, 32, 1>::SMEM;
    out[1] = p.bk_q == 80 ? DQ(160, 80) : DQ(160, 64);
  }
#undef DQ
}

// the bf16 path: prep, dK/dV (and its reduction when split), dQ
cudaError_t launch_tma(const Args& a) {
  const Shape& sh = a.sh;
  const BwdPlan p = bwd_plan(sh.b, sh.sq, sh.sk, sh.h, sh.d);
  unsigned char* ws = reinterpret_cast<unsigned char*>(a.delta);
  float* lse2 = reinterpret_cast<float*>(ws);
  float* delta = reinterpret_cast<float*>(ws + p.off_delta);
  bf16* qs = reinterpret_cast<bf16*>(ws + p.off_qs);
  float* dkp = reinterpret_cast<float*>(ws + p.off_dkp);
  float* dvp = reinterpret_cast<float*>(ws + p.off_dvp);
  const long long rq = (long long)sh.h * sh.d;  // row strides of the contiguous tensors
  const long long bq = rq * sh.sq, bk = rq * sh.sk;

  const long long rows = (long long)sh.b * sh.h * p.sqp;
  bwd_prep_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, a.st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout),
      a.lse, qs, lse2, delta, sh, p.sqp, a.qscale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap mk_kv, mv_kv, mqs_kv, mq_kv, mg_kv, mqs_q, mg_q, mk_q, mv_q;
  const int bkv = 64 * p.nwg_kv;
  if (!cached_bf16_map(&mk_kv, a.k, sh.b, sh.sk, sh.h, sh.d, bk, rq, sh.d, bkv) ||
      !cached_bf16_map(&mv_kv, a.v, sh.b, sh.sk, sh.h, sh.d, bk, rq, sh.d, bkv) ||
      !cached_bf16_map(&mqs_kv, qs, sh.b, sh.sq, sh.h, sh.d, bq, rq, sh.d, p.bq_kv) ||
      !cached_bf16_map(&mq_kv, a.q, sh.b, sh.sq, sh.h, sh.d, bq, rq, sh.d, p.bq_kv) ||
      !cached_bf16_map(&mg_kv, a.dout, sh.b, sh.sq, sh.h, sh.d, bq, rq, sh.d, p.bq_kv) ||
      !cached_bf16_map(&mqs_q, qs, sh.b, sh.sq, sh.h, sh.d, bq, rq, sh.d, 64 * p.nwg_q) ||
      !cached_bf16_map(&mg_q, a.dout, sh.b, sh.sq, sh.h, sh.d, bq, rq, sh.d, 64 * p.nwg_q) ||
      !cached_bf16_map(&mk_q, a.k, sh.b, sh.sk, sh.h, sh.d, bk, rq, sh.d, p.bk_q) ||
      !cached_bf16_map(&mv_q, a.v, sh.b, sh.sk, sh.h, sh.d, bk, rq, sh.d, p.bk_q))
    return cudaErrorInvalidValue;
  const CUtensorMap mkv[5] = {mk_kv, mv_kv, mqs_kv, mq_kv, mg_kv};
  const CUtensorMap mq[4] = {mqs_q, mg_q, mk_q, mv_q};
  const BwdArgs ba{sh.sq, sh.sk, sh.d, p.sqp, p.nsplit, a.scale};

  if (p.dn == 48) err = launch_dkdv<48, 64, 2>(mkv, lse2, delta, a.dk, a.dv, dkp, dvp, sh, ba, a.st);
  else if (p.dn == 80) err = launch_dkdv<80, 32, 2>(mkv, lse2, delta, a.dk, a.dv, dkp, dvp, sh, ba, a.st);
  else err = launch_dkdv<160, 32, 1>(mkv, lse2, delta, a.dk, a.dv, dkp, dvp, sh, ba, a.st);
  if (err != cudaSuccess) return err;
  if (p.nsplit > 1) {
    const long long n = bk * sh.b;
    const unsigned blocks = (unsigned)std::min((n + 255) / 256, 4LL * kFill);
    dkdv_reduce_kernel<<<blocks, 256, 0, a.st>>>(
        dkp, dvp, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), n, p.nsplit, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
#define ARGS p.nwg_q, mq, lse2, delta, a.dq, sh, ba, a.st
  if (p.dn == 48) return p.bk_q == 80 ? launch_dq_rows<48, 80>(ARGS) : launch_dq_rows<48, 64>(ARGS);
  if (p.dn == 80) return p.bk_q == 80 ? launch_dq_rows<80, 80>(ARGS) : launch_dq_rows<80, 64>(ARGS);
  return p.bk_q == 80 ? launch_dq_rows<160, 80>(ARGS) : launch_dq_rows<160, 64>(ARGS);
#undef ARGS
}

template <int DPAD>
cudaError_t launch_simt(const Args& a) {  // the fp32 parity path
  constexpr int BR = 32, BC = 32;  // rows owned by a block, rows of a streamed tile
  cudaError_t err = launch_delta(a);
  if (err != cudaSuccess) return err;
  const float *q = static_cast<const float*>(a.q), *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v), *g = static_cast<const float*>(a.dout);
  constexpr size_t smem = simt_smem_bytes<DPAD, BR, BC>();
  auto k1 = dkdv_simt_kernel<DPAD, BR, BC>;
  auto k2 = dq_simt_kernel<DPAD, BR, BC>;
  err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  k1<<<dim3((a.sh.sk + BR - 1) / BR, a.sh.h, a.sh.b), kSimtThreads, smem, a.st>>>(
      q, k, v, g, a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.sh,
      a.qscale, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2<<<dim3((a.sh.sq + BR - 1) / BR, a.sh.h, a.sh.b), kSimtThreads, smem, a.st>>>(
      q, k, v, g, a.lse, a.delta, static_cast<float*>(a.dq), a.sh, a.qscale, a.scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// launches of each body since the library was loaded (0: fp32 SIMT, 1: fp32
// 3xTF32, 2: bf16), so that a check can tell which body a call took
long long body_launches[3] = {0, 0, 0};

// the fp32 plan: the 3xTF32 body where its TMA maps and vector stores can
// address the tensors (D % 4 == 0, each of q, k, v, o, dout, dq, dk, dv
// 16-byte aligned), SIMT elsewhere
bwd_tf32::F32BwdPlan f32_bwd_plan_of(int b, int sq, int sk, int h, int d, const void* const (&t)[8]) {
  bool ok = true;
  for (const void* p : t) ok = ok && aligned16(p);
  return bwd_tf32::f32_bwd_plan(b, sq, sk, h, d, ok);
}

}  // namespace

extern "C" {

const char* madm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// bf16.  q, o, dout, dq: contiguous [B, Sq, H, D]; k, v, dk, dv: contiguous
// [B, Sk, H, D]; lse (from the forward): contiguous fp32 [B, H, Sq].
// `delta` is the workspace: madm_flash_attention_bwd_plan's bytes (16-byte
// aligned).  D <= 160, D % 8 == 0, 16-byte aligned q, k, v, dout, dq, dk,
// dv.  Returns the cudaError_t of the launches (0 = success,
// cudaErrorInvalidValue for input outside these bounds); the kernels run on
// `stream`.
int madm_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                             const void* lse, void* delta, void* dq, void* dk, void* dv, int b, int sq, int sk,
                             int h, int d, float scale, void* stream) {
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
               dq, dk, dv, Shape{b, sq, sk, h, d}, scale * kLog2e, scale,
               static_cast<cudaStream_t>(stream)};
  const bool ok = d >= 1 && d <= 160 && d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                  aligned16(dout) && aligned16(dq) && aligned16(dk) && aligned16(dv) && aligned16(delta);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = launch_tma(a);
  if (err == cudaSuccess) ++body_launches[2];
  return static_cast<int>(err);
}

// float32, the tensors as madm_flash_attention_bwd's; `ws` is the
// workspace, ws_bytes long: at least the bytes madm_flash_attention_bwd_f32_plan
// returns (a shorter one is refused).  D <= 160.  The 3xTF32 body where
// the plan names it, else SIMT.  Returns the cudaError_t of the launches;
// the kernels run on `stream`.
int madm_flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                 const void* lse, void* ws, long long ws_bytes, void* dq, void* dk, void* dv,
                                 int b, int sq, int sk, int h, int d, float scale, void* stream) {
  if (d < 1 || d > 160) return static_cast<int>(cudaErrorInvalidValue);
  const bwd_tf32::F32BwdPlan p = f32_bwd_plan_of(b, sq, sk, h, d, {q, k, v, o, dout, dq, dk, dv});
  cudaError_t err;
  if (p.tma) {
    const bwd_tf32::BwdIn in{static_cast<const float*>(q), static_cast<const float*>(k),
                             static_cast<const float*>(v), static_cast<const float*>(o),
                             static_cast<const float*>(dout), static_cast<const float*>(lse),
                             static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
                             b, sq, sk, h, d, scale * kLog2e, scale, static_cast<cudaStream_t>(stream)};
    err = bwd_tf32::dispatch_tf32(p, in, ws, ws_bytes);
  } else if (ws == nullptr || ws_bytes < p.bytes) {
    err = cudaErrorInvalidValue;
  } else {
    const Args a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(ws),
                 dq, dk, dv, Shape{b, sq, sk, h, d}, scale * kLog2e, scale,
                 static_cast<cudaStream_t>(stream)};
    err = launch_simt<160>(a);
  }
  if (err == cudaSuccess) ++body_launches[p.tma];
  return static_cast<int>(err);
}

// The fp32 plan for tensors at these addresses, for holding backward_plan()
// to it: out = {3xTF32 body (1) or SIMT (0), padded D, queries a dK/dV
// tile, keys a dQ tile, A side resident, dK/dV splits, dK/dV ring stages,
// dQ ring stages, dK/dV shared memory, dQ shared memory, the stats' padded
// rows}; returns the workspace bytes.
long long madm_flash_attention_bwd_f32_plan(int b, int sq, int sk, int h, int d, const void* q, const void* k,
                                            const void* v, const void* o, const void* dout, const void* dq,
                                            const void* dk, const void* dv, int* out) {
  const bwd_tf32::F32BwdPlan p = f32_bwd_plan_of(b, sq, sk, h, d, {q, k, v, o, dout, dq, dk, dv});
  const int x[11] = {p.tma, p.dn, p.bt_kv, p.bt_q, p.res, p.nsplit, p.stages_kv, p.stages_q, p.smem_kv,
                     p.smem_q, p.sqs};
  for (int i = 0; i < 11; ++i) out[i] = x[i];
  return p.bytes;
}

// out = launches of each body through the two entries above since the
// library was loaded: {fp32 SIMT, fp32 3xTF32, bf16}
void madm_flash_attention_bwd_body_counts(long long* out) {
  for (int i = 0; i < 3; ++i) out[i] = body_launches[i];
}

// K5's bf16 body: K3's kernels for the backward of K4 on a packed
// self-attention (Sq == Sk == s), from K4's saved o and fp32 lse [B, H, S].
// Arguments as madm_flash_attention_bwd's in bf16, with K4's bounds: 1 <= g
// <= 4 (the routing decision; the kernels take one head a warpgroup), S % 64
// == 0, D <= 64, D % 8 == 0, 16-byte aligned tensors; `ws` is
// madm_packed_attention_bwd_plan's bytes.  Returns the cudaError_t of the
// launches; the kernels run on `stream`.
int madm_packed_attention_bwd_tma(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const void* lse, void* ws, void* dq, void* dk,
                                  void* dv, int b, int s, int h, int d, int g, float scale,
                                  void* stream) {
  if (g < 1 || g > 4 || d < 1 || d > 64 || d % 8 != 0 || s % 64 != 0 || b < 1 || h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool ok = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) && aligned16(dq) &&
                  aligned16(dk) && aligned16(dv) && aligned16(ws);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(ws),
               dq, dk, dv, Shape{b, s, s, h, d}, scale * kLog2e, scale,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch_tma(a));
}

// The bf16 path's plan for a shape, for holding attention_plan() to it:
// out = {padded D, q rows a dK/dV tile, dK/dV consumer warpgroups, dK/dV
// splits, keys a dQ tile, dQ consumer warpgroups, padded Sq, dK/dV shared
// memory, dQ shared memory}; returns the workspace bytes.
long long madm_flash_attention_bwd_plan(int b, int sq, int sk, int h, int d, int* out) {
  const BwdPlan p = bwd_plan(b, sq, sk, h, d);
  int sm[2];
  plan_smem(p, sm);
  const int v[9] = {p.dn, p.bq_kv, p.nwg_kv, p.nsplit, p.bk_q, p.nwg_q, p.sqp, sm[0], sm[1]};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return p.bytes;
}

// K5's bf16 plan for a [B, S, H, D] self-attention: K3's at Sq == Sk == S
// (the same out values and workspace bytes).
long long madm_packed_attention_bwd_plan(int b, int s, int h, int d, int* out) {
  return madm_flash_attention_bwd_plan(b, s, s, h, d, out);
}

}  // extern "C"
