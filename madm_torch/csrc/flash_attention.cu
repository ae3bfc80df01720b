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
// moved, i.e. far above the card's ~295 ops/byte ridge: it is bound by
// operations.  The TPU kernel kept the whole K/V of a head resident in its
// 128 MB of VMEM; a Hopper block has at most 227 KB of shared memory, so this
// kernel streams K/V through shared memory in tiles of BK keys with an
// online softmax (running max and sum in fp32, base-2 exponent with
// scale*log2(e) folded into q, as the TPU kernel did) and divides by the sum
// once, after the last PV product.  The S x S scores never reach device
// memory.  Keys past kv_len (the ragged last tile, e.g. Sk=77) are masked to
// -inf; D is padded to the tile width in shared memory only.
//
// Two bodies, chosen from the dtype and D:
// - bf16 with D % 8 == 0 and 16-byte aligned rows (every attention of the
//   model): tensor cores through mma.sync m16n8k16 (bf16 in, fp32
//   accumulate), FlashAttention-2 style.
//   A block is 4 warps x 16 query rows; each warp keeps its scores, its
//   online-softmax state and its [16, D] output accumulator in registers
//   (the m16n8 accumulator layout gives each thread rows g and g+8, so the
//   rescale by exp2(m_old - m_new) needs no shared memory), and feeds P to
//   the PV product straight from the score registers as bf16.  q is scaled
//   and rounded to bf16 as the TPU kernel did; K is staged row-major and V
//   transposed in shared memory so every fragment is one 32-bit load.  Tiles
//   arrive by 16-byte loads, and the next K/V tile is fetched into registers
//   while the current one computes.
//   The D=512 single-head VAE attention splits its output columns over 4
//   blocks of 128 (each recomputes the scores) to keep the accumulator in
//   registers.
// Both bodies optionally write the fp32 row log-sum-exp (natural log, of the
// scaled scores) to lse [B, H, Sq]: the backward kernel K3
// (flash_attention_bwd.cu) recomputes P = exp(s - lse) from it.  Eval passes
// hand a null pointer and skip the write.
// - float32 (the parity path) and any other bf16 input: SIMT fp32 FMA on a
//   16x16 thread grid, register tiles of RI query rows x CJ keys and RI rows
//   x DJ head columns;
//   D=512 uses 32-row query tiles so its fp32 output accumulator stays in
//   registers (32 x 512 over 256 threads).  This body does not use the tensor
//   cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 16 x 16: tx = key / head-dim lane, ty = query lane
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, s, h;  // element strides of batch, sequence and head; head dim is unit-stride
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int DPAD, int BQ, int BK>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (DPAD + 1) + BK * (DPAD + 1) + BK * DPAD + BQ * (BK + 1));
}

template <typename T, int DPAD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int nh, int sq, int sk, int d,
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
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  for (int e = tid; e < BQ * DPAD; e += kThreads) {
    const int r = e / DPAD, c = e - r * DPAD;
    float x = 0.f;
    if (q0 + r < sq && c < d) x = to_float(qb[(long long)(q0 + r) * qs.s + c]) * qscale;
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
        kx = to_float(kb[(long long)(k0 + r) * ks.s + c]);
        vx = to_float(vb[(long long)(k0 + r) * vs.s + c]);
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
  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    const float inv = 1.f / l_run[i];
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) ob[(long long)r * os.s + c] = from_float<T>(acc[i][j] * inv);
    }
    if (lse != nullptr && tx == 0)
      lse[((long long)b * nh + h) * sq + r] = (m_run[i] + log2f(l_run[i])) * kLn2;
  }
}

// ------------------------------------------------- bf16 tensor-core body
constexpr int kMmaWarps = 4;  // 16 query rows each
constexpr int kMmaBQ = 16 * kMmaWarps;

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo -> low half (lower column)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int DP, int BK, int DO>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (kMmaBQ * (DP + 8) + BK * (DP + 8) + DO * (BK + 8));
}

// DO < DP splits the output columns over DP / DO blocks, each of which
// recomputes the scores; it keeps the D=512 accumulator at 16 x 128 per warp.
template <int DP, int BK, int DO>
__global__ void __launch_bounds__(32 * kMmaWarps)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int nh, int sq, int sk, int d, Strides qs,
                     Strides ks, Strides vs, Strides os, float qscale) {
  constexpr int LQ = DP + 8, LK = DP + 8, LV = BK + 8;  // 32-bit fragment loads conflict-free
  constexpr int NT = BK / 8;   // score n-tiles per warp
  constexpr int DT = DO / 8;   // output n-tiles per warp
  constexpr int NCH = DP / DO;  // output column chunks, one per block
  static_assert(DP % 16 == 0 && BK % 16 == 0 && DP % DO == 0 && DO % 8 == 0, "tile shape");
  constexpr int kT = 32 * kMmaWarps;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][LQ], scaled q
  __nv_bfloat16* Ks = Qs + kMmaBQ * LQ;                             // [BK][LK]
  __nv_bfloat16* Vt = Ks + BK * LK;                                 // [DO][LV], V^T of the chunk

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;  // mma fragment group / thread-in-group
  const int q0 = blockIdx.x * kMmaBQ, h = blockIdx.y / NCH, b = blockIdx.z;
  const int dc = (blockIdx.y - h * NCH) * DO;  // first output column of this block
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;

  // 16-byte loads: the caller guarantees d % 8 == 0 and 16-byte aligned rows
  constexpr int KV8 = DP / 8, VV8 = DO / 8;               // 8-column vectors per row
  constexpr int NKR = (BK * KV8 + kT - 1) / kT;           // K vectors per thread and tile
  constexpr int NVR = (BK * VV8 + kT - 1) / kT;           // V vectors per thread and tile
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  for (int e = tid; e < kMmaBQ * KV8; e += kT) {
    const int r = e / KV8, c8 = (e - r * KV8) * 8;
    uint4 raw = zero4;
    if (q0 + r < sq && c8 < d) raw = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * qs.s + c8);
    const __nv_bfloat16* x8 = reinterpret_cast<const __nv_bfloat16*>(&raw);
    __align__(16) __nv_bfloat16 y8[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) y8[i] = __float2bfloat16(__bfloat162float(x8[i]) * qscale);
    *reinterpret_cast<uint4*>(Qs + r * LQ + c8) = *reinterpret_cast<const uint4*>(y8);
  }

  // the next K/V tile is fetched into registers while the current one computes
  uint4 kreg[NKR], vreg[NVR];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < NKR; ++i) {
      const int e = tid + i * kT, r = e / KV8, c8 = (e - r * KV8) * 8;
      kreg[i] = (e < BK * KV8 && k0 + r < sk && c8 < d)
                    ? *reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * ks.s + c8)
                    : zero4;
    }
#pragma unroll
    for (int i = 0; i < NVR; ++i) {
      const int e = tid + i * kT, r = e / VV8, c8 = (e - r * VV8) * 8;
      vreg[i] = (e < BK * VV8 && k0 + r < sk && dc + c8 < d)
                    ? *reinterpret_cast<const uint4*>(vb + (long long)(k0 + r) * vs.s + dc + c8)
                    : zero4;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < NKR; ++i) {
      const int e = tid + i * kT, r = e / KV8, c8 = (e - r * KV8) * 8;
      if (e < BK * KV8) *reinterpret_cast<uint4*>(Ks + r * LK + c8) = kreg[i];
    }
#pragma unroll
    for (int i = 0; i < NVR; ++i) {
      const int e = tid + i * kT, r = e / VV8, c8 = (e - r * VV8) * 8;
      if (e < BK * VV8) {
        const __nv_bfloat16* x8 = reinterpret_cast<const __nv_bfloat16*>(&vreg[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) Vt[(c8 + j) * LV + r] = x8[j];
      }
    }
  };
  fetch(0);

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // rows g and g+8 of this warp
  float l0 = 0.f, l1 = 0.f;                       // this thread's share of the row sums
  const __nv_bfloat16* qrow0 = Qs + (16 * warp + g) * LQ + 2 * tg;
  const __nv_bfloat16* qrow1 = qrow0 + 8 * LQ;

  for (int k0 = 0; k0 < sk; k0 += BK) {
    __syncthreads();  // Qs written (first tile); Ks/Vt free (later tiles)
    stash();
    __syncthreads();
    if (k0 + BK < sk) fetch(k0 + BK);

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      const uint32_t a0 = ld32(qrow0 + kk), a1 = ld32(qrow1 + kk);
      const uint32_t a2 = ld32(qrow0 + kk + 8), a3 = ld32(qrow1 + kk + 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* kp = Ks + (8 * j + g) * LK + kk + 2 * tg;
        mma_bf16_16816(s[j], a0, a1, a2, a3, ld32(kp), ld32(kp + 8));
      }
    }

    // online softmax; a row's 8-key tiles are spread over the 4 threads of a group
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int key = k0 + 8 * j + 2 * tg;
      if (key >= sk) s[j][0] = s[j][2] = -CUDART_INF_F;
      if (key + 1 >= sk) s[j][1] = s[j][3] = -CUDART_INF_F;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
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
    for (int j = 0; j < NT; ++j) {
      s[j][0] = exp2f(s[j][0] - n0);
      s[j][1] = exp2f(s[j][1] - n0);
      s[j][2] = exp2f(s[j][2] - n1);
      s[j][3] = exp2f(s[j][3] - n1);
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= al0;
      acc[j][1] *= al0;
      acc[j][2] *= al1;
      acc[j][3] *= al1;
    }

    // acc += P V: two adjacent score tiles form one A fragment
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const __nv_bfloat16* vp = Vt + (8 * j + g) * LV + 16 * kk + 2 * tg;
        mma_bf16_16816(acc[j], a0, a1, a2, a3, ld32(vp), ld32(vp + 8));
      }
    }
  }

  // row sums across the group, normalise after PV, store
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;
  if (lse != nullptr && dc == 0 && tg == 0) {  // the row sums are whole on every thread now
    float* lb = lse + ((long long)b * nh + h) * sq;
    if (r0 < sq) lb[r0] = (m0 + log2f(l0)) * kLn2;
    if (r1 < sq) lb[r1] = (m1 + log2f(l1)) * kLn2;
  }
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int c = dc + 8 * j + 2 * tg;
    if (r0 < sq) {
      if (c < d) ob[(long long)r0 * os.s + c] = __float2bfloat16(acc[j][0] * i0);
      if (c + 1 < d) ob[(long long)r0 * os.s + c + 1] = __float2bfloat16(acc[j][1] * i0);
    }
    if (r1 < sq) {
      if (c < d) ob[(long long)r1 * os.s + c] = __float2bfloat16(acc[j][2] * i1);
      if (c + 1 < d) ob[(long long)r1 * os.s + c + 1] = __float2bfloat16(acc[j][3] * i1);
    }
  }
}

template <int DP, int BK, int DO>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                       int sq, int sk, int h, int d, Strides qs, Strides ks, Strides vs, Strides os,
                       float qscale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<DP, BK, DO>();
  auto kern = flash_fwd_mma_kernel<DP, BK, DO>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kMmaBQ - 1) / kMmaBQ, h * (DP / DO), b);
  kern<<<grid, 32 * kMmaWarps, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, h, sq, sk, d,
      qs, ks, vs, os, qscale);
  return cudaGetLastError();
}

template <typename T, int DPAD, int BQ, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                   int sq, int sk, int h, int d, Strides qs, Strides ks, Strides vs, Strides os, float qscale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DPAD, BQ, BK>();
  auto kern = flash_fwd_kernel<T, DPAD, BQ, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<T*>(o), lse, h,
                                         sq, sk, d, qs, ks, vs, os, qscale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                     int sq, int sk, int h, int d, Strides qs, Strides ks, Strides vs, Strides os, float qscale,
                     bool vec16, cudaStream_t st) {
#define ARGS q, k, v, o, lse, b, sq, sk, h, d, qs, ks, vs, os, qscale, st
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (vec16) {  // tensor-core body
      if (d <= 48) return launch_mma<48, 64, 48>(ARGS);
      if (d <= 64) return launch_mma<64, 64, 64>(ARGS);
      if (d <= 80) return launch_mma<80, 64, 80>(ARGS);
      if (d <= 128) return launch_mma<128, 32, 128>(ARGS);
      if (d <= 160) return launch_mma<160, 32, 160>(ARGS);
      if (d <= 512) return launch_mma<512, 32, 128>(ARGS);
    }
  }
  if (d <= 48) return launch<T, 48, 64, 64>(ARGS);
  if (d <= 64) return launch<T, 64, 64, 64>(ARGS);
  if (d <= 80) return launch<T, 80, 64, 64>(ARGS);
  if (d <= 128) return launch<T, 128, 64, 32>(ARGS);
  if (d <= 160) return launch<T, 160, 64, 32>(ARGS);
  if (d <= 512) return launch<T, 512, 32, 32>(ARGS);
#undef ARGS
  return cudaErrorInvalidValue;
}

// 16-byte vector loads of head rows are legal: 8-element rows and strides, aligned base
bool aligned16(const void* p, const Strides& st, int d) {
  return d % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 8 == 0 &&
         st.s % 8 == 0 && st.h % 8 == 0;
}

}  // namespace

extern "C" {

const char* madm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  lse is null
// or a contiguous fp32 [B, H, Sq].  Returns the cudaError_t of the launch
// (0 = success); the kernel runs on `stream`.
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
  if (dtype == 0)
    err = dispatch<float>(q, k, v, o, static_cast<float*>(lse), b, sq, sk, h, d, qs, ks, vs, os,
                          qscale, false, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, o, static_cast<float*>(lse), b, sq, sk, h, d, qs, ks,
                                  vs, os, qscale,
                                  aligned16(q, qs, d) && aligned16(k, ks, d) && aligned16(v, vs, d), st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
