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
// on contiguous [B, S, H, D] tensors; lse and delta are fp32 [B, H, Sq].
// dq, dk and dv come out in the input dtype from fp32 accumulators.
//
// Bound on the H100: 10*Sq*Sk*D operations per head (the TPU kernel's own
// count) against ~(4*Sq + 4*Sk)*D elements moved: far above the ~295
// ops/byte ridge, so it is bound by operations.  The TPU kernel walked the
// q blocks of a head in order on one core and accumulated dk/dv in a
// revisited output block; Hopper blocks run in parallel in no order, so this
// port follows FlashAttention-2 instead, without atomics and deterministic:
//   1. delta_kernel: delta = rowsum(dO * O) in fp32, one warp per row;
//   2. dkdv kernel: parallel over K/V tiles, loops over the q tiles of the
//      head and keeps the tile's dK/dV accumulators in registers;
//   3. dq kernel: parallel over q tiles, loops over the K/V tiles.
// P and dS never reach device memory.  The scores are recomputed in both
// passes (7 products where an atomic dq would need 5): the price of no atomics.
// Keys past kv_len (the ragged last tile, e.g. Sk=77) get P = 0, query rows
// past Sq contribute nothing; D is padded to the tile width in shared memory
// only (D=40 -> 48).  D > 160 is refused: the only larger head, the VAE's
// D=512 mid-block attention, never trains.
//
// Two bodies, one per dtype:
// - bf16 (the train step): tensor cores through mma.sync m16n8k16 (bf16 in,
//   fp32 accumulate), instantiated for the UNet's head dims (D=40 -> 48, 80,
//   160; other D <= 160 pad to the next of these).  It needs D % 8 == 0 and
//   16-byte aligned tensors, as every UNet attention has; other bf16 input is
//   refused, not sent to a slower body.
//   q is scaled by scale*log2(e) and rounded to bf16 exactly as K1 did, so P
//   is the forward's P; the softmax runs in base 2.  Each warp owns 16 rows
//   (keys in the dkdv kernel, queries in the dq kernel); the score tile's
//   accumulator registers become the A fragments of the next product
//   (P^T dO, dS^T Q, dS K) without a trip through shared memory.  Tiles that
//   are B operands of a k-over-rows product are staged transposed.
// - float32 (the parity path): SIMT fp32 FMA with the tiles in shared
//   memory, one instantiation padded to D=160.  This body does not use the
//   tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;                 // mma bodies: 4 warps x 16 rows
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kSimtThreads = 256;

struct Shape {
  int b, sq, sk, h, d;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// --------------------------------------------------------------- delta
// delta[b, h, i] = sum_c dO[b, i, h, c] * O[b, i, h, c]; one warp per row
template <typename T>
__global__ void delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                             float* __restrict__ delta, Shape sh) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)sh.b * sh.sq * sh.h) return;  // whole warps leave together
  const T* op = o + row * sh.d;
  const T* gp = dout + row * sh.d;
  float acc = 0.f;
  for (int c = lane; c < sh.d; c += 32) acc += to_float(op[c]) * to_float(gp[c]);
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

// ------------------------------------------------- bf16 tensor-core bodies
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

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [r0, r0 + n) x D of a [B, S, H, D] head into a [n][ld] bf16 tile (and,
// when tr != nullptr, its transpose [DP][ldt]); rows past `rows` and columns
// past D are zero; with qscale != 0 the row-major copy is q * qscale rounded
// to bf16 as in K1 while the transpose keeps q
template <int DP>
__device__ __forceinline__ void stage(const bf16* __restrict__ src, long long srow, int r0,
                                      int n, int rows, int d, bf16* dst, int ld, bf16* tr,
                                      int ldt, float qscale) {
  constexpr int V8 = DP / 8;
  for (int e = threadIdx.x; e < n * V8; e += kMmaThreads) {
    const int r = e / V8, c8 = (e - r * V8) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows && c8 < d) raw = *reinterpret_cast<const uint4*>(src + (r0 + r) * srow + c8);
    const bf16* x8 = reinterpret_cast<const bf16*>(&raw);
    if (qscale != 0.f) {
      __align__(16) bf16 y8[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) y8[i] = __float2bfloat16(__bfloat162float(x8[i]) * qscale);
      *reinterpret_cast<uint4*>(dst + r * ld + c8) = *reinterpret_cast<const uint4*>(y8);
    } else {
      *reinterpret_cast<uint4*>(dst + r * ld + c8) = raw;
    }
    if (tr != nullptr) {
#pragma unroll
      for (int i = 0; i < 8; ++i) tr[(c8 + i) * ldt + r] = x8[i];
    }
  }
}

template <int DP, int BQ>
constexpr size_t dkdv_mma_smem_bytes() {
  return sizeof(bf16) * (2 * (16 * kWarps) * (DP + 8) + 2 * BQ * (DP + 8) + 2 * DP * (BQ + 8)) +
         sizeof(float) * 2 * BQ;
}

// grid (ceil(Sk / 64), H, B): each warp owns 16 keys; loop over q tiles of BQ
template <int DP, int BQ>
__global__ void __launch_bounds__(kMmaThreads)
dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, Shape sh, float qscale,
                float scale) {
  constexpr int BKV = 16 * kWarps;
  constexpr int LD = DP + 8, LT = BQ + 8;  // 32-bit fragment loads stay aligned
  constexpr int NQ = BQ / 8;               // query n-tiles of S^T and dP^T
  constexpr int DT = DP / 8;               // head-dim n-tiles of dK and dV
  static_assert(DP % 16 == 0 && BQ % 16 == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BKV][LD]
  bf16* Vs = Ks + BKV * LD;                      // [BKV][LD]
  bf16* Qs = Vs + BKV * LD;                      // [BQ][LD]  q * scale * log2(e)
  bf16* Gs = Qs + BQ * LD;                       // [BQ][LD]  dO
  bf16* Qt = Gs + BQ * LD;                       // [DP][LT]  q^T
  bf16* Gt = Qt + DP * LT;                       // [DP][LT]  dO^T
  float* Ls = reinterpret_cast<float*>(Gt + DP * LT);  // [BQ] lse, log2 units
  float* Ds = Ls + BQ;                                 // [BQ] delta

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;  // mma fragment group / thread-in-group
  const int k0 = blockIdx.x * BKV, hh = blockIdx.y, b = blockIdx.z;
  const int H = sh.h, D = sh.d;
  const long long srow = (long long)H * D;
  const bf16* qb = q + ((long long)b * sh.sq * H + hh) * D;
  const bf16* gb = dout + ((long long)b * sh.sq * H + hh) * D;
  const bf16* kb = k + ((long long)b * sh.sk * H + hh) * D;
  const bf16* vb = v + ((long long)b * sh.sk * H + hh) * D;
  const float* lb = lse + ((long long)b * H + hh) * sh.sq;
  const float* db = delta + ((long long)b * H + hh) * sh.sq;

  stage<DP>(kb, srow, k0, BKV, sh.sk, D, Ks, LD, nullptr, 0, 0.f);
  stage<DP>(vb, srow, k0, BKV, sh.sk, D, Vs, LD, nullptr, 0, 0.f);

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  const bf16* krow0 = Ks + (16 * warp + g) * LD + 2 * tg;
  const bf16* krow1 = krow0 + 8 * LD;
  const bf16* vrow0 = Vs + (16 * warp + g) * LD + 2 * tg;
  const bf16* vrow1 = vrow0 + 8 * LD;

  for (int q0 = 0; q0 < sh.sq; q0 += BQ) {
    __syncthreads();  // K/V written (first tile); the q-side tiles free (later)
    stage<DP>(qb, srow, q0, BQ, sh.sq, D, Qs, LD, Qt, LT, qscale);
    stage<DP>(gb, srow, q0, BQ, sh.sq, D, Gs, LD, Gt, LT, 0.f);
    for (int r = threadIdx.x; r < BQ; r += kMmaThreads) {
      const bool ok = q0 + r < sh.sq;
      Ls[r] = ok ? lb[q0 + r] * kLog2e : 0.f;
      Ds[r] = ok ? db[q0 + r] : 0.f;
    }
    __syncthreads();

    // S^T = K Qs^T and dP^T = V dO^T: this warp's 16 keys x BQ queries
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      const uint32_t a0 = ld32(krow0 + kk), a1 = ld32(krow1 + kk);
      const uint32_t a2 = ld32(krow0 + kk + 8), a3 = ld32(krow1 + kk + 8);
      const uint32_t c0 = ld32(vrow0 + kk), c1 = ld32(vrow1 + kk);
      const uint32_t c2 = ld32(vrow0 + kk + 8), c3 = ld32(vrow1 + kk + 8);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const bf16* qp = Qs + (8 * j + g) * LD + kk + 2 * tg;
        mma_bf16_16816(st[j], a0, a1, a2, a3, ld32(qp), ld32(qp + 8));
        const bf16* gp = Gs + (8 * j + g) * LD + kk + 2 * tg;
        mma_bf16_16816(dpt[j], c0, c1, c2, c3, ld32(gp), ld32(gp + 8));
      }
    }
    // P^T and dS^T in place; element e of n-tile j is query 8j + 2tg + (e & 1)
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * tg + (e & 1);
        const float p = (q0 + col < sh.sq) ? exp2f(st[j][e] - Ls[col]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - Ds[col]);
      }

    // dV += P^T dO and dK += dS^T q, 16 queries per step
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      const uint32_t p0 = pack_bf16(st[2 * kq][0], st[2 * kq][1]);
      const uint32_t p1 = pack_bf16(st[2 * kq][2], st[2 * kq][3]);
      const uint32_t p2 = pack_bf16(st[2 * kq + 1][0], st[2 * kq + 1][1]);
      const uint32_t p3 = pack_bf16(st[2 * kq + 1][2], st[2 * kq + 1][3]);
      const uint32_t s0 = pack_bf16(dpt[2 * kq][0], dpt[2 * kq][1]);
      const uint32_t s1 = pack_bf16(dpt[2 * kq][2], dpt[2 * kq][3]);
      const uint32_t s2 = pack_bf16(dpt[2 * kq + 1][0], dpt[2 * kq + 1][1]);
      const uint32_t s3 = pack_bf16(dpt[2 * kq + 1][2], dpt[2 * kq + 1][3]);
#pragma unroll
      for (int jd = 0; jd < DT; ++jd) {
        const bf16* gp = Gt + (8 * jd + g) * LT + 16 * kq + 2 * tg;
        mma_bf16_16816(dva[jd], p0, p1, p2, p3, ld32(gp), ld32(gp + 8));
        const bf16* qp = Qt + (8 * jd + g) * LT + 16 * kq + 2 * tg;
        mma_bf16_16816(dka[jd], s0, s1, s2, s3, ld32(qp), ld32(qp + 8));
      }
    }
  }

  const int r0 = k0 + 16 * warp + g, r1 = r0 + 8;
  bf16* dkb = dk + ((long long)b * sh.sk * H + hh) * D;
  bf16* dvb = dv + ((long long)b * sh.sk * H + hh) * D;
#pragma unroll
  for (int jd = 0; jd < DT; ++jd) {
    const int c = 8 * jd + 2 * tg;  // D % 8 == 0: c < D implies c + 1 < D
    if (c >= D) continue;
    if (r0 < sh.sk) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + r0 * srow + c) =
          __floats2bfloat162_rn(dka[jd][0] * scale, dka[jd][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + r0 * srow + c) =
          __floats2bfloat162_rn(dva[jd][0], dva[jd][1]);
    }
    if (r1 < sh.sk) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + r1 * srow + c) =
          __floats2bfloat162_rn(dka[jd][2] * scale, dka[jd][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + r1 * srow + c) =
          __floats2bfloat162_rn(dva[jd][2], dva[jd][3]);
    }
  }
}

template <int DP, int BK>
constexpr size_t dq_mma_smem_bytes() {
  return sizeof(bf16) * (2 * (16 * kWarps) * (DP + 8) + 2 * BK * (DP + 8) + DP * (BK + 8));
}

// grid (ceil(Sq / 64), H, B): each warp owns 16 queries; loop over K/V tiles of BK
template <int DP, int BK>
__global__ void __launch_bounds__(kMmaThreads)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, Shape sh, float qscale, float scale) {
  constexpr int BQ = 16 * kWarps;
  constexpr int LD = DP + 8, LT = BK + 8;
  constexpr int NT = BK / 8;  // key n-tiles of S and dP
  constexpr int DT = DP / 8;  // head-dim n-tiles of dQ
  static_assert(DP % 16 == 0 && BK % 16 == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]  q * scale * log2(e)
  bf16* Gs = Qs + BQ * LD;                       // [BQ][LD]  dO
  bf16* Ks = Gs + BQ * LD;                       // [BK][LD]
  bf16* Vs = Ks + BK * LD;                       // [BK][LD]
  bf16* Kt = Vs + BK * LD;                       // [DP][LT]  K^T

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int q0 = blockIdx.x * BQ, hh = blockIdx.y, b = blockIdx.z;
  const int H = sh.h, D = sh.d;
  const long long srow = (long long)H * D;
  const bf16* qb = q + ((long long)b * sh.sq * H + hh) * D;
  const bf16* gb = dout + ((long long)b * sh.sq * H + hh) * D;
  const bf16* kb = k + ((long long)b * sh.sk * H + hh) * D;
  const bf16* vb = v + ((long long)b * sh.sk * H + hh) * D;
  const float* lb = lse + ((long long)b * H + hh) * sh.sq;
  const float* db = delta + ((long long)b * H + hh) * sh.sq;

  stage<DP>(qb, srow, q0, BQ, sh.sq, D, Qs, LD, nullptr, 0, qscale);
  stage<DP>(gb, srow, q0, BQ, sh.sq, D, Gs, LD, nullptr, 0, 0.f);
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;  // this thread's two query rows
  const float l0 = r0 < sh.sq ? lb[r0] * kLog2e : 0.f, l1 = r1 < sh.sq ? lb[r1] * kLog2e : 0.f;
  const float d0 = r0 < sh.sq ? db[r0] : 0.f, d1 = r1 < sh.sq ? db[r1] : 0.f;

  float dqa[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;
  const bf16* qrow0 = Qs + (16 * warp + g) * LD + 2 * tg;
  const bf16* qrow1 = qrow0 + 8 * LD;
  const bf16* grow0 = Gs + (16 * warp + g) * LD + 2 * tg;
  const bf16* grow1 = grow0 + 8 * LD;

  for (int k0 = 0; k0 < sh.sk; k0 += BK) {
    __syncthreads();  // q-side tiles written (first tile); K/V tiles free (later)
    stage<DP>(kb, srow, k0, BK, sh.sk, D, Ks, LD, Kt, LT, 0.f);
    stage<DP>(vb, srow, k0, BK, sh.sk, D, Vs, LD, nullptr, 0, 0.f);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      const uint32_t a0 = ld32(qrow0 + kk), a1 = ld32(qrow1 + kk);
      const uint32_t a2 = ld32(qrow0 + kk + 8), a3 = ld32(qrow1 + kk + 8);
      const uint32_t c0 = ld32(grow0 + kk), c1 = ld32(grow1 + kk);
      const uint32_t c2 = ld32(grow0 + kk + 8), c3 = ld32(grow1 + kk + 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bf16* kp = Ks + (8 * j + g) * LD + kk + 2 * tg;
        mma_bf16_16816(s[j], a0, a1, a2, a3, ld32(kp), ld32(kp + 8));
        const bf16* vp = Vs + (8 * j + g) * LD + kk + 2 * tg;
        mma_bf16_16816(dp[j], c0, c1, c2, c3, ld32(vp), ld32(vp + 8));
      }
    }
    // dS in place of s; elements 0, 1 are row g, elements 2, 3 row g + 8
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * tg + (e & 1);
        const float p = key < sh.sk ? exp2f(s[j][e] - (e < 2 ? l0 : l1)) : 0.f;
        s[j][e] = p * (dp[j][e] - (e < 2 ? d0 : d1));
      }
    // dQ += dS K, 16 keys per step
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int jd = 0; jd < DT; ++jd) {
        const bf16* kp = Kt + (8 * jd + g) * LT + 16 * kk + 2 * tg;
        mma_bf16_16816(dqa[jd], a0, a1, a2, a3, ld32(kp), ld32(kp + 8));
      }
    }
  }

  bf16* dqb = dq + ((long long)b * sh.sq * H + hh) * D;
#pragma unroll
  for (int jd = 0; jd < DT; ++jd) {
    const int c = 8 * jd + 2 * tg;
    if (c >= D) continue;
    if (r0 < sh.sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + r0 * srow + c) =
          __floats2bfloat162_rn(dqa[jd][0] * scale, dqa[jd][1] * scale);
    if (r1 < sh.sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + r1 * srow + c) =
          __floats2bfloat162_rn(dqa[jd][2] * scale, dqa[jd][3] * scale);
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

template <typename T>
cudaError_t launch_delta(const Args& a) {
  const long long rows = (long long)a.sh.b * a.sh.sq * a.sh.h;
  const int per_block = kSimtThreads / 32;
  delta_kernel<T><<<(unsigned)((rows + per_block - 1) / per_block), kSimtThreads, 0, a.st>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, a.sh);
  return cudaGetLastError();
}

template <int DP, int BQ, int BK>
cudaError_t launch_mma(const Args& a) {
  cudaError_t err = launch_delta<bf16>(a);
  if (err != cudaSuccess) return err;
  const bf16 *q = static_cast<const bf16*>(a.q), *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v), *g = static_cast<const bf16*>(a.dout);
  constexpr size_t s1 = dkdv_mma_smem_bytes<DP, BQ>(), s2 = dq_mma_smem_bytes<DP, BK>();
  auto k1 = dkdv_mma_kernel<DP, BQ>;
  auto k2 = dq_mma_kernel<DP, BK>;
  err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != cudaSuccess) return err;
  constexpr int R = 16 * kWarps;
  k1<<<dim3((a.sh.sk + R - 1) / R, a.sh.h, a.sh.b), kMmaThreads, s1, a.st>>>(
      q, k, v, g, a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.sh,
      a.qscale, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2<<<dim3((a.sh.sq + R - 1) / R, a.sh.h, a.sh.b), kMmaThreads, s2, a.st>>>(
      q, k, v, g, a.lse, a.delta, static_cast<bf16*>(a.dq), a.sh, a.qscale, a.scale);
  return cudaGetLastError();
}

template <int DPAD>
cudaError_t launch_simt(const Args& a) {  // the fp32 parity path
  constexpr int BR = 32, BC = 32;  // rows owned by a block, rows of a streamed tile
  cudaError_t err = launch_delta<float>(a);
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

}  // namespace

extern "C" {

const char* madm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// dtype: 0 = float32, 1 = bfloat16.  q, o, dout, dq: contiguous [B, Sq, H, D];
// k, v, dk, dv: contiguous [B, Sk, H, D]; lse (from the forward) and the
// scratch delta: contiguous fp32 [B, H, Sq].  D <= 160; bf16 also needs
// D % 8 == 0 and 16-byte aligned q, k, v, dout, dq, dk, dv.  Returns the
// cudaError_t of the launches (0 = success, cudaErrorInvalidValue for input
// outside these bounds); the kernels run on `stream`.
int madm_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse, void* delta,
                             void* dq, void* dk, void* dv, int b, int sq, int sk, int h, int d,
                             float scale, void* stream) {
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
               dq, dk, dv, Shape{b, sq, sk, h, d}, scale * kLog2e, scale,
               static_cast<cudaStream_t>(stream)};
  if (d < 1 || d > 160) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return static_cast<int>(launch_simt<160>(a));
  const bool mma = dtype == 1 && d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(dout) && aligned16(dq) && aligned16(dk) && aligned16(dv);
  if (!mma) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (d <= 48) err = launch_mma<48, 64, 64>(a);
  else if (d <= 80) err = launch_mma<80, 32, 64>(a);
  else err = launch_mma<160, 16, 32>(a);
  return static_cast<int>(err);
}

}  // extern "C"
