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
// Three bodies, chosen from the dtype and, in fp32, what TMA can address:
// - bf16 (every attention of the model): warp-specialised TMA + wgmma, the
//   body in flash_fwd_tma.cuh (its layouts are described there) in its
//   one-pass mode: online softmax in the accumulator registers, P as the
//   register A operand of O += P V, the output normalised after PV, as on
//   the TPU; the fp32 row log-sum-exp (natural log of the scaled scores)
//   goes to lse [B, H, Sq] when asked: K3 (flash_attention_bwd.cu)
//   recomputes P = exp(s - lse) from it.  K4 (flash_attention_packed.cu)
//   runs the same body in its two-pass mode.
// - float32 (the LDM extractor's default, fp32 eval, the toy parity
//   checks): the tensor cores in "3xTF32", the body in flash_fwd_tf32.cuh
//   (its bound, error argument, layouts and key split are described there),
//   for every call TMA can address: D % 4 == 0, 16-byte aligned bases and
//   stepped strides of a multiple of 4 elements.  It is bound by operations
//   (12 H Sq Sk D at 495 TFLOP/s): every fp32 product is at least three
//   tf32 products of hi and lo pieces (rounded to tf32; a third piece of q,
//   k and P where memory allows), each error below 2^-22 of the product,
//   and the tensor cores' sums are kept to one k-step before fp32 adds
//   them.  q * scale * log2(e) stays fp32; P is split in registers
//   and is PV's A operand; V is written transposed into Vt hi and lo tiles
//   (tf32 wgmma reads shared operands K-major only), K into hi and lo
//   copies of TMA's layout.  Where
//   the query tiles leave SMs idle (the VAE's single head of D=512 at B=1:
//   64 tiles), the keys are split over blocks into fp32 partials that a
//   combine kernel merges in split order; lse is written as the bf16 body
//   writes it.  The wrapper hands the partials' workspace in (`work`).
//   What TMA cannot address (D % 4 != 0, a misaligned base or stride) runs
//   the SIMT body below: fp32 FMA on a 16x16 thread grid, register tiles of
//   RI query rows x CJ keys and RI rows x DJ head columns (D=512 in 32-row
//   tiles); madm_flash_attention_fwd_f32_plan says which.  A launch either
//   body refuses returns its error: nothing falls back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <chrono>

#include "flash_fwd_tf32.cuh"
#include "flash_fwd_tma.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16: tx = key / head-dim lane, ty = query lane
using fwd_tma::kLn2;
using fwd_tma::Strides;

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
// (flash_fwd_tma.cuh, in its one-pass mode)
using namespace fwd_tma;

cudaError_t dispatch_tma(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                         int sq, int sk, int h, int d, Strides qs, Strides ks, Strides vs, Strides os,
                         float qscale, cudaStream_t st) {
#define ARGS p.nwg, q, k, v, o, lse, b, sq, sk, h, d, qs, ks, vs, os, qscale, st
  const FwdPlan p = fwd_plan(b, sq, sk, h, d);
  if (p.splitd)
    return launch_tma<512, 64, 2, true, 1, false>(q, k, v, o, lse, b, sq, sk, h, d, qs, ks, vs, os, qscale, st);
  if (p.dn == 48) return p.bk == 80 ? launch_tma_rows<48, 80, false>(ARGS) : launch_tma_rows<48, 128, false>(ARGS);
  if (p.dn == 80) return p.bk == 80 ? launch_tma_rows<80, 80, false>(ARGS) : launch_tma_rows<80, 128, false>(ARGS);
  return p.bk == 80 ? launch_tma_rows<160, 80, false>(ARGS) : launch_tma_rows<160, 64, false>(ARGS);
#undef ARGS
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

// launches of each body since the library was loaded (0: fp32 SIMT, 1: fp32
// 3xTF32, 2: bf16), so that a check can tell which body a call took
long long body_launches[3] = {0, 0, 0};

// the fp32 body's plan: the TMA body where TMA can address q, k and v
fwd_tf32::F32Plan f32_plan_of(int b, int sq, int sk, int h, int d, const void* q, const void* k, const void* v,
                              const Strides& qs, const Strides& ks, const Strides& vs) {
  const bool tma = fwd_tf32::f32_addressable(b, h, d, q, qs) && fwd_tf32::f32_addressable(b, h, d, k, ks) &&
                   fwd_tf32::f32_addressable(b, h, d, v, vs);
  return fwd_tf32::f32_plan(b, sq, sk, h, d, tma);
}

}  // namespace

extern "C" {

const char* madm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  lse is null
// or a contiguous fp32 [B, H, Sq]; o is contiguous.  work is the fp32
// body's workspace, work_bytes long: at least the bytes
// madm_flash_attention_fwd_f32_plan returns (null and 0 where that is 0;
// a shorter one is refused).  bf16 needs what TMA needs: D % 8 == 0, 16-byte
// aligned bases, S and B strides of a multiple of 8 elements, and heads
// side by side (head stride D) or a head stride of a multiple of 8.
// Returns the cudaError_t of the launch (0 = success, cudaErrorInvalidValue
// for input outside these bounds); the kernels run on `stream`.
int madm_flash_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                             void* lse, void* work, long long work_bytes, int b, int sq, int sk, int h,
                             int d,
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
  if (d < 1 || d > 512) {
    err = cudaErrorInvalidValue;
  } else if (dtype == 0) {
    const fwd_tf32::F32Plan p = f32_plan_of(b, sq, sk, h, d, q, k, v, qs, ks, vs);
    err = p.tma ? fwd_tf32::dispatch_tf32(p, q, k, v, o, static_cast<float*>(lse), work, work_bytes, b, sq, sk, h,
                                          d, qs, ks, vs, os, qscale, st)
                : dispatch_simt(q, k, v, o, static_cast<float*>(lse), b, sq, sk, h, d, qs, ks, vs, os, qscale, st);
    if (err == cudaSuccess) ++body_launches[p.tma];
  } else if (dtype == 1 && d % 8 == 0) {
    err = dispatch_tma(q, k, v, o, static_cast<float*>(lse), b, sq, sk, h, d, qs, ks, vs, os, qscale, st);
    if (err == cudaSuccess) ++body_launches[2];
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The fp32 plan for tensors at q, k, v with these strides, for holding
// forward_plan() to it: out = {TMA body (1) or SIMT (0), padded D, q rows a
// block, keys a tile, consumer warpgroups, D split over them, ring stages,
// key splits, dynamic shared memory bytes}; returns the workspace bytes.
long long madm_flash_attention_fwd_f32_plan(int b, int sq, int sk, int h, int d, const void* q, const void* k,
                                            const void* v, long long q_sb, long long q_ss, long long q_sh,
                                            long long k_sb, long long k_ss, long long k_sh,
                                            long long v_sb, long long v_ss, long long v_sh, int* out) {
  const fwd_tf32::F32Plan p = f32_plan_of(b, sq, sk, h, d, q, k, v, Strides{q_sb, q_ss, q_sh},
                                          Strides{k_sb, k_ss, k_sh}, Strides{v_sb, v_ss, v_sh});
  const int x[9] = {p.tma, p.dn, p.bq, p.bk, p.nwg, p.splitd, p.stages, p.nsplit, p.smem};
  for (int i = 0; i < 9; ++i) out[i] = x[i];
  return p.ws;
}

// out = launches of each body since the library was loaded: {fp32 SIMT,
// fp32 3xTF32, bf16}
void madm_flash_attention_body_counts(long long* out) {
  for (int i = 0; i < 3; ++i) out[i] = body_launches[i];
}

// The bf16 body's launch plan for a shape, for holding attention_plan() to
// it: out = {padded D, q rows a block, keys a tile, consumer warpgroups,
// D split over them, ring stages, dynamic shared memory bytes}.
void madm_flash_attention_fwd_plan(int b, int sq, int sk, int h, int d, int* out) {
  const FwdPlan p = fwd_plan(b, sq, sk, h, d);
  const int v[7] = {p.dn, p.bq, p.bk, p.nwg, p.splitd, p.stages, p.smem};
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
