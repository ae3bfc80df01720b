// K4: packed-head flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel madm_tpu/ops/flash_attention.py::_packed_attn_kernel
// (pallas_call in _packed_fwd_impl).  Computes, for the self-attention shapes
// the packing rule picks (Sq == Sk, S % 512 == 0, D <= 64),
//   o = softmax(q k^T * scale) v
// on contiguous [B, S, H, D] tensors, with the TPU kernel's rounding points:
// q is scaled by scale*log2(e) and rounded to the input type before QK^T;
// the softmax runs in base 2 in fp32; the normaliser 1/sum is multiplied
// into P BEFORE the PV product and P is rounded to the input type (the TPU
// kernel's `(e_g * r).astype(q.dtype)`; K1 divides after PV instead).
//
// The TPU kernel packs G heads into one program so that its QK^T and PV dots
// fill 120 of the MXU's 128 lanes at D=40, at the price of block-diagonal
// K'/V' built in HBM (3x the K/V bytes, 3x the MACs on zeros).  None of that
// pays on Hopper, where wgmma takes any multiple of 16 as its depth: G
// stays the routing decision (pack_group; the wrapper checks it), and the
// body takes one head a consumer warpgroup, as K1 does.
//
// Bound on the H100: 4*H*S^2*D operations against 4*S*H*D elements moved,
// far above the ~295 ops/byte ridge: bound by operations.  Streaming K/V
// through shared memory cannot know the row sum before the first PV product,
// so each block makes two passes over the keys: the first finds the row max
// and sum, the second recomputes the scores and accumulates P V with the
// final normaliser.  That is 6 instead of 4 operations per (query, key, dim)
// and two exponentials per score, which at D=40 cost about as much as the
// products: the price of the TPU's rounding point.
//
// Two bodies:
// - bf16: K1's TMA + wgmma body (flash_fwd_tma.cuh) in its two-pass mode: a
//   producer warp streams K tiles (pass 1), then K and V tiles (pass 2) by
//   TMA through mbarrier rings, 64 keys a tile; consumer warpgroups own 64
//   query rows each, two blocks an SM at D <= 48; D padded to 48 (or 80 for
//   D > 48) for the products.  It writes the fp32 row log-sum-exp
//   [B, H, S] in K1's convention when asked, so that K5's bf16 body (K3's
//   kernels, flash_attention_bwd.cu) starts from the forward's statistics.
//   No mma.sync.
// - float32 (the parity path and the toy widths): one thread per (query row,
//   head), G heads a block, K/V tiles shared through shared memory, SIMT fp32
//   FMA; no lse (the fp32 backward recomputes its statistics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_fwd_tma.cuh"

namespace {

constexpr int kBQ = 64;  // query rows of an fp32 block

// ------------------------------------------------------------ fp32 body
constexpr int kSimtBK = 32;

// one thread per (query row, head): block of 64 rows x G heads, K/V tiles of
// kSimtBK keys for the G heads through shared memory
template <int DP>
__global__ void __launch_bounds__(256)
packed_fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int s, int h, int d,
                       int g, float qscale) {
  extern __shared__ float fsmem[];
  float* Ks = fsmem;                      // [kSimtBK][g * DP]
  float* Vs = fsmem + kSimtBK * g * DP;   // [kSimtBK][g * DP]
  const int ld = g * DP;
  const int tid = threadIdx.x;
  const int hj = tid / kBQ, row = blockIdx.x * kBQ + tid % kBQ;
  const int h0 = blockIdx.y * g, b = blockIdx.z;
  const int gv = min(g, h - h0);
  const bool live = hj < gv;

  float qr[DP], acc[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    qr[c] = (live && c < d) ? q[(((long long)b * s + row) * h + h0 + hj) * d + c] * qscale : 0.f;
    acc[c] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f, inv = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < s; k0 += kSimtBK) {
      __syncthreads();
      for (int e = tid; e < kSimtBK * ld; e += blockDim.x) {
        const int r = e / ld, rem = e - r * ld, j = rem / DP, c = rem - j * DP;
        const bool ok = j < gv && c < d;
        const long long at = (((long long)b * s + k0 + r) * h + h0 + j) * d + c;
        Ks[e] = ok ? k[at] : 0.f;
        Vs[e] = (ok && pass == 1) ? v[at] : 0.f;
      }
      __syncthreads();
      if (!live) continue;
      for (int r = 0; r < kSimtBK; ++r) {
        const float* kr = Ks + r * ld + hj * DP;
        float sc = 0.f;
#pragma unroll
        for (int c = 0; c < DP; ++c) sc = fmaf(qr[c], kr[c], sc);
        if (pass == 0) {
          const float mn = fmaxf(m, sc);
          l = l * exp2f(m - mn) + exp2f(sc - mn);
          m = mn;
        } else {
          const float p = exp2f(sc - m) * inv;
          const float* vr = Vs + r * ld + hj * DP;
#pragma unroll
          for (int c = 0; c < DP; ++c) acc[c] = fmaf(p, vr[c], acc[c]);
        }
      }
    }
    inv = 1.f / l;
  }
  if (!live) return;
  float* orow = o + (((long long)b * s + row) * h + h0 + hj) * d;
#pragma unroll
  for (int c = 0; c < DP; ++c)
    if (c < d) orow[c] = acc[c];
}

// ------------------------------------------------------------ bf16 body
using namespace fwd_tma;

constexpr int kBK = 64;  // keys a tile: 85 registers a thread at D <= 48, so two blocks an SM

// K1's plan at Sq == Sk == S (D padding, rows and warpgroups a block) with
// K4's 64-key tiles; packed_forward_plan() in madm_torch/ops/flash_attention.py
// makes the same choice
FwdPlan packed_plan(int b, int s, int h, int d) {
  FwdPlan p = fwd_plan(b, s, s, h, d);
  p.bk = kBK;
  p.smem = p.dn == 48 ? (p.nwg == 1 ? tma_smem<48, kBK, 1, false, 2>() : tma_smem<48, kBK, 2, false, 2>())
                      : (p.nwg == 1 ? tma_smem<80, kBK, 1, false, 2>() : tma_smem<80, kBK, 2, false, 2>());
  return p;
}

cudaError_t dispatch_two_pass(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                              int s, int h, int d, float qscale, cudaStream_t st) {
  const FwdPlan p = packed_plan(b, s, h, d);
  const Strides t{(long long)s * h * d, (long long)h * d, d};  // contiguous [B, S, H, D]
#define ARGS p.nwg, q, k, v, o, lse, b, s, s, h, d, t, t, t, t, qscale, st
  return p.dn == 48 ? launch_tma_rows<48, kBK, true>(ARGS) : launch_tma_rows<80, kBK, true>(ARGS);
#undef ARGS
}

// ------------------------------------------------------------------ host
template <int DP>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o, int b, int s,
                        int h, int d, int g, float qscale, cudaStream_t st) {
  const size_t smem = sizeof(float) * 2 * kSimtBK * g * DP;
  auto kern = packed_fwd_simt_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(s / kBQ, (h + g - 1) / g, b);
  kern<<<grid, kBQ * g, smem, st>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                    static_cast<const float*>(v), static_cast<float*>(o), s, h,
                                    d, g, qscale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* madm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, o: contiguous [B, S, H, D];
// 1 <= g <= 4 heads a block (the float32 body's grouping; the bf16 body
// takes one head a warpgroup), S % 64 == 0, D <= 64.  lse: null, or (bf16
// only) a contiguous fp32 [B, H, S] for the row log-sum-exp.  bf16 also
// needs D % 8 == 0 and 16-byte aligned q, k, v, o.  Returns the cudaError_t
// of the launch (0 = success, cudaErrorInvalidValue for input outside these
// bounds); the kernel runs on `stream`.
int madm_packed_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                              void* lse, int b, int s, int h, int d, int g, float scale, void* stream) {
  const float qscale = scale * 1.4426950408889634f;  // fold log2(e): softmax in base 2
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g < 1 || g > 4 || d < 1 || d > 64 || s % kBQ != 0 || b < 1 || h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    const bool ok = d % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(o) % 16 == 0;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(dispatch_two_pass(q, k, v, o, static_cast<float*>(lse), b, s, h, d, qscale, st));
  }
  if (dtype != 0 || lse != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (d <= 8) err = launch_simt<8>(q, k, v, o, b, s, h, d, g, qscale, st);
  else if (d <= 16) err = launch_simt<16>(q, k, v, o, b, s, h, d, g, qscale, st);
  else if (d <= 32) err = launch_simt<32>(q, k, v, o, b, s, h, d, g, qscale, st);
  else if (d <= 48) err = launch_simt<48>(q, k, v, o, b, s, h, d, g, qscale, st);
  else err = launch_simt<64>(q, k, v, o, b, s, h, d, g, qscale, st);
  return static_cast<int>(err);
}

// The bf16 body's launch plan for a [B, S, H, D] self-attention, for holding
// packed_forward_plan() to it: out = {padded D, q rows a block, keys a tile,
// consumer warpgroups, D split over them (0), ring stages, dynamic shared
// memory bytes}.
void madm_packed_attention_fwd_plan(int b, int s, int h, int d, int* out) {
  const FwdPlan p = packed_plan(b, s, h, d);
  const int v[7] = {p.dn, p.bq, p.bk, p.nwg, p.splitd, p.stages, p.smem};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}

}  // extern "C"
