// K5: packed-head flash-attention backward for Hopper (sm_90a), its float32
// body.
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
// The bf16 body (every train step with flash_pack) is K3's TMA + wgmma
// kernels in flash_attention_bwd.cu, entered through
// madm_packed_attention_bwd_tma there: it starts from K4's saved output and
// row log-sum-exp instead of recomputing them, and takes delta =
// rowsum(dO * O) with K4's bf16 O (madm_torch/ops/flash_attention.py,
// packed_backward_from_stats_reference, states that arithmetic).
//
// This float32 body (the parity path and the toy widths) follows
// FlashAttention-2's split, without atomics and deterministic, one thread per
// (row, head), SIMT fp32 FMA:
//   1. dq kernel: parallel over q tiles of G heads; a first pass over the K/V
//      tiles finds each row's max, sum and delta = rowsum(dP * P) (online,
//      rescaled as the max moves) and writes the base-2 log-sum-exp and delta
//      to fp32 scratch [B, H, S]; a second pass accumulates dQ;
//   2. dkdv kernel: parallel over K/V tiles of G heads, loops over the q tiles
//      with their statistics and keeps dK/dV in registers.
// Bound on the H100: 10*H*S^2*D operations against ~8*S*H*D elements moved:
// bound by operations, which this body, off the tensor cores, is far from.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;  // rows a block owns (queries in dq, keys in dkdv)
constexpr int kTile = 32;  // rows of a streamed tile

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

}  // namespace

extern "C" {

const char* madm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, dout, dq, dk, dv: contiguous
// [B, S, H, D]; lse2 and delta: fp32 scratch [B, H, S] (written by the dq
// kernel, read by the dkdv kernel).  1 <= g <= 4, S % 64 == 0, D <= 64.
// Only dtype 0 runs here: bf16 goes to madm_packed_attention_bwd_tma
// (flash_attention_bwd.cu).
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
