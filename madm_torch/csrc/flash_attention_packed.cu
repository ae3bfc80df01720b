// K4: packed-head flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel madm_tpu/ops/flash_attention.py::_packed_attn_kernel
// (pallas_call in _packed_fwd_impl).  Computes, for the self-attention shapes
// the packing rule picks (Sq == Sk, S % 512 == 0, D <= 64),
//   o = softmax(q k^T * scale) v
// on contiguous [B, S, H, D] tensors, G heads to a block.
//
// The TPU kernel packs G heads into one program so that its QK^T and PV dots
// fill 120 of the MXU's 128 lanes at D=40, at the price of block-diagonal
// K'/V' built in HBM (3x the K/V bytes, 3x the MACs on zeros).  None of that
// pays on Hopper, where the tensor-core tile is 16x8x16.  What a G-head block
// does buy here is locality: in [B, S, H, D] the G adjacent heads of a row
// are one contiguous run (240 bytes at G=3, D=40, against 80 for one head),
// so a block that owns one q tile of G heads stages its q, K and V tiles as
// whole [rows, G*D] slabs by cp.async (16-byte copies, double-buffered K/V),
// with D zero-padded to DP (40 -> 48) in shared memory only.  The last group
// may be ragged (H=8, G=3: heads 6-7): its missing head is neither loaded nor
// computed; nothing is padded in memory.
//
// Bound on the H100: 4*H*S^2*D operations against (4*S*H*D) elements moved,
// far above the ~295 ops/byte ridge: bound by operations.
//
// Rounding points follow the TPU kernel: q is scaled by scale*log2(e) and
// rounded to the input type before QK^T; the softmax runs in base 2 in fp32;
// the normaliser 1/sum is multiplied into P BEFORE the PV product and P is
// rounded to the input type (the TPU kernel's `(e_g * r).astype(q.dtype)`;
// K1 divides after PV instead).  Streaming K/V through shared memory cannot
// know the row sum before the first PV product, so each block makes two
// passes over the keys: the first finds the row max and sum, the second
// recomputes the scores and accumulates P V with the final normaliser.  That
// is 6 instead of 4 operations per (query, key, dim): the price of the TPU's
// rounding point.
//
// Two bodies:
// - bf16: tensor cores through mma.sync m16n8k16 (bf16 in, fp32 accumulate).
//   4 warps per head, 16 query rows each; a block is 64 rows x G heads
//   (128*G threads).  Q fragments live in registers for the whole kernel
//   (scaled there); K fragments are 32-bit loads from the row-major slab; V
//   fragments for PV come from the row-major slab by ldmatrix.trans.
// - float32 (the parity path and the toy widths): one thread per (query row,
//   head), K/V tiles shared through shared memory, SIMT fp32 FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBQ = 64;  // query rows of a block
constexpr int kBK = 64;  // keys of a streamed tile
constexpr int kWarpsPerHead = kBQ / 16;

// the most heads a block takes at a padded head dim: the packing rule's
// G = min(128 // D, 4) (4 warps a head, so at most 512 threads)
constexpr int max_group(int dp) { return dp <= 32 ? 4 : dp <= 48 ? 3 : 2; }

// ------------------------------------------------------------ primitives
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices, transposed: thread t gives the row address of
// matrix t/8, row t%8, and receives column t/4 of rows 2(t%4), 2(t%4)+1 of each
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo -> low half (lower column)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// a pair of bf16 times s in fp32, rounded back to bf16 (the TPU's q scaling)
__device__ __forceinline__ uint32_t scale_pair(uint32_t x, float s) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&x);
  return pack_bf16(__low2float(v) * s, __high2float(v) * s);
}

// cp.async of rows [r0, r0 + n) of the G-head group starting at head h0 into a
// [n][ls] slab, head j at column j*DP; only the first D columns of each valid
// head are written (the pad columns keep the zeros the block wrote at start)
template <int DP>
__device__ __forceinline__ void stage_slab(bf16* dst, int ls, const bf16* __restrict__ src,
                                           int b, int s, int r0, int n, int h, int h0, int gv,
                                           int d, int nthreads) {
  const int c8 = d / 8;  // 16-byte chunks of a head row
  const int per_row = gv * c8;
  const bf16* base = src + (((long long)b * s + r0) * h + h0) * d;
  for (int e = threadIdx.x; e < n * per_row; e += nthreads) {
    const int r = e / per_row, rem = e - r * per_row;
    const int j = rem / c8, c = rem - j * c8;
    cp_async16(dst + r * ls + j * DP + c * 8, base + (long long)r * h * d + rem * 8);
  }
}

// ------------------------------------------------------------ bf16 body
template <int DP>
__global__ void __launch_bounds__(128 * max_group(DP))
packed_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, int s, int h, int d,
                      int g, float qscale) {
  constexpr int NT = kBK / 8;  // score n-tiles per warp
  constexpr int DT = DP / 8;   // output n-tiles per warp
  constexpr int KS = DP / 16;  // k-steps over the head dim
  static_assert(DP % 16 == 0, "tile shape");
  const int ls = g * DP + 8;  // slab row stride: conflict-free fragment loads
  const int nthreads = blockDim.x;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][ls]
  bf16* Ks0 = Qs + kBQ * ls;                     // [2][kBK][ls]
  bf16* Vs0 = Ks0 + 2 * kBK * ls;                // [2][kBK][ls]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;  // mma fragment group / thread-in-group
  const int q0 = blockIdx.x * kBQ, h0 = blockIdx.y * g, b = blockIdx.z;
  const int gv = min(g, h - h0);  // heads of this (possibly ragged) group
  const int hj = warp / kWarpsPerHead, wr = 16 * (warp % kWarpsPerHead);
  const bool live = hj < gv;

  {  // zero the pad columns (and the ragged group's missing head) once
    uint4* p = reinterpret_cast<uint4*>(smem_raw);
    const int n16 = (kBQ + 4 * kBK) * ls * 2 / 16;
    for (int e = tid; e < n16; e += nthreads) p[e] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const int nt = s / kBK;  // tiles per pass; the wrapper guarantees S % 64 == 0
  stage_slab<DP>(Qs, ls, q, b, s, q0, kBQ, h, h0, gv, d, nthreads);
  stage_slab<DP>(Ks0, ls, k, b, s, 0, kBK, h, h0, gv, d, nthreads);
  cp_async_commit();

  uint32_t qf[KS][4];
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // rows gr and gr+8 of this warp
  float l0 = 0.f, l1 = 0.f;                       // this thread's share of the row sums
  float i0 = 0.f, i1 = 0.f;                       // 1 / row sums (second pass)

  // steps 0..nt-1: first pass (row max and sum, K only); nt..2nt-1: second pass
  for (int step = 0; step < 2 * nt; ++step) {
    const int buf = step & 1;
    const bf16* Ks = Ks0 + buf * kBK * ls;
    const bf16* Vs = Vs0 + buf * kBK * ls;
    if (step + 1 < 2 * nt) {  // prefetch the next step's tiles into the other buffer
      const int nxt = (step + 1) % nt;
      stage_slab<DP>(Ks0 + (buf ^ 1) * kBK * ls, ls, k, b, s, nxt * kBK, kBK, h, h0, gv, d,
                     nthreads);
      if (step + 1 >= nt)
        stage_slab<DP>(Vs0 + (buf ^ 1) * kBK * ls, ls, v, b, s, nxt * kBK, kBK, h, h0, gv, d,
                       nthreads);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (live) {
      if (step == 0) {
        const bf16* qr0 = Qs + (wr + gr) * ls + hj * DP + 2 * tg;
        const bf16* qr1 = qr0 + 8 * ls;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          qf[kk][0] = scale_pair(ld32(qr0 + 16 * kk), qscale);
          qf[kk][1] = scale_pair(ld32(qr1 + 16 * kk), qscale);
          qf[kk][2] = scale_pair(ld32(qr0 + 16 * kk + 8), qscale);
          qf[kk][3] = scale_pair(ld32(qr1 + 16 * kk + 8), qscale);
        }
      }
      float sc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const bf16* kp = Ks + (8 * j + gr) * ls + hj * DP + 16 * kk + 2 * tg;
          mma_bf16_16816(sc[j], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3], ld32(kp),
                         ld32(kp + 8));
        }
      }
      if (step < nt) {  // online row max and sum
        float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
          mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          ps0 += exp2f(sc[j][0] - n0) + exp2f(sc[j][1] - n0);
          ps1 += exp2f(sc[j][2] - n1) + exp2f(sc[j][3] - n1);
        }
        l0 = l0 * exp2f(m0 - n0) + ps0;
        l1 = l1 * exp2f(m1 - n1) + ps1;
        m0 = n0;
        m1 = n1;
        if (step == nt - 1) {  // whole row sums on every thread of the group
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            l0 += __shfl_xor_sync(0xffffffffu, l0, off);
            l1 += __shfl_xor_sync(0xffffffffu, l1, off);
          }
          i0 = 1.f / l0;
          i1 = 1.f / l1;
        }
      } else {  // P = exp2(s - m) / l rounded to bf16, then acc += P V
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint32_t a0 = pack_bf16(exp2f(sc[2 * kk][0] - m0) * i0, exp2f(sc[2 * kk][1] - m0) * i0);
          const uint32_t a1 = pack_bf16(exp2f(sc[2 * kk][2] - m1) * i1, exp2f(sc[2 * kk][3] - m1) * i1);
          const uint32_t a2 =
              pack_bf16(exp2f(sc[2 * kk + 1][0] - m0) * i0, exp2f(sc[2 * kk + 1][1] - m0) * i0);
          const uint32_t a3 =
              pack_bf16(exp2f(sc[2 * kk + 1][2] - m1) * i1, exp2f(sc[2 * kk + 1][3] - m1) * i1);
          const int key = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
          for (int jj = 0; jj < DT / 2; ++jj) {
            uint32_t bv[4];
            ldmatrix_x4_trans(bv, Vs + key * ls + hj * DP + 16 * jj + 8 * (lane >> 4));
            mma_bf16_16816(acc[2 * jj], a0, a1, a2, a3, bv[0], bv[1]);
            mma_bf16_16816(acc[2 * jj + 1], a0, a1, a2, a3, bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();  // this step's buffer is free for the prefetch two steps on
  }

  if (!live) return;
  const int r0 = q0 + wr + gr, r1 = r0 + 8;
  bf16* o0 = o + (((long long)b * s + r0) * h + h0 + hj) * d;
  bf16* o1 = o + (((long long)b * s + r1) * h + h0 + hj) * d;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int c = 8 * j + 2 * tg;  // d % 8 == 0: c < d implies c + 1 < d
    if (c >= d) continue;
    *reinterpret_cast<__nv_bfloat162*>(o0 + c) = __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    *reinterpret_cast<__nv_bfloat162*>(o1 + c) = __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
}

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

// ------------------------------------------------------------------ host
template <int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int b, int s, int h,
                       int d, int g, float qscale, cudaStream_t st) {
  if (g > max_group(DP)) return cudaErrorInvalidValue;
  const size_t smem = sizeof(bf16) * (kBQ + 4 * kBK) * (g * DP + 8);
  auto kern = packed_fwd_mma_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(s / kBQ, (h + g - 1) / g, b);
  kern<<<grid, 32 * kWarpsPerHead * g, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), s, h, d, g, qscale);
  return cudaGetLastError();
}

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
// 1 <= g <= 4 heads a block, S % 64 == 0, D <= 64; bf16 also needs D % 8 == 0
// and 16-byte aligned q, k, v, o.  Returns the cudaError_t of the launch
// (0 = success, cudaErrorInvalidValue for input outside these bounds); the
// kernel runs on `stream`.
int madm_packed_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                              int b, int s, int h, int d, int g, float scale, void* stream) {
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
    cudaError_t err;
    if (d <= 16) err = launch_mma<16>(q, k, v, o, b, s, h, d, g, qscale, st);
    else if (d <= 32) err = launch_mma<32>(q, k, v, o, b, s, h, d, g, qscale, st);
    else if (d <= 48) err = launch_mma<48>(q, k, v, o, b, s, h, d, g, qscale, st);
    else err = launch_mma<64>(q, k, v, o, b, s, h, d, g, qscale, st);
    return static_cast<int>(err);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (d <= 8) err = launch_simt<8>(q, k, v, o, b, s, h, d, g, qscale, st);
  else if (d <= 16) err = launch_simt<16>(q, k, v, o, b, s, h, d, g, qscale, st);
  else if (d <= 32) err = launch_simt<32>(q, k, v, o, b, s, h, d, g, qscale, st);
  else if (d <= 48) err = launch_simt<48>(q, k, v, o, b, s, h, d, g, qscale, st);
  else err = launch_simt<64>(q, k, v, o, b, s, h, d, g, qscale, st);
  return static_cast<int>(err);
}

}  // extern "C"
