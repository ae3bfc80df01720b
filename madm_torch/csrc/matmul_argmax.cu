// K7: conv_seg + argmax of the eval head for Hopper (sm_90a).
//
// Replaces the TPU kernel madm_tpu/ops/aspp.py::_argmax_kernel (pallas_call
// in matmul_argmax).  For NHWC x [P pixels][C] it writes, per pixel, the
// first index of the largest of the NC logits x . w[:, k] + b[k], summed in
// fp32; the logits never reach device memory.  Padded classes never compete
// (masked to -inf, as on the TPU).
//
// Bound on the H100: at the eval head's shape (512x512 pixels, C = 256 bf16,
// 11 classes) it reads 134 MB and writes 1 MB for 1.5 GFLOP of products: it
// is bound by bytes (~0.040 ms at 3.35 TB/s).  On the fp32 CUDA cores the
// product costs ~190 warp instructions a pixel (4,096 FMAs, the bf16
// unpacking, 25 shuffles), and dispatching them alone takes about the byte
// bound.  The TPU kernel ran it on its matrix unit; so does the bf16 body
// here, with wgmma, which takes the arithmetic off the dispatch slots:
// - A persistent grid (one block an SM) walks tiles of 64 pixels.  A
//   producer warp brings each tile in by TMA as C/64 boxes [64 pixels][64
//   channels] of a 2-D map (C, P), 128-byte swizzled (pixels past P read
//   zeros), into a ring of up to 4 stages under full and empty mbarriers,
//   so the ring never drains between tiles.
// - conv_seg's fp32 weights are split in the prologue, in the kernel (by the
//   consumers, while the producer's first loads are in flight), into
//   bf16 halves w_hi = bf16(w) and w_lo = bf16(w - w_hi), and stored as one
//   K-major B operand [2 NCP classes][C], 128-byte swizzled: hi in rows
//   0..NCP-1, lo in NCP..2NCP-1 (NCP = 16, or 32 for 17-32 classes; padded
//   classes zero).  x is exact in bf16 and w_hi + w_lo carries w to ~2^-17
//   relative, so the logits are the fp32 twin's to far inside K7's
//   tolerance.
// - One consumer warpgroup runs wgmma m64n(2 NCP)k16 over K = C with fp32
//   accumulators.  A thread holds classes c and c + NCP of its two rows in
//   its own registers, so logit = acc_hi + acc_lo + bias is formed there;
//   the first-occurrence argmax is a scan over the thread's NCP/4 classes
//   in ascending order and two quad shuffles; the ids go out as int32.
// C must be a multiple of 64 (one swizzle span a box row).
//
// float32 (the parity path) keeps the SIMT body: conv_seg's weights, padded
// to NCP classes in fp32, sit in shared memory, and each warp owns groups
// of PIX = 64 / NCP pixels: a lane reads 16 bytes of channels of each pixel,
// sums its NCP partial dot products in fp32 registers, and the warp adds
// them up with a reduce-scatter of shuffles that leaves one class's logit in
// each lane, then takes the first-occurrence argmax over lanes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxSmem = 200 * 1024;

// 16 bytes of x, held raw and read as fp32 one channel at a time
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static uint4 load(const float* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static float get(const uint4& v, int j) {
    return __uint_as_float(j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w);
  }
};

// Shared weights: Ws[j][q][i] = w[q * VEC + j][i] for class i < NCP, with a
// row stride of NCP + 4 floats so that the 16-byte reads of 8 neighbouring
// lanes (neighbouring q) fall in distinct banks.
template <int NCP>
__host__ __device__ constexpr int ws_stride() { return NCP + 4; }

// pixels a warp sums at once: 64 fp32 accumulators a lane
template <int NCP>
__host__ __device__ constexpr int pix_per_group() { return 64 / NCP; }

// Reduce-scatter of a lane's N partial sums over the warp: at each step a
// lane keeps half of its classes (the upper half where `lane & mask`), adds
// its partner's sums of them, and hands the other half over.  One step per
// template level, so that every index is a constant and `a` stays in
// registers.  Afterwards lane L holds class L >> (5 - log2 NCP).
template <int NCP, int N = NCP>
__device__ __forceinline__ void reduce_scatter(float (&a)[NCP], int lane) {
  if constexpr (N > 1) {
    constexpr int n = N / 2, mask = 16 * N / NCP;
    const bool upper = (lane & mask) != 0;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float lo = a[i], hi = a[i + n];
      a[i] = (upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, upper ? lo : hi, mask);
    }
    reduce_scatter<NCP, n>(a, lane);
  }
}

template <typename T, int NCP>
__global__ void __launch_bounds__(kThreads, 2) matmul_argmax_kernel(const T* __restrict__ x,
                                                                 const float* __restrict__ w,
                                                                 const float* __restrict__ b,
                                                                 int* __restrict__ out, long long pixels,
                                                                 int C, int nc) {
  constexpr int VEC = Vec<T>::N;
  constexpr int WS = ws_stride<NCP>();
  constexpr int PIX = pix_per_group<NCP>();
  extern __shared__ __align__(16) float Ws[];
  const int NQ = C / VEC;  // 16-byte vectors per pixel
  for (int v = threadIdx.x; v < C * NCP; v += kThreads) {
    const int c = v / NCP, i = v - c * NCP;
    const int q = c / VEC, j = c - q * VEC;
    Ws[((size_t)j * NQ + q) * WS + i] = i < nc ? w[(size_t)c * nc + i] : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  // after the reduce-scatter lane holds class (lane >> shift); lanes that
  // differ only in the low `shift` bits hold the same class
  constexpr int kLog = NCP == 32 ? 5 : 4;
  constexpr int shift = 5 - kLog;
  const int cls = lane >> shift;
  const float bias = cls < nc ? b[cls] : 0.f;
  const long long groups = (pixels + PIX - 1) / PIX;
  const long long warp0 = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long nwarps = ((long long)gridDim.x * kThreads) >> 5;

  for (long long g = warp0; g < groups; g += nwarps) {
    const long long p0 = g * PIX;
    float acc[PIX][NCP];
#pragma unroll
    for (int k = 0; k < PIX; ++k)
#pragma unroll
      for (int i = 0; i < NCP; ++i) acc[k][i] = 0.f;

    for (int q = lane; q < NQ; q += 32) {
      uint4 xv[PIX];
#pragma unroll
      for (int k = 0; k < PIX; ++k)
        xv[k] = p0 + k < pixels ? Vec<T>::load(x + (size_t)(p0 + k) * C + q * VEC) : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float* wrow = &Ws[((size_t)j * NQ + q) * WS];
#pragma unroll
        for (int i = 0; i < NCP; i += 4) {
          const float4 wv = *reinterpret_cast<const float4*>(wrow + i);
#pragma unroll
          for (int k = 0; k < PIX; ++k) {
            const float xj = Vec<T>::get(xv[k], j);
            acc[k][i] = fmaf(xj, wv.x, acc[k][i]);
            acc[k][i + 1] = fmaf(xj, wv.y, acc[k][i + 1]);
            acc[k][i + 2] = fmaf(xj, wv.z, acc[k][i + 2]);
            acc[k][i + 3] = fmaf(xj, wv.w, acc[k][i + 3]);
          }
        }
      }
    }

#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      reduce_scatter<NCP>(acc[k], lane);
      float val = acc[k][0];  // class cls, summed over the lanes that differ in bits >= shift
#pragma unroll
      for (int mask = (1 << shift) >> 1; mask > 0; mask >>= 1) val += __shfl_xor_sync(0xffffffffu, val, mask);
      val = cls < nc ? val + bias : -INFINITY;
      // first-occurrence argmax over the lanes' (logit, class)
      int best = cls;
#pragma unroll
      for (int mask = 16; mask > 0; mask >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, val, mask);
        const int oc = __shfl_xor_sync(0xffffffffu, best, mask);
        if (ov > val || (ov == val && oc < best)) {
          val = ov;
          best = oc;
        }
      }
      if (lane == 0 && p0 + k < pixels) out[p0 + k] = best;
    }
  }
}

// The float32 body's grid: a warp a group of PIX pixels, 8 warps a block,
// at most two blocks an SM resident (its launch bounds), each warp then
// walking several groups
template <int NCP>
long long simt_blocks(long long pixels) {
  const long long warps_needed = (pixels + pix_per_group<NCP>() - 1) / pix_per_group<NCP>();
  const long long blocks = (warps_needed + kThreads / 32 - 1) / (kThreads / 32);
  return blocks < 2 * 132 ? blocks : 2 * 132;
}

template <int NCP>
int launch_simt(const void* x, const float* w, const float* b, int* out, long long pixels, int c, int nc,
                cudaStream_t st) {
  const int smem = c * ws_stride<NCP>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(matmul_argmax_kernel<float, NCP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  matmul_argmax_kernel<float, NCP><<<(unsigned)simt_blocks<NCP>(pixels), kThreads, smem, st>>>(
      static_cast<const float*>(x), w, b, out, pixels, c, nc);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- bfloat16: TMA + wgmma
using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int TM = 64;                   // pixels of a tile: one wgmma's rows
constexpr int WG_THREADS = 128 + 32;     // one consumer warpgroup, one producer warp
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;       // dynamic shared memory a block may use
constexpr int SM_COUNT = 132;            // H100 SXM

// The launch plan of the bf16 body; argmax_plan() in madm_torch/ops/aspp.py
// computes the same.  B operand [2 NCP][C] bf16 (w_hi over w_lo), then
// `stages` stages of a [64 pixels][C] tile, then the mbarriers.
struct ArgmaxPlan {
  int ncp, w_bytes, stage_bytes, stages, smem, tiles, grid;
};

inline ArgmaxPlan argmax_plan(long long pixels, int c, int nc) {
  ArgmaxPlan p{};
  p.ncp = nc <= 16 ? 16 : 32;
  p.w_bytes = 2 * p.ncp * c * 2;
  p.stage_bytes = TM * c * 2;
  const int room = SMEM_LIMIT - 1024 - p.w_bytes - 16 * MAX_STAGES;
  p.stages = room / p.stage_bytes < MAX_STAGES ? room / p.stage_bytes : MAX_STAGES;
  p.smem = 1024 + p.w_bytes + p.stages * p.stage_bytes + 16 * p.stages;
  const long long tiles = (pixels + TM - 1) / TM;
  p.tiles = tiles > 0x7fffffffLL ? 0x7fffffff : (int)tiles;
  p.grid = p.tiles < SM_COUNT ? p.tiles : SM_COUNT;
  return p;
}

struct ArgmaxArgs {
  const float* w;  // [C][nc]
  const float* b;  // [nc]
  int* out;        // [P]
  long long pixels;
  int c, nc, stages, tiles;
};

template <int NCP>
__global__ void __launch_bounds__(WG_THREADS, 1)
argmax_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ ArgmaxArgs a) {
  constexpr int N = 2 * NCP;  // wgmma columns: NCP hi, NCP lo
  const int nkc = a.c / 64;   // 64-channel chunks
  const int stage_bytes = nkc * TM * 128, w_bytes = nkc * N * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sW = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sX = sW + w_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sX + a.stages * stage_bytes);
  uint64_t* empty = full + a.stages;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 1);  // the consumer warpgroup's one arrival
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warp: one thread starts every load, from the start
    if (tid == 128) {
      for (int t = blockIdx.x, it = 0; t < a.tiles; t += gridDim.x, ++it) {
        const int s = it % a.stages, ph = (it / a.stages) & 1;
        mbar_wait(empty + s, ph ^ 1);
        mbar_expect_tx(full + s, stage_bytes);
        for (int kc = 0; kc < nkc; ++kc)
          tma_load(sX + s * stage_bytes + kc * TM * 128, &xmap, full + s, 64 * kc, t * TM, 0, 0, false);
      }
    }
    return;
  }

  // meanwhile the consumers put w_hi and w_lo into B, K-major: class row n
  // (n < NCP hi, else lo of class n - NCP), chunk kc, the 16-byte unit of
  // channels 8u..8u+7 at unit u ^ (n & 7); 8 loads in flight a thread
#pragma unroll 8
  for (int v = tid; v < N * a.c; v += 128) {
    const int k = v / N, n = v - k * N, cls = n % NCP;
    const float wv = cls < a.nc ? __ldg(a.w + (size_t)k * a.nc + cls) : 0.f;
    const bf16 hi = __float2bfloat16(wv);
    const bf16 val = n < NCP ? hi : __float2bfloat16(wv - __bfloat162float(hi));
    const int kc = k / 64, kk = k % 64;
    *reinterpret_cast<bf16*>(sW + kc * N * 128 + n * 128 + (((kk / 8) ^ (n & 7)) * 16) + (kk % 8) * 2) = val;
  }
  fence_async_smem();  // the weights become visible to wgmma
  named_sync(1, 128);

  // consumers: warp w holds pixel rows 16w + g and 16w + g + 8 of a tile,
  // classes 8j + 2tg + {0, 1} (hi in acc[4j..], lo in acc[4(j + NCP/8)..])
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tg = lane % 4;
  constexpr int NJ = NCP / 8;
  float bias[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cls = 8 * j + 2 * tg + e;
      bias[j][e] = cls < a.nc ? a.b[cls] : 0.f;
    }
  const uint32_t wb = smem_addr(sW);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int t = blockIdx.x, it = 0; t < a.tiles; t += gridDim.x, ++it) {
    const int s = it % a.stages;
    mbar_wait(full + s, (it / a.stages) & 1);
    const uint32_t xa = smem_addr(sX + s * stage_bytes);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll 4
    for (int k = 0; k < a.c / 16; ++k)
      wgmma_ss<N>(acc, desc(xa + (k / 4) * TM * 128 + (k % 4) * 32, 16),
                  desc(wb + (k / 4) * N * 128 + (k % 4) * 32, 16), k > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    if (tid == 0) mbar_arrive(empty + s);  // the stage goes back for the tile after next

    float best[2] = {-INFINITY, -INFINITY};
    int idx[2] = {0x7fffffff, 0x7fffffff};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cls = 8 * j + 2 * tg + e;  // ascending over (j, e); padded classes never compete
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g and g + 8
          const float v = acc[4 * j + 2 * h + e] + acc[4 * (j + NJ) + 2 * h + e] + bias[j][e];
          if (cls < a.nc && (v > best[h] || (v == best[h] && cls < idx[h]))) {
            best[h] = v;
            idx[h] = cls;
          }
        }
      }
#pragma unroll
    for (int m = 1; m <= 2; m *= 2)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float ov = __shfl_xor_sync(0xffffffffu, best[h], m);
        const int oi = __shfl_xor_sync(0xffffffffu, idx[h], m);
        if (ov > best[h] || (ov == best[h] && oi < idx[h])) {
          best[h] = ov;
          idx[h] = oi;
        }
      }
    if (tg == 0) {
      const long long p0 = (long long)t * TM + 16 * warp + g;
      if (p0 < a.pixels) a.out[p0] = idx[0];
      if (p0 + 8 < a.pixels) a.out[p0 + 8] = idx[1];
    }
  }
}

template <int NCP>
int launch_wgmma(const void* x, const float* w, const float* b, int* out, long long pixels, int c, int nc,
                 cudaStream_t st) {
  const ArgmaxPlan p = argmax_plan(pixels, c, nc);
  if (p.stages < 2 || pixels > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m;
  if (!cached_bf16_map(&m, x, 1, (int)pixels, 1, c, pixels * c, c, c, TM))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_smem_once<argmax_wgmma_kernel<NCP>>(p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ArgmaxArgs a{w, b, out, pixels, c, nc, p.stages, p.tiles};
  argmax_wgmma_kernel<NCP><<<p.grid, WG_THREADS, p.smem, st>>>(m, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* madm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// dtype: 0 = float32, 1 = bfloat16 (x); w [c][nc] and b [nc] are float32;
// out [pixels] int32.  x is contiguous and 16-byte aligned, 1 <= nc <= 32;
// float32: c a multiple of 4; bfloat16: c a multiple of 64 with at least two
// tile stages in shared memory (c <= 576 at 32 classes), pixels < 2^31 (the
// caller checks).  Returns the cudaError_t of the launch.
int madm_matmul_argmax(int dtype, const void* x, const float* w, const float* b, int* out,
                       long long pixels, int c, int nc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pixels <= 0 || c <= 0 || nc < 1 || nc > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    if (c % 4 != 0 || c * (nc <= 16 ? 20 : 36) * 4 > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    return nc <= 16 ? launch_simt<16>(x, w, b, out, pixels, c, nc, st)
                    : launch_simt<32>(x, w, b, out, pixels, c, nc, st);
  }
  if (dtype == 1) {
    if (c % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
    return nc <= 16 ? launch_wgmma<16>(x, w, b, out, pixels, c, nc, st)
                    : launch_wgmma<32>(x, w, b, out, pixels, c, nc, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch plan for a shape, for holding argmax_plan() to it: out = {body
// (0 SIMT, 1 TMA + wgmma), padded classes, threads, stages, dynamic shared
// memory bytes, grid, tiles}.  float32: the SIMT body's (no stages, no
// tiles; its grid at most two blocks an SM).
void madm_matmul_argmax_plan(int dtype, long long pixels, int c, int nc, int* out) {
  const int ncp = nc <= 16 ? 16 : 32;
  if (dtype == 1) {
    const ArgmaxPlan p = argmax_plan(pixels, c, nc);
    const int v[7] = {1, p.ncp, WG_THREADS, p.stages, p.smem, p.grid, p.tiles};
    for (int i = 0; i < 7; ++i) out[i] = v[i];
  } else {
    const int v[7] = {0, ncp, kThreads, 0, c * (ncp + 4) * 4,
                      (int)(ncp == 16 ? simt_blocks<16>(pixels) : simt_blocks<32>(pixels)), 0};
    for (int i = 0; i < 7; ++i) out[i] = v[i];
  }
}

}  // extern "C"
