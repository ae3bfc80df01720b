// K7: conv_seg + argmax of the eval head for Hopper (sm_90a).
//
// Replaces the TPU kernel madm_tpu/ops/aspp.py::_argmax_kernel (pallas_call
// in matmul_argmax).  For NHWC x [P pixels][C] it writes, per pixel, the
// first index of the largest of the NC logits x . w[:, k] + b[k], summed in
// fp32; the logits never reach device memory.
//
// Bound on the H100: at the eval head's shape (512x512 pixels, C = 256 bf16,
// 11 classes) it reads 134 MB and writes 1 MB for 1.5 GFLOP of products: it
// is bound by bytes (~0.040 ms at 3.35 TB/s).  The TPU kernel ran the product
// on its matrix unit with the classes padded to 128 lanes; here conv_seg's
// weights, padded to NCP = 16 or 32 classes in fp32, sit in shared memory,
// and each warp owns groups of PIX = 64 / NCP pixels: a lane reads 16 bytes
// of channels of each pixel (neighbouring lanes on neighbouring addresses), sums its
// NCP partial dot products in fp32 registers, and the warp adds them up
// with a reduce-scatter of shuffles that leaves one class's logit in each
// lane (NCP - 1 shuffles, not NCP x 5), then takes the first-occurrence
// argmax over lanes.  Each weight read from shared memory serves PIX pixels.
// Padded classes never compete (masked to -inf, as on the TPU).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxSmem = 200 * 1024;

// 16 bytes of x, held raw and widened to fp32 one channel at a time
template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static uint4 load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static float get(const uint4& v, int j) {  // j: compile-time
    const unsigned w = j < 2 ? v.x : j < 4 ? v.y : j < 6 ? v.z : v.w;
    return __uint_as_float(j % 2 ? (w & 0xffff0000u) : (w << 16));
  }
};
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

template <typename T, int NCP>
int launch(const void* x, const float* w, const float* b, int* out, long long pixels, int c, int nc,
           cudaStream_t st) {
  const int smem = c * ws_stride<NCP>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(matmul_argmax_kernel<T, NCP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, matmul_argmax_kernel<T, NCP>, kThreads, smem);
  const long long warps_needed = (pixels + pix_per_group<NCP>() - 1) / pix_per_group<NCP>();
  long long blocks = (warps_needed + kThreads / 32 - 1) / (kThreads / 32);
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;  // each warp then walks several pixel groups
  matmul_argmax_kernel<T, NCP><<<(unsigned)blocks, kThreads, smem, st>>>(static_cast<const T*>(x), w, b, out,
                                                                        pixels, c, nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* madm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// dtype: 0 = float32, 1 = bfloat16 (x); w [c][nc] and b [nc] are float32;
// out [pixels] int32.  x is contiguous and 16-byte aligned, c a multiple of
// 16 bytes' worth of x, 1 <= nc <= 32 (the caller checks).  Returns the
// cudaError_t of the launch.
int madm_matmul_argmax(int dtype, const void* x, const float* w, const float* b, int* out,
                       long long pixels, int c, int nc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = dtype == 0 ? 4 : 8;
  if (pixels <= 0 || c <= 0 || c % vec != 0 || nc < 1 || nc > 32 ||
      c * (nc <= 16 ? 20 : 36) * 4 > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    return nc <= 16 ? launch<float, 16>(x, w, b, out, pixels, c, nc, st)
                    : launch<float, 32>(x, w, b, out, pixels, c, nc, st);
  }
  if (dtype == 1) {
    return nc <= 16 ? launch<__nv_bfloat16, 16>(x, w, b, out, pixels, c, nc, st)
                    : launch<__nv_bfloat16, 32>(x, w, b, out, pixels, c, nc, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
