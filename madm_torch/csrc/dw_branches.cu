// K6: dilated 3x3 depthwise convs + folded BN + ReLU for Hopper (sm_90a).
//
// Replaces the TPU kernel madm_tpu/ops/aspp.py::_dw_kernel (pallas_call in
// dw_branches).  For NHWC embeds e_0..e_{n-1} (each EC channels; x is their
// channel concat, C = n*EC, never built) and up to three dilations d_i it
// writes, for each i, out_i [B, H, W, C]:
//   out_i = T(relu((sum_{3x3 taps} w_i * x[y+ky*d_i, x+kx*d_i]) * scale_i + bias_i))
// summed in fp32 from fp32 taps, taps outside the image reading zero.
//
// Bound on the H100: a stencil of 18 operations per output against one read
// of x and one write of each out_i: at the 'full' head's shape (512x512,
// C = 1024 bf16, one dilation a call) 1.07 GB a call, ~0.32 ms at 3.35 TB/s,
// against 4.8 GFLOP, 0.072 ms at the 67 TFLOP/s of the fp32 CUDA cores (no
// tensor-core form).  It is bound by bytes.  The TPU kernel kept a ring of
// 2*18+8 rows of one 128-channel tile in VMEM; a Hopper block has 227 KB, so
// here a block owns one output row segment of TPX pixels, one slice of CS
// channels (128 bytes a pixel) and one dilation d, and stages only the three
// input rows it reads (y-d, y, y+d, each with a d-column halo: 38 KB at
// d = 18) in shared memory with 16-byte cp.async copies.  Its 9 taps then
// come from shared memory.  Blocks of one channel slice run in row order, so
// the rows a neighbour stages again are still in L2: each input byte crosses
// device memory about once a call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int TPX = 64;          // output pixels per block
constexpr int UNITS = 8;         // 16-byte units of a pixel's channel slice
constexpr int kMaxEmbeds = 4;
constexpr int kMaxDils = 3;
constexpr int kMaxDilation = 18;
constexpr int XCOLS = TPX + 2 * kMaxDilation;  // staged columns of one input row

struct Params {
  const void* embeds[kMaxEmbeds];
  const float* w;      // [n_dil][3][3][C]
  const float* scale;  // [n_dil][C]
  const float* bias;   // [n_dil][C]
  void* out[kMaxDils]; // each [B][H][W][C], type T
  int H, W, EC, C, dil[kMaxDils];
};

// 16 bytes of T to and from fp32: 8 bf16 or 4 float
template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&v)[8]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[4]) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));  // src-size 0: the 16 bytes are zero-filled
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4) dw_branches_kernel(Params p) {
  constexpr int VEC = Vec<T>::N;
  constexpr int CS = UNITS * VEC;  // channels of the block's slice
  __shared__ __align__(16) T X[3 * XCOLS * CS];  // [row y-d, y, y+d][column][channel]

  const int tiles_per_row = (p.W + TPX - 1) / TPX;
  const int y = blockIdx.x / tiles_per_row;
  const int x0 = (blockIdx.x - y * tiles_per_row) * TPX;
  const int slices = p.C / CS;
  const int di = blockIdx.y / slices;
  const int c0 = (blockIdx.y - di * slices) * CS;  // concat channel of the slice
  const int b = blockIdx.z;
  const int e = c0 / p.EC;
  // picked by branches, not by a run-time index, so that Params stays in
  // the constant bank instead of a local copy
  const void* embed = p.embeds[0];
  if (e == 1) embed = p.embeds[1];
  else if (e == 2) embed = p.embeds[2];
  else if (e == 3) embed = p.embeds[3];
  int d = p.dil[0];
  void* out_ptr = p.out[0];
  if (di == 1) { d = p.dil[1]; out_ptr = p.out[1]; }
  else if (di == 2) { d = p.dil[2]; out_ptr = p.out[2]; }
  const T* src = static_cast<const T*>(embed) + (size_t)b * p.H * p.W * p.EC + (c0 - e * p.EC);

  // stage rows y-d, y, y+d, columns x0-d .. x0+TPX+d-1 of the slice
  const int ncols = TPX + 2 * d;
  for (int v = threadIdx.x; v < 3 * ncols * UNITS; v += kThreads) {
    const int u = v % UNITS, rc = v / UNITS;
    const int r = rc / ncols, col = rc - r * ncols;
    const int yy = y + (r - 1) * d, xx = x0 - d + col;
    const bool in = yy >= 0 && yy < p.H && xx >= 0 && xx < p.W;
    cp_async16(&X[(r * XCOLS + col) * CS + u * VEC],
               in ? src + ((size_t)yy * p.W + xx) * p.EC + u * VEC : src, in);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  const int u = threadIdx.x % UNITS;
  const int cc = c0 + u * VEC;  // this thread's channels cc .. cc+VEC-1
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // a thread sums PPT pixels of one channel unit; a warp covers 4
  // neighbouring pixels x 8 units: 512 contiguous bytes of shared memory per
  // tap, 4 x 128 contiguous bytes of output per store.  Each tap's weights
  // are read once (L1-resident) for the PPT pixels: few registers, so that
  // enough blocks stay resident to keep the copies in flight.
  constexpr int PPT = TPX / (kThreads / UNITS);
  const int px0 = threadIdx.x / UNITS;
  float acc[PPT][VEC];
#pragma unroll
  for (int k = 0; k < PPT; ++k)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[k][j] = 0.f;
  const float* wp = p.w + (size_t)di * 9 * p.C + cc;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      float wv[VEC];
#pragma unroll
      for (int j = 0; j < VEC; j += 4) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(wp + (size_t)(r * 3 + kx) * p.C + j));
        wv[j] = f.x; wv[j + 1] = f.y; wv[j + 2] = f.z; wv[j + 3] = f.w;
      }
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        float xv[VEC];
        Vec<T>::load(&X[(r * XCOLS + px0 + k * (kThreads / UNITS) + kx * d) * CS + u * VEC], xv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[k][j] = fmaf(wv[j], xv[j], acc[k][j]);
      }
    }

  float sc[VEC], bi[VEC];
#pragma unroll
  for (int j = 0; j < VEC; j += 4) {
    const float4 s4 = __ldg(reinterpret_cast<const float4*>(p.scale + (size_t)di * p.C + cc + j));
    const float4 t4 = __ldg(reinterpret_cast<const float4*>(p.bias + (size_t)di * p.C + cc + j));
    sc[j] = s4.x; sc[j + 1] = s4.y; sc[j + 2] = s4.z; sc[j + 3] = s4.w;
    bi[j] = t4.x; bi[j + 1] = t4.y; bi[j + 2] = t4.z; bi[j + 3] = t4.w;
  }
  T* out = static_cast<T*>(out_ptr);
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int x = x0 + px0 + k * (kThreads / UNITS);
    if (x >= p.W) break;
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[k][j] = fmaxf(fmaf(acc[k][j], sc[j], bi[j]), 0.f);
    Vec<T>::store(out + (((size_t)b * p.H + y) * p.W + x) * p.C + cc, acc[k]);
  }
}

}  // namespace

extern "C" {

const char* madm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// dtype: 0 = float32, 1 = bfloat16 (embeds and outs; w, scale and bias are
// float32).  Every tensor is contiguous and 16-byte aligned.  Requires
// 1 <= n_embeds <= 4, 1 <= n_dil <= 3, dilations in [1, 18] and ec a
// multiple of the channel slice (64 bf16, 32 float32; the caller checks).
// Returns the cudaError_t of the launch.
int madm_dw_branches(int dtype, const void* const* embeds, int n_embeds, const float* w,
                     const float* scale, const float* bias, void* const* outs, int n_dil,
                     const int* dilations, int b, int h, int w_, int ec, void* stream) {
  const int cs = dtype == 0 ? UNITS * 4 : UNITS * 8;
  const long long tiles = (long long)h * ((w_ + TPX - 1) / TPX);
  const int c = n_embeds * ec;
  if ((dtype != 0 && dtype != 1) || n_embeds < 1 || n_embeds > kMaxEmbeds || n_dil < 1 ||
      n_dil > kMaxDils || ec % cs != 0 || tiles < 1 || tiles > 0x7fffffffLL || b < 1 || b > 65535 ||
      (long long)n_dil * (c / cs) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  for (int i = 0; i < n_embeds; ++i) p.embeds[i] = embeds[i];
  for (int i = 0; i < n_dil; ++i) {
    if (dilations[i] < 1 || dilations[i] > kMaxDilation) return static_cast<int>(cudaErrorInvalidValue);
    p.dil[i] = dilations[i];
    p.out[i] = outs[i];
  }
  p.w = w; p.scale = scale; p.bias = bias;
  p.H = h; p.W = w_; p.EC = ec; p.C = c;
  const dim3 grid((unsigned)tiles, (unsigned)(n_dil * (c / cs)), (unsigned)b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dw_branches_kernel<float><<<grid, kThreads, 0, st>>>(p);
  } else {
    dw_branches_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
