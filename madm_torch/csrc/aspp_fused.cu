// K2: the fused separable-ASPP fuse layer (eval BN) for Hopper (sm_90a).
//
// Replaces the TPU kernel madm_tpu/ops/aspp.py::_aspp_fused_kernel
// (pallas_call in aspp_fused).  For NHWC embeds e_0..e_{n-1} (each EC
// channels, C = n*EC in all) it writes the branch concat [B, H, W, 4*PC]:
//   branch 0:   relu((x @ a0_w) * a0_s + a0_b)                   (aspp_0, 1x1)
//   branch 1+i: relu((dw_i(x) @ pw_w[i]) * pw_s[i] + pw_b[i])    (d = dil[i])
//   dw_i(x) = T(relu(sum_{3x3 taps} w_i * x[y+ky*d, x+kx*d] + dw_b[i]))
// where x is the channel concat of the embeds (never built), the depthwise BN
// scale is folded into w_i in fp32 by the caller, taps outside the image read
// zero, and the depthwise output is rounded to the working type T before the
// pointwise product, as on the TPU.
//
// Bound on the H100: ~564 GFLOP per 512x512 image, almost all of it in the
// four C x PC pointwise products, against ~1 GB of embed reads and output
// writes: it is bound by operations.  The TPU kernel fed its matrix unit from
// a VMEM ring of rows; here each block owns one row segment of TP pixels and
// one branch, walks the C input channels in chunks of KC, builds that
// chunk's depthwise output (or, for branch 0, the raw embed values) straight
// into shared memory from global/L2 reads, stages the matching KC x PC slice
// of the pointwise weights beside it, and accumulates the TP x PC product in
// fp32 registers.  The 1024-channel concat and the depthwise outputs never
// reach device memory.  The tiling does not depend on W, so any width
// (including the sliding-window path's W=1024) takes the same kernel.
//
// bf16 (the model's type) streams each chunk's three input rows (y-d, y,
// y+d, with a d-column halo) and its weight slice into shared memory with
// 16-byte cp.async copies, double-buffered so the next chunk arrives while
// this one computes, takes the depthwise taps from shared memory, and runs
// the product on the tensor cores through
// WMMA 16x16x16 bf16 -> fp32 fragments: 8 warps, each a 32 pixel x 64 channel
// tile.  float32 (the parity path) gathers the taps from global memory and
// runs the product as SIMT fp32 FMA, each thread an 8 pixel x 8 channel tile,
// so that it keeps full fp32 precision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int TP = 64;         // pixels per block (one row segment)
constexpr int KC = 32;         // input channels per chunk
constexpr int PC = 256;        // output channels per branch
constexpr int kMaxEmbeds = 4;
constexpr int kMaxDilation = 24;  // halo of the bf16 kernel's staged input rows

struct Embeds {
  const void* p[kMaxEmbeds];
};

struct Params {
  Embeds embeds;
  const float* dw_w;  // [3][3][3][C], BN scale folded
  const float* dw_b;  // [3][C]
  const void* pw_w;   // [3][C][PC], type T
  const float* pw_s;  // [3][PC]
  const float* pw_b;
  const void* a0_w;   // [C][PC], type T
  const float* a0_s;  // [PC]
  const float* a0_b;
  void* out;          // [B][H][W][4*PC], type T
  int H, W, EC, C, d1, d2, d3;
};

// Where this block works: row y, pixels x0..x0+TP-1, one branch, one image.
struct Tile {
  int y, x0, branch, b, dil;
};

__device__ __forceinline__ Tile block_tile(const Params& p) {
  Tile t;
  const int tiles_per_row = (p.W + TP - 1) / TP;
  t.y = blockIdx.x / tiles_per_row;
  t.x0 = (blockIdx.x - t.y * tiles_per_row) * TP;
  t.branch = blockIdx.y;
  t.b = blockIdx.z;
  t.dil = t.branch == 1 ? p.d1 : (t.branch == 2 ? p.d2 : p.d3);
  return t;
}

// float32 body: the branch input of chunk channel `lane` (concat channel
// c0 + lane) at the 8 pixels warp + 8n of the tile, gathered from global memory.
__device__ __forceinline__ void gather_chunk(const Params& p, const Tile& t, int c0, int lane,
                                             int warp, float (&vals)[8]) {
  const int e = c0 / p.EC;
  const int ce = c0 - e * p.EC + lane;
  const int cc = c0 + lane;
  const float* src = static_cast<const float*>(p.embeds.p[e]) + (size_t)t.b * p.H * p.W * p.EC;
  if (t.branch == 0) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int x = t.x0 + warp + 8 * n;
      vals[n] = x < p.W ? src[((size_t)t.y * p.W + x) * p.EC + ce] : 0.f;
    }
    return;
  }
  const float* tap_w = p.dw_w + (size_t)(t.branch - 1) * 9 * p.C;
  float w9[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) w9[k] = tap_w[(size_t)k * p.C + cc];
  const float bias = p.dw_b[(size_t)(t.branch - 1) * p.C + cc];
#pragma unroll 2
  for (int n = 0; n < 8; ++n) {
    const int x = t.x0 + warp + 8 * n;
    float a = 0.f;
    if (x < p.W) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const int yy = t.y + (ky - 1) * t.dil;
        if (yy < 0 || yy >= p.H) continue;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int xx = x + (kx - 1) * t.dil;
          if (xx < 0 || xx >= p.W) continue;
          a = fmaf(w9[ky * 3 + kx], src[((size_t)yy * p.W + xx) * p.EC + ce], a);
        }
      }
      a = fmaxf(a + bias, 0.f);  // depthwise BN bias + ReLU
    }
    vals[n] = a;
  }
}

// ------------------------------------------------------------- float32 (SIMT)
__global__ void __launch_bounds__(kThreads) aspp_fused_simt_kernel(Params p) {
  constexpr int ALD = TP + 1;     // odd stride: the chunk build writes conflict-free
  __shared__ float As[KC * ALD];  // [KC][TP]
  __shared__ float Bs[KC * PC];   // [KC][PC]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Tile t = block_tile(p);
  const float* wsrc = t.branch == 0 ? static_cast<const float*>(p.a0_w)
                                    : static_cast<const float*>(p.pw_w) + (size_t)(t.branch - 1) * p.C * PC;
  float acc[8][8];  // pixels warp*8 + i, channels lane + 32*j
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < p.C; c0 += KC) {
    float vals[8];
    gather_chunk(p, t, c0, lane, warp, vals);
    __syncthreads();  // the previous chunk's product has read As/Bs
#pragma unroll
    for (int n = 0; n < 8; ++n) As[lane * ALD + warp + 8 * n] = vals[n];
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) Bs[kk * PC + tid] = wsrc[(size_t)(c0 + kk) * PC + tid];
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = As[kk * ALD + warp * 8 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = Bs[kk * PC + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  const float* sc = t.branch == 0 ? p.a0_s : p.pw_s + (t.branch - 1) * PC;
  const float* sh = t.branch == 0 ? p.a0_b : p.pw_b + (t.branch - 1) * PC;
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int x = t.x0 + warp * 8 + i;
    if (x >= p.W) continue;
    float* dst = out + (((size_t)t.b * p.H + t.y) * p.W + x) * (4 * PC) + t.branch * PC;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = lane + 32 * j;
      dst[n] = fmaxf(fmaf(acc[i][j], sc[n], sh[n]), 0.f);
    }
  }
}

// ------------------------------------------------------- bfloat16 (WMMA)
constexpr int ALDB = KC + 8;  // bf16 row strides: multiples of 8, rows 32-byte aligned
constexpr int BLDB = PC + 8;
constexpr int XCOLS = TP + 2 * kMaxDilation;  // halo columns of one input row
constexpr int XSIZE = 3 * XCOLS * KC;         // [row y-d, y, y+d][TP + 2d columns][KC]

// Shared memory of the bf16 kernel: two stages of (halo rows, weight slice)
// so that chunk c+1 streams in (cp.async) while chunk c computes.  The halo
// rows are dead by the epilogue, which reuses their space for staging.
struct WmmaSmem {
  union {
    __nv_bfloat16 X[2][XSIZE];
    float stage[8][16 * 16];  // per-warp epilogue tile
  };
  __nv_bfloat16 B[2][KC * BLDB];  // [KC][PC] weight slices
  __nv_bfloat16 A[TP * ALDB];     // [TP][KC] depthwise output of the chunk
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));  // src-size 0: the 16 bytes are zero-filled
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__global__ void __launch_bounds__(kThreads, 2) aspp_fused_wmma_kernel(Params p) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  WmmaSmem& sm = *reinterpret_cast<WmmaSmem*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1;   // pixels 32*wm .. +32
  const int wn = warp >> 1;  // channels 64*wn .. +64
  const Tile t = block_tile(p);
  const int d = t.branch == 0 ? 0 : t.dil;
  const int nrows = t.branch == 0 ? 1 : 3;  // branch 0 needs only row y
  const int ncols = TP + 2 * d;
  const __nv_bfloat16* wsrc =
      t.branch == 0 ? static_cast<const __nv_bfloat16*>(p.a0_w)
                    : static_cast<const __nv_bfloat16*>(p.pw_w) + (size_t)(t.branch - 1) * p.C * PC;

  // queue chunk c0's input rows and weight slice into stage s (16-byte copies)
  auto issue = [&](int c0, int s) {
    const int e = c0 / p.EC;
    const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(p.embeds.p[e]) +
                               (size_t)t.b * p.H * p.W * p.EC + (c0 - e * p.EC);
    for (int v = tid; v < nrows * ncols * (KC / 8); v += kThreads) {
      const int q8 = (v & 3) * 8, rc = v >> 2;
      const int r = rc / ncols, c = rc - r * ncols;
      const int row = nrows == 1 ? 1 : r;  // halo row index: 0 = y-d, 1 = y, 2 = y+d
      const int yy = t.y + (row - 1) * d, xx = t.x0 - d + c;
      const bool in = yy >= 0 && yy < p.H && xx >= 0 && xx < p.W;
      cp_async16(&sm.X[s][(row * XCOLS + c) * KC + q8],
                 in ? &src[((size_t)yy * p.W + xx) * p.EC + q8] : src, in);
    }
#pragma unroll
    for (int v = tid; v < KC * PC / 8; v += kThreads) {
      const int row = v / (PC / 8), col = (v % (PC / 8)) * 8;
      cp_async16(&sm.B[s][row * BLDB + col], &wsrc[(size_t)(c0 + row) * PC + col], true);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  issue(0, 0);
  for (int c0 = 0, s = 0; c0 < p.C; c0 += KC, s ^= 1) {
    __syncthreads();  // every warp is done with stage s^1 (chunk c0 - KC)
    if (c0 + KC < p.C) {
      issue(c0 + KC, s ^ 1);
      cp_async_wait<1>();  // chunk c0 has landed; c0 + KC stays in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const __nv_bfloat16* a_src = &sm.X[s][XCOLS * KC];  // branch 0: row y, as is
    int a_ld = KC;
    if (t.branch != 0) {
      // depthwise taps from shared memory: lane = channel, warp + 8n = pixel
      const int cc = c0 + lane;
      const float* tap_w = p.dw_w + (size_t)(t.branch - 1) * 9 * p.C + cc;
      float w9[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) w9[k] = tap_w[(size_t)k * p.C];
      const float bias = p.dw_b[(size_t)(t.branch - 1) * p.C + cc];
      const __nv_bfloat16* xs = sm.X[s];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int px = warp + 8 * n;
        float a = 0.f;
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
            a = fmaf(w9[r * 3 + kx], __bfloat162float(xs[(r * XCOLS + px + kx * d) * KC + lane]), a);
        // depthwise BN bias + ReLU, rounded to bf16 (taps beyond the image read zero)
        sm.A[px * ALDB + lane] = __float2bfloat16(fmaxf(a + bias, 0.f));
      }
      __syncthreads();
      a_src = sm.A;
      a_ld = ALDB;
    }
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a_src + (32 * wm + 16 * i) * a_ld + ks, a_ld);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], &sm.B[s][ks * BLDB + 64 * wn + 16 * j], BLDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  __syncthreads();  // every warp is done with X before it becomes staging space

  // epilogue: each 16x16 tile through the warp's staging buffer; a lane owns
  // 8 consecutive channels of one pixel and writes them as one 16-byte store
  const float* sc = t.branch == 0 ? p.a0_s : p.pw_s + (t.branch - 1) * PC;
  const float* sh = t.branch == 0 ? p.a0_b : p.pw_b + (t.branch - 1) * PC;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  const int r = lane >> 1, cq = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(sm.stage[warp], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int x = t.x0 + 32 * wm + 16 * i + r;
      const int n = 64 * wn + 16 * j + cq;
      if (x < p.W) {
        __align__(16) __nv_bfloat16 v8[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v8[e] = __float2bfloat16(fmaxf(fmaf(sm.stage[warp][r * 16 + cq + e], sc[n + e], sh[n + e]), 0.f));
        *reinterpret_cast<uint4*>(&out[(((size_t)t.b * p.H + t.y) * p.W + x) * (4 * PC) + t.branch * PC + n]) =
            *reinterpret_cast<const uint4*>(v8);
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" {

const char* madm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// dtype: 0 = float32, 1 = bfloat16 (embeds, pw_w, a0_w and out; the other
// parameters are float32).  Every tensor is contiguous and 16-byte aligned.
// Requires 1 <= n_embeds <= 4, ec % 32 == 0, dilations in [1, 24] and PC ==
// 256 output channels per branch (the caller checks).  Returns the cudaError_t of the launch.
int madm_aspp_fused(int dtype, const void* const* embeds, int n_embeds, const float* dw_w,
                    const float* dw_b, const void* pw_w, const float* pw_s, const float* pw_b,
                    const void* a0_w, const float* a0_s, const float* a0_b, void* out, int b,
                    int h, int w, int ec, int d1, int d2, int d3, void* stream) {
  const long long tiles = (long long)h * ((w + TP - 1) / TP);
  if (n_embeds < 1 || n_embeds > kMaxEmbeds || ec % KC != 0 || tiles > 0x7fffffffLL ||
      b > 65535 || d1 < 1 || d2 < 1 || d3 < 1 || d1 > kMaxDilation || d2 > kMaxDilation ||
      d3 > kMaxDilation)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  for (int i = 0; i < n_embeds; ++i) p.embeds.p[i] = embeds[i];
  p.dw_w = dw_w; p.dw_b = dw_b; p.pw_w = pw_w; p.pw_s = pw_s; p.pw_b = pw_b;
  p.a0_w = a0_w; p.a0_s = a0_s; p.a0_b = a0_b; p.out = out;
  p.H = h; p.W = w; p.EC = ec; p.C = n_embeds * ec; p.d1 = d1; p.d2 = d2; p.d3 = d3;
  const dim3 grid((unsigned)tiles, 4, b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    aspp_fused_simt_kernel<<<grid, kThreads, 0, st>>>(p);
  } else if (dtype == 1) {
    const int smem = static_cast<int>(sizeof(WmmaSmem));
    cudaError_t err = cudaFuncSetAttribute(aspp_fused_wmma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    aspp_fused_wmma_kernel<<<grid, kThreads, smem, st>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
