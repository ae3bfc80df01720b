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
// tensor-core form).  It is bound by bytes.
//
// The bf16 body (the model's type) is the TPU kernel's rolling ring, on TMA.
// The TPU kernel read x from HBM once by keeping a ring of rows in VMEM and
// walking down the image in its sequential grid axis; here a block walks
// down a chain of rows in a loop:
// - Work unit: a strip of TPX = 128 output columns x one 64-channel slice x
//   one dilation d x one residue class r of rows mod d (of one image).  The
//   rows y = r, r + d, r + 2d, ... are a chain, and the three rows that an
//   output row y reads (y - d, y, y + d) lie on its own chain.  Each input
//   row of the chain is loaded once, by thread 0, as one TMA box [64
//   channels][TPX + 2d columns] of a rank-4 map (EC, W, H, B) of its embed
//   (K2's map, hopper::embed_map, unswizzled; columns past either edge of
//   the image read zeros), into a ring of SLOTS row slots under full and
//   empty mbarriers, SLOTS - 1 rows ahead.  Rows above or below the image
//   are never loaded: they would add zeros.
// - An input byte crosses from L2 into an SM (TPX + 2d) / TPX times (1.09
//   at d = 6, 1.28 at d = 18); a block that staged the three rows of one
//   output row segment of 64 pixels would bring each row in three times
//   with its halo, 3.56-4.69 times.  The strips of
//   a chain run side by side (the strip is the fastest block index), so
//   the halo columns that two strips share are read by both at about the
//   same time, once from device memory.
// - Registers: a thread owns one 16-byte vector (8 channels) of COLS = 4
//   columns (c, c + 32, c + 64, c + 96 of the strip) and holds fp32
//   accumulators for the three output rows that a staged row feeds (its
//   chain's j - 1, j, j + 1, through tap rows ky = 2, 1, 0), rotated by a
//   loop unrolled three ways so that every register index is static.  Each
//   staged vector is read from shared memory 3 times (once a kx tap), not 9,
//   and its 72 fp32 taps stay in registers for the whole chain.  A warp
//   reads 4 neighbouring pixels x 128 bytes: no bank conflicts.
// - When a row has had its last input row, BN + ReLU in fp32, rounded to
//   bf16 and stored by 16-byte stores straight from the registers (a warp
//   writes 4 pixels x 128 contiguous bytes); columns past W are not stored.
// - Block order: strip, then residue, segment, slice, image; the dilations
//   of a call one after another.  Where the chains are too few to fill the
//   card (fewer than 2 x 132 units, as at d = 1), each is cut into segments
//   of at least 8 rows, each re-staging its two edge rows.
// 256 threads, one block an SM (its registers), 123 KB of ring.
//
// float32 (the parity path) is a SIMT body: a block owns one output row
// segment of 64 pixels, a 32-channel slice and one dilation, and stages the
// three input rows it reads with 16-byte cp.async copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int TPX = 64;          // output pixels per block
constexpr int UNITS = 8;         // 16-byte units of a pixel's channel slice
constexpr int kMaxEmbeds = 4;
constexpr int kMaxDils = 3;
constexpr int kMaxDilation = 18;
constexpr int XCOLS = TPX + 2 * kMaxDilation;  // staged columns of one input row

// ------------------------------------------------------------- float32 (SIMT)
struct Params {
  const void* embeds[kMaxEmbeds];
  const float* w;      // [n_dil][3][3][C]
  const float* scale;  // [n_dil][C]
  const float* bias;   // [n_dil][C]
  void* out[kMaxDils]; // each [B][H][W][C], type T
  int H, W, EC, C, dil[kMaxDils];
};

// 16 bytes of T to and from fp32
template <typename T>
struct Vec;
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
  // neighbouring pixels x 8 units
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

// ------------------------------------------------- bfloat16: chains on TMA
using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int CH_TPX = 128;                     // output columns of a strip
constexpr int CH_THREADS = 256;
constexpr int CH_STEP = CH_THREADS / 8;         // 32: a thread's columns c, c + 32, ...
constexpr int CH_COLS = CH_TPX / CH_STEP;       // 4 columns a thread
constexpr int SLOTS = 6;                        // ring of input rows
constexpr int SLOT_BYTES = (CH_TPX + 2 * kMaxDilation) * 128;  // one box [164 columns][64 channels]
constexpr int BAR_OFF = SLOTS * SLOT_BYTES;
constexpr int CH_SMEM = 128 + BAR_OFF + 16 * SLOTS;  // + 128 to align the base
constexpr int SM_COUNT = 132;                   // H100 SXM
constexpr int TARGET_UNITS = 2 * SM_COUNT;      // units below which chains are cut
constexpr int MIN_SEG_ROWS = 8;
static_assert(SLOT_BYTES % 128 == 0 && CH_TPX + 2 * kMaxDilation <= 256, "TMA box");

// The launch plan of the bf16 body; dw_plan() in madm_torch/ops/aspp.py
// computes the same.  Dilation i has res[i] = min(d, H) chains a (strip,
// slice, image), each cut into nseg[i] segments of seg_rows[i] chain rows
// (the last segments of a short chain may be empty), units[i] blocks in
// all; the grid is their sum.
struct ChainPlan {
  int strips, slices, res[kMaxDils], nseg[kMaxDils], seg_rows[kMaxDils], units[kMaxDils];
  long long grid;
};

inline ChainPlan chain_plan(int b, int h, int w, int c, int n_dil, const int* dil) {
  ChainPlan p{};
  p.strips = (w + CH_TPX - 1) / CH_TPX;
  p.slices = c / 64;
  long long base = 0;
  for (int i = 0; i < n_dil; ++i) {
    p.res[i] = dil[i] < h ? dil[i] : h;
    base += (long long)b * p.slices * p.strips * p.res[i];
  }
  const long long want = base >= TARGET_UNITS || base == 0 ? 1 : (TARGET_UNITS + base - 1) / base;
  for (int i = 0; i < n_dil; ++i) {
    const int l = h > dil[i] ? (h + dil[i] - 1) / dil[i] : 1;  // the longest chain: residue 0
    const int cap = l / MIN_SEG_ROWS > 1 ? l / MIN_SEG_ROWS : 1;  // segments of >= MIN_SEG_ROWS rows
    const int n = want < cap ? (int)want : cap;
    p.seg_rows[i] = (l + n - 1) / n;
    p.nseg[i] = (l + p.seg_rows[i] - 1) / p.seg_rows[i];
    const long long u = (long long)b * p.slices * p.strips * p.res[i] * p.nseg[i];
    p.units[i] = u > 0x7fffffffLL ? 0x7fffffff : (int)u;
    p.grid += u;
  }
  return p;
}

struct ChainMaps {
  CUtensorMap x[kMaxEmbeds][kMaxDils];  // embed e as dilation i reads it: boxes [64][TPX + 2 d_i]
};

struct ChainArgs {
  const float* w;      // [n_dil][3][3][C]
  const float* scale;  // [n_dil][C]
  const float* bias;
  bf16* out[kMaxDils];
  int H, W, EC, C, n_dil, strips, slices;
  int dil[kMaxDils], res[kMaxDils], nseg[kMaxDils], seg_rows[kMaxDils], units[kMaxDils];
};

__global__ void __launch_bounds__(CH_THREADS, 1)
dw_chain_kernel(const __grid_constant__ ChainMaps maps, const __grid_constant__ ChainArgs a) {
  // which unit: dilation, then strip, residue, segment, slice, image
  int u = blockIdx.x, di = 0;
  while (di + 1 < a.n_dil && u >= a.units[di]) u -= a.units[di++];
  const int d = a.dil[di];
  const int strip = u % a.strips;
  u /= a.strips;
  const int r = u % a.res[di];
  u /= a.res[di];
  const int seg = u % a.nseg[di];
  u /= a.nseg[di];
  const int slice = u % a.slices, b = u / a.slices;
  // output chain rows k0 .. k1-1 (image rows r + k d); input rows j0 .. j0+n-1
  const int len = (a.H - r + d - 1) / d;
  const int k0 = seg * a.seg_rows[di];
  if (k0 >= len) return;
  const int k1 = min(k0 + a.seg_rows[di], len);
  const int j0 = max(k0 - 1, 0), n = min(k1, len - 1) - j0 + 1;
  const int e = slice * 64 / a.EC, ce = slice * 64 - e * a.EC, x0 = strip * CH_TPX;
  const CUtensorMap* xm = &maps.x[e][di];

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + BAR_OFF);
  uint64_t* empty = full + SLOTS;
  const int tid = threadIdx.x, lane = tid % 32;
  const int uu = tid % 8, cc = tid / 8;  // channel vector and first column of this thread
  if (tid == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CH_THREADS / 32);  // one arrival a warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const uint32_t box_bytes = (CH_TPX + 2 * d) * 128;
  auto load_row = [&](int i) {  // chain row j0 + i into slot i % SLOTS
    uint64_t* bar = full + i % SLOTS;
    mbar_expect_tx(bar, box_bytes);
    tma_load(sm + (i % SLOTS) * SLOT_BYTES, xm, bar, ce, x0 - d, r + (j0 + i) * d, b, true);
  };
  if (tid == 0)
    for (int i = 0; i < SLOTS && i < n; ++i) load_row(i);

  // taps of this thread's 8 channels, and their BN
  const int ch = slice * 64 + uu * 8;
  float tw[9][8], sc[8], bi[8];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int q = 0; q < 8; q += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(a.w + ((size_t)di * 9 + t) * a.C + ch + q));
      tw[t][q] = f.x; tw[t][q + 1] = f.y; tw[t][q + 2] = f.z; tw[t][q + 3] = f.w;
    }
#pragma unroll
  for (int q = 0; q < 8; q += 4) {
    const float4 s4 = __ldg(reinterpret_cast<const float4*>(a.scale + (size_t)di * a.C + ch + q));
    const float4 b4 = __ldg(reinterpret_cast<const float4*>(a.bias + (size_t)di * a.C + ch + q));
    sc[q] = s4.x; sc[q + 1] = s4.y; sc[q + 2] = s4.z; sc[q + 3] = s4.w;
    bi[q] = b4.x; bi[q + 1] = b4.y; bi[q + 2] = b4.z; bi[q + 3] = b4.w;
  }
  float acc[3][CH_COLS][8];  // output rows by (chain row - j0) mod 3
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int i = 0; i < CH_COLS; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[q][i][k] = 0.f;

  bf16* const out = a.out[di] + ch;
  // BN + ReLU of output chain row k, rounded to bf16, 16 bytes a column
  auto finish = [&](float (&v)[CH_COLS][8], int k) {
    bf16* o = out + (size_t)(b * a.H + r + k * d) * a.W * a.C;
#pragma unroll
    for (int i = 0; i < CH_COLS; ++i) {
      const int x = x0 + cc + CH_STEP * i;
      uint4 raw;
      uint32_t* h = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        h[q] = pack_bf16(fmaxf(fmaf(v[i][2 * q], sc[2 * q], bi[2 * q]), 0.f),
                         fmaxf(fmaf(v[i][2 * q + 1], sc[2 * q + 1], bi[2 * q + 1]), 0.f));
      if (x < a.W) *reinterpret_cast<uint4*>(o + (size_t)x * a.C) = raw;
    }
  };

  // step i: chain row j = j0 + i feeds output rows j - 1 (taps ky = 2), j
  // (ky = 1) and j + 1 (ky = 0), held in acc[(P + 2) % 3], acc[P] and
  // acc[(P + 1) % 3] with P = i % 3
  auto step = [&](auto phase, int i) {
    constexpr int P = decltype(phase)::value, A = (P + 2) % 3, N = (P + 1) % 3;
    // thread 0 refills the slot that row i - 1 freed with row i - 1 + SLOTS
    if (tid == 0 && i > 0 && i - 1 + SLOTS < n) {
      mbar_wait(empty + (i - 1) % SLOTS, ((i - 1) / SLOTS) & 1);
      load_row(i - 1 + SLOTS);
    }
    __syncwarp();
    const int s = i % SLOTS;
    mbar_wait(full + s, (i / SLOTS) & 1);
    const unsigned char* row = sm + s * SLOT_BYTES + cc * 128 + uu * 16;
#pragma unroll
    for (int ci = 0; ci < CH_COLS; ++ci)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const uint4 raw = *reinterpret_cast<const uint4*>(row + (CH_STEP * ci + kx * d) * 128);
        const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float xv = __uint_as_float(k % 2 ? (wd[k / 2] & 0xffff0000u) : (wd[k / 2] << 16));
          acc[A][ci][k] = fmaf(tw[6 + kx][k], xv, acc[A][ci][k]);
          acc[P][ci][k] = fmaf(tw[3 + kx][k], xv, acc[P][ci][k]);
          acc[N][ci][k] = fmaf(tw[kx][k], xv, acc[N][ci][k]);
        }
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    const int j = j0 + i;
    if (j - 1 >= k0) finish(acc[A], j - 1);
#pragma unroll
    for (int ci = 0; ci < CH_COLS; ++ci)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[A][ci][k] = 0.f;  // now row j + 2's
    if (i == n - 1 && j < k1) finish(acc[P], j);  // the chain's last row
  };
  for (int i = 0;;) {
    step(std::integral_constant<int, 0>(), i);
    if (++i == n) break;
    step(std::integral_constant<int, 1>(), i);
    if (++i == n) break;
    step(std::integral_constant<int, 2>(), i);
    if (++i == n) break;
  }
}

cudaError_t launch_chain(const void* const* embeds, int n_embeds, const float* w, const float* scale,
                         const float* bias, void* const* outs, int n_dil, const int* dil, int b, int h,
                         int w_, int ec, cudaStream_t st) {
  const int c = n_embeds * ec;
  const ChainPlan p = chain_plan(b, h, w_, c, n_dil, dil);
  if (p.grid < 1 || p.grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  ChainMaps m;
  ChainArgs a{};
  for (int i = 0; i < n_dil; ++i) {
    for (int e = 0; e < n_embeds; ++e)
      if (!cached_embed_map(&m.x[e][i], embeds[e], b, h, w_, ec, CH_TPX + 2 * dil[i],
                            CU_TENSOR_MAP_SWIZZLE_NONE))
        return cudaErrorInvalidValue;
    a.out[i] = static_cast<bf16*>(outs[i]);
    a.dil[i] = dil[i];
    a.res[i] = p.res[i];
    a.nseg[i] = p.nseg[i];
    a.seg_rows[i] = p.seg_rows[i];
    a.units[i] = p.units[i];
  }
  a.w = w; a.scale = scale; a.bias = bias;
  a.H = h; a.W = w_; a.EC = ec; a.C = c; a.n_dil = n_dil; a.strips = p.strips; a.slices = p.slices;
  cudaError_t err = set_smem_once<dw_chain_kernel>(CH_SMEM);
  if (err != cudaSuccess) return err;
  dw_chain_kernel<<<(unsigned)p.grid, CH_THREADS, CH_SMEM, st>>>(m, a);
  return cudaGetLastError();
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
  const int cs = dtype == 0 ? UNITS * 4 : 64;
  const int c = n_embeds * ec;
  if ((dtype != 0 && dtype != 1) || n_embeds < 1 || n_embeds > kMaxEmbeds || n_dil < 1 ||
      n_dil > kMaxDils || ec % cs != 0 || h < 1 || w_ < 1 || b < 1 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n_dil; ++i)
    if (dilations[i] < 1 || dilations[i] > kMaxDilation) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(launch_chain(embeds, n_embeds, w, scale, bias, outs, n_dil, dilations, b, h,
                                         w_, ec, st));
  // the SIMT body's grid: row segments along x, (dilation, slice) along y
  const long long tiles = (long long)h * ((w_ + TPX - 1) / TPX);
  if (tiles > 0x7fffffffLL || (long long)n_dil * (c / cs) > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  for (int i = 0; i < n_embeds; ++i) p.embeds[i] = embeds[i];
  for (int i = 0; i < n_dil; ++i) {
    p.dil[i] = dilations[i];
    p.out[i] = outs[i];
  }
  p.w = w; p.scale = scale; p.bias = bias;
  p.H = h; p.W = w_; p.EC = ec; p.C = c;
  const dim3 grid((unsigned)tiles, (unsigned)(n_dil * (c / cs)), (unsigned)b);
  dw_branches_kernel<float><<<grid, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The launch plan for a shape, for holding dw_plan() to it: out = {body (0
// SIMT, 1 chains on TMA), columns a strip, threads, ring slots, dynamic
// shared memory bytes, grid x, y, z, strips, channel slices, then per
// dilation (three, 0 past n_dil) segments, segment rows, units}.  float32:
// the SIMT body's (a block one row segment of 64 pixels, one 32-channel
// slice and one dilation; its 38 KB of shared memory are static).
void madm_dw_plan(int dtype, int b, int h, int w, int ec, int n_embeds, int n_dil, const int* dil,
                  int* out) {
  for (int i = 0; i < 19; ++i) out[i] = 0;
  const int c = n_embeds * ec;
  if (dtype == 1) {
    const ChainPlan p = chain_plan(b, h, w, c, n_dil, dil);
    const int v[10] = {1, CH_TPX, CH_THREADS, SLOTS, CH_SMEM, (int)p.grid, 1, 1, p.strips, p.slices};
    for (int i = 0; i < 10; ++i) out[i] = v[i];
    for (int i = 0; i < n_dil; ++i) {
      out[10 + i] = p.nseg[i];
      out[13 + i] = p.seg_rows[i];
      out[16 + i] = p.units[i];
    }
  } else {
    const int strips = (w + TPX - 1) / TPX;
    const int v[10] = {0, TPX, kThreads, 0, 0, h * strips, n_dil * (c / (UNITS * 4)), b, strips,
                       c / (UNITS * 4)};
    for (int i = 0; i < 10; ++i) out[i] = v[i];
  }
}

}  // extern "C"
