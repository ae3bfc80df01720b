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
// pointwise product, as on the TPU.  The 1024-channel concat and the
// depthwise outputs never reach device memory.
//
// Bound on the H100: ~564 GFLOP per 512x512 image, almost all of it in the
// four C x PC pointwise products, against ~1.07 GB of embed reads and output
// writes: it is bound by operations, 0.571 ms at 989 TFLOP/s.
//
// What limits a Hopper body is the traffic that feeds the tensor cores, not
// the FLOPs.  Per SM and clock the tensor cores do ~2,048 bf16 MAC and
// shared memory gives 128 bytes.  A wgmma m64n256k16 whose A comes from
// registers reads its 8 KB of B from shared memory for 262 K MAC: 64 B a
// clock at full rate, half the budget, leaving ~8 B per depthwise output
// element.  A 9-tap gather of bf16 costs 18 B per element, 22 B if the
// output goes back through shared memory.  And every block streams its
// branch's C x PC weights (512 KB) and its embed rows through L2.
//
// The bf16 body (the model's type), with what it does about that:
// - A block computes 64 pixels of two image rows (y and y+d) x all 256
//   output channels of one branch, in two consumer warpgroups of 64 pixel
//   rows each (one m64n256 fp32 accumulator, 128 registers a thread, per
//   warpgroup).  256 threads: ptxas may use 255 registers a thread and uses
//   199, with no spills.  No producer warp: one consumer thread issues the
//   loads.
// - The C input channels stream in chunks of 64 through a ring of 2 stages
//   (93 KB each, 187 KB in all) under mbarriers.  A stage holds the halo
//   rows y-d, y, y+d, y+2d of the chunk, each a TMA box [64 channels]
//   [64 + 2d pixels] of a rank-4 map (EC, W, H, B) of the embed, 128-byte
//   swizzled; the chunk's [64][256] weights as four [64][64] boxes, read
//   MN-major by wgmma as TMA wrote them; and, for the dilated branches, the
//   chunk's 9 x 64 fp32 taps and its 64 biases by bulk copy.  Coordinates
//   outside the image (x < 0, x >= W, rows above 0 or below H-1) read TMA's
//   zeros: that is the conv's zero padding, so the inner loop has no bounds
//   check.
// - aspp_0 (1x1): A is the embed row as TMA put it (rows y and y+1, one a
//   warpgroup): wgmma with both operands in shared memory, no SIMT work.
// - The dilated branches: each thread computes the depthwise outputs of
//   exactly the elements of its own m64k16 A fragment, straight into
//   registers, and they are the register A operand of the wgmma: the
//   depthwise output never touches shared memory.  The fragment's two rows
//   of a thread are the pixels (y, x) and (y+d, x), which share the halo
//   rows y and y+d: 12 loads of a channel pair for 2 pixels instead of 18,
//   12 B per output element.  Lanes g = 0..7 of a warp take 8 consecutive
//   columns, so their 32-bit reads of the swizzled rows hit 32 distinct
//   banks.  The taps of a thread's 4 channels are read once per thread and
//   k-step (9 x 2 float2), not once per pixel.  A k-step's depthwise runs
//   while the previous k-step's wgmma is in flight (two A fragments, at most
//   one group outstanding), and a chunk's stage goes back for its refill as
//   the next chunk starts, a chunk of work before the refill is needed.
// - Block order: the branch is the fastest block index, so the four
//   branches of a tile run together; tiles walk all row pairs of a group of
//   column strips (2 at 512 and 1024 columns) before the next group, the
//   group as wide as keeps the live halo rows within ~30 MB of the 50 MB L2.
// - Epilogue: BN scale and shift and the ReLU in fp32 on the accumulator,
//   rounded to bf16 and stored from registers (two channels a store);
//   columns past W and a second row past H are not stored.
// Budget per 64-channel chunk of a dilated block (2 x 64 pixels): the tensor
// cores need 1,024 clocks; shared memory serves B (512 wavefronts of 128
// bytes), the halo reads (768) and the taps (576), and TMA writes ~80 KB
// into it (32 KB of weights, 39-51 KB of halo rows, 2.5 KB of taps), all of
// it from L2: ~9.6 GB from L2 for a 512x512 image.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py and python -m
// madm_torch.profile_aspp --ablate): 2.48-2.62 ms at [1,512,512,1024], 22-23%
// of the bound (the WMMA body before it took 6.44 ms).  The aspp_0 blocks
// alone take 0.48 ms, the dilated ones alone 2.12: 1.50 without their
// depthwise, 1.51 without their products, 1.07 for the depthwise with no
// products and no weight or halo loads.  So the SIMT depthwise and the
// load-and-product path (bound by the latency and rate of the loads from
// L2, not by the tensor cores) each take about half, and overlap only in
// part: that overlap is what a next design has to win.  Tried in short
// calls and not kept, each slower or no faster: clusters of two blocks
// sharing the weights and two halo rows by TMA multicast; persistent blocks
// (ptxas then serialized the wgmmas); 32-channel stages in a ring of 4; the
// depthwise output through shared memory as an SS operand.
//
// float32 (the parity path) gathers the taps from global memory and runs the
// product as SIMT fp32 FMA, each thread an 8 pixel x 8 channel tile of a
// 64-pixel row segment, so that it keeps full fp32 precision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

// ------------------------------------------------- bfloat16: TMA + wgmma
using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int TC = 64;   // pixels of a tile row (one strip)
constexpr int KCB = 64;  // input channels a stage: one 128-byte swizzled row a pixel
constexpr int STAGES = 2;
constexpr int SLOT_BYTES = (TC + 2 * kMaxDilation) * 128;  // one halo row; a multiple of 1024
constexpr int X_BYTES = 4 * SLOT_BYTES;                     // halo rows y-d, y, y+d, y+2d
constexpr int W_BYTES = KCB * PC * 2;                       // [64][256] weights, four [64][64] boxes
constexpr int TAP_BYTES = 10 * KCB * 4;                     // 9 fp32 taps and the bias a channel
constexpr int STAGE_BYTES = (X_BYTES + W_BYTES + TAP_BYTES + 1023) / 1024 * 1024;
constexpr int BAR_OFF = STAGES * STAGE_BYTES;
constexpr int TMA_SMEM = 1024 + BAR_OFF + 8 * 2 * STAGES;  // + 1024 to align the base
constexpr int TMA_THREADS = 256;                            // two consumer warpgroups
constexpr int SM_COUNT = 132;                               // H100 SXM
constexpr long long L2_BUDGET = 30ll << 20;                 // live halo rows, of the 50 MB L2
static_assert(SLOT_BYTES % 1024 == 0 && (X_BYTES + W_BYTES) % 1024 == 0, "swizzle atoms");

struct Maps {
  CUtensorMap x[kMaxEmbeds][4];  // embed e as branch br reads it: boxes [64][64 + 2 d_br]
  CUtensorMap pw;                // pw_w as a [3C][PC] matrix: boxes [64 rows][64 columns]
  CUtensorMap a0;                // a0_w as [C][PC]
};

struct TmaArgs {
  const float* dw_w;  // [3][3][3][C], BN scale folded
  const float* dw_b;  // [3][C]
  const float *pw_s, *pw_b, *a0_s, *a0_b;
  bf16* out;  // [B][H][W][4*PC]
  int H, W, EC, C, nch;
  int pair[4];  // row distance of a tile's two rows: 1 for aspp_0, the dilation for the others
  int nk[4];    // row pairs (tiles down the image) of each branch
  int nk_max, strips, group;
};

// The launch plan of the bf16 body; aspp_plan() in madm_torch/ops/aspp.py
// computes the same.  A branch pairs rows y and y+e (e = pair[br]) for the
// y with floor(y / e) even: row_pairs of them cover the H rows, each once
// (the second row of the last pairs may lie past H).  Column strips of TC
// pixels; `group` strips walk down the image together.
struct TmaPlan {
  int nk[4], nk_max, strips, group;
  long long gx;  // blocks along x: 4 branches x nk_max x strips
};

inline int row_pairs(int h, int e) { return h / (2 * e) * e + (h % (2 * e) < e ? h % (2 * e) : e); }

inline TmaPlan tma_plan(int h, int w, int c, const int pair[4]) {
  TmaPlan p{};
  p.nk_max = 0;
  int dmax = 0;
  for (int i = 0; i < 4; ++i) {
    p.nk[i] = row_pairs(h, pair[i]);
    p.nk_max = p.nk[i] > p.nk_max ? p.nk[i] : p.nk_max;
    if (i > 0 && pair[i] > dmax) dmax = pair[i];
  }
  p.strips = (w + TC - 1) / TC;
  // the widest group of strips whose live halo rows fit the budget: 3d + 2
  // rows of a tile plus the rows that the blocks in flight span
  p.group = 1;
  for (int g = 16; g > 1; g /= 2) {
    if (g > p.strips) continue;
    const long long rows = 3 * dmax + 2 + 2 * ((SM_COUNT + 4 * g - 1) / (4 * g));
    if (rows * (TC * g + 2 * dmax) * c * 2 <= L2_BUDGET) {
      p.group = g;
      break;
    }
  }
  p.gx = 4ll * p.nk_max * p.strips;
  return p;
}

// Which tile this block computes: the branch is the fastest block index, then
// the strip within its group, then the row pair, then the group.  False for
// a block past its branch's row pairs (branches differ in them by < e).
__device__ __forceinline__ bool tma_tile(const TmaArgs& a, int& br, int& k, int& strip) {
  br = blockIdx.x & 3;
  const int rest = blockIdx.x >> 2;
  const int per = a.nk_max * a.group, full = a.strips / a.group;
  if (rest < full * per) {
    const int grp = rest / per, r = rest - grp * per;
    k = r / a.group;
    strip = grp * a.group + (r - k * a.group);
  } else {  // the last, narrower group
    const int rem = a.strips - full * a.group, r = rest - full * per;
    k = r / rem;
    strip = full * a.group + (r - k * rem);
  }
  return k < a.nk[br];
}

__global__ void __launch_bounds__(TMA_THREADS, 1)
aspp_fused_tma_kernel(const __grid_constant__ Maps maps, const __grid_constant__ TmaArgs a) {
  int br, k, strip;
  if (!tma_tile(a, br, k, strip)) return;
  const int e = a.pair[br], d = br == 0 ? 0 : e;
  const int y = (k / e) * 2 * e + k % e, x0 = strip * TC, b = blockIdx.y;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + BAR_OFF);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tg = lane % 4;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);  // one arrival a warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  // chunk c (input channels 64c..64c+63) into stage s: halo rows, weights, taps
  auto load = [&](int c, int s) {
    unsigned char* st = sm + s * STAGE_BYTES;
    const int ei = c * KCB / a.EC, ce = c * KCB - ei * a.EC;
    const CUtensorMap* xm = &maps.x[ei][br];
    const uint32_t xbytes = br == 0 ? 2 * TC * 128 : 4 * (TC + 2 * d) * 128;
    mbar_expect_tx(full + s, xbytes + W_BYTES + (br ? TAP_BYTES : 0));
    if (br == 0) {  // rows y and y+1 into slots 1 and 2
      for (int r = 0; r < 2; ++r) tma_load(st + (1 + r) * SLOT_BYTES, xm, full + s, ce, x0, y + r, b, true);
    } else {
      for (int r = 0; r < 4; ++r)
        tma_load(st + r * SLOT_BYTES, xm, full + s, ce, x0 - d, y + (r - 1) * d, b, true);
    }
    const CUtensorMap* wm = br == 0 ? &maps.a0 : &maps.pw;
    const int row0 = (br == 0 ? 0 : (br - 1) * a.C) + c * KCB;
    for (int j = 0; j < PC / 64; ++j) tma_load(st + X_BYTES + j * 8192, wm, full + s, 64 * j, row0, 0, 0, false);
    if (br) {
      const float* tw = a.dw_w + (size_t)(br - 1) * 9 * a.C + c * KCB;
      for (int tap = 0; tap < 9; ++tap)
        bulk_load(st + X_BYTES + W_BYTES + tap * 256, tw + (size_t)tap * a.C, 256, full + s);
      bulk_load(st + X_BYTES + W_BYTES + 9 * 256, a.dw_b + (size_t)(br - 1) * a.C + c * KCB, 256, full + s);
    }
  };
  // once every product that reads chunk c-1's stage is done: release that
  // stage (both warpgroups), and refill it with chunk c+1
  auto release = [&](int c) {
    if (c == 0) return;
    const int sp = (c - 1) & 1;
    if (t == 0) mbar_arrive(empty + sp);
    if (tid == 0 && c + 1 < a.nch) {
      mbar_wait(empty + sp, ((c - 1) >> 1) & 1);
      load(c + 1, sp);
    }
    __syncwarp();  // the warp reconverges before its next wgmma
  };

  if (tid == 0) {
    load(0, 0);
    if (a.nch > 1) load(1, 1);
  }

  float acc[PC / 2];
#pragma unroll
  for (int i = 0; i < PC / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  // A fragments of two k-steps: one in the tensor cores, one being built.  A
  // fragment is held live (fence_regs) until the wait that retires its wgmma,
  // so that the next one is not built into the registers the tensor cores read
  uint32_t af[2][4] = {};
  // dilated branches: this thread's pixels are (y, x0 + col) and (y + d, x0 + col);
  // tap column kx is box row col + kx*d of each halo row (the box starts at x0 - d)
  const int col = 32 * wg + 8 * warp + g;
  int xoff[3], xswz[3];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
    xoff[kx] = (col + kx * d) * 128 + 4 * tg;
    xswz[kx] = ((col + kx * d) & 7) << 4;  // the 128-byte swizzle: 16-byte unit ^= row & 7
  }

  // one chunk loop a kind of branch: the wgmma chain on acc has no merging paths
  if (br == 0) {
    for (int c = 0; c < a.nch; ++c) {
      const int s = c & 1;
      mbar_wait(full + s, (c >> 1) & 1);
      const unsigned char* st = sm + s * STAGE_BYTES;
      const uint32_t wb = smem_addr(st + X_BYTES), xa = smem_addr(st + (1 + wg) * SLOT_BYTES);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KCB / 16; ++ks)
        wgmma_ss_mn<PC>(acc, desc(xa + ks * 32, 16), desc(wb + ks * 2048, 8192), c | ks);
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk's products are done
      release(c);
    }
  } else {
    for (int c = 0; c < a.nch; ++c) {
      const int s = c & 1;
      mbar_wait(full + s, (c >> 1) & 1);
      const unsigned char* st = sm + s * STAGE_BYTES;
      const uint32_t wb = smem_addr(st + X_BYTES);
      // the previous chunk's last product is done, so its stage goes back
      // now, a chunk of depthwise work before its refill is needed
      wgmma_wait0();
      release(c);
      const float* taps = reinterpret_cast<const float*>(st + X_BYTES + W_BYTES) + 2 * tg;
#pragma unroll
      for (int ks = 0; ks < KCB / 16; ++ks) {
        // the depthwise outputs of this thread's fragment: pixels (y, x) and
        // (y + d, x), channels 16ks + {2tg, 2tg+1} (lo) and {2tg+8, 2tg+9} (hi)
        float2 wlo[9], whi[9];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          wlo[tap] = *reinterpret_cast<const float2*>(taps + tap * KCB + 16 * ks);
          whi[tap] = *reinterpret_cast<const float2*>(taps + tap * KCB + 16 * ks + 8);
        }
        const float2 blo = *reinterpret_cast<const float2*>(taps + 9 * KCB + 16 * ks);
        const float2 bhi = *reinterpret_cast<const float2*>(taps + 9 * KCB + 16 * ks + 8);
        float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int slot = 0; slot < 4; ++slot) {
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const int off = slot * SLOT_BYTES + xoff[kx] + ((32 * ks) ^ xswz[kx]);
            const uint32_t v0 = *reinterpret_cast<const uint32_t*>(st + off);
            const uint32_t v1 = *reinterpret_cast<const uint32_t*>(st + (off ^ 16));
            const float x[4] = {__uint_as_float(v0 << 16), __uint_as_float(v0 & 0xffff0000u),
                                __uint_as_float(v1 << 16), __uint_as_float(v1 & 0xffff0000u)};
            if (slot < 3) {  // pixel (y, x): tap row ky = slot
              const float2 l = wlo[slot * 3 + kx], h = whi[slot * 3 + kx];
              s0[0] = fmaf(l.x, x[0], s0[0]);
              s0[1] = fmaf(l.y, x[1], s0[1]);
              s0[2] = fmaf(h.x, x[2], s0[2]);
              s0[3] = fmaf(h.y, x[3], s0[3]);
            }
            if (slot > 0) {  // pixel (y + d, x): tap row ky = slot - 1
              const float2 l = wlo[(slot - 1) * 3 + kx], h = whi[(slot - 1) * 3 + kx];
              s1[0] = fmaf(l.x, x[0], s1[0]);
              s1[1] = fmaf(l.y, x[1], s1[1]);
              s1[2] = fmaf(h.x, x[2], s1[2]);
              s1[3] = fmaf(h.y, x[3], s1[3]);
            }
          }
        }
        // depthwise BN bias + ReLU, rounded to bf16: fragment rows g (y) and g+8 (y+d)
        uint32_t* f = af[ks & 1];
        f[0] = pack_bf16(fmaxf(s0[0] + blo.x, 0.f), fmaxf(s0[1] + blo.y, 0.f));
        f[1] = pack_bf16(fmaxf(s1[0] + blo.x, 0.f), fmaxf(s1[1] + blo.y, 0.f));
        f[2] = pack_bf16(fmaxf(s0[2] + bhi.x, 0.f), fmaxf(s0[3] + bhi.y, 0.f));
        f[3] = pack_bf16(fmaxf(s1[2] + bhi.x, 0.f), fmaxf(s1[3] + bhi.y, 0.f));
        fence_regs(af[ks & 1]);  // the fragment is complete before the wgmma's fence
        wgmma_fence();
        wgmma_rs<PC>(acc, af[ks & 1], desc(wb + ks * 2048, 8192), c | ks);
        wgmma_commit();
        wgmma_wait<1>();  // the previous k-step's product is done: its fragment is free
        fence_regs(af[(ks + 1) & 1]);
      }
    }
  }
  wgmma_wait0();
  fence_regs(acc);

  // epilogue: BN + ReLU in fp32, bf16 pairs stored from the accumulator
  // (rows g and g+8 of each warp's 16, columns 8j + 2tg, 8j + 2tg + 1)
  const float* sc = br == 0 ? a.a0_s : a.pw_s + (br - 1) * PC;
  const float* sh = br == 0 ? a.a0_b : a.pw_b + (br - 1) * PC;
  int py0, py1, px0, px1;
  if (br == 0) {  // warpgroup wg: row y + wg, pixels x0 .. x0 + 63
    py0 = py1 = y + wg;
    px0 = x0 + 16 * warp + g;
    px1 = px0 + 8;
  } else {
    py0 = y;
    py1 = y + d;
    px0 = px1 = x0 + col;
  }
  const bool ok0 = py0 < a.H && px0 < a.W, ok1 = py1 < a.H && px1 < a.W;
  bf16* o0 = a.out + (((size_t)b * a.H + py0) * a.W + px0) * (4 * PC) + br * PC + 2 * tg;
  bf16* o1 = a.out + (((size_t)b * a.H + py1) * a.W + px1) * (4 * PC) + br * PC + 2 * tg;
#pragma unroll
  for (int j = 0; j < PC / 8; ++j) {
    const int n = 8 * j + 2 * tg;
    const float2 s2 = *reinterpret_cast<const float2*>(sc + n), h2 = *reinterpret_cast<const float2*>(sh + n);
    if (ok0)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) = __floats2bfloat162_rn(
          fmaxf(fmaf(acc[4 * j], s2.x, h2.x), 0.f), fmaxf(fmaf(acc[4 * j + 1], s2.y, h2.y), 0.f));
    if (ok1)
      *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) = __floats2bfloat162_rn(
          fmaxf(fmaf(acc[4 * j + 2], s2.x, h2.x), 0.f), fmaxf(fmaf(acc[4 * j + 3], s2.y, h2.y), 0.f));
  }
}

cudaError_t launch_tma(const void* const* embeds, int n, const float* dw_w, const float* dw_b,
                       const void* pw_w, const float* pw_s, const float* pw_b, const void* a0_w,
                       const float* a0_s, const float* a0_b, void* out, int b, int h, int w, int ec,
                       const int pair[4], cudaStream_t st) {
  const int c = n * ec;
  const TmaPlan p = tma_plan(h, w, c, pair);
  if (p.gx > 0x7fffffffLL) return cudaErrorInvalidValue;
  Maps m;
  for (int e = 0; e < n; ++e)
    for (int br = 0; br < 4; ++br)
      if (!cached_embed_map(&m.x[e][br], embeds[e], b, h, w, ec, TC + (br ? 2 * pair[br] : 0),
                            CU_TENSOR_MAP_SWIZZLE_128B))
        return cudaErrorInvalidValue;
  if (!cached_bf16_map(&m.pw, pw_w, 1, 3 * c, 1, PC, 3ll * c * PC, PC, PC, KCB) ||
      !cached_bf16_map(&m.a0, a0_w, 1, c, 1, PC, (long long)c * PC, PC, PC, KCB))
    return cudaErrorInvalidValue;
  cudaError_t err = set_smem_once<aspp_fused_tma_kernel>(TMA_SMEM);
  if (err != cudaSuccess) return err;
  TmaArgs a{dw_w, dw_b, pw_s, pw_b, a0_s, a0_b, static_cast<bf16*>(out), h, w, ec, c, c / KCB,
            {pair[0], pair[1], pair[2], pair[3]}, {p.nk[0], p.nk[1], p.nk[2], p.nk[3]},
            p.nk_max, p.strips, p.group};
  aspp_fused_tma_kernel<<<dim3((unsigned)p.gx, b), TMA_THREADS, TMA_SMEM, st>>>(m, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* madm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// dtype: 0 = float32, 1 = bfloat16 (embeds, pw_w, a0_w and out; the other
// parameters are float32).  Every tensor is contiguous and 16-byte aligned.
// Requires 1 <= n_embeds <= 4, dilations in [1, 24], b <= 65535 and PC ==
// 256 output channels per branch; ec % 32 == 0 for float32 and ec % 64 == 0
// for bfloat16 (whose stages take 64 channels of one embed).  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for input outside these
// bounds).
int madm_aspp_fused(int dtype, const void* const* embeds, int n_embeds, const float* dw_w,
                    const float* dw_b, const void* pw_w, const float* pw_s, const float* pw_b,
                    const void* a0_w, const float* a0_s, const float* a0_b, void* out, int b,
                    int h, int w, int ec, int d1, int d2, int d3, void* stream) {
  const long long tiles = (long long)h * ((w + TP - 1) / TP);
  if (n_embeds < 1 || n_embeds > kMaxEmbeds || ec % (dtype == 1 ? KCB : KC) != 0 ||
      tiles > 0x7fffffffLL || b > 65535 || d1 < 1 || d2 < 1 || d3 < 1 || d1 > kMaxDilation ||
      d2 > kMaxDilation || d3 > kMaxDilation)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const int pair[4] = {1, d1, d2, d3};
    return static_cast<int>(launch_tma(embeds, n_embeds, dw_w, dw_b, pw_w, pw_s, pw_b, a0_w, a0_s,
                                       a0_b, out, b, h, w, ec, pair, st));
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  for (int i = 0; i < n_embeds; ++i) p.embeds.p[i] = embeds[i];
  p.dw_w = dw_w; p.dw_b = dw_b; p.pw_w = pw_w; p.pw_s = pw_s; p.pw_b = pw_b;
  p.a0_w = a0_w; p.a0_s = a0_s; p.a0_b = a0_b; p.out = out;
  p.H = h; p.W = w; p.EC = ec; p.C = n_embeds * ec; p.d1 = d1; p.d2 = d2; p.d3 = d3;
  aspp_fused_simt_kernel<<<dim3((unsigned)tiles, 4, b), kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The launch plan for a shape, for holding aspp_plan() to it: out = {tile
// columns, tile rows, input channels a stage, stages, threads, dynamic shared
// memory bytes, grid x, y, z, column strips, strips a group, row pairs of
// branches 0-3}.  float32: the SIMT body's (row segments of TP pixels, one
// branch a grid row, no dynamic shared memory, no groups).
void madm_aspp_fused_plan(int dtype, int b, int h, int w, int ec, int n_embeds, int d1, int d2,
                          int d3, int* out) {
  const int strips = (w + TP - 1) / TP;
  if (dtype == 1) {
    const int pair[4] = {1, d1, d2, d3};
    const TmaPlan p = tma_plan(h, w, n_embeds * ec, pair);
    const int v[15] = {TC, 2, KCB, STAGES, TMA_THREADS, TMA_SMEM, (int)p.gx, b, 1,
                       p.strips, p.group, p.nk[0], p.nk[1], p.nk[2], p.nk[3]};
    for (int i = 0; i < 15; ++i) out[i] = v[i];
  } else {
    const int v[15] = {TP, 1, KC, 1, kThreads, 0, h * strips, 4, b, strips, 0, h, h, h, h};
    for (int i = 0; i < 15; ++i) out[i] = v[i];
  }
}

}  // extern "C"
