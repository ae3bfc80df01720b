"""The eval head's kernels and the heads built on them (port of
``madm_tpu/ops/aspp.py``).

- ``aspp_fused`` (K2, ``csrc/aspp_fused.cu``, replaces ``_aspp_fused_kernel``):
  the whole sep-ASPP fuse layer, NHWC embeds -> branch concat
  ``[B, H, W, 4*PC]``; ``aspp_head_forward`` is the 'aspp' eval head on it.
  ``aspp_plan`` states, as a pure function of shape, dilations and dtype, how
  it launches (tile, stages, threads, shared memory, grid, block order) and
  refuses what its bodies do not take; ``AsppPlan.tile_pixels`` and
  ``AsppPlan.halo_boxes`` give the bf16 body's row-to-pixel map and TMA boxes.
- ``dw_branches`` (K6, ``csrc/dw_branches.cu``, replaces ``_dw_kernel``):
  dilated 3x3 depthwise conv + folded BN + ReLU, one output per dilation.
- ``matmul_argmax`` (K7, ``csrc/matmul_argmax.cu``, replaces
  ``_argmax_kernel``): conv_seg + first-occurrence argmax, int32 ids.
  ``fused_head_forward`` is the 'full' eval head on K6 and K7.

A CPU tensor goes to the kernel's plain twin (``*_reference``); a CUDA
tensor launches the kernel, or raises.  ``<wrapper>.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import kernels
from .flash_attention import SM_COUNT, SMEM_LIMIT

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_PC = 256  # output channels per branch the kernel is built for
KERNEL_CHUNK = {torch.float32: 32, torch.bfloat16: 64}  # embed channels must be a multiple of these
KERNEL_MAX_DILATION = 24  # halo of the rows the kernel stages in shared memory
KERNEL_MAX_BATCH = 65535  # the grid's y (bf16) or z (float32) extent
TILE_COLS = 64  # pixels of a tile row
TMA_STAGES = 2
TMA_THREADS = 256  # two consumer warpgroups
_SLOT_BYTES = (TILE_COLS + 2 * KERNEL_MAX_DILATION) * 128  # one halo row of 64 channels
_STAGE_BYTES = -(-(4 * _SLOT_BYTES + 64 * KERNEL_PC * 2 + 10 * 64 * 4) // 1024) * 1024
TMA_SMEM = 1024 + TMA_STAGES * _STAGE_BYTES + 8 * 2 * TMA_STAGES
L2_BUDGET = 30 << 20  # bytes of live halo rows the block order aims to keep in the 50 MB L2


def depthwise_reference(x: torch.Tensor, w_fold: torch.Tensor, bias: torch.Tensor, d: int,
                        dtype: torch.dtype) -> torch.Tensor:
    """One dilated branch's depthwise output as K2 feeds it to the pointwise
    product: relu(conv3x3_d(x) + bias) in fp32, rounded to ``dtype``.  x
    [B, H, W, C] fp32, w_fold [3, 3, C] (BN scale folded), bias [C]."""
    c = x.shape[-1]
    k = w_fold.float().permute(2, 0, 1).unsqueeze(1)  # [C, 1, 3, 3]
    dwo = F.conv2d(x.permute(0, 3, 1, 2), k, padding=d, dilation=d, groups=c).permute(0, 2, 3, 1)
    return F.relu(dwo + bias.float()).to(dtype).float()


def aspp_fused_reference(embeds: Sequence[torch.Tensor], dw_w, dw_s, dw_b, pw_w, pw_s, pw_b,
                         a0_w, a0_s, a0_b,
                         dilations: Tuple[int, ...] = (6, 12, 18)) -> torch.Tensor:
    """Plain twin of kernel K2, in fp32 from the same inputs.

    embeds: NHWC, same resolution; dw_w [n_dil, 3, 3, C] with its BN scale
    dw_s [n_dil, C] (folded here in fp32, as the kernel's caller folds it) and
    bias dw_b; pw_w [n_dil, C, PC], pw_s/pw_b [n_dil, PC]; a0_w [C, PC],
    a0_s/a0_b [PC].  The depthwise output is rounded to the embeds' dtype
    before the pointwise product, as the kernel does."""
    dtype = embeds[0].dtype
    x = torch.cat([e.float() for e in embeds], dim=-1)  # [B, H, W, C]
    w_fold = dw_w.float() * dw_s.float()[:, None, None, :]
    outs = [F.relu(x @ a0_w.float() * a0_s.float() + a0_b.float())]
    for i, d in enumerate(dilations):
        dwo = depthwise_reference(x, w_fold[i], dw_b[i], d, dtype)
        outs.append(F.relu(dwo @ pw_w[i].float() * pw_s[i].float() + pw_b[i].float()))
    return torch.cat(outs, dim=-1).to(dtype)


# ------------------------------------------------------------ launch plan
def _row_pairs(h: int, e: int) -> int:
    """How many rows y < h have floor(y / e) even: the tiles down the image of
    a branch whose tile pairs rows y and y + e."""
    return h // (2 * e) * e + min(h % (2 * e), e)


@dataclass(frozen=True)
class AsppPlan:
    """How K2 runs a call.

    ``body`` "tma_wgmma" (bf16) or "simt" (float32).  A bf16 block computes
    ``tile_cols`` pixels of ``tile_rows`` = 2 image rows, y and y + e with e =
    ``pairs[branch]`` (1 for aspp_0, the dilation for the others), for one
    branch, streaming ``chunk`` input channels a stage through ``stages``
    stages.  ``row_pairs[branch]`` tiles run down the image, ``strips``
    across it; ``group`` strips walk down the image together (block order:
    branch fastest, then the strip in its group, then the row pair, then the
    group; grid y is the batch).  The float32 body: a block is ``tile_cols``
    pixels of one row and one branch (grid (H * strips, 4, B)), and
    ``row_pairs`` the H rows."""
    body: str
    tile_cols: int
    tile_rows: int
    chunk: int
    stages: int
    threads: int
    smem: int  # dynamic shared-memory bytes
    grid: Tuple[int, int, int]
    strips: int
    group: int
    row_pairs: Tuple[int, int, int, int]
    pairs: Tuple[int, int, int, int]

    def c_plan(self) -> list:
        """The plan as ``madm_aspp_fused_plan`` in csrc/aspp_fused.cu writes it."""
        return [self.tile_cols, self.tile_rows, self.chunk, self.stages, self.threads, self.smem,
                *self.grid, self.strips, self.group, *self.row_pairs]

    def blocks(self) -> Iterator[Optional[Tuple[int, int, int]]]:
        """(branch, row pair k, strip) of each bf16 block of one image in launch
        order, None for a block past its branch's row pairs (the kernel's
        ``tma_tile``)."""
        nk_max, g = max(self.row_pairs), self.group
        full = self.strips // g
        for bx in range(self.grid[0]):
            br, rest = bx & 3, bx >> 2
            if rest < full * nk_max * g:
                grp, r = divmod(rest, nk_max * g)
                k, s = divmod(r, g)
                strip = grp * g + s
            else:
                rem = self.strips - full * g
                k, s = divmod(rest - full * nk_max * g, rem)
                strip = full * g + s
            yield (br, k, strip) if k < self.row_pairs[br] else None

    def tile_row(self, branch: int, k: int) -> int:
        """The first image row y of tile k of a branch (its second is y + e)."""
        e = self.pairs[branch]
        return k // e * 2 * e + k % e

    def tile_pixels(self, branch: int, k: int, strip: int) -> torch.Tensor:
        """[128, 2] int (row, column) of the pixel of each accumulator row m of
        a bf16 tile (m = 64 * warpgroup + 16 * warp + r; a thread holds rows
        r = g and g + 8 of its warp).  Pixels past H or W are computed and
        not stored."""
        m = torch.arange(128)
        wg, warp, r = m // 64, m % 64 // 16, m % 16
        y, x0 = self.tile_row(branch, k), strip * self.tile_cols
        if branch == 0:  # warpgroup wg: row y + wg, its 64 pixels in order
            return torch.stack([y + wg, x0 + m % 64], dim=1)
        # rows g and g + 8 of a thread: pixels (y, x) and (y + d, x), one column
        return torch.stack([y + (r // 8) * self.pairs[branch], x0 + 32 * wg + 8 * warp + r % 8], dim=1)

    def halo_boxes(self, branch: int, k: int, strip: int) -> Tuple[Tuple[int, int, int, int], ...]:
        """(slot, image row, first column, width) of each TMA box of a chunk:
        slots 1 and 2 hold rows y and y + 1 (aspp_0, 64 columns); the dilated
        branches' slots 0-3 rows y - d, y, y + d, y + 2d, columns x0 - d ..
        x0 + 63 + d.  Coordinates outside the image read zeros."""
        y, x0 = self.tile_row(branch, k), strip * self.tile_cols
        if branch == 0:
            return tuple((1 + r, y + r, x0, self.tile_cols) for r in range(2))
        d = self.pairs[branch]
        return tuple((r, y + (r - 1) * d, x0 - d, self.tile_cols + 2 * d) for r in range(4))


def aspp_plan(b: int, h: int, w: int, ec: int, n_embeds: int, dilations: Sequence[int],
              dtype: torch.dtype) -> AsppPlan:
    """K2's launch plan (``madm_aspp_fused_plan`` in csrc/aspp_fused.cu makes
    the same choice); raises ValueError for what the kernel does not take:
    1-4 embeds, each a multiple of 32 channels (float32) or 64 (bf16: a stage
    is 64 channels of one embed), three dilations in [1, 24], B <= 65535."""
    if dtype not in _DTYPES:
        raise ValueError(f"aspp_fused takes float32 or bfloat16 embeds, got {dtype}")
    chunk = KERNEL_CHUNK[dtype]
    if not 1 <= n_embeds <= 4 or ec % chunk or len(dilations) != 3 \
            or not all(1 <= d <= KERNEL_MAX_DILATION for d in dilations):
        raise ValueError(
            f"aspp_fused kernel takes 1-4 embeds of a multiple of {chunk} channels ({dtype}) and "
            f"3 dilations in [1, {KERNEL_MAX_DILATION}]; got {n_embeds} x {ec}, {tuple(dilations)}")
    if not 1 <= b <= KERNEL_MAX_BATCH:
        raise ValueError(f"aspp_fused kernel takes a batch of 1 to {KERNEL_MAX_BATCH}, got {b}")
    strips = -(-w // TILE_COLS)
    pairs = (1, *(int(d) for d in dilations))
    if dtype == torch.float32:
        if h * strips > 2 ** 31 - 1:
            raise ValueError(f"aspp_fused: {h} x {w} is too many row segments for the grid")
        return AsppPlan("simt", TILE_COLS, 1, chunk, 1, 256, 0, (h * strips, 4, b), strips, 0,
                        (h,) * 4, pairs)
    row_pairs = tuple(_row_pairs(h, e) for e in pairs)
    dmax, c = max(pairs[1:]), n_embeds * ec
    group = 1
    for g in (16, 8, 4, 2):
        rows = 3 * dmax + 2 + 2 * -(-SM_COUNT // (4 * g))
        if g <= strips and rows * (TILE_COLS * g + 2 * dmax) * c * 2 <= L2_BUDGET:
            group = g
            break
    gx = 4 * max(row_pairs) * strips
    if gx > 2 ** 31 - 1:
        raise ValueError(f"aspp_fused: {h} x {w} is too many tiles for the grid")
    return AsppPlan("tma_wgmma", TILE_COLS, 2, chunk, TMA_STAGES, TMA_THREADS, TMA_SMEM, (gx, b, 1),
                    strips, group, row_pairs, pairs)


def tma_maps(b: int, h: int, w: int, ec: int, n_embeds: int,
             dilations: Sequence[int]) -> Tuple[Tuple[str, Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]], ...]:
    """(name, dims, byte strides, box) of each tensor map the bf16 body
    encodes (``launch_tma`` in csrc/aspp_fused.cu), dims and box innermost
    first: embed e as branch br reads it, rank 4 (EC, W, H, B) with boxes
    [64 channels][64 + 2 d pixels] (d = 0 for aspp_0); pw_w as a [3C][PC]
    and a0_w as a [C][PC] matrix, boxes [64][64].  All 128-byte swizzled."""
    c = n_embeds * ec
    maps = []
    for e in range(n_embeds):
        for br, d in enumerate((0, *dilations)):
            maps.append((f"embed{e}/branch{br}", (ec, w, h, b), (2 * ec, 2 * ec * w, 2 * ec * w * h),
                         (64, TILE_COLS + 2 * d, 1, 1)))
    maps.append(("pw_w", (KERNEL_PC, 3 * c, 1), (2 * KERNEL_PC, 2 * KERNEL_PC * 3 * c), (64, 64, 1)))
    maps.append(("a0_w", (KERNEL_PC, c, 1), (2 * KERNEL_PC, 2 * KERNEL_PC * c), (64, 64, 1)))
    return tuple(maps)


def _launch(embeds, dw_w, dw_s, dw_b, pw_w, pw_s, pw_b, a0_w, a0_s, a0_b, dilations):
    e0 = embeds[0]
    dt = e0.dtype
    b, h, w, ec = e0.shape
    n = len(embeds)
    c = n * ec
    pc = pw_w.shape[-1]
    if pc != KERNEL_PC:
        raise ValueError(f"aspp_fused kernel takes {KERNEL_PC} output channels per branch, got {pc}")
    aspp_plan(b, h, w, ec, n, dilations, dt)
    if any(e.shape != e0.shape or e.dtype != dt or e.device != e0.device for e in embeds):
        raise ValueError("aspp_fused: embeds differ in shape, dtype or device")
    if not e0.is_cuda:
        raise ValueError(f"aspp_fused kernel needs CUDA tensors, got {e0.device}")
    dev = e0.device
    f32 = dict(device=dev, dtype=torch.float32)
    dw_w = (dw_w.to(**f32) * dw_s.to(**f32)[:, None, None, :]).contiguous()
    params = dict(
        dw_b=dw_b.to(**f32).contiguous(), pw_s=pw_s.to(**f32).contiguous(),
        pw_b=pw_b.to(**f32).contiguous(), a0_s=a0_s.to(**f32).contiguous(),
        a0_b=a0_b.to(**f32).contiguous(),
        pw_w=pw_w.to(device=dev, dtype=dt).contiguous(),
        a0_w=a0_w.to(device=dev, dtype=dt).contiguous(),
    )
    if tuple(dw_w.shape) != (3, 3, 3, c) or tuple(params["pw_w"].shape) != (3, c, pc) \
            or tuple(params["a0_w"].shape) != (c, pc):
        raise ValueError(f"aspp_fused weight shapes do not match C={c}, PC={pc}")
    embeds = [e.contiguous() for e in embeds]
    # 16-byte loads (float32) and TMA boxes and bulk copies (bf16)
    if any(t.data_ptr() % 16 for t in (*embeds, dw_w, *params.values())):
        raise ValueError("aspp_fused kernel needs 16-byte aligned tensors")
    out = torch.empty((b, h, w, 4 * pc), device=dev, dtype=dt)
    if out.numel() == 0:
        return out
    lib = _lib()
    ptrs = (ctypes.c_void_p * n)(*[e.data_ptr() for e in embeds])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.madm_aspp_fused(
            _DTYPES[dt], ptrs, n, dw_w.data_ptr(), params["dw_b"].data_ptr(),
            params["pw_w"].data_ptr(), params["pw_s"].data_ptr(), params["pw_b"].data_ptr(),
            params["a0_w"].data_ptr(), params["a0_s"].data_ptr(), params["a0_b"].data_ptr(),
            out.data_ptr(), b, h, w, ec, *[int(d) for d in dilations], stream)
    kernels.check(lib, err, "aspp_fused launch")
    aspp_fused.launches += 1
    return out


def _lib() -> ctypes.CDLL:
    """K2's library, its C functions typed once."""
    lib = kernels.load("aspp_fused")
    if lib.madm_aspp_fused.argtypes is None:
        lib.madm_aspp_fused.restype = ctypes.c_int
        lib.madm_aspp_fused.argtypes = ([ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
                                        + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.madm_aspp_fused_plan.restype = None
        lib.madm_aspp_fused_plan.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int)]
    return lib


def c_plan(b: int, h: int, w: int, ec: int, n_embeds: int, dilations: Sequence[int],
           dtype: torch.dtype) -> list:
    """The plan that the C library computes for a shape (needs the built
    library, so a machine with CUDA): the list ``AsppPlan.c_plan`` gives."""
    out = (ctypes.c_int * 15)()
    _lib().madm_aspp_fused_plan(_DTYPES[dtype], b, h, w, ec, n_embeds, *[int(d) for d in dilations], out)
    return list(out)


def aspp_fused(embeds: Sequence[torch.Tensor], dw_w, dw_s, dw_b, pw_w, pw_s, pw_b,
               a0_w, a0_s, a0_b, dilations: Tuple[int, ...] = (6, 12, 18)) -> torch.Tensor:
    """The whole separable-ASPP fuse layer (eval BN) on NHWC embeds; returns
    [B, H, W, (1 + n_dil) * PC] in branch order (aspp_0, then one PC block
    per dilation).  Arguments as in ``aspp_fused_reference``."""
    if embeds[0].device.type == "cpu":
        return aspp_fused_reference(embeds, dw_w, dw_s, dw_b, pw_w, pw_s, pw_b,
                                    a0_w, a0_s, a0_b, dilations)
    return _launch(embeds, dw_w, dw_s, dw_b, pw_w, pw_s, pw_b, a0_w, a0_s, a0_b, dilations)


aspp_fused.launches = 0


# ------------------------------------------------------------------- K6
DW_MAX_DILATION = 18  # the bf16 body's box [64][128 + 2 d] stays within TMA's 256 columns
DW_SLICE = {torch.float32: 32, torch.bfloat16: 64}  # channels of a block's slice
DW_TPX = 128  # output columns of a bf16 strip
DW_THREADS = 256
DW_SLOTS = 6  # ring of chain rows
DW_SLOT_BYTES = (DW_TPX + 2 * DW_MAX_DILATION) * 128
DW_SMEM = 128 + DW_SLOTS * DW_SLOT_BYTES + 16 * DW_SLOTS
DW_TARGET_UNITS = 2 * SM_COUNT  # fewer chains than this are cut into segments
DW_MIN_SEG_ROWS = 8


@dataclass(frozen=True)
class DwPlan:
    """How K6 runs a call.

    ``body`` "chains_tma" (bf16) or "simt" (float32).  A bf16 block (a unit)
    walks, for one dilation d, one image, one ``DW_SLICE`` channel slice and
    one strip of ``tpx`` output columns, a segment of the chain of rows y = r,
    r + d, r + 2d, ... (r < ``res[i]`` = min(d, H)): the chain's rows
    ``seg * seg_rows[i]`` .. + ``seg_rows[i]`` - 1.  Each input row it reads
    comes in once, as a TMA box of ``tpx`` + 2d columns, through a ring of
    ``slots`` rows.  Units run dilation by dilation, and within one strip
    fastest, then residue, segment, slice, image.  The float32 body: a block
    is ``tpx`` pixels of one row, one slice and one dilation, grid (H *
    strips, n_dil * slices, B)."""
    body: str
    tpx: int
    threads: int
    slots: int
    smem: int  # dynamic shared-memory bytes
    grid: Tuple[int, int, int]
    strips: int
    slices: int
    nseg: Tuple[int, ...]
    seg_rows: Tuple[int, ...]
    units: Tuple[int, ...]
    res: Tuple[int, ...]
    dilations: Tuple[int, ...]
    b: int
    h: int
    w: int

    def c_plan(self) -> list:
        """The plan as ``madm_dw_plan`` in csrc/dw_branches.cu writes it."""
        pad = lambda t: list(t) + [0] * (3 - len(t))  # noqa: E731
        return [int(self.body == "chains_tma"), self.tpx, self.threads, self.slots, self.smem,
                *self.grid, self.strips, self.slices, *pad(self.nseg), *pad(self.seg_rows),
                *pad(self.units)]

    def blocks(self) -> Iterator[Tuple[int, int, int, int, int, int]]:
        """(dilation index, strip, residue, segment, slice, image) of each bf16
        block in launch order (the kernel's decode of blockIdx.x)."""
        for i in range(len(self.dilations)):
            for u in range(self.units[i]):
                strip, u = u % self.strips, u // self.strips
                r, u = u % self.res[i], u // self.res[i]
                seg, u = u % self.nseg[i], u // self.nseg[i]
                yield i, strip, r, seg, u % self.slices, u // self.slices

    def chain(self, i: int, r: int, seg: int) -> Optional[Tuple[int, int, int, int]]:
        """(k0, k1, j0, n) of a unit: it writes chain rows k0 .. k1 - 1 (image
        rows r + k d) and reads chain rows j0 .. j0 + n - 1; None for an empty
        segment of a short chain."""
        d = self.dilations[i]
        length = -(-(self.h - r) // d)
        k0 = seg * self.seg_rows[i]
        if k0 >= length:
            return None
        k1 = min(k0 + self.seg_rows[i], length)
        j0 = max(k0 - 1, 0)
        return k0, k1, j0, min(k1, length - 1) - j0 + 1

    def box(self, i: int, r: int, j: int, strip: int) -> Tuple[int, int, int]:
        """(image row, first column, width) of the TMA box of chain row j;
        columns outside the image read zeros."""
        d = self.dilations[i]
        return r + j * d, strip * self.tpx - d, self.tpx + 2 * d

    def loads_per_input(self) -> float:
        """Mean times an input element crosses from L2 into an SM, per
        dilation: box elements loaded over n_dil x B x H x W (the channel
        slices cancel).  Exact for these units."""
        cols = 0
        for i, strip, r, seg, sl, b in self.blocks():
            if sl or b:
                continue
            ch = self.chain(i, r, seg)
            if ch is not None:
                cols += ch[3] * (self.tpx + 2 * self.dilations[i])
        return cols / (len(self.dilations) * self.h * self.w)

    @property
    def max_loads(self) -> int:
        """The most times one input element crosses into an SM for one
        dilation: two strips share a halo column (d <= 18 < tpx), and two
        segments an edge row."""
        return (2 if self.strips > 1 else 1) * (2 if max(self.nseg) > 1 else 1)


def dw_plan(b: int, h: int, w: int, c: int, dilations: Sequence[int], dtype: torch.dtype,
            n_embeds: int = 1) -> DwPlan:
    """K6's launch plan (``madm_dw_plan`` in csrc/dw_branches.cu makes the
    same choice) for embeds [B, H, W, c / n_embeds]; raises ValueError for
    what the kernel does not take: 1-4 embeds of a multiple of 32 channels
    (float32) or 64 (bf16), 1-3 dilations in [1, 18], B <= 65535."""
    if dtype not in _DTYPES:
        raise ValueError(f"dw_branches takes float32 or bfloat16 embeds, got {dtype}")
    sl = DW_SLICE[dtype]
    dils = tuple(int(d) for d in dilations)
    if (not 1 <= n_embeds <= 4 or c % n_embeds or (c // n_embeds) % sl or not 1 <= len(dils) <= 3
            or not all(1 <= d <= DW_MAX_DILATION for d in dils)):
        raise ValueError(
            f"dw_branches kernel takes 1-4 embeds of a multiple of {sl} channels ({dtype}) and "
            f"1-3 dilations in [1, {DW_MAX_DILATION}]; got {n_embeds} embeds, {c} channels, {dils}")
    if not 1 <= b <= KERNEL_MAX_BATCH:
        raise ValueError(f"dw_branches kernel takes a batch of 1 to {KERNEL_MAX_BATCH}, got {b}")
    if dtype == torch.float32:
        strips = -(-w // TILE_COLS)
        if h * strips > 2 ** 31 - 1 or len(dils) * (c // sl) > 65535:
            raise ValueError(f"dw_branches: {b} x {h} x {w} x {c} is too large for the grid")
        return DwPlan("simt", TILE_COLS, 256, 0, 0, (h * strips, len(dils) * (c // sl), b), strips,
                      c // sl, (), (), (), (), dils, b, h, w)
    strips, slices = -(-w // DW_TPX), c // sl
    res = tuple(min(d, h) for d in dils)
    lens = [max(1, -(-h // d)) for d in dils]  # the longest chain of each dilation: residue 0
    base = sum(b * slices * strips * r for r in res)  # 0 for an empty image: no units
    want = 1 if base >= DW_TARGET_UNITS or base == 0 else -(-DW_TARGET_UNITS // base)
    seg_rows = tuple(-(-n // min(want, max(1, n // DW_MIN_SEG_ROWS))) for n in lens)
    nsegs = tuple(-(-n // s) for n, s in zip(lens, seg_rows))
    units = tuple(b * slices * strips * r * s for r, s in zip(res, nsegs))
    if sum(units) > 2 ** 31 - 1:
        raise ValueError(f"dw_branches: {b} x {h} x {w} x {c} is too many units for the grid")
    return DwPlan("chains_tma", DW_TPX, DW_THREADS, DW_SLOTS, DW_SMEM, (sum(units), 1, 1), strips, slices,
                  nsegs, seg_rows, units, res, dils, b, h, w)


def dw_maps(b: int, h: int, w: int, ec: int, n_embeds: int,
            dilations: Sequence[int]) -> Tuple[Tuple[str, Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]], ...]:
    """(name, dims, byte strides, box) of each tensor map the bf16 body
    encodes (``launch_chain`` in csrc/dw_branches.cu), innermost first: embed
    e as dilation i reads it, rank 4 (EC, W, H, B), boxes [64 channels][128 +
    2 d pixels], unswizzled (K2's map, ``hopper::embed_map``)."""
    return tuple((f"embed{e}/dilation{i}", (ec, w, h, b), (2 * ec, 2 * ec * w, 2 * ec * w * h),
                  (64, DW_TPX + 2 * d, 1, 1))
                 for i, d in enumerate(dilations) for e in range(n_embeds))


def dw_branches_reference(embeds: Sequence[torch.Tensor], dw_w, scale, bias,
                          dilations: Tuple[int, ...] = (6, 12, 18)) -> Tuple[torch.Tensor, ...]:
    """Plain twin of kernel K6, in fp32 from the same inputs.

    embeds: NHWC [B, H, W, EC], 1-4 of them, whose channel concat x (C
    channels) is the conv's input; dw_w [n_dil, 3, 3, C], scale and bias
    [n_dil, C] (BN folded).  Returns, per dilation d,
    relu(depthwise_conv_d(x) * scale + bias) NHWC in the embeds' dtype."""
    dtype = embeds[0].dtype
    x = torch.cat([e.float() for e in embeds], dim=-1).permute(0, 3, 1, 2)
    c = x.shape[1]
    outs = []
    for i, d in enumerate(dilations):
        k = dw_w[i].float().permute(2, 0, 1).unsqueeze(1)  # [C, 1, 3, 3]
        y = F.conv2d(x, k, padding=d, dilation=d, groups=c)
        y = F.relu(y * scale[i].float()[:, None, None] + bias[i].float()[:, None, None])
        outs.append(y.permute(0, 2, 3, 1).to(dtype).contiguous())
    return tuple(outs)


def _dw_lib() -> ctypes.CDLL:
    """K6's library, its C functions typed once."""
    lib = kernels.load("dw_branches")
    if lib.madm_dw_branches.argtypes is None:
        lib.madm_dw_branches.restype = ctypes.c_int
        lib.madm_dw_branches.argtypes = (
            [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int] + [ctypes.c_void_p] * 3
            + [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.madm_dw_plan.restype = None
        lib.madm_dw_plan.argtypes = ([ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
                                     + [ctypes.POINTER(ctypes.c_int)])
    return lib


def dw_c_plan(b: int, h: int, w: int, ec: int, n_embeds: int, dilations: Sequence[int],
              dtype: torch.dtype) -> list:
    """The plan that the C library computes for a shape (needs the built
    library, so a machine with CUDA): the list ``DwPlan.c_plan`` gives."""
    out = (ctypes.c_int * 19)()
    dils = (ctypes.c_int * len(dilations))(*[int(d) for d in dilations])
    _dw_lib().madm_dw_plan(_DTYPES[dtype], b, h, w, ec, n_embeds, len(dilations), dils, out)
    return list(out)


def _dw_launch(embeds, dw_w, scale, bias, dilations):
    e0 = embeds[0]
    dt = e0.dtype
    b, h, w, ec = e0.shape
    n, n_dil = len(embeds), len(dilations)
    c = n * ec
    dw_plan(b, h, w, c, dilations, dt, n)
    if any(e.shape != e0.shape or e.dtype != dt or e.device != e0.device for e in embeds):
        raise ValueError("dw_branches: embeds differ in shape, dtype or device")
    if not e0.is_cuda:
        raise ValueError(f"dw_branches kernel needs CUDA tensors, got {e0.device}")
    dev = e0.device
    f32 = dict(device=dev, dtype=torch.float32)
    dw_w, scale, bias = (t.to(**f32).contiguous() for t in (dw_w, scale, bias))
    if tuple(dw_w.shape) != (n_dil, 3, 3, c) or tuple(scale.shape) != (n_dil, c) \
            or tuple(bias.shape) != (n_dil, c):
        raise ValueError(f"dw_branches weight shapes do not match {n_dil} dilations, C={c}")
    embeds = [e.contiguous() for e in embeds]
    if any(e.data_ptr() % 16 for e in embeds):  # 16-byte loads (float32) and TMA boxes (bf16)
        raise ValueError("dw_branches kernel needs 16-byte aligned embeds")
    outs = tuple(torch.empty((b, h, w, c), device=dev, dtype=dt) for _ in dilations)
    if outs[0].numel() == 0:
        return outs
    lib = _dw_lib()
    ptrs = (ctypes.c_void_p * n)(*[e.data_ptr() for e in embeds])
    out_ptrs = (ctypes.c_void_p * n_dil)(*[o.data_ptr() for o in outs])
    dils = (ctypes.c_int * n_dil)(*[int(d) for d in dilations])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.madm_dw_branches(_DTYPES[dt], ptrs, n, dw_w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                   out_ptrs, n_dil, dils, b, h, w, ec, stream)
    kernels.check(lib, err, "dw_branches launch")
    dw_branches.launches += 1
    return outs


def dw_branches(embeds: Sequence[torch.Tensor], dw_w, scale, bias,
                dilations: Tuple[int, ...] = (6, 12, 18)) -> Tuple[torch.Tensor, ...]:
    """relu(bn(depthwise_conv_d(concat(embeds)))) for each dilation, the
    concat never built.  Arguments as in ``dw_branches_reference``."""
    if embeds[0].device.type == "cpu":
        return dw_branches_reference(embeds, dw_w, scale, bias, dilations)
    return _dw_launch(embeds, dw_w, scale, bias, dilations)


dw_branches.launches = 0


# ------------------------------------------------------------------- K7
ARGMAX_MAX_CLASSES = 32  # the kernel pads the classes to 16 or 32
ARGMAX_TILE = 64  # pixels of a bf16 tile: one wgmma's rows
ARGMAX_THREADS = 128 + 32  # one consumer warpgroup, one producer warp
ARGMAX_MAX_STAGES = 4


@dataclass(frozen=True)
class ArgmaxPlan:
    """How K7 runs a call.  ``body`` "tma_wgmma" (bf16): ``grid`` persistent
    blocks walk ``tiles`` tiles of 64 pixels (block i takes tiles i, i +
    grid, ...) through ``stages`` stages of [64][C] bf16, against conv_seg's
    weights as one [2 ``ncp``][C] bf16 operand (w_hi, w_lo); "simt"
    (float32): warps of 64 / ``ncp`` pixel groups, at most 2 blocks an SM."""
    body: str
    ncp: int
    threads: int
    stages: int
    smem: int
    grid: int
    tiles: int

    def c_plan(self) -> list:
        """The plan as ``madm_matmul_argmax_plan`` in csrc/matmul_argmax.cu writes it."""
        return [int(self.body == "tma_wgmma"), self.ncp, self.threads, self.stages, self.smem, self.grid,
                self.tiles]


def argmax_plan(pixels: int, c: int, nc: int, dtype: torch.dtype) -> ArgmaxPlan:
    """K7's launch plan (``madm_matmul_argmax_plan`` in csrc/matmul_argmax.cu
    makes the same choice); raises ValueError for what the kernel does not
    take: 1-32 classes; bf16 x of a multiple of 64 channels with two stages
    of a 64-pixel tile in shared memory (C <= 576 at 17-32 classes, 704 at
    1-16) and fewer than 2^31 pixels; float32 x of a multiple of 4 channels
    whose padded weights fit 200 KB."""
    if dtype not in _DTYPES:
        raise ValueError(f"matmul_argmax takes float32 or bfloat16 x, got {dtype}")
    if not 1 <= nc <= ARGMAX_MAX_CLASSES:
        raise ValueError(f"matmul_argmax kernel takes 1-{ARGMAX_MAX_CLASSES} classes, got {nc}")
    ncp = 16 if nc <= 16 else 32
    if dtype == torch.float32:
        if c % 4 or c * (ncp + 4) * 4 > 200 * 1024:
            raise ValueError(f"matmul_argmax kernel takes float32 x of a multiple of 4 channels, at most "
                             f"{200 * 1024 // ((ncp + 4) * 4)}; got {c}")
        groups = -(-pixels // (64 // ncp))
        return ArgmaxPlan("simt", ncp, 256, 0, c * (ncp + 4) * 4, min(-(-groups // 8), 2 * SM_COUNT), 0)
    w_bytes, stage_bytes = 2 * ncp * c * 2, ARGMAX_TILE * c * 2
    stages = min(ARGMAX_MAX_STAGES, (SMEM_LIMIT - 1024 - w_bytes - 16 * ARGMAX_MAX_STAGES) // stage_bytes)
    if c % 64 or c <= 0 or stages < 2:
        raise ValueError(f"matmul_argmax kernel takes bf16 x of a multiple of 64 channels with two "
                         f"64-pixel stages in shared memory; got {c} channels, {nc} classes")
    if pixels >= 2 ** 31:
        raise ValueError(f"matmul_argmax kernel takes fewer than 2^31 pixels, got {pixels}")
    tiles = -(-pixels // ARGMAX_TILE)
    return ArgmaxPlan("tma_wgmma", ncp, ARGMAX_THREADS, stages,
                      1024 + w_bytes + stages * stage_bytes + 16 * stages, min(tiles, SM_COUNT), tiles)


def matmul_argmax_reference(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain twin of kernel K7: first-occurrence argmax over the last dim of
    x @ w + bias in fp32.  x [B, H, W, C], w [C, NC], bias [NC] -> int32 [B, H, W]."""
    from ..models.daformer import argmax_classes

    return argmax_classes(x.float() @ w.float() + bias.float(), dim=-1)


def _argmax_lib() -> ctypes.CDLL:
    """K7's library, its C functions typed once."""
    lib = kernels.load("matmul_argmax")
    if lib.madm_matmul_argmax.argtypes is None:
        lib.madm_matmul_argmax.restype = ctypes.c_int
        lib.madm_matmul_argmax.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                                           + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.madm_matmul_argmax_plan.restype = None
        lib.madm_matmul_argmax_plan.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                                ctypes.POINTER(ctypes.c_int)]
    return lib


def argmax_c_plan(pixels: int, c: int, nc: int, dtype: torch.dtype) -> list:
    """The plan that the C library computes (needs the built library): the
    list ``ArgmaxPlan.c_plan`` gives."""
    out = (ctypes.c_int * 7)()
    _argmax_lib().madm_matmul_argmax_plan(_DTYPES[dtype], pixels, c, nc, out)
    return list(out)


def _argmax_launch(x, w, bias):
    dt = x.dtype
    *lead, c = x.shape
    nc = w.shape[-1]
    if tuple(w.shape) != (c, nc) or tuple(bias.shape) != (nc,):
        raise ValueError(f"matmul_argmax: w {tuple(w.shape)} and bias {tuple(bias.shape)} do not "
                         f"fit x's {c} channels")
    argmax_plan(math.prod(lead), c, nc, dt)
    if not x.is_cuda:
        raise ValueError(f"matmul_argmax kernel needs a CUDA tensor, got {x.device}")
    x = x.contiguous()
    if x.data_ptr() % 16:  # 16-byte loads (float32) and TMA boxes (bf16)
        raise ValueError("matmul_argmax kernel needs 16-byte aligned pixels")
    f32 = dict(device=x.device, dtype=torch.float32)
    w, bias = w.to(**f32).contiguous(), bias.to(**f32).contiguous()
    out = torch.empty(lead, device=x.device, dtype=torch.int32)
    if out.numel() == 0:
        return out
    lib = _argmax_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.madm_matmul_argmax(_DTYPES[dt], x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                                     out.numel(), c, nc, stream)
    kernels.check(lib, err, "matmul_argmax launch")
    matmul_argmax.launches += 1
    return out


def matmul_argmax(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """argmax(x @ w + bias) over the last dim, the eval conv_seg + argmax,
    without the logits reaching memory.  x [B, H, W, C] (w and bias are read
    as fp32) -> int32 [B, H, W]."""
    if x.device.type == "cpu":
        return matmul_argmax_reference(x, w, bias)
    return _argmax_launch(x, w, bias)


matmul_argmax.launches = 0


# ----------------------------------------------------------------- heads
def _fold_bn(bn: torch.nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm -> per-channel (scale, bias) in fp32."""
    s = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    return s, bn.bias.float() - bn.running_mean.float() * s


def fits_kernel(head) -> bool:
    """Whether ``aspp_head_forward`` serves this head: sep-ASPP with
    dilations 1/6/12/18, 256-wide embeds and branches, 4 inputs led by s0."""
    return (
        tuple(head.dilations) == (1, 6, 12, 18)
        and head.embed_dims == 256
        and head.channels == KERNEL_PC
        and len(head.in_keys) == 4
        and head.in_keys[0] == "s0"
    )


def aspp_head_forward(head, features: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Eval DAFormer head with the fuse layer's branches in ``aspp_fused``;
    returns argmax ids [B, H, W] int32 at the s0 resolution.

    Plain torch around the kernel: the embeds and their bilinear resize, the
    bottleneck 3x3 conv + BN + ReLU, conv_seg and the first-occurrence argmax.
    ``head`` is a ``models.daformer.DAFormerHead``; ``features`` NCHW."""
    from ..models.daformer import argmax_classes

    dt = head.conv_seg.weight.dtype
    embeds = [e.permute(0, 2, 3, 1).contiguous() for e in head.embeds(features)]
    fl = head.fuse_layer
    a0 = fl.aspp_modules[0]
    s_a0, b_a0 = _fold_bn(a0.bn)
    dw_w, dw_s, dw_b, pw_w, pw_s, pw_b = [], [], [], [], [], []
    for m in fl.aspp_modules[1:]:
        s, bb = _fold_bn(m.depthwise_conv.bn)
        dw_w.append(m.depthwise_conv.conv.weight[:, 0].permute(1, 2, 0).float())  # [3, 3, C]
        dw_s.append(s)
        dw_b.append(bb)
        s, bb = _fold_bn(m.pointwise_conv.bn)
        pw_w.append(_pointwise(m.pointwise_conv.conv))  # [C, PC]
        pw_s.append(s)
        pw_b.append(bb)
    fused = aspp_fused(
        embeds, torch.stack(dw_w), torch.stack(dw_s), torch.stack(dw_b),
        torch.stack(pw_w).to(dt), torch.stack(pw_s), torch.stack(pw_b),
        _pointwise(a0.conv).to(dt), s_a0, b_a0, tuple(head.dilations[1:]),
    )
    y = fl.bottleneck(fused.permute(0, 3, 1, 2))
    return argmax_classes(head.conv_seg(y))


def _pointwise(conv: torch.nn.Conv2d) -> torch.Tensor:
    """A 1x1 conv's weight as the [Cin, Cout] matrix of an NHWC product."""
    return conv.weight[:, :, 0, 0].t()


def argmax_head_forward(head, features: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The 'argmax' eval head: the module head up to the bottleneck, then
    conv_seg + argmax in ``matmul_argmax`` (K7); ids [B, H, W] int32 at the
    s0 resolution (JAX ``MADM.head_ids``, ``madm.py:1112-1118``)."""
    pre = head(features, return_pre_seg=True)
    return matmul_argmax(pre.permute(0, 2, 3, 1), _pointwise(head.conv_seg), head.conv_seg.bias)


def fused_head_forward(head, features: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The 'full' eval head: argmax ids [B, H, W] int32 at the s0 resolution
    (JAX ``fused_head_forward`` with ``MADM_DW_IMPL=pallas``).

    Embeds and their bilinear resize, the 1024-channel concat, aspp_0 and
    the pointwise convs as NHWC products, each dilated depthwise conv in
    ``dw_branches`` (K6, one call a dilation), the bottleneck 3x3 conv in
    plain torch, conv_seg + argmax in ``matmul_argmax`` (K7).  The
    products' BN is folded in fp32 and applied in the head's dtype, as JAX
    does; K6 takes fp32 taps and its BN in fp32."""
    cd = head.conv_seg.weight.dtype
    xcat = torch.cat([e.permute(0, 2, 3, 1) for e in head.embeds(features)], dim=-1).contiguous()

    def bn_relu(y, bn, channel_dim=-1):
        s, b = (t.to(cd) for t in _fold_bn(bn))
        if channel_dim == 1:
            s, b = s[:, None, None], b[:, None, None]
        return F.relu(y * s + b)

    fl = head.fuse_layer
    a0 = fl.aspp_modules[0]
    branches = [bn_relu(xcat @ _pointwise(a0.conv), a0.bn)]
    for m, d in zip(fl.aspp_modules[1:], head.dilations[1:]):
        dwc, pwc = m.depthwise_conv, m.pointwise_conv
        s, b = _fold_bn(dwc.bn)
        dwo = dw_branches([xcat], dwc.conv.weight[:, 0].permute(1, 2, 0)[None].float(),
                          s[None], b[None], (d,))[0]
        branches.append(bn_relu(dwo @ _pointwise(pwc.conv), pwc.bn))
        del dwo
    x = torch.cat(branches, dim=-1).permute(0, 3, 1, 2)  # NCHW view of NHWC memory
    del branches
    bk = fl.bottleneck
    y = bn_relu(F.conv2d(x, bk.conv.weight, padding=1), bk.bn, channel_dim=1)
    return matmul_argmax(y.permute(0, 2, 3, 1), _pointwise(head.conv_seg), head.conv_seg.bias)
