// RAFT correlation window lookup, forward, for Hopper.
//
// Replaces the TPU kernel liso_tpu/ops/corr_fused_pallas.py:_fwd_kernel,
// reached through _fused_fwd_impl and fused_corr_window. For every (batch,
// pixel p, level l, tap (i, j)) of the (2r+2)^2 = 64 integer taps around
// (floor(row / 2^l), floor(col / 2^l)) it computes
//     tap = bf16(<f0[p], f1cat[off_l + (r0 - 3 + i) * w_l + (c0 - 3 + j)]> * scale)
// and stores it as fp32; taps outside the level's padded (h_l, w_l) are 0.
//
// The TPU kernel computes the corr block f1cat @ f0_tile^T of a pixel tile
// over the whole level and reads the taps out of it. Here a block takes a
// tile of 8 x 8 pixels and, one level at a time, a region of cells: the
// bounding box of the tile's in-range window cells where it holds at most
// 20 x 20 cells (at smooth flow about 16 x 16 at level 0, 11 x 11 at level
// 1), else 20 x 20 cells centred on the tile's mean coords (the backward's
// region, corr_tile.cuh), always inside the level's padded extent. The
// block stages the tile's f0 rows once and the region's f1cat rows in
// chunks of 64 cells, all channels, in shared memory as bf16 (asynchronous
// copies, two buffers: the next chunk's copies fly while this one's
// product is formed), and forms the product [64 pixels] x [region cells]
// on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 sums). Each
// product is scaled and rounded to bf16 into a [64 pixels, region] block
// in shared memory, and each pixel's in-region taps are read from it, a
// window row a thread. A tap in range but outside the region (a large or
// scattered flow) goes to a queue in shared memory; once the level's
// in-region taps are written, each thread takes queued taps and sums each
// over all channels from f1cat in device memory, its 16-byte loads in
// flight together, so no tap is dropped. The two paths sum the same exact
// bf16 x bf16 products in fp32 in different orders, as the plain version
// (one fp32 matmul) does in a third.
//
// Bound: bytes. At the serving width (B=8, HW=4096, C=128, M=5440, L=4) a
// lookup reads 8 MB of f0 and 11 MB of f1cat and writes 34 MB of taps. The
// region rows come from L2: at smooth flow about 520 cells of 256 bytes
// per tile, 70 MB per call (the warp-per-pixel kernel this replaces read
// 2.1 GB), and the dense products over the regions are about 5 GFLOP on
// the tensor cores.
#include <limits.h>

#include "corr_tile.cuh"

namespace {

using namespace corr_tile;

// the tile and region shape: the measured choice (PERF.md §6 gives the
// 4 x 16 and 2 x 32 tiles' times)
constexpr int kTH = 8, kTW = 8;
constexpr int kPix = kTH * kTW;
static_assert(kPix == 64, "a tile is 64 pixels: four m16 row blocks");
constexpr int kRH = 20, kRW = 20;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 64;  // region cells staged at a time: 8 n8 tiles
// the product block's row stride in bf16 elements: an odd count of words
constexpr int kPStride = kRH * kRW + 2;

size_t smem_bytes(int c) {
  return sizeof(__nv_bfloat16) *
         ((size_t)(kPix + 2 * kChunk) * (c + 8) + (size_t)kPix * kPStride) +
         sizeof(uint16_t) * kTaps * kPix;
}

__global__ void __launch_bounds__(kThreads, 2)
corr_window_fwd_kernel(const __nv_bfloat16* __restrict__ f0,
                       const __nv_bfloat16* __restrict__ f1,
                       const float* __restrict__ coords,
                       float* __restrict__ out, int hw, int wpix, int c,
                       int m, Levels lv, float scale) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  // rows of c + 8 bf16: an odd count of 16-byte units, so the 8 rows of
  // an ldmatrix fall on distinct banks
  const int fs = c + 8;
  __nv_bfloat16* f0t = smem;                 // [kPix][fs]
  __nv_bfloat16* f1c = f0t + kPix * fs;      // 2 x [kChunk][fs]
  __nv_bfloat16* prod = f1c + 2 * kChunk * fs;  // [kPix][kPStride]
  // taps outside the region: t * kPix + q
  uint16_t* queue = reinterpret_cast<uint16_t*>(prod + kPix * kPStride);
  __shared__ float2 mean;
  __shared__ int r0s[kPix], c0s[kPix];
  __shared__ int n_queued;
  // the bounding box of the level's in-range window cells of the tile:
  // first row, last row, first col, last col
  __shared__ int box[4];

  const int b = blockIdx.y;
  const int hpix = hw / wpix;
  const int tiles_x = (wpix + kTW - 1) / kTW;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x % tiles_x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, qd = lane & 3;  // mma fragment coordinates
  const float* cr = coords + (size_t)b * 2 * hw;
  const float* cc = cr + hw;
  const __nv_bfloat16* f1b = f1 + (size_t)b * m * c;
  const int nt_all = lv.n * kTaps;
  // 16-byte vectors a row (a power of two that divides kThreads): thread
  // T stages vector T % vecs of rows T / vecs, T / vecs + per, ...
  const int vecs = c / 8, per = kThreads / vecs;
  const int v0 = threadIdx.x % vecs, row0 = threadIdx.x / vecs;

  auto pixel = [&](int q) {
    return tile_pixel<kTH, kTW>(q, ty, tx, hpix, wpix);
  };

  if (warp == 0) {
    const float2 mn = tile_mean<kTH, kTW>(cr, cc, ty, tx, hpix, wpix, lane);
    if (lane == 0) {
      mean = mn;
      box[0] = box[2] = INT_MAX;
      box[1] = box[3] = INT_MIN;
    }
  }
  // the tile's f0 rows, zero outside the grid
  for (int q = row0; q < kPix; q += per) {
    const int p = pixel(q);
    cp_async16(f0t + q * fs + v0 * 8,
               f0 + ((size_t)b * hw + max(p, 0)) * c + v0 * 8, p >= 0);
  }
  cp_async_commit();

  // this warp's product tile: pixels 16 * (warp % 4) + [0, 16), cells
  // 32 * (warp / 4) + [0, 32) of each chunk
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row

  for (int l = 0; l < lv.n; ++l) {
    cp_async_wait<0>();
    __syncthreads();  // f0t and mean; the previous level's taps are read
    const float div = (float)(1 << l);
    const int hl = lv.h[l], wl = lv.w[l], off = lv.off[l];
    if (threadIdx.x < kPix) {
      const int p = pixel(threadIdx.x);
      const int r0 = p < 0 ? -(1 << 28) : window_cell(cr[p], div);
      const int c0 = p < 0 ? -(1 << 28) : window_cell(cc[p], div);
      r0s[threadIdx.x] = r0;
      c0s[threadIdx.x] = c0;
      const int rlo = max(r0 - 3, 0), rhi = min(r0 + 4, hl - 1);
      const int clo = max(c0 - 3, 0), chi = min(c0 + 4, wl - 1);
      const bool any = rlo <= rhi && clo <= chi;  // a tap in range
      const int v[4] = {any ? rlo : INT_MAX, any ? rhi : INT_MIN,
                        any ? clo : INT_MAX, any ? chi : INT_MIN};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = e & 1 ? __reduce_max_sync(0xffffffffu, v[e])
                            : __reduce_min_sync(0xffffffffu, v[e]);
        if (lane == 0) {
          if (e & 1) atomicMax(&box[e], x); else atomicMin(&box[e], x);
        }
      }
    }
    if (threadIdx.x == 0) n_queued = 0;
    __syncthreads();  // the window cells and their box
    // the region: the box where it holds at most kRH * kRW cells, else
    // kRH x kRW cells centred on the tile's mean coords; either way inside
    // the level
    int ro, co, rh, rw;
    if (box[0] > box[1]) {  // no tap of the tile is in range
      ro = co = rh = rw = 0;
    } else if ((box[1] - box[0] + 1) * (box[3] - box[2] + 1) <= kRH * kRW) {
      ro = box[0];
      co = box[2];
      rh = box[1] - box[0] + 1;
      rw = box[3] - box[2] + 1;
    } else {
      rh = min(kRH, hl);
      rw = min(kRW, wl);
      ro = min(max(region_origin(mean.x, div, rh), 0), hl - rh);
      co = min(max(region_origin(mean.y, div, rw), 0), wl - rw);
    }
    const int ncells = rh * rw;

    // the region's f1cat rows from cell `base` on into a chunk buffer,
    // zero past the region
    auto stage = [&](int base, __nv_bfloat16* buf) {
      int n = base + row0, rr = n / rw, rc = n - rr * rw;
      for (int cell = row0; cell < kChunk; cell += per) {
        const bool ok = n < ncells;
        cp_async16(buf + cell * fs + v0 * 8,
                   f1b + (ok ? (size_t)(off + (ro + rr) * wl + co + rc) * c : 0) + v0 * 8,
                   ok);
        n += per;
        for (rc += per; rc >= rw; rc -= rw) ++rr;
      }
    };
    const int nchunks = (ncells + kChunk - 1) / kChunk;
    if (nchunks > 0) stage(0, f1c);
    cp_async_commit();
    for (int k = 0; k < nchunks; ++k) {
      const int base = k * kChunk;
      const __nv_bfloat16* cur = f1c + (k & 1) * kChunk * fs;
      if (k + 1 < nchunks) stage(base + kChunk, f1c + ((k + 1) & 1) * kChunk * fs);
      cp_async_commit();
      cp_async_wait<1>();  // this chunk's copies have landed
      __syncthreads();
      if (base + n0 < ncells) {
        float acc[4][4] = {};
        for (int ks = 0; ks < c / 16; ++ks) {
          unsigned a[4], bb[2][4];
          ldsm_x4(a, f0t + (m0 + mr + 8 * (mi & 1)) * fs + ks * 16 + 8 * (mi >> 1));
#pragma unroll
          for (int j = 0; j < 2; ++j)
            ldsm_x4(bb[j], cur + (n0 + 16 * j + mr + 8 * (mi >> 1)) * fs +
                               ks * 16 + 8 * (mi & 1));
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma(acc[nt], a, bb[nt >> 1] + 2 * (nt & 1));
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = base + n0 + 8 * nt + 2 * qd;
          if (n >= ncells) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<__nv_bfloat162*>(
                prod + (m0 + grp + 8 * h) * kPStride + n) =
                __floats2bfloat162_rn(acc[nt][2 * h] * scale,
                                      acc[nt][2 * h + 1] * scale);
        }
      }
      __syncthreads();  // this chunk's buffer is free for chunk k + 2; the products
    }

    // the taps: thread (window row i, pixel slot q) writes the row's 8
    // taps; a warp covers 32 pixels of one row, so each tap is written in
    // runs of a tile row
    float* outl = out + ((size_t)b * nt_all + l * kTaps) * hw;
    for (int item = threadIdx.x; item < kW1 * kPix; item += kThreads) {
      const int i = item / kPix, q = item % kPix, p = pixel(q);
      const int row = r0s[q] - 3 + i, c0 = c0s[q] - 3;
      const bool row_ok = p >= 0 && row >= 0 && row < hl;
      const bool row_in = row_ok && (unsigned)(row - ro) < (unsigned)rh;
      const __nv_bfloat16* pr = prod + q * kPStride + (row - ro) * rw - co;
#pragma unroll
      for (int j = 0; j < kW1; ++j) {
        const int col = c0 + j;
        const bool in_range = row_ok && col >= 0 && col < wl;
        const bool in_region = row_in && (unsigned)(col - co) < (unsigned)rw;
        const int t = i * kW1 + j;
        if (p >= 0 && (in_region || !in_range))
          outl[(size_t)t * hw + p] = in_region ? __bfloat162float(pr[col]) : 0.0f;
        const bool side = in_range && !in_region;
        const unsigned ball = __ballot_sync(0xffffffffu, side);
        if (ball) {
          int at = 0;
          if (lane == 0) at = atomicAdd(&n_queued, __popc(ball));
          at = __shfl_sync(0xffffffffu, at, 0);
          if (side) queue[at + __popc(ball & ((1u << lane) - 1))] = (uint16_t)(t * kPix + q);
        }
      }
    }
    __syncthreads();  // the queue
    if (threadIdx.x == 0) {  // the next level's box
      box[0] = box[2] = INT_MAX;
      box[1] = box[3] = INT_MIN;
    }
    // the queued taps, one a thread: the dot over every channel
    const int nq = n_queued;
    for (int e = threadIdx.x; e < nq; e += kThreads) {
      const int idx = queue[e];
      const int t = idx / kPix, q = idx % kPix, p = pixel(q);
      const int row = r0s[q] - 3 + t / kW1, col = c0s[q] - 3 + t % kW1;
      const uint4* fr = reinterpret_cast<const uint4*>(
          f1b + (size_t)(off + row * wl + col) * c);
      const uint4* ar = reinterpret_cast<const uint4*>(f0t + q * fs);
      float s = 0.0f;
#pragma unroll 4
      for (int v = 0; v < vecs; ++v) {
        const uint4 x = __ldg(fr + v), y = ar[v];
        s = fmaf(bf_lo(x.x), bf_lo(y.x), s);
        s = fmaf(bf_hi(x.x), bf_hi(y.x), s);
        s = fmaf(bf_lo(x.y), bf_lo(y.y), s);
        s = fmaf(bf_hi(x.y), bf_hi(y.y), s);
        s = fmaf(bf_lo(x.z), bf_lo(y.z), s);
        s = fmaf(bf_hi(x.z), bf_hi(y.z), s);
        s = fmaf(bf_lo(x.w), bf_lo(y.w), s);
        s = fmaf(bf_hi(x.w), bf_hi(y.w), s);
      }
      outl[(size_t)t * hw + p] = __bfloat162float(__float2bfloat16_rn(s * scale));
    }
  }
}

}  // namespace

// f0 [B, HW, C] bf16, f1cat [B, M, C] bf16, coords [B, 2, HW] fp32 (row,
// col at level 0), out [B, L*64, HW] fp32; all contiguous and 16-byte
// aligned, C a power of two from 16 to 256. level_meta is HOST memory: 3*L ints, the
// padded (h, w) of every level and its row offset in f1cat, then one more
// int, the width of the pixel grid (HW = its height * width, row-major).
extern "C" int corr_window_fwd(const void* f0, const void* f1cat,
                               const void* coords, void* out, int b, int hw,
                               int c, int m, int n_levels,
                               const int* level_meta, float scale,
                               void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || c < 16 || c > 256 || (c & (c - 1)))
    return (int)cudaErrorInvalidValue;
  const int wpix = level_meta[3 * n_levels];
  if (wpix < 1 || hw % wpix != 0) return (int)cudaErrorInvalidValue;
  if (b == 0 || hw == 0) return (int)cudaSuccess;
  const Levels lv = levels_from_meta(n_levels, level_meta);
  // the shared-memory limit is raised once per device, to the largest
  // footprint asked for so far (it grows with C)
  static size_t smem_set[kMaxDevices] = {};
  const size_t smem = smem_bytes(c);
  cudaError_t err = raise_smem_limit((const void*)corr_window_fwd_kernel,
                                     smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((hw / wpix + kTH - 1) / kTH) * ((wpix + kTW - 1) / kTW);
  dim3 blocks(tiles, b);
  corr_window_fwd_kernel<<<blocks, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(f0),
      static_cast<const __nv_bfloat16*>(f1cat),
      static_cast<const float*>(coords), static_cast<float*>(out), hw, wpix,
      c, m, lv, scale);
  return (int)cudaGetLastError();
}
