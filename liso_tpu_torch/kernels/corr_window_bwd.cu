// RAFT correlation window lookup, backward, for Hopper.
//
// Replaces the TPU kernel liso_tpu/ops/corr_fused_pallas.py:_bwd_kernel,
// reached through _fused_bwd_impl, the VJP of fused_corr_window. The forward
// (corr_window_fwd.cu) returns, for every pixel p and every tap t of level l,
// tap = bf16(<f0[p], f1cat[m]> * scale) with m = off_l + row * w_l + col the
// tap's cell; out-of-range taps are 0. Given the taps' cotangent g, the TPU
// kernel scatters g back to a [M, P] corr block per pixel tile, scales it and
// rounds it to bf16, and forms df0 = dcorr^T f1cat and df1 += dcorr f0 with
// two MXU matmuls, df1 summed in a VMEM block across its sequential grid:
//     d = bf16(g[t, p] * scale)         (the TPU kernel's bf16 cotangent)
//     df0[p] += d * f1cat[m]
//     df1[m] += d * bf16(f0[p])
// for every in-range tap; a tap outside its level's padded extent has no
// cell and contributes nothing. d times a bf16 value is exact in fp32, so
// the kernel and the plain version (dense scatter + two fp32 matmuls) differ
// only in the order of their fp32 sums.
//
// On the H100 blocks run in parallel, so df1's sum across blocks needs
// atomics; the design decides how many. A block takes a 2-D tile of 8 x 8
// pixels and 32 channels, one level at a time. Its pixels' windows fall
// mostly in one region of kS x kS cells of the level, centred on the mean
// of the pixels' coords. As the TPU kernel does, the block places each
// in-region tap's d in a dense bf16 block dcorr [64 pixels, kS * kS cells]
// in shared memory and forms both products on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 sums):
//     df1[region] += dcorr^T f0[tile]     flushed to df1 with one global
//                                         atomic per touched (cell, channel)
//     df0[tile]   += dcorr f1cat[region]  kept in registers across levels
// A tap in range but outside the region (large or scattered flow) is done
// at once by its warp, lane = channel, with global atomics into df1 and
// df0. df0 is zeroed by the caller and written by atomics. The region is
// not summed per tap in shared memory: Hopper has no shared fp32 atomic
// add (it compiles to a compare-and-swap loop), and where eight warps'
// windows overlap those loops ran slower than global atomics.
//
// Bound: bytes. At the train step's width (B=1, HW=13225 on a 115 x 115
// grid, C=128, M=19776, L=4) a call reads 13.5 MB of cotangent, 3.4 MB of
// f0 and 5.1 MB of f1cat and writes 6.8 MB of df0 and 10.1 MB of df1. The
// 433 M products of each output become 1.44 M mma instructions each (dense
// over the region), and the global atomics fall from 433 M to one per
// touched (cell, channel) of a block plus the taps outside the regions.
#include "corr_tile.cuh"

namespace {

using namespace corr_tile;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 8;  // tile side in pixels
constexpr int kPix = kTile * kTile;
constexpr int kS = 20;  // region side in cells
constexpr int kCells = kS * kS;  // 400 = 25 x 16
constexpr int kCh = 32;  // channels of a block
// shared row strides in bf16 elements: rows of 816 and 80 bytes put the 8
// rows of an ldmatrix on distinct banks
constexpr int kDStride = kCells + 8;
constexpr int kFStride = kCh + 8;
constexpr size_t kSmem =
    sizeof(__nv_bfloat16) * (kPix * kDStride + kCells * kFStride + kPix * kFStride);

__device__ __forceinline__ void add2(float* p, float x, float y) {
  if (x != 0.f || y != 0.f) atomicAdd(reinterpret_cast<float2*>(p), make_float2(x, y));
}

__global__ void __launch_bounds__(kThreads, 2)
corr_window_bwd_kernel(const __nv_bfloat16* __restrict__ f0,
                       const __nv_bfloat16* __restrict__ f1,
                       const float* __restrict__ coords,
                       const float* __restrict__ g,
                       float* __restrict__ df0, float* __restrict__ df1,
                       int hw, int wpix, int c, int m, Levels lv,
                       float scale) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* dcorr = smem;                     // [kPix][kDStride]
  __nv_bfloat16* f1r = dcorr + kPix * kDStride;    // [kCells][kFStride]
  __nv_bfloat16* f0t = f1r + kCells * kFStride;    // [kPix][kFStride]
  __shared__ float mean[2];
  __shared__ int r0s[kPix], c0s[kPix];

  const int b = blockIdx.z;
  const int ch0 = blockIdx.y * kCh;
  const int hpix = hw / wpix;
  const int tiles_x = (wpix + kTile - 1) / kTile;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x % tiles_x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, qd = lane & 3;  // mma fragment coordinates
  const float* cr = coords + (size_t)b * 2 * hw;
  const float* cc = cr + hw;
  const __nv_bfloat16* f1b = f1 + (size_t)b * m * c + ch0;
  float* df1b = df1 + (size_t)b * m * c + ch0;
  float* df0b = df0 + (size_t)b * hw * c + ch0;

  // the pixel of tile slot q, or -1 outside the grid
  auto pixel = [&](int q) {
    return tile_pixel<kTile, kTile>(q, ty, tx, hpix, wpix);
  };

  // the region's centre: the mean coords of the tile's pixels near the grid
  if (warp == 0) {
    const float2 mn = tile_mean<kTile, kTile>(cr, cc, ty, tx, hpix, wpix, lane);
    if (lane == 0) {
      mean[0] = mn.x;
      mean[1] = mn.y;
    }
  }
  // the tile's f0 (bf16, 4 x 16 bytes a pixel), zero outside the grid
  for (int i = threadIdx.x; i < kPix * kCh / 8; i += kThreads) {
    const int q = i / (kCh / 8), v = i % (kCh / 8), p = pixel(q);
    uint4 x = make_uint4(0, 0, 0, 0);
    if (p >= 0)
      x = __ldg(reinterpret_cast<const uint4*>(f0 + ((size_t)b * hw + p) * c + ch0) + v);
    *reinterpret_cast<uint4*>(f0t + q * kFStride + v * 8) = x;
  }
  __syncthreads();  // mean and f0t
  // df0 of this warp's output tiles: pixels 16 * (warp / 2) + [0, 16),
  // channels 16 * (warp % 2) + [0, 16), summed over every level
  float acc0[2][4] = {};
  const int nt_items = lv.n * kTaps;
  // this thread's taps of a level: pixel slot q, taps tq + 4 k
  const int q = threadIdx.x % kPix, tq = threadIdx.x / kPix;
  const int pq = pixel(q);
  constexpr int kItems = kTaps * kPix / kThreads;  // 16

  for (int l = 0; l < lv.n; ++l) {
    const float div = (float)(1 << l);
    const int hl = lv.h[l], wl = lv.w[l], off = lv.off[l];
    const int ro = region_origin(mean[0], div, kS);
    const int co = region_origin(mean[1], div, kS);
    // this level's cotangents of the thread's taps, all loads in flight
    // together
    float gv[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      gv[k] = pq >= 0
          ? g[((size_t)b * nt_items + l * kTaps + tq + 4 * k) * hw + pq] : 0.f;
    uint4* d4 = reinterpret_cast<uint4*>(dcorr);
    for (int i = threadIdx.x; i < kPix * kDStride / 8; i += kThreads)
      d4[i] = make_uint4(0, 0, 0, 0);
    // the region's f1cat rows, zero outside the level
    constexpr int kF1Vecs = kCells * kCh / 8;
#pragma unroll
    for (int k = 0; k < (kF1Vecs + kThreads - 1) / kThreads; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i >= kF1Vecs) break;
      const int cell = i / (kCh / 8), v = i % (kCh / 8);
      const int row = ro + cell / kS, col = co + cell % kS;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (row >= 0 && row < hl && col >= 0 && col < wl)
        x = __ldg(reinterpret_cast<const uint4*>(
                      f1b + (size_t)(off + row * wl + col) * c) + v);
      *reinterpret_cast<uint4*>(f1r + cell * kFStride + v * 8) = x;
    }
    if (threadIdx.x < kPix) {
      const int p = pixel(threadIdx.x);
      r0s[threadIdx.x] = p < 0 ? -(1 << 28) : window_cell(cr[p], div);
      c0s[threadIdx.x] = p < 0 ? -(1 << 28) : window_cell(cc[p], div);
    }
    __syncthreads();

    // place each in-region tap's d; a tap in range outside the region is
    // done here by its warp, one lane per channel
    const int r0 = r0s[q], c0 = c0s[q];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int t = tq + 4 * k;
      const int row = r0 - 3 + t / kW1, col = c0 - 3 + t % kW1;
      const bool in_range = row >= 0 && row < hl && col >= 0 && col < wl;
      const int rr = row - ro, rc = col - co;
      const bool in_region = in_range && (unsigned)rr < (unsigned)kS &&
                             (unsigned)rc < (unsigned)kS;
      const float d = __bfloat162float(__float2bfloat16_rn(gv[k] * scale));
      if (in_region) dcorr[q * kDStride + rr * kS + rc] = __float2bfloat16_rn(d);
      unsigned side = __ballot_sync(0xffffffffu, in_range && !in_region);
      while (side) {
        const int src = __ffs(side) - 1;
        side &= side - 1;
        const int sq = __shfl_sync(0xffffffffu, q, src);
        const int sp = __shfl_sync(0xffffffffu, pq, src);
        const float sd = __shfl_sync(0xffffffffu, d, src);
        const int cell = off + __shfl_sync(0xffffffffu, row, src) * wl +
                         __shfl_sync(0xffffffffu, col, src);
        atomicAdd(df1b + (size_t)cell * c + lane,
                  sd * __bfloat162float(f0t[sq * kFStride + lane]));
        atomicAdd(df0b + (size_t)sp * c + lane,
                  sd * __bfloat162float(f1b[(size_t)cell * c + lane]));
      }
    }
    __syncthreads();

    // df1[region] = dcorr^T f0[tile]: M = 400 cells (25 m-tiles, warp w
    // takes w, w + 8, ...), N = 32 channels, K = 64 pixels; flushed at once
    for (int mt = warp; mt < kCells / 16; mt += kWarps) {
      float acc[4][4] = {};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int i = lane >> 3, r = lane & 7;
        unsigned a[4], bb[2][4];  // A[cell][pixel] = dcorr[pixel][cell]
        ldsm_x4_t(a, dcorr + (ks * 16 + r + 8 * (i >> 1)) * kDStride + mt * 16 + 8 * (i & 1));
        // B = f0[tile] [64 pixels = K][32 channels = N], 2 n-tiles a load
#pragma unroll
        for (int j = 0; j < 2; ++j)
          ldsm_x4_t(bb[j], f0t + (ks * 16 + r + 8 * (i & 1)) * kFStride + 16 * j + 8 * (i >> 1));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma(acc[nt], a, bb[nt >> 1] + 2 * (nt & 1));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cell = mt * 16 + grp + 8 * h;
        const int row = ro + cell / kS, col = co + cell % kS;
        if (row < 0 || row >= hl || col < 0 || col >= wl) continue;
        float* dst = df1b + (size_t)(off + row * wl + col) * c + 2 * qd;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          add2(dst + nt * 8, acc[nt][2 * h], acc[nt][2 * h + 1]);
      }
    }

    // df0[tile] += dcorr f1cat[region]: M = 64 pixels, N = 32 channels,
    // K = 400 cells; warp w takes pixels 16 (w / 2) + [0, 16) and channels
    // 16 (w % 2) + [0, 16)
    {
      const int m0 = 16 * (warp >> 1), n0 = 16 * (warp & 1);
      const int i = lane >> 3, r = lane & 7;
#pragma unroll 5
      for (int ks = 0; ks < kCells / 16; ++ks) {
        unsigned a[4], bb[4];
        ldsm_x4(a, dcorr + (m0 + r + 8 * (i & 1)) * kDStride + ks * 16 + 8 * (i >> 1));
        ldsm_x4_t(bb, f1r + (ks * 16 + r + 8 * (i & 1)) * kFStride + n0 + 8 * (i >> 1));
        mma(acc0[0], a, bb);
        mma(acc0[1], a, bb + 2);
      }
    }
    __syncthreads();
  }

  // df0 (zeroed by the caller; side taps added to it already)
  const int m0 = 16 * (warp >> 1), n0 = 16 * (warp & 1);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = pixel(m0 + grp + 8 * h);
    if (p < 0) continue;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      add2(df0b + (size_t)p * c + n0 + nt * 8 + 2 * qd, acc0[nt][2 * h],
           acc0[nt][2 * h + 1]);
  }
}

}  // namespace

// f0 [B, HW, C] bf16, f1cat [B, M, C] bf16, coords [B, 2, HW] fp32 (row,
// col at level 0), g [B, L*64, HW] fp32; df0 [B, HW, C] and df1 [B, M, C]
// fp32, both ZEROED by the caller and accumulated here. All contiguous and
// 16-byte aligned, C % 32 == 0. level_meta is HOST memory: 3*L ints, the
// padded (h, w) of every level and its row offset in f1cat, then one more
// int, the width of the pixel grid (HW = its height * width, row-major).
extern "C" int corr_window_bwd(const void* f0, const void* f1cat,
                               const void* coords, const void* g, void* df0,
                               void* df1, int b, int hw, int c, int m,
                               int n_levels, const int* level_meta,
                               float scale, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || c % kCh != 0)
    return (int)cudaErrorInvalidValue;
  const int wpix = level_meta[3 * n_levels];
  if (wpix < 1 || hw % wpix != 0) return (int)cudaErrorInvalidValue;
  if (b == 0 || hw == 0) return (int)cudaSuccess;
  const Levels lv = levels_from_meta(n_levels, level_meta);
  // once per device: the footprint is fixed
  static size_t smem_set[kMaxDevices] = {};
  cudaError_t err = raise_smem_limit((const void*)corr_window_bwd_kernel,
                                     kSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int tiles =
      ((hw / wpix + kTile - 1) / kTile) * ((wpix + kTile - 1) / kTile);
  dim3 blocks(tiles, c / kCh, b);
  corr_window_bwd_kernel<<<blocks, kThreads, kSmem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(f0),
      static_cast<const __nv_bfloat16*>(f1cat),
      static_cast<const float*>(coords), static_cast<const float*>(g),
      static_cast<float*>(df0), static_cast<float*>(df1), hw, wpix, c, m, lv,
      scale);
  return (int)cudaGetLastError();
}
