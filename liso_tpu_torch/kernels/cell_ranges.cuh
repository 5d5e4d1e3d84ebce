// Point ranges of a tile of cells, found inside the kernel, for Hopper.
//
// The scatter kernels take points sorted by cell id within each sample (or
// row). The TPU wrapper gives each tile of cells its range of points with a
// host-side searchsorted of the tile bounds (liso_tpu/ops/
// grid_scatter_pallas.py:_tile_starts). Here each thread block finds the
// range of its own tile: one warp per bound runs a 33-way search over the
// sorted ids (four rounds of dependent loads over 131072 ids). K1 and K1-add
// then derive every cell's start from the tile's own points (tile_starts),
// with no search per cell and no launch or pass besides the kernel's; K3
// walks the range itself.
#pragma once

#include <cuda_runtime.h>

namespace cell_ranges {

// First index i in [0, n) with ids[i] >= key (n if none), for ids ascending.
// Called by all 32 lanes of a warp with the same arguments; every lane
// returns the same value. Each round the 32 lanes probe 32 points that cut
// [lo, hi) into 33 parts; the ballot of `ids < key` is a prefix of the
// lanes, and its length names the part that holds the bound.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ ids,
                                                int n, int key) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the bound lies in [lo, hi]
  while (hi - lo > 32) {
    const long long span = hi - lo;
    const int p = lo + (int)(span * (lane + 1) / 33);  // lo < p < hi
    const int k = __popc(__ballot_sync(0xffffffffu, ids[p] < key));
    const int nlo = k > 0 ? lo + (int)(span * k / 33) + 1 : lo;
    const int nhi = k < 32 ? lo + (int)(span * (k + 1) / 33) : hi;
    lo = nlo;
    hi = nhi;
  }
  const int p = lo + lane;
  return lo + __popc(__ballot_sync(0xffffffffu, p < hi && ids[p] < key));
}

// Block-wide: fills starts[0 .. cells] (shared memory) so that the points
// of cell base + k are [starts[k], starts[k + 1]) of ids [n] (ascending;
// ids of later cells and of the drop bucket, int32 max included, sort after
// the tile). `range` is two ints of shared memory; the block needs at least
// two warps. Starts with and ends with __syncthreads.
//
// The tile's points are [lo, hi), the lower bounds of base and base + cells.
// Point p (lo <= p <= hi) writes the starts of the cells after its
// predecessor's cell up to its own (point hi stands for the tile's end), so
// every start is written once and the work is the tile's points plus its
// cells. Each thread loads kUnroll points before it writes, so that a tile
// holding a whole sample's points keeps several loads in flight.
template <int kThreads>
__device__ __forceinline__ void tile_starts(const int* __restrict__ ids, int n,
                                            int base, int cells, int* starts,
                                            int* range) {
  constexpr int kUnroll = 4;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if (warp < 2) {
    const int r = warp_lower_bound(ids, n, base + warp * cells);
    if ((threadIdx.x & 31) == 0) range[warp] = r;
  }
  __syncthreads();
  const int lo = range[0], hi = range[1];
  for (int p0 = lo + (int)threadIdx.x; p0 <= hi; p0 += kUnroll * kThreads) {
    int prev[kUnroll], cur[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u * kThreads;
      prev[u] = p > lo && p <= hi ? ids[p - 1] - base : -1;
      cur[u] = p < hi ? ids[p] - base : cells;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u * kThreads;
      if (p > hi) break;
      for (int k = prev[u] + 1; k <= cur[u]; ++k) starts[k] = p;
    }
  }
  __syncthreads();
}

}  // namespace cell_ranges
