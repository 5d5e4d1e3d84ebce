// Scatter-add of scalar per-point values over sorted bins, for Hopper.
//
// Replaces the TPU kernel liso_tpu/ops/grid_scatter_pallas.py:
// _reduce_kernel_c1, reached through _grid_reduce_impl with C == 1 and
// op="add": the dynamicness-threshold histogram of the SLIM train step
// (liso_tpu/models/slim.py:movavg_update_batched), one row per RAFT
// iteration, 100000 bins padded to a multiple of 2048. That kernel places
// each value at its bin row with a masked lane-sum because TPU scatters
// serialise. Here the values arrive sorted by bin, so every bin's values are
// one contiguous range and no atomics are needed.
//
// Design: a cluster of kSplit blocks owns a span of kSplit x kTile bins of
// one row, and each of its blocks writes kTile of them. Each block finds
// the span's values [L0, H0) with two warp searches (cell_ranges.cuh): no
// host-side search. The blocks split those values evenly, whatever their
// bins: early in SLIM training the sigmoid of near-random weights puts
// most of a row's 131072 values into one bin, and eight SMs then share it.
// A block walks its share in chunks of kChunk values, each loaded coalesced
// and staged in shared memory (the next chunk's loads start before the
// current one is summed). Each thread sums its kPer consecutive values
// serially, bin run by bin run, in the values' order; a segmented scan over
// the threads (warp shuffles, then the warps' totals) carries a run that
// crosses a thread's or a chunk's edge. A finished bin sum goes, by one
// thread, into the shared memory of the block that writes its bin
// (distributed shared memory). The run a block continues from the block
// before, and the run open at its end, are finished when the cluster meets:
// each block then adds the totals of the blocks before it, in rank order.
// Each block writes its kTile sums once, coalesced, empty bins as 0. No
// atomics, and every order is fixed: the result is deterministic. The drop
// bucket (ids >= num_bins, int32 max) sorts past the last span and is never
// read.
//
// Bound: bytes. At the train step's width (6 rows of 131072 values into
// 100352 bins) it reads 3.1 MB of values and 3.1 MB of bins and writes
// 2.4 MB; the 786k adds are nothing at the card's rate.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cell_ranges.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 2048;              // bins each block writes
constexpr int kSplit = 8;                // blocks per cluster
constexpr int kSpan = kSplit * kTile;    // bins per cluster
constexpr int kPer = 16;                 // consecutive values per thread
constexpr int kChunk = kThreads * kPer;  // values staged at a time
constexpr int kPad = 4;  // sbin[kPad - 1]: the bin before the chunk

// Starts the coalesced loads of the chunk at c (values, and bins relative
// to the span; past hi, zeros).
__device__ __forceinline__ void fetch(const float* __restrict__ v,
                                      const int* __restrict__ bn, int c,
                                      int hi, int cbase, float (&pv)[kPer],
                                      int (&pb)[kPer]) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = c + k * kThreads + (int)threadIdx.x;
    pv[k] = i < hi ? v[i] : 0.0f;
    pb[k] = i < hi ? bn[i] - cbase : 0;
  }
}

// Puts the sum x of span bin `bin` into the shared memory of the cluster's
// block that writes it.
__device__ __forceinline__ void put(float* sums, int bin, float x) {
  *cg::this_cluster().map_shared_rank(sums + bin % kTile, bin / kTile) = x;
}

// (f, a), the segmented scan's element: f says a run starts in the values
// it covers, a is the sum of the run open at their end. (f, a) then (g, b)
// combine to (f | g, g ? b : a + b).
struct Part {
  int f;
  float a;
};

__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads, 3)
grid_reduce_add_c1_kernel(const float* __restrict__ vals,
                          const int* __restrict__ bins,
                          float* __restrict__ out, int n, int num_bins) {
  __shared__ __align__(16) float sval[kChunk];
  __shared__ __align__(16) int sbin[kPad + kChunk];  // relative to cbase
  __shared__ float sums[kTile];  // this block's bins of the span
  __shared__ int range[2];
  __shared__ int wflag[kWarps];
  __shared__ float wsum[kWarps];
  __shared__ Part part;         // this block's values, for the blocks after
  __shared__ int lead_ends;     // the run continued from before ends here,
  __shared__ float lead_sum;    // its sum over this block's values
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int rank = (int)cluster.block_rank();
  const int r = blockIdx.y;
  const int cbase = blockIdx.x / kSplit * kSpan;
  const int span = min(kSpan, num_bins - cbase);
  const float* v = vals + (size_t)r * n;
  const int* bn = bins + (size_t)r * n;

  if (warp < 2) {
    const int p = cell_ranges::warp_lower_bound(bn, n, cbase + warp * span);
    if (lane == 0) range[warp] = p;
  }
  for (int k = t; k < kTile; k += kThreads) sums[k] = 0.0f;
  if (t == 0) lead_ends = 0;
  cluster.sync();  // every block's sums are 0 before any is put
  const int share = (range[1] - range[0] + kSplit - 1) / kSplit;
  const int lo = min(range[1], range[0] + rank * share);
  const int hi = min(range[1], lo + share);

  float pv[kPer];  // the next chunk, in flight
  int pb[kPer];
  int prev = -1;  // the bin of the run open before the chunk (-1: none)
  int next = -1;  // the bin of the next block's first value (-1: none)
  if (lo < hi) {
    fetch(v, bn, lo, hi, cbase, pv, pb);
    if (lo > range[0]) prev = bn[lo - 1] - cbase;
    if (hi < range[1]) next = bn[hi] - cbase;
  }
  int lead = -1;  // the bin of the run this block continues (-1: none)
  int heads = 0;  // a run starts in this block's values
  float carry = 0.0f;  // a of the block's values before the chunk
  // a finished run; the one continued from before waits for the cluster
  auto finish = [&](int bin, float x) {
    if (bin == lead) {
      lead_sum = x;
      lead_ends = 1;
    } else {
      put(sums, bin, x);
    }
  };
  for (int c = lo; c < hi; c += kChunk) {
    const int m = min(kChunk, hi - c);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = k * kThreads + t;
      if (i < m) {
        sval[i] = pv[k];
        sbin[kPad + i] = pb[k];
      }
    }
    if (t == 0) sbin[kPad - 1] = prev;
    __syncthreads();
    if (c + kChunk < hi) fetch(v, bn, c + kChunk, hi, cbase, pv, pb);
    if (c == lo && prev >= 0 && sbin[kPad] == prev) lead = prev;
    // the run open at the last chunk's end ended there if this chunk
    // starts with another bin
    if (t == 0 && c > lo && sbin[kPad] != prev) finish(prev, carry);

    // this thread's values: a run that starts and ends here is finished
    // here; the run it starts with (if no bin starts at its first value)
    // needs what came before, `tlead`
    const int p0 = t * kPer, cnt = min(kPer, m - p0);
    int f = 0, tlead = -1;
    float a = 0.0f, tlead_sum = 0.0f;
    if (cnt > 0) {
      int bp = sbin[kPad + p0 - 1];
#pragma unroll
      for (int q = 0; q < kPer / 4; ++q) {
        const float4 x4 = *reinterpret_cast<const float4*>(sval + p0 + 4 * q);
        const int4 b4 = *reinterpret_cast<const int4*>(sbin + kPad + p0 + 4 * q);
        const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
        const int bs[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = 4 * q + u;
          if (j < cnt) {
            if (bs[u] != bp) {  // a run starts at j: the one before ended
              if (j > 0) {
                if (f) {
                  finish(bp, a);
                } else {
                  tlead = bp;
                  tlead_sum = a;
                }
              }
              f = 1;
              a = xs[u];
            } else {
              a += xs[u];
            }
            bp = bs[u];
          }
        }
      }
      // the last run ends here if the chunk's next value starts another bin
      if (p0 + cnt < m && sbin[kPad + p0 + cnt] != bp) {
        if (f) {
          finish(bp, a);
        } else {
          tlead = bp;
          tlead_sum = a;
        }
      }
    }

    // inclusive scan of (f, a) over the warp's lanes, then over the warps
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int g = __shfl_up_sync(0xffffffffu, f, d);
      const float b = __shfl_up_sync(0xffffffffu, a, d);
      if (lane >= d) {
        a = f ? a : b + a;
        f |= g;
      }
    }
    const int xf = __shfl_up_sync(0xffffffffu, f, 1);
    const float xa = __shfl_up_sync(0xffffffffu, a, 1);
    if (lane == 31) {
      wflag[warp] = f;
      wsum[warp] = a;
    }
    __syncthreads();
    float before = carry, total = carry;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w == warp) before = total;
      heads |= wflag[w];
      total = wflag[w] ? wsum[w] : total + wsum[w];
    }
    // the sum of what precedes this thread's values, then its lead run
    const float e = lane == 0 ? before : xf ? xa : before + xa;
    if (tlead >= 0) finish(tlead, e + tlead_sum);
    prev = sbin[kPad + m - 1];
    carry = total;
    __syncthreads();
  }
  if (t == 0) part = Part{heads, carry};
  cluster.sync();  // every block's part and finished sums are in place

  if (warp == 0 && lo < hi) {
    // a of the values of the blocks before this one: lane q reads block
    // q's part, and a scan over the lanes joins them
    Part o{0, 0.0f};
    if (lane < rank) o = *cluster.map_shared_rank(&part, lane);
#pragma unroll
    for (int d = 1; d < kSplit; d <<= 1) {
      const int g = __shfl_up_sync(0xffffffffu, o.f, d);
      const float b = __shfl_up_sync(0xffffffffu, o.a, d);
      if (lane >= d) {
        o.a = o.f ? o.a : b + o.a;
        o.f |= g;
      }
    }
    const float x = rank > 0 ? __shfl_sync(0xffffffffu, o.a, rank - 1) : 0.0f;
    if (lane == 0) {
      if (lead_ends) put(sums, lead, x + lead_sum);
      // the run open at this block's end ends here unless the next block
      // goes on with it
      if (next != prev) put(sums, prev, heads ? carry : x + carry);
    }
  }
  cluster.sync();  // every sum is in place

  const int tile = min(kTile, span - rank * kTile);
  float* o = out + (size_t)r * num_bins + cbase + rank * kTile;
  for (int k = t; k < tile; k += kThreads) o[k] = sums[k];
}

}  // namespace

// vals [R, N] fp32 and bins [R, N] int32, sorted by bin within each row (ids
// >= num_bins are dropped); out [R, num_bins] fp32. All contiguous.
extern "C" int grid_reduce_add_c1(const void* vals, const void* bins,
                                  void* out, int rows, int n, int num_bins,
                                  void* stream) {
  if (rows == 0 || num_bins == 0) return (int)cudaSuccess;
  dim3 blocks((num_bins + kSpan - 1) / kSpan * kSplit, rows);
  grid_reduce_add_c1_kernel<<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(bins),
      static_cast<float*>(out), n, num_bins);
  return (int)cudaGetLastError();
}
