// Scatter-add of scalar per-point values over sorted bins, for Hopper.
//
// Replaces the TPU kernel liso_tpu/ops/grid_scatter_pallas.py:
// _reduce_kernel_c1, reached through _grid_reduce_impl with C == 1 and
// op="add": the dynamicness-threshold histogram of the SLIM train step
// (liso_tpu/models/slim.py:movavg_update_batched), one row per RAFT
// iteration, 100000 bins padded to a multiple of 2048. That kernel places
// each value at its bin row with a masked lane-sum because TPU scatters
// serialise. Here the values arrive sorted by bin, so a searchsorted of the
// bin bounds (done by the wrapper) gives every bin its contiguous range
// [starts[k], starts[k+1]) and one warp sums one bin's range in fp32: no
// atomics, and every output is written once (empty bins as 0). The drop
// bucket (ids >= num_bins, int32 max) sorts past the last bin and is never
// read.
//
// Bound: bytes. At the train step's width (6 rows of 131072 values into
// 100352 bins) it reads 3.1 MB of values and 2.4 MB of starts and writes
// 2.4 MB; the 786k adds are nothing at the card's rate.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // bins per block

__global__ void __launch_bounds__(kWarps * 32)
grid_reduce_add_c1_kernel(const float* __restrict__ vals,
                          const int* __restrict__ starts,
                          float* __restrict__ out, int n, int num_bins) {
  const int lane = threadIdx.x & 31;
  const int bin = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int r = blockIdx.y;
  if (bin >= num_bins) return;
  const int* st = starts + (size_t)r * (num_bins + 1);
  const int s = st[bin];
  const int e = st[bin + 1];
  const float* v = vals + (size_t)r * n;
  float acc = 0.0f;
  for (int p = s + lane; p < e; p += 32) acc += v[p];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) out[(size_t)r * num_bins + bin] = acc;
}

}  // namespace

// vals [R, N] fp32 sorted by bin within each row, starts [R, num_bins + 1]
// int32 (range of bin k is [starts[k], starts[k+1])), out [R, num_bins]
// fp32. All contiguous.
extern "C" int grid_reduce_add_c1(const void* vals, const void* starts,
                                  void* out, int rows, int n, int num_bins,
                                  void* stream) {
  if (rows == 0 || num_bins == 0) return (int)cudaSuccess;
  dim3 blocks((num_bins + kWarps - 1) / kWarps, rows);
  grid_reduce_add_c1_kernel<<<blocks, kWarps * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(starts),
      static_cast<float*>(out), n, num_bins);
  return (int)cudaGetLastError();
}
