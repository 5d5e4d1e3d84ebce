// Scatter-add of cell-sorted point rows into a dense BEV grid, for Hopper.
//
// Replaces the TPU kernel liso_tpu/ops/grid_scatter_pallas.py:_reduce_kernel
// with op="add" at C > 1, reached through _grid_reduce_impl from
// _grid_gather_bwd, the VJP of grid_gather: the cotangent of a per-point row
// gather is the per-cell sum of the points' cotangent rows. That kernel adds
// each 128-point chunk into the output block by a one-hot matmul on the MXU,
// because scatters serialise on the TPU, and rounds the block to the input
// type after every chunk. Here the points arrive sorted by cell, so every
// cell's rows form one contiguous range [starts[c], starts[c+1]) (a
// searchsorted of the cell bounds, done by the wrapper, gives the ranges)
// and no atomics are needed: one thread owns one (cell, group of channels),
// walks the cell's range, sums in fp32 registers, and writes once, rounding
// to the output type once. The order of the sum is the points' order, so
// the result is deterministic. Every cell is written by the kernel, empty
// ones as 0, so no zero-fill pass exists. Ids >= num_cells (the drop bucket,
// int32 max included) sort past the last cell's range and are never read.
//
// Layout: consecutive threads on consecutive channel groups of one cell, so
// a grid row is written as contiguous vectors of kVec channels (16 bytes
// fp32, 8 bytes bf16) when C % kVec == 0 and both arrays are aligned, else as
// single channels (C = 2 at the decoder's flow gather).
//
// Bound: bytes. At the adjoint of the SLIM train step's gather (846400 cells
// of 64 bf16 channels, 65536 points of which about 9% reach the grid) the
// grid is 108 MB written against under 1 MB of rows read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 4;  // channels per thread on the vector path
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// V contiguous elements of T, moved as one aligned access.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
grid_reduce_add_kernel(const T* __restrict__ g, const int* __restrict__ starts,
                       T* __restrict__ out, int n, int c, int num_cells) {
  const int groups = c / V;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (idx >= (long long)num_cells * groups) return;
  const int cell = (int)(idx / groups);
  const int k = (int)(idx % groups) * V;
  const int* st = starts + (size_t)b * (num_cells + 1);
  const int s = st[cell];
  const int e = st[cell + 1];
  const T* src = g + (size_t)b * n * c + k;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.0f;
  for (int p = s; p < e; ++p) {
    const Pack<T, V> x = *reinterpret_cast<const Pack<T, V>*>(src + (size_t)p * c);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] += to_f(x.v[i]);
  }
  Pack<T, V> y;
#pragma unroll
  for (int i = 0; i < V; ++i) from_f(acc[i], &y.v[i]);
  *reinterpret_cast<Pack<T, V>*>(out + ((size_t)b * num_cells + cell) * c + k) = y;
}

template <typename T, int V>
cudaError_t launch_v(const void* g, const void* starts, void* out, int b,
                     int n, int c, int num_cells, cudaStream_t stream) {
  const long long work = (long long)num_cells * (c / V);
  if (work == 0 || b == 0) return cudaSuccess;
  dim3 blocks((unsigned)((work + kThreads - 1) / kThreads), b);
  grid_reduce_add_kernel<T, V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const int*>(starts),
      static_cast<T*>(out), n, c, num_cells);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* g, const void* starts, void* out, int b, int n,
                   int c, int num_cells, cudaStream_t stream) {
  const uintptr_t align = sizeof(T) * kVec;
  if (c % kVec == 0 && (uintptr_t)g % align == 0 && (uintptr_t)out % align == 0)
    return launch_v<T, kVec>(g, starts, out, b, n, c, num_cells, stream);
  return launch_v<T, 1>(g, starts, out, b, n, c, num_cells, stream);
}

}  // namespace

// g [B, N, C] (fp32 or bf16) sorted by cell within each sample, starts
// [B, num_cells + 1] int32 (the rows of cell k are [starts[k], starts[k+1])),
// out [B, num_cells, C] (type of g). All contiguous, C >= 1.
extern "C" int grid_reduce_add(const void* g, const void* starts, void* out,
                               int b, int n, int c, int num_cells, int is_bf16,
                               void* stream) {
  if (c < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(g, starts, out, b, n, c, num_cells, s);
  return launch<float>(g, starts, out, b, n, c, num_cells, s);
}
