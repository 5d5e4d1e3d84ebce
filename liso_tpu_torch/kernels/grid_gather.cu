// Per-point row gather from a dense BEV grid, for Hopper.
//
// Replaces the TPU kernel liso_tpu/ops/grid_scatter_pallas.py:_gather_kernel,
// reached through _grid_gather_impl, which the VJP of the scatter-max
// (grid_reduce_with_occ, op="max") calls twice: once on the forward grid for
// the winner test, once on the grid's cotangent. That kernel gathers by a
// one-hot matmul on the MXU because row gathers serialise on the TPU. Here a
// gather is a plain indexed load: out[b, p, :] = grid[b, cells[b, p], :], and
// a cell id >= num_cells (the drop bucket, int32 max included) reads 0, as
// the TPU kernel's one-hot matches no grid row for it.
//
// Layout: one thread per (point, group of kVec channels), consecutive
// threads on consecutive channel groups of one point, so a point's row is
// read and written as contiguous 16-byte (fp32) or 8-byte (bf16) vectors.
// The copy moves values unchanged, so the result is bitwise the plain
// version's.
//
// Bound: bytes. At the train step's width (B=1, 65536 points, C=64 bf16) it
// reads the cells (256 KB) and one 128-byte grid row per point (8.4 MB) and
// writes 8.4 MB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 4;  // channels per thread and vector access
constexpr int kThreads = 256;

template <typename T>
struct alignas(sizeof(T) * kVec) Pack {
  T v[kVec];
};

__device__ __forceinline__ void set_zero(float& x) { x = 0.0f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16& x) {
  x = __float2bfloat16_rn(0.0f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
grid_gather_kernel(const T* __restrict__ grid, const int* __restrict__ cells,
                   T* __restrict__ out, int n, int c, int num_cells) {
  const int groups = c / kVec;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (idx >= (long long)n * groups) return;
  const int p = (int)(idx / groups);
  const int k = (int)(idx % groups) * kVec;
  const int cell = cells[(size_t)b * n + p];
  Pack<T> y;
  if (cell >= 0 && cell < num_cells) {
    y = *reinterpret_cast<const Pack<T>*>(
        grid + ((size_t)b * num_cells + cell) * c + k);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) set_zero(y.v[i]);
  }
  *reinterpret_cast<Pack<T>*>(out + ((size_t)b * n + p) * c + k) = y;
}

template <typename T>
cudaError_t launch(const void* grid, const void* cells, void* out, int b,
                   int n, int c, int num_cells, cudaStream_t stream) {
  const long long work = (long long)n * (c / kVec);
  if (work == 0) return cudaSuccess;
  dim3 blocks((unsigned)((work + kThreads - 1) / kThreads), b);
  grid_gather_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(grid), static_cast<const int*>(cells),
      static_cast<T*>(out), n, c, num_cells);
  return cudaGetLastError();
}

}  // namespace

// grid [B, num_cells, C] (fp32 or bf16), cells [B, N] int32, out [B, N, C]
// (type of grid). All contiguous, C % 4 == 0, grid and out aligned to 4
// elements.
extern "C" int grid_gather(const void* grid, const void* cells, void* out,
                           int b, int n, int c, int num_cells, int is_bf16,
                           void* stream) {
  if (c % kVec != 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(grid, cells, out, b, n, c, num_cells, s);
  return launch<float>(grid, cells, out, b, n, c, num_cells, s);
}
