// Per-point row gather from a dense BEV grid, for Hopper.
//
// Replaces the TPU kernel liso_tpu/ops/grid_scatter_pallas.py:_gather_kernel,
// reached through _grid_gather_impl. That kernel gathers by a one-hot matmul
// on the MXU because row gathers serialise on the TPU. Here a gather is a
// plain indexed copy: out[b, p, :] = grid[b, cells[b, p], :], and a cell id
// >= num_cells (the drop bucket, int32 max included) reads 0, as the TPU
// kernel's one-hot matches no grid row for it. The copy moves bits
// unchanged, so the result is bitwise the plain version's, at any C.
//
// Bound: bytes. At the SLIM train step's width (B=1, 65536 points, C=64
// bf16, 91% of the points in the drop bucket) it reads the cells (256 KB)
// and 5559 grid rows of 128 bytes (0.7 MB) and writes 8.4 MB.
//
// Design: a warp owns 32 consecutive points. Each lane loads one point's id
// (one coalesced load), and the warp's 32 output rows, one contiguous run,
// are walked as vectors j = 0, 1, ... of VB bytes: vector j belongs to
// point j / vecs, whose id comes from its lane by shuffle. So stores are
// contiguous across the warp whatever the row's width, a row of 16-byte
// multiples moves as 16-byte vectors (8 bf16 or 4 fp32, 8 lanes a row at
// C = 64 bf16), narrower rows as 8-, 4- or 2-byte vectors (C = 2 fp32 is
// one 8-byte vector a point, one point a lane). Each lane issues kUnroll
// loads before its stores. A drop-bucket point reads nothing and writes
// zeros.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // loads in flight per lane before its stores

template <typename V>
__global__ void __launch_bounds__(kThreads)
grid_gather_kernel(const V* __restrict__ grid, const int* __restrict__ cells,
                   V* __restrict__ out, int n, int vecs, int num_cells) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const long long p0 = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  if (p0 >= n) return;  // whole warps only: the shuffles below need all lanes
  const int pts = (int)min(32LL, n - p0);
  const int cell = lane < pts ? cells[(size_t)b * n + p0 + lane] : num_cells;
  const V* src = grid + (size_t)b * num_cells * vecs;
  V* dst = out + ((size_t)b * n + p0) * vecs;
  const int total = pts * vecs;  // vectors of the warp's rows
  const int rounds = (total + 31) / 32;
  for (int r0 = 0; r0 < rounds; r0 += kUnroll) {
    V val[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r0 + u >= rounds) break;  // uniform across the warp
      const int j = (r0 + u) * 32 + lane;
      const int p = min(j / vecs, 31);
      const int id = __shfl_sync(0xffffffffu, cell, p);
      val[u] = V{};
      if (j < total && id >= 0 && id < num_cells)
        val[u] = src[(size_t)id * vecs + (j - p * vecs)];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = (r0 + u) * 32 + lane;
      if (r0 + u < rounds && j < total) dst[j] = val[u];
    }
  }
}

template <typename V>
cudaError_t launch(const void* grid, const void* cells, void* out, int b,
                   int n, size_t row, int num_cells, cudaStream_t stream) {
  const int vecs = (int)(row / sizeof(V));
  const long long warps = ((long long)n + 31) / 32;
  dim3 blocks((unsigned)((warps + kWarps - 1) / kWarps), b);
  grid_gather_kernel<V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(grid), static_cast<const int*>(cells),
      static_cast<V*>(out), n, vecs, num_cells);
  return cudaGetLastError();
}

}  // namespace

// grid [B, num_cells, C] (fp32 or bf16), cells [B, N] int32, out [B, N, C]
// (type of grid). All contiguous, C >= 1. The widest vector that divides
// the row and both arrays' alignment is taken.
extern "C" int grid_gather(const void* grid, const void* cells, void* out,
                           int b, int n, int c, int num_cells, int is_bf16,
                           void* stream) {
  if (c < 1) return (int)cudaErrorInvalidValue;
  if (b == 0 || n == 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const size_t row = (size_t)c * (is_bf16 ? 2 : 4);
  const uintptr_t at = (uintptr_t)grid | (uintptr_t)out | row;
  if (at % 16 == 0) return launch<uint4>(grid, cells, out, b, n, row, num_cells, s);
  if (at % 8 == 0) return launch<uint2>(grid, cells, out, b, n, row, num_cells, s);
  if (at % 4 == 0) return launch<unsigned>(grid, cells, out, b, n, row, num_cells, s);
  return launch<unsigned short>(grid, cells, out, b, n, row, num_cells, s);
}
