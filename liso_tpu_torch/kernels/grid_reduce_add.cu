// Scatter-add of cell-sorted point rows into a dense BEV grid, for Hopper.
//
// Replaces the TPU kernel liso_tpu/ops/grid_scatter_pallas.py:_reduce_kernel
// with op="add" at C > 1, reached through _grid_reduce_impl from
// _grid_gather_bwd, the VJP of grid_gather: the cotangent of a per-point row
// gather is the per-cell sum of the points' cotangent rows. That kernel adds
// each 128-point chunk into the output block by a one-hot matmul on the MXU,
// because scatters serialise on the TPU, and rounds the block to the input
// type after every chunk. Here the points arrive sorted by cell, so every
// cell's rows form one contiguous range and no atomics are needed; each
// cell is summed in fp32 and rounded to the output type once. Ids >=
// num_cells (the drop bucket, int32 max included) sort past the last cell's
// range and are never read.
//
// Bound: bytes. The grid write dominates: at the adjoint of the SLIM train
// step's gather (846400 cells of 64 bf16 channels, 5559 of 65536 points in
// the grid) it is 108 MB against under 1 MB of rows read. So the kernel
// writes every cell itself, empty ones as 0, and no zero-fill pass exists.
//
// Design (K1's, grid_scatter_max.cu, with a sum for the max): one block
// owns a tile of kTile cells of one sample and finds its points and every
// cell's start inside the kernel (cell_ranges.cuh): nothing is searched on
// the host. A row is moved as vectors of VB bytes, the widest of 16, 8, 4
// and 2 that divides the row and both arrays' alignment (16 at C = 64 bf16,
// 8 at C = 2 fp32, 2 at odd C in bf16), one thread per vector and row
// bytes / VB threads per cell. Each thread sums its vector over the cell's
// points in fp32 registers, in the points' order, and writes it once with
// streaming stores (the grid is write-once and larger than L2). A cell of
// more than kLong points is taken by the whole block: each cell group sums
// a strided share of the points, and the partial sums meet in shared memory
// in a fixed order, so one cell may hold every point of a sample and the
// result stays deterministic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cell_ranges.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // cells per block
constexpr int kLong = 32;    // longer cells are taken by the whole block

template <int VB>
struct Vec;  // VB bytes moved as one aligned access, as 32-bit words
template <>
struct Vec<16> {
  using type = uint4;
  __device__ static void split(uint4 v, unsigned* w) {
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
  __device__ static uint4 join(const unsigned* w) {
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <>
struct Vec<8> {
  using type = uint2;
  __device__ static void split(uint2 v, unsigned* w) { w[0] = v.x; w[1] = v.y; }
  __device__ static uint2 join(const unsigned* w) { return make_uint2(w[0], w[1]); }
};
template <>
struct Vec<4> {
  using type = unsigned;
  __device__ static void split(unsigned v, unsigned* w) { w[0] = v; }
  __device__ static unsigned join(const unsigned* w) { return w[0]; }
};
template <>
struct Vec<2> {  // one bf16, in the low half of the word
  using type = unsigned short;
  __device__ static void split(unsigned short v, unsigned* w) { w[0] = v; }
  __device__ static unsigned short join(const unsigned* w) {
    return (unsigned short)w[0];
  }
};

// The E elements of one vector as fp32: a word is one fp32 or two bf16 (the
// lower half first); a bf16 widens exactly by its bits.
template <bool kBf16, int VB>
struct Elems {
  static constexpr int E = VB / (kBf16 ? 2 : 4);
  static constexpr int W = VB >= 4 ? VB / 4 : 1;
  __device__ static void add_into(float* acc, typename Vec<VB>::type v) {
    unsigned w[W];
    Vec<VB>::split(v, w);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if constexpr (kBf16)
        acc[j] += __uint_as_float(j & 1 ? w[j / 2] & 0xffff0000u : w[j / 2] << 16);
      else
        acc[j] += __uint_as_float(w[j]);
    }
  }
  // rounds to nearest even, as the plain version's cast does
  __device__ static typename Vec<VB>::type pack(const float* acc) {
    unsigned w[W];
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = 0;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if constexpr (kBf16)
        w[j / 2] |= (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(acc[j]))
                    << (16 * (j & 1));
      else
        w[j] = __float_as_uint(acc[j]);
    }
    return Vec<VB>::join(w);
  }
};

template <bool kBf16, int VB>
__global__ void __launch_bounds__(kThreads)
grid_reduce_add_kernel(const char* __restrict__ g, const int* __restrict__ cells,
                       char* __restrict__ out, int n, int c, int num_cells) {
  using V = typename Vec<VB>::type;
  using El = Elems<kBf16, VB>;
  constexpr int E = El::E;
  __shared__ int starts[kTile + 1];
  __shared__ int range[2];
  __shared__ int longs[kTile];
  __shared__ int n_long;
  __shared__ float partial[kThreads * E];
  const int b = blockIdx.y;
  const int base = blockIdx.x * kTile;
  const int tile = min(kTile, num_cells - base);
  const size_t row = (size_t)c * (kBf16 ? 2 : 4);  // bytes
  const int vecs = (int)(row / VB);                // vectors per row
  const int group = min(vecs, kThreads);           // threads per cell
  const int slots = kThreads / group;              // cells at a time
  const int slot = threadIdx.x / group, v0 = threadIdx.x % group;
  const char* src = g + (size_t)b * n * row;
  char* dst = out + ((size_t)b * num_cells + base) * row;
  if (threadIdx.x == 0) n_long = 0;
  cell_ranges::tile_starts<kThreads>(cells + (size_t)b * n, n, base, tile,
                                     starts, range);

  if (slot < slots) {
    for (int k = slot; k < tile; k += slots) {
      const int s = starts[k], e = starts[k + 1];
      if (e - s > kLong) {
        if (v0 == 0) longs[atomicAdd(&n_long, 1)] = k;
        continue;
      }
      for (int vi = v0; vi < vecs; vi += group) {
        float acc[E];
#pragma unroll
        for (int j = 0; j < E; ++j) acc[j] = 0.0f;
        for (int p = s; p < e; ++p)
          El::add_into(acc, reinterpret_cast<const V*>(src + (size_t)p * row)[vi]);
        __stcs(reinterpret_cast<V*>(dst + (size_t)k * row) + vi, El::pack(acc));
      }
    }
  }
  __syncthreads();

  // long cells: slot q sums points s + q, s + q + slots, ...; slot 0 adds
  // the slots' partial sums in slot order and writes the row
  for (int i = 0; i < n_long; ++i) {
    const int k = longs[i];
    const int s = starts[k], e = starts[k + 1];
    for (int vb = 0; vb < vecs; vb += group) {
      const int vi = vb + v0;
      const bool active = slot < slots && vi < vecs;
      float acc[E];
#pragma unroll
      for (int j = 0; j < E; ++j) acc[j] = 0.0f;
      if (active)
        for (int p = s + slot; p < e; p += slots)
          El::add_into(acc, reinterpret_cast<const V*>(src + (size_t)p * row)[vi]);
#pragma unroll
      for (int j = 0; j < E; ++j) partial[threadIdx.x * E + j] = acc[j];
      __syncthreads();
      if (slot == 0 && vi < vecs) {
        for (int q = 1; q < slots; ++q)
#pragma unroll
          for (int j = 0; j < E; ++j) acc[j] += partial[(q * group + v0) * E + j];
        __stcs(reinterpret_cast<V*>(dst + (size_t)k * row) + vi, El::pack(acc));
      }
      __syncthreads();
    }
  }
}

template <bool kBf16, int VB>
cudaError_t launch(const void* g, const void* cells, void* out, int b, int n,
                   int c, int num_cells, cudaStream_t stream) {
  dim3 blocks((num_cells + kTile - 1) / kTile, b);
  grid_reduce_add_kernel<kBf16, VB><<<blocks, kThreads, 0, stream>>>(
      static_cast<const char*>(g), static_cast<const int*>(cells),
      static_cast<char*>(out), n, c, num_cells);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t launch_any(const void* g, const void* cells, void* out, int b,
                       int n, int c, int num_cells, cudaStream_t stream) {
  const size_t row = (size_t)c * (kBf16 ? 2 : 4);
  const uintptr_t at = (uintptr_t)g | (uintptr_t)out | row;
  if (at % 16 == 0) return launch<kBf16, 16>(g, cells, out, b, n, c, num_cells, stream);
  if (at % 8 == 0) return launch<kBf16, 8>(g, cells, out, b, n, c, num_cells, stream);
  if (at % 4 == 0) return launch<kBf16, 4>(g, cells, out, b, n, c, num_cells, stream);
  if constexpr (kBf16) return launch<kBf16, 2>(g, cells, out, b, n, c, num_cells, stream);
  return cudaErrorMisalignedAddress;  // fp32 off a 4-byte boundary
}

}  // namespace

// g [B, N, C] (fp32 or bf16) and cells [B, N] int32, ascending within each
// sample (ids >= num_cells, int32 max included, are dropped); out [B,
// num_cells, C] (type of g). All contiguous, C >= 1, fp32 arrays aligned to
// 4 bytes and bf16 arrays to 2.
extern "C" int grid_reduce_add(const void* g, const void* cells, void* out,
                               int b, int n, int c, int num_cells, int is_bf16,
                               void* stream) {
  if (c < 1) return (int)cudaErrorInvalidValue;
  if (b == 0 || num_cells == 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_any<true>(g, cells, out, b, n, c, num_cells, s);
  return launch_any<false>(g, cells, out, b, n, c, num_cells, s);
}
