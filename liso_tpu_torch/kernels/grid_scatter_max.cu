// BEV scatter-max with occupancy over cell-sorted points, for Hopper.
//
// Replaces the TPU kernel liso_tpu/ops/grid_scatter_pallas.py:_reduce_kernel
// (op="max", with_occ=True), reached through _grid_reduce_impl and
// grid_reduce_with_occ. That kernel scatters by a one-hot matmul on the MXU
// because scatters serialise on the TPU. Here the points arrive sorted by
// cell, so every cell's points form one contiguous range and no atomics are
// needed. The max selects an element, so the result written back in the
// input type is exact, whatever the order of the comparisons.
//
// Bound: bytes. The grid write dominates: 537 MB at the serving shape (B=8,
// 512^2 cells, C=128 bf16) against 67 MB of features read, 134 MB at the
// detector's (B=2, C=64 fp32), 108 MB at the SLIM train step's (920^2 cells,
// C=64 bf16). So the kernel writes every cell of the grid itself, empty
// ones as 0 with occ 0, and no separate zero-fill pass exists.
//
// Design: one block owns a tile of kTile cells of one sample and finds its
// points and every cell's start inside the kernel (cell_ranges.cuh): no
// host-side search. A grid row is moved as 16-byte vectors (4 fp32 or 8
// bf16; 8-byte vectors where the row is not a multiple of 16 bytes), one
// thread per vector and row bytes / 16 threads per cell, so a warp covers
// two 256-byte rows at C=64 fp32 or C=128 bf16. Each thread keeps the
// running max of its vector in fp32 registers over the cell's points and
// writes it once with streaming stores (the grid is write-once and larger
// than L2). The tile's occupancy is written as one coalesced run. A cell of
// more than kLong points is taken by the whole block: each cell group walks
// a strided share of the points, and the partial maxima meet in shared
// memory, so one cell may hold every point of a sample.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cell_ranges.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // cells per block
constexpr int kLong = 32;    // longer cells are taken by the whole block

template <int W>
struct Vec;  // W 32-bit words moved as one aligned access
template <>
struct Vec<4> {
  using type = uint4;
  __device__ static void split(uint4 v, unsigned* w) {
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
  __device__ static uint4 join(const unsigned* w) {
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <>
struct Vec<2> {
  using type = uint2;
  __device__ static void split(uint2 v, unsigned* w) { w[0] = v.x; w[1] = v.y; }
  __device__ static uint2 join(const unsigned* w) { return make_uint2(w[0], w[1]); }
};

// The elements of one vector as fp32: a word is one fp32 or two bf16 (the
// lower half first); a bf16 widens exactly by its bits.
template <bool kBf16, int W>
struct Elems {
  static constexpr int E = kBf16 ? 2 * W : W;
  __device__ static void max_into(float* m, typename Vec<W>::type v) {
    unsigned w[W];
    Vec<W>::split(v, w);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (kBf16) {
        m[2 * j] = fmaxf(m[2 * j], __uint_as_float(w[j] << 16));
        m[2 * j + 1] = fmaxf(m[2 * j + 1], __uint_as_float(w[j] & 0xffff0000u));
      } else {
        m[j] = fmaxf(m[j], __uint_as_float(w[j]));
      }
    }
  }
  // m holds bf16 values widened to fp32 (or 0), so the bf16 is exact
  __device__ static typename Vec<W>::type pack(const float* m) {
    unsigned w[W];
#pragma unroll
    for (int j = 0; j < W; ++j)
      w[j] = kBf16 ? (__float_as_uint(m[2 * j]) >> 16) |
                         (__float_as_uint(m[2 * j + 1]) & 0xffff0000u)
                   : __float_as_uint(m[j]);
    return Vec<W>::join(w);
  }
};

template <bool kBf16, int W>
__global__ void __launch_bounds__(kThreads)
grid_scatter_max_occ_kernel(const char* __restrict__ feats,
                            const int* __restrict__ cells,
                            char* __restrict__ grid, float* __restrict__ occ,
                            int n, int c, int num_cells) {
  using V = typename Vec<W>::type;
  using El = Elems<kBf16, W>;
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
  const int vecs = (int)(row / sizeof(V));         // vectors per row
  const int group = min(vecs, kThreads);           // threads per cell
  const int slots = kThreads / group;              // cells at a time
  const int slot = threadIdx.x / group, v0 = threadIdx.x % group;
  const char* f = feats + (size_t)b * n * row;
  char* g = grid + ((size_t)b * num_cells + base) * row;
  float* oc = occ + (size_t)b * num_cells + base;
  if (threadIdx.x == 0) n_long = 0;
  cell_ranges::tile_starts<kThreads>(cells + (size_t)b * n, n, base, tile,
                                     starts, range);

  for (int k = threadIdx.x; k < tile; k += kThreads)
    __stcs(oc + k, starts[k + 1] > starts[k] ? 1.0f : 0.0f);

  if (slot < slots) {
    for (int k = slot; k < tile; k += slots) {
      const int s = starts[k], e = starts[k + 1];
      if (e - s > kLong) {
        if (v0 == 0) longs[atomicAdd(&n_long, 1)] = k;
        continue;
      }
      for (int vi = v0; vi < vecs; vi += group) {
        float m[E];
#pragma unroll
        for (int j = 0; j < E; ++j) m[j] = e > s ? __uint_as_float(0xff800000u) : 0.0f;
        for (int p = s; p < e; ++p)
          El::max_into(m, reinterpret_cast<const V*>(f + (size_t)p * row)[vi]);
        __stcs(reinterpret_cast<V*>(g + (size_t)k * row) + vi, El::pack(m));
      }
    }
  }
  __syncthreads();

  // long cells: slot j walks points s + j, s + j + slots, ...; slot 0 takes
  // the maximum over the slots' partial maxima and writes the row
  for (int i = 0; i < n_long; ++i) {
    const int k = longs[i];
    const int s = starts[k], e = starts[k + 1];
    for (int vb = 0; vb < vecs; vb += group) {
      const int vi = vb + v0;
      const bool active = slot < slots && vi < vecs;
      float m[E];
#pragma unroll
      for (int j = 0; j < E; ++j) m[j] = __uint_as_float(0xff800000u);
      if (active)
        for (int p = s + slot; p < e; p += slots)
          El::max_into(m, reinterpret_cast<const V*>(f + (size_t)p * row)[vi]);
#pragma unroll
      for (int j = 0; j < E; ++j) partial[threadIdx.x * E + j] = m[j];
      __syncthreads();
      if (slot == 0 && vi < vecs) {
        for (int q = 1; q < slots; ++q)
#pragma unroll
          for (int j = 0; j < E; ++j)
            m[j] = fmaxf(m[j], partial[(q * group + v0) * E + j]);
        __stcs(reinterpret_cast<V*>(g + (size_t)k * row) + vi, El::pack(m));
      }
      __syncthreads();
    }
  }
}

template <bool kBf16, int W>
cudaError_t launch(const void* feats, const void* cells, void* grid,
                   void* occ, int b, int n, int c, int num_cells,
                   cudaStream_t stream) {
  dim3 blocks((num_cells + kTile - 1) / kTile, b);
  grid_scatter_max_occ_kernel<kBf16, W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const char*>(feats), static_cast<const int*>(cells),
      static_cast<char*>(grid), static_cast<float*>(occ), n, c, num_cells);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t launch_any(const void* feats, const void* cells, void* grid,
                       void* occ, int b, int n, int c, int num_cells,
                       cudaStream_t stream) {
  const size_t row = (size_t)c * (kBf16 ? 2 : 4);
  if (row % 16 == 0 && (uintptr_t)feats % 16 == 0 && (uintptr_t)grid % 16 == 0)
    return launch<kBf16, 4>(feats, cells, grid, occ, b, n, c, num_cells, stream);
  return launch<kBf16, 2>(feats, cells, grid, occ, b, n, c, num_cells, stream);
}

}  // namespace

// feats [B, N, C] (fp32 or bf16) and cells [B, N] int32, ascending within
// each sample (ids >= num_cells, int32 max included, are dropped); grid [B,
// num_cells, C] (type of feats), occ [B, num_cells] fp32. All contiguous,
// C % 4 == 0, feats and grid aligned to 4 elements (8 bytes at least).
extern "C" int grid_scatter_max_occ(const void* feats, const void* cells,
                                    void* grid, void* occ, int b, int n,
                                    int c, int num_cells, int is_bf16,
                                    void* stream) {
  if (c % 4 != 0) return (int)cudaErrorInvalidValue;
  if (b == 0 || num_cells == 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_any<true>(feats, cells, grid, occ, b, n, c, num_cells, s);
  return launch_any<false>(feats, cells, grid, occ, b, n, c, num_cells, s);
}
