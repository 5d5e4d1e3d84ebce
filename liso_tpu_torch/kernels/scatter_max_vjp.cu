// The VJP of the BEV scatter-max in one pass, for Hopper.
//
// Replaces the backward of liso_tpu/ops/grid_scatter_pallas.py:
// grid_reduce_with_occ (op="max"), _grid_reduce_occ_bwd, which runs the TPU
// kernel _gather_kernel twice (a one-hot matmul each: once on the forward
// grid for the winner test, once on the grid's cotangent) and then an
// elementwise compare and select:
//     winner = feats == gather(grid, cells)
//     dfeats = where(winner, gather(g_grid, cells), 0)
// Every tied maximum gets the full cotangent. Here the same function is one
// kernel: each thread reads one point's cell id, its feature vector, the
// grid vector at that cell, and the cotangent vector there only where some
// element wins, and writes dfeats once. A cell id >= num_cells (the drop
// bucket, int32 max included) writes a zero row and reads no grid row.
// The compare is done on fp32 (a bf16 widens exactly by its bits), so
// -0.0 == +0.0 wins and a NaN never wins; the select moves the cotangent's
// bits unchanged and writes +0.0 elsewhere, so the result is bitwise the
// plain composition's (grid_scatter.scatter_max_vjp_plain).
//
// Layout: one thread per (point, 16-byte vector of channels): 4 fp32 or 8
// bf16 (8-byte vectors where a row is not a multiple of 16 bytes), so at
// C = 64 a point's row is 16 (fp32) or 8 (bf16) neighbouring threads. The
// lanes of a point load its cell id from the same address, one request;
// the features are read once and dfeats written once, both streaming.
//
// Bound: bytes. At the SLIM train step's width (B=1, 65536 points of which
// 5559 reach the grid, C=64 bf16) it must read the cells (256 KB), the
// feature rows of the points in the grid and the grid and cotangent rows
// of their cells (128 bytes each), and write 8.4 MB: about 10.8 MB. At the
// detector's (B=2, 32768 points each, all in the grid, C=64 fp32): about
// 64 MB.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// Per 32-bit word, the bits of the elements whose feature equals the grid's
// (as fp32): all of a word for fp32, each 16-bit half for two bf16 (the
// lower half first).
template <bool kBf16>
__device__ __forceinline__ unsigned win_bits(unsigned f, unsigned g) {
  if (!kBf16) return __uint_as_float(f) == __uint_as_float(g) ? 0xffffffffu : 0u;
  const unsigned lo = __uint_as_float(f << 16) == __uint_as_float(g << 16)
                          ? 0x0000ffffu : 0u;
  const unsigned hi = __uint_as_float(f & 0xffff0000u) ==
                              __uint_as_float(g & 0xffff0000u)
                          ? 0xffff0000u : 0u;
  return lo | hi;
}

template <bool kBf16, int W>
__global__ void __launch_bounds__(kThreads)
scatter_max_vjp_kernel(const char* __restrict__ feats,
                       const int* __restrict__ cells,
                       const char* __restrict__ grid,
                       const char* __restrict__ g_grid,
                       char* __restrict__ out, int n, int vecs,
                       int num_cells) {
  using V = typename Vec<W>::type;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)n * vecs) return;
  const int b = blockIdx.y;
  const int p = (int)(idx / vecs);
  const int vi = (int)(idx % vecs);
  const size_t pt = (size_t)b * n + p;
  const unsigned cell = (unsigned)__ldg(cells + pt);
  V* dst = reinterpret_cast<V*>(out) + pt * vecs + vi;
  unsigned o[W] = {};
  if (cell < (unsigned)num_cells) {
    const size_t at = ((size_t)b * num_cells + cell) * vecs + vi;
    unsigned f[W], m[W], win[W];
    Vec<W>::split(__ldcs(reinterpret_cast<const V*>(feats) + pt * vecs + vi), f);
    Vec<W>::split(__ldg(reinterpret_cast<const V*>(grid) + at), m);
    unsigned any = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      win[j] = win_bits<kBf16>(f[j], m[j]);
      any |= win[j];
    }
    if (any) {  // the cotangent row is read only where an element wins
      unsigned gv[W];
      Vec<W>::split(__ldg(reinterpret_cast<const V*>(g_grid) + at), gv);
#pragma unroll
      for (int j = 0; j < W; ++j) o[j] = gv[j] & win[j];
    }
  }
  __stcs(dst, Vec<W>::join(o));
}

template <bool kBf16, int W>
cudaError_t launch(const void* feats, const void* cells, const void* grid,
                   const void* g_grid, void* out, int b, int n, int c,
                   int num_cells, cudaStream_t stream) {
  const int vecs = (int)((size_t)c * (kBf16 ? 2 : 4) / (4 * W));
  const long long work = (long long)n * vecs;
  if (work == 0 || b == 0) return cudaSuccess;
  dim3 blocks((unsigned)((work + kThreads - 1) / kThreads), b);
  scatter_max_vjp_kernel<kBf16, W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const char*>(feats), static_cast<const int*>(cells),
      static_cast<const char*>(grid), static_cast<const char*>(g_grid),
      static_cast<char*>(out), n, vecs, num_cells);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t launch_any(const void* feats, const void* cells, const void* grid,
                       const void* g_grid, void* out, int b, int n, int c,
                       int num_cells, cudaStream_t stream) {
  const size_t row = (size_t)c * (kBf16 ? 2 : 4);
  const bool v16 = row % 16 == 0 && (uintptr_t)feats % 16 == 0 &&
                   (uintptr_t)grid % 16 == 0 && (uintptr_t)g_grid % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  if (v16)
    return launch<kBf16, 4>(feats, cells, grid, g_grid, out, b, n, c,
                            num_cells, stream);
  return launch<kBf16, 2>(feats, cells, grid, g_grid, out, b, n, c, num_cells,
                          stream);
}

}  // namespace

// feats [B, N, C], grid and g_grid [B, num_cells, C], out [B, N, C], all of
// one type (fp32 or bf16); cells [B, N] int32 (ids >= num_cells, int32 max
// included, are dropped). All contiguous, C % 4 == 0, every float array
// aligned to 4 elements (8 bytes at least).
extern "C" int scatter_max_vjp(const void* feats, const void* cells,
                               const void* grid, const void* g_grid,
                               void* out, int b, int n, int c, int num_cells,
                               int is_bf16, void* stream) {
  if (c % 4 != 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_any<true>(feats, cells, grid, g_grid, out, b, n, c,
                            num_cells, s);
  return launch_any<false>(feats, cells, grid, g_grid, out, b, n, c,
                           num_cells, s);
}
