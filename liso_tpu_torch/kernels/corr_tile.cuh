// Shared pieces of the correlation-window kernels (corr_window_fwd.cu,
// corr_window_bwd.cu): the level table, the tensor-core helpers (ldmatrix
// and mma.sync m16n8k16, bf16 in, fp32 sums) and the pixel tile's region
// of cells.
//
// A block takes a 2-D tile of pixels. Its pixels' windows fall mostly in
// one region of cells of each level: centred on the mean of the tile's
// coords (the backward; the forward where the box of the tile's windows
// is too large); both kernels form the tile's products over that region
// on the tensor cores, as the TPU kernels form them over the whole level,
// and take any tap in range but outside the region on a slower path.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace corr_tile {

constexpr int kMaxLevels = 8;
constexpr int kW1 = 8;  // window side 2r + 2 for radius 3
constexpr int kTaps = kW1 * kW1;

struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int off[kMaxLevels];
};

// level_meta (host memory): 3 ints a level, its padded (h, w) and its row
// offset in f1cat
inline Levels levels_from_meta(int n_levels, const int* level_meta) {
  Levels lv = {};
  lv.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = level_meta[3 * l];
    lv.w[l] = level_meta[3 * l + 1];
    lv.off[l] = level_meta[3 * l + 2];
  }
  return lv;
}

// the low and high bf16 of a 32-bit word, as fp32
__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// four 8x8 bf16 matrices; thread T gives the row address of matrix T / 8
__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16 bytes from device to shared memory without a register, in the
// current group of asynchronous copies; 16 zero bytes where !ok (src is
// then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most N of this thread's groups of copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// acc (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma(float* acc, const unsigned* a,
                                    const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The pixel of slot q of the kTH x kTW tile (ty, tx) of an hpix x wpix
// grid, row-major, or -1 outside the grid.
template <int kTH, int kTW>
__device__ __forceinline__ int tile_pixel(int q, int ty, int tx, int hpix,
                                          int wpix) {
  const int y = ty * kTH + q / kTW, x = tx * kTW + q % kTW;
  return y < hpix && x < wpix ? y * wpix + x : -1;
}

// One warp: the mean (row, col) of the tile's coords that lie near the
// grid (far-away coords would pull the region off every window), or
// -1e9 where none does. cr, cc: the sample's row and col coords.
template <int kTH, int kTW>
__device__ __forceinline__ float2 tile_mean(const float* cr, const float* cc,
                                            int ty, int tx, int hpix,
                                            int wpix, int lane) {
  float sr = 0.f, sc = 0.f, cnt = 0.f;
  for (int q = lane; q < kTH * kTW; q += 32) {
    const int p = tile_pixel<kTH, kTW>(q, ty, tx, hpix, wpix);
    if (p < 0) continue;
    const float r = cr[p], col = cc[p];
    if (r > -16.f && r < hpix + 16.f && col > -16.f && col < wpix + 16.f) {
      sr += r;
      sc += col;
      cnt += 1.f;
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    sr += __shfl_xor_sync(0xffffffffu, sr, o);
    sc += __shfl_xor_sync(0xffffffffu, sc, o);
    cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  }
  return cnt > 0.f ? make_float2(sr / cnt, sc / cnt) : make_float2(-1e9f, -1e9f);
}

// The first row (or col) of a region of `size` cells centred on the
// tile's mean coord `m` at level scale `div`.
__device__ __forceinline__ int region_origin(float m, float div, int size) {
  return (int)floorf(m / div + 0.5f) - size / 2;
}

// The cell floor(v / div) that a coord's window is anchored at (its taps
// lie at offsets -3 .. 4), clamped: far-away coords only need to stay far
// away, and a float beyond int range would not convert.
__device__ __forceinline__ int window_cell(float v, float div) {
  return (int)fminf(fmaxf(floorf(v / div), -1e6f), 1e6f);
}

// Raises `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device. The attribute holds per device, so `done` keeps, per device
// ordinal, the largest limit set so far: the call is made once per device
// and size, not on every launch.
constexpr int kMaxDevices = 64;
inline cudaError_t raise_smem_limit(const void* kernel, size_t bytes,
                                    size_t* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) done[dev] = bytes;
  return err;
}

}  // namespace corr_tile
