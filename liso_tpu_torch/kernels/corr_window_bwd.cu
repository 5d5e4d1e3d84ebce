// RAFT correlation window lookup, backward, for Hopper.
//
// Replaces the TPU kernel liso_tpu/ops/corr_fused_pallas.py:_bwd_kernel,
// reached through _fused_bwd_impl, the VJP of fused_corr_window. The forward
// (corr_window_fwd.cu) returns, for every pixel p and every tap t of level l,
// tap = bf16(<f0[p], f1cat[m]> * scale) with m = off_l + row * w_l + col the
// tap's cell; out-of-range taps are 0. Given the taps' cotangent g, the TPU
// kernel scatters g back to a [M, P] corr block per pixel tile, scales it and
// rounds it to bf16, and forms df0 = dcorr^T f1cat and df1 += dcorr f0 with
// two MXU matmuls. Only the windowed entries of that block are non-zero, so
// this kernel works on them alone, as the forward does:
//     d = bf16(g[t, p] * scale)         (the TPU kernel's bf16 cotangent)
//     df0[p] += d * f1cat[m]            (summed in registers, tap order)
//     df1[m] += d * bf16(f0[p])         (fp32 atomicAdd: m is shared
//                                        between pixels)
// for every in-range tap; a tap outside its level's padded extent has no
// cell and contributes nothing. d times a bf16 value is exact in fp32, so
// the kernel and the plain version (dense scatter + two fp32 matmuls) differ
// only in the order of their fp32 sums.
//
// Layout: a block of 8 warps takes 32 consecutive pixels and stages their
// [L*64, 32] cotangents in shared memory with coalesced loads. One warp
// takes one pixel: lane l holds channels l, l + 32, ..., so a tap's f1cat row
// is read and its df1 row updated as contiguous 64- and 128-byte runs.
//
// Bound: bytes, and in practice the atomics. At the train step's width (B=1,
// HW=13225, C=128, M=19776, L=4) a call reads 13.5 MB of cotangent, 3.4 MB
// of f0 and 5.1 MB of f1cat and writes 6.8 MB of df0 and 10.1 MB of df1, and
// issues HW * L * 64 * C = 433 M fp32 atomic adds into df1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kW1 = 8;      // window side 2r + 2 for radius 3
constexpr int kWarps = 8;
constexpr int kPix = 32;    // pixels per block
constexpr int kMaxChunks = 8;  // C <= 256 (channels per lane <= 8)

struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int off[kMaxLevels];
};

__global__ void __launch_bounds__(kWarps * 32)
corr_window_bwd_kernel(const __nv_bfloat16* __restrict__ f0,
                       const __nv_bfloat16* __restrict__ f1,
                       const float* __restrict__ coords,
                       const float* __restrict__ g,
                       float* __restrict__ df0, float* __restrict__ df1,
                       int hw, int c, int m, Levels lv, float scale) {
  extern __shared__ float gs[];  // [nt][kPix] cotangents of this block
  __shared__ int meta[3 * kMaxLevels];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      meta[3 * l] = lv.h[l];
      meta[3 * l + 1] = lv.w[l];
      meta[3 * l + 2] = lv.off[l];
    }
  }
  const int b = blockIdx.y;
  const int p_base = blockIdx.x * kPix;
  const int nt = lv.n * kW1 * kW1;
  for (int idx = threadIdx.x; idx < nt * kPix; idx += blockDim.x) {
    const int t = idx / kPix;
    const int pp = idx % kPix;
    const int p = p_base + pp;
    gs[idx] = p < hw ? g[((size_t)b * nt + t) * hw + p] : 0.0f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunks = c / 32;
  const __nv_bfloat16* f1b = f1 + (size_t)b * m * c;
  float* df1b = df1 + (size_t)b * m * c;

  for (int pp = warp; pp < kPix; pp += kWarps) {
    const int p = p_base + pp;
    if (p >= hw) break;
    float f0r[kMaxChunks];
    float acc[kMaxChunks];
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      f0r[k] = k < chunks
                   ? __bfloat162float(f0[((size_t)b * hw + p) * c + lane + 32 * k])
                   : 0.0f;
      acc[k] = 0.0f;
    }
    const float r = coords[(size_t)b * 2 * hw + p];
    const float cc = coords[((size_t)b * 2 + 1) * hw + p];
    for (int l = 0; l < lv.n; ++l) {
      const float div = (float)(1 << l);
      // the forward's clamp: far-away coords only need to stay far away
      const int r0 = (int)fminf(fmaxf(floorf(r / div), -1e6f), 1e6f);
      const int c0 = (int)fminf(fmaxf(floorf(cc / div), -1e6f), 1e6f);
      const int hl = meta[3 * l];
      const int wl = meta[3 * l + 1];
      const int off = meta[3 * l + 2];
      for (int i = 0; i < kW1; ++i) {
        const int row = r0 - 3 + i;
        if (row < 0 || row >= hl) continue;
        for (int j = 0; j < kW1; ++j) {
          const int col = c0 - 3 + j;
          if (col < 0 || col >= wl) continue;
          const int t = (l * kW1 + i) * kW1 + j;
          const float d =
              __bfloat162float(__float2bfloat16_rn(gs[t * kPix + pp] * scale));
          const size_t cell = (size_t)(off + row * wl + col) * c;
#pragma unroll
          for (int k = 0; k < kMaxChunks; ++k) {
            if (k < chunks) {
              const int ch = lane + 32 * k;
              acc[k] = fmaf(d, __bfloat162float(f1b[cell + ch]), acc[k]);
              atomicAdd(df1b + cell + ch, d * f0r[k]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      if (k < chunks) df0[((size_t)b * hw + p) * c + lane + 32 * k] = acc[k];
    }
  }
}

}  // namespace

// f0 [B, HW, C] bf16, f1cat [B, M, C] bf16, coords [B, 2, HW] fp32 (row,
// col at level 0), g [B, L*64, HW] fp32; df0 [B, HW, C] fp32 (written in
// full), df1 [B, M, C] fp32 (ZEROED by the caller, accumulated here). All
// contiguous, C % 32 == 0, C <= 256. level_meta is HOST memory: 3*L ints,
// the padded (h, w) of every level and its row offset in f1cat.
extern "C" int corr_window_bwd(const void* f0, const void* f1cat,
                               const void* coords, const void* g, void* df0,
                               void* df1, int b, int hw, int c, int m,
                               int n_levels, const int* level_meta,
                               float scale, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || c % 32 != 0 ||
      c > 32 * kMaxChunks)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || hw == 0) return (int)cudaSuccess;
  Levels lv = {};
  lv.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = level_meta[3 * l];
    lv.w[l] = level_meta[3 * l + 1];
    lv.off[l] = level_meta[3 * l + 2];
  }
  const size_t smem = sizeof(float) * (size_t)n_levels * kW1 * kW1 * kPix;
  cudaError_t err = cudaFuncSetAttribute(
      corr_window_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 blocks((hw + kPix - 1) / kPix, b);
  corr_window_bwd_kernel<<<blocks, kWarps * 32, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(f0),
      static_cast<const __nv_bfloat16*>(f1cat),
      static_cast<const float*>(coords), static_cast<const float*>(g),
      static_cast<float*>(df0), static_cast<float*>(df1), hw, c, m, lv,
      scale);
  return (int)cudaGetLastError();
}
