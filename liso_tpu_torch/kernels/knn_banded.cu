// 1-NN over x-sorted point clouds with an x-band, for Hopper.
//
// Replaces the TPU kernel liso_tpu/ops/knn_pallas.py:_knn_kernel, reached
// through _nn1_impl (nn_1_sorted, nn_1_sorted_diff): the SLIM loss's nearest
// neighbour of every warped point, all RAFT iterations and flow types of
// one direction in one call. Both clouds are sorted by BEV cell (x-major),
// so a chunk of 512 consecutive queries spanning [qlo, qhi] in x can only
// have a neighbour within `margin` metres of x in the 1024-ref tiles whose x
// range meets [qlo - margin, qhi + margin]. The wrapper computes each
// chunk's contiguous tile range [t_lo, t_hi) on the device with
// searchsorted, exactly as the TPU wrapper does; this kernel visits only
// those tiles. The TPU kernel takes each tile's distances with one MXU
// product; here each thread owns one query and walks the staged tile.
//
// Metric, as the TPU kernel's fused product: with ref rows (x, y, z,
// |r|^2 + pen) and the query's (-2x, -2y, -2z, 1),
//     sq = |q|^2 + ((|r|^2 + pen) - 2 qx rx - 2 qy ry - 2 qz rz)
// in IEEE fp32 fused multiply-adds, never TF32 (a reduced-precision dot
// finds the true neighbour for only about a quarter of the queries at
// |coords| ~ 60 m). Invalid refs carry pen = 1e9; pad refs carry
// |r|^2 + pen = 1e9 at coords 0. The running best starts at 1e9 with index
// 0 and is replaced only by a strictly smaller distance, refs visited in
// ascending order, so ties keep the lowest index (the TPU kernel's first
// argmin). The wrapper clamps the distance at 0, sets invalid queries to
// (1e9, 0) and clips indices to N - 1.
//
// Layout: one block of 512 threads per (chunk, batch); each tile of 1024
// refs is staged in shared memory as float4, and each thread keeps its
// query and its (best, index) in registers.
//
// Bound: operations. At the train step's width (18 * 65536 queries against
// 65536 refs, x-band of about 17 m over a 116 m cloud) a call evaluates
// about 1.2e10 query-ref pairs, 4 fp32 FMAs each, against 25 MB of inputs.
#include <cuda_runtime.h>

namespace {

constexpr int kQC = 512;   // queries per chunk (one per thread)
constexpr int kRT = 1024;  // refs per tile
constexpr float kBig = 1e9f;

__global__ void __launch_bounds__(kQC)
knn_banded_kernel(const float* __restrict__ q, const float4* __restrict__ refs,
                  const int* __restrict__ ranges, float* __restrict__ dist,
                  int* __restrict__ index, int nq, int nr_pad, int n_chunks) {
  __shared__ float4 tile[kRT];
  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int qi = chunk * kQC + threadIdx.x;
  const bool active = qi < nq;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) {
    const float* qp = q + ((size_t)b * nq + qi) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  const float q2 = qx * qx + qy * qy + qz * qz;
  const float mx = -2.0f * qx, my = -2.0f * qy, mz = -2.0f * qz;
  float best = kBig;
  int bidx = 0;
  const int* rg = ranges + ((size_t)b * n_chunks + chunk) * 2;
  const int t_lo = rg[0];
  const int t_hi = rg[1];
  const float4* rb = refs + (size_t)b * nr_pad;
  for (int t = t_lo; t < t_hi; ++t) {
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < kRT; k += kQC) tile[k] = rb[(size_t)t * kRT + k];
    __syncthreads();
    if (active) {
      for (int k = 0; k < kRT; ++k) {
        const float4 r = tile[k];
        float acc = fmaf(mx, r.x, r.w);
        acc = fmaf(my, r.y, acc);
        acc = fmaf(mz, r.z, acc);
        const float sq = q2 + acc;
        if (sq < best) {
          best = sq;
          bidx = t * kRT + k;
        }
      }
    }
  }
  if (active) {
    dist[(size_t)b * nq + qi] = best;
    index[(size_t)b * nq + qi] = bidx;
  }
}

}  // namespace

// q [B, Nq, 3] fp32, refs [B, Nr_pad, 4] fp32 rows (x, y, z, |r|^2 + pen),
// Nr_pad a multiple of 1024, ranges [B, ceil(Nq / 512), 2] int32 tile
// ranges; dist [B, Nq] fp32, index [B, Nq] int32. All contiguous, refs
// 16-byte aligned.
extern "C" int knn_banded(const void* q, const void* refs, const void* ranges,
                          void* dist, void* index, int b, int nq, int nr_pad,
                          void* stream) {
  if (nr_pad % kRT != 0) return (int)cudaErrorInvalidValue;
  if (b == 0 || nq == 0) return (int)cudaSuccess;
  const int n_chunks = (nq + kQC - 1) / kQC;
  dim3 blocks(n_chunks, b);
  knn_banded_kernel<<<blocks, kQC, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float4*>(refs),
      static_cast<const int*>(ranges), static_cast<float*>(dist),
      static_cast<int*>(index), nq, nr_pad, n_chunks);
  return (int)cudaGetLastError();
}
