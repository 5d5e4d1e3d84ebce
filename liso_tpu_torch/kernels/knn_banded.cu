// 1-NN over cell-sorted point clouds with an x-band, for Hopper.
//
// Replaces the TPU kernel liso_tpu/ops/knn_pallas.py:_knn_kernel, reached
// through _nn1_impl (nn_1_sorted, nn_1_sorted_diff): the SLIM loss's nearest
// neighbour of every warped point, all RAFT iterations and flow types of
// one direction in one call. Both clouds are sorted by BEV cell (x-major),
// so a chunk of 512 consecutive queries spanning [qlo, qhi] in x can only
// have a neighbour within `margin` metres of x in the 1024-ref tiles whose x
// range meets [qlo - margin, qhi + margin]. The wrapper computes each
// chunk's contiguous tile range [t_lo, t_hi) on the device with
// searchsorted, exactly as the TPU wrapper does. This kernel returns the
// exact 1-NN over the refs of that band (ops/knn_banded.py:
// nn_1_sorted_band_plain), but it does not test every ref of it.
//
// The TPU kernel takes whole tiles because its MXU takes fixed-size
// products. Here a warp owns 128 consecutive queries of one chunk (four a
// lane; their x range is a few centimetres) and sweeps the band in
// sub-tiles of 32 refs: first rightwards from the sub-tile nearest its
// queries' x, then leftwards. It stops in a direction once no ref left in
// that direction can beat any of its queries' best so far:
//     gap > sqrt((best + 2^-17 |q|^2) (1 + 2^-16))     for every query,
// where gap is the x distance from the query to the nearest x that any
// remaining ref can have. The refs are cell-sorted, not strictly x-sorted
// (within one x-row of cells they are ordered by y, and points outside the
// grid trail), so gap comes from bounds the wrapper builds over the valid
// refs' x per sub-tile: the suffix minimum of the minima going right, the
// prefix maximum of the maxima going left. The slack makes the cut
// conservative for the rounded metric: the computed distance of a ref at
// true distance D lies within 10 * 2^-24 (|q| + |r|)^2 < 2^-20 (|q| + |r|)^2
// of D^2 (the rounding of |q|^2, |r|^2, three fused multiply-adds and an
// add), and |r| <= |q| + D, so it exceeds D^2 (1 - 2^-19) - 2^-17 |q|^2; a
// ref beyond the cut is strictly worse than the best, never tied with it.
//
// Metric, as the TPU kernel's fused product: with ref rows (x, y, z,
// |r|^2 + pen) and the query's (-2x, -2y, -2z),
//     acc = (|r|^2 + pen) - 2 qx rx - 2 qy ry - 2 qz rz
// in IEEE fp32 fused multiply-adds, never TF32 (a reduced-precision dot
// finds the true neighbour for only about a quarter of the queries at
// |coords| ~ 60 m); the query's |q|^2 is added once to the best acc, so
// the distance is |q|^2 + acc as before. Comparing acc instead of
// |q|^2 + acc can move the winner only where fp32 rounding makes two refs
// a near-tie. Sub-tiles are not visited in ascending order, so a tie
// compares indices: the lowest index wins (the TPU kernel's first argmin).
// Invalid refs carry pen = 1e9 and are left out of the x bounds; pad refs
// carry |r|^2 + pen = 1e9 at coords 0. A query whose band holds no ref, or
// only refs at 1e9 or more, gets (1e9, 0), as the old full-band kernel
// gave. The wrapper clamps the distance at 0, sets invalid queries to
// (1e9, 0) and clips indices to N - 1.
//
// Bound: operations, on the pairs the sweep tests. Each pair costs 3 FMAs,
// a compare and two selects, and each 16-byte shared load of a ref serves
// a lane's four queries: 6.4 issued instructions a pair in the SASS. The
// tensor cores would not help: a pair's dot has 3 terms, and its compare
// and selects stay on the regular cores. At the train step's width (18 *
// 65536 queries against 65536 refs, an x-band of about 17 m over a 116 m
// cloud) the sweep tests 0.39 of the band's 1.3e10 pairs and issues at
// about 60% of the card's rate (PERF.md). `visited`, when not null,
// receives the count of (valid query, ref) pairs tested.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQC = 512;   // queries per chunk (the band's unit)
constexpr int kRT = 1024;  // refs per tile (the band's unit)
constexpr int kS = 32;     // refs per sub-tile: one 16-byte row a lane
// queries per lane: the measured choice (PERF.md §6 gives 2 and 8)
constexpr int kQ = 4;
constexpr int kWQ = 32 * kQ;      // queries per warp
constexpr int kWarps = kQC / kWQ;  // warps per chunk
constexpr float kBig = 1e9f;

__global__ void __launch_bounds__(kWarps * 32)
knn_banded_kernel(const float* __restrict__ q,
                  const unsigned char* __restrict__ q_valid,
                  const float4* __restrict__ refs,
                  const int* __restrict__ ranges,
                  const float* __restrict__ suf_min,
                  const float* __restrict__ pre_max,
                  float* __restrict__ dist, int* __restrict__ index,
                  unsigned long long* __restrict__ visited, int nq,
                  int nr_pad, int n_chunks) {
  __shared__ float4 stage[kWarps][kS];
  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = chunk * kQC + warp * kWQ;
  const int nsub = nr_pad / kS;

  float qx[kQ], mx[kQ], my[kQ], mz[kQ], q2[kQ], best[kQ];
  int bidx[kQ];
  bool act[kQ];
  float xlo = INFINITY, xhi = -INFINITY;
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const int qi = q0 + j * 32 + lane;
    act[j] = qi < nq && q_valid[(size_t)b * nq + qi];
    float x = 0.f, y = 0.f, z = 0.f;
    if (act[j]) {
      const float* qp = q + ((size_t)b * nq + qi) * 3;
      x = qp[0];
      y = qp[1];
      z = qp[2];
      xlo = fminf(xlo, x);
      xhi = fmaxf(xhi, x);
    }
    qx[j] = x;
    mx[j] = -2.0f * x;
    my[j] = -2.0f * y;
    mz[j] = -2.0f * z;
    q2[j] = x * x + y * y + z * z;
    best[j] = INFINITY;
    bidx[j] = -1;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    xlo = fminf(xlo, __shfl_xor_sync(0xffffffffu, xlo, o));
    xhi = fmaxf(xhi, __shfl_xor_sync(0xffffffffu, xhi, o));
  }

  const int* rg = ranges + ((size_t)b * n_chunks + chunk) * 2;
  const int sb = rg[0] * (kRT / kS);
  const int se = min(rg[1] * (kRT / kS), nsub);
  const float4* rb = refs + (size_t)b * nr_pad;
  const float* smin = suf_min + (size_t)b * nsub;
  const float* pmax = pre_max + (size_t)b * nsub;
  float4* st = stage[warp];
  long long tested = 0;

  // every active query of the warp is farther than its cut from the x
  // bound x_b, on the side `right` (x_b >= x) or the other
  auto done = [&](float xb, bool right) {
    bool ok = true;
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const float d = fmaxf(q2[j] + best[j], 0.0f);
      const float cut = sqrtf((d + 0x1p-17f * q2[j]) * (1.0f + 0x1p-16f));
      const float gap = right ? xb - qx[j] : qx[j] - xb;
      ok = ok && (!act[j] || gap > cut);
    }
    return __all_sync(0xffffffffu, ok);
  };
  auto visit = [&](int s) {
    __syncwarp();  // the previous sub-tile is no longer read
    st[lane] = rb[(size_t)s * kS + lane];
    __syncwarp();
    float m[kQ];
    int mi[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      m[j] = INFINITY;
      mi[j] = 0;
    }
#pragma unroll 8
    for (int k = 0; k < kS; ++k) {
      const float4 r = st[k];
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        float acc = fmaf(mx[j], r.x, r.w);
        acc = fmaf(my[j], r.y, acc);
        acc = fmaf(mz[j], r.z, acc);
        if (acc < m[j]) {
          m[j] = acc;
          mi[j] = k;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const int id = s * kS + mi[j];
      if (m[j] < best[j] || (m[j] == best[j] && id < bidx[j])) {
        best[j] = m[j];
        bidx[j] = id;
      }
    }
    ++tested;
  };

  if (xlo <= xhi && sb < se) {
    // start at the first sub-tile whose prefix maximum reaches the
    // queries' middle x (the prefix maximum never decreases)
    const float mid = 0.5f * (xlo + xhi);
    int lo = sb, hi = se;
    while (lo < hi) {
      const int md = (lo + hi) >> 1;
      if (pmax[md] < mid) lo = md + 1; else hi = md;
    }
    const int start = min(lo, se - 1);
    for (int s = start; s < se && !done(smin[s], true); ++s) visit(s);
    for (int s = start - 1; s >= sb && !done(pmax[s], false); --s) visit(s);
  }

  if (visited != nullptr) {
    int n_act = 0;
#pragma unroll
    for (int j = 0; j < kQ; ++j) n_act += act[j];
#pragma unroll
    for (int o = 16; o; o >>= 1) n_act += __shfl_xor_sync(0xffffffffu, n_act, o);
    if (lane == 0 && tested > 0)
      atomicAdd(visited, (unsigned long long)(tested * kS * n_act));
  }
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const int qi = q0 + j * 32 + lane;
    if (qi >= nq) continue;
    const float d = q2[j] + best[j];
    const bool found = act[j] && bidx[j] >= 0 && d < kBig;
    dist[(size_t)b * nq + qi] = found ? d : kBig;
    index[(size_t)b * nq + qi] = found ? bidx[j] : 0;
  }
}

}  // namespace

// q [B, Nq, 3] fp32, q_valid [B, Nq] uint8, refs [B, Nr_pad, 4] fp32 rows
// (x, y, z, |r|^2 + pen), Nr_pad a multiple of 1024, ranges [B, ceil(Nq /
// 512), 2] int32 tile ranges, suf_min and pre_max [B, Nr_pad / 32] fp32:
// over the valid refs' x of sub-tiles s.. (suffix minimum, +inf where none)
// and ..s (prefix maximum, -inf where none); dist [B, Nq] fp32, index
// [B, Nq] int32; visited: null, or one uint64 that the kernel adds the
// count of tested (valid query, ref) pairs to. All contiguous, refs 16-byte
// aligned.
extern "C" int knn_banded(const void* q, const void* q_valid, const void* refs,
                          const void* ranges, const void* suf_min,
                          const void* pre_max, void* dist, void* index,
                          void* visited, int b, int nq, int nr_pad,
                          void* stream) {
  if (nr_pad % kRT != 0) return (int)cudaErrorInvalidValue;
  if (b == 0 || nq == 0) return (int)cudaSuccess;
  const int n_chunks = (nq + kQC - 1) / kQC;
  dim3 blocks(n_chunks, b);
  knn_banded_kernel<<<blocks, kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const unsigned char*>(q_valid),
      static_cast<const float4*>(refs), static_cast<const int*>(ranges),
      static_cast<const float*>(suf_min), static_cast<const float*>(pre_max),
      static_cast<float*>(dist), static_cast<int*>(index),
      static_cast<unsigned long long*>(visited), nq, nr_pad, n_chunks);
  return (int)cudaGetLastError();
}
