// Eval-mode BatchNorm followed by ReLU in one pass, for Hopper.
//
// Replaces no TPU kernel. On the TPU, XLA fuses an eval BatchNorm and its
// ReLU into the ops around them; the port's PyTorch composition of the two
// (models/layers.py: bn_relu_eval_plain) runs seven full passes over a map
// instead: the cast to fp32, four broadcast fp32 ops, the cast to the
// output dtype and the ReLU, 48 bytes of traffic per bf16 element. A
// streaming step runs 23 such layers: CenterPoint's 21 (bf16, NCHW) and
// the two pillar encoders' norms (fp32, channel-last).
//
// Arithmetic: the composition's, op for op, in fp32:
//   y = ((x - mean) * scale) * weight + bias,   scale = rsqrt(var + eps)
// with __fsub_rn / __fmul_rn / __fadd_rn, which nvcc never contracts into
// an FMA (at -O3 it contracts a plain a * b + c, and an FMA rounds once
// where the composition rounds twice). y is rounded to the output dtype by
// __float2bfloat16 (round to nearest even: PyTorch's own conversion on
// sm_80 and later), then ReLU'd as torch.relu's clamp_min does it: a NaN
// passes unchanged, anything else is fmaxf(y, 0). So the result is bitwise
// the composition's, NaN, infinities and signed zeros included. The scale
// is the wrapper's torch.rsqrt, as in the composition.
//
// Bound: bytes, each input element read once and each output element
// written once. CenterPoint's stage 0, [8, 64, 256, 256] bf16 in and out:
// 134 MB, 0.040 ms at 3.35 TB/s; a pillar encoder's [8, 65536, 64] fp32:
// 268 MB, 0.080 ms. A streaming step's 23 layers move 2.05 GB (0.61 ms),
// where the composition moved 20.8 GB.
//
// Design: the channel of the element at memory offset i is (i / inner) % C,
// inner = H * W for NCHW and 1 for channel-last memory ([..., C], or NCHW
// maps held channels_last, as CenterPoint's are: its input is a
// channels-last image and cuDNN keeps that layout).
//   * NCHW (inner > 1): a plane (n, c) is one contiguous run of `inner`
//     elements of one channel. Blocks walk planes (grid y, grid-stride) and
//     within a plane 16-byte vectors (grid x, grid-stride): a thread loads 8
//     bf16 or 4 fp32 at a time and reads its plane's four constants once.
//     When inner is not a multiple of the vector, or a pointer is not
//     aligned to it, the same walk goes element by element.
//   * Channel-last (inner == 1, C <= kMaxRowC): each block stages the 4 x C
//     constants in shared memory, and each thread takes a 16-byte group of
//     consecutive channels (C a multiple of the vector, else element by
//     element). A thread's channel advances by the grid's stride mod C, so
//     no division runs per vector. A wider C takes the NCHW walk.
// Grid-stride loops, no atomics, no scratch. One kernel template serves
// both walks, so every launch is named bn_relu_eval_kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowC = 1024;  // channel-last constants in shared memory
constexpr int kBlocksPerSm = 8;  // channel-last grid: 2048 threads an SM

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// relu(Out(((x - m) * s) * w + b)), every op rounded where PyTorch rounds
template <typename Out>
__device__ __forceinline__ Out bn_relu(float x, float m, float s, float w,
                                       float b) {
  const Out y = from_f32<Out>(
      __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, m), s), w), b));
  const float r = to_f32(y);  // exact: y is representable
  return isnan(r) ? y : from_f32<Out>(fmaxf(r, 0.0f));
}

template <typename In, typename Out, int V, bool kRows>
__global__ void __launch_bounds__(kThreads)
bn_relu_eval_kernel(const In* __restrict__ x, const float* __restrict__ mean,
                    const float* __restrict__ scale,
                    const float* __restrict__ weight,
                    const float* __restrict__ bias, Out* __restrict__ out,
                    long long planes, int c, long long inner) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  if constexpr (kRows) {  // inner == 1: `planes` counts every element
    extern __shared__ float sh[];  // mean, scale, weight, bias: C each
    for (int i = threadIdx.x; i < c; i += kThreads) {
      sh[i] = mean[i];
      sh[c + i] = scale[i];
      sh[2 * c + i] = weight[i];
      sh[3 * c + i] = bias[i];
    }
    __syncthreads();
    const long long vecs = planes / V;
    int ch = (int)((first * V) % c);
    const int step = (int)((stride * V) % c);
    for (long long v = first; v < vecs; v += stride) {
      const Pack<In, V> a = *reinterpret_cast<const Pack<In, V>*>(x + v * V);
      Pack<Out, V> o;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int k = ch + j;
        o.v[j] = bn_relu<Out>(to_f32(a.v[j]), sh[k], sh[c + k], sh[2 * c + k],
                              sh[3 * c + k]);
      }
      *reinterpret_cast<Pack<Out, V>*>(out + v * V) = o;
      ch += step;
      if (ch >= c) ch -= c;
    }
  } else {
    const long long vecs = inner / V;
    for (long long p = blockIdx.y; p < planes; p += gridDim.y) {
      const int ch = (int)(p % c);
      const float m = __ldg(mean + ch), s = __ldg(scale + ch);
      const float w = __ldg(weight + ch), b = __ldg(bias + ch);
      const In* src = x + p * inner;
      Out* dst = out + p * inner;
      for (long long v = first; v < vecs; v += stride) {
        const Pack<In, V> a =
            *reinterpret_cast<const Pack<In, V>*>(src + v * V);
        Pack<Out, V> o;
#pragma unroll
        for (int j = 0; j < V; ++j)
          o.v[j] = bn_relu<Out>(to_f32(a.v[j]), m, s, w, b);
        *reinterpret_cast<Pack<Out, V>*>(dst + v * V) = o;
      }
    }
  }
}

template <typename In, typename Out, int V, bool kRows>
void run(const void* x, const void* const* k, void* out, dim3 grid,
         size_t shmem, long long planes, int c, long long inner,
         cudaStream_t s) {
  bn_relu_eval_kernel<In, Out, V, kRows><<<grid, kThreads, shmem, s>>>(
      static_cast<const In*>(x), static_cast<const float*>(k[0]),
      static_cast<const float*>(k[1]), static_cast<const float*>(k[2]),
      static_cast<const float*>(k[3]), static_cast<Out*>(out), planes, c,
      inner);
}

template <typename In, typename Out>
cudaError_t launch(const void* x, const void* const* k, void* out,
                   long long planes, int c, long long inner, cudaStream_t s) {
  constexpr int V = 16 / sizeof(In);
  const bool aligned = (uintptr_t)x % alignof(Pack<In, V>) == 0 &&
                       (uintptr_t)out % alignof(Pack<Out, V>) == 0;
  if (inner == 1 && c <= kMaxRowC) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const bool vec = aligned && c % V == 0;
    const long long vecs = vec ? planes / V : planes;
    const long long want = (vecs + kThreads - 1) / kThreads;
    const dim3 grid((unsigned)std::min(want, (long long)sms * kBlocksPerSm));
    const size_t shmem = 4 * (size_t)c * sizeof(float);
    if (vec) run<In, Out, V, true>(x, k, out, grid, shmem, planes, c, inner, s);
    else run<In, Out, 1, true>(x, k, out, grid, shmem, planes, c, inner, s);
  } else {
    const bool vec = aligned && inner % V == 0;
    const long long vecs = vec ? inner / V : inner;
    const long long want = (vecs + kThreads - 1) / kThreads;
    const dim3 grid((unsigned)std::min(want, 1LL << 20),
                    (unsigned)std::min(planes, 65535LL));
    if (vec) run<In, Out, V, false>(x, k, out, grid, 0, planes, c, inner, s);
    else run<In, Out, 1, false>(x, k, out, grid, 0, planes, c, inner, s);
  }
  return cudaGetLastError();
}

}  // namespace

// out = relu(BatchNorm_eval(x)) over `planes` runs of `inner` elements, run
// p of channel p % c (NCHW: planes = N * C, inner = H * W; channel-last:
// planes = every element, inner = 1). x is bf16 or fp32 (in_bf16), out
// bf16 or fp32 (out_bf16), both contiguous; mean, scale, weight and bias
// are fp32 [c].
extern "C" int bn_relu_eval(const void* x, const void* mean,
                            const void* scale, const void* weight,
                            const void* bias, void* out, long long planes,
                            int c, long long inner, int in_bf16, int out_bf16,
                            void* stream) {
  if (c < 1 || inner < 1 || planes < 0 || planes % c != 0)
    return (int)cudaErrorInvalidValue;
  if (planes == 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const void* const k[4] = {mean, scale, weight, bias};
  if (in_bf16 && out_bf16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, k, out, planes, c,
                                                     inner, s);
  if (in_bf16)
    return (int)launch<__nv_bfloat16, float>(x, k, out, planes, c, inner, s);
  if (out_bf16)
    return (int)launch<float, __nv_bfloat16>(x, k, out, planes, c, inner, s);
  return (int)launch<float, float>(x, k, out, planes, c, inner, s);
}
