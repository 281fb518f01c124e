// K-GN: one-pass GroupNorm + per-channel affine, with an optional residual
// add and an optional ReLU, for sm_90a. Built by nvcc into a shared
// library with a plain C interface (see etpnav_tpu_torch/ops/cuda_build.py)
// and called through ctypes from etpnav_tpu_torch/ops/fused_groupnorm.py.
//
// Replaces the Pallas TPU kernel group_norm_fused
// (etpnav_tpu/ops/pallas_groupnorm.py:29-94): per (sample, group), fp32
// sums of x and x^2, mean and E[x^2] over n = H*W*(C/G),
// inv = rsqrt(max(E[x^2] - mean^2, 0) + eps), a = inv*scale,
// b = bias - mean*a, y = x*a + b, then + residual, then ReLU, all in fp32
// with one rounding to x's dtype. The variance is the JAX package's
// E[x^2] - E[x]^2 form, not Welford's.
//
// Layout: channels_last (NHWC in memory), the layout of the depth trunk
// on the card: its input is the NHWC depth map viewed as NCHW, and the
// convolutions keep that memory format. A (sample, group) is H*W runs of
// C/G elements, C apart.
//
// What bounds it: about 10 operations per element against 4-8 bytes moved
// (x read, residual read, out written), far below the H100's ~295
// FLOP/byte ridge, so bytes. One block owns one (sample, group): it reads
// the slab once into shared memory as fp32 (at most 8,192 elements, 32 KB,
// at the R2R trunk's largest group), reduces, and normalizes from shared
// memory, so x crosses HBM once and nothing but the output is written.
// Slabs too large for shared memory are read a second time instead. At
// B = 96 that is 1,536 blocks at most shapes and 96 at the compression
// GN(1). With few channels per group (C/G = 2 at the stem and in layer 1)
// a warp's loads are strided, and the 16 group blocks of a sample read
// the same sectors; L2 absorbs the repeats.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory a block may take without an opt-in, less the
// static reduction scratch
constexpr size_t kMaxDynSmem = 46 * 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// sum of (s1, s2) over the block; every thread gets the totals
__device__ __forceinline__ void block_sum2(float& s1, float& s2) {
  __shared__ float red[2][kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(kFull, s1, o);
    s2 += __shfl_xor_sync(kFull, s2, o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  s1 = 0.f;
  s2 = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    s1 += red[0][w];
    s2 += red[1][w];
  }
}

// grid: B*G blocks, block b*G + g owns group g of sample b. Element i of
// the slab, in memory order, is pixel i / cg, channel g*cg + i % cg.
template <typename T, bool kCached>
__global__ void __launch_bounds__(kThreads)
group_norm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ out, int C,
                  int HW, int G, float eps, int relu) {
  extern __shared__ float smem[];        // a[cg], b[cg], then the slab
  const int cg = C / G;
  const int n = cg * HW;
  const int b = blockIdx.x / G, g = blockIdx.x % G;
  const long long base = static_cast<long long>(b) * C * HW + g * cg;
  float* a_c = smem;
  float* b_c = smem + cg;
  float* slab = smem + 2 * cg;
  auto offset = [&](int i) -> long long {
    return static_cast<long long>(i / cg) * C + i % cg;
  };

  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = to_f(x[base + offset(i)]);
    if (kCached) slab[i] = v;
    s1 += v;
    s2 += __fmul_rn(v, v);
  }
  block_sum2(s1, s2);
  const float mean = __fdiv_rn(s1, static_cast<float>(n));
  const float ex2 = __fdiv_rn(s2, static_cast<float>(n));
  const float var = fmaxf(__fsub_rn(ex2, __fmul_rn(mean, mean)), 0.f);
  const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  for (int c = threadIdx.x; c < cg; c += kThreads) {
    const float a = __fmul_rn(inv, scale[g * cg + c]);
    a_c[c] = a;
    b_c[c] = __fsub_rn(bias[g * cg + c], __fmul_rn(mean, a));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const long long o = base + offset(i);
    const float v = kCached ? slab[i] : to_f(x[o]);
    const int c = i % cg;
    float y = __fadd_rn(__fmul_rn(v, a_c[c]), b_c[c]);
    if (res) y = __fadd_rn(y, to_f(res[o]));
    if (relu) y = fmaxf(y, 0.f);
    out[o] = from_f<T>(y);
  }
}

template <typename T>
int launch(const void* x, const void* res, const float* scale,
           const float* bias, void* out, int B, int C, int HW, int G,
           float eps, int relu, cudaStream_t stream) {
  const int cg = C / G;
  const size_t affine = 2 * static_cast<size_t>(cg) * sizeof(float);
  const size_t cached =
      affine + static_cast<size_t>(cg) * HW * sizeof(float);
  const dim3 grid(B * G);
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(res);
  T* op = static_cast<T*>(out);
  if (cached <= kMaxDynSmem)
    group_norm_kernel<T, true>
        <<<grid, kThreads, cached, stream>>>(xp, rp, scale, bias, op, C, HW,
                                             G, eps, relu);
  else if (affine <= kMaxDynSmem)
    group_norm_kernel<T, false>
        <<<grid, kThreads, affine, stream>>>(xp, rp, scale, bias, op, C, HW,
                                             G, eps, relu);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, res (may be null) and out share one shape (B, C, H, W), laid out
// channels_last. scale and bias are fp32 (C,). dtype: 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError() after the launch, or -1 for
// arguments the kernel does not take.
int etp_group_norm(const void* x, const void* res, const void* scale,
                   const void* bias, void* out, int dtype, int B, int C,
                   int HW, int G, float eps, int relu, void* stream) {
  if (B < 1 || C < 1 || HW < 1 || G < 1 || C % G != 0) return -1;
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, res, sp, bp, out, B, C, HW, G, eps, relu, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, res, sp, bp, out, B, C, HW, G, eps, relu,
                                 st);
  return -1;
}

}  // extern "C"
