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
// convolutions keep that memory format. A sample is one contiguous slab
// of H*W*C elements, channel fastest.
//
// What bounds it: about 10 operations per element against 4-8 bytes moved
// (x read, residual read, out written), far below the H100's ~295
// FLOP/byte ridge, so bytes: each byte should cross HBM once, in 16-byte
// coalesced accesses. The R2R trunk at B = 96 has 17 shapes, 2,048 to
// 131,072 elements per sample, C/G = 2 to 128.
//
// Design (group_norm_slab_kernel): one thread-block cluster per sample, of
// 1 to 8 blocks (8,192 elements per block or more: 8 blocks of 16,384 at
// 128x32x32, one block up to 16x16x32), so a launch has B to 8B blocks; a
// sample of one block syncs and sums within the block alone.
// Block r of the cluster owns the contiguous range [r*chunk, (r+1)*chunk)
// of the slab, which 256 threads read as 8-element vectors (16 bytes in
// bf16): a warp reads 512 contiguous bytes. Since 2048 = 256*8 is a
// multiple of C, every thread meets the same 8 channels in every pass, and
// keeps their sums of x and x^2 in registers; it also caches each vector
// in shared memory. The block then sums its per-thread partials per group
// in a fixed order; after cluster.sync() every block adds the cluster's
// group sums over distributed shared memory in rank order, so all blocks
// (and two launches) get the same bits; then each thread normalises its
// cached vectors with its 8 channels' (a, b) and writes 16-byte vectors,
// adding the residual read in the same coalesced order. x is read once.
// It takes C a multiple of 8 that divides 2048 (8 to 2048 channels; the
// R2R trunk has 32 to 1024) and 16-byte aligned operands; the wrapper
// refuses anything else.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kVec = 8;                  // elements per thread access
constexpr int kSpan = kThreads * kVec;   // elements per block pass
constexpr int kMaxCluster = 8;
constexpr int kChunkTarget = 8192;       // elements per block, at least

// 8 consecutive elements as raw bits: 16 bytes of bf16, 32 of fp32.
template <typename T> struct Vec8;
template <> struct Vec8<__nv_bfloat16> {
  uint4 r;
  __device__ __forceinline__ void to_float(float* v) const {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[k]);
      v[2 * k] = __low2float(h);
      v[2 * k + 1] = __high2float(h);
    }
  }
  __device__ __forceinline__ void from_float(const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&h);
    }
    r = make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <> struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void to_float(float* v) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  __device__ __forceinline__ void from_float(const float* v) {
    a = make_float4(v[0], v[1], v[2], v[3]);
    b = make_float4(v[4], v[5], v[6], v[7]);
  }
};

// grid: B*nb blocks in clusters of nb, one cluster per sample; block r
// owns elements [r*chunk, min((r+1)*chunk, N)) of its sample's slab of N =
// H*W*C (chunk a multiple of kSpan). Shared memory: the cached vectors
// (chunk elements of T), the per-slot partial sums (2 x kSpan fp32), the
// block's group sums and the group statistics (2 x G fp32 each).
template <typename T>
__global__ void __launch_bounds__(kThreads)
group_norm_slab_kernel(const T* __restrict__ x, const T* __restrict__ res,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ out,
                       int C, int N, int G, int chunk, float eps, int relu) {
  extern __shared__ float4 slab_smem[];
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int nb = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long base = static_cast<long long>(blockIdx.x / nb) * N;
  const int start = rank * chunk;
  const int end = min(start + chunk, N);
  Vec8<T>* cache = reinterpret_cast<Vec8<T>*>(slab_smem);
  float* part1 = reinterpret_cast<float*>(cache + chunk / kVec);
  float* part2 = part1 + kSpan;
  float* gsum = part2 + kSpan;           // [2][G], read by the cluster
  float* stat = gsum + 2 * G;            // mean[G], inv[G]
  const int tid = threadIdx.x, c0 = (tid * kVec) % C;
  const int cpg = C / G;

  float s1[kVec], s2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) s1[j] = s2[j] = 0.f;
#pragma unroll 4
  for (int i = start + tid * kVec; i < end; i += kSpan) {
    const Vec8<T> raw = *reinterpret_cast<const Vec8<T>*>(x + base + i);
    cache[(i - start) / kVec] = raw;
    float v[kVec];
    raw.to_float(v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      s1[j] += v[j];
      s2[j] += __fmul_rn(v[j], v[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    part1[tid * kVec + j] = s1[j];
    part2[tid * kVec + j] = s2[j];
  }
  __syncthreads();
  // group g's slots: k*C + g*cg + q for k < kSpan / C, q < cg, summed by
  // one warp in a fixed order
  const int warp = tid / 32, lane = tid % 32;
  const int per_group = kSpan / G;
  for (int g = warp; g < G; g += kWarps) {
    float t1 = 0.f, t2 = 0.f;
    for (int idx = lane; idx < per_group; idx += 32) {
      const int slot = (idx / cpg) * C + g * cpg + idx % cpg;
      t1 += part1[slot];
      t2 += part2[slot];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      t1 += __shfl_xor_sync(kFull, t1, o);
      t2 += __shfl_xor_sync(kFull, t2, o);
    }
    if (lane == 0) {
      gsum[g] = t1;
      gsum[G + g] = t2;
    }
  }
  if (nb > 1)
    cluster.sync();                      // every block's group sums written
  else
    __syncthreads();
  const float n = static_cast<float>(N / G);
  for (int g = tid; g < G; g += kThreads) {
    float t1 = gsum[g], t2 = gsum[G + g];
    if (nb > 1) {                        // rank order: the same bits in
      t1 = t2 = 0.f;                     // every block
      for (int r = 0; r < nb; ++r) {
        const float* gs = cluster.map_shared_rank(gsum, r);
        t1 += gs[g];
        t2 += gs[G + g];
      }
    }
    const float mean = __fdiv_rn(t1, n);
    const float ex2 = __fdiv_rn(t2, n);
    const float var = fmaxf(__fsub_rn(ex2, __fmul_rn(mean, mean)), 0.f);
    stat[g] = mean;
    stat[G + g] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  }
  if (nb > 1)
    cluster.sync();                      // stat visible; no block leaves
  else                                   // while its gsum is read
    __syncthreads();
  float a[kVec], b[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int c = c0 + j, g = c / cpg;
    a[j] = __fmul_rn(stat[G + g], scale[c]);
    b[j] = __fsub_rn(bias[c], __fmul_rn(stat[g], a[j]));
  }
#pragma unroll 4
  for (int i = start + tid * kVec; i < end; i += kSpan) {
    float v[kVec], r[kVec];
    cache[(i - start) / kVec].to_float(v);
    if (res) reinterpret_cast<const Vec8<T>*>(res + base + i)->to_float(r);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      v[j] = __fadd_rn(__fmul_rn(v[j], a[j]), b[j]);
      if (res) v[j] = __fadd_rn(v[j], r[j]);
      if (relu) v[j] = fmaxf(v[j], 0.f);
    }
    Vec8<T> o;
    o.from_float(v);
    *reinterpret_cast<Vec8<T>*>(out + base + i) = o;
  }
}

template <typename T>
int launch_slab(const void* xv, const void* resv, const float* scale,
                const float* bias, void* outv, int B, int C, int HW, int G,
                float eps, int relu, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* res = static_cast<const T*>(resv);
  T* out = static_cast<T*>(outv);
  const int N = C * HW;
  int nb = 1;
  while (nb < kMaxCluster && N / (2 * nb) >= kChunkTarget) nb *= 2;
  const int chunk = (N / nb + kSpan - 1) / kSpan * kSpan;
  const size_t smem = static_cast<size_t>(chunk) * sizeof(T) +
                      (2 * kSpan + 4 * static_cast<size_t>(G)) * sizeof(float);
  auto kernel = group_norm_slab_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * nb);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = nb > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, res, scale,
                                             bias, out, C, N, G, chunk, eps,
                                             relu);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// x, res (may be null) and out share one shape (B, C, H, W), laid out
// channels_last, 16-byte aligned. scale and bias are fp32 (C,). dtype:
// 0 = float32, 1 = bfloat16. Needs C % 8 == 0 and 2048 % C == 0. Returns
// cudaGetLastError() after the launch, or -1 for arguments the kernel
// does not take.
int etp_group_norm(const void* x, const void* res, const void* scale,
                   const void* bias, void* out, int dtype, int B, int C,
                   int HW, int G, float eps, int relu, void* stream) {
  if (B < 1 || C < 1 || HW < 1 || G < 1 || C % G != 0 || C % kVec != 0 ||
      kSpan % C != 0 || !aligned16(x) || !aligned16(out) ||
      (res && !aligned16(res)))
    return -1;
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_slab<float>(x, res, sp, bp, out, B, C, HW, G, eps, relu,
                              st);
  if (dtype == 1)
    return launch_slab<__nv_bfloat16>(x, res, sp, bp, out, B, C, HW, G, eps,
                                      relu, st);
  return -1;
}

}  // extern "C"
