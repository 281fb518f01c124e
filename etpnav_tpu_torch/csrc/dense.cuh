// Dense building blocks shared by K-PRENORM (prenorm_attention.cu) and
// K-BLOCK (attention_block.cu), for sm_90a: dtype conversions, warp
// reductions, a row LayerNorm, the GEMM out = A . W^T + bias (+ residual)
// over fp32 (out, in) weights that are rounded to A's dtype as they are
// loaded, and the attention of one (sample, head) on the natural layout of
// the GEMM's q/k/v output. Header only; each source launches the
// instantiations it needs; K-ATT and K-ATT-BWD take etp::mma_bf16 through
// attention_tc.cuh. cuda_build hashes every .cuh into each library's
// name, so an edit here rebuilds them all.
//
// GEMM: 64x64 output tiles over k-slabs of 32 (bf16: tensor cores through
// mma.sync m16n8k16, fp32 accumulate, four warps of 32x32) or 16 (fp32:
// CUDA-core FMAs, 4x4 outputs per thread, sums in k order). The M edge is
// masked; N and K must be multiples of 64. The epilogue adds the fp32
// bias, then the residual (in A's dtype) in fp32, and stores in TO: A's
// dtype (rounded) or fp32 (not rounded, for a LayerNorm that follows).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace etp {

constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// ---------------------------------------------------------------------------
// LayerNorm: y = ((x - mu) * rsqrt(var + eps) * g + b), var = mean((x-mu)^2),
// statistics in fp32, y rounded once to TO. One warp per row.
// ---------------------------------------------------------------------------

constexpr int kLnRowsPerBlock = 8;

template <typename TI, typename TO>
__global__ void __launch_bounds__(kLnRowsPerBlock * 32)
layer_norm_kernel(const TI* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ b, TO* __restrict__ y, int M,
                  int D, float eps) {
  const int row = blockIdx.x * kLnRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;                  // whole warps leave together
  const TI* xr = x + static_cast<long long>(row) * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += to_f(xr[d]);
  const float mu = __fdiv_rn(warp_sum(s), static_cast<float>(D));
  float s2 = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float c = __fsub_rn(to_f(xr[d]), mu);
    s2 += __fmul_rn(c, c);
  }
  const float var = __fdiv_rn(warp_sum(s2), static_cast<float>(D));
  const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  TO* yr = y + static_cast<long long>(row) * D;
  for (int d = lane; d < D; d += 32) {
    const float c = __fsub_rn(to_f(xr[d]), mu);
    yr[d] = from_f<TO>(__fadd_rn(__fmul_rn(__fmul_rn(c, r), g[d]), b[d]));
  }
}

template <typename TI, typename TO>
int launch_layer_norm(const TI* x, const float* g, const float* b, TO* y,
                      int M, int D, float eps, cudaStream_t st) {
  layer_norm_kernel<TI, TO>
      <<<(M + kLnRowsPerBlock - 1) / kLnRowsPerBlock, kLnRowsPerBlock * 32, 0,
         st>>>(x, g, b, y, M, D, eps);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// GEMM out[part][m][n] = A[m] . W_part[n] + bias_part[n] (+ res[m][n])
// ---------------------------------------------------------------------------

constexpr int kTile = 64;                // output tile, M and N

struct GemmArgs {
  const void* a;                         // (M, K) in A's dtype
  const float* w[3];                     // (n_part, K) fp32, (out, in)
  const float* bias[3];                  // (n_part,) fp32
  const void* residual;                  // (M, n_part) in A's dtype, or null
  void* out;                             // (parts, M, n_part) in TO
  int M, K, n_part;
};

template <typename TA, typename TO>
__device__ __forceinline__ void store_out(const GemmArgs& p, int part, int m,
                                          int n, float acc) {
  if (m >= p.M) return;
  float y = __fadd_rn(acc, p.bias[part][n]);
  const long long mn = static_cast<long long>(m) * p.n_part + n;
  if (p.residual)
    y = __fadd_rn(to_f(static_cast<const TA*>(p.residual)[mn]), y);
  static_cast<TO*>(p.out)[static_cast<long long>(part) * p.M * p.n_part + mn] =
      from_f<TO>(y);
}

// bf16: tensor cores through mma.sync.m16n8k16 (fp32 accumulate).
constexpr int kBkH = 32;                 // k per slab
constexpr int kPadH = 8;                 // row pad: conflict-free fragments

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// block: 4 warps in a 2x2 grid of 32x32 sub-tiles; warp sub-tile = 2 (m16)
// by 4 (n8) mma tiles.
template <typename TO>
__global__ void __launch_bounds__(128) gemm_bf16_kernel(GemmArgs p) {
  __shared__ __align__(16) __nv_bfloat16 As[kTile][kBkH + kPadH];
  __shared__ __align__(16) __nv_bfloat16 Bs[kTile][kBkH + kPadH];
  const int m0 = blockIdx.x * kTile;
  const int part = (blockIdx.y * kTile) / p.n_part;
  const int n0 = (blockIdx.y * kTile) % p.n_part;
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(p.a);
  const float* W = p.w[part] + static_cast<long long>(n0) * p.K;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int grp = lane / 4, tig = lane % 4;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += kBkH) {
    // A: 64 rows x 32 bf16, 16-byte chunks of 8
    for (int c = tid; c < kTile * kBkH / 8; c += 128) {
      const int r = c / (kBkH / 8), kc = (c % (kBkH / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < p.M)
        v = *reinterpret_cast<const uint4*>(
            A + static_cast<long long>(m0 + r) * p.K + k0 + kc);
      *reinterpret_cast<uint4*>(&As[r][kc]) = v;
    }
    // W: 64 rows (n) x 32 fp32, rounded to bf16 (nearest even) on load
    for (int c = tid; c < kTile * kBkH / 4; c += 128) {
      const int r = c / (kBkH / 4), kc = (c % (kBkH / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(
          W + static_cast<long long>(r) * p.K + k0 + kc);
      *reinterpret_cast<__nv_bfloat162*>(&Bs[r][kc]) =
          __floats2bfloat162_rn(v.x, v.y);
      *reinterpret_cast<__nv_bfloat162*>(&Bs[r][kc + 2]) =
          __floats2bfloat162_rn(v.z, v.w);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBkH; kk += 16) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + grp;
        af[i][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + tig * 2]);
        af[i][1] =
            *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + tig * 2]);
        af[i][2] =
            *reinterpret_cast<const uint32_t*>(&As[r][kk + tig * 2 + 8]);
        af[i][3] =
            *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + tig * 2 + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + j * 8 + grp;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(&Bs[n][kk + tig * 2]);
        bf[j][1] =
            *reinterpret_cast<const uint32_t*>(&Bs[n][kk + tig * 2 + 8]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + wm + i * 16 + grp;
      const int n = n0 + wn + j * 8 + tig * 2;
      store_out<__nv_bfloat16, TO>(p, part, m, n, acc[i][j][0]);
      store_out<__nv_bfloat16, TO>(p, part, m, n + 1, acc[i][j][1]);
      store_out<__nv_bfloat16, TO>(p, part, m + 8, n, acc[i][j][2]);
      store_out<__nv_bfloat16, TO>(p, part, m + 8, n + 1, acc[i][j][3]);
    }
}

// fp32: CUDA-core FMAs; 256 threads in a 16x16 grid, 4x4 outputs each.
constexpr int kBkF = 16;

template <typename TO>
__global__ void __launch_bounds__(256) gemm_f32_kernel(GemmArgs p) {
  __shared__ __align__(16) float As[kBkF][kTile + 4];   // k-major
  __shared__ __align__(16) float Bs[kBkF][kTile + 4];
  const int m0 = blockIdx.x * kTile;
  const int part = (blockIdx.y * kTile) / p.n_part;
  const int n0 = (blockIdx.y * kTile) % p.n_part;
  const float* A = static_cast<const float*>(p.a);
  const float* W = p.w[part] + static_cast<long long>(n0) * p.K;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += kBkF) {
    {  // one float4 of A and one of W per thread: 64 rows x 16 k each
      const int r = tid / (kBkF / 4), kc = (tid % (kBkF / 4)) * 4;
      float4 va = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < p.M)
        va = *reinterpret_cast<const float4*>(
            A + static_cast<long long>(m0 + r) * p.K + k0 + kc);
      const float4 vw = *reinterpret_cast<const float4*>(
          W + static_cast<long long>(r) * p.K + k0 + kc);
      As[kc][r] = va.x;
      As[kc + 1][r] = va.y;
      As[kc + 2][r] = va.z;
      As[kc + 3][r] = va.w;
      Bs[kc][r] = vw.x;
      Bs[kc + 1][r] = vw.y;
      Bs[kc + 2][r] = vw.z;
      Bs[kc + 3][r] = vw.w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBkF; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_out<float, TO>(p, part, m0 + ty * 4 + i, n0 + tx * 4 + j,
                           acc[i][j]);
}

// `parts` weight matrices of n_part outputs each; A's dtype is TA.
template <typename TA, typename TO>
int launch_gemm(const GemmArgs& p, int parts, cudaStream_t st) {
  const dim3 grid((p.M + kTile - 1) / kTile, parts * p.n_part / kTile);
  if constexpr (sizeof(TA) == 2)
    gemm_bf16_kernel<TO><<<grid, 128, 0, st>>>(p);
  else
    gemm_f32_kernel<TO><<<grid, 256, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Attention per (sample, head) on the natural layout: q, k, v are rows
// [b*L, b*L + L) of the three (M, D) planes of qkv, columns [h*64, h*64 + 64),
// and ctx (M, D) takes the same columns. One block per (sample, head): the
// head's K and V sit in shared memory in fp32; warp w takes query rows w,
// w + 8, ..., its q row staged in shared memory; lane j scores keys j + 32t
// (t < KPL, so L <= 32 * KPL), so the max and the sum are the row's own, as
// in the Pallas kernels; then lane j owns output dims j and j + 32.
// Logits: fp32 q.k times scale, plus bias[b][r][j] (fp32, element strides
// sbb, sbq, sbk) when bias is not null. The rounding point of p:
//   NORM_FIRST: p normalised in fp32, then rounded to T for p.v; ctx the
//     rounded fp32 sum (K-BLOCK: _attn_block_kernel);
//   else: the unnormalised p rounded to T for p.v, the fp32 sum divided
//     by the row sum last, rounded (K-PRENORM: _prenorm_attn_kernel_v2).
// ---------------------------------------------------------------------------

constexpr int kHeadDim = 64;
constexpr int kAttnWarps = 8;

template <typename T, int KPL, bool NORM_FIRST>
__global__ void __launch_bounds__(kAttnWarps * 32)
head_attention_kernel(const T* __restrict__ qkv,
                      const float* __restrict__ bias, long long sbb,
                      long long sbq, long long sbk, T* __restrict__ ctx,
                      int M, int L, int D, int H, float scale) {
  extern __shared__ float sm[];          // k[L][65], v[L][64], q[warps][64]
  float* ks = sm;
  float* vs = ks + L * (kHeadDim + 1);
  float* qs = vs + L * kHeadDim;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long plane = static_cast<long long>(M) * D;
  const long long row0 = static_cast<long long>(b) * L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < L * kHeadDim; i += blockDim.x) {
    const int r = i / kHeadDim, d = i % kHeadDim;
    const long long o = (row0 + r) * D + h * kHeadDim + d;
    ks[r * (kHeadDim + 1) + d] = to_f(qkv[plane + o]);
    vs[r * kHeadDim + d] = to_f(qkv[2 * plane + o]);
  }
  __syncthreads();

  float* qw = qs + warp * kHeadDim;
  for (int r = warp; r < L; r += kAttnWarps) {
    const T* qr = qkv + (row0 + r) * D + h * kHeadDim;
    qw[lane] = to_f(qr[lane]);
    qw[lane + 32] = to_f(qr[lane + 32]);
    __syncwarp();

    float s[KPL];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const int j = lane + 32 * t;
      s[t] = -INFINITY;
      if (j < L) {
        const float* kr = ks + j * (kHeadDim + 1);
        float acc = 0.f;
#pragma unroll 16
        for (int d = 0; d < kHeadDim; ++d) acc = fmaf(qw[d], kr[d], acc);
        s[t] = __fmul_rn(acc, scale);
        if (bias)
          s[t] = __fadd_rn(s[t], bias[b * sbb + r * sbq + j * sbk]);
      }
      mx = fmaxf(mx, s[t]);
    }
    mx = warp_max(mx);
    float p[KPL];
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      p[t] = lane + 32 * t < L ? expf(__fsub_rn(s[t], mx)) : 0.f;
      sum += p[t];
    }
    const float denom = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < KPL; ++t)
      p[t] = to_f(from_f<T>(NORM_FIRST ? __fdiv_rn(p[t], denom) : p[t]));

    float o0 = 0.f, o1 = 0.f;
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const int j0 = 32 * t;
      if (j0 >= L) break;                // uniform across the warp
      const int n = L - j0 < 32 ? L - j0 : 32;
      for (int jj = 0; jj < n; ++jj) {
        const float pj = __shfl_sync(kFull, p[t], jj);
        const float* vr = vs + (j0 + jj) * kHeadDim;
        o0 = fmaf(pj, vr[lane], o0);
        o1 = fmaf(pj, vr[lane + 32], o1);
      }
    }
    if (!NORM_FIRST) {
      o0 = __fdiv_rn(o0, denom);
      o1 = __fdiv_rn(o1, denom);
    }
    T* cr = ctx + (row0 + r) * D + h * kHeadDim;
    cr[lane] = from_f<T>(o0);
    cr[lane + 32] = from_f<T>(o1);
    __syncwarp();                        // qw is rewritten for the next row
  }
}

// B*H blocks; the caller checks 1 <= L <= 32 * KPL and D = H * 64.
template <typename T, int KPL, bool NORM_FIRST>
int launch_head_attention(const T* qkv, const float* bias, long long sbb,
                          long long sbq, long long sbk, T* ctx, int B, int L,
                          int D, int H, float scale, cudaStream_t st) {
  const size_t smem = (static_cast<size_t>(L) * (2 * kHeadDim + 1) +
                       kAttnWarps * kHeadDim) * sizeof(float);
  if (smem > 48 * 1024) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        head_attention_kernel<T, KPL, NORM_FIRST>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
    if (err) return err;
  }
  head_attention_kernel<T, KPL, NORM_FIRST>
      <<<B * H, kAttnWarps * 32, smem, st>>>(qkv, bias, sbb, sbq, sbk, ctx,
                                             B * L, L, D, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace etp
