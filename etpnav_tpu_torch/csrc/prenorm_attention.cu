// K-PRENORM: CLIP's pre-norm attention half-block, y = x + o(MHA(LN(x))),
// for sm_90a. Built by nvcc into a shared library with a plain C interface
// (see etpnav_tpu_torch/ops/cuda_build.py) and called through ctypes from
// etpnav_tpu_torch/ops/fused_prenorm.py.
//
// Replaces two Pallas TPU kernels of etpnav_tpu/ops/pallas_attention.py
// that compute the same function:
//   - fused_prenorm_attention_v2 (:500-621), q/k/v/o weights (D, D) each;
//   - fused_prenorm_attention (:397-497), a fused (D, 3D) q/k/v weight.
// Rounding points are those of _prenorm_attn_kernel_v2: LayerNorm in fp32
// as mean((x - mu)^2), rounded to x's dtype; each projection an fp32
// accumulate plus an fp32 bias, rounded to x's dtype; logits fp32 times
// scale; p = exp(l - max) rounded to x's dtype before p.v; ctx / sum
// rounded to x's dtype; the output projection an fp32 accumulate plus bo;
// x + out rounded once. The weights are the fp32 (out, in) Linear weights;
// in bf16 they are rounded to nearest even as they are loaded, so they
// equal .to(torch.bfloat16) and no cast kernel runs.
//
// Design: one C entry point that launches a chain of four kernels on the
// caller's stream, all written here (no cuBLAS):
//   1. LayerNorm, one warp per row, writing a = LN(x) (M, D);
//   2. the q/k/v projections as one GEMM with N = 3D, a (M, D) times the
//      three weights, with the bias epilogue, writing q, k, v (3, M, D) in
//      the natural (B, L, H*hd) layout;
//   3. attention, one block per (sample, head): the head's q, k, v slices
//      (L <= 64 rows of hd = 64) sit in shared memory, each warp takes whole
//      query rows, so the softmax max is the row's own (as in the Pallas
//      kernel, not a running one) and p is rounded once;
//   4. the output projection as a GEMM with the bias + residual epilogue.
// The GEMMs use 64x64 output tiles over k-slabs of 32 (bf16: tensor cores
// through mma.sync m16n8k16, fp32 accumulate, four warps of 32x32) or 16
// (fp32: CUDA-core FMAs, 4x4 outputs per thread, sums in k order). The M
// edge (M = B*50 rows) is masked; D must be a multiple of 64.
//
// What bounds it: at the CLIP shape (B*12 = 96 images, L = 50, D = 768)
// the four projections are 2*M*D*4D = 22.6 GFLOP against ~24 MB of
// activations and weights, so in bf16 the tensor cores' rate bounds it
// (~23 us at 989 TFLOP/s) and in fp32 the CUDA cores' (~340 us at 67
// TFLOP/s). This first version keeps a, q/k/v and ctx in device memory
// between the four kernels (5*M*D elements written and read once each)
// and loads its tiles without a pipeline; the L2 holds the weights.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kHeadDim = 64;
constexpr int kMaxLen = 64;              // tokens per sample (ViT-B/32: 50)
constexpr int kTile = 64;                // GEMM output tile, M and N
constexpr int kDefaultSmem = 48 * 1024;

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
// 1. LayerNorm: a = ((x - mu) * rsqrt(var + eps) * g + b) in x's dtype
// ---------------------------------------------------------------------------

constexpr int kLnRowsPerBlock = 8;       // one warp per row

template <typename T>
__global__ void __launch_bounds__(kLnRowsPerBlock * 32)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ b, T* __restrict__ a, int M,
                  int D, float eps) {
  const int row = blockIdx.x * kLnRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;                  // whole warps leave together
  const T* xr = x + static_cast<long long>(row) * D;
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
  T* ar = a + static_cast<long long>(row) * D;
  for (int d = lane; d < D; d += 32) {
    const float c = __fsub_rn(to_f(xr[d]), mu);
    ar[d] = from_f<T>(__fadd_rn(__fmul_rn(__fmul_rn(c, r), g[d]), b[d]));
  }
}

// ---------------------------------------------------------------------------
// 2, 4. GEMM out[part][m][n] = A[m] . W_part[n] + bias_part[n] (+ res[m][n])
// ---------------------------------------------------------------------------

struct GemmArgs {
  const void* a;                         // (M, K) in T
  const float* w[3];                     // (n_part, K) fp32, (out, in)
  const float* bias[3];                  // (n_part,) fp32
  const void* residual;                  // (M, n_part) in T, or null
  void* out;                             // (parts, M, n_part) in T
  int M, K, n_part;
};

template <typename T>
__device__ __forceinline__ void store_out(const GemmArgs& p, int part, int m,
                                          int n, float acc) {
  if (m >= p.M) return;
  float y = __fadd_rn(acc, p.bias[part][n]);
  const long long mn = static_cast<long long>(m) * p.n_part + n;
  if (p.residual) y = __fadd_rn(to_f(static_cast<const T*>(p.residual)[mn]), y);
  static_cast<T*>(p.out)[static_cast<long long>(part) * p.M * p.n_part + mn] =
      from_f<T>(y);
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
      store_out<__nv_bfloat16>(p, part, m, n, acc[i][j][0]);
      store_out<__nv_bfloat16>(p, part, m, n + 1, acc[i][j][1]);
      store_out<__nv_bfloat16>(p, part, m + 8, n, acc[i][j][2]);
      store_out<__nv_bfloat16>(p, part, m + 8, n + 1, acc[i][j][3]);
    }
}

// fp32: CUDA-core FMAs; 256 threads in a 16x16 grid, 4x4 outputs each.
constexpr int kBkF = 16;

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
      store_out<float>(p, part, m0 + ty * 4 + i, n0 + tx * 4 + j, acc[i][j]);
}

// ---------------------------------------------------------------------------
// 3. attention per (sample, head) on the natural layout
// ---------------------------------------------------------------------------

constexpr int kAttnWarps = 4;

// grid: B*H blocks. q, k, v are rows [b*L, b*L + L) of the three (M, D)
// planes of qkv, columns [h*64, h*64 + 64). Warp w takes query rows w,
// w + 4, ...; lane j scores keys j and j + 32, then owns output dims j
// and j + 32.
template <typename T>
__global__ void __launch_bounds__(kAttnWarps * 32)
attention_kernel(const T* __restrict__ qkv, T* __restrict__ ctx, int M,
                 int L, int D, int H, float scale) {
  extern __shared__ float sm[];          // q[L][65], k[L][65], v[L][64]
  float* qs = sm;
  float* ks = qs + L * (kHeadDim + 1);
  float* vs = ks + L * (kHeadDim + 1);
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long plane = static_cast<long long>(M) * D;
  const long long row0 = static_cast<long long>(b) * L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < L * kHeadDim; i += blockDim.x) {
    const int r = i / kHeadDim, d = i % kHeadDim;
    const long long o = (row0 + r) * D + h * kHeadDim + d;
    qs[r * (kHeadDim + 1) + d] = to_f(qkv[o]);
    ks[r * (kHeadDim + 1) + d] = to_f(qkv[plane + o]);
    vs[r * kHeadDim + d] = to_f(qkv[2 * plane + o]);
  }
  __syncthreads();

  const int n_lo = L < 32 ? L : 32;      // keys 0..31 and 32..L-1
  for (int r = warp; r < L; r += kAttnWarps) {
    const float* qr = qs + r * (kHeadDim + 1);
    float s[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = lane + 32 * t;
      float acc = 0.f;
      if (j < L) {
        const float* kr = ks + j * (kHeadDim + 1);
#pragma unroll 16
        for (int d = 0; d < kHeadDim; ++d) acc = fmaf(qr[d], kr[d], acc);
      }
      s[t] = j < L ? __fmul_rn(acc, scale) : -INFINITY;
    }
    const float mx = warp_max(fmaxf(s[0], s[1]));
    float p[2];
#pragma unroll
    for (int t = 0; t < 2; ++t)
      p[t] = lane + 32 * t < L ? expf(__fsub_rn(s[t], mx)) : 0.f;
    const float denom = warp_sum(p[0] + p[1]);
    const float p0 = to_f(from_f<T>(p[0]));     // p in the input dtype
    const float p1 = to_f(from_f<T>(p[1]));
    float o0 = 0.f, o1 = 0.f;
    for (int j = 0; j < n_lo; ++j) {
      const float pj = __shfl_sync(kFull, p0, j);
      o0 = fmaf(pj, vs[j * kHeadDim + lane], o0);
      o1 = fmaf(pj, vs[j * kHeadDim + lane + 32], o1);
    }
    for (int j = 32; j < L; ++j) {
      const float pj = __shfl_sync(kFull, p1, j - 32);
      o0 = fmaf(pj, vs[j * kHeadDim + lane], o0);
      o1 = fmaf(pj, vs[j * kHeadDim + lane + 32], o1);
    }
    T* cr = ctx + (row0 + r) * D + h * kHeadDim;
    cr[lane] = from_f<T>(__fdiv_rn(o0, denom));
    cr[lane + 32] = from_f<T>(__fdiv_rn(o1, denom));
  }
}

template <typename T>
int run_chain(const T* x, const float* ln_g, const float* ln_b,
              const float* const* w, const float* const* bias, T* a, T* qkv,
              T* ctx, T* out, int B, int L, int D, int H, float eps,
              float scale, cudaStream_t st) {
  const int M = B * L;
  layer_norm_kernel<T>
      <<<(M + kLnRowsPerBlock - 1) / kLnRowsPerBlock, kLnRowsPerBlock * 32, 0,
         st>>>(x, ln_g, ln_b, a, M, D, eps);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  GemmArgs qkv_args{a, {w[0], w[1], w[2]}, {bias[0], bias[1], bias[2]},
                    nullptr, qkv, M, D, D};
  const dim3 qkv_grid((M + kTile - 1) / kTile, 3 * D / kTile);
  GemmArgs o_args{ctx, {w[3], w[3], w[3]}, {bias[3], bias[3], bias[3]}, x,
                  out, M, D, D};
  const dim3 o_grid((M + kTile - 1) / kTile, D / kTile);
  const bool bf16 = sizeof(T) == 2;

  if (bf16)
    gemm_bf16_kernel<<<qkv_grid, 128, 0, st>>>(qkv_args);
  else
    gemm_f32_kernel<<<qkv_grid, 256, 0, st>>>(qkv_args);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  const size_t smem =
      static_cast<size_t>(L) * (3 * kHeadDim + 2) * sizeof(float);
  if (smem > kDefaultSmem) {
    err = static_cast<int>(cudaFuncSetAttribute(
        attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (err) return err;
  }
  attention_kernel<T><<<B * H, kAttnWarps * 32, smem, st>>>(qkv, ctx, M, L,
                                                            D, H, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  if (bf16)
    gemm_bf16_kernel<<<o_grid, 128, 0, st>>>(o_args);
  else
    gemm_f32_kernel<<<o_grid, 256, 0, st>>>(o_args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, out (B, L, D) and the scratch a, ctx (B*L, D) and qkv (3, B*L, D)
// in one dtype (0 = float32, 1 = bfloat16), contiguous; ln_g, ln_b and
// the biases fp32 (D,); the weights fp32 (D, D) as (out, in). Needs
// D = H*64, D % 64 == 0 and 1 <= L <= 64. Returns the first non-zero
// cudaGetLastError() of the chain, or -1 for arguments it does not take.
int etp_prenorm_attention(const void* x, const void* ln_g, const void* ln_b,
                          const void* wq, const void* bq, const void* wk,
                          const void* bk, const void* wv, const void* bv,
                          const void* wo, const void* bo, void* a, void* qkv,
                          void* ctx, void* out, int dtype, int B, int L,
                          int D, int H, float eps, float scale,
                          void* stream) {
  if (B < 1 || L < 1 || L > kMaxLen || H < 1 || D != H * kHeadDim ||
      D % kTile != 0)
    return -1;
  const float* w[4] = {static_cast<const float*>(wq),
                       static_cast<const float*>(wk),
                       static_cast<const float*>(wv),
                       static_cast<const float*>(wo)};
  const float* bias[4] = {static_cast<const float*>(bq),
                          static_cast<const float*>(bk),
                          static_cast<const float*>(bv),
                          static_cast<const float*>(bo)};
  const float* g = static_cast<const float*>(ln_g);
  const float* b = static_cast<const float*>(ln_b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_chain<float>(
        static_cast<const float*>(x), g, b, w, bias, static_cast<float*>(a),
        static_cast<float*>(qkv), static_cast<float*>(ctx),
        static_cast<float*>(out), B, L, D, H, eps, scale, st);
  if (dtype == 1)
    return run_chain<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), g, b, w, bias,
        static_cast<__nv_bfloat16*>(a), static_cast<__nv_bfloat16*>(qkv),
        static_cast<__nv_bfloat16*>(ctx), static_cast<__nv_bfloat16*>(out),
        B, L, D, H, eps, scale, st);
  return -1;
}

}  // extern "C"
