// Dense building blocks shared by K-PRENORM (prenorm_attention.cu) and
// K-BLOCK (attention_block.cu), for sm_90a: dtype conversions, warp
// reductions, the tensor-core primitives (cp.async, ldmatrix, mma.sync;
// K-ATT and K-ATT-BWD take them through attention_tc.cuh), a row
// LayerNorm, the rounding of fp32 weights to bf16, the GEMM out = A . W^T
// + bias (+ residual), and the attention of one (sample, head) on the
// natural layout of the GEMM's q/k/v output. Header only; each source
// launches the instantiations it needs. cuda_build hashes every .cuh into
// each library's name, so an edit here rebuilds them all.
//
// What bounds the bf16 chain: at K-PRENORM's CLIP shape (M = 4800 rows,
// K = 768) the q/k/v GEMM (N = 2304) is 17.0 GFLOP, 0.017 ms at the
// tensor cores' 989 TFLOP/s, and the output GEMM (N = 768, plus the
// residual) moves 23 MB, 0.007 ms at 3.35 TB/s. A GEMM with one stage of
// plain loads waits for every k-slab's load, and one that rounds fp32
// weights as it loads them reads each weight once per M-tile (75 tiles,
// ~530 MB from L2 for the q/k/v weights). So:
//   - the bf16 weights are rounded once per call, by round_bf16_kernel
//     (7 MB read, 3.5 MB written), and the GEMM copies raw bf16 tiles;
//   - the GEMM keeps a ring of 3 k-slabs of 64 in shared memory,
//     filled by 16-byte cp.async 2 slabs ahead of the
//     mma.sync m16n8k16 products (fp32 accumulate), whose fragments come
//     from ldmatrix; 128 x 128 output tiles of 8 warps where that gives
//     at least one block per SM, else 64 x 64 tiles of 4 warps (K-BLOCK's
//     text layer: M = 640 gives 360 and 120 blocks);
//   - the epilogue adds the fp32 bias, then the residual (in A's dtype) in
//     fp32, and stores a pair of columns in TO: A's dtype (rounded once)
//     or fp32 (not rounded, for a LayerNorm that follows);
//   - the attention scores and sums on tensor cores: one warp per 16 query
//     rows, K, V and Q of the head in shared memory as bf16 by cp.async,
//     the softmax on the score fragments in registers (the row's own max,
//     as in the Pallas kernels), p reused from the fragments as the A
//     operand of p.v.
// On an H100 SXM at 700 W (chip_smoke.py) the bf16 K-PRENORM chain takes
// ~0.16 ms at the CLIP shape, ~0.12 ms of it in the two GEMMs (~190
// TFLOP/s): what is left to gain is the GEMM's, by wgmma fed by TMA.
// The fp32 launches keep CUDA-core arithmetic: 64x64 tiles over k-slabs of
// 16, 4x4 outputs per thread, sums in k order; the attention with fp32 K
// and V in shared memory, one warp per query row.

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
// Tensor-core primitives. Every head tile in shared memory holds rows of
// hd = 64 bf16 (128 bytes) at a pitch of 72 elements (144 bytes): the
// 16-byte chunks that one ldmatrix phase reads from 8 consecutive rows then
// fall on 8 distinct groups of 4 banks, so the loads are free of bank
// conflicts. A (rows x keys) bf16 tile whose width is a multiple of 16 gets
// a pitch of width + 8 for the same reason.
//
// Fragment coordinates of an m16n8 accumulator c[4] in a warp (grp =
// lane / 4, tig = lane % 4): c[0], c[1] at row grp, columns 2 tig and
// 2 tig + 1; c[2], c[3] at row grp + 8, the same columns.
// ---------------------------------------------------------------------------

constexpr int kTcHd = 64;                // the head dim of every tile
constexpr int kTcPitch = kTcHd + 8;      // bf16 elements per tile row

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// The same copy, or 16 zero bytes where `valid` is false (the source is
// then not read).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait for every cp.async this thread issued (the caller then syncs the
// threads that read the copied rows).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void zero16(void* smem) {
  *reinterpret_cast<uint4*>(smem) = make_uint4(0u, 0u, 0u, 0u);
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8, and register i receives matrix i in the mma layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Two fp32 values rounded to bf16 (nearest even), `lo` in the low half:
// the lower column of an mma fragment register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A operand (16 rows x 16 k) of tile `base` (a row-major bf16 tile at
// `pitch` elements): rows r0 .. r0+15, columns c0 .. c0+15.
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* base,
                                       int pitch, int r0, int c0, int lane) {
  ldmatrix_x4(a, base + (r0 + lane % 16) * pitch + c0 + (lane / 16) * 8);
}

// The B operands of two n8 tiles for a product X . Y^T, Y stored
// row-major with n along its rows: Y rows n0 .. n0+15 (tile 0: b[0],
// b[1]; tile 1: b[2], b[3]), columns (the k of the product) c0 .. c0+15.
__device__ __forceinline__ void load_b_nt(uint32_t* b,
                                          const __nv_bfloat16* base,
                                          int pitch, int n0, int c0,
                                          int lane) {
  ldmatrix_x4(b, base + (n0 + lane % 8 + (lane / 16) * 8) * pitch + c0 +
                     ((lane / 8) % 2) * 8);
}

// The B operands of two n8 tiles for a product X . Y, Y stored row-major
// with k along its rows: Y rows (the k of the product) k0 .. k0+15,
// columns n0 .. n0+15 (tile 0: b[0], b[1]; tile 1: b[2], b[3]).
__device__ __forceinline__ void load_b_nn(uint32_t* b,
                                          const __nv_bfloat16* base,
                                          int pitch, int k0, int n0,
                                          int lane) {
  ldmatrix_x4_trans(b, base + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * pitch +
                           n0 + (lane / 16) * 8);
}

// The A operand of X^T (16 rows x 16 k) for a product X^T . Y, X stored
// row-major with k along its rows: X rows k0 .. k0+15, columns (the rows
// of the product) m0 .. m0+15.
__device__ __forceinline__ void load_a_t(uint32_t* a,
                                         const __nv_bfloat16* base,
                                         int pitch, int k0, int m0,
                                         int lane) {
  ldmatrix_x4_trans(a, base + (k0 + lane % 8 + (lane / 16) * 8) * pitch + m0 +
                           ((lane / 8) % 2) * 8);
}

// The A operand of the next product from the accumulators of two
// adjacent n8 tiles (16 columns), rounded to bf16: the FlashAttention-2
// reuse of a score tile as the left operand, with no shared memory.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* c0,
                                         const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
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
// fp32 -> bf16 (nearest even) of up to 4 matrices of n elements each, n a
// multiple of 4: the GEMM's bf16 weights, equal to .to(torch.bfloat16).
// ---------------------------------------------------------------------------

struct RoundArgs {
  const float* src[4];
  int n;
};

__global__ void __launch_bounds__(256)
round_bf16_kernel(RoundArgs a, __nv_bfloat16* __restrict__ dst) {
  const float4* s = reinterpret_cast<const float4*>(a.src[blockIdx.y]);
  uint2* d = reinterpret_cast<uint2*>(
      dst + static_cast<long long>(blockIdx.y) * a.n);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n / 4;
       i += gridDim.x * blockDim.x) {
    const float4 v = s[i];
    d[i] = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

inline int launch_round_bf16(const float* const* src, int mats, int n,
                             __nv_bfloat16* dst, cudaStream_t st) {
  RoundArgs a{};
  for (int i = 0; i < mats; ++i) a.src[i] = src[i];
  a.n = n;
  const int blocks = (n / 4 + 255) / 256;
  round_bf16_kernel<<<dim3(blocks < 1024 ? blocks : 1024, mats), 256, 0,
                      st>>>(a, dst);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// GEMM out[part][m][n] = A[m] . W_part[n] + bias_part[n] (+ res[m][n])
// ---------------------------------------------------------------------------

constexpr int kTile = 64;                // fp32 output tile, M and N

struct GemmArgs {
  const void* a;                         // (M, K) in A's dtype
  const void* w[3];                      // (n_part, K) as (out, in), A's dtype
  const float* bias[3];                  // (n_part,) fp32
  const void* residual;                  // (M, n_part) in A's dtype, or null
  void* out;                             // (parts, M, n_part) in TO
  int M, K, n_part;
};

// a[i] of a kernel argument's array by selects: an index into it would
// copy the array to the local stack
template <typename P>
__device__ __forceinline__ P pick3(const P (&a)[3], int i) {
  return i == 0 ? a[0] : (i == 1 ? a[1] : a[2]);
}

template <typename TA, typename TO>
__device__ __forceinline__ void store_out(const GemmArgs& p, int part, int m,
                                          int n, float acc) {
  if (m >= p.M) return;
  float y = __fadd_rn(acc, pick3(p.bias, part)[n]);
  const long long mn = static_cast<long long>(m) * p.n_part + n;
  if (p.residual)
    y = __fadd_rn(to_f(static_cast<const TA*>(p.residual)[mn]), y);
  static_cast<TO*>(p.out)[static_cast<long long>(part) * p.M * p.n_part + mn] =
      from_f<TO>(y);
}

// Columns n, n + 1 of row m of a bf16 GEMM (bias and out already those of
// the part): the same arithmetic as store_out, one 4- or 8-byte store.
template <typename TO>
__device__ __forceinline__ void store_pair(const GemmArgs& p,
                                           const float* bias, TO* out, int m,
                                           int n, float c0, float c1) {
  if (m >= p.M) return;
  float y0 = __fadd_rn(c0, bias[n]), y1 = __fadd_rn(c1, bias[n + 1]);
  const long long mn = static_cast<long long>(m) * p.n_part + n;
  if (p.residual) {
    const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const __nv_bfloat16*>(p.residual) + mn);
    y0 = __fadd_rn(__low2float(r), y0);
    y1 = __fadd_rn(__high2float(r), y1);
  }
  if constexpr (sizeof(TO) == 2)
    *reinterpret_cast<uint32_t*>(out + mn) = pack_bf16(y0, y1);
  else
    *reinterpret_cast<float2*>(out + mn) = make_float2(y0, y1);
}

// bf16: a ring of kGemmStages k-slabs of 64 (A: BM rows, W: BN rows, at a
// pitch of 72 elements, 144 bytes, so the 8 rows of an ldmatrix phase fall
// on distinct banks), filled by cp.async; warps in a (BM/WM) x (BN/WN)
// grid, each WM x WN of (WM/16) x (WN/8) m16n8 tiles. 128 x 128 tiles
// take 110.6 KB, so two blocks share an SM.
constexpr int kGemmBk = 64;
constexpr int kGemmPitch = kGemmBk + 8;
constexpr int kGemmStages = 3;

template <int BM, int BN, int WM, int WN>
struct GemmTile {
  static constexpr int kWarps = (BM / WM) * (BN / WN);
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kStageElems = (BM + BN) * kGemmPitch;
  static constexpr size_t kSmem =
      static_cast<size_t>(kGemmStages) * kStageElems * 2;
};

template <typename TO, int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(GemmTile<BM, BN, WM, WN>::kThreads)
gemm_bf16_kernel(GemmArgs p) {
  using Tile = GemmTile<BM, BN, WM, WN>;
  constexpr int MI = WM / 16, NI = WN / 8, kChunks = kGemmBk / 8;
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(gemm_smem);
  const int m0 = blockIdx.x * BM;
  const int part = (blockIdx.y * BN) / p.n_part;
  const int n0 = (blockIdx.y * BN) % p.n_part;
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(p.a);
  const __nv_bfloat16* W =
      static_cast<const __nv_bfloat16*>(pick3(p.w, part)) +
      static_cast<long long>(n0) * p.K;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = (warp / (BN / WN)) * WM, wn = (warp % (BN / WN)) * WN;
  const int grp = lane / 4, tig = lane % 4;
  const int KT = p.K / kGemmBk;

  auto load_stage = [&](int stage, int kt) {
    __nv_bfloat16* As = sm + stage * Tile::kStageElems;
    __nv_bfloat16* Bs = As + BM * kGemmPitch;
    const int k0 = kt * kGemmBk;
    for (int c = tid; c < BM * kChunks; c += Tile::kThreads) {
      const int r = c / kChunks, kc = (c % kChunks) * 8;
      const bool ok = m0 + r < p.M;
      cp_async16_zfill(
          As + r * kGemmPitch + kc,
          A + static_cast<long long>(ok ? m0 + r : 0) * p.K + k0 + kc, ok);
    }
    for (int c = tid; c < BN * kChunks; c += Tile::kThreads) {
      const int r = c / kChunks, kc = (c % kChunks) * 8;
      cp_async16(Bs + r * kGemmPitch + kc,
                 W + static_cast<long long>(r) * p.K + k0 + kc);
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kGemmStages - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kGemmStages - 2>();    // slab kt has landed
    __syncthreads();                     // ... for every thread, and slab
                                         // kt - 1's stage is free again
    const int next = kt + kGemmStages - 1;
    if (next < KT) load_stage(next % kGemmStages, next);
    cp_async_commit();
    const __nv_bfloat16* As = sm + (kt % kGemmStages) * Tile::kStageElems;
    const __nv_bfloat16* Bs = As + BM * kGemmPitch;
#pragma unroll
    for (int kk = 0; kk < kGemmBk; kk += 16) {
      uint32_t af[MI][4], bfr[NI / 2][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        load_a(af[i], As, kGemmPitch, wm + i * 16, kk, lane);
#pragma unroll
      for (int j = 0; j < NI / 2; ++j)
        load_b_nt(bfr[j], Bs, kGemmPitch, wn + j * 16, kk, lane);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI / 2; ++j) {
          mma_bf16(acc[i][2 * j], af[i], bfr[j]);
          mma_bf16(acc[i][2 * j + 1], af[i], bfr[j] + 2);
        }
    }
  }
  const float* bias = pick3(p.bias, part);
  TO* out = static_cast<TO*>(p.out) + static_cast<long long>(part) * p.M *
                                          p.n_part;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int m = m0 + wm + i * 16 + grp;
      const int n = n0 + wn + j * 8 + tig * 2;
      store_pair<TO>(p, bias, out, m, n, acc[i][j][0], acc[i][j][1]);
      store_pair<TO>(p, bias, out, m + 8, n, acc[i][j][2], acc[i][j][3]);
    }
}

template <typename TO, int BM, int BN, int WM, int WN>
int launch_gemm_bf16(const GemmArgs& p, int parts, cudaStream_t st) {
  using Tile = GemmTile<BM, BN, WM, WN>;
  auto kernel = gemm_bf16_kernel<TO, BM, BN, WM, WN>;
  if constexpr (Tile::kSmem > 48 * 1024) {
    // every launch: a function-local static would be one object across
    // the libraries that include this header (a unique global symbol),
    // and only the first library's kernel would get the attribute
    const int err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Tile::kSmem)));
    if (err) return err;
  }
  const dim3 grid((p.M + BM - 1) / BM, parts * p.n_part / BN);
  kernel<<<grid, Tile::kThreads, Tile::kSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
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
  const float* W = static_cast<const float*>(pick3(p.w, part)) +
                   static_cast<long long>(n0) * p.K;
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

// `parts` weight matrices of n_part outputs each; A's dtype is TA. The
// caller checks n_part % 64 == 0 and K % 64 == 0.
template <typename TA, typename TO>
int launch_gemm(const GemmArgs& p, int parts, cudaStream_t st) {
  if constexpr (sizeof(TA) == 2) {
    constexpr int kSms = 132;
    const long long blocks128 =
        static_cast<long long>((p.M + 127) / 128) * (parts * p.n_part / 128);
    if (p.n_part % 128 == 0 && blocks128 >= kSms)
      return launch_gemm_bf16<TO, 128, 128, 32, 64>(p, parts, st);
    return launch_gemm_bf16<TO, 64, 64, 32, 32>(p, parts, st);
  } else {
    const dim3 grid((p.M + kTile - 1) / kTile, parts * p.n_part / kTile);
    gemm_f32_kernel<TO><<<grid, 256, 0, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
}

// ---------------------------------------------------------------------------
// Attention per (sample, head) on the natural layout: q, k, v are rows
// [b*L, b*L + L) of the three (M, D) planes of qkv, columns [h*64, h*64 + 64),
// and ctx (M, D) takes the same columns. fp32, on CUDA cores: one block per
// (sample, head), the head's K and V in shared memory in fp32; warp w takes
// query rows w, w + 8, ..., its q row staged in shared memory; lane j
// scores keys j + 32t
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

// bf16 on tensor cores: one block per (sample, head), up to 8 warps; warp
// w takes the 16-row query tiles w, w + 8, ... Q, K and V of the head (Lp =
// L rounded up to 16 rows; rows >= L zero) sit in shared memory at pitch
// kTcPitch. The scores of a warp's 16 rows over all Lp keys stay in the
// m16n8 accumulators (NT 16-key tiles, L <= 16 * NT), so the max and the sum
// are the row's own; keys >= L score -inf. p = exp(l - max) in fp32; the sum
// adds the fp32 p; p is rounded to bf16 (after the division by the sum
// when NORM_FIRST) as the A operand of p.v, and the fp32 sum of p.v is
// divided last otherwise, then rounded.
constexpr int kAttnTcWarps = 8;

template <int NT, bool NORM_FIRST>
__global__ void __launch_bounds__(kAttnTcWarps * 32)
head_attention_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                         const float* __restrict__ bias, long long sbb,
                         long long sbq, long long sbk,
                         __nv_bfloat16* __restrict__ ctx, int M, int L,
                         int D, int H, float scale) {
  extern __shared__ __align__(16) unsigned char attn_smem[];
  const int Lp = (L + 15) & ~15, nt = Lp / 16;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(attn_smem);
  __nv_bfloat16* ks = qs + Lp * kTcPitch;
  __nv_bfloat16* vs = ks + Lp * kTcPitch;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long plane = static_cast<long long>(M) * D;
  const long long row0 = static_cast<long long>(b) * L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;

  for (int c = threadIdx.x; c < Lp * (kTcHd / 8); c += blockDim.x) {
    const int r = c / (kTcHd / 8), dc = (c % (kTcHd / 8)) * 8;
    const bool ok = r < L;
    const long long o = (row0 + (ok ? r : 0)) * D + h * kTcHd + dc;
    cp_async16_zfill(qs + r * kTcPitch + dc, qkv + o, ok);
    cp_async16_zfill(ks + r * kTcPitch + dc, qkv + plane + o, ok);
    cp_async16_zfill(vs + r * kTcPitch + dc, qkv + 2 * plane + o, ok);
  }
  cp_async_wait_all();
  __syncthreads();

  for (int qt = warp; qt < nt; qt += blockDim.x / 32) {
    const int q0 = qt * 16;
    uint32_t qf[kTcHd / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTcHd / 16; ++kk)
      load_a(qf[kk], qs, kTcPitch, q0, kk * 16, lane);

    float s[2 * NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[2 * t][e] = s[2 * t + 1][e] = 0.f;
      if (t < nt) {
#pragma unroll
        for (int kk = 0; kk < kTcHd / 16; ++kk) {
          uint32_t bf[4];
          load_b_nt(bf, ks, kTcPitch, t * 16, kk * 16, lane);
          mma_bf16(s[2 * t], qf[kk], bf);
          mma_bf16(s[2 * t + 1], qf[kk], bf + 2);
        }
      }
    }

    // logits, the row's max: e < 2 is row q0 + grp, e >= 2 row + 8
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t8 = 0; t8 < 2 * NT; ++t8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q0 + grp + (e >> 1) * 8;
        const int j = t8 * 8 + 2 * tig + (e & 1);
        float v = -INFINITY;
        if (j < L) {
          v = __fmul_rn(s[t8][e], scale);
          if (bias && r < L) v = __fadd_rn(v, bias[b * sbb + r * sbq + j * sbk]);
        }
        s[t8][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
    }
#pragma unroll
    for (int t8 = 0; t8 < 2 * NT; ++t8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = t8 * 8 + 2 * tig + (e & 1);
        const float pe = j < L ? expf(__fsub_rn(s[t8][e], mx[e >> 1])) : 0.f;
        s[t8][e] = pe;
        sum[e >> 1] += pe;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(kFull, sum[i], 1);
      sum[i] += __shfl_xor_sync(kFull, sum[i], 2);
    }
    if (NORM_FIRST) {
#pragma unroll
      for (int t8 = 0; t8 < 2 * NT; ++t8)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[t8][e] = __fdiv_rn(s[t8][e], sum[e >> 1]);
    }

    float o[kTcHd / 8][4];
#pragma unroll
    for (int d8 = 0; d8 < kTcHd / 8; ++d8)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d8][e] = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (t < nt) {
        uint32_t pa[4];
        acc_to_a(pa, s[2 * t], s[2 * t + 1]);
#pragma unroll
        for (int d16 = 0; d16 < kTcHd / 16; ++d16) {
          uint32_t bf[4];
          load_b_nn(bf, vs, kTcPitch, t * 16, d16 * 16, lane);
          mma_bf16(o[2 * d16], pa, bf);
          mma_bf16(o[2 * d16 + 1], pa, bf + 2);
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = q0 + grp + half * 8;
      if (r >= L) continue;
      __nv_bfloat16* cr = ctx + (row0 + r) * D + h * kTcHd + 2 * tig;
#pragma unroll
      for (int d8 = 0; d8 < kTcHd / 8; ++d8) {
        float y0 = o[d8][2 * half], y1 = o[d8][2 * half + 1];
        if (!NORM_FIRST) {
          y0 = __fdiv_rn(y0, sum[half]);
          y1 = __fdiv_rn(y1, sum[half]);
        }
        *reinterpret_cast<uint32_t*>(cr + d8 * 8) = pack_bf16(y0, y1);
      }
    }
  }
}

template <int NT, bool NORM_FIRST>
int launch_head_attention_tc(const __nv_bfloat16* qkv, const float* bias,
                             long long sbb, long long sbq, long long sbk,
                             __nv_bfloat16* ctx, int B, int L, int D, int H,
                             float scale, cudaStream_t st) {
  const int Lp = (L + 15) & ~15;
  const size_t smem = 3 * static_cast<size_t>(Lp) * kTcPitch * 2;
  auto kernel = head_attention_tc_kernel<NT, NORM_FIRST>;
  if (smem > 48 * 1024) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (err) return err;
  }
  const int warps = Lp / 16 < kAttnTcWarps ? Lp / 16 : kAttnTcWarps;
  kernel<<<B * H, warps * 32, smem, st>>>(qkv, bias, sbb, sbq, sbk, ctx,
                                          B * L, L, D, H, scale);
  return static_cast<int>(cudaGetLastError());
}

// B*H blocks; the caller checks 1 <= L <= 32 * KPL and D = H * 64. bf16
// runs the tensor-core kernel, built for 16 * NT >= L keys (NT from
// {4, 8, 2 KPL}); fp32 the CUDA-core one.
template <typename T, int KPL, bool NORM_FIRST>
int launch_head_attention(const T* qkv, const float* bias, long long sbb,
                          long long sbq, long long sbk, T* ctx, int B, int L,
                          int D, int H, float scale, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    static_assert(KPL <= 2 || KPL > 4, "NT buckets are 4, 8, 2 KPL");
    if constexpr (KPL <= 2) {
      return launch_head_attention_tc<2 * KPL, NORM_FIRST>(
          qkv, bias, sbb, sbq, sbk, ctx, B, L, D, H, scale, st);
    } else {
      if (L <= 64)
        return launch_head_attention_tc<4, NORM_FIRST>(
            qkv, bias, sbb, sbq, sbk, ctx, B, L, D, H, scale, st);
      if (L <= 128)
        return launch_head_attention_tc<8, NORM_FIRST>(
            qkv, bias, sbb, sbq, sbk, ctx, B, L, D, H, scale, st);
      return launch_head_attention_tc<2 * KPL, NORM_FIRST>(
          qkv, bias, sbb, sbq, sbk, ctx, B, L, D, H, scale, st);
    }
  } else {
    const size_t smem = (static_cast<size_t>(L) * (2 * kHeadDim + 1) +
                         kAttnWarps * kHeadDim) * sizeof(float);
    if (smem > 48 * 1024) {
      const int err = static_cast<int>(cudaFuncSetAttribute(
          head_attention_kernel<T, KPL, NORM_FIRST>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem)));
      if (err) return err;
    }
    head_attention_kernel<T, KPL, NORM_FIRST>
        <<<B * H, kAttnWarps * 32, smem, st>>>(qkv, bias, sbb, sbq, sbk, ctx,
                                               B * L, L, D, H, scale);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace etp
