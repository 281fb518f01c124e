// Dense building blocks shared by K-PRENORM (prenorm_attention.cu) and
// K-BLOCK (attention_block.cu), for sm_90a: dtype conversions, warp
// reductions, the tensor-core primitives (cp.async, ldmatrix, mma.sync;
// K-ATT and K-ATT-BWD take them through attention_tc.cuh), Hopper's
// mbarrier, TMA and wgmma primitives, a row LayerNorm, the rounding of
// fp32 weights to bf16, the GEMM out = A . W^T + bias (+ residual), and
// the attention of one (sample, head) on the natural layout of the GEMM's
// q/k/v output. Header only; each source launches the instantiations it
// needs. cuda_build hashes every .cuh into each library's name, so an
// edit here rebuilds them all.
//
// What bounds the bf16 chain: at K-PRENORM's CLIP shape (M = 4800 rows,
// K = 768) the q/k/v GEMM (N = 2304) is 17.0 GFLOP, 0.017 ms at the
// tensor cores' 989 TFLOP/s, and the output GEMM (N = 768, plus the
// residual) moves 23 MB, 0.007 ms at 3.35 TB/s. So:
//   - the bf16 weights are rounded once per call, by round_bf16_kernel
//     (7 MB read, 3.5 MB written), and the GEMM copies raw bf16 tiles;
//   - the GEMM runs on wgmma, the one instruction that reaches
//     the tensor cores' full rate: TMA fills a ring of 3-4 k-slabs of 64
//     in shared memory (128-byte swizzle, the layout the wgmma
//     descriptors read), mbarriers signal each stage, one producer warp
//     keeps the loads in flight while one or two consumer warpgroups
//     issue m64nBNk16 products (bf16 in, fp32 accumulate) into
//     registers; the grid is persistent. Tiles of 128 x 128, two blocks
//     per SM, where M gives two blocks per SM, 64 x 128 where it does not
//     (K-BLOCK's text layer, M = 640). The earlier cp.async / ldmatrix /
//     mma.sync GEMM ran the q/k/v product at ~190 TFLOP/s against
//     cuBLAS's ~570 (NVIDIA H100 80GB HBM3, 700 W);
//   - the epilogue adds the fp32 bias, then the residual (in A's dtype) in
//     fp32, and stores in TO: A's dtype (rounded once) or fp32 (not
//     rounded, for a LayerNorm that follows), 16 bytes a lane through a
//     small per-warp buffer in shared memory;
//   - the attention scores and sums on tensor cores (mma.sync): a grid of
//     (sample, head, query group of up to 4 tiles), one warp per 16 query
//     rows; the head's K and V and the group's Q in shared memory as bf16
//     by cp.async; a row's scores over all keys in registers (the row's
//     own max and sum, as in the Pallas kernels), p packed from the
//     fragments as the A operand of p.v.
// The fp32 launches keep CUDA-core arithmetic: 64x64 tiles over k-slabs of
// 16, 4x4 outputs per thread, sums in k order; the attention with fp32 K
// and V in shared memory, one warp per query row.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

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

// Each thread rounds kRoundVecs float4s, their loads issued together.
constexpr int kRoundVecs = 4;

__global__ void __launch_bounds__(256)
round_bf16_kernel(RoundArgs a, __nv_bfloat16* __restrict__ dst) {
  const float4* s = reinterpret_cast<const float4*>(a.src[blockIdx.y]);
  uint2* d = reinterpret_cast<uint2*>(
      dst + static_cast<long long>(blockIdx.y) * a.n);
  const int stride = gridDim.x * blockDim.x;
  for (int i0 = blockIdx.x * blockDim.x + threadIdx.x; i0 < a.n / 4;
       i0 += stride * kRoundVecs) {
    float4 vs[kRoundVecs];
#pragma unroll
    for (int u = 0; u < kRoundVecs; ++u)
      if (i0 + u * stride < a.n / 4) vs[u] = s[i0 + u * stride];
#pragma unroll
    for (int u = 0; u < kRoundVecs; ++u)
      if (i0 + u * stride < a.n / 4) {
        const float4 v = vs[u];
        d[i0 + u * stride] =
            make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
      }
  }
}

inline int launch_round_bf16(const float* const* src, int mats, int n,
                             __nv_bfloat16* dst, cudaStream_t st) {
  RoundArgs a{};
  for (int i = 0; i < mats; ++i) a.src[i] = src[i];
  a.n = n;
  const int blocks = (n / 4 + 256 * kRoundVecs - 1) / (256 * kRoundVecs);
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

// The epilogue of one warp's 16 x BN accumulators d (rows m_w + grp and
// + 8 of each n8 column tile j, columns n0 + 8 j + 2 tig and + 1: the
// mma.sync m16n8 layout): + the fp32 bias, then + the residual (bf16) in
// fp32, stored as TO, rows >= M skipped; bias and out are the part's. The
// warp moves 16 columns at a time through its fp32 buffer cbuf (16 rows
// at a pitch of kEpiPitch floats), so that each lane then reads 8
// consecutive columns of one row and stores them as one 16-byte (bf16) or
// two (fp32) vectors: whole sectors, where the fragment layout writes 4
// bytes per lane across 8 rows.
constexpr int kEpiPitch = 20;
constexpr int kEpiFloats = 16 * kEpiPitch;   // one warp's buffer

template <typename TO, int BN>
__device__ __forceinline__ void store_rows(const GemmArgs& p,
                                           const float* bias, TO* out,
                                           int m_w, int n0, const float* d,
                                           float* cbuf, int lane) {
  const __nv_bfloat16* res = static_cast<const __nv_bfloat16*>(p.residual);
  const int grp = lane / 4, tig = lane % 4;
  const int r = lane / 2, c = (lane % 2) * 8, m = m_w + r;
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += 2) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = j0 + jj;
      const float2 bv = __ldg(
          reinterpret_cast<const float2*>(bias + n0 + j * 8 + 2 * tig));
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(cbuf + (grp + 8 * h) * kEpiPitch +
                                   jj * 8 + 2 * tig) =
            make_float2(__fadd_rn(d[4 * j + 2 * h], bv.x),
                        __fadd_rn(d[4 * j + 2 * h + 1], bv.y));
    }
    __syncwarp();
    float v[8];
    const float4 v0 =
        *reinterpret_cast<const float4*>(cbuf + r * kEpiPitch + c);
    const float4 v1 =
        *reinterpret_cast<const float4*>(cbuf + r * kEpiPitch + c + 4);
    v[0] = v0.x; v[1] = v0.y; v[2] = v0.z; v[3] = v0.w;
    v[4] = v1.x; v[5] = v1.y; v[6] = v1.z; v[7] = v1.w;
    __syncwarp();                        // cbuf is rewritten next
    if (m >= p.M) continue;
    const long long mn =
        static_cast<long long>(m) * p.n_part + n0 + j0 * 8 + c;
    if (res) {
      const uint4 rr = __ldg(reinterpret_cast<const uint4*>(res + mn));
      const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&rr);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = __fadd_rn(__low2float(r2[i]), v[2 * i]);
        v[2 * i + 1] = __fadd_rn(__high2float(r2[i]), v[2 * i + 1]);
      }
    }
    if constexpr (sizeof(TO) == 2) {
      *reinterpret_cast<uint4*>(out + mn) =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                     pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    } else {
      *reinterpret_cast<float4*>(out + mn) =
          make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(out + mn + 4) =
          make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

// ---------------------------------------------------------------------------
// Hopper's asynchronous pieces for the bf16 GEMM: mbarriers, TMA tile
// loads (cp.async.bulk.tensor) and warpgroup products (wgmma.mma_async).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// A barrier wait that does not end is a deadlock of the ring, not a slow
// launch: no legitimate wait comes near kMbarTimeoutNs (the slowest slab
// takes microseconds). mbar_wait then writes a fault record into
// host-mapped memory, where the host reads it after the launch has failed
// (device printf may not flush before a trap), and traps, so the hang
// becomes a launch error that names its barrier. The bound costs one
// %globaltimer read per failed try_wait.
constexpr unsigned long long kMbarTimeoutNs = 4000000000ull;   // 4 s
constexpr unsigned long long kFaultGraceNs = 50000000ull;      // 50 ms

// The record's words: kFaultSet, then the kernel's tile (BM, BN, STAGES),
// the barrier (0 = full, 1 = empty), its stage, the parity waited for, the
// block and the thread. One thread of the grid writes it.
constexpr unsigned kFaultSet = 0x6d626172u;                 // "mbar"
constexpr int kFaultWords = 9;

struct BarrierSite {
  unsigned* fault;                       // host-mapped record, or null
  unsigned short bm, bn, stages, kind;   // kind: 0 = full, 1 = empty
};

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

static __device__ unsigned g_fault_claim;  // elects the record's writer

__device__ __noinline__ void mbar_fault(const BarrierSite& site, int stage,
                                        int parity) {
  if (site.fault && atomicCAS(&g_fault_claim, 0u, 1u) == 0u) {
    volatile unsigned* r = site.fault;
    r[1] = site.bm;
    r[2] = site.bn;
    r[3] = site.stages;
    r[4] = site.kind;
    r[5] = static_cast<unsigned>(stage);
    r[6] = static_cast<unsigned>(parity);
    r[7] = blockIdx.x;
    r[8] = threadIdx.x;
    __threadfence_system();
    r[0] = kFaultSet;
    __threadfence_system();
  }
  // every faulting thread waits before it traps: a trap ends the context
  // and may drop the record's stores still on their way to the host
  const uint64_t t = global_ns();
  while (global_ns() - t < kFaultGraceNs) {
  }
  __trap();
}

// Wait until the barrier's phase of parity `parity` has completed; trap
// with a fault record after kMbarTimeoutNs.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity,
                                          const BarrierSite& site,
                                          int stage) {
  const uint32_t a = smem_u32(bar);
  uint64_t t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t now = global_ns();
    if (t0 == 0)
      t0 = now;
    else if (now - t0 > kMbarTimeoutNs)
      mbar_fault(site, stage, parity);
  }
}

// The (c0 = column, c1 = row) box of a 2-D tensor map into shared
// memory; its bytes complete on `bar`. Rows past the tensor's end land as
// zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// A wgmma shared-memory descriptor for a K-major bf16 tile stored as
// 128-byte rows in TMA's 128-byte swizzle (8-row atoms of 1024 bytes, the
// atom's base 1024-byte aligned): start address >> 4, leading byte
// offset 1 (unused by this layout), stride byte offset 1024 >> 4, layout
// SWIZZLE_128B. The k-th 16-wide slice of the 64-wide slab starts 32 k
// bytes further: + 2 k in the address field.
__device__ __forceinline__ uint64_t sw128_desc(const void* smem) {
  const uint64_t a = smem_u32(smem);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products (CUTLASS's warpgroup_fence_operand).
template <int R>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, fp32, in registers) += A (64 x 16) . B (N x 16)^T, both
// K-major bf16 in shared memory. Accumulator i of a thread (lane: grp =
// lane / 4, tig = lane % 4) of warp w of the warpgroup sits at row 16 w +
// grp + 8 ((i / 2) % 2), column 8 (i / 4) + 2 tig + i % 2: the mma.sync
// m16n8 fragment repeated over N / 8 column tiles.
__device__ __forceinline__ void wgmma_m64n64(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da,
                                           uint64_t db) {
  if constexpr (N == 64) wgmma_m64n64(d, da, db);
  else wgmma_m64n128(d, da, db);
}

// bf16: a ring of STAGES k-slabs of 64 (one 128-byte swizzle row of bf16
// per tile row: A BM x 64, W BN x 64), filled by TMA and consumed by
// wgmma. One producer warp (one thread of it) keeps the loads in flight:
// it waits for a stage's `empty` barrier, announces the stage's bytes on
// its `full` barrier and issues the tile loads. BM / 64 consumer
// warpgroups each own 64 rows x BN columns of fp32 accumulators: they
// wait for `full`, issue the slab's four m64nBNk16 products, commit, and
// once the previous slab's products are done (wait_group 1) release that
// slab's stage on `empty`. The epilogue is store_rows's from the
// accumulator registers. The grid is persistent (at most MIN_BLOCKS
// blocks per SM, each walking over output tiles), so one tile's epilogue
// runs while the producer already loads the next tile's slabs.

constexpr int kWgBk = 64;
constexpr int kSms = 132;                // an H100 SXM's SMs

template <int BM, int BN, int STAGES>
struct WgTile {
  static constexpr int kConsumers = BM / 64;         // warpgroups
  static constexpr int kThreads = kConsumers * 128 + 32;
  static constexpr int kABytes = BM * kWgBk * 2;
  static constexpr int kStageBytes = (BM + BN) * kWgBk * 2;
  // the stages, each consumer warp's epilogue buffer, alignment slack
  static constexpr size_t kSmem = static_cast<size_t>(STAGES) * kStageBytes +
                                  kConsumers * 4 * kEpiFloats * 4 + 1024;
};

// The producer's loads of the KT slabs of one tile (A rows from m0, W rows
// from w_row0); `it` counts slabs over all of the block's tiles.
template <int BM, int BN, int STAGES>
__device__ __forceinline__ void produce_tile(const CUtensorMap* tm_a,
                                             const CUtensorMap* tm_w,
                                             unsigned char* base,
                                             uint64_t* full, uint64_t* empty,
                                             int m0, int w_row0, int KT,
                                             int& it, unsigned* fault) {
  using Tile = WgTile<BM, BN, STAGES>;
  const BarrierSite site{fault, BM, BN, STAGES, 1};
  for (int kt = 0; kt < KT; ++kt, ++it) {
    const int s = it % STAGES;
#ifdef ETP_TEST_WITHHOLD_ARRIVE
    // a deliberately broken ring, for testing the bounded wait only: the
    // producer of block 0 stops before its first arrival on full[0], so
    // that block's consumers wait on full[0], parity 0, forever
    if (blockIdx.x == 0 && it == 0) return;
#endif
    if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1, site, s);
    unsigned char* st = base + s * Tile::kStageBytes;
    mbar_expect_tx(&full[s], Tile::kStageBytes);
    tma_load_2d(st, tm_a, &full[s], kt * kWgBk, m0);
    tma_load_2d(st + Tile::kABytes, tm_w, &full[s], kt * kWgBk, w_row0);
  }
}

// A consumer warpgroup's products of one tile into d (64 rows from wg *
// 64, BN columns), each slab's stage released once its products are done.
template <int BM, int BN, int STAGES>
__device__ __forceinline__ void consume_tile(float* d,
                                             const unsigned char* base,
                                             uint64_t* full, uint64_t* empty,
                                             int KT, int& it, int wg,
                                             bool leader, unsigned* fault) {
  using Tile = WgTile<BM, BN, STAGES>;
  const BarrierSite site{fault, BM, BN, STAGES, 0};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
  for (int kt = 0; kt < KT; ++kt, ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1, site, s);
    const unsigned char* st = base + s * Tile::kStageBytes;
    const uint64_t da = sw128_desc(st + wg * 64 * 128);
    const uint64_t db = sw128_desc(st + Tile::kABytes);
    fence_acc<BN / 2>(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBk / 16; ++kk)
      wgmma_tile<BN>(d, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();                     // slab it - 1's products are done
    fence_acc<BN / 2>(d);
    if (kt > 0 && leader) mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_acc<BN / 2>(d);
  if (leader) mbar_arrive(&empty[(it - 1) % STAGES]);
}

// The ring's barriers, initialised by thread 0: `full` takes the
// producer's arrival and the TMA bytes, `empty` one arrival per consumer
// warpgroup. The caller then syncs the block.
template <int STAGES>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int consumers) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// the swizzle atoms need a 1024-byte aligned base
__device__ __forceinline__ unsigned char* ring_base(unsigned char* smem) {
  return smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
}

template <typename TO, int BM, int BN, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__(WgTile<BM, BN, STAGES>::kThreads,
                                  MIN_BLOCKS)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap tm_a,
                 const __grid_constant__ CUtensorMap tm_w, GemmArgs p,
                 int n_tiles, unsigned* fault) {
  using Tile = WgTile<BM, BN, STAGES>;
  extern __shared__ __align__(1024) unsigned char gemm_smem[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  unsigned char* base = ring_base(gemm_smem);
  const int m_tiles = (p.M + BM - 1) / BM;
  const int tiles = m_tiles * n_tiles;
  const int KT = p.K / kWgBk;
  const int tid = threadIdx.x;
  init_ring<STAGES>(full, empty, Tile::kConsumers);
  __syncthreads();

  // Persistent: block c takes tiles c, c + gridDim.x, ... (M fastest, so
  // neighbouring blocks share a W tile in L2); `it` counts k-slabs over
  // all of a block's tiles, so stage and phase run on across tiles and the
  // producer loads the next tile while the consumers store this one.
  int it = 0;
  if (tid >= Tile::kConsumers * 128) {   // the producer warp
    if (tid == Tile::kConsumers * 128)
      for (int t = blockIdx.x; t < tiles; t += gridDim.x)
        produce_tile<BM, BN, STAGES>(&tm_a, &tm_w, base, full, empty,
                                     (t % m_tiles) * BM, (t / m_tiles) * BN,
                                     KT, it, fault);
    return;
  }
  const int wg = tid / 128, lane = tid % 32;
  float* cbuf = reinterpret_cast<float*>(base + STAGES * Tile::kStageBytes) +
                (tid / 32) * kEpiFloats;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t % m_tiles) * BM, w_row0 = (t / m_tiles) * BN;
    float d[BN / 2];
    consume_tile<BM, BN, STAGES>(d, base, full, empty, KT, it, wg,
                                 tid % 128 == 0, fault);
    const int part = w_row0 / p.n_part, n0 = w_row0 % p.n_part;
    TO* out = static_cast<TO*>(p.out) +
              static_cast<long long>(part) * p.M * p.n_part;
    store_rows<TO, BN>(p, pick3(p.bias, part), out,
                       m0 + wg * 64 + ((tid % 128) / 32) * 16, n0, d, cbuf,
                       lane);
  }
}

// The library's barrier fault record: kFaultWords words of pinned host
// memory mapped into the device's address space, allocated once by
// etp_dense_fault_init when the library is loaded (outside any stream
// capture). Each library that includes this header has its own.
static unsigned* g_fault_host = nullptr;
static unsigned* g_fault_device = nullptr;

static inline unsigned* fault_record_device() { return g_fault_device; }

// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// libraries link no libcuda); null if the driver has none.
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiledFn>(nullptr);
    return reinterpret_cast<EncodeTiledFn>(f);
  }();
  return fn;
}

// What a GEMM launch returns when the driver cannot encode a tensor map.
constexpr int kErrTensorMap = -3;

// The map of a row-major (rows, K) bf16 matrix, read in boxes of
// box_rows x 64 with the 128-byte swizzle; out-of-range rows read zeros.
inline int encode_rows(CUtensorMap* map, const void* ptr, int rows, int K,
                       int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return kErrTensorMap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t box[2] = {kWgBk, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

template <typename TO, int BM, int BN, int STAGES, int MIN_BLOCKS>
int launch_gemm_bf16(const GemmArgs& p, int parts, cudaStream_t st) {
  using Tile = WgTile<BM, BN, STAGES>;
  CUtensorMap tm_a, tm_w;
  int err = encode_rows(&tm_a, p.a, p.M, p.K, BM);
  if (!err) err = encode_rows(&tm_w, p.w[0], parts * p.n_part, p.K, BN);
  if (err) return err;
  auto kernel = gemm_bf16_kernel<TO, BM, BN, STAGES, MIN_BLOCKS>;
  // every launch: a function-local static would be one object across the
  // libraries that include this header (a unique global symbol), and only
  // the first library's kernel would get the attribute
  err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tile::kSmem)));
  if (err) return err;
  const int n_tiles = parts * p.n_part / BN;
  const int tiles = (p.M + BM - 1) / BM * n_tiles;
  const int grid = tiles < kSms * MIN_BLOCKS ? tiles : kSms * MIN_BLOCKS;
  kernel<<<grid, Tile::kThreads, Tile::kSmem, st>>>(tm_a, tm_w, p, n_tiles,
                                                    fault_record_device());
  return static_cast<int>(cudaGetLastError());
}

// The bf16 tile configuration, by shape: BM x BN, stages, blocks per SM.
//   128 x 128, 3 stages (107 KB), 2 blocks per SM, where M gives two
//     blocks per SM;
//   64 x 128, 4 stages (102 KB), 2 blocks per SM, where it does not
//     (K-BLOCK's text layer, M = 640);
//   64 x 64, 4 stages (70 KB), 3 blocks per SM, for n_part % 128 != 0.
// 128 x 256 tiles at one block per SM were slower than 128 x 128 at the
// port's K = 768 (PERF.md).
template <typename TO>
int dispatch_gemm_bf16(const GemmArgs& p, int parts, cudaStream_t st) {
  // the parts' weights are one (parts * n_part, K) matrix
  for (int i = 1; i < parts; ++i)
    if (p.w[i] != static_cast<const __nv_bfloat16*>(p.w[0]) +
                      static_cast<long long>(i) * p.n_part * p.K)
      return -1;
  if (reinterpret_cast<uintptr_t>(p.a) % 16 ||
      reinterpret_cast<uintptr_t>(p.w[0]) % 16)
    return -2;  // etp::kErrMisaligned: TMA needs 16-byte aligned bases
  for (int i = 0; i < parts; ++i)
    if (reinterpret_cast<uintptr_t>(p.bias[i]) % 8) return -2;
  if (reinterpret_cast<uintptr_t>(p.residual) % 16 ||
      reinterpret_cast<uintptr_t>(p.out) % 16)
    return -2;                           // the epilogue's 16-byte vectors
  if (p.n_part % 128 != 0)
    return launch_gemm_bf16<TO, 64, 64, 4, 3>(p, parts, st);
  const long long tiles128 =
      static_cast<long long>((p.M + 127) / 128) * (parts * p.n_part / 128);
  if (tiles128 >= 2 * kSms)
    return launch_gemm_bf16<TO, 128, 128, 3, 2>(p, parts, st);
  return launch_gemm_bf16<TO, 64, 128, 4, 2>(p, parts, st);
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
    return dispatch_gemm_bf16<TO>(p, parts, st);
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

// bf16 on tensor cores: a grid of (sample, head, query group), one warp
// per 16-row query tile. The head's nt = Lp / 16 query tiles (Lp = L
// rounded up to 16) split into ceil(nt / kQw) groups of at most kQw = 4
// tiles, as equal as they come (at L = 200: 3, 3, 3 and 4), one block of
// 4 warps each, so every warp carries one tile and a thread may hold up
// to ~170 registers at three blocks per SM (the scores of 16 rows over
// 208 keys need ~160; at L <= 128, 128 registers and four blocks per SM
// do). A block copies the head's K and V (rows >= L zero) and its own Q
// rows into shared memory by cp.async, at pitch kTcPitch, and the bias
// as fp32: one row for a key mask, else its query rows where they fit
// two blocks per SM, else the bias is read where it lies. A warp's scores of its 16 rows over all Lp keys stay in the m16n8
// accumulators (NT 16-key tiles, L <= 16 NT; NT is the smallest of 4, 6,
// 8, 13, 14 that holds L), so the max and the sum are the row's own (keys
// >= L score -inf). p = exp(l - max) in fp32; the sum adds the fp32 p; p
// is rounded to bf16 (after the division by the sum when NORM_FIRST) into
// packed A operands before the p.v accumulators start; the fp32 sum of
// p.v is divided last otherwise, then rounded.
// One block of nt warps per (sample, head) copies K and V once but, at L
// = 200, holds 13 warps: 128 registers a thread, spilling. Built with
// this softmax it was no faster at L = 200 with a key mask, and slower
// with a full bias and at L <= 96 (PERF.md).
constexpr int kQw = 4;                             // query tiles a block
constexpr size_t kAttnSmemPerBlock = 113 * 1024;   // two blocks per SM

// Where a block finds the head attention's bias: none; one key row the
// same for every query row (a key mask), staged in shared memory; its
// query rows, staged where they fit two blocks per SM; or in global
// memory where it lies. A template parameter of the kernel, so that each
// instantiation holds one path.
enum AttnBias { kBiasNone, kBiasKeyRow, kBiasRows, kBiasGlobal };

inline int attn_bias_mode(const float* bias, long long sbq, int Lp) {
  if (!bias) return kBiasNone;
  if (sbq == 0) return kBiasKeyRow;
  const size_t kvq = (2 * static_cast<size_t>(Lp) + kQw * 16) * kTcPitch * 2;
  return kvq + static_cast<size_t>(kQw) * 16 * Lp * 4 <= kAttnSmemPerBlock
             ? kBiasRows : kBiasGlobal;
}

// the rows of fp32 bias a block of mode BIAS stages
template <int BIAS>
__host__ __device__ constexpr int staged_bias_rows() {
  return BIAS == kBiasKeyRow ? 1 : (BIAS == kBiasRows ? kQw * 16 : 0);
}

// p / s rounded to nearest even for 0 <= p <= 1 <= s (a probability over
// its row's sum), through the row's correctly rounded reciprocal y = 1/s:
// q0 = RN(p y), then RN(q0 + RN(p - s q0) y), which is the correctly
// rounded quotient while p - s q0 does not underflow (Markstein's
// correction), so for p = 0 and for p >= 2^-100; three instructions in
// place of __fdiv_rn's reciprocal refinement and range check. A warp
// that holds any p in (0, 2^-100) divides all of its p by __fdiv_rn.
__device__ __forceinline__ float div_by_row_sum(float p, float s, float y) {
  const float q0 = __fmul_rn(p, y);
  return __fmaf_rn(__fmaf_rn(-q0, s, p), y, q0);
}

__device__ __forceinline__ bool needs_fdiv(float p) {
  return p > 0.f && p < 0x1p-100f;
}

template <int NT, bool NORM_FIRST, int BIAS>
__global__ void __launch_bounds__(kQw * 32, NT >= 13 ? 3 : 4)
head_attention_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                         const float* __restrict__ bias, long long sbb,
                         long long sbq, long long sbk,
                         __nv_bfloat16* __restrict__ ctx, int M, int L,
                         int D, int H, float scale) {
  constexpr int bias_rows = staged_bias_rows<BIAS>();
  extern __shared__ __align__(16) unsigned char attn_smem[];
  const int Lp = (L + 15) & ~15, nt = Lp / 16;
  const int groups = (nt + kQw - 1) / kQw;
  const int g = blockIdx.x % groups, bh = blockIdx.x / groups;
  const int b = bh / H, h = bh % H;
  // the block's query tiles [t0, t1), rows [r0, r0 + nq)
  const int t0 = g * nt / groups, t1 = (g + 1) * nt / groups;
  const int r0 = t0 * 16, nq = (t1 - t0) * 16;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(attn_smem);
  __nv_bfloat16* vs = ks + Lp * kTcPitch;
  __nv_bfloat16* qs = vs + Lp * kTcPitch;
  float* bs = reinterpret_cast<float*>(qs + kQw * 16 * kTcPitch);
  const long long plane = static_cast<long long>(M) * D;
  const long long row0 = static_cast<long long>(b) * L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;

  for (int c = threadIdx.x; c < Lp * (kTcHd / 8); c += blockDim.x) {
    const int r = c / (kTcHd / 8), dc = (c % (kTcHd / 8)) * 8;
    const bool ok = r < L;
    const long long o = (row0 + (ok ? r : 0)) * D + h * kTcHd + dc;
    cp_async16_zfill(ks + r * kTcPitch + dc, qkv + plane + o, ok);
    cp_async16_zfill(vs + r * kTcPitch + dc, qkv + 2 * plane + o, ok);
  }
  for (int c = threadIdx.x; c < nq * (kTcHd / 8); c += blockDim.x) {
    const int r = c / (kTcHd / 8), dc = (c % (kTcHd / 8)) * 8;
    const bool ok = r0 + r < L;
    const long long o = (row0 + (ok ? r0 + r : 0)) * D + h * kTcHd + dc;
    cp_async16_zfill(qs + r * kTcPitch + dc, qkv + o, ok);
  }
  for (int c = threadIdx.x; c < bias_rows * Lp; c += blockDim.x) {
    const int gr = BIAS == kBiasKeyRow ? 0 : r0 + c / Lp, j = c % Lp;
    bs[c] = gr < L && j < L ? bias[b * sbb + gr * sbq + j * sbk] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
  if (warp >= t1 - t0) return;           // a group of fewer than kQw tiles
  const int q0 = r0 + warp * 16;

  uint32_t qf[kTcHd / 16][4];
#pragma unroll
  for (int kk = 0; kk < kTcHd / 16; ++kk)
    load_a(qf[kk], qs, kTcPitch, warp * 16, kk * 16, lane);
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

  // logits and the row's max: e < 2 is row q0 + grp, e >= 2 row + 8; keys
  // >= L score -inf. A staged bias is read as float2 pairs of keys (a key
  // row, or the warp's two rows), a bias in global memory where it lies;
  // rows >= L are computed, read no bias from global memory and are not
  // stored.
  float mx[2] = {-INFINITY, -INFINITY};
  if constexpr (BIAS == kBiasKeyRow || BIAS == kBiasRows) {
    const float* br0 =
        bs + (BIAS == kBiasKeyRow ? 0 : (warp * 16 + grp) * Lp);
    const float* br1 = BIAS == kBiasKeyRow ? br0 : br0 + 8 * Lp;
#pragma unroll
    for (int t8 = 0; t8 < 2 * NT; ++t8) {
      const int j = t8 * 8 + 2 * tig;
      float2 b0 = make_float2(0.f, 0.f), b1 = b0;
      if (t8 < 2 * nt) {                 // uniform; keys past Lp
        b0 = *reinterpret_cast<const float2*>(br0 + j);
        b1 = *reinterpret_cast<const float2*>(br1 + j);
      }
      const float bb[4] = {b0.x, b0.y, b1.x, b1.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = __fadd_rn(__fmul_rn(s[t8][e], scale), bb[e]);
        s[t8][e] = j + (e & 1) < L ? v : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[t8][e]);
      }
    }
  } else if constexpr (BIAS == kBiasGlobal) {
    const float* bw = bias + b * sbb + q0 * sbq;
#pragma unroll
    for (int t8 = 0; t8 < 2 * NT; ++t8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = grp + (e >> 1) * 8;
        const int j = t8 * 8 + 2 * tig + (e & 1);
        s[t8][e] = __fmul_rn(s[t8][e], scale);
        if (j < L && q0 + r < L)
          s[t8][e] = __fadd_rn(s[t8][e], bw[r * sbq + j * sbk]);
      }
#pragma unroll
    for (int t8 = 0; t8 < 2 * NT; ++t8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (t8 * 8 + 2 * tig + (e & 1) >= L) s[t8][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[t8][e]);
      }
  } else {
#pragma unroll
    for (int t8 = 0; t8 < 2 * NT; ++t8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = t8 * 8 + 2 * tig + (e & 1);
        s[t8][e] = j < L ? __fmul_rn(s[t8][e], scale) : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[t8][e]);
      }
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
    bool tiny = false;
#pragma unroll
    for (int t8 = 0; t8 < 2 * NT; ++t8)
#pragma unroll
      for (int e = 0; e < 4; ++e) tiny |= needs_fdiv(s[t8][e]);
    if (__any_sync(kFull, tiny)) {       // warp-uniform: no divergence
#pragma unroll
      for (int t8 = 0; t8 < 2 * NT; ++t8)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[t8][e] = __fdiv_rn(s[t8][e], sum[e >> 1]);
    } else {
      const float y[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
#pragma unroll
      for (int t8 = 0; t8 < 2 * NT; ++t8)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[t8][e] = div_by_row_sum(s[t8][e], sum[e >> 1], y[e >> 1]);
    }
  }
  uint32_t pa[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc_to_a(pa[t], s[2 * t], s[2 * t + 1]);

  float o[kTcHd / 8][4];
#pragma unroll
  for (int d8 = 0; d8 < kTcHd / 8; ++d8)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d8][e] = 0.f;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t < nt) {
#pragma unroll
      for (int d16 = 0; d16 < kTcHd / 16; ++d16) {
        uint32_t bf[4];
        load_b_nn(bf, vs, kTcPitch, t * 16, d16 * 16, lane);
        mma_bf16(o[2 * d16], pa[t], bf);
        mma_bf16(o[2 * d16 + 1], pa[t], bf + 2);
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

template <int NT, bool NORM_FIRST, int BIAS>
int launch_head_attention_tc_bias(const __nv_bfloat16* qkv, const float* bias,
                                  long long sbb, long long sbq, long long sbk,
                                  __nv_bfloat16* ctx, int B, int L, int D,
                                  int H, float scale, cudaStream_t st) {
  const int Lp = (L + 15) & ~15;
  const size_t smem =
      (2 * static_cast<size_t>(Lp) + kQw * 16) * kTcPitch * 2 +
      static_cast<size_t>(staged_bias_rows<BIAS>()) * Lp * 4;
  auto kernel = head_attention_tc_kernel<NT, NORM_FIRST, BIAS>;
  if (smem > 48 * 1024) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (err) return err;
  }
  const int groups = (Lp / 16 + kQw - 1) / kQw;
  kernel<<<B * H * groups, kQw * 32, smem, st>>>(
      qkv, bias, sbb, sbq, sbk, ctx, B * L, L, D, H, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int NT, bool NORM_FIRST>
int launch_head_attention_tc(const __nv_bfloat16* qkv, const float* bias,
                             long long sbb, long long sbq, long long sbk,
                             __nv_bfloat16* ctx, int B, int L, int D, int H,
                             float scale, cudaStream_t st) {
  switch (attn_bias_mode(bias, sbq, (L + 15) & ~15)) {
    case kBiasNone:
      return launch_head_attention_tc_bias<NT, NORM_FIRST, kBiasNone>(
          qkv, bias, sbb, sbq, sbk, ctx, B, L, D, H, scale, st);
    case kBiasKeyRow:
      return launch_head_attention_tc_bias<NT, NORM_FIRST, kBiasKeyRow>(
          qkv, bias, sbb, sbq, sbk, ctx, B, L, D, H, scale, st);
    case kBiasRows:
      return launch_head_attention_tc_bias<NT, NORM_FIRST, kBiasRows>(
          qkv, bias, sbb, sbq, sbk, ctx, B, L, D, H, scale, st);
    default:
      return launch_head_attention_tc_bias<NT, NORM_FIRST, kBiasGlobal>(
          qkv, bias, sbb, sbq, sbk, ctx, B, L, D, H, scale, st);
  }
}

// The caller checks 1 <= L <= 32 * KPL and D = H * 64. bf16 runs the
// tensor-core kernel, built for 16 * NT >= L keys (NT from 4, 6, 8, 13,
// 14; L <= 64 for KPL = 2); fp32 the CUDA-core one.
template <typename T, int KPL, bool NORM_FIRST>
int launch_head_attention(const T* qkv, const float* bias, long long sbb,
                          long long sbq, long long sbk, T* ctx, int B, int L,
                          int D, int H, float scale, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    static_assert(KPL == 2 || KPL == 7, "NT buckets cover L <= 64 or 224");
    if (KPL == 2 || L <= 64)
      return launch_head_attention_tc<4, NORM_FIRST>(
          qkv, bias, sbb, sbq, sbk, ctx, B, L, D, H, scale, st);
    if constexpr (KPL == 2) {
      return -1;                         // L > 64: not reached
    } else {
      if (L <= 96)
        return launch_head_attention_tc<6, NORM_FIRST>(
            qkv, bias, sbb, sbq, sbk, ctx, B, L, D, H, scale, st);
      if (L <= 128)
        return launch_head_attention_tc<8, NORM_FIRST>(
            qkv, bias, sbb, sbq, sbk, ctx, B, L, D, H, scale, st);
      if (L <= 208)
        return launch_head_attention_tc<13, NORM_FIRST>(
            qkv, bias, sbb, sbq, sbk, ctx, B, L, D, H, scale, st);
      return launch_head_attention_tc<14, NORM_FIRST>(
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

extern "C" {

// Allocates the barrier fault record (see mbar_wait); 0 or a CUDA error.
// Without it a stuck wait still traps, with no record.
int etp_dense_fault_init() {
  if (etp::g_fault_host) return 0;
  void* h = nullptr;
  int err = static_cast<int>(cudaHostAlloc(
      &h, etp::kFaultWords * sizeof(unsigned),
      cudaHostAllocMapped | cudaHostAllocPortable));
  if (err) return err;
  memset(h, 0, etp::kFaultWords * sizeof(unsigned));
  void* d = nullptr;
  err = static_cast<int>(cudaHostGetDevicePointer(&d, h, 0));
  if (err) {
    cudaFreeHost(h);
    return err;
  }
  etp::g_fault_host = static_cast<unsigned*>(h);
  etp::g_fault_device = static_cast<unsigned*>(d);
  return 0;
}

// Copies the record's kFaultWords words into out (a host read that needs
// no working CUDA context); returns 1 if a wait timed out, else 0.
int etp_dense_fault(unsigned* out) {
  const volatile unsigned* r = etp::g_fault_host;
  if (!r) return 0;
  for (int i = 0; i < etp::kFaultWords; ++i) out[i] = r[i];
  return out[0] == etp::kFaultSet;
}

}  // extern "C"
