// K-ATT-BWD: the backward of K-ATT (attention.cu), for sm_90a. Built by
// nvcc into a shared library with a plain C interface (see
// etpnav_tpu_torch/ops/cuda_build.py) and called through ctypes from
// etpnav_tpu_torch/ops/fused_attention.py, as the backward of
// `AttentionFn`.
//
// Replaces the custom VJP of the Pallas TPU kernel fused_bias_attention
// (etpnav_tpu/ops/pallas_attention.py:339-394), whose backward recomputes
// the attention and returns d(q, k, v, bias). With the forward's output O,
// its row log-sum-exp lse and the incoming gradient dO, per (b, h):
//   P    = exp(q.k^T * scale + bias - lse)        (fp32, recomputed)
//   Z    = m / keep, the forward's dropout mask (1 without dropout)
//   D_i  = sum_d dO_id O_id
//   dV   = (P o Z)^T . dO
//   dP   = dO . V^T
//   dS   = P o (dP o Z - D)
//   dQ   = scale * dS . K,   dK = scale * dS^T . Q
//   dbias[b] = sum_h dS[b, h]                       (only when asked)
// The mask is the forward's Philox draw of the same logical (b, h, q, k)
// (philox.cuh). All sums are fp32; dq, dk and dv are written in q's dtype,
// dbias in fp32.
//
// What bounds it: at the learn step's shapes (L <= 96, hd = 64) the five
// products come to ~10 FLOP per byte of q/k/v/o/dO/dq/dk/dv, far below the
// H100's ridge, so it is bound by the bytes it moves. The design reads
// each q/dO/O row once, walks the keys in tiles of 32 (from L2 once per
// tile of 16 query rows, as the forward does), keeps P, dS and the dK/dV
// sums out of device memory (dK and dV accumulate in fp32 in shared
// memory, Lk * hd * 4 bytes each), and writes every gradient once. One
// block per (b, h) owns all its keys, so dQ rows are complete in the block
// and written directly, and nothing is summed across blocks: the result
// does not depend on scheduling. dbias goes per head to an fp32 scratch
// that a second small kernel sums over the heads, in a fixed order. Like
// the forward, this first version uses CUDA cores with fp32 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kTileK = 32;                 // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long b, h, l;                       // element strides; hd stride is 1
};

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

// Dynamic shared memory of one block, in floats: dK and dV sums for every
// key (Lk rounded up to the tile), one K and one V tile (+1 pad: lane j
// reads row j), the query tile's q and dO, and the tile's P*Z and dS.
__host__ __device__ constexpr long long smem_floats(int lk_pad, int hd) {
  return 2LL * lk_pad * hd + 2LL * kTileK * (hd + 1) +
         2LL * kRowsPerBlock * hd + 2LL * kRowsPerBlock * kTileK;
}

struct Grads {
  void* dq;
  void* dk;
  void* dv;
  float* dbias_heads;                      // (B, H, Lq, Lk) or null
  Strides sdq, sdk, sdv;
};

// grid: B*H blocks of kThreads. Per query tile of 16 rows: warp w owns
// rows w*4 .. w*4+3 for the scores (lane j = key j of the key tile); for
// the products, thread t owns (key, dim) pairs e = t + 128 i of the tile
// (dV, dK) and (row, dim) pairs (dQ), so each sum has one owner.
template <typename T, int HD, bool DROP>
__global__ void __launch_bounds__(kThreads)
attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ o, const T* __restrict__ dout,
                     const float* __restrict__ lse, Grads g, int H, int Lq,
                     int Lk, Strides sq, Strides sk, Strides sv, Strides so,
                     Strides sdo, long long sbb, long long sbq,
                     long long sbk, float scale,
                     const long long* __restrict__ seed_offset,
                     uint32_t threshold, float inv_keep) {
  extern __shared__ float smem[];
  const int lk_pad = (Lk + kTileK - 1) / kTileK * kTileK;
  float* dks = smem;                                   // [lk_pad][HD]
  float* dvs = dks + lk_pad * HD;                      // [lk_pad][HD]
  float* ks = dvs + lk_pad * HD;                       // [kTileK][HD + 1]
  float* vs = ks + kTileK * (HD + 1);                  // [kTileK][HD + 1]
  float* qs = vs + kTileK * (HD + 1);                  // [rows][HD]
  float* dos = qs + kRowsPerBlock * HD;                // [rows][HD]
  float* pzs = dos + kRowsPerBlock * HD;               // [rows][kTileK]
  float* dss = pzs + kRowsPerBlock * kTileK;           // [rows][kTileK]
  __shared__ float row_d[kRowsPerBlock], row_lse[kRowsPerBlock];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* ob = o + b * so.b + h * so.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
  const float* biasb = bias ? bias + b * sbb : nullptr;
  const float* lseb = lse + static_cast<long long>(bh) * Lq;
  float* dbh = g.dbias_heads
                   ? g.dbias_heads + static_cast<long long>(bh) * Lq * Lk
                   : nullptr;
  etp::DropoutParams dp{};
  if constexpr (DROP) dp = etp::load_dropout(seed_offset, threshold, inv_keep);

  for (int i = t; i < lk_pad * HD; i += kThreads) dks[i] = dvs[i] = 0.f;

  constexpr int kDqPerThread = kRowsPerBlock * HD / kThreads;
  constexpr int kKdPerThread = kTileK * HD / kThreads;
  for (int q0 = 0; q0 < Lq; q0 += kRowsPerBlock) {
    __syncthreads();                     // previous query tile consumed
    for (int i = t; i < kRowsPerBlock * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, qi = q0 + r;
      const bool in = qi < Lq;
      qs[i] = in ? to_f(qb[qi * sq.l + d]) : 0.f;
      dos[i] = in ? to_f(dob[qi * sdo.l + d]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      const int qi = q0 + row;
      float part = 0.f;
      if (qi < Lq) {
        for (int d = lane; d < HD; d += 32)
          part += to_f(dob[qi * sdo.l + d]) * to_f(ob[qi * so.l + d]);
      }
      part = warp_sum(part);
      if (lane == 0) {
        row_d[row] = part;
        row_lse[row] = qi < Lq ? lseb[qi] : INFINITY;
      }
    }

    float dq_acc[kDqPerThread];
#pragma unroll
    for (int i = 0; i < kDqPerThread; ++i) dq_acc[i] = 0.f;

    for (int k0 = 0; k0 < Lk; k0 += kTileK) {
      __syncthreads();                   // previous key tile consumed
      for (int i = t; i < kTileK * HD; i += kThreads) {
        const int j = i / HD, d = i % HD, kj = k0 + j;
        const bool in = kj < Lk;
        ks[j * (HD + 1) + d] = in ? to_f(kb[kj * sk.l + d]) : 0.f;
        vs[j * (HD + 1) + d] = in ? to_f(vb[kj * sv.l + d]) : 0.f;
      }
      __syncthreads();

      const int kj = k0 + lane;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int row = warp * kRowsPerWarp + r;
        const int qi = q0 + row;
        const bool valid = qi < Lq && kj < Lk;
        float s = 0.f, dpd = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) {
          s = fmaf(qs[row * HD + d], ks[lane * (HD + 1) + d], s);
          dpd = fmaf(dos[row * HD + d], vs[lane * (HD + 1) + d], dpd);
        }
        float p = 0.f;
        if (valid) {
          s *= scale;
          if (biasb) s += biasb[qi * sbq + kj * sbk];
          p = expf(s - row_lse[row]);
        }
        float z = 1.f;
        if constexpr (DROP) {
          if (valid)
            z = etp::dropout_keep(dp, bh, qi, kj) ? dp.inv_keep : 0.f;
        }
        const float ds = p * (dpd * z - row_d[row]);
        pzs[row * kTileK + lane] = p * z;
        dss[row * kTileK + lane] = ds;
        if (dbh && valid) dbh[static_cast<long long>(qi) * Lk + kj] = ds;
      }
      __syncthreads();

      // dV and dK for the tile's keys: thread t owns (key, dim) pairs
#pragma unroll
      for (int i = 0; i < kKdPerThread; ++i) {
        const int e = t + kThreads * i;
        const int j = e / HD, d = e % HD;
        if (k0 + j >= Lk) continue;
        float av = 0.f, ak = 0.f;
#pragma unroll
        for (int r = 0; r < kRowsPerBlock; ++r) {
          av = fmaf(pzs[r * kTileK + j], dos[r * HD + d], av);
          ak = fmaf(dss[r * kTileK + j], qs[r * HD + d], ak);
        }
        dvs[(k0 + j) * HD + d] += av;
        dks[(k0 + j) * HD + d] += ak;
      }
      // dQ for the tile's rows: thread t owns (row, dim) pairs
#pragma unroll
      for (int i = 0; i < kDqPerThread; ++i) {
        const int e = t + kThreads * i;
        const int r = e / HD, d = e % HD;
        float a = 0.f;
#pragma unroll 8
        for (int j = 0; j < kTileK; ++j)
          a = fmaf(dss[r * kTileK + j], ks[j * (HD + 1) + d], a);
        dq_acc[i] += a;
      }
    }

    T* dqb = static_cast<T*>(g.dq) + b * g.sdq.b + h * g.sdq.h;
#pragma unroll
    for (int i = 0; i < kDqPerThread; ++i) {
      const int e = t + kThreads * i;
      const int r = e / HD, d = e % HD, qi = q0 + r;
      if (qi < Lq) dqb[qi * g.sdq.l + d] = from_f<T>(dq_acc[i] * scale);
    }
  }
  __syncthreads();

  T* dkb = static_cast<T*>(g.dk) + b * g.sdk.b + h * g.sdk.h;
  T* dvb = static_cast<T*>(g.dv) + b * g.sdv.b + h * g.sdv.h;
  for (int i = t; i < Lk * HD; i += kThreads) {
    const int j = i / HD, d = i % HD;
    dkb[j * g.sdk.l + d] = from_f<T>(dks[i] * scale);
    dvb[j * g.sdv.l + d] = from_f<T>(dvs[i]);
  }
}

// dbias[b, q, k] = sum over h of dbias_heads[b, h, q, k], heads in order.
__global__ void head_sum_kernel(const float* __restrict__ heads,
                                float* __restrict__ out, int B, int H,
                                long long plane) {
  const long long n = static_cast<long long>(B) * plane;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long b = i / plane, e = i % plane;
    const float* src = heads + b * H * plane + e;
    float acc = 0.f;
    for (int h = 0; h < H; ++h) acc += src[h * plane];
    out[i] = acc;
  }
}

template <typename T, int HD, bool DROP>
int launch(const void* q, const void* k, const void* v, const float* bias,
           const void* o, const void* dout, const float* lse, Grads g,
           int B, int H, int Lq, int Lk, Strides sq, Strides sk, Strides sv,
           Strides so, Strides sdo, long long sbb, long long sbq,
           long long sbk, float scale, const long long* seed_offset,
           uint32_t threshold, float inv_keep, cudaStream_t stream) {
  const int lk_pad = (Lk + kTileK - 1) / kTileK * kTileK;
  const size_t bytes = smem_floats(lk_pad, HD) * sizeof(float);
  auto kernel = attention_bwd_kernel<T, HD, DROP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * H, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, g, H, Lq, Lk, sq, sk, sv, so, sdo,
      sbb, sbq, sbk, scale, seed_offset, threshold, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest Lk the kernel takes at head dim 64 (its shared memory must fit
// the 227 KB a block may use): the wrapper checks it before the launch.
int etp_attention_bwd_max_lk() {
  int lk = 0;
  while (smem_floats(lk + kTileK, 64) * 4 + 1024 <= 232448) lk += kTileK;
  return lk;
}

// dtype: 0 = float32, 1 = bfloat16. bias may be null; dbias_heads (fp32
// (B, H, Lq, Lk) scratch) and dbias (fp32 (B, Lq, Lk)) are both null or
// both set. seed_offset: null (no dropout) or the forward's device int64[2]
// {seed, offset}, with its threshold and inv_keep. lse: the forward's
// contiguous fp32 (B, H, Lq). Returns the first CUDA error of the
// launches, or -1 for a head dim or dtype the kernel does not take.
int etp_attention_bwd(const void* q, const void* k, const void* v,
                      const void* bias, const void* o, const void* dout,
                      const void* lse, void* dq, void* dk, void* dv,
                      void* dbias_heads, void* dbias, int dtype, int B,
                      int H, int Lq, int Lk, int hd, const long long* st,
                      float scale, const void* seed_offset,
                      unsigned threshold, float inv_keep, void* stream) {
  // st: the element strides (b, h, l) of q, k, v, o, dout, dq, dk, dv,
  // then the bias's (b, q, k): 27 values
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]},
      sdo{st[12], st[13], st[14]};
  const Grads g{dq,
                dk,
                dv,
                static_cast<float*>(dbias_heads),
                {st[15], st[16], st[17]},
                {st[18], st[19], st[20]},
                {st[21], st[22], st[23]}};
  const float* bp = static_cast<const float*>(bias);
  const float* lp = static_cast<const float*>(lse);
  const long long* sp = static_cast<const long long*>(seed_offset);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd != 64 || (dtype != 0 && dtype != 1)) return -1;
  int err;
#define ETP_BWD(T, DROP)                                                    \
  launch<T, 64, DROP>(q, k, v, bp, o, dout, lp, g, B, H, Lq, Lk, sq, sk,    \
                      sv, so, sdo, st[24], st[25], st[26], scale, sp,       \
                      threshold, inv_keep, s)
  if (dtype == 0)
    err = sp ? ETP_BWD(float, true) : ETP_BWD(float, false);
  else
    err = sp ? ETP_BWD(__nv_bfloat16, true) : ETP_BWD(__nv_bfloat16, false);
#undef ETP_BWD
  if (err != 0 || !dbias_heads) return err;
  const long long plane = static_cast<long long>(Lq) * Lk;
  const long long n = B * plane;
  const int blocks = static_cast<int>(n / 256 + 1 < 4096 ? n / 256 + 1 : 4096);
  head_sum_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(
                                             dbias_heads),
                                         static_cast<float*>(dbias), B, H,
                                         plane);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
