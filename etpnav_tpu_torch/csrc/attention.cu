// K-ATT: multi-head attention forward, softmax(q.k^T * scale + bias) . v,
// for sm_90a. Built by nvcc into a shared library with a plain C
// interface (see etpnav_tpu_torch/ops/cuda_build.py) and called through
// ctypes from etpnav_tpu_torch/ops/fused_attention.py.
//
// Replaces three Pallas TPU kernels of etpnav_tpu/ops/pallas_attention.py:
//   - fused_attention_nhd (:211-253), unbiased attention read in place
//     from the natural (B, L, H*hd) projection layout (the CLIP tower);
//   - fused_attention (:123-184), the same on the head-leading
//     (B, H, L, hd) layout (the CLIP tower's cls-row last block, which
//     the port runs on the natural layout with Lq = 1);
//   - fused_bias_attention, forward only (:339-374), with a (B, Lq, Lk)
//     fp32 bias shared by all heads (text, waypoint, pano and graph
//     stacks).
// Every layout is taken through element strides, so no operand is copied
// or transposed before the call; a bias stride of 0 broadcasts (padding
// biases (B,1,1,Lk), the waypoint neighbour mask (1,1,12,12)).
//
// What bounds it: at the shapes of the serving path (L <= 96, hd = 64)
// the work is ~0.7 GFLOP against ~30 MB of q/k/v/out per CLIP layer, far
// below the H100's ~295 FLOP/byte ridge, so the kernel is bound by the
// bytes it moves. The design reads each q row once and each k/v tile
// once per block of 16 query rows, keeps logits, max and sum in
// registers (never in device memory), and writes the output once. It
// uses CUDA cores with fp32 FMAs: this first version trades tensor-core
// throughput (not the limit here) for simple, exact-order numerics.
//
// Numerics follow the Pallas kernels: fp32 logits, max and sum; the
// unnormalised probability p is rounded to the input dtype before p.v,
// which accumulates in fp32; the division by the sum comes last. Keys are
// visited in tiles of 32 with an online softmax, so any Lk >= 1 works.
//
// Training adds two optional operands. Attention-prob dropout (the learn
// step's attn_dropout; the JAX package leaves its kernel for XLA whenever
// dropout is on, etpnav_tpu/ops/attention.py:103,135,166): the rounded p
// of a dropped (q, k) is zeroed and a kept one scaled by 1/keep before
// p.v, while the sum in the denominator keeps every key, so
// ctx = sum_k m_k/keep * round(p_k) v_k / sum_k p_k, which is
// dropout(softmax(s)) . v. The keep bit m is Philox4x32-10 of the logical
// (b, h, q, k) (philox.cuh), so both layouts and the backward kernel draw
// the same mask. And the fp32 row log-sum-exp (B, H, Lq), which the
// backward (attention_bwd.cu) reads to rebuild the probabilities. Without
// dropout the kernel is the DROP = false instantiation, whose arithmetic
// is the serving kernel's unchanged.
//
// K-ATT-CHEAP is the CHEAP = true instantiation of the same kernel, behind
// its own entry point etp_attention_cheap (bf16 only). It replaces
// cheap_attention (tools/exp_attn_pack.py:86, kernel_cheap :49-84), a TPU
// experiment: bf16 logits and a constant-shift softmax with no max pass,
// logits = bf16(sum q.k), x bf16(scale), - bf16(10), p = bf16(exp(.)),
// denom and ctx fp32 sums, out = bf16(ctx / denom). Only the softmax stage
// differs from K-ATT (the tiles, the layouts, the p.v loop and the final
// division are the same), so it is a template switch here and not a source
// of its own: with no running max there is nothing to rescale, and the
// division by the sum still comes last. Its `pack` option filled the TPU's
// 128x128 matrix unit with two samples and has no counterpart here. What
// bounds it is what bounds K-ATT, the bytes of q, k, v and the output: the
// switch drops the max reduction and the rescaling, arithmetic that runs
// beside the loads; it moves the same bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kTileK = 32;                 // keys per tile: one per lane
constexpr int kWarps = 4;
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

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// grid: (B*H, ceil(Lq / kRowsPerBlock)); block: kWarps warps. Warp w owns
// query rows w*kRowsPerWarp .. +kRowsPerWarp-1 of the block's tile; in a
// key tile, lane j scores key j, then the warp accumulates p.v with each
// lane owning hd/32 output dims. CHEAP (bf16, no bias, no dropout, no
// lse): K-ATT-CHEAP's constant-shift softmax in place of the online one.
template <typename T, int HD, bool DROP, bool CHEAP = false>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ out, int H, int Lq, int Lk, Strides sq,
                     Strides sk, Strides sv, Strides so, long long sbb,
                     long long sbq, long long sbk, float scale,
                     const long long* __restrict__ seed_offset,
                     uint32_t threshold, float inv_keep,
                     float* __restrict__ lse) {
  constexpr int kDimsPerLane = HD / 32;
  __shared__ float qs[kRowsPerBlock][HD];
  __shared__ float ks[kTileK][HD + 1];     // +1: lane j reads row j
  __shared__ float vs[kTileK][HD];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = blockIdx.y * kRowsPerBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float* biasb = bias ? bias + b * sbb : nullptr;
  etp::DropoutParams dp{};
  if constexpr (DROP) dp = etp::load_dropout(seed_offset, threshold, inv_keep);
  [[maybe_unused]] const float scale_bf16 = round_bf16(scale);

  for (int i = threadIdx.x; i < kRowsPerBlock * HD; i += blockDim.x) {
    const int r = i / HD, d = i % HD, qi = q0 + r;
    qs[r][d] = qi < Lq ? to_f(qb[qi * sq.l + d]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += kTileK) {
    __syncthreads();                       // previous tile fully consumed
    for (int i = threadIdx.x; i < kTileK * HD; i += blockDim.x) {
      const int j = i / HD, d = i % HD, kj = k0 + j;
      const bool in = kj < Lk;
      ks[j][d] = in ? to_f(kb[kj * sk.l + d]) : 0.f;
      vs[j][d] = in ? to_f(vb[kj * sv.l + d]) : 0.f;
    }
    __syncthreads();

    const int kj = k0 + lane;
    const bool valid = kj < Lk;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      const int qi = q0 + row;
      if (qi >= Lq) continue;              // uniform across the warp
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s = fmaf(qs[row][d], ks[lane][d], s);
      float p_in;
      if constexpr (CHEAP) {
        // every step rounded to bf16; a constant shift of 10, no max
        const float t =
            round_bf16(round_bf16(round_bf16(s) * scale_bf16) - 10.f);
        p_in = valid ? round_bf16(expf(t)) : 0.f;
        l[r] += warp_sum(p_in);
      } else {
        s *= scale;
        if (valid && biasb) s += biasb[qi * sbq + kj * sbk];
        s = valid ? s : -INFINITY;
        const float m_new = fmaxf(m[r], warp_max(s));
        // all logits so far -inf (only with a -inf bias): shift by 0
        const float shift = m_new == -INFINITY ? 0.f : m_new;
        const float p = valid ? expf(s - shift) : 0.f;
        const float corr = expf(m[r] - shift);
        l[r] = l[r] * corr + warp_sum(p);
        p_in = to_f(from_f<T>(p));             // p in the input dtype
        if constexpr (DROP) {
          if (valid)
            p_in = etp::dropout_keep(dp, blockIdx.x, qi, kj)
                       ? p_in * dp.inv_keep
                       : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] *= corr;
        m[r] = m_new;
      }
#pragma unroll 8
      for (int j = 0; j < kTileK; ++j) {
        const float pj = __shfl_sync(kFull, p_in, j);
#pragma unroll
        for (int i = 0; i < kDimsPerLane; ++i)
          acc[r][i] = fmaf(pj, vs[j][lane + 32 * i], acc[r][i]);
      }
    }
  }

  T* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp * kRowsPerWarp + r;
    if (qi >= Lq) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i)
      ob[qi * so.l + lane + 32 * i] = from_f<T>(acc[r][i] * inv);
    // l is the sum at the final max m (or 0 when every logit is -inf,
    // whose probabilities the backward then takes as 0)
    if (lse && lane == 0)
      lse[static_cast<long long>(blockIdx.x) * Lq + qi] =
          l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, const float* bias,
            void* out, int B, int H, int Lq, int Lk, Strides sq, Strides sk,
            Strides sv, Strides so, long long sbb, long long sbq,
            long long sbk, float scale, const long long* seed_offset,
            uint32_t threshold, float inv_keep, float* lse,
            cudaStream_t stream) {
  dim3 grid(B * H, (Lq + kRowsPerBlock - 1) / kRowsPerBlock);
  if (seed_offset)
    attention_fwd_kernel<T, HD, true><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), bias, static_cast<T*>(out), H, Lq, Lk, sq,
        sk, sv, so, sbb, sbq, sbk, scale, seed_offset, threshold, inv_keep,
        lse);
  else
    attention_fwd_kernel<T, HD, false><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), bias, static_cast<T*>(out), H, Lq, Lk, sq,
        sk, sv, so, sbb, sbq, sbk, scale, nullptr, 0u, 1.f, lse);
}

void launch_cheap(const void* q, const void* k, const void* v, void* out,
                  int B, int H, int Lq, int Lk, Strides sq, Strides sk,
                  Strides sv, Strides so, float scale, cudaStream_t stream) {
  dim3 grid(B * H, (Lq + kRowsPerBlock - 1) / kRowsPerBlock);
  attention_fwd_kernel<__nv_bfloat16, 64, false, true>
      <<<grid, kWarps * 32, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), nullptr,
          static_cast<__nv_bfloat16*>(out), H, Lq, Lk, sq, sk, sv, so, 0, 0,
          0, scale, nullptr, 0u, 1.f, nullptr);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. bias may be null (no bias).
// seed_offset: null (no dropout) or device int64[2] {seed, offset}; a
// probability is kept iff its Philox word is below `threshold`, and then
// scaled by inv_keep. lse: null, or a contiguous fp32 (B, H, Lq) output.
// Returns cudaGetLastError() after the launch, or -1 for a head dim or
// dtype the kernel does not take (hd = 64, the width of every
// configuration's heads, is the one built).
int etp_attention_fwd(const void* q, const void* k, const void* v,
                      const void* bias, void* out, int dtype, int B, int H,
                      int Lq, int Lk, int hd, long long sqb, long long sqh,
                      long long sql, long long skb, long long skh,
                      long long skl, long long svb, long long svh,
                      long long svl, long long sob, long long soh,
                      long long sol, long long sbb, long long sbq,
                      long long sbk, float scale, const void* seed_offset,
                      unsigned threshold, float inv_keep, void* lse,
                      void* stream) {
  const Strides sq{sqb, sqh, sql}, sk{skb, skh, skl}, sv{svb, svh, svl},
      so{sob, soh, sol};
  const float* bp = static_cast<const float*>(bias);
  const long long* sp = static_cast<const long long*>(seed_offset);
  float* lp = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd != 64) return -1;
  if (dtype == 0)
    launch<float, 64>(q, k, v, bp, out, B, H, Lq, Lk, sq, sk, sv, so, sbb,
                      sbq, sbk, scale, sp, threshold, inv_keep, lp, st);
  else if (dtype == 1)
    launch<__nv_bfloat16, 64>(q, k, v, bp, out, B, H, Lq, Lk, sq, sk, sv,
                              so, sbb, sbq, sbk, scale, sp, threshold,
                              inv_keep, lp, st);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}

// K-ATT-CHEAP: bfloat16 q, k, v and out with the same element strides as
// etp_attention_fwd, no bias. Returns cudaGetLastError() after the launch,
// or -1 for a head dim other than 64.
int etp_attention_cheap(const void* q, const void* k, const void* v,
                        void* out, int B, int H, int Lq, int Lk, int hd,
                        long long sqb, long long sqh, long long sql,
                        long long skb, long long skh, long long skl,
                        long long svb, long long svh, long long svl,
                        long long sob, long long soh, long long sol,
                        float scale, void* stream) {
  if (hd != 64) return -1;
  launch_cheap(q, k, v, out, B, H, Lq, Lk, Strides{sqb, sqh, sql},
               Strides{skb, skh, skl}, Strides{svb, svh, svl},
               Strides{sob, soh, sol}, scale,
               static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
