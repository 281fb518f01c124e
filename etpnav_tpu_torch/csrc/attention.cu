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
// What bounds it: at the shapes of the paths (L <= 200, hd = 64) the work
// is ~4 L FLOP per byte of q/k/v/out, below the H100's ~295 FLOP/byte
// ridge, so the kernel is bound by the bytes it moves. Two designs:
//
// bf16 (every bf16 launch): tensor cores. One block per (b, h, 128-row
// query tile), one warp per 16 query rows (up to 8, two blocks per SM).
// The head's K and V are copied once per block into shared memory as
// bf16 with 16-byte cp.async (in chunks of 256 keys beyond that),
// S = Q.K^T runs on mma.sync.m16n8k16 with fp32 accumulators, the softmax
// works on those accumulator fragments in registers (scale, bias by its
// strides, the -inf of keys past Lk, row max and sum by quad shuffles, the
// dropout bits of each fragment, one Philox call per four elements), and
// the rounded p of two adjacent key tiles is the
// A operand of P.V with no shared-memory round trip. Keys are walked 64
// at a time with an online softmax. The output is staged in shared memory
// and written with 16-byte stores, so q, k, v and the output need a
// 16-byte-aligned base and row, head and batch strides (the entry points
// check). A block reads K and V from L2 once per 128 query rows.
//
// fp32: CUDA cores with fp32 FMAs (a TF32 tensor core would break the
// fp32 tolerances), 16 query rows per block of 4 warps, keys in tiles of
// 32, one per lane.
//
// Head width 192 (DeepSeek-V2's MLA: 128 + 64 rotary dims of q and k, v
// zero-padded from 128 by the caller and the output cut back), bf16 and
// without dropout only: the same kernel instantiated at HD = 192, its q
// fragments and output accumulators three times as wide, one block of 8
// warps per SM (up to 255 registers a thread) and K/V chunks of 128 keys
// (153 KB of shared memory with the q rows). At L = 200 it moves ~26 FLOP
// per byte and is bound by bytes too; the width-64 instantiation is the
// code it was before the head width became a template parameter.
//
// Numerics, both designs, as the Pallas kernels: fp32 logits, max and
// sum; the unnormalised probability p is rounded to the input dtype
// before p.v, which accumulates in fp32; the division by the sum comes
// last. The max is a running one over the key tiles, so p is rounded at
// that max (the plain version rounds at the row's global max).
//
// Training adds two optional operands. Attention-prob dropout (the learn
// step's attn_dropout; the JAX package leaves its kernel for XLA whenever
// dropout is on, etpnav_tpu/ops/attention.py:103,135,166): the rounded p
// of a dropped (q, k) is zeroed and a kept one scaled by 1/keep (fp32:
// before p.v; bf16: the sum of kept p.v times 1/keep, in the epilogue),
// while the sum in the denominator keeps every key, so
// ctx = sum_k m_k/keep * round(p_k) v_k / sum_k p_k, which is
// dropout(softmax(s)) . v. The keep bit m is Philox4x32-10 of the logical
// (b, h, q, k) (philox.cuh), so both layouts and the backward kernel draw
// the same mask. And the fp32 row log-sum-exp (B, H, Lq), which the
// backward (attention_bwd.cu) reads to rebuild the probabilities. A launch
// with the lse and without dropout runs the serving launch's arithmetic
// and only adds the lse store.
//
// K-ATT-CHEAP is the CHEAP = true instantiation of the bf16 kernel, behind
// its own entry point etp_attention_cheap (bf16 only). It replaces
// cheap_attention (tools/exp_attn_pack.py:86, kernel_cheap :49-84), a TPU
// experiment: bf16 logits and a constant-shift softmax with no max pass,
// logits = bf16(sum q.k), x bf16(scale), - bf16(10), p = bf16(exp(.)),
// denom and ctx fp32 sums, out = bf16(ctx / denom). Only the softmax stage
// differs from K-ATT (the tiles, the layouts, the p.v product and the
// final division are the same), so it is a template switch here: with no
// running max there is nothing to rescale. Its `pack` option filled the
// TPU's 128x128 matrix unit with two samples and has no counterpart here.
// What bounds it is what bounds K-ATT, the bytes of q, k, v and the output.

#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tc.cuh"
#include "philox.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long b, h, l;                       // element strides; hd stride is 1
};

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

// max and sum over the 4 lanes (tig) that hold one accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kTileK = 32;                 // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;

// grid: (B*H, ceil(Lq / kRowsPerBlock)); block: kWarps warps. Warp w owns
// query rows w*kRowsPerWarp .. +kRowsPerWarp-1 of the block's tile; in a
// key tile, lane j scores key j, then the warp accumulates p.v with each
// lane owning hd/32 output dims.
template <int HD, bool DROP>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ bias,
                         float* __restrict__ out, int H, int Lq, int Lk,
                         Strides sq, Strides sk, Strides sv, Strides so,
                         long long sbb, long long sbq, long long sbk,
                         float scale,
                         const long long* __restrict__ seed_offset,
                         uint32_t threshold, float inv_keep, int heads_total,
                         int head_base, float* __restrict__ lse) {
  constexpr int kDimsPerLane = HD / 32;
  __shared__ float qs[kRowsPerBlock][HD];
  __shared__ float ks[kTileK][HD + 1];     // +1: lane j reads row j
  __shared__ float vs[kTileK][HD];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = blockIdx.y * kRowsPerBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* biasb = bias ? bias + b * sbb : nullptr;
  etp::DropoutParams dp{};
  if constexpr (DROP)
    dp = etp::load_dropout(seed_offset, threshold, inv_keep, H, heads_total,
                           head_base);

  for (int i = threadIdx.x; i < kRowsPerBlock * HD; i += blockDim.x) {
    const int r = i / HD, d = i % HD, qi = q0 + r;
    qs[r][d] = qi < Lq ? qb[qi * sq.l + d] : 0.f;
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
      ks[j][d] = in ? kb[kj * sk.l + d] : 0.f;
      vs[j][d] = in ? vb[kj * sv.l + d] : 0.f;
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
      s *= scale;
      if (valid && biasb) s += biasb[qi * sbq + kj * sbk];
      s = valid ? s : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(s));
      // all logits so far -inf (only with a -inf bias): shift by 0
      const float shift = m_new == -INFINITY ? 0.f : m_new;
      const float p = valid ? expf(s - shift) : 0.f;
      const float corr = expf(m[r] - shift);
      l[r] = l[r] * corr + warp_sum(p);
      float p_in = p;
      if constexpr (DROP) {
        if (valid)
          p_in = etp::dropout_keep(dp, blockIdx.x, qi, kj) ? p * dp.inv_keep
                                                           : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] *= corr;
      m[r] = m_new;
#pragma unroll 8
      for (int j = 0; j < kTileK; ++j) {
        const float pj = __shfl_sync(kFull, p_in, j);
#pragma unroll
        for (int i = 0; i < kDimsPerLane; ++i)
          acc[r][i] = fmaf(pj, vs[j][lane + 32 * i], acc[r][i]);
      }
    }
  }

  float* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp * kRowsPerWarp + r;
    if (qi >= Lq) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i)
      ob[qi * so.l + lane + 32 * i] = acc[r][i] * inv;
    // l is the sum at the final max m (or 0 when every logit is -inf,
    // whose probabilities the backward then takes as 0)
    if (lse && lane == 0)
      lse[static_cast<long long>(blockIdx.x) * Lq + qi] =
          l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync.m16n8k16, fp32 accumulate)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 8;                // 16 query rows each
constexpr int kTcRows = 16 * kTcWarps;     // query rows per block
constexpr int kTcGroup = 64;               // keys per online-softmax step

// Keys in shared memory at once: 256 at hd = 64; 128 at hd = 192, whose
// rows take three times the bytes (153 KB with a block's q rows, one
// block per SM).
__host__ __device__ constexpr int tc_max_chunk(int hd) {
  return hd == 64 ? 256 : 128;
}

// Dynamic shared memory: the block's q rows (16 per warp), then a chunk of
// K and of V, each row at a pitch of hd + 8 elements (etp::kTcPitch at 64).
__host__ __device__ constexpr int tc_smem_bytes(int warps, int chunk,
                                                int hd) {
  return (16 * warps + 2 * chunk) * (hd + 8) * 2;
}

// grid: (B*H, ceil(Lq / 128)); block: min(8, ceil(Lq / 16)) warps; chunk:
// the keys copied to shared memory at once (Lk rounded up to 16, at most
// tc_max_chunk(HD), a multiple of kTcGroup). Warp w owns query rows q0 +
// 16 w .. + 15; per group of 64 keys it holds S in 8 m16n8 accumulators,
// the output in HD / 8 more, and per fragment row the running max and a
// partial sum of its lanes' keys. CHEAP: K-ATT-CHEAP's constant-shift
// softmax in place of the online one (no bias, no dropout, no lse).
// HD = 64 is every ETPNav head; HD = 192 is MLA's (qk 128 + 64 rope, v
// zero-padded to 192 by the caller), whose q fragments (48 registers)
// and output accumulators (96) take one block of 8 warps per SM with up
// to 255 registers a thread, where hd = 64 runs two.
template <int HD, bool DROP, bool CHEAP>
__global__ void __launch_bounds__(kTcWarps * 32, HD == 64 ? 2 : 1)
attention_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ bias, bf16* __restrict__ out,
                        int H, int Lq, int Lk, int chunk, Strides sq,
                        Strides sk, Strides sv, Strides so, long long sbb,
                        long long sbq, long long sbk, float scale,
                        const long long* __restrict__ seed_offset,
                        uint32_t threshold, float inv_keep, int heads_total,
                        int head_base, float* __restrict__ lse) {
  constexpr int kPitch = HD + 8;          // etp::kTcPitch at HD = 64
  constexpr int kRowChunks = HD / 8;      // 16-byte chunks of a row
  constexpr int kKs = HD / 16;            // k steps of Q.K^T, n16 of P.V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nthreads = blockDim.x;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);        // [16 warps][pitch]
  bf16* ks = qs + nthreads / 32 * 16 * kPitch;         // [chunk][pitch]
  bf16* vs = ks + chunk * kPitch;                      // [chunk][pitch]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kTcRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const float* biasb = bias ? bias + b * sbb : nullptr;
  etp::DropoutParams dp{};
  if constexpr (DROP)
    dp = etp::load_dropout(seed_offset, threshold, inv_keep, H, heads_total,
                           head_base);
  [[maybe_unused]] const float scale_bf16 = round_bf16(scale);

  // the block's q rows (16 per warp; rows past Lq are zeros)
  for (int c = threadIdx.x; c < nthreads / 32 * 16 * kRowChunks;
       c += nthreads) {
    const int r = c / kRowChunks, ch = c % kRowChunks, qi = q0 + r;
    bf16* dst = qs + r * kPitch + ch * 8;
    if (qi < Lq)
      etp::cp_async16(dst, qb + qi * sq.l + ch * 8);
    else
      etp::zero16(dst);
  }

  const int row0 = q0 + warp * 16 + grp;               // rows row0, row0+8
  const bool active = q0 + warp * 16 < Lq;             // uniform per warp
  uint32_t qf[kKs][4];                                 // A: 16 rows x HD
  float acc[2 * kKs][4];                               // out: 16 x HD
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2 * kKs; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int c0 = 0; c0 < Lk; c0 += chunk) {
    const int n16 = min(chunk, (Lk - c0 + 15) & ~15);  // keys in smem
    if (c0) __syncthreads();                           // chunk consumed
    for (int c = threadIdx.x; c < n16 * kRowChunks; c += nthreads) {
      const int r = c / kRowChunks, ch = c % kRowChunks, kj = c0 + r;
      bf16* kd = ks + r * kPitch + ch * 8;
      bf16* vd = vs + r * kPitch + ch * 8;
      if (kj < Lk) {
        etp::cp_async16(kd, kb + kj * sk.l + ch * 8);
        etp::cp_async16(vd, vb + kj * sv.l + ch * 8);
      } else {                                         // zeros, not NaNs
        etp::zero16(kd);
        etp::zero16(vd);
      }
    }
    etp::cp_async_wait_all();
    __syncthreads();
    if (!active) continue;
    if (c0 == 0) {
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk)
        etp::load_a(qf[kk], qs, kPitch, warp * 16, kk * 16, lane);
    }

    for (int g = 0; g < n16; g += kTcGroup) {
      const int steps = min(4, (n16 - g) / 16);        // 16-key steps
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t < steps) {
#pragma unroll
          for (int kk = 0; kk < kKs; ++kk) {
            uint32_t bf[4];
            etp::load_b_nt(bf, ks, kPitch, g + 16 * t, kk * 16, lane);
            etp::mma_bf16(s[2 * t], qf[kk], bf);
            etp::mma_bf16(s[2 * t + 1], qf[kk], bf + 2);
          }
        }
      }

      // softmax stage on the fragments: element (j, e) is row row0 + 8
      // (e / 2), key c0 + g + 8 j + 2 tig + e % 2
      float corr[2] = {1.f, 1.f};
      if constexpr (CHEAP) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = c0 + g + 8 * j + 2 * tig + (e & 1);
            const float t =
                round_bf16(round_bf16(round_bf16(s[j][e]) * scale_bf16) -
                           10.f);
            const float p = kj < Lk ? round_bf16(expf(t)) : 0.f;
            l[e / 2] += p;
            s[j][e] = p;
          }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= scale;
        if (biasb) {                       // clamped: no branch per load
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kj = min(c0 + g + 8 * j + 2 * tig + (e & 1), Lk - 1);
              const int qi = min(row0 + 8 * (e / 2), Lq - 1);
              s[j][e] += biasb[qi * sbq + kj * sbk];
            }
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = c0 + g + 8 * j + 2 * tig + (e & 1);
            if (kj >= Lk) s[j][e] = -INFINITY;
            mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
          }
        float shift[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float m_new = fmaxf(m[i], quad_max(mx[i]));
          // all logits so far -inf (only with a -inf bias): shift by 0
          shift[i] = m_new == -INFINITY ? 0.f : m_new;
          corr[i] = expf(m[i] - shift[i]);
          m[i] = m_new;
          l[i] *= corr[i];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          bool keep[4] = {true, true, true, true};
          if constexpr (DROP)
            if (g + 8 * j < n16)           // uniform: a tile with keys
              etp::dropout_keep_tile(dp, bh, row0, c0 + g + 8 * j, tig,
                                     keep);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = expf(s[j][e] - shift[e / 2]);  // 0 at -inf
            l[e / 2] += p;
            s[j][e] = keep[e] ? p : 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < 2 * kKs; ++j) {
          acc[j][0] *= corr[0];
          acc[j][1] *= corr[0];
          acc[j][2] *= corr[1];
          acc[j][3] *= corr[1];
        }
      }

      // P.V: p rounded to bf16 (the rounding point of p) as the A operand
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t < steps) {
          uint32_t pa[4];
          etp::acc_to_a(pa, s[2 * t], s[2 * t + 1]);
#pragma unroll
          for (int dp2 = 0; dp2 < kKs; ++dp2) {
            uint32_t bf[4];
            etp::load_b_nn(bf, vs, kPitch, g + 16 * t, dp2 * 16, lane);
            etp::mma_bf16(acc[2 * dp2], pa, bf);
            etp::mma_bf16(acc[2 * dp2 + 1], pa, bf + 2);
          }
        }
      }
    }
  }

  if (!active) return;                                 // no later barrier
  // epilogue: the row sums over the quad, the division last, bf16 rows
  // staged in the warp's q rows and written with 16-byte stores
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    inv[i] = 1.f / l[i];
  }
  bf16* stage = qs + warp * 16 * kPitch;
#pragma unroll
  for (int j = 0; j < 2 * kKs; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x0 = acc[j][2 * i], x1 = acc[j][2 * i + 1];
      if constexpr (DROP) {
        x0 *= dp.inv_keep;
        x1 *= dp.inv_keep;
      }
      *reinterpret_cast<__nv_bfloat162*>(
          stage + (grp + 8 * i) * kPitch + 8 * j + 2 * tig) =
          __floats2bfloat162_rn(x0 * inv[i], x1 * inv[i]);
    }
  __syncwarp();
  bf16* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int c = lane; c < 16 * kRowChunks; c += 32) {
    const int r = c / kRowChunks, ch = c % kRowChunks,
              qi = q0 + warp * 16 + r;
    if (qi < Lq)
      *reinterpret_cast<uint4*>(ob + qi * so.l + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + r * kPitch + ch * 8);
  }
  // l is the sum at the final max m (or 0 when every logit is -inf,
  // whose probabilities the backward then takes as 0)
  if (lse && tig == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = row0 + 8 * i;
      if (qi < Lq)
        lse[static_cast<long long>(bh) * Lq + qi] =
            l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    }
  }
}

template <int HD, bool DROP, bool CHEAP>
int launch_tc(const void* q, const void* k, const void* v, const float* bias,
              void* out, int B, int H, int Lq, int Lk, Strides sq,
              Strides sk, Strides sv, Strides so, long long sbb,
              long long sbq, long long sbk, float scale,
              const long long* seed_offset, uint32_t threshold,
              float inv_keep, int heads_total, int head_base, float* lse,
              cudaStream_t stream) {
  if (!etp::rows16(q, sq, B, H, Lq) || !etp::rows16(k, sk, B, H, Lk) ||
      !etp::rows16(v, sv, B, H, Lk) || !etp::rows16(out, so, B, H, Lq))
    return etp::kErrMisaligned;
  const int chunk = std::min(tc_max_chunk(HD), (Lk + 15) / 16 * 16);
  const int warps = std::min(kTcWarps, (Lq + 15) / 16);
  const int bytes = tc_smem_bytes(warps, chunk, HD);
  auto kernel = attention_fwd_tc_kernel<HD, DROP, CHEAP>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * H, (Lq + kTcRows - 1) / kTcRows);
  kernel<<<grid, warps * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bias, static_cast<bf16*>(out), H, Lq, Lk,
      chunk, sq, sk, sv, so, sbb, sbq, sbk, scale, seed_offset, threshold,
      inv_keep, heads_total, head_base, lse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. bias may be null (no bias).
// seed_offset: null (no dropout) or device int64[2] {seed, offset}; a
// probability is kept iff its Philox word is below `threshold`, and then
// scaled by inv_keep. heads_total, head_base: the layer's heads and the
// first of them these H are (H and 0 unless the heads are split over
// ranks; philox.cuh). lse: null, or a contiguous fp32 (B, H, Lq) output.
// Returns cudaGetLastError() after the launch, -1 for a head dim or
// dtype the kernel does not take (hd = 64, the width of ETPNav's heads,
// in both dtypes; hd = 192, MLA's, in bf16 without dropout), or
// etp::kErrMisaligned for a bf16 q, k, v or out without 16-byte rows
// (etp::rows16).
int etp_attention_fwd(const void* q, const void* k, const void* v,
                      const void* bias, void* out, int dtype, int B, int H,
                      int Lq, int Lk, int hd, long long sqb, long long sqh,
                      long long sql, long long skb, long long skh,
                      long long skl, long long svb, long long svh,
                      long long svl, long long sob, long long soh,
                      long long sol, long long sbb, long long sbq,
                      long long sbk, float scale, const void* seed_offset,
                      unsigned threshold, float inv_keep, int heads_total,
                      int head_base, void* lse, void* stream) {
  const Strides sq{sqb, sqh, sql}, sk{skb, skh, skl}, sv{svb, svh, svl},
      so{sob, soh, sol};
  const float* bp = static_cast<const float*>(bias);
  const long long* sp = static_cast<const long long*>(seed_offset);
  float* lp = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 192 && dtype == 1 && !sp)
    return launch_tc<192, false, false>(q, k, v, bp, out, B, H, Lq, Lk, sq,
                                        sk, sv, so, sbb, sbq, sbk, scale,
                                        nullptr, 0u, 1.f, H, 0, lp, st);
  if (hd != 64) return -1;
  if (dtype == 1)
    return sp ? launch_tc<64, true, false>(q, k, v, bp, out, B, H, Lq, Lk,
                                           sq, sk, sv, so, sbb, sbq, sbk,
                                           scale, sp, threshold, inv_keep,
                                           heads_total, head_base, lp, st)
              : launch_tc<64, false, false>(q, k, v, bp, out, B, H, Lq, Lk,
                                            sq, sk, sv, so, sbb, sbq, sbk,
                                            scale, nullptr, 0u, 1.f, H, 0,
                                            lp, st);
  if (dtype != 0) return -1;
  const dim3 grid(B * H, (Lq + kRowsPerBlock - 1) / kRowsPerBlock);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  if (sp)
    attention_fwd_f32_kernel<64, true><<<grid, kWarps * 32, 0, st>>>(
        qf, kf, vf, bp, of, H, Lq, Lk, sq, sk, sv, so, sbb, sbq, sbk, scale,
        sp, threshold, inv_keep, heads_total, head_base, lp);
  else
    attention_fwd_f32_kernel<64, false><<<grid, kWarps * 32, 0, st>>>(
        qf, kf, vf, bp, of, H, Lq, Lk, sq, sk, sv, so, sbb, sbq, sbk, scale,
        nullptr, 0u, 1.f, H, 0, lp);
  return static_cast<int>(cudaGetLastError());
}

// K-ATT-CHEAP: bfloat16 q, k, v and out with the same element strides
// and alignment as etp_attention_fwd, no bias. Returns cudaGetLastError()
// after the launch, -1 for a head dim other than 64, or
// etp::kErrMisaligned as etp_attention_fwd does.
int etp_attention_cheap(const void* q, const void* k, const void* v,
                        void* out, int B, int H, int Lq, int Lk, int hd,
                        long long sqb, long long sqh, long long sql,
                        long long skb, long long skh, long long skl,
                        long long svb, long long svh, long long svl,
                        long long sob, long long soh, long long sol,
                        float scale, void* stream) {
  if (hd != 64) return -1;
  return launch_tc<64, false, true>(
      q, k, v, nullptr, out, B, H, Lq, Lk, Strides{sqb, sqh, sql},
      Strides{skb, skh, skl}, Strides{svb, svh, svl}, Strides{sob, soh, sol},
      0, 0, 0, scale, nullptr, 0u, 1.f, H, 0, nullptr,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
