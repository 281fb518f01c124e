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
// H100's ridge, so it is bound by the bytes it moves. Two designs:
//
// bf16 (every bf16 launch): tensor cores. One block per (b, h) of up to 8
// warps. K and V of the head are copied once into shared memory as bf16
// with 16-byte cp.async, then the queries in chunks of 16 rows per warp
// with their dO. Per chunk, warp w takes 16 query rows: S = Q.K^T and
// dP = dO.V^T on mma.sync, P, the keep bits and dS in fp32 fragments, dQ
// += dS.K on mma.sync with dS rounded to bf16 as the A operand, and P o M
// (the kept P, M the 0/1 keep bit) and dS stored to shared memory as
// bf16. Then the warps split the keys, 16 each: dV += (P o M)^T . dO and
// dK += dS^T . Q on mma.sync from transposed ldmatrix loads of those
// tiles, in fp32 registers written once at the end (dV times 1/keep). No
// shared-memory read-modify-write and no atomics: every sum has one
// owner, so the result does not depend on scheduling. D is computed from
// 16-byte loads of dO and O, so q, k, v, O and dO need a 16-byte-aligned
// base and strides (the entry point checks).
//
// fp32: CUDA cores with fp32 FMAs (TF32 tensor cores would break the
// fp32 tolerances): per query tile of 16 rows, keys in tiles of 32 (lane
// j = key j), dK and dV summed in fp32 in shared memory.
//
// Rounding points, bf16: the products on tensor cores take P o M and dS
// rounded to bf16 (the plain version rounds at the same points); XLA's
// VJP of the reference (_attention_xla) also rounds p to bf16 before its
// dV product. dP, P, D, dS and d(bias) stay fp32: d(bias) is held to
// fp32 tolerances and takes dS unrounded.
//
// d(bias), both designs, with no per-head scratch in device memory: the
// heads of one sample run as one thread-block cluster of C blocks (C = 4
// for 12 heads), block r taking heads r H/C .. (r+1) H/C - 1 in order and
// adding their dS into an fp32 (Lq, Lk) sum in its shared memory. After
// cluster.sync() block r sums rows r Lq/C .. of the C partial sums, in
// rank order, over the cluster's distributed shared memory and writes
// d(bias) once: deterministic, in a fixed order. Launches without d(bias)
// run one block per (b, h), no cluster.

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tc.cuh"
#include "philox.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemMax = 232448;           // bytes a block may use (227 KB)

struct Strides {
  long long b, h, l;                       // element strides; hd stride is 1
};

struct Grads {
  void* dq;
  void* dk;
  void* dv;
  float* dbias;                            // (B, Lq, Lk) or null
  Strides sdq, sdk, sdv;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Blocks per cluster (heads of one sample) for a d(bias) launch: 4 when H
// allows, else 3, 2 or 1; each block takes H / C heads in order.
int dbias_cluster(int H) {
  for (int c = 4; c > 1; --c)
    if (H % c == 0) return c;
  return 1;
}

// d(bias)[b] from the cluster's partial head sums dbs[Lq][Lk] (fp32, in
// each block's shared memory): block r sums its share of the rows over
// the blocks in rank order and writes them.
__device__ void cluster_head_sum(float* dbs, float* dbias_b, int Lq, int Lk) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                          // every partial sum complete
  const int n = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int rows = (Lq + n - 1) / n;
  const int e0 = min(Lq, r * rows) * Lk, e1 = min(Lq, (r + 1) * rows) * Lk;
  for (int i = e0 + threadIdx.x; i < e1; i += blockDim.x) {
    float acc = 0.f;
    for (int rr = 0; rr < n; ++rr) acc += cluster.map_shared_rank(dbs, rr)[i];
    dbias_b[i] = acc;
  }
  cluster.sync();                          // no block leaves while read
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kTileK = 32;                 // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;

// Dynamic shared memory of one block, in floats: dK and dV sums for every
// key (Lk rounded up to the tile), one K and one V tile (+1 pad: lane j
// reads row j), the query tile's q and dO, and the tile's P*Z and dS;
// then, for d(bias), the (Lq, Lk) partial head sum.
__host__ __device__ constexpr long long f32_smem_floats(int lk_pad, int hd) {
  return 2LL * lk_pad * hd + 2LL * kTileK * (hd + 1) +
         2LL * kRowsPerBlock * hd + 2LL * kRowsPerBlock * kTileK;
}

// grid: B * (H / hpb) blocks of kThreads, hpb heads each (a cluster per
// sample when d(bias) is asked). Per query tile of 16 rows: warp w owns
// rows w*4 .. w*4+3 for the scores (lane j = key j of the key tile); for
// the products, thread t owns (key, dim) pairs e = t + 128 i of the tile
// (dV, dK) and (row, dim) pairs (dQ), so each sum has one owner.
template <int HD, bool DROP>
__global__ void __launch_bounds__(kThreads)
attention_bwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ bias,
                         const float* __restrict__ o,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse, Grads g, int H,
                         int hpb, int Lq, int Lk, Strides sq, Strides sk,
                         Strides sv, Strides so, Strides sdo, long long sbb,
                         long long sbq, long long sbk, float scale,
                         const long long* __restrict__ seed_offset,
                         uint32_t threshold, float inv_keep,
                         int heads_total, int head_base) {
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
  float* dbs = g.dbias ? dss + kRowsPerBlock * kTileK : nullptr;  // [Lq][Lk]
  __shared__ float row_d[kRowsPerBlock], row_lse[kRowsPerBlock];

  const int nblk = H / hpb;
  const int b = blockIdx.x / nblk, rank = blockIdx.x % nblk;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;
  etp::DropoutParams dp{};
  if constexpr (DROP)
    dp = etp::load_dropout(seed_offset, threshold, inv_keep, H, heads_total,
                           head_base);
  if (dbs)
    for (int i = t; i < Lq * Lk; i += kThreads) dbs[i] = 0.f;

  constexpr int kDqPerThread = kRowsPerBlock * HD / kThreads;
  constexpr int kKdPerThread = kTileK * HD / kThreads;
  for (int hh = 0; hh < hpb; ++hh) {
    const int h = rank * hpb + hh, bh = b * H + h;
    const float* qb = q + b * sq.b + h * sq.h;
    const float* kb = k + b * sk.b + h * sk.h;
    const float* vb = v + b * sv.b + h * sv.h;
    const float* ob = o + b * so.b + h * so.h;
    const float* dob = dout + b * sdo.b + h * sdo.h;
    const float* biasb = bias ? bias + b * sbb : nullptr;
    const float* lseb = lse + static_cast<long long>(bh) * Lq;
    __syncthreads();                       // the previous head's sums read
    for (int i = t; i < lk_pad * HD; i += kThreads) dks[i] = dvs[i] = 0.f;

    for (int q0 = 0; q0 < Lq; q0 += kRowsPerBlock) {
      __syncthreads();                     // previous query tile consumed
      for (int i = t; i < kRowsPerBlock * HD; i += kThreads) {
        const int r = i / HD, d = i % HD, qi = q0 + r;
        const bool in = qi < Lq;
        qs[i] = in ? qb[qi * sq.l + d] : 0.f;
        dos[i] = in ? dob[qi * sdo.l + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int row = warp * kRowsPerWarp + r;
        const int qi = q0 + row;
        float part = 0.f;
        if (qi < Lq) {
          for (int d = lane; d < HD; d += 32)
            part += dob[qi * sdo.l + d] * ob[qi * so.l + d];
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
          ks[j * (HD + 1) + d] = in ? kb[kj * sk.l + d] : 0.f;
          vs[j * (HD + 1) + d] = in ? vb[kj * sv.l + d] : 0.f;
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
          if (dbs && valid) dbs[qi * Lk + kj] += ds;
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

      float* dqb = static_cast<float*>(g.dq) + b * g.sdq.b + h * g.sdq.h;
#pragma unroll
      for (int i = 0; i < kDqPerThread; ++i) {
        const int e = t + kThreads * i;
        const int r = e / HD, d = e % HD, qi = q0 + r;
        if (qi < Lq) dqb[qi * g.sdq.l + d] = dq_acc[i] * scale;
      }
    }
    __syncthreads();

    float* dkb = static_cast<float*>(g.dk) + b * g.sdk.b + h * g.sdk.h;
    float* dvb = static_cast<float*>(g.dv) + b * g.sdv.b + h * g.sdv.h;
    for (int i = t; i < Lk * HD; i += kThreads) {
      const int j = i / HD, d = i % HD;
      dkb[j * g.sdk.l + d] = dks[i] * scale;
      dvb[j * g.sdv.l + d] = dvs[i];
    }
  }
  if (dbs)
    cluster_head_sum(dbs, g.dbias + static_cast<long long>(b) * Lq * Lk, Lq,
                     Lk);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync.m16n8k16, fp32 accumulate)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using etp::kTcPitch;

constexpr int kTcMaxWarps = 8;
constexpr int kTcMaxKt = 2;                // key tiles of 16 per warp

struct TcShape {
  int warps, kt;
  long long bytes;
};

// Warps (16 query rows each per chunk, then 16 keys each), key tiles per
// warp and dynamic shared memory of a launch: K and V of the head, the
// chunk's q and dO (pitch 72), its P o M and dS tiles (pitch Lk16 + 8),
// and for d(bias) the (Lq, Lk) fp32 partial head sum.
TcShape tc_shape(int Lq, int Lk, bool dbias) {
  const int lk16 = (Lk + 15) / 16 * 16;
  const int warps =
      std::min(kTcMaxWarps, std::max((Lq + 15) / 16, lk16 / 16));
  const int rows = 16 * warps;
  const long long bytes = (2LL * lk16 + 2LL * rows) * kTcPitch * 2 +
                          2LL * rows * (lk16 + 8) * 2 +
                          (dbias ? 4LL * Lq * Lk : 0);
  return {warps, (lk16 / 16 + warps - 1) / warps, bytes};
}

template <bool DROP, int KT>
__global__ void __launch_bounds__(kTcMaxWarps * 32)
attention_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ bias,
                        const bf16* __restrict__ o,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse, Grads g, int H,
                        int hpb, int Lq, int Lk, Strides sq, Strides sk,
                        Strides sv, Strides so, Strides sdo, long long sbb,
                        long long sbq, long long sbk, float scale,
                        const long long* __restrict__ seed_offset,
                        uint32_t threshold, float inv_keep,
                         int heads_total, int head_base) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nw = blockDim.x / 32;
  const int rows = 16 * nw;                            // query rows / chunk
  const int lk16 = (Lk + 15) & ~15;
  const int pp = lk16 + 8;                             // P, dS tile pitch
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);        // [lk16][72]
  bf16* vs = ks + lk16 * kTcPitch;                     // [lk16][72]
  bf16* qs = vs + lk16 * kTcPitch;                     // [rows][72]
  bf16* dos = qs + rows * kTcPitch;                    // [rows][72]
  bf16* pzs = dos + rows * kTcPitch;                   // [rows][pp]
  bf16* dss = pzs + rows * pp;                         // [rows][pp]
  float* dbs = g.dbias ? reinterpret_cast<float*>(dss + rows * pp)
                       : nullptr;                      // [Lq][Lk]

  const int nblk = H / hpb;
  const int b = blockIdx.x / nblk, rank = blockIdx.x % nblk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;
  etp::DropoutParams dp{};
  if constexpr (DROP)
    dp = etp::load_dropout(seed_offset, threshold, inv_keep, H, heads_total,
                           head_base);
  if (dbs)
    for (int i = threadIdx.x; i < Lq * Lk; i += blockDim.x) dbs[i] = 0.f;

  for (int hh = 0; hh < hpb; ++hh) {
    const int h = rank * hpb + hh, bh = b * H + h;
    const bf16* qb = q + b * sq.b + h * sq.h;
    const bf16* kb = k + b * sk.b + h * sk.h;
    const bf16* vb = v + b * sv.b + h * sv.h;
    const bf16* ob = o + b * so.b + h * so.h;
    const bf16* dob = dout + b * sdo.b + h * sdo.h;
    const float* biasb = bias ? bias + b * sbb : nullptr;
    const float* lseb = lse + static_cast<long long>(bh) * Lq;
    bf16* dqb = static_cast<bf16*>(g.dq) + b * g.sdq.b + h * g.sdq.h;

    if (hh) __syncthreads();               // the previous head's tiles read
    for (int c = threadIdx.x; c < lk16 * 8; c += blockDim.x) {
      const int r = c / 8, ch = c % 8;
      bf16* kd = ks + r * kTcPitch + ch * 8;
      bf16* vd = vs + r * kTcPitch + ch * 8;
      if (r < Lk) {
        etp::cp_async16(kd, kb + r * sk.l + ch * 8);
        etp::cp_async16(vd, vb + r * sv.l + ch * 8);
      } else {                             // zeros, not NaNs
        etp::zero16(kd);
        etp::zero16(vd);
      }
    }

    float dk[KT][8][4], dv[KT][8][4];
#pragma unroll
    for (int i = 0; i < KT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[i][j][e] = dv[i][j][e] = 0.f;

    for (int qc0 = 0; qc0 < Lq; qc0 += rows) {
      if (qc0) __syncthreads();            // the previous chunk's tiles read
      for (int c = threadIdx.x; c < rows * 8; c += blockDim.x) {
        const int r = c / 8, ch = c % 8, qi = qc0 + r;
        bf16* qd = qs + r * kTcPitch + ch * 8;
        bf16* dd = dos + r * kTcPitch + ch * 8;
        if (qi < Lq) {
          etp::cp_async16(qd, qb + qi * sq.l + ch * 8);
          etp::cp_async16(dd, dob + qi * sdo.l + ch * 8);
        } else {
          etp::zero16(qd);
          etp::zero16(dd);
        }
      }
      etp::cp_async_wait_all();
      __syncthreads();

      // phase 1: warp w, query rows r0 .. r0+15 of the chunk, every key
      const int r0 = warp * 16;
      if (qc0 + r0 < Lq) {
        // D of row r0 + lane / 2 from 16-byte loads (each lane half a row)
        float dpart = 0.f;
        {
          const int qi = qc0 + r0 + lane / 2;
          if (qi < Lq) {
            const uint4* a =
                reinterpret_cast<const uint4*>(dob + qi * sdo.l) + lane % 2 * 4;
            const uint4* c =
                reinterpret_cast<const uint4*>(ob + qi * so.l) + lane % 2 * 4;
#pragma unroll
            for (int ch = 0; ch < 4; ++ch) {
              const uint4 x = a[ch], y = c[ch];
              const __nv_bfloat162* xa =
                  reinterpret_cast<const __nv_bfloat162*>(&x);
              const __nv_bfloat162* ya =
                  reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 fx = __bfloat1622float2(xa[e]);
                const float2 fy = __bfloat1622float2(ya[e]);
                dpart = fmaf(fx.x, fy.x, dpart);
                dpart = fmaf(fx.y, fy.y, dpart);
              }
            }
          }
          dpart += __shfl_xor_sync(kFull, dpart, 1);
        }
        float row_d[2], row_lse[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          row_d[i] = __shfl_sync(kFull, dpart, 2 * (grp + 8 * i));
          const int qi = qc0 + r0 + grp + 8 * i;
          row_lse[i] = qi < Lq ? lseb[qi] : INFINITY;
        }

        float dq[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
        for (int k0 = 0; k0 < lk16; k0 += 16) {
          float s[2][4] = {}, dpv[2][4] = {};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            uint32_t qa[4], da[4], kf[4], vf[4];
            etp::load_a(qa, qs, kTcPitch, r0, kk * 16, lane);
            etp::load_a(da, dos, kTcPitch, r0, kk * 16, lane);
            etp::load_b_nt(kf, ks, kTcPitch, k0, kk * 16, lane);
            etp::load_b_nt(vf, vs, kTcPitch, k0, kk * 16, lane);
            etp::mma_bf16(s[0], qa, kf);
            etp::mma_bf16(s[1], qa, kf + 2);
            etp::mma_bf16(dpv[0], da, vf);
            etp::mma_bf16(dpv[1], da, vf + 2);
          }
          // element (j, e): row qc0 + r0 + grp + 8 (e / 2), key k0 + 8 j
          // + 2 tig + e % 2; s becomes P o M, dpv becomes dS
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] *= scale;
          if (biasb) {                     // clamped: no branch per load
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int kj = min(k0 + 8 * j + 2 * tig + (e & 1), Lk - 1);
                const int qi = min(qc0 + r0 + grp + 8 * (e / 2), Lq - 1);
                s[j][e] += biasb[qi * sbq + kj * sbk];
              }
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            bool keep[4] = {true, true, true, true};
            if constexpr (DROP)
              etp::dropout_keep_tile(dp, bh, qc0 + r0 + grp, k0 + 8 * j, tig,
                                     keep);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kj = k0 + 8 * j + 2 * tig + (e & 1);
              const int qi = qc0 + r0 + grp + 8 * (e / 2);
              const bool valid = qi < Lq && kj < Lk;
              const float p = valid ? expf(s[j][e] - row_lse[e / 2]) : 0.f;
              const float z = DROP ? (keep[e] ? dp.inv_keep : 0.f) : 1.f;
              const float ds = p * (dpv[j][e] * z - row_d[e / 2]);
              if (dbs && valid) dbs[qi * Lk + kj] += ds;
              s[j][e] = z != 0.f ? p : 0.f;
              dpv[j][e] = ds;
            }
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int at = (r0 + grp + 8 * i) * pp + k0 + 8 * j + 2 * tig;
              *reinterpret_cast<uint32_t*>(pzs + at) =
                  etp::pack_bf16(s[j][2 * i], s[j][2 * i + 1]);
              *reinterpret_cast<uint32_t*>(dss + at) =
                  etp::pack_bf16(dpv[j][2 * i], dpv[j][2 * i + 1]);
            }
          // dQ += dS . K, dS rounded to bf16 as the A operand
          uint32_t dsa[4];
          etp::acc_to_a(dsa, dpv[0], dpv[1]);
#pragma unroll
          for (int d2 = 0; d2 < 4; ++d2) {
            uint32_t kf[4];
            etp::load_b_nn(kf, ks, kTcPitch, k0, d2 * 16, lane);
            etp::mma_bf16(dq[2 * d2], dsa, kf);
            etp::mma_bf16(dq[2 * d2 + 1], dsa, kf + 2);
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int qi = qc0 + r0 + grp + 8 * i;
            if (qi < Lq)
              *reinterpret_cast<__nv_bfloat162*>(dqb + qi * g.sdq.l + 8 * j +
                                                 2 * tig) =
                  __floats2bfloat162_rn(dq[j][2 * i] * scale,
                                        dq[j][2 * i + 1] * scale);
          }
      }
      __syncthreads();

      // phase 2: warp w owns key tiles w + nw i; the chunk's rows with data
      const int n_rows = min(rows, (Lq - qc0 + 15) & ~15);
#pragma unroll
      for (int i = 0; i < KT; ++i) {
        const int kt = warp + nw * i;
        if (kt * 16 >= lk16) continue;     // uniform per warp
        for (int r = 0; r < n_rows; r += 16) {
          uint32_t pa[4], sa[4];
          etp::load_a_t(pa, pzs, pp, r, kt * 16, lane);
          etp::load_a_t(sa, dss, pp, r, kt * 16, lane);
#pragma unroll
          for (int d2 = 0; d2 < 4; ++d2) {
            uint32_t bd[4], bq[4];
            etp::load_b_nn(bd, dos, kTcPitch, r, d2 * 16, lane);
            etp::load_b_nn(bq, qs, kTcPitch, r, d2 * 16, lane);
            etp::mma_bf16(dv[i][2 * d2], pa, bd);
            etp::mma_bf16(dv[i][2 * d2 + 1], pa, bd + 2);
            etp::mma_bf16(dk[i][2 * d2], sa, bq);
            etp::mma_bf16(dk[i][2 * d2 + 1], sa, bq + 2);
          }
        }
      }
    }

    // dK and dV of the warp's keys, written once
    bf16* dkb = static_cast<bf16*>(g.dk) + b * g.sdk.b + h * g.sdk.h;
    bf16* dvb = static_cast<bf16*>(g.dv) + b * g.sdv.b + h * g.sdv.h;
    const float v_scale = DROP ? dp.inv_keep : 1.f;
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      const int kt = warp + nw * i;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int kj = kt * 16 + grp + 8 * ii;
          if (kj >= Lk) continue;
          const int d = 8 * j + 2 * tig;
          *reinterpret_cast<__nv_bfloat162*>(dkb + kj * g.sdk.l + d) =
              __floats2bfloat162_rn(dk[i][j][2 * ii] * scale,
                                    dk[i][j][2 * ii + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dvb + kj * g.sdv.l + d) =
              __floats2bfloat162_rn(dv[i][j][2 * ii] * v_scale,
                                    dv[i][j][2 * ii + 1] * v_scale);
        }
    }
  }
  if (dbs)
    cluster_head_sum(dbs, g.dbias + static_cast<long long>(b) * Lq * Lk, Lq,
                     Lk);
}

// One launch: with d(bias), B * C blocks in clusters of C (C =
// dbias_cluster(H), H / C heads per block); else B * H blocks of one
// head, no cluster.
template <typename... KArgs, typename... Args>
int launch(void (*kernel)(KArgs...), int B, int H, bool dbias, int threads,
           long long bytes, cudaStream_t stream, Args... args) {
  cudaError_t err;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = dbias ? dbias_cluster(H) : H;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dbias ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest Lk the kernel of `dtype` (0 = float32, 1 = bfloat16) takes at
// head dim 64 for Lq query rows, with or without d(bias): its shared
// memory must fit the 227 KB a block may use, and bf16 holds at most two
// key tiles of 16 per warp. The wrapper checks it before the launch.
int etp_attention_bwd_max_lk(int dtype, int lq, int bias_grad) {
  int lk = 0;
  if (dtype == 0) {
    while (f32_smem_floats((lk + 16 + kTileK - 1) / kTileK * kTileK, 64) *
                   4 +
               (bias_grad ? 4LL * lq * (lk + 16) : 0) + 1024 <=
           kSmemMax)
      lk += 16;
  } else {
    while (lk + 16 <= kTcMaxWarps * kTcMaxKt * 16 &&
           tc_shape(lq, lk + 16, bias_grad != 0).bytes <= kSmemMax)
      lk += 16;
  }
  return lk;
}

// dtype: 0 = float32, 1 = bfloat16. bias may be null; dbias (fp32
// (B, Lq, Lk)) is null unless d(bias) is asked. seed_offset: null (no
// dropout) or the forward's device int64[2] {seed, offset}, with its
// threshold, inv_keep, heads_total and head_base. lse: the forward's contiguous fp32 (B, H, Lq).
// Returns the CUDA error of the launch, -1 for a head dim, dtype or Lk
// the kernel does not take, or etp::kErrMisaligned for a bf16 q, k, v, o
// or dout without 16-byte rows (etp::rows16).
int etp_attention_bwd(const void* q, const void* k, const void* v,
                      const void* bias, const void* o, const void* dout,
                      const void* lse, void* dq, void* dk, void* dv,
                      void* dbias, int dtype, int B, int H, int Lq, int Lk,
                      int hd, const long long* st, float scale,
                      const void* seed_offset, unsigned threshold,
                      float inv_keep, int heads_total, int head_base,
                      void* stream) {
  // st: the element strides (b, h, l) of q, k, v, o, dout, dq, dk, dv,
  // then the bias's (b, q, k): 27 values
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]},
      sdo{st[12], st[13], st[14]};
  const Grads g{dq,
                dk,
                dv,
                static_cast<float*>(dbias),
                {st[15], st[16], st[17]},
                {st[18], st[19], st[20]},
                {st[21], st[22], st[23]}};
  const float* bp = static_cast<const float*>(bias);
  const float* lp = static_cast<const float*>(lse);
  const long long* sp = static_cast<const long long*>(seed_offset);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool db = dbias != nullptr;
  if (hd != 64 || (dtype != 0 && dtype != 1) ||
      Lk > etp_attention_bwd_max_lk(dtype, Lq, db))
    return -1;
  const int hpb = db ? H / dbias_cluster(H) : 1;
  if (dtype == 0) {
    const long long bytes =
        f32_smem_floats((Lk + kTileK - 1) / kTileK * kTileK, 64) * 4 +
        (db ? 4LL * Lq * Lk : 0);
    auto kernel = sp ? attention_bwd_f32_kernel<64, true>
                     : attention_bwd_f32_kernel<64, false>;
    return launch(kernel, B, H, db, kThreads, bytes, s,
                  static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), bp,
                  static_cast<const float*>(o),
                  static_cast<const float*>(dout), lp, g, H, hpb, Lq, Lk, sq,
                  sk, sv, so, sdo, st[24], st[25], st[26], scale, sp,
                  threshold, inv_keep, heads_total, head_base);
  }
  if (!etp::rows16(q, sq, B, H, Lq) || !etp::rows16(k, sk, B, H, Lk) ||
      !etp::rows16(v, sv, B, H, Lk) || !etp::rows16(o, so, B, H, Lq) ||
      !etp::rows16(dout, sdo, B, H, Lq))
    return etp::kErrMisaligned;
  const TcShape sh = tc_shape(Lq, Lk, db);
  auto kernel = sp ? (sh.kt == 1 ? attention_bwd_tc_kernel<true, 1>
                                 : attention_bwd_tc_kernel<true, 2>)
                   : (sh.kt == 1 ? attention_bwd_tc_kernel<false, 1>
                                 : attention_bwd_tc_kernel<false, 2>);
  return launch(kernel, B, H, db, sh.warps * 32, sh.bytes, s,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), bp, static_cast<const bf16*>(o),
                static_cast<const bf16*>(dout), lp, g, H, hpb, Lq, Lk, sq, sk,
                sv, so, sdo, st[24], st[25], st[26], scale, sp, threshold,
                inv_keep, heads_total, head_base);
}

}  // extern "C"
