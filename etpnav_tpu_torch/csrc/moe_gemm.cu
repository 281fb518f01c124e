// K-MOE: the grouped expert products of a mixture-of-experts layer, for
// sm_90a. Built by nvcc into a shared library with a plain C interface
// (etpnav_tpu_torch/ops/cuda_build.py) and called through ctypes from
// etpnav_tpu_torch/ops/moe_gemm.py. It replaces no TPU kernel: the JAX
// package has no expert layer. It was added for DeepSeek-V2's routed
// experts (models/dsv2_text.py), whose layer this process computes for the
// experts it holds.
//
// The caller sorts a layer's token-expert routings by held expert: rows
// offsets[e] .. offsets[e+1]-1 of the (R, K) bf16 row matrix belong to
// expert e. Two launches a layer:
//   etp_moe_gate_up: h[r] = bf16(silu(g) * u), [g, u] = x[r] . [Wg_e; Wu_e]^T
//   etp_moe_down:    y[dest[r]] = row_w[r] * (h[r] . Wd_e^T), fp32
//
// What bounds it: at DeepSeek-V2-Lite's shapes an expert sees about 19
// rows of a 200-token encode (6 routings a token over 64 experts, 16 held
// here), so each product does ~19 multiply-adds per weight element it
// reads: ~19 FLOP per byte, far below the H100's ~295 FLOP/byte ridge.
// The products are bound by the bytes of the held experts' weights (138
// MB a layer in bf16, 41 us at 3.35 TB/s). So the design streams each
// expert's weights once and keeps the tensor cores' work out of the way:
//   - swapped operands: the expert's output features are the wgmma's M
//     side (64 weight rows a consumer warpgroup) and the expert's routing
//     rows its N side (a tile of 64 rows, wgmma m64n64k16), so one pass
//     over a weight tile serves all of an expert's rows (up to 64; more
//     rows take further passes, from L2);
//   - dense.cuh's ring: TMA fills 4 stages of k-slabs of 64 (the two
//     warpgroups' weight rows and the routing rows, 128-byte swizzle), one
//     producer warp keeps them in flight, wgmma consumes them
//     (etp::consume_tile); the grid is persistent, one block per SM;
//   - gate/up: warpgroup 0 takes an expert's gate rows f..f+63 and
//     warpgroup 1 the same up rows, so silu(g) * u is formed in the
//     epilogue from the two warpgroups' accumulators (exchanged through
//     shared memory) and only h, bf16, is written;
//   - down: the routing weight is applied in the epilogue and each row
//     is stored at its routing's place, so the caller sums a token's
//     routings with no atomics, in a fixed order;
//   - tiles are ordered (row tile, expert, feature tile), the row tile
//     slowest: the first tiles of the grid are every expert's first (and
//     usually only) row tile, spread evenly over the SMs; a tile past its
//     expert's rows is skipped by producer and consumers alike, so nothing
//     leaves the device to size the launch.
// Numerics: bf16 operands, fp32 accumulation; gate/up: silu(g) * u in fp32
// rounded once to bf16; down: row_w * acc in fp32.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dense.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRowTile = 64;                         // wgmma's N
constexpr int kStages = 4;
using Tile = etp::WgTile<128, kRowTile, kStages>;    // two warpgroups
constexpr int kConsumerThreads = Tile::kConsumers * 128;
// warpgroup 1's up accumulators, handed to warpgroup 0
constexpr int kXchgFloats = 128 * (kRowTile / 2);
constexpr size_t kSmem =
    static_cast<size_t>(kStages) * Tile::kStageBytes + kXchgFloats * 4 + 1024;

struct MoeArgs {
  const int* offsets;    // (E + 1,) rows of each held expert
  const float* row_w;    // (R,) routing weights (down)
  const int* dest;       // (R,) output row of each routing (down)
  void* out;             // gate/up: (R, n_out) bf16; down: (n_dest, n_out)
  int E, n_out, K, R;    // n_out: I (gate/up) or N (down)
};

// the tile t's expert, feature tile and first row; false for a tile past
// its expert's rows
__device__ __forceinline__ bool decode(const MoeArgs& p, int t, int f_tiles,
                                       int& e, int& ft, int& r0, int& hi) {
  const int per_rt = p.E * f_tiles;
  const int rt = t / per_rt, rem = t % per_rt;
  e = rem / f_tiles;
  ft = rem % f_tiles;
  r0 = __ldg(p.offsets + e) + rt * kRowTile;
  hi = __ldg(p.offsets + e + 1);
  return r0 < hi;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

template <bool GATE_UP>
__global__ void __launch_bounds__(Tile::kThreads, 1)
moe_gemm_kernel(const __grid_constant__ CUtensorMap tm_w,
                const __grid_constant__ CUtensorMap tm_x, MoeArgs p,
                unsigned* fault) {
  extern __shared__ __align__(1024) unsigned char moe_smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  unsigned char* base = etp::ring_base(moe_smem);
  float* xchg = reinterpret_cast<float*>(base + kStages * Tile::kStageBytes);
  const int f_tiles = GATE_UP ? p.n_out / 64 : p.n_out / 128;
  const int tiles = (p.R + kRowTile - 1) / kRowTile * p.E * f_tiles;
  const int KT = p.K / etp::kWgBk;
  const int tid = threadIdx.x;
  etp::init_ring<kStages>(full, empty, Tile::kConsumers);
  __syncthreads();

  int it = 0, e, ft, r0, hi;
  if (tid >= kConsumerThreads) {         // the producer warp
    if (tid != kConsumerThreads) return;
    const etp::BarrierSite site{fault, 128, kRowTile, kStages, 1};
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      if (!decode(p, t, f_tiles, e, ft, r0, hi)) continue;
      // weight rows of the two warpgroups: gate f.. and up f.. of expert
      // e's (2I, K) block, or 128 consecutive rows of its (N, K) block
      const int w0 = GATE_UP ? e * 2 * p.n_out + ft * 64
                             : e * p.n_out + ft * 128;
      const int w1 = GATE_UP ? w0 + p.n_out : w0 + 64;
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % kStages;
        if (it >= kStages)
          etp::mbar_wait(&empty[s], (it / kStages - 1) & 1, site, s);
        unsigned char* st = base + s * Tile::kStageBytes;
        etp::mbar_expect_tx(&full[s], Tile::kStageBytes);
        etp::tma_load_2d(st, &tm_w, &full[s], kt * etp::kWgBk, w0);
        etp::tma_load_2d(st + 64 * 128, &tm_w, &full[s], kt * etp::kWgBk,
                         w1);
        etp::tma_load_2d(st + Tile::kABytes, &tm_x, &full[s],
                         kt * etp::kWgBk, r0);
      }
    }
    return;
  }

  const int wg = tid / 128, lane = tid % 32, w = (tid % 128) / 32;
  const int grp = lane / 4, tig = lane % 4;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    if (!decode(p, t, f_tiles, e, ft, r0, hi)) continue;
    float d[kRowTile / 2];
    etp::consume_tile<128, kRowTile, kStages>(d, base, full, empty, KT, it,
                                              wg, tid % 128 == 0, fault);
    // accumulator i: weight row 16 w + grp + 8 ((i / 2) % 2) of the
    // warpgroup's 64, routing row r0 + 8 (i / 4) + 2 tig + i % 2
    if constexpr (GATE_UP) {
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < kRowTile / 2; ++i)
          xchg[i * 128 + tid % 128] = d[i];
      }
      consumers_sync();
      if (wg == 0) {
        bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
        for (int i = 0; i < kRowTile / 2; ++i) {
          const int f = ft * 64 + 16 * w + grp + 8 * ((i >> 1) & 1);
          const int r = r0 + 8 * (i >> 2) + 2 * tig + (i & 1);
          if (r < hi) {
            const float g = d[i], u = xchg[i * 128 + tid];
            out[static_cast<long long>(r) * p.n_out + f] =
                __float2bfloat16(g / (1.f + expf(-g)) * u);
          }
        }
      }
      consumers_sync();                  // xchg is rewritten next tile
    } else {
      float* out = static_cast<float*>(p.out);
#pragma unroll
      for (int i = 0; i < kRowTile / 2; ++i) {
        const int f = ft * 128 + wg * 64 + 16 * w + grp + 8 * ((i >> 1) & 1);
        const int r = r0 + 8 * (i >> 2) + 2 * tig + (i & 1);
        if (r < hi)
          out[static_cast<long long>(__ldg(p.dest + r)) * p.n_out + f] =
              __ldg(p.row_w + r) * d[i];
      }
    }
  }
}

template <bool GATE_UP>
int launch(const void* x, const void* w, const MoeArgs& p,
           cudaStream_t st) {
  if (p.E < 1 || p.R < 1 || p.K % etp::kWgBk ||
      p.n_out % (GATE_UP ? 64 : 128))
    return -1;
  if (reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return -2;                           // TMA needs 16-byte aligned bases
  const int w_rows = p.E * p.n_out * (GATE_UP ? 2 : 1);
  CUtensorMap tm_w, tm_x;
  int err = etp::encode_rows(&tm_w, w, w_rows, p.K, 64);
  if (!err) err = etp::encode_rows(&tm_x, x, p.R, p.K, kRowTile);
  if (err) return err;
  auto kernel = moe_gemm_kernel<GATE_UP>;
  err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem)));
  if (err) return err;
  const int f_tiles = GATE_UP ? p.n_out / 64 : p.n_out / 128;
  const long long tiles =
      static_cast<long long>((p.R + kRowTile - 1) / kRowTile) * p.E * f_tiles;
  const int grid = tiles < etp::kSms ? static_cast<int>(tiles) : etp::kSms;
  kernel<<<grid, Tile::kThreads, kSmem, st>>>(tm_w, tm_x, p,
                                              etp::fault_record_device());
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (R, K) bf16 rows sorted by held expert, w_gu (E, 2I, K) bf16 (expert
// e's I gate rows, then its I up rows), offsets int32 (E + 1,) on the
// device; out (R, I) bf16, written at the rows of held experts. Needs K %
// 64 == 0 and I % 64 == 0. Returns cudaGetLastError() after the launch,
// -1 for sizes it does not take, -2 for a base that is not 16-byte
// aligned, or etp::kErrTensorMap.
int etp_moe_gate_up(const void* x, const void* w_gu, const void* offsets,
                    void* out, int E, int I, int K, int R, void* stream) {
  const MoeArgs p{static_cast<const int*>(offsets), nullptr, nullptr, out,
                  E, I, K, R};
  return launch<true>(x, w_gu, p, static_cast<cudaStream_t>(stream));
}

// h (R, K) bf16 rows sorted by held expert, w_d (E, N, K) bf16, offsets
// int32 (E + 1,), row_w fp32 (R,), dest int32 (R,) on the device; out
// (n_dest, N) fp32, zeroed by the caller: row dest[r] = row_w[r] * (h[r] .
// w_d[e]^T) for the rows of held experts. Needs K % 64 == 0 and N % 128
// == 0. Returns as etp_moe_gate_up.
int etp_moe_down(const void* h, const void* w_d, const void* offsets,
                 const void* row_w, const void* dest, void* out, int E, int N,
                 int K, int R, void* stream) {
  const MoeArgs p{static_cast<const int*>(offsets),
                  static_cast<const float*>(row_w),
                  static_cast<const int*>(dest), out, E, N, K, R};
  return launch<false>(h, w_d, p, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
