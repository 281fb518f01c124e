// K-NMS: waypoint-heatmap softmax + circular row wrap + iterative argmax
// NMS + the K candidate slots, one block per batch row, for sm_90a. Built
// by nvcc into a shared library with a plain C interface
// (etpnav_tpu_torch/ops/cuda_build.py) and called through ctypes from
// etpnav_tpu_torch/ops/fused_nms.py.
//
// Replaces the Pallas TPU kernel fused_heatmap_nms
// (etpnav_tpu/ops/pallas_nms.py:59-96, kernel _nms_kernel :28-56), the
// softmax and wrap its wrapper ran as separate XLA ops, and the
// extract_candidates chain after it (etpnav_tpu/models/waypoint.py:81).
// Semantics are those of etpnav_tpu/ops/nms.py (itself pinned to the
// reference's waypoint_pred/utils.py:8-64): a softmax over all A*D cells;
// the map wrapped to A+2 rows (row A-1 on top, row 0 at the bottom); K
// rounds of first-index argmax (jnp.argmax ties) with rectangular
// suppression |dy| <= sigma_y and min(|dx|, |dx + D|) <= sigma_x — the
// reference's asymmetric circular wrap on the distance axis, reproduced as
// it is. The value written at a peak is the original probability
// (ops/nms.py:52), even once every cell is suppressed. The slots are
// extract_candidates(map[:, 1:-1, :], K): the peaks on wrapped rows 1..A
// whose value is > 0, in row-major order, (row - 1, column, 1); the rest
// (0, 0, 0).
//
// Rounding: p = expf(x - max) / s. The sum s is taken exactly: each of
// the A*D values of expf(x - max) (in [0, 1]) is truncated to a multiple
// of 2^-40, those integers are summed in int64 (exact, < 2^51, so in any
// order), and the sum is rounded once to fp32. The plain version
// (heatmap_nms_plain) takes the same steps, so the map and the slots
// equal it bit for bit by construction, whatever order either sums in.
// Before its one rounding, s is within A*D * 2^-40 (< 1.4e-9) of the
// exact sum of the fp32 values.
//
// What bounds it: at (B = 8, 120, 12) it reads 46 KB and writes 47 KB
// (28 ns at 3.35 TB/s), so what it costs is its serial structure. A
// block of 256 threads per sample spent its 9.3 us (kernel time, NVIDIA
// H100 80GB HBM3, 700 W) on two __syncthreads and an 8-way cross-warp
// scan per round, a runtime i / D and i % D for every cell of every
// round, expf taken twice per cell and a cell-by-cell zero fill.
// This one, a block of kWarps = 16 warps per sample:
//   - reads the logits once into registers (cell i = t * T + tid of the
//     wrapped map, T = 512 threads) and takes each cell's expf once;
//   - works out each cell's (row, column) once, D = 12 a compile-time
//     divisor; a round tests a cell against the peak's column set (one
//     ballot of 12 lanes) and row range: no division per round;
//   - takes each round's argmax of (value, index) pairs with redux
//     instructions (the largest value's bits, then the lowest index
//     holding it): in each warp, then once across the warps' partials
//     (one barrier a round, the partials double-buffered);
//   - keeps suppression and selection as bit masks in registers, skips
//     the last round's suppression, and writes the map once, every cell,
//     at the end;
//   - writes the K slots from the peaks' indices in the same launch.
// 16 warps per sample is the fastest block measured at B = 8 (kernel
// time, NVIDIA H100 80GB HBM3, 700 W; PERF.md): 1 warp 16.2 us (46 cells
// a lane, no barrier, but each round's work serial in one warp), 4 warps
// 7.1, 8 warps 5.2, 16 warps 5.0, 32 warps 5.9 us. Running the rounds in
// one warp over row maxima after a block-wide softmax was slower too.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kD = 12;                   // distance bins: the map's width
constexpr int kMaxCells = 32 * 46;       // (A + 2) * D for A <= 120
constexpr int kMaxK = 32;                // slots are written by one warp
constexpr int kWarps = 16;               // a sample's block
constexpr float kFixed = 0x1p40f;        // the sum's fixed-point scale

// The warp's best (value, index) pair, in every lane: the largest value,
// then the lowest index among the lanes that hold it. Values are >= 0 (a
// probability or a suppressed 0), so their fp32 bits order as unsigned
// integers, and two redux instructions do it.
__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
  const unsigned top = __reduce_max_sync(kFull, __float_as_uint(bv));
  bi = static_cast<int>(__reduce_min_sync(
      kFull, __float_as_uint(bv) == top ? static_cast<unsigned>(bi)
                                        : 0x7fffffffu));
  bv = __uint_as_float(top);
}

// The warp's largest value, in every lane, by one redux on the fp32 bits
// mapped to integers of the same order.
__device__ __forceinline__ float warp_max(float v) {
  const unsigned u = __float_as_uint(v);
  const unsigned top = __reduce_max_sync(
      kFull, u ^ (static_cast<unsigned>(static_cast<int>(u) >> 31) |
                  0x80000000u));
  return __uint_as_float(top & 0x80000000u ? top ^ 0x80000000u : ~top);
}

// The wrapped row y's source row in the (A, D) logits.
__device__ __forceinline__ int src_row(int y, int A) {
  return y == 0 ? A - 1 : (y == A + 1 ? 0 : y - 1);
}

__global__ void __launch_bounds__(kWarps * 32)
heatmap_nms_kernel(const float* __restrict__ logits, float* __restrict__ out,
                   long long* __restrict__ slots,
                   unsigned char* __restrict__ valid, int B, int A, int K,
                   float sigma_x, float sigma_y) {
  constexpr int T = kWarps * 32;
  constexpr int CPT = (kMaxCells + T - 1) / T;   // cells per thread
  static_assert(CPT <= 64, "masks are 64-bit");
  __shared__ float red_v[2][kWarps];
  __shared__ int red_i[2][kWarps];
  __shared__ long long red_s[kWarps];
  __shared__ int peaks[kMaxK];
  __shared__ float peak_v[kMaxK];        // the map's value at each peak
  const int b = blockIdx.x;
  const int N0 = A * kD, N = N0 + 2 * kD;
  const float* x = logits + static_cast<long long>(b) * N0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  float p[CPT];
  int row[CPT], col[CPT];
  float mx = -INFINITY;
#pragma unroll
  for (int t = 0; t < CPT; ++t) {
    const int i = t * T + tid;
    row[t] = i / kD;
    col[t] = i - row[t] * kD;
    p[t] = -INFINITY;
    if (i < N) {
      p[t] = x[src_row(row[t], A) * kD + col[t]];
      mx = fmaxf(mx, p[t]);
    }
  }
  mx = warp_max(mx);
  if (lane == 0) red_v[0][warp] = mx;
  __syncthreads();
  mx = warp_max(lane < kWarps ? red_v[0][lane] : -INFINITY);
  long long s = 0;                       // the A*D cells; wrap rows excluded
#pragma unroll
  for (int t = 0; t < CPT; ++t) {
    const int i = t * T + tid;
    if (i < N) {
      p[t] = expf(__fsub_rn(p[t], mx));
      if (row[t] >= 1 && row[t] <= A)    // truncated to a multiple of 2^-40
        s += static_cast<long long>(__fmul_rn(p[t], kFixed));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  if (lane == 0) red_s[warp] = s;
  __syncthreads();
  s = lane < kWarps ? red_s[lane] : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  // s < 2^51 converts to double exactly, then rounds once to fp32
  const float sf = static_cast<float>(static_cast<double>(s) / 0x1p40);
#pragma unroll
  for (int t = 0; t < CPT; ++t) p[t] = __fdiv_rn(p[t], sf);

  // |dy| <= sigma_y for an integer dy is |dy| <= floor(sigma_y)
  const int ry = sigma_y >= 0.f
                     ? static_cast<int>(fminf(floorf(sigma_y), 1e6f)) : -1;
  uint64_t sup = 0, sel = 0;
  for (int r = 0; r < K; ++r) {
    float bv = 0.f;                      // below every cell but ties
    int bi = 0x7fffffff;
#pragma unroll
    for (int t = 0; t < CPT; ++t) {      // ascending i: first index wins
      const int i = t * T + tid;
      const float v = (sup >> t) & 1 ? 0.f : p[t];
      if (i < N && (v > bv || bi == 0x7fffffff)) { bv = v; bi = i; }
    }
    warp_argmax(bv, bi);
    if (lane == 0) { red_v[r & 1][warp] = bv; red_i[r & 1][warp] = bi; }
    __syncthreads();                     // round r + 1 writes the other half
    bv = lane < kWarps ? red_v[r & 1][lane] : 0.f;
    bi = lane < kWarps ? red_i[r & 1][lane] : 0x7fffffff;
    warp_argmax(bv, bi);
    const int idx = bi < N ? bi : 0;     // NaN logits select nothing
    if (tid == 0) peaks[r] = idx;
    if (idx % T == tid) {                // the owner: the map's value there
      sel |= 1ull << (idx / T);
#pragma unroll
      for (int t = 0; t < CPT; ++t)
        if (t == idx / T) peak_v[r] = fmaxf(p[t], 0.f);
    }
    if (r + 1 == K) break;               // the last peak suppresses nothing
    const int y_mu = idx / kD, x_mu = idx - y_mu * kD;
    const int dx = lane - x_mu;
    const unsigned cols = __ballot_sync(
        kFull, lane < kD && static_cast<float>(min(abs(dx), abs(dx + kD))) <=
                                sigma_x);
    const int lo = y_mu - ry, hi = y_mu + ry;
#pragma unroll
    for (int t = 0; t < CPT; ++t)
      if (((cols >> col[t]) & 1u) && row[t] >= lo && row[t] <= hi)
        sup |= 1ull << t;
  }

  float* o = out + static_cast<long long>(b) * N;
#pragma unroll
  for (int t = 0; t < CPT; ++t) {
    const int i = t * T + tid;
    if (i < N) o[i] = (sel >> t) & 1 ? fmaxf(p[t], 0.f) : 0.f;
  }

  __syncthreads();
  if (warp != 0) return;
  // slot of peak r, in lane r: a peak on rows 1..A whose map value is > 0
  // and that no earlier round took
  const int pk = lane < K ? peaks[lane] : 0x7fffffff;
  bool ok = lane < K && pk / kD >= 1 && pk / kD <= A &&
            peak_v[lane < K ? lane : 0] > 0.f;
  for (int q = 0; q < K; ++q)
    if (__shfl_sync(kFull, pk, q) == pk && q < lane) ok = false;
  const unsigned oks = __ballot_sync(kFull, ok);
  const int nvalid = __popc(oks);
  int rank = 0;
  for (int q = 0; q < K; ++q)
    rank += ((oks >> q) & 1u) && __shfl_sync(kFull, pk, q) < pk;
  long long* angle = slots + static_cast<long long>(b) * K;
  long long* dist = angle + static_cast<long long>(B) * K;
  unsigned char* vb = valid + static_cast<long long>(b) * K;
  if (ok) {
    angle[rank] = pk / kD - 1;
    dist[rank] = pk % kD;
    vb[rank] = 1;
  }
  if (lane >= nvalid && lane < K) {
    angle[lane] = 0;
    dist[lane] = 0;
    vb[lane] = 0;
  }
}

}  // namespace

extern "C" {

// logits (B, A, D) fp32 contiguous -> out (B, A+2, D) fp32, slots (2, B,
// K) int64 (angle index, distance index) and valid (B, K) bool, all
// contiguous. Returns cudaGetLastError() after the launch, or -1 for
// arguments it does not take (D != 12, (A + 2) * 12 > 1472 cells, K
// outside 1..32).
int etp_heatmap_nms(const float* logits, float* out, long long* slots,
                    unsigned char* valid, int B, int A, int D, int K,
                    float sigma_x, float sigma_y, void* stream) {
  if (B < 1 || A < 1 || D != kD || (A + 2) * kD > kMaxCells || K < 1 ||
      K > kMaxK)
    return -1;
  heatmap_nms_kernel<<<B, kWarps * 32, 0, static_cast<cudaStream_t>(
                                              stream)>>>(
      logits, out, slots, valid, B, A, K, sigma_x, sigma_y);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
