// K-BLOCK: the post-norm BERT self-attention sub-block,
// y = LN(x + (softmax(q.k^T * scale + bias[b]) . v) . Wo + bo), with the
// q/k/v/o projections inside, for sm_90a. Built by nvcc into a shared
// library with a plain C interface (see etpnav_tpu_torch/ops/cuda_build.py)
// and called through ctypes from etpnav_tpu_torch/ops/fused_block.py.
//
// Replaces the Pallas TPU kernel fused_attention_block
// (etpnav_tpu/ops/pallas_attention.py:686, _attn_block_kernel :639-683).
// Inference only. Its rounding points, which differ from K-ATT's:
//   - each projection an fp32 sum of x-dtype operands plus the fp32 bias,
//     rounded to x's dtype (in bf16 the chain first rounds the fp32 (out,
//     in) weights to nearest even into a bf16 scratch, so they equal
//     .to(torch.bfloat16));
//   - logits fp32 times scale plus the fp32 bias; p = exp(l - max)
//     normalised by the row sum in fp32 BEFORE it is rounded for p.v;
//   - ctx an fp32 sum, rounded;
//   - the output projection an fp32 sum plus bo plus the residual x, in
//     fp32 and NOT rounded before the LayerNorm;
//   - LayerNorm statistics in fp32, mean((h - mu)^2), rsqrt; rounded once.
// The bias is any fp32 (B, L, L) view, broadcast dims read with stride 0
// (the text encoder's (B,1,1,L) key mask, the graph self-attention's mask +
// sprel (B,1,G,G)).
//
// Design: one C entry point launching a chain of hand-written kernels on
// the caller's stream (no cuBLAS), all in csrc/dense.cuh (shared with
// K-PRENORM):
//   0. bf16 only: the four (D, D) weights rounded to bf16 once per call;
//   1. the q/k/v projections as one GEMM with N = 3D, writing q, k, v
//      (3, M, D), M = B*L;
//   2. attention with the bias and the normalise-first rounding: in bf16
//      head_attention_tc_kernel, a grid of (sample, head, query group of
//      up to 4 tiles), one 16-row query tile per warp (K and V of the
//      head, L <= 224 rows of hd = 64, and the group's Q in shared memory
//      by cp.async; each warp scores its rows over all keys on tensor
//      cores, so the max and the sum are the row's own); in fp32 the
//      CUDA-core head_attention_kernel, one block per (sample, head);
//      both write ctx (M, D);
//   3. the output projection as a GEMM whose epilogue adds bo and the
//      residual and stores the fp32 pre-norm row h (M, D);
//   4. the row LayerNorm of h, one warp per row, rounded to x's dtype.
// Steps 3 and 4 stay two kernels. A thread-block cluster of three blocks
// spanning D = 768 (256 columns each, the rows' statistics exchanged
// through distributed shared memory, h kept in the accumulators) was
// built and was no faster than the two kernels at the text layer,
// (160, 64) or (64, 200) on an H100 80GB HBM3 at 700 W, so it was not
// kept.
//
// What bounds it: at the text encoder's shape (B = 8, L = 80, D = 768) the
// four projections are 2*M*D*4D = 3.0 GFLOP against ~11 MB of weights and
// activations; at (160, 64) and (64, 200) 48 and 60 GFLOP. In bf16 the
// tensor cores' rate bounds it, in fp32 the CUDA cores'. The bf16 GEMMs
// are dense.cuh's TMA-fed wgmma design; q/k/v and ctx stay in device
// memory between the kernels.

#include "dense.cuh"

namespace {

using etp::kTile;

constexpr int kKeysPerLane = 7;
constexpr int kMaxLen = 32 * kKeysPerLane;   // 224 >= RxR's 200 tokens

template <typename T>
int run_chain(const T* x, const float* const* w, const float* const* bias,
              const float* ln_g, const float* ln_b, const float* attn_bias,
              long long sbb, long long sbq, long long sbk,
              __nv_bfloat16* w_bf16, T* qkv, T* ctx, float* h32, T* out,
              int B, int L, int D, int H, float eps, float scale,
              cudaStream_t st) {
  const int M = B * L;
  const void* wt[4] = {w[0], w[1], w[2], w[3]};
  int err = 0;
  if constexpr (sizeof(T) == 2) {
    err = etp::launch_round_bf16(w, 4, D * D, w_bf16, st);
    if (err) return err;
    for (int i = 0; i < 4; ++i)
      wt[i] = w_bf16 + static_cast<long long>(i) * D * D;
  }
  etp::GemmArgs qkv_args{x, {wt[0], wt[1], wt[2]},
                         {bias[0], bias[1], bias[2]}, nullptr, qkv, M, D, D};
  err = etp::launch_gemm<T, T>(qkv_args, 3, st);
  if (err) return err;

  err = etp::launch_head_attention<T, kKeysPerLane, true>(
      qkv, attn_bias, sbb, sbq, sbk, ctx, B, L, D, H, scale, st);
  if (err) return err;

  etp::GemmArgs o_args{ctx, {wt[3], wt[3], wt[3]},
                       {bias[3], bias[3], bias[3]}, x, h32, M, D, D};
  err = etp::launch_gemm<T, float>(o_args, 1, st);
  if (err) return err;
  return etp::launch_layer_norm<float, T>(h32, ln_g, ln_b, out, M, D, eps,
                                          st);
}

}  // namespace

extern "C" {

// x, out (B, L, D) and the scratch ctx (B*L, D) and qkv (3, B*L, D) in one
// dtype (0 = float32, 1 = bfloat16), contiguous; h32 (B*L, D) fp32
// scratch; w_bf16 a bf16 (4, D, D) scratch for the rounded weights (bf16
// only; may be null for float32); the biases and ln_g, ln_b fp32 (D,); the
// weights fp32 (D, D) as (out, in). attn_bias: fp32 with element strides
// (sbb, sbq, sbk) over (B, L, L). Needs D = H*64 and 1 <= L <= 224.
// Returns the first non-zero cudaGetLastError() of the chain, or -1 for
// arguments it does not take.
int etp_attention_block(const void* x, const void* wq, const void* bq,
                        const void* wk, const void* bk, const void* wv,
                        const void* bv, const void* wo, const void* bo,
                        const void* ln_g, const void* ln_b,
                        const void* attn_bias, long long sbb, long long sbq,
                        long long sbk, void* w_bf16, void* qkv, void* ctx,
                        void* h32, void* out, int dtype, int B, int L, int D,
                        int H, float eps, float scale, void* stream) {
  if (B < 1 || L < 1 || L > kMaxLen || H < 1 || D != H * etp::kHeadDim ||
      D % kTile != 0 || !attn_bias || (dtype == 1 && !w_bf16))
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
  const float* ab = static_cast<const float*>(attn_bias);
  __nv_bfloat16* wl = static_cast<__nv_bfloat16*>(w_bf16);
  float* hp = static_cast<float*>(h32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_chain<float>(static_cast<const float*>(x), w, bias, g, b, ab,
                            sbb, sbq, sbk, wl, static_cast<float*>(qkv),
                            static_cast<float*>(ctx), hp,
                            static_cast<float*>(out), B, L, D, H, eps, scale,
                            st);
  if (dtype == 1)
    return run_chain<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), w, bias, g, b, ab, sbb, sbq,
        sbk, wl, static_cast<__nv_bfloat16*>(qkv),
        static_cast<__nv_bfloat16*>(ctx), hp,
        static_cast<__nv_bfloat16*>(out), B, L, D, H, eps, scale, st);
  return -1;
}

}  // extern "C"
