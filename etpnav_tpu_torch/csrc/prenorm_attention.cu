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
// in bf16 the chain first rounds them to nearest even into a bf16 scratch
// (they then equal .to(torch.bfloat16), as the plain version's).
//
// Design: one C entry point that launches a chain of kernels on the
// caller's stream, all hand-written (no cuBLAS), all in csrc/dense.cuh
// (shared with K-BLOCK, attention_block.cu):
//   0. bf16 only: the four (D, D) weights rounded to bf16 once per call
//      (round_bf16_kernel: 7 MB read, 3.5 MB written at D = 768);
//   1. LayerNorm, one warp per row, writing a = LN(x) (M, D);
//   2. the q/k/v projections as one GEMM with N = 3D, a (M, D) times the
//      three weights, with the bias epilogue, writing q, k, v (3, M, D) in
//      the natural (B, L, H*hd) layout;
//   3. attention (head_attention_tc_kernel in bf16: a grid of (sample,
//      head, query group of up to 4 tiles; at L <= 64 one group), one
//      16-row query tile per warp; q, k, v of the head (L <= 64 rows of
//      hd = 64) copied into shared memory by cp.async; each warp scores
//      its rows over all keys on tensor cores, so the softmax max is the
//      row's own, as in the Pallas kernel, and p is rounded once,
//      unnormalised, in the fragments);
//   4. the output projection as a GEMM with the bias + residual epilogue.
//
// What bounds it: at the CLIP shape (B*12 = 96 images, L = 50, D = 768)
// the four projections are 2*M*D*4D = 22.6 GFLOP against ~24 MB of
// activations and weights, so in bf16 the tensor cores' rate bounds it
// (~23 us at 989 TFLOP/s) and in fp32 the CUDA cores' (~340 us at 67
// TFLOP/s). The bf16 GEMMs run wgmma on tiles that TMA loads into a ring
// of shared-memory stages (dense.cuh says why); the chain keeps a, q/k/v
// and ctx in device memory between its kernels (5*M*D elements written
// and read once each, ~4.6 MB in bf16, most of it in L2). The fp32
// launches keep the CUDA-core GEMM and attention.

#include "dense.cuh"

namespace {

using etp::kTile;

constexpr int kMaxLen = 64;              // tokens per sample (ViT-B/32: 50)

template <typename T>
int run_chain(const T* x, const float* ln_g, const float* ln_b,
              const float* const* w, const float* const* bias,
              __nv_bfloat16* w_bf16, T* a, T* qkv, T* ctx, T* out, int B,
              int L, int D, int H, float eps, float scale, cudaStream_t st) {
  const int M = B * L;
  const void* wt[4] = {w[0], w[1], w[2], w[3]};
  int err = 0;
  if constexpr (sizeof(T) == 2) {
    err = etp::launch_round_bf16(w, 4, D * D, w_bf16, st);
    if (err) return err;
    for (int i = 0; i < 4; ++i)
      wt[i] = w_bf16 + static_cast<long long>(i) * D * D;
  }
  err = etp::launch_layer_norm<T, T>(x, ln_g, ln_b, a, M, D, eps, st);
  if (err) return err;

  etp::GemmArgs qkv_args{a, {wt[0], wt[1], wt[2]},
                         {bias[0], bias[1], bias[2]}, nullptr, qkv, M, D, D};
  etp::GemmArgs o_args{ctx, {wt[3], wt[3], wt[3]},
                       {bias[3], bias[3], bias[3]}, x, out, M, D, D};
  err = etp::launch_gemm<T, T>(qkv_args, 3, st);
  if (err) return err;

  err = etp::launch_head_attention<T, kMaxLen / 32, false>(
      qkv, nullptr, 0, 0, 0, ctx, B, L, D, H, scale, st);
  if (err) return err;

  return etp::launch_gemm<T, T>(o_args, 1, st);
}

}  // namespace

extern "C" {

// x, out (B, L, D) and the scratch a, ctx (B*L, D) and qkv (3, B*L, D)
// in one dtype (0 = float32, 1 = bfloat16), contiguous; ln_g, ln_b and
// the biases fp32 (D,); the weights fp32 (D, D) as (out, in); w_bf16 a
// bf16 (4, D, D) scratch for the rounded weights (bf16 only; may be null
// for float32). Needs D = H*64, D % 64 == 0 and 1 <= L <= 64.
// Returns the first non-zero cudaGetLastError() of the chain, or -1 for
// arguments it does not take.
int etp_prenorm_attention(const void* x, const void* ln_g, const void* ln_b,
                          const void* wq, const void* bq, const void* wk,
                          const void* bk, const void* wv, const void* bv,
                          const void* wo, const void* bo, void* w_bf16,
                          void* a, void* qkv, void* ctx, void* out,
                          int dtype, int B, int L, int D, int H, float eps,
                          float scale, void* stream) {
  if (B < 1 || L < 1 || L > kMaxLen || H < 1 || D != H * etp::kHeadDim ||
      D % kTile != 0 || (dtype == 1 && !w_bf16))
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
  __nv_bfloat16* wl = static_cast<__nv_bfloat16*>(w_bf16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_chain<float>(
        static_cast<const float*>(x), g, b, w, bias, wl,
        static_cast<float*>(a), static_cast<float*>(qkv),
        static_cast<float*>(ctx), static_cast<float*>(out), B, L, D, H, eps,
        scale, st);
  if (dtype == 1)
    return run_chain<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), g, b, w, bias, wl,
        static_cast<__nv_bfloat16*>(a), static_cast<__nv_bfloat16*>(qkv),
        static_cast<__nv_bfloat16*>(ctx), static_cast<__nv_bfloat16*>(out),
        B, L, D, H, eps, scale, st);
  return -1;
}

// dst (n,) bf16 = src (n,) fp32 rounded to nearest even, n % 4 == 0, both
// 16-byte aligned: the chain's weight rounding alone, for checking it.
int etp_round_bf16(const void* src, void* dst, int n, void* stream) {
  if (n < 4 || n % 4 != 0) return -1;
  const float* s = static_cast<const float*>(src);
  return etp::launch_round_bf16(&s, 1, n, static_cast<__nv_bfloat16*>(dst),
                                static_cast<cudaStream_t>(stream));
}

// out (M, N) bf16 = a (M, K) bf16 . w (N, K)^T bf16 + bias (N,) fp32,
// rounded once: the chains' bf16 GEMM alone, for measuring it, with the
// tile configuration the chains pick for this shape (dense.cuh). Needs
// N % 64 == 0, K % 64 == 0 and 16-byte aligned a and w (-2 otherwise).
int etp_gemm_bf16(const void* a, const void* w, const void* bias, void* out,
                  int M, int N, int K, void* stream) {
  if (M < 1 || N < 64 || K < 64 || N % 64 != 0 || K % 64 != 0) return -1;
  const float* bb = static_cast<const float*>(bias);
  etp::GemmArgs p{a, {w, w, w}, {bb, bb, bb}, nullptr, out, M, K, N};
  return etp::dispatch_gemm_bf16<__nv_bfloat16>(
      p, 1, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
