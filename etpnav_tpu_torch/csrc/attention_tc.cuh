// Tensor-core building blocks of the bf16 attention kernels, K-ATT
// (attention.cu) and K-ATT-BWD (attention_bwd.cu), for sm_90a: 16-byte
// cp.async copies into shared memory, ldmatrix loads of mma.sync
// fragments (plain and transposed) and the packing of fp32 accumulators
// into a bf16 A operand. The product itself is etp::mma_bf16
// (mma.sync.m16n8k16, bf16 in, fp32 accumulate) of dense.cuh.
//
// Every head tile in shared memory holds rows of hd = 64 bf16 (128 bytes)
// at a pitch of 72 elements (144 bytes): the 16-byte chunks that one
// ldmatrix phase reads from 8 consecutive rows then fall on 8 distinct
// groups of 4 banks, so the loads are free of bank conflicts. A (rows x
// keys) bf16 tile whose width is a multiple of 16 gets a pitch of width +
// 8 for the same reason.
//
// Fragment coordinates of an m16n8 accumulator c[4] in a warp (grp =
// lane / 4, tig = lane % 4): c[0], c[1] at row grp, columns 2 tig and
// 2 tig + 1; c[2], c[3] at row grp + 8, the same columns.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "dense.cuh"

namespace etp {

constexpr int kTcHd = 64;                // the head dim of every tile
constexpr int kTcPitch = kTcHd + 8;      // bf16 elements per tile row

// What a bf16 entry point returns, without launching, for an operand
// whose rows cannot be copied as 16-byte chunks.
constexpr int kErrMisaligned = -2;

// True when a bf16 (n0, n1, n2, hd) operand with element strides `s`
// (fields b, h, l) has 16-byte rows: a 16-byte-aligned base, and the
// stride of every dim longer than 1 a multiple of 8 elements.
template <typename S>
inline bool rows16(const void* p, const S& s, int n0, int n1, int n2) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (n0 == 1 || s.b % 8 == 0) && (n1 == 1 || s.h % 8 == 0) &&
         (n2 == 1 || s.l % 8 == 0);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
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

}  // namespace etp
