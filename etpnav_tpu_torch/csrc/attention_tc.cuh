// The bf16 attention kernels' own pieces, K-ATT (attention.cu) and
// K-ATT-BWD (attention_bwd.cu), for sm_90a: the refusal of operands
// without 16-byte rows. Their tensor-core building blocks (16-byte
// cp.async copies, ldmatrix loads of mma.sync fragments, the packing of
// fp32 accumulators into a bf16 A operand, etp::mma_bf16 itself) live in
// dense.cuh, which the GEMM and the head attention of K-PRENORM and
// K-BLOCK share.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "dense.cuh"

namespace etp {

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

}  // namespace etp
