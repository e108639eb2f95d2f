// One packed output word of the multi-source pulls, shared by the kernels of
// blest_ms.cu and blest_serve.cu.  A word holds 32 lanes (BFSs) of one slot
// (slice) of a VSS; fq points at the parent slice set's (sigma, kw) frontier
// words, w is the word's index in [0, kw).  sigma <= 8 (masks are bytes).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace blest {

// The selective-OR pull of kernels/pull_ms_packed.py:
//   word = OR_{b : bit_b(m)} fq[b, w]
// Zero bits read nothing, so a zero mask costs no frontier load.
__device__ __forceinline__ uint32_t or_pull_word(unsigned m,
                                                 const uint32_t* fq, int kw,
                                                 int w) {
  uint32_t acc = 0;
  for (; m; m &= m - 1) acc |= fq[(__ffs(m) - 1) * kw + w];
  return acc;
}

// The binary-MMA pull of kernels/pull_mma_ms_packed.py, for one slot with
// int8 weights aj[0..sigma):
//   count[l] = sum_b aj[b] * bit_l(fq[b, w]);   word = sum_l (count[l] > 0) << l
// When no weight is negative, count[l] > 0 exactly when some b with
// aj[b] > 0 has bit l set, so the word is the OR of those words (one pass);
// a negative weight runs the 32-lane count loop.  Both are exact on any int8
// weights.  Zero weights read no frontier word.  The unrolled loops keep a
// and fw in registers (weights past sigma are 0); sigma == 8 reads the row
// in one aligned 8-byte load.
__device__ __forceinline__ uint32_t mma_word(const int8_t* aj, int sigma,
                                             const uint32_t* fq, int kw,
                                             int w) {
  uint64_t row = 0;
  if (sigma == 8 && (reinterpret_cast<uintptr_t>(aj) & 7u) == 0) {
    row = *reinterpret_cast<const uint64_t*>(aj);
  } else {
    for (int b = 0; b < sigma; ++b) {
      row |= static_cast<uint64_t>(static_cast<uint8_t>(aj[b])) << (8 * b);
    }
  }
  int a[8];
  uint32_t fw[8];
  uint32_t pos_or = 0;
  bool negative = false;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    a[b] = static_cast<int8_t>(row >> (8 * b));
    fw[b] = a[b] ? fq[b * kw + w] : 0u;
    if (a[b] > 0) pos_or |= fw[b];
    negative |= a[b] < 0;
  }
  if (!negative) return pos_or;
  uint32_t word = 0;
  for (int l = 0; l < 32; ++l) {
    int count = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      count += a[b] * static_cast<int>((fw[b] >> l) & 1u);
    }
    word |= static_cast<uint32_t>(count > 0) << l;
  }
  return word;
}

}  // namespace blest
