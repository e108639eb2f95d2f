// The int8 plane rows of the binary-MMA pulls, shared by ms_pull.cuh's
// plane-row instance and blest_ms.cu's tensor-core form (kernel 7) and by
// blest_serve.cu (kernel 10): a slot's weights as one 64-bit row, its
// positive-weight bits and negative flag, and the exact word of a row with
// a negative weight.  A word holds 32 lanes (BFSs) of one slot (slice) of a
// VSS.  sigma <= 8.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace blest {

// A slot's int8 MMA weights aj[0..sigma) as the bytes of one 64-bit row
// (weight b in byte b; bytes past sigma are 0).  sigma == 8 reads the row in
// one aligned 8-byte load.
__device__ __forceinline__ uint64_t plane_row(const int8_t* aj, int sigma) {
  if (sigma == 8 && (reinterpret_cast<uintptr_t>(aj) & 7u) == 0) {
    return *reinterpret_cast<const uint64_t*>(aj);
  }
  uint64_t row = 0;
  for (int b = 0; b < sigma; ++b) {
    row |= static_cast<uint64_t>(static_cast<uint8_t>(aj[b])) << (8 * b);
  }
  return row;
}

__device__ __forceinline__ int weight(uint64_t row, int b) {
  return static_cast<int8_t>(row >> (8 * b));
}

// Bit b set where weight b is positive (a nonzero byte with its sign bit
// clear; the multiply gathers bit 7 of each byte into the top byte), and
// whether the row has a negative weight.
__device__ __forceinline__ unsigned positive_bits(uint64_t row) {
  constexpr uint64_t kLow7 = 0x7f7f7f7f7f7f7f7full;
  const uint64_t nonzero = (((row & kLow7) + kLow7) | row) & ~kLow7;
  const uint64_t pos = nonzero & ~row;
  return static_cast<unsigned>(((pos >> 7) * 0x0102040810204080ull) >> 56);
}

__device__ __forceinline__ bool has_negative(uint64_t row) {
  return (row & 0x8080808080808080ull) != 0;
}

// The exact binary-MMA word of a row with any int8 weights, from the
// frontier words fw[b] of its planes (fw[b] unread where weight b is 0):
//   count[l] = sum_b a[b] * bit_l(fw[b]);   word = sum_l (count[l] > 0) << l
__device__ __forceinline__ uint32_t count_word(uint64_t row,
                                               const uint32_t (&fw)[8]) {
  uint32_t word = 0;
  for (int l = 0; l < 32; ++l) {
    int count = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      count += weight(row, b) * static_cast<int>((fw[b] >> l) & 1u);
    }
    word |= static_cast<uint32_t>(count > 0) << l;
  }
  return word;
}

}  // namespace blest
