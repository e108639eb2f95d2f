// Multi-source BLEST kernels for Hopper (sm_90a): the byteplane pull, the
// packed-word pull in its gather and its MMA-operand form, and the OR-scatter
// of packed marks into visited words (paper Alg. 5, kappa concurrent BFSs).
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes.  Every entry point takes
// device pointers and a cudaStream_t, launches on that stream, allocates
// nothing, does not synchronise, and returns the launch's cudaError_t so
// that the Python wrapper can raise on a refused launch.
//
// What bounds them: each is an integer pass that does a few operations per
// byte it moves, so device-memory bandwidth bounds it (bytes moved / 3.35
// TB/s on an H100 SXM); the MMA form's operation count, taken at the int8
// tensor-core rate, is below its byte bound too.  The outputs (marks) are
// most of the bytes, so every kernel writes them with consecutive threads on
// consecutive words, and reads each VSS's small parent frontier tile through
// v2r itself, as the TPU kernels' index maps do.  The ragged edge is masked
// by the loop bounds; nothing is padded.  sigma <= 8 (masks are bytes).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ms_words.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileThreads = 128;  // one block per VSS tile
constexpr int64_t kMaxBlocks = 132 * 16;

int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// Replaces repro/kernels/pull_ms.py::pull_ms (Pallas: one VSS per grid step,
// its parent's (sigma, kappa) frontier tile fetched through a scalar-prefetch
// index map on v2r, the (tau, sigma) @ (sigma, kappa) int8 product on the
// MXU, then > 0).  One block per VSS q:
//   marks[q, j, k] = (sum_{b < sigma} bit_b(masks[q, j]) * int8(f[v2r[q], b, k])) > 0
// Bound: bytes; the (tau, kappa) marks written per VSS are almost all of
// them.  The block stages its tau mask bytes and its parent's sigma x kappa
// frontier bytes in shared memory, each read once, then writes the tile four
// bytes a thread, lanes contiguous, so stores coalesce into whole lines.  The
// sum runs over the set bits of the mask only (a zero bit adds nothing), on
// the frontier bytes as signed int8, as the reference's int8 product does,
// so the kernel equals it on any bytes and not only on 0/1.
__global__ void pull_ms_kernel(const uint8_t* __restrict__ masks,
                               const uint8_t* __restrict__ f_planes,
                               const int32_t* __restrict__ v2r,
                               uint8_t* __restrict__ marks, int tau,
                               int sigma, int kappa) {
  extern __shared__ uint8_t smem[];
  const int tile = sigma * kappa;
  int8_t* f_s = reinterpret_cast<int8_t*>(smem);  // (sigma, kappa)
  uint8_t* m_s = smem + tile;                      // (tau,)
  const int64_t q = blockIdx.x;
  const uint8_t* f = f_planes + static_cast<int64_t>(v2r[q]) * tile;
  const uint8_t sigma_bits = static_cast<uint8_t>((1u << sigma) - 1u);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    f_s[i] = static_cast<int8_t>(f[i]);
  }
  for (int i = threadIdx.x; i < tau; i += blockDim.x) {
    m_s[i] = masks[q * tau + i] & sigma_bits;
  }
  __syncthreads();
  const int tk = tau * kappa;
  uint8_t* out = marks + q * tk;
  if (kappa % 4 == 0) {
    // four lanes of one slot per thread; tk % 4 == 0, so every tile starts
    // on a 4-byte boundary and the word store is aligned
    uint32_t* out_w = reinterpret_cast<uint32_t*>(out);
    for (int w = threadIdx.x; w < tk / 4; w += blockDim.x) {
      const int j = (4 * w) / kappa;
      const int k = (4 * w) % kappa;
      int acc[4] = {0, 0, 0, 0};
      for (unsigned m = m_s[j]; m; m &= m - 1) {
        const int8_t* row = f_s + (__ffs(m) - 1) * kappa + k;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += row[e];
      }
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) word |= static_cast<uint32_t>(acc[e] > 0) << (8 * e);
      out_w[w] = word;
    }
  } else {
    for (int i = threadIdx.x; i < tk; i += blockDim.x) {
      const int j = i / kappa;
      const int k = i % kappa;
      int acc = 0;
      for (unsigned m = m_s[j]; m; m &= m - 1) acc += f_s[(__ffs(m) - 1) * kappa + k];
      out[i] = acc > 0;
    }
  }
}

// Replaces repro/kernels/pull_ms_packed.py::pull_ms_packed (Pallas: one VSS
// per grid step, the parent's (sigma, kw) word tile through a scalar-prefetch
// index map, sigma selective ORs).  One block per VSS q, one thread per
// output word (j, w):
//   marks[q, j, w] = OR_{b < sigma : bit_b(masks[q, j])} f[v2r[q], b, w]
// Bound: bytes (the marks written).  Consecutive threads write consecutive
// words; the parent tile (sigma * kw words) is read through the L1 cache
// by all tau slots of the VSS; a zero mask reads no frontier word.
__global__ void pull_ms_packed_kernel(const uint8_t* __restrict__ masks,
                                      const uint32_t* __restrict__ f,
                                      const int32_t* __restrict__ v2r,
                                      uint32_t* __restrict__ marks, int tau,
                                      int sigma, int kw) {
  const int64_t q = blockIdx.x;
  const uint32_t* fq = f + static_cast<int64_t>(v2r[q]) * sigma * kw;
  const unsigned sigma_bits = (1u << sigma) - 1u;
  const int words = tau * kw;
  uint32_t* out = marks + q * words;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const int j = i / kw;
    out[i] = blest::or_pull_word(masks[q * tau + j] & sigma_bits, fq, kw,
                                 i % kw);
  }
}

// Replaces repro/kernels/pull_mma_ms_packed.py::pull_mma_ms_packed (Pallas:
// per grid step a batched (block, tau, sigma) x (block, sigma, kappa) int8
// product on the MXU over frontier tiles that XLA pre-gathered, then the
// sign of the counts packed into words).  Here the kernel reads f through
// v2r itself (no (n_q, sigma, kw) gathered copy), one block per VSS q, one
// thread per output word (j, w):
//   count[l] = sum_{b < sigma} a[q, j, b] * bit_l(f[v2r[q], b, w]),
//   marks[q, j, w] = sum_l (count[l] > 0) << l
// Bound: bytes (a_planes read, marks written); the 2*sigma*kappa operations
// per slot at the int8 tensor-core rate take less time.  Scalar code
// (blest::mma_word): the OR of the positively weighted words, or the 32-lane
// count loop where a weight is negative; exact on any int8 a_planes, as the
// reference is.
__global__ void pull_mma_ms_packed_kernel(const int8_t* __restrict__ a_planes,
                                          const uint32_t* __restrict__ f,
                                          const int32_t* __restrict__ v2r,
                                          uint32_t* __restrict__ marks,
                                          int tau, int sigma, int kw) {
  const int64_t q = blockIdx.x;
  const uint32_t* fq = f + static_cast<int64_t>(v2r[q]) * sigma * kw;
  const int8_t* aq = a_planes + q * tau * sigma;
  const int words = tau * kw;
  uint32_t* out = marks + q * words;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const int j = i / kw;
    out[i] = blest::mma_word(aq + j * sigma, sigma, fq, kw, i % kw);
  }
}

// Replaces repro/kernels/scatter_or.py::scatter_or (Pallas: a grid of
// n_rows + t steps, an init copy then one read-modify-write of out[rows[i]]
// per step, correct only because TPU grid steps run in order on one core).
// Blocks run in no order here, so each word is ORed in with atomicOr: OR is
// commutative and idempotent, so duplicate rows combine exactly whatever the
// order.  The wrapper copies dest into out first.  One thread per scatter
// element i (a grid-stride loop), over its kw words:
//   out[rows[i], w] |= marks[i, w]
// Bound: bytes (marks and rows read, out read and written).  A zero word is
// skipped (OR with 0 changes nothing), so slots that mark nothing cost one
// read and no atomic.  rows are int64 (the port's row_ids) and must lie in
// [0, n_rows): the kernel reads them unchecked, as the pulls read v2r.
__global__ void scatter_or_kernel(uint32_t* __restrict__ out,
                                  const int64_t* __restrict__ rows,
                                  const uint32_t* __restrict__ marks,
                                  int64_t t, int kw) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       s < t; s += stride) {
    const uint32_t* ms = marks + s * kw;
    uint32_t* row = nullptr;
    for (int w = 0; w < kw; ++w) {
      const uint32_t m = ms[w];
      if (m == 0) continue;
      if (row == nullptr) row = out + rows[s] * kw;
      atomicOr(row + w, m);
    }
  }
}

}  // namespace

extern "C" {

int blest_pull_ms(const void* masks, const void* f_planes, const void* v2r,
                  void* marks, int64_t n_q, int tau, int sigma, int kappa,
                  void* stream) {
  const int smem = sigma * kappa + tau;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pull_ms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pull_ms_kernel<<<static_cast<unsigned>(n_q), kTileThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(masks), static_cast<const uint8_t*>(f_planes),
      static_cast<const int32_t*>(v2r), static_cast<uint8_t*>(marks), tau,
      sigma, kappa);
  return static_cast<int>(cudaGetLastError());
}

int blest_pull_ms_packed(const void* masks, const void* f, const void* v2r,
                         void* marks, int64_t n_q, int tau, int sigma, int kw,
                         void* stream) {
  pull_ms_packed_kernel<<<static_cast<unsigned>(n_q), kTileThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(masks), static_cast<const uint32_t*>(f),
      static_cast<const int32_t*>(v2r), static_cast<uint32_t*>(marks), tau,
      sigma, kw);
  return static_cast<int>(cudaGetLastError());
}

int blest_pull_mma_ms_packed(const void* a_planes, const void* f,
                             const void* v2r, void* marks, int64_t n_q,
                             int tau, int sigma, int kw, void* stream) {
  pull_mma_ms_packed_kernel<<<static_cast<unsigned>(n_q), kTileThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a_planes), static_cast<const uint32_t*>(f),
      static_cast<const int32_t*>(v2r), static_cast<uint32_t*>(marks), tau,
      sigma, kw);
  return static_cast<int>(cudaGetLastError());
}

int blest_scatter_or(void* out, const void* rows, const void* marks,
                     int64_t t, int kw, void* stream) {
  scatter_or_kernel<<<grid_for(t), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), static_cast<const int64_t*>(rows),
      static_cast<const uint32_t*>(marks), t, kw);
  return static_cast<int>(cudaGetLastError());
}

const char* blest_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
