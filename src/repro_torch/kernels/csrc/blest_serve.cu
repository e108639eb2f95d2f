// Serve-engine kernels for Hopper (sm_90a): the dense packed level with the
// pull fused into the OR-scatter, in its selective-OR and its MMA-operand
// form, and the packed pull over a queued list of active VSSs (the engine's
// per-level dense/queued sweeps, kappa lanes of 32-bit words).
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes.  Every entry point takes
// device pointers and a cudaStream_t, launches on that stream, allocates
// nothing, does not synchronise, and returns the launch's cudaError_t so
// that the Python wrapper can raise on a refused launch.  The per-word pulls
// are those of blest_ms.cu (ms_words.cuh).
//
// What bounds them: device-memory bandwidth.  Each does a few integer
// operations per byte it moves.  The fused kernels read the masks (or int8
// planes), the int64 scatter rows and the frontier tiles once and the
// visited words twice (copy, then OR); they never write the (N_q, tau, kw)
// marks that the unfused pull + scatter_or pair writes and reads back.
// Their atomics on the rows of hub vertices (many slots on one row) are what
// holds scatter_or below the bandwidth bound, and they hit these kernels too.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ms_words.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileThreads = 128;  // one block per queued VSS
constexpr int64_t kMaxBlocks = 132 * 16;

int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// Replaces repro/kernels/pull_scatter_ms_packed.py::pull_scatter_ms_packed
// (Pallas: one grid of n_rows + N_q*tau steps, an init copy of v then, per
// slot e = q*tau + j, the slot's pulled row ORed into out[rows[e]] in a live
// output block; correct only because TPU grid steps run in order on one
// core).  Here the wrapper copies v into a fresh out, and one thread per
// (slot, word) i = e*kw + w (a grid-stride loop) computes
//   word = OR_{b : bit_b(masks[e])} f[v2r[e / tau], b, w]
// and ORs it in with atomicOr: OR is commutative and idempotent, so
// duplicate rows combine exactly in any order.  A zero mask reads no
// frontier word and a zero word costs no atomic.  Consecutive threads take
// the kw words of one slot, so the atomics of a slot land on one row's
// consecutive words.  rows are int64 (the port's row_ids) and must lie in
// [0, n_rows), v2r in [0, num_sets_ext): both are read unchecked.
__global__ void pull_scatter_ms_packed_kernel(
    uint32_t* __restrict__ out, const uint8_t* __restrict__ masks,
    const uint32_t* __restrict__ f, const int32_t* __restrict__ v2r,
    const int64_t* __restrict__ rows, int64_t t, int tau, int sigma, int kw) {
  const unsigned sigma_bits = (1u << sigma) - 1u;
  const int64_t total = t * kw;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int64_t e = i / kw;
    const int w = static_cast<int>(i - e * kw);
    const unsigned m = masks[e] & sigma_bits;
    if (m == 0) continue;
    const uint32_t* fq = f + static_cast<int64_t>(v2r[e / tau]) * sigma * kw;
    const uint32_t word = blest::or_pull_word(m, fq, kw, w);
    if (word) atomicOr(out + rows[e] * kw + w, word);
  }
}

// Replaces repro/kernels/pull_mma_ms_packed.py::pull_scatter_mma_ms_packed
// (Pallas: the fused grid of pull_scatter_ms_packed with each slot's mark
// row computed on the MXU as a (1, sigma) x (sigma, kappa) int8 product of
// the slot's mask plane row and the unpacked frontier planes, thresholded
// and packed).  Here: kernel 8's scatter, one thread per (slot, word), with
// the word computed as that product by blest::mma_word (the scalar form of
// pull_mma_ms_packed); each slot is thresholded on its own (count > 0), then
// ORed in, as the TPU kernel does.  A slot whose weights are all zero reads
// no frontier word; a zero word costs no atomic.  Pad tiles of
// prep_mma_tiles have zero planes, so they scatter nothing.
__global__ void pull_scatter_mma_ms_packed_kernel(
    uint32_t* __restrict__ out, const int8_t* __restrict__ a_planes,
    const uint32_t* __restrict__ f, const int32_t* __restrict__ v2r,
    const int64_t* __restrict__ rows, int64_t t, int tau, int sigma, int kw) {
  const int64_t total = t * kw;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int64_t e = i / kw;
    const int w = static_cast<int>(i - e * kw);
    const uint32_t* fq = f + static_cast<int64_t>(v2r[e / tau]) * sigma * kw;
    const uint32_t word = blest::mma_word(a_planes + e * sigma, sigma, fq, kw,
                                          w);
    if (word) atomicOr(out + rows[e] * kw + w, word);
  }
}

// Replaces repro/kernels/pull_ms_packed_queued.py::pull_ms_packed_queued
// (Pallas: one grid step per queued VSS, its mask row and its parent's
// frontier tile selected by scalar-prefetched index maps through qids and
// v2r[qids]).  Here block i loads q = qids[i] and v2r[q] itself (the double
// indirection), then one thread per output word (j, w):
//   marks[i, j, w] = OR_{b : bit_b(masks[q, j])} f[v2r[q], b, w]
// Bound: bytes (the (B, tau, kw) marks written).  Bucket padding names the
// pad VSS (zero masks), so its rows read no frontier word and write zeros.
__global__ void pull_ms_packed_queued_kernel(const uint8_t* __restrict__ masks,
                                             const uint32_t* __restrict__ f,
                                             const int32_t* __restrict__ v2r,
                                             const int32_t* __restrict__ qids,
                                             uint32_t* __restrict__ marks,
                                             int tau, int sigma, int kw) {
  const int64_t i = blockIdx.x;
  const int64_t q = qids[i];
  const uint32_t* fq = f + static_cast<int64_t>(v2r[q]) * sigma * kw;
  const unsigned sigma_bits = (1u << sigma) - 1u;
  const int words = tau * kw;
  uint32_t* out = marks + i * words;
  for (int k = threadIdx.x; k < words; k += blockDim.x) {
    const int j = k / kw;
    out[k] = blest::or_pull_word(masks[q * tau + j] & sigma_bits, fq, kw,
                                 k % kw);
  }
}

}  // namespace

extern "C" {

int blest_pull_scatter_ms_packed(void* out, const void* masks, const void* f,
                                 const void* v2r, const void* rows, int64_t t,
                                 int tau, int sigma, int kw, void* stream) {
  pull_scatter_ms_packed_kernel<<<grid_for(t * kw), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), static_cast<const uint8_t*>(masks),
      static_cast<const uint32_t*>(f), static_cast<const int32_t*>(v2r),
      static_cast<const int64_t*>(rows), t, tau, sigma, kw);
  return static_cast<int>(cudaGetLastError());
}

int blest_pull_scatter_mma_ms_packed(void* out, const void* a_planes,
                                     const void* f, const void* v2r,
                                     const void* rows, int64_t t, int tau,
                                     int sigma, int kw, void* stream) {
  pull_scatter_mma_ms_packed_kernel<<<grid_for(t * kw), kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), static_cast<const int8_t*>(a_planes),
      static_cast<const uint32_t*>(f), static_cast<const int32_t*>(v2r),
      static_cast<const int64_t*>(rows), t, tau, sigma, kw);
  return static_cast<int>(cudaGetLastError());
}

int blest_pull_ms_packed_queued(const void* masks, const void* f,
                                const void* v2r, const void* qids, void* marks,
                                int64_t b, int tau, int sigma, int kw,
                                void* stream) {
  pull_ms_packed_queued_kernel<<<static_cast<unsigned>(b), kTileThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(masks), static_cast<const uint32_t*>(f),
      static_cast<const int32_t*>(v2r), static_cast<const int32_t*>(qids),
      static_cast<uint32_t*>(marks), tau, sigma, kw);
  return static_cast<int>(cudaGetLastError());
}

const char* blest_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
