// Single-source BLEST kernels for Hopper (sm_90a): the Stage-1 pull in its
// byte and packed-word layouts, and the fused Stage-2 frontier sweep.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes.  Every entry point takes
// device pointers and a cudaStream_t, launches on that stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError() so that the
// Python wrapper can raise on a refused launch.
//
// What bounds them: all three are integer passes that do a few ALU
// operations per byte they move, so device-memory bandwidth bounds them
// (bytes moved / 3.35 TB/s on an H100 SXM).  The design meets that bound
// the simple way: consecutive threads touch consecutive bytes or words, so
// every warp's loads and stores coalesce, each input is read once and each
// output written once, and a grid-stride loop over a grid of a few blocks
// per SM keeps enough loads in flight.  The ragged edge is masked by the
// loop bound; nothing is padded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// 132 SMs x 16 blocks of 256 threads: enough resident warps to hide
// latency; larger inputs are covered by the grid-stride loops.
constexpr int64_t kMaxBlocks = 132 * 16;

int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// Replaces repro/kernels/pull_ss.py::pull_ss (Pallas, one (BLK_V, tau) byte
// tile per grid step).  One thread per output byte:
//   marks[v, l] = (masks[v, l] & alphas[v]) != 0
__global__ void pull_ss_kernel(const uint8_t* __restrict__ masks,
                               const uint8_t* __restrict__ alphas,
                               uint8_t* __restrict__ marks,
                               int64_t total, int64_t tau) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    marks[i] = (masks[i] & alphas[i / tau]) != 0;
  }
}

// Replaces repro/kernels/pull_ss.py::pull_ss_packed.  One thread per 32-bit
// word of four slices; per-byte nonzero by the carry trick, evaluated on
// uint32_t so that the add wraps by definition.
__global__ void pull_ss_packed_kernel(const uint32_t* __restrict__ masks,
                                      const uint8_t* __restrict__ alphas,
                                      uint32_t* __restrict__ marks,
                                      int64_t total, int64_t words) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const uint32_t a = static_cast<uint32_t>(alphas[i / words]) * 0x01010101u;
    const uint32_t t = masks[i] & a;
    const uint32_t nz = ((t & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | t;
    marks[i] = (nz >> 7) & 0x01010101u;
  }
}

// Replaces repro/kernels/frontier_sweep.py::frontier_sweep.  One thread per
// slice set s, owning vertices [s*sigma, (s+1)*sigma): no two threads write
// the same vertex, so no atomics.  ell is a kernel argument (the TPU kernel
// brings it in by scalar prefetch).
__global__ void frontier_sweep_kernel(const uint8_t* __restrict__ v_curr,
                                      const uint8_t* __restrict__ v_next,
                                      const int32_t* __restrict__ level,
                                      uint8_t* __restrict__ v_out,
                                      int32_t* __restrict__ level_out,
                                      uint8_t* __restrict__ f_words,
                                      uint8_t* __restrict__ active,
                                      int64_t num_sets, int sigma,
                                      int32_t ell) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       s < num_sets; s += stride) {
    int32_t word = 0;
    for (int b = 0; b < sigma; ++b) {
      const int64_t u = s * sigma + b;
      const uint8_t nxt = v_next[u];
      // uint8 arithmetic as in the reference: diff = v_next & (1 - v_curr)
      const uint8_t diff = nxt & static_cast<uint8_t>(1 - v_curr[u]);
      v_out[u] = nxt;
      level_out[u] = diff ? ell : level[u];
      word += static_cast<int32_t>(diff) << b;
    }
    f_words[s] = static_cast<uint8_t>(word);
    active[s] = word != 0;
  }
}

}  // namespace

extern "C" {

int blest_pull_ss(const void* masks, const void* alphas, void* marks,
                  int64_t n_v, int64_t tau, void* stream) {
  const int64_t total = n_v * tau;
  pull_ss_kernel<<<grid_for(total), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(masks), static_cast<const uint8_t*>(alphas),
      static_cast<uint8_t*>(marks), total, tau);
  return static_cast<int>(cudaGetLastError());
}

int blest_pull_ss_packed(const void* masks, const void* alphas, void* marks,
                         int64_t n_v, int64_t words, void* stream) {
  const int64_t total = n_v * words;
  pull_ss_packed_kernel<<<grid_for(total), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(masks), static_cast<const uint8_t*>(alphas),
      static_cast<uint32_t*>(marks), total, words);
  return static_cast<int>(cudaGetLastError());
}

int blest_frontier_sweep(const void* v_curr, const void* v_next,
                         const void* level, void* v_out, void* level_out,
                         void* f_words, void* active, int64_t num_sets,
                         int sigma, int ell, void* stream) {
  frontier_sweep_kernel<<<grid_for(num_sets), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(v_curr), static_cast<const uint8_t*>(v_next),
      static_cast<const int32_t*>(level), static_cast<uint8_t*>(v_out),
      static_cast<int32_t*>(level_out), static_cast<uint8_t*>(f_words),
      static_cast<uint8_t*>(active), num_sets, sigma, ell);
  return static_cast<int>(cudaGetLastError());
}

const char* blest_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
