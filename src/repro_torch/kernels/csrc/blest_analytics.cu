// Packed AND/popcount reductions of the graph-analytics kinds for Hopper
// (sm_90a): the multi-lane "any neighbour in the frontier" pull, the Luby
// local-minimum test, and the pairwise row-intersection popcount.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes.  Every entry point takes
// device pointers and a cudaStream_t, launches on that stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError() so that the
// Python wrapper can raise on a refused launch.
//
// None of the three replaces a Pallas kernel: the reference computes them
// as jitted XLA ops with lax.population_count (src/repro/core/components.py,
// mis.py, triangles.py), in forms that materialize an (n, kappa, words)
// intermediate or gather whole rows.  Here every kernel reads the packed
// symmetrized adjacency `rows` ((n_rows, words) u32, vertex u at word
// u / 32, bit u % 32) in place.
//
// What bounds them: device-memory bytes.  A and B read every row once and
// do a few ALU operations a word, so their bound is the rows' bytes over
// 3.35 TB/s (2 GiB at kron-17: 0.64 ms).  C reads row a for each of its
// pairs (from the L2 within a run of equal a) and row b where a is
// nonzero; its bound counts each row it names once.
// Design, the same for all three: a block of kThreads threads per row (A,
// B) or per pair (C); the threads walk the row in 16-byte loads (one u32
// word a thread where the row is not 16-byte aligned: words % 4 != 0 or a
// view), neighbouring threads on neighbouring addresses; a word that is 0
// costs nothing more, since the rows of a sparse graph are almost all
// zero words; the block reduces with a warp reduction and one shared word
// a warp.  Nothing is padded: the loop bound masks the ragged tail.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// OR of every thread's v, in every thread of the block.
__device__ __forceinline__ uint32_t block_or(uint32_t v) {
  __shared__ uint32_t part[kWarps];
  v = __reduce_or_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) r |= part[i];
  return r;
}

// Sum of every thread's v, in every thread of the block.
__device__ __forceinline__ uint32_t block_sum(uint32_t v) {
  __shared__ uint32_t part[kWarps];
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) r += part[i];
  return r;
}

// Calls f(word, index) for each u32 word of a row of `words` words, the
// threads of the block in turn: 16-byte loads where kVec.
template <bool kVec, typename F>
__device__ __forceinline__ void for_words(const uint32_t* __restrict__ row,
                                          int64_t words, F&& f) {
  if (kVec) {
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
    for (int64_t i = threadIdx.x; i < words / 4; i += kThreads) {
      const uint4 x = __ldg(row4 + i);
      if ((x.x | x.y | x.z | x.w) == 0) continue;
      f(x.x, 4 * i);
      f(x.y, 4 * i + 1);
      f(x.z, 4 * i + 2);
      f(x.w, 4 * i + 3);
    }
  } else {
    for (int64_t w = threadIdx.x; w < words; w += kThreads) {
      const uint32_t x = __ldg(row + w);
      if (x != 0) f(x, w);
    }
  }
}

// Kernel A.  Stands for repro/core/components.py::_pull_lanes (and, at
// kappa = 1, mis.py::_neighbours_of):
//   out[v, k] = any_w(rows[v, w] & fw[k, w]) != 0
// Two launches.  lane_masks_kernel turns the frontier inside out, a u32
// lane mask a vertex of each group of 32 lanes: lanes[g][u] bit k is bit u
// of fw[32 g + k] (every bit of the words, the tail too).  Then a block per
// (row v, lane group) walks the set bits u of the row's nonzero words and
// ORs lanes[g][u] in: one load a neighbour, as kernel B makes, where a
// test of each nonzero word against 32 lane words costs a warp
// instruction per lane for each thread that holds one.
__global__ void lane_masks_kernel(const uint32_t* __restrict__ fw,
                                  uint32_t* __restrict__ lanes,
                                  int64_t words, int kappa) {
  const int64_t bits = 32 * words;
  const int k0 = 32 * blockIdx.y;
  const int kn = kappa - k0 < 32 ? kappa - k0 : 32;
  for (int64_t u = blockIdx.x * static_cast<int64_t>(blockDim.x)
                   + threadIdx.x;
       u < bits; u += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    uint32_t m = 0;
    for (int k = 0; k < kn; ++k) {
      m |= ((__ldg(fw + (k0 + k) * words + (u >> 5)) >> (u & 31)) & 1u) << k;
    }
    lanes[blockIdx.y * bits + u] = m;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
lane_any_kernel(const uint32_t* __restrict__ rows,
                const uint32_t* __restrict__ lanes, uint8_t* __restrict__ out,
                int64_t words, int kappa) {
  const int64_t v = blockIdx.x;
  const int k0 = 32 * blockIdx.y;
  const int kn = kappa - k0 < 32 ? kappa - k0 : 32;
  const uint32_t* mask = lanes + blockIdx.y * 32 * words;
  uint32_t hit = 0;
  for_words<kVec>(rows + v * words, words, [&](uint32_t r, int64_t w) {
    while (r != 0) {
      hit |= __ldg(mask + 32 * w + (__ffs(r) - 1));
      r &= r - 1;
    }
  });
  hit = block_or(hit);
  const int t = threadIdx.x;
  if (t < kn) out[v * kappa + k0 + t] = (hit >> t) & 1u;
}

// Kernel B.  Stands for repro/core/mis.py::_local_min_round (one Luby
// round's winner test):
//   out[v] = no u with bit u of rows[v] & cand set has
//            key(u) < key(v),  key(u) = (prio[u] << 32) | u
// The reference walks the 64 key bits MSB first over (n, words) planes of
// still-tied neighbours; since keys are unique that is "some candidate
// neighbour has a smaller key", which this kernel tests straight: it walks
// the set bits of each nonzero word and compares the 64-bit keys.  A
// self-loop compares a key with itself, which is not smaller.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
luby_local_min_kernel(const uint32_t* __restrict__ rows,
                      const uint32_t* __restrict__ cand,
                      const uint32_t* __restrict__ prio,
                      uint8_t* __restrict__ out, int64_t words) {
  const int64_t v = blockIdx.x;
  const uint64_t key = (static_cast<uint64_t>(__ldg(prio + v)) << 32)
                       | static_cast<uint64_t>(v);
  bool lost = false;
  for_words<kVec>(rows + v * words, words, [&](uint32_t r, int64_t w) {
    uint32_t m = r & __ldg(cand + w);
    while (m != 0 && !lost) {
      const int64_t u = 32 * w + (__ffs(m) - 1);
      m &= m - 1;
      const uint64_t ku = (static_cast<uint64_t>(__ldg(prio + u)) << 32)
                          | static_cast<uint64_t>(u);
      lost = ku < key;
    }
  });
  lost = __syncthreads_or(lost);
  if (threadIdx.x == 0) out[v] = lost ? 0 : 1;
}

// Kernel C.  Stands for repro/core/triangles.py::_count_edge_intersections,
// _edge_intersection_counts and _vertex_triangles:
//   cnt[i] = sum_w popc(rows[a[i], w] & rows[b[i], w])
// A block per pair.  Row a is read whole, row b only where a's 16-byte
// chunk (or word) is nonzero; pairs come in CSR order, so the blocks of
// one run of equal a find its row in the L2.  No row is gathered: a padded
// pair names the zero row, which counts 0.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
and_popc_pairs_kernel(const uint32_t* __restrict__ rows,
                      const int64_t* __restrict__ a,
                      const int64_t* __restrict__ b,
                      int32_t* __restrict__ cnt, int64_t words) {
  const int64_t i = blockIdx.x;
  const uint32_t* ra = rows + __ldg(a + i) * words;
  const uint32_t* rb = rows + __ldg(b + i) * words;
  uint32_t acc = 0;
  if (kVec) {
    const uint4* ra4 = reinterpret_cast<const uint4*>(ra);
    const uint4* rb4 = reinterpret_cast<const uint4*>(rb);
    for (int64_t j = threadIdx.x; j < words / 4; j += kThreads) {
      const uint4 x = __ldg(ra4 + j);
      if ((x.x | x.y | x.z | x.w) == 0) continue;
      const uint4 y = __ldg(rb4 + j);
      acc += __popc(x.x & y.x) + __popc(x.y & y.y) + __popc(x.z & y.z)
             + __popc(x.w & y.w);
    }
  } else {
    for (int64_t w = threadIdx.x; w < words; w += kThreads) {
      const uint32_t x = __ldg(ra + w);
      if (x != 0) acc += __popc(x & __ldg(rb + w));
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) cnt[i] = static_cast<int32_t>(acc);
}

}  // namespace

extern "C" {

int blest_lane_any(const void* rows, const void* fw, void* lanes, void* out,
                   int64_t n, int64_t words, int kappa, void* stream) {
  const int groups = (kappa + 31) / 32;
  if (n < 1 || n > INT32_MAX || words < 1 || kappa < 1 || groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t mask_blocks = (32 * words + 255) / 256;
  lane_masks_kernel<<<dim3(static_cast<unsigned>(
                               mask_blocks < 132 * 8 ? mask_blocks : 132 * 8),
                           static_cast<unsigned>(groups)),
                      256, 0, s>>>(static_cast<const uint32_t*>(fw),
                                   static_cast<uint32_t*>(lanes), words,
                                   kappa);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>(groups));
  auto kernel = words % 4 == 0 && aligned16(rows) ? lane_any_kernel<true>
                                                  : lane_any_kernel<false>;
  kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(rows), static_cast<const uint32_t*>(lanes),
      static_cast<uint8_t*>(out), words, kappa);
  return static_cast<int>(cudaGetLastError());
}

int blest_luby_local_min(const void* rows, const void* cand, const void* prio,
                         void* out, int64_t n, int64_t words, void* stream) {
  if (n < 1 || n > INT32_MAX || words < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = words % 4 == 0 && aligned16(rows)
                    ? luby_local_min_kernel<true>
                    : luby_local_min_kernel<false>;
  kernel<<<static_cast<unsigned>(n), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const uint32_t*>(cand),
      static_cast<const uint32_t*>(prio), static_cast<uint8_t*>(out), words);
  return static_cast<int>(cudaGetLastError());
}

int blest_and_popc_pairs(const void* rows, const void* a, const void* b,
                         void* cnt, int64_t p, int64_t words, void* stream) {
  if (p < 1 || p > INT32_MAX || words < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = words % 4 == 0 && aligned16(rows)
                    ? and_popc_pairs_kernel<true>
                    : and_popc_pairs_kernel<false>;
  kernel<<<static_cast<unsigned>(p), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const int64_t*>(a),
      static_cast<const int64_t*>(b), static_cast<int32_t*>(cnt), words);
  return static_cast<int>(cudaGetLastError());
}

const char* blest_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
