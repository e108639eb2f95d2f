// Single-source BLEST kernels for Hopper (sm_90a): the Stage-1 pull in its
// byte and packed-word layouts, the packed pull fused with its scatter into
// V_next (the pull-scatter), and the fused Stage-2 frontier sweep.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes.  Every entry point takes
// device pointers and a cudaStream_t, launches on that stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError() so that the
// Python wrapper can raise on a refused launch.
//
// What bounds them: all four are integer passes that do a few ALU
// operations per byte they move, so device-memory bandwidth bounds them
// (bytes moved / 3.35 TB/s on an H100 SXM).  Consecutive threads touch
// consecutive bytes or words, so every warp's loads and stores coalesce,
// and each input is read once and each output written once.  The byte
// pull and the sweep take 16-byte items (their notes below); the packed
// pull a 32-bit word a thread on a grid-stride loop over a grid of a few
// blocks per SM.  The ragged edge is masked by the loop bound; nothing is
// padded.

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
// tile per grid step):
//   marks[v, l] = (masks[v, l] & alphas[v]) != 0
// exact on any byte values.
//
// What bounds it: device-memory bytes, 2 tau + 1 a VSS (masks in, marks
// out, one alpha): 207.2 MB at kron-22 (N_v = 806,384, tau = 128).  The
// first port ran a thread per byte (a byte load, a byte store and a 64-bit
// division i / tau each) on a grid capped at 132 x 16 blocks: issue-bound
// at 27% of the byte bound.
//
// Design.  Where tau % 16 == 0 and masks and marks are 16-byte aligned
// (every call of the BFS drivers: tau = 128, fresh tensors), the item
// kernel runs.  An item is 16 consecutive mask bytes of one row (tau % 16
// == 0, so no item straddles two rows).  A thread takes kPullItems items
// kPullThreads apart, so each warp access covers 512 contiguous bytes; it
// issues every item's 16-byte read-only load and alpha byte first, then
// makes each item's four words with the packed pull's carry trick against
// the alpha broadcast to four bytes, then issues the 16-byte streaming
// stores.  An item's row is i >> kShift (tau = 16 << kShift a template
// argument for tau in {16, 32, 64, 128}) or one 32-bit division by tau / 16
// otherwise; items are 32-bit, so the wrapper refuses masks of 2^31 items
// (32 GiB) or more.  The grid is one wave of resident blocks over the
// card's SMs (the occupancy API, once per instance), each looping over
// chunks of kPullThreads * kPullItems items; a smaller input launches a
// block a chunk.  Every other call (tau % 16 != 0, as the pool's tau in {1,
// 2, 4}; a pointer off 16 bytes, as a view with a storage offset) runs the
// byte kernel: a thread a byte on a grid-stride loop, its (row, column)
// advanced by the stride with no division a byte.  The launcher chooses per
// call; nothing is padded and nothing is written outside marks.
constexpr int kPullThreads = 256;
constexpr int kPullItems = 4;  // items a thread (PERF.md: by measurement)
constexpr int kPullItemBytes = 16;

// The byte kernel.
__global__ void pull_ss_bytes(const uint8_t* __restrict__ masks,
                              const uint8_t* __restrict__ alphas,
                              uint8_t* __restrict__ marks, int64_t total,
                              int64_t tau) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int64_t row = i / tau, col = i - row * tau;
  const int64_t step_rows = stride / tau, step_cols = stride - step_rows * tau;
  for (; i < total; i += stride) {
    marks[i] = (masks[i] & alphas[row]) != 0;
    row += step_rows;
    col += step_cols;
    if (col >= tau) {
      col -= tau;
      ++row;
    }
  }
}

// Per byte of m: 1 where (byte & alpha) != 0, else 0 (a4: alpha in every
// byte).  The high bit of ((t & 0x7f) + 0x7f) | t is set iff t != 0.
__device__ __forceinline__ uint32_t pull_word(uint32_t m, uint32_t a4) {
  const uint32_t t = m & a4;
  const uint32_t nz = ((t & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | t;
  return (nz >> 7) & 0x01010101u;
}

// The item kernel; kShift = log2(tau / 16), or -1 for a run-time row_items
// = tau / 16.
template <int kShift>
__global__ void __launch_bounds__(kPullThreads)
    pull_ss_items(const uint4* __restrict__ masks,
                  const uint8_t* __restrict__ alphas,
                  uint4* __restrict__ marks, uint32_t items,
                  uint32_t row_items) {
  constexpr uint32_t kChunk = kPullThreads * kPullItems;
  for (uint32_t i0 = blockIdx.x * kChunk + threadIdx.x; i0 < items;
       i0 += gridDim.x * kChunk) {
    uint4 m[kPullItems];
    uint32_t a[kPullItems];
#pragma unroll
    for (int k = 0; k < kPullItems; ++k) {
      const uint32_t i = i0 + k * kPullThreads;
      m[k] = make_uint4(0, 0, 0, 0);
      a[k] = 0;
      if (i < items) {
        uint32_t row;
        if constexpr (kShift >= 0) {
          row = i >> kShift;
        } else {
          row = i / row_items;
        }
        m[k] = __ldg(masks + i);
        a[k] = __ldg(alphas + row);
      }
    }
#pragma unroll
    for (int k = 0; k < kPullItems; ++k) {
      const uint32_t i = i0 + k * kPullThreads;
      if (i < items) {
        const uint32_t a4 = a[k] * 0x01010101u;
        __stcs(marks + i,
               make_uint4(pull_word(m[k].x, a4), pull_word(m[k].y, a4),
                          pull_word(m[k].z, a4), pull_word(m[k].w, a4)));
      }
    }
  }
}

// Blocks of `kernel` resident on the whole card at once: one wave.
template <typename Kernel>
int64_t wave_blocks(Kernel kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  const int64_t wave = static_cast<int64_t>(sms) * per_sm;
  return wave > 0 ? wave : 1;  // a failed query shows at the launch check
}

template <int kShift>
void launch_pull_items(const uint8_t* masks, const uint8_t* alphas,
                       uint8_t* marks, int64_t items, int64_t row_items,
                       cudaStream_t st) {
  static const int64_t wave = wave_blocks(pull_ss_items<kShift>,
                                          kPullThreads);
  const int64_t chunks = (items + kPullThreads * kPullItems - 1)
                         / (kPullThreads * kPullItems);
  pull_ss_items<kShift>
      <<<static_cast<unsigned>(chunks < wave ? chunks : wave), kPullThreads,
         0, st>>>(reinterpret_cast<const uint4*>(masks), alphas,
                  reinterpret_cast<uint4*>(marks),
                  static_cast<uint32_t>(items),
                  static_cast<uint32_t>(row_items));
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

// The pull-scatter: kernel 2's pull and the combine of its marks into
// V_next in one pass.  It stands for repro/kernels/pull_ss.py::
// pull_ss_packed followed by repro/core/blest.py's XLA max-scatter, and on
// the port's packed single-source levels it replaces kernel 2 above,
// core/blest.py's torch scatter_reduce amax (a 32-bit CAS loop a slot) and
// its eager visited gather.  With v_next a copy of v_curr on entry, for each
// slot s (byte b of word i, VSS v = i / words):
//   mark = (byte b of masks[i]) & f_words[v2r[v]] != 0
//   mark and v_next[rows[s]] == 0  ->  v_next[rows[s]] = 1
// On 0/1 bytes the max the scatter took is this store of 1: every writer of
// a byte writes the same value, so there are no atomics and no combine
// pass, the marks never reach memory, and a byte store leaves its
// neighbours as they are.  The one instance is both update mechanics:
// V_next starts as V and only gains 1s, so a row V has visited reads 1 in
// V_next and is not stored, which is all that eager's (Alg. 2) filter on V
// did, and the V_next lazy (Alg. 3) gives is the same.  A slot with a zero
// mask (padding; its row is spread over n_ext) marks nothing, so its row is
// never read; a padding VSS points at the sentinel set, whose frontier word
// is 0.
//
// What bounds it: device-memory bytes.  v2r once (4 bytes a VSS, which its
// words share through the cache) and the frontier words; the masks of the
// VSSs with a nonzero alpha (tau bytes each); 16 bytes of rows for each
// word with a mark (4 a slot); the byte reads and stores of V_next, n_ext
// bytes, which stay in L2.  A thin level reads little more than v2r; one
// where every slot marks reads 5 tau + 4 bytes a VSS.  A hub's row is marked by many VSSs: stored by each, those
// stores met at one address in L2 and took the fat levels of a scale-free
// graph two to three times as long as reading the byte first and storing
// only a 0 does (PERF.md §6).
//
// Design.  A thread takes kScatterWords words kScatterThreads apart in a
// chunk of kScatterThreads * kScatterWords, on a loop over chunks with one
// wave of resident blocks (as the byte pull).  At tau = 128 a VSS is 32
// words, so a warp's words share one VSS and its alpha, and a warp whose
// alpha is zero (a VSS outside the frontier: most of a thin level's) loads
// neither masks nor rows.  Each stage issues its loads for all of a
// thread's words before any is used: v2r, the frontier words, the masks of
// the words with a nonzero alpha, the rows of the words with a mark (one
// 16-byte load, four slots; the wrapper hands 16-byte aligned rows), then
// for each marked slot the byte of V_next and, where it is 0, the store.
// A word's VSS is i >> shift where words is a power of two, else one 32-bit
// division; indices are 32-bit, so the launcher refuses 2^31 words or
// more.  kScatterWords = 4 by measurement
// (PERF.md §6: 2, 8 and 16 were no faster).
constexpr int kScatterThreads = 256;
constexpr int kScatterWords = 4;  // words a thread

__device__ __forceinline__ int32_t int4_lane(const int4& r, int b) {
  return b == 0 ? r.x : b == 1 ? r.y : b == 2 ? r.z : r.w;
}

__global__ void __launch_bounds__(kScatterThreads)
    pull_scatter_ss_packed_kernel(uint8_t* __restrict__ v_next,
                                  const uint32_t* __restrict__ masks,
                                  const uint8_t* __restrict__ f_words,
                                  const int32_t* __restrict__ v2r,
                                  const int4* __restrict__ rows,
                                  uint32_t total, uint32_t words, int shift) {
  constexpr uint32_t kChunk = kScatterThreads * kScatterWords;
  for (uint32_t i0 = blockIdx.x * kChunk + threadIdx.x; i0 < total;
       i0 += gridDim.x * kChunk) {
    int32_t set[kScatterWords];
#pragma unroll
    for (int k = 0; k < kScatterWords; ++k) {
      const uint32_t i = i0 + k * kScatterThreads;
      set[k] = i < total ? __ldg(v2r + (shift >= 0 ? i >> shift : i / words))
                         : -1;
    }
    uint32_t alpha[kScatterWords];
#pragma unroll
    for (int k = 0; k < kScatterWords; ++k) {
      alpha[k] = set[k] >= 0 ? __ldg(f_words + set[k]) * 0x01010101u : 0u;
    }
    // per word, the high bit of each byte whose slot marks
    uint32_t hit[kScatterWords];
#pragma unroll
    for (int k = 0; k < kScatterWords; ++k) {
      hit[k] = 0;
      if (alpha[k]) {
        const uint32_t t = __ldg(masks + i0 + k * kScatterThreads) & alpha[k];
        hit[k] = (((t & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | t) & 0x80808080u;
      }
    }
    int4 r[kScatterWords];
#pragma unroll
    for (int k = 0; k < kScatterWords; ++k) {
      r[k] = hit[k] ? __ldg(rows + i0 + k * kScatterThreads)
                    : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kScatterWords; ++k) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (!(hit[k] & (0x80u << (8 * b)))) continue;
        const int32_t row = int4_lane(r[k], b);
        // a row already set is not stored again: a hub's row is read by
        // every VSS that marks it, and stored by the first few (a stale 0
        // from the cache costs one more store of 1, never a wrong byte)
        if (v_next[row] == 0) v_next[row] = 1;
      }
    }
  }
}

// Replaces repro/kernels/frontier_sweep.py::frontier_sweep (Pallas: a
// (BLK_N,) tile of each input per grid step, ell by scalar prefetch).  Per
// slice set s of sigma vertices u = s * sigma + b:
//   diff[u]     = v_next[u] & (1 - v_curr[u])     (uint8 arithmetic)
//   level'[u]   = diff[u] ? ell : level[u]
//   f_words[s]  = uint8(sum_b diff[u] << b),  active[s] = (that sum) != 0
//   v_out[u]    = v_next[u]
// exact on any byte values, as the reference is (the sum is int32, all
// terms >= 0).  ell is a kernel argument.
//
// What bounds it: device-memory bytes, 11 + 2 / sigma a vertex (v_curr,
// v_next, v_out, 4-byte level in and out, a frontier and an activity byte
// a set): 47.2 MB at kron-22, 11.8 MB at road-20.  The first port ran a
// thread per slice set with sigma single-byte loads and stores, strided by
// sigma across the warp, and the int32 level in 4-byte pieces 32 bytes
// apart: a quarter of the bandwidth.
//
// Design.  A thread owns an item of kSweepItem = 16 consecutive vertices,
// 16 / sigma whole slice sets (sigma divides 16), so no two threads write
// one vertex and there are no atomics.  It makes one 16-byte load each of
// v_curr and v_next and four of level, the same per-vertex arithmetic in
// registers, byte by byte (sigma a template argument, so every index is a
// constant), then one 16-byte store of v_out, four of level', and one store
// of 16 / sigma bytes each of f_words and active (2 bytes at sigma = 8).
// A thread an item, no grid-stride loop: road-20's 1,048,584 vertices are
// 65,536 items and the tail's set in 513 blocks of 128 threads, 3.9 on
// each of the H100's 132 SMs, all resident at once, six 16-byte loads in
// flight a thread.  The tail (n % 16 vertices, whole sets, since sigma
// divides n) goes to the thread after the last item, vertex by vertex; a
// call where any pointer is off the alignment its vector accesses need (a
// view with a storage offset) runs the per-vertex kernel over every set
// instead.  Nothing is padded.
//
// Two instances of each kernel: ell a kernel argument (the per-level host
// loops), or ell read from a device int32 (kDevEll; blest_frontier_sweep_dev),
// which a captured CUDA graph of a level needs: a replay launches the
// arguments it was captured with, so a level number that changes from
// replay to replay has to live in device memory.  Each thread loads it once
// (one address for the whole grid, served by the cache); the item and byte
// maps are the same in both instances.
constexpr int kSweepThreads = 128;
constexpr int kSweepItem = 16;  // vertices an item

// Slice sets [s0, s1), vertex by vertex (the tail and the unaligned path).
__device__ __forceinline__ void sweep_sets(
    const uint8_t* __restrict__ v_curr, const uint8_t* __restrict__ v_next,
    const int32_t* __restrict__ level, uint8_t* __restrict__ v_out,
    int32_t* __restrict__ level_out, uint8_t* __restrict__ f_words,
    uint8_t* __restrict__ active, int64_t s0, int64_t s1, int sigma,
    int32_t ell) {
  for (int64_t s = s0; s < s1; ++s) {
    int32_t word = 0;
    for (int b = 0; b < sigma; ++b) {
      const int64_t u = s * sigma + b;
      const uint8_t nxt = v_next[u];
      const uint8_t diff = nxt & static_cast<uint8_t>(1 - v_curr[u]);
      v_out[u] = nxt;
      level_out[u] = diff ? ell : level[u];
      word += static_cast<int32_t>(diff) << b;
    }
    f_words[s] = static_cast<uint8_t>(word);
    active[s] = word != 0;
  }
}

// The level of this call: the argument, or the device int32 at ell_dev.
template <bool kDevEll>
__device__ __forceinline__ int32_t sweep_ell(const int32_t* ell_dev,
                                             int32_t ell) {
  return kDevEll ? __ldg(ell_dev) : ell;
}

// The per-vertex kernel: a thread per slice set, on a grid-stride loop.
template <bool kDevEll>
__global__ void frontier_sweep_sets(const uint8_t* __restrict__ v_curr,
                                    const uint8_t* __restrict__ v_next,
                                    const int32_t* __restrict__ level,
                                    uint8_t* __restrict__ v_out,
                                    int32_t* __restrict__ level_out,
                                    uint8_t* __restrict__ f_words,
                                    uint8_t* __restrict__ active,
                                    int64_t num_sets, int sigma,
                                    const int32_t* __restrict__ ell_dev,
                                    int32_t ell_arg) {
  const int32_t ell = sweep_ell<kDevEll>(ell_dev, ell_arg);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       s < num_sets; s += stride) {
    sweep_sets(v_curr, v_next, level, v_out, level_out, f_words, active, s,
               s + 1, sigma, ell);
  }
}

// kSets bytes at p (kSets-byte aligned) as one store.
template <int kSets>
__device__ __forceinline__ void store_set_bytes(uint8_t* p,
                                                const uint32_t (&x)[kSets]) {
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < kSets; ++k) w[k / 4] |= (x[k] & 0xffu) << (8 * (k % 4));
  if (kSets == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if (kSets == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else if (kSets == 4) {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  } else {
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(w[0]);
  }
}

template <int kSigma, bool kDevEll>
__global__ void __launch_bounds__(kSweepThreads)
    frontier_sweep_items(const uint8_t* __restrict__ v_curr,
                         const uint8_t* __restrict__ v_next,
                         const int32_t* __restrict__ level,
                         uint8_t* __restrict__ v_out,
                         int32_t* __restrict__ level_out,
                         uint8_t* __restrict__ f_words,
                         uint8_t* __restrict__ active, int64_t items,
                         int64_t num_sets,
                         const int32_t* __restrict__ ell_dev,
                         int32_t ell_arg) {
  const int32_t ell = sweep_ell<kDevEll>(ell_dev, ell_arg);
  constexpr int kSets = kSweepItem / kSigma;  // slice sets an item
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kSweepThreads
                    + threadIdx.x;
  if (i >= items) {
    if (i == items) {  // the tail, whole sets
      sweep_sets(v_curr, v_next, level, v_out, level_out, f_words, active,
                 items * kSets, num_sets, kSigma, ell);
    }
    return;
  }
  const uint4 c4 = __ldg(reinterpret_cast<const uint4*>(v_curr) + i);
  const uint4 n4 = __ldg(reinterpret_cast<const uint4*>(v_next) + i);
  const int4* lp = reinterpret_cast<const int4*>(level) + 4 * i;
  int4 l4[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) l4[k] = __ldg(lp + k);
  const uint32_t cur[4] = {c4.x, c4.y, c4.z, c4.w};
  const uint32_t nxt[4] = {n4.x, n4.y, n4.z, n4.w};
  int32_t lv[16] = {l4[0].x, l4[0].y, l4[0].z, l4[0].w,
                    l4[1].x, l4[1].y, l4[1].z, l4[1].w,
                    l4[2].x, l4[2].y, l4[2].z, l4[2].w,
                    l4[3].x, l4[3].y, l4[3].z, l4[3].w};
  uint32_t word[kSets];
#pragma unroll
  for (int k = 0; k < kSets; ++k) word[k] = 0;
#pragma unroll
  for (int u = 0; u < kSweepItem; ++u) {
    const uint32_t c = (cur[u / 4] >> (8 * (u % 4))) & 0xffu;
    const uint32_t x = (nxt[u / 4] >> (8 * (u % 4))) & 0xffu;
    const uint32_t diff = x & ((1u - c) & 0xffu);  // uint8 arithmetic
    lv[u] = diff ? ell : lv[u];
    word[u / kSigma] += diff << (u % kSigma);
  }
  reinterpret_cast<uint4*>(v_out)[i] = n4;
  int4* lo = reinterpret_cast<int4*>(level_out) + 4 * i;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    lo[k] = make_int4(lv[4 * k], lv[4 * k + 1], lv[4 * k + 2], lv[4 * k + 3]);
  }
  uint32_t act[kSets];
#pragma unroll
  for (int k = 0; k < kSets; ++k) act[k] = word[k] != 0;
  store_set_bytes<kSets>(f_words + i * kSets, word);
  store_set_bytes<kSets>(active + i * kSets, act);
}

// Both instances' launcher: the per-vertex kernel where any pointer is off
// the alignment its vector accesses need, else the item kernel for sigma.
template <bool kDevEll>
int launch_frontier_sweep(const void* v_curr, const void* v_next,
                          const void* level, void* v_out, void* level_out,
                          void* f_words, void* active, int64_t num_sets,
                          int sigma, const int32_t* ell_dev, int32_t ell,
                          void* stream) {
  if (num_sets < 1 || (sigma != 1 && sigma != 2 && sigma != 4 && sigma != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto misaligned = [](const void* p, uintptr_t bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) != 0;
  };
  const uintptr_t set_bytes = kSweepItem / sigma;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* vc = static_cast<const uint8_t*>(v_curr);
  const auto* vn = static_cast<const uint8_t*>(v_next);
  const auto* lv = static_cast<const int32_t*>(level);
  auto* vo = static_cast<uint8_t*>(v_out);
  auto* lo = static_cast<int32_t*>(level_out);
  auto* fw = static_cast<uint8_t*>(f_words);
  auto* ac = static_cast<uint8_t*>(active);
  if (misaligned(vc, 16) || misaligned(vn, 16) || misaligned(lv, 16)
      || misaligned(vo, 16) || misaligned(lo, 16)
      || misaligned(fw, set_bytes) || misaligned(ac, set_bytes)) {
    frontier_sweep_sets<kDevEll><<<grid_for(num_sets), kThreads, 0, st>>>(
        vc, vn, lv, vo, lo, fw, ac, num_sets, sigma, ell_dev, ell);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t items = num_sets * sigma / kSweepItem;
  const bool tail = items * kSweepItem < num_sets * sigma;
  const int64_t blocks = (items + tail + kSweepThreads - 1) / kSweepThreads;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = sigma == 1   ? frontier_sweep_items<1, kDevEll>
                : sigma == 2 ? frontier_sweep_items<2, kDevEll>
                : sigma == 4 ? frontier_sweep_items<4, kDevEll>
                             : frontier_sweep_items<8, kDevEll>;
  kernel<<<static_cast<unsigned>(blocks), kSweepThreads, 0, st>>>(
      vc, vn, lv, vo, lo, fw, ac, items, num_sets, ell_dev, ell);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int blest_pull_ss(const void* masks, const void* alphas, void* marks,
                  int64_t n_v, int64_t tau, void* stream) {
  if (n_v < 1 || tau < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const uint8_t*>(masks);
  const auto* a = static_cast<const uint8_t*>(alphas);
  auto* out = static_cast<uint8_t*>(marks);
  const int64_t total = n_v * tau;
  if (tau % kPullItemBytes != 0
      || (reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(out))
             % kPullItemBytes != 0) {
    pull_ss_bytes<<<grid_for(total), kThreads, 0, st>>>(m, a, out, total,
                                                        tau);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t items = total / kPullItemBytes;
  const int64_t row_items = tau / kPullItemBytes;
  if (items > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  switch (row_items) {
    case 1: launch_pull_items<0>(m, a, out, items, row_items, st); break;
    case 2: launch_pull_items<1>(m, a, out, items, row_items, st); break;
    case 4: launch_pull_items<2>(m, a, out, items, row_items, st); break;
    case 8: launch_pull_items<3>(m, a, out, items, row_items, st); break;
    default: launch_pull_items<-1>(m, a, out, items, row_items, st);
  }
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

// v_next in place, a copy of V; rows 16-byte aligned, n_v * words below
// 2^31.
int blest_pull_scatter_ss_packed(void* v_next, const void* masks,
                                 const void* f_words, const void* v2r,
                                 const void* rows, int64_t n_v, int64_t words,
                                 void* stream) {
  const int64_t total = n_v * words;
  if (n_v < 1 || words < 1 || total > INT32_MAX
      || reinterpret_cast<uintptr_t>(rows) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int shift = -1;
  if ((words & (words - 1)) == 0) {
    for (shift = 0; (int64_t{1} << shift) < words; ++shift) {
    }
  }
  static const int64_t wave = wave_blocks(pull_scatter_ss_packed_kernel,
                                          kScatterThreads);
  const int64_t chunks = (total + kScatterThreads * kScatterWords - 1)
                         / (kScatterThreads * kScatterWords);
  pull_scatter_ss_packed_kernel<<<
      static_cast<unsigned>(chunks < wave ? chunks : wave), kScatterThreads,
      0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(v_next), static_cast<const uint32_t*>(masks),
      static_cast<const uint8_t*>(f_words), static_cast<const int32_t*>(v2r),
      static_cast<const int4*>(rows), static_cast<uint32_t>(total),
      static_cast<uint32_t>(words), shift);
  return static_cast<int>(cudaGetLastError());
}

int blest_frontier_sweep(const void* v_curr, const void* v_next,
                         const void* level, void* v_out, void* level_out,
                         void* f_words, void* active, int64_t num_sets,
                         int sigma, int ell, void* stream) {
  return launch_frontier_sweep<false>(v_curr, v_next, level, v_out, level_out,
                                      f_words, active, num_sets, sigma,
                                      nullptr, ell, stream);
}

// The same sweep with the level read from the device int32 at ell_dev.
int blest_frontier_sweep_dev(const void* v_curr, const void* v_next,
                             const void* level, void* v_out, void* level_out,
                             void* f_words, void* active, int64_t num_sets,
                             int sigma, const void* ell_dev, void* stream) {
  if (ell_dev == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_frontier_sweep<true>(v_curr, v_next, level, v_out, level_out,
                                     f_words, active, num_sets, sigma,
                                     static_cast<const int32_t*>(ell_dev), 0,
                                     stream);
}

const char* blest_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
