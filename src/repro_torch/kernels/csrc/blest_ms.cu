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
// The packed gather pull and the MMA-operand pull are dense instances of
// ms_pull.cuh's template, on mask bytes and on int8 plane rows
// (blest_serve.cu has the queued one); the MMA-operand pull also has a
// binary tensor-core form here (blest_pull_mma_ms_packed_bmma).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ms_pull.cuh"
#include "ms_words.cuh"

namespace {

// pull_ms's launch geometry, here alone: 8 warps a block; a block takes a
// run of VSSs of kPullSlots slots (16 VSSs at tau = 128), fewer where their
// frontier tiles would pass kPullSmem bytes (at least one VSS).
constexpr int kPullThreads = 256;
constexpr int kPullWarps = kPullThreads / 32;
constexpr int kPullSlots = 2048;
constexpr int kPullSmem = 32 * 1024;
// scatter_or's launch geometry, here alone: 8 warps a block; a warp takes
// kScatterRuns consecutive runs of kScatterRun mark words (16 bytes a lane),
// so a block covers 4,096 words.
constexpr int kScatterThreads = 256;
constexpr int kScatterWarps = kScatterThreads / 32;
constexpr int kScatterRun = 128;
constexpr int kScatterRuns = 4;

// The run of VSSs a block of pull_ms takes.
int pull_vss_per_block(int tau, int sigma, int kappa) {
  const int runs = (kPullSlots + tau - 1) / tau;
  const int fit = kPullSmem / (sigma * kappa);
  return fit < 1 ? 1 : (runs < fit ? runs : fit);
}

// Byte k of the result is 1 where byte k of x is nonzero, else 0: the low
// seven bits carry into bit 7 (no carry leaves the byte), ORed with bit 7.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return ((((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) >> 7) & 0x01010101u;
}

// The exact marks of four lanes: byte k is (sum over the set bits b of m of
// int8(t[b * kappa + k])) > 0.  Even and odd bytes are summed in the two
// 16-bit halves of a word each, sign-extended ((x ^ 0x80) - 0x80 per half);
// |sum| <= 8 * 128 fits 16 bits.
__device__ __forceinline__ uint32_t exact_marks4(unsigned m, const uint8_t* t,
                                                 int kappa) {
  uint32_t even = 0, odd = 0;
  for (; m; m &= m - 1) {
    const uint32_t x =
        *reinterpret_cast<const uint32_t*>(t + (__ffs(m) - 1) * kappa);
    even = __vadd2(even, __vsub2((x & 0x00ff00ffu) ^ 0x00800080u,
                                 0x00800080u));
    odd = __vadd2(odd, __vsub2(((x >> 8) & 0x00ff00ffu) ^ 0x00800080u,
                               0x00800080u));
  }
  return (__vcmpgts2(even, 0) & 0x00010001u)
         | ((__vcmpgts2(odd, 0) & 0x00010001u) << 8);
}

// Replaces repro/kernels/pull_ms.py::pull_ms (Pallas: one VSS per grid step,
// its parent's (sigma, kappa) frontier tile fetched through a scalar-prefetch
// index map on v2r, the (tau, sigma) @ (sigma, kappa) int8 product on the
// MXU, then > 0):
//   marks[q, j, k] = (sum_{b < sigma} bit_b(masks[q, j]) * int8(f[v2r[q], b, k])) > 0
// What bounds it: device-memory bytes, almost all of them the (tau, kappa)
// marks written per VSS (kron-22 at kappa = 64: 6.6 GB of 6.98); the
// product's operations take far less at the int8 tensor-core rate, and this
// kernel needs no tensor core: the sum runs over a mask's set bits only
// (one or two at kron-22), so the work is a few instructions per 16 bytes
// written, and the design keeps it there.
//
// Design.  Block b takes the run of vpb VSSs from q0 = b * vpb
// (pull_vss_per_block; the last run may be shorter):
//  1. a warp per VSS of the run: lane 0 loads v2r[q] once, the warp copies
//     the parent's (sigma, kappa) tile into shared memory with 16-byte
//     loads; the block copies the run's mask bytes too, and learns with the
//     barrier (__syncthreads_or) whether any tile byte has bit 7 set;
//  2. the run's marks are nv * tau * kappa / 16 items of 16 bytes, item
//     it at byte 16 * it of the run's output: thread i takes items i,
//     i + 256, ..., its (VSS, slot, 16-lane group) stepped, never divided,
//     so consecutive threads store consecutive 16 bytes.  An item ORs the
//     16-byte tile rows of its mask's set bits (one shared load a bit) and
//     makes each byte 0/1 (nonzero_bytes), then stores 16 bytes once.
// Exactness: the reference sums the frontier bytes as signed int8.  Where no
// byte of the run's tiles has bit 7 set, every byte is >= 0, so the sum over
// set bits is > 0 exactly when their OR is nonzero; a run with a byte >= 128
// (only arbitrary bytes give one; BFS planes are 0/1) takes the exact sum,
// two bytes to a 32-bit word (exact_marks4).  A kappa that is no multiple of
// 16 (or an unaligned pointer) takes the byte path (kVec = false): the same
// run, an item a byte, the exact sum.  Equal to the reference on any bytes.
// v2r must lie in [0, num_sets_ext): it is read unchecked, as the TPU
// kernel reads it.
//
// Geometry: 256 threads, ptxas -v: 40 registers (16-byte path) and 31 (byte
// path), no spill; at kron-22 (kappa = 64) 16 VSSs a block, 10 KB of
// dynamic shared memory, 50,399 blocks.  tools/ab_ms_kernels.py prints the
// registers and times this kernel against the one it replaced; PERF.md
// has the numbers.
template <bool kVec>
__global__ void __launch_bounds__(kPullThreads)
    pull_ms_kernel(const uint8_t* __restrict__ masks,
                   const uint8_t* __restrict__ f_planes,
                   const int32_t* __restrict__ v2r,
                   uint8_t* __restrict__ marks, int64_t n_q, int tau,
                   int sigma, int kappa, int vpb) {
  extern __shared__ uint4 pull_mem[];  // (vpb, sigma, kappa) tiles, masks
  const int tile = sigma * kappa;
  uint8_t* tiles = reinterpret_cast<uint8_t*>(pull_mem);
  uint8_t* m_s = tiles + ((vpb * tile + 15) & ~15);  // (vpb, tau)
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * vpb;
  const int nv = n_q - q0 < vpb ? static_cast<int>(n_q - q0) : vpb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t high = 0;  // the OR of the bytes this thread copied
  for (int v = warp; v < nv; v += kPullWarps) {
    int p = 0;
    if (lane == 0) p = v2r[q0 + v];
    p = __shfl_sync(0xffffffffu, p, 0);
    const uint8_t* src = f_planes + static_cast<int64_t>(p) * tile;
    uint8_t* dst = tiles + v * tile;
    if (kVec) {
      for (int i = lane; i < tile / 16; i += 32) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(src) + i);
        high |= x.x | x.y | x.z | x.w;
        reinterpret_cast<uint4*>(dst)[i] = x;
      }
    } else {
      for (int i = lane; i < tile; i += 32) {
        const uint8_t x = __ldg(src + i);
        high |= x;
        dst[i] = x;
      }
    }
  }
  const unsigned sigma_bits = (1u << sigma) - 1u;
  const uint8_t* mq = masks + q0 * tau;
  for (int i = threadIdx.x; i < nv * tau; i += kPullThreads) {
    m_s[i] = mq[i] & sigma_bits;
  }
  const bool exact = __syncthreads_or((high & 0x80808080u) != 0) != 0;

  constexpr int kW = kVec ? 16 : 1;  // bytes an item
  const int groups = kappa / kW;     // items a slot
  const int per_vss = tau * groups;
  const int items = nv * per_vss;
  int g = threadIdx.x % groups;
  int j = (threadIdx.x / groups) % tau;
  int v = threadIdx.x / per_vss;
  const int dg = kPullThreads % groups, dj = (kPullThreads / groups) % tau;
  const int dv = kPullThreads / per_vss;
  uint8_t* out = marks + q0 * tau * kappa;
  for (int it = threadIdx.x; it < items; it += kPullThreads) {
    const unsigned m = m_s[v * tau + j];
    const uint8_t* t = tiles + v * tile + g * kW;
    if (kVec) {
      uint4 r;
      if (exact) {
        r = make_uint4(exact_marks4(m, t, kappa), exact_marks4(m, t + 4, kappa),
                       exact_marks4(m, t + 8, kappa),
                       exact_marks4(m, t + 12, kappa));
      } else {
        uint4 acc = make_uint4(0, 0, 0, 0);
        for (unsigned mm = m; mm; mm &= mm - 1) {
          const uint4 x =
              *reinterpret_cast<const uint4*>(t + (__ffs(mm) - 1) * kappa);
          acc.x |= x.x; acc.y |= x.y; acc.z |= x.z; acc.w |= x.w;
        }
        r = make_uint4(nonzero_bytes(acc.x), nonzero_bytes(acc.y),
                       nonzero_bytes(acc.z), nonzero_bytes(acc.w));
      }
      __stcs(reinterpret_cast<uint4*>(out) + it, r);
    } else {
      int acc = 0;
      for (unsigned mm = m; mm; mm &= mm - 1) {
        acc += static_cast<int8_t>(t[(__ffs(mm) - 1) * kappa]);
      }
      out[it] = acc > 0;
    }
    g += dg;
    if (g >= groups) {
      g -= groups;
      ++j;
    }
    j += dj;
    if (j >= tau) {
      j -= tau;
      ++v;
    }
    v += dv;
  }
}

// The binary tensor-core form of repro/kernels/pull_mma_ms_packed.py::
// pull_mma_ms_packed (:177), reachable from its own entry point
// (blest_pull_mma_ms_packed_bmma); the wrapper launches the template's
// plane-row instance, which was faster on the H100 at every shape measured
// (PERF.md).  One
// mma.sync.m8n8k128 .b1 .and.popc per 8 slots x 8 lanes:
//   marks[q, j, w] = pack_l( popc(A[q, j] & B[l]) > 0 )
// Layout, with no wasted outputs: K (128 bits) packs a group of
// G = 128 / sigma VSSs block-diagonally, VSS v of the group in bits
// [v * sigma, v * sigma + sigma).  The A row of slot j of VSS v holds the
// slot's positive-weight bits (blest::positive_bits of its plane row) in
// v's segment and zeros elsewhere; the B column of lane l holds bit l of
// the frontier words f[v2r[q], b, w] of every VSS of the group at bit
// v * sigma + b.  So every product is a needed (slot, lane) count, exact
// for weights without a negative one (count > 0 iff some positive weight's
// plane has the bit); a slot with a negative weight counts its words with
// the exact loop (blest::count_word), as the template does.
// What bounds it: device-memory bytes, as the template (the plane rows and
// the marks), unless the tensor cores and the packing of counts into words
// are slower: 413M mma at kron-22, each 64 counts to threshold and pack.
// On an H100 SXM it took 9.7 ms there against the template's 1.48, at
// 4.2e10 mma a second, a fifth of the 2.3e11 the instruction reaches on
// registers alone: the time goes around the mma, not into it.
//
// Design.  A block takes one group of G VSSs (16 at sigma = 8):
//  1. the group's parents, then their tiles, into shared memory; each
//     slot's plane row (one 8-byte load at sigma = 8) into a byte of its
//     positive weights and a negative-weight flag;
//  2. the bit transpose: K position p = v * sigma + b holds tile row
//     (v, b); a warp takes one (K word, frontier word) pair at a time: lane
//     i holds row 32 kk + i's word w, and 32 ballots give lane l the K word
//     of lane column 32 w + l, kept in the B fragment's order so that a
//     thread's four N tiles are one 16-byte shared load;
//  3. a warp per M tile of 8 consecutive slots of the group (they may span
//     VSSs: each row carries its own segment): its A fragment once, then
//     four frontier words at a time (two or one where kw is no multiple of
//     four), the B fragments of all, four mma a word (its 32 lanes, all
//     issued before any count is read), each thread's two counts > 0 of an
//     mma ORed into the word at its lanes, the word assembled across the
//     four threads of a row with two shuffles; a row's words go out as
//     16-byte stores where kw % 4 == 0 and marks is aligned, else one by
//     one.
// v2r must index f: it is read unchecked, as the TPU kernel reads it.
// Geometry: 256 threads, ptxas -v: 58 registers (4 words a step) and 52
// (2 or 1), no spill; at kron-22 50,399 blocks, 12 KB of dynamic shared
// memory.  tools/ab_sweep_mma.py times it against the template's instance
// and the instruction alone.
constexpr int kBmmaThreads = 256;
constexpr int kBmmaWarps = kBmmaThreads / 32;

__device__ __forceinline__ void bmma_and_popc(uint32_t a, uint32_t b,
                                              int& d0, int& d1) {
  asm("mma.sync.aligned.m8n8k128.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1}, {%2}, {%3}, {%4, %5};"
      : "=r"(d0), "=r"(d1)
      : "r"(a), "r"(b), "r"(0), "r"(0));
}

// Shared memory of a group of G VSSs: the B columns (32 * kw lanes of 4
// words), the tiles, the positive and flag bytes, the parents.
inline int64_t bmma_smem(int group, int tau, int sigma, int kw) {
  return 4 * (128 * int64_t{kw} + int64_t{group} * sigma * kw + group)
         + (2 * int64_t{group} * tau + 15) / 16 * 16;
}

template <int kStep>  // frontier words a step: 4, 2 or 1, dividing kw
__global__ void __launch_bounds__(kBmmaThreads)
    pull_mma_bmma_kernel(const int8_t* __restrict__ a_planes,
                         const uint32_t* __restrict__ f,
                         const int32_t* __restrict__ v2r,
                         uint32_t* __restrict__ marks, int64_t n_q, int tau,
                         int sigma, int kw) {
  extern __shared__ uint4 bmma_mem[];
  const int group = 128 / sigma;
  const int tile = sigma * kw;
  uint32_t* cols = reinterpret_cast<uint32_t*>(bmma_mem);  // 128 * kw
  uint32_t* tiles = cols + 128 * kw;                        // group * tile
  int32_t* par = reinterpret_cast<int32_t*>(tiles + group * tile);
  uint8_t* pos = reinterpret_cast<uint8_t*>(par + group);   // group * tau
  uint8_t* neg = pos + group * tau;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * group;
  const int nv = n_q - q0 < group ? static_cast<int>(n_q - q0) : group;
  const int slots = nv * tau;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // 1. parents, tiles (zero past nv), positive weights and flags
  for (int v = threadIdx.x; v < nv; v += kBmmaThreads) par[v] = v2r[q0 + v];
  __syncthreads();
  for (int i = threadIdx.x; i < group * tile; i += kBmmaThreads) {
    const int v = i / tile;
    tiles[i] = v < nv ? __ldg(f + static_cast<int64_t>(par[v]) * tile
                              + (i - v * tile))
                      : 0u;
  }
  const int8_t* aq = a_planes + q0 * tau * sigma;
  for (int s = threadIdx.x; s < slots; s += kBmmaThreads) {
    const uint64_t row = blest::plane_row(aq + static_cast<int64_t>(s) * sigma,
                                          sigma);
    pos[s] = blest::positive_bits(row);
    neg[s] = blest::has_negative(row);
  }
  __syncthreads();

  // 2. the bit transpose into B columns: cols[((w * 8 + g) * 4 + kk) * 4
  //    + nt] is K word kk of lane 8 nt + g of frontier word w
  const int kp = group * sigma;  // K positions in use (128 where sigma | 128)
  for (int task = warp; task < 4 * kw; task += kBmmaWarps) {
    const int kk = task & 3, w = task >> 2;
    const int p = 32 * kk + lane;
    const uint32_t r = p < kp ? tiles[p * kw + w] : 0u;
    uint32_t mine = 0;
    for (int l = 0; l < 32; ++l) {
      const uint32_t col = __ballot_sync(0xffffffffu, (r >> l) & 1u);
      if (lane == l) mine = col;
    }
    cols[((w * 8 + (lane & 7)) * 4 + kk) * 4 + (lane >> 3)] = mine;
  }
  __syncthreads();

  // 3. a warp per M tile of 8 slots, kStep frontier words at a time: their
  //    B fragments, then their 4 kStep mma, then the counts into words
  const int g = lane >> 2, t = lane & 3;
  const int mtiles = (slots + 7) / 8;
  uint32_t* out = marks + q0 * tau * kw;
  const bool vec =
      kStep == 4 && (reinterpret_cast<uintptr_t>(marks) & 15u) == 0;
  for (int m = warp; m < mtiles; m += kBmmaWarps) {
    const int s = 8 * m + g;  // this thread's row
    uint32_t a = 0;
    if (s < slots) {
      const int seg = (s / tau) * sigma - 32 * t;  // v's segment, from word t
      const uint32_t ps = pos[s];
      a = seg >= 0 ? (seg < 32 ? ps << seg : 0u)
                   : (-seg < sigma ? ps >> -seg : 0u);
    }
    for (int w0 = 0; w0 < kw; w0 += kStep) {
      __syncwarp();  // converged for mma.sync.aligned and the shuffles
      uint4 b[kStep];
#pragma unroll
      for (int e = 0; e < kStep; ++e) {
        b[e] = *reinterpret_cast<const uint4*>(
            cols + (((w0 + e) * 8 + g) * 4 + t) * 4);
      }
      int d[kStep][8];  // N tile nt: columns 2 t and 2 t + 1 in 2 nt, + 1
#pragma unroll
      for (int e = 0; e < kStep; ++e) {
        bmma_and_popc(a, b[e].x, d[e][0], d[e][1]);
        bmma_and_popc(a, b[e].y, d[e][2], d[e][3]);
        bmma_and_popc(a, b[e].z, d[e][4], d[e][5]);
        bmma_and_popc(a, b[e].w, d[e][6], d[e][7]);
      }
      uint32_t r[kStep];
#pragma unroll
      for (int e = 0; e < kStep; ++e) {
        uint32_t bits = 0;  // lanes 8 nt + 2 t and + 1 of the word
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          bits |= d[e][c] > 0 ? 1u << (8 * (c / 2) + c % 2) : 0u;
        }
        r[e] = bits << (2 * t);
      }
#pragma unroll
      for (int e = 0; e < kStep; ++e) {
        r[e] |= __shfl_xor_sync(0xffffffffu, r[e], 1);
      }
#pragma unroll
      for (int e = 0; e < kStep; ++e) {
        r[e] |= __shfl_xor_sync(0xffffffffu, r[e], 2);
      }
      // r: row s's words w0 .. w0 + kStep - 1, in each of the row's four
      // threads; thread 0 of the row stores four as one 16-byte store, or
      // thread t word w0 + t
      if (s < slots && (vec ? t == 0 : t < kStep)) {
        const bool exact = neg[s] != 0;
        const int8_t* aj = aq + static_cast<int64_t>(s) * sigma;
        const uint32_t* tv = tiles + (s / tau) * tile;
        uint32_t* dst = out + static_cast<int64_t>(s) * kw + w0;
        if (vec) {
          if (exact) {
#pragma unroll
            for (int e = 0; e < kStep; ++e) {
              r[e] = blest::exact_word(aj, sigma, tv, kw, w0 + e);
            }
          }
          *reinterpret_cast<uint4*>(dst) =
              make_uint4(r[0], r[kStep > 1], r[kStep > 2 ? 2 : 0],
                         r[kStep > 3 ? 3 : 0]);
        } else {
          uint32_t x = r[0];
#pragma unroll
          for (int e = 1; e < kStep; ++e) x = t == e ? r[e] : x;
          dst[t] = exact ? blest::exact_word(aj, sigma, tv, kw, w0 + t) : x;
        }
      }
    }
  }
}

// Replaces repro/kernels/scatter_or.py::scatter_or (Pallas: a grid of
// n_rows + t steps, an init copy then one read-modify-write of out[rows[i]]
// per step, correct only because TPU grid steps run in order on one core).
// Blocks run in no order here, so the words are ORed in with atomics: OR is
// commutative and idempotent, so duplicate rows combine exactly whatever the
// order.  The wrapper copies dest into a fresh out first.
//   out[rows[i], w] |= marks[i, w]
// What bounds it: device-memory bytes (kron-22, kappa = 256: marks 3.30 GB,
// int32 rows 0.41 GB at most, out in and out 0.27 GB), then the L2 atomics
// of the scatter, one request per row's words where the warp's lanes sit on
// one row's consecutive words.
//
// Design.  The marks are read as one flat array of t * kw words, in runs of
// kScatterRun words: a warp takes kScatterRuns consecutive runs, loading
// each with one 16-byte load a lane (the next run's load issued before this
// run's atomics) into its staging row in shared memory; then lane l takes
// the run's items l, l + 32, ...: word pairs where kw is even (one 64-bit
// atomicOr a pair; a row starts 8-byte aligned, out being a fresh tensor),
// words where it is odd (one 32-bit atomicOr a word).  So consecutive lanes
// sit on consecutive words of one element, and a row's words go out in one
// warp instruction.  An item's element and word come from the run's first
// (stepped a run at a time) plus a per-lane offset computed once, never a
// division a word.  Only a lane whose pair or word is nonzero loads its
// element's int32 row and issues an atomic: an element whose words are all
// zero (most of road's, on a sparse frontier) costs its marks' read alone.
// rows must lie in [0, n_rows): they are read unchecked, as the pulls read
// v2r.
//
// Geometry: 256 threads, 4 KB of static shared memory, ptxas -v: 32
// registers (pairs) and 38 (words), no spill; 201,596 blocks at kron-22
// (kappa = 256).  With the atomics compiled out (a diagnostic of
// tools/ab_ms_kernels.py) the call runs at its byte bound; the atomics'
// read-modify-write of out, whose rows follow no order, takes the rest.
template <bool kPairs>
__global__ void __launch_bounds__(kScatterThreads)
    scatter_or_kernel(uint32_t* __restrict__ out,
                      const int32_t* __restrict__ rows,
                      const uint32_t* __restrict__ marks, int64_t t, int kw) {
  __shared__ uint4 stage[kScatterWarps][32];
  constexpr int kSpan = kPairs ? 2 : 1;                 // words an item
  constexpr int kItems = kScatterRun / (32 * kSpan);    // a lane's, a run
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t n = t * kw;
  int64_t r0 = (static_cast<int64_t>(blockIdx.x) * kScatterWarps + warp)
               * (kScatterRun * kScatterRuns);
  if (r0 >= n) return;
  // the run's first word is word w0 of element s0
  int64_t s0 = r0 / kw;
  int w0 = static_cast<int>(r0 - s0 * kw);
  const int rq = kScatterRun / kw, rr = kScatterRun % kw;
  int dq[kItems], dr[kItems];  // item k's offset: dq[k] elements, dr[k] words
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int o = kSpan * (lane + 32 * k);
    dq[k] = o / kw;
    dr[k] = o - dq[k] * kw;
  }
  const bool vec = (reinterpret_cast<uintptr_t>(marks) & 15u) == 0;
  auto load = [&](int64_t r) {  // words r + 4 lane .. + 3, zero past n
    const int64_t i = r + 4 * lane;
    if (vec && i + 4 <= n) {
      return __ldcs(reinterpret_cast<const uint4*>(marks + i));
    }
    uint4 x = make_uint4(0, 0, 0, 0);
    if (i < n) x.x = __ldcs(marks + i);
    if (i + 1 < n) x.y = __ldcs(marks + i + 1);
    if (i + 2 < n) x.z = __ldcs(marks + i + 2);
    if (i + 3 < n) x.w = __ldcs(marks + i + 3);
    return x;
  };
  uint4 next = load(r0);
  for (int run = 0; run < kScatterRuns; ++run) {
    stage[warp][lane] = next;
    if (run + 1 < kScatterRuns && r0 + kScatterRun < n) {
      next = load(r0 + kScatterRun);
    }
    __syncwarp();
    const uint32_t* words = reinterpret_cast<const uint32_t*>(stage[warp]);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int o = kSpan * (lane + 32 * k);
      const unsigned long long x =
          kPairs ? *reinterpret_cast<const unsigned long long*>(words + o)
                 : words[o];
      if (x) {
        int64_t s = s0 + dq[k];
        int w = w0 + dr[k];
        if (w >= kw) {
          w -= kw;
          ++s;
        }
        uint32_t* dst = out + static_cast<int64_t>(rows[s]) * kw + w;
        if (kPairs) {
          atomicOr(reinterpret_cast<unsigned long long*>(dst), x);
        } else {
          atomicOr(dst, static_cast<uint32_t>(x));
        }
      }
    }
    __syncwarp();
    r0 += kScatterRun;
    if (r0 >= n) break;
    s0 += rq;
    w0 += rr;
    if (w0 >= kw) {
      w0 -= kw;
      ++s0;
    }
  }
}

}  // namespace

extern "C" {

int blest_pull_ms(const void* masks, const void* f_planes, const void* v2r,
                  void* marks, int64_t n_q, int tau, int sigma, int kappa,
                  void* stream) {
  if (n_q < 1 || tau < 1 || sigma < 1 || sigma > 8 || kappa < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vpb = pull_vss_per_block(tau, sigma, kappa);
  const int64_t blocks = (n_q + vpb - 1) / vpb;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = ((vpb * sigma * kappa + 15) & ~15) + vpb * tau;
  const bool vec = kappa % 16 == 0
                   && (reinterpret_cast<uintptr_t>(f_planes) & 15u) == 0
                   && (reinterpret_cast<uintptr_t>(marks) & 15u) == 0;
  auto kernel = vec ? pull_ms_kernel<true> : pull_ms_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), kPullThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(masks), static_cast<const uint8_t*>(f_planes),
      static_cast<const int32_t*>(v2r), static_cast<uint8_t*>(marks), n_q, tau,
      sigma, kappa, vpb);
  return static_cast<int>(cudaGetLastError());
}

int blest_pull_ms_packed(const void* masks, const void* f, const void* v2r,
                         void* marks, int64_t n_q, int tau, int sigma, int kw,
                         void* stream) {
  return blest::launch_pull_ms_packed<false>(masks, f, v2r, nullptr, marks,
                                             n_q, tau, sigma, kw, stream);
}

// The run of VSSs a block of either packed pull takes over n_q VSSs
// (ms_pull.cuh).
int blest_packed_vss_per_block(int64_t n_q, int tau, int sigma, int kw) {
  if (n_q < 1 || tau < 1 || sigma < 1 || sigma > 8 || kw < 1) return 0;
  return blest::packed_vss_per_block(n_q, tau, sigma, kw);
}

// The MMA-operand pull (kernel 7): the template's plane-row instance.
int blest_pull_mma_ms_packed(const void* a_planes, const void* f,
                             const void* v2r, void* marks, int64_t n_q,
                             int tau, int sigma, int kw, void* stream) {
  return blest::launch_pull_ms_packed<false, true>(
      a_planes, f, v2r, nullptr, marks, n_q, tau, sigma, kw, stream);
}

// Kernel 7's binary tensor-core form, a block per group of 128 / sigma VSSs.
int blest_pull_mma_ms_packed_bmma(const void* a_planes, const void* f,
                                  const void* v2r, void* marks, int64_t n_q,
                                  int tau, int sigma, int kw, void* stream) {
  if (n_q < 1 || tau < 1 || sigma < 1 || sigma > 8 || kw < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = 128 / sigma;
  const int64_t blocks = (n_q + group - 1) / group;
  const int64_t smem = bmma_smem(group, tau, sigma, kw);
  if (blocks > INT32_MAX || smem > 227 * 1024
      || int64_t{group} * tau * kw > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = kw % 4 == 0   ? pull_mma_bmma_kernel<4>
                : kw % 2 == 0 ? pull_mma_bmma_kernel<2>
                              : pull_mma_bmma_kernel<1>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), kBmmaThreads,
           static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a_planes), static_cast<const uint32_t*>(f),
      static_cast<const int32_t*>(v2r), static_cast<uint32_t*>(marks), n_q,
      tau, sigma, kw);
  return static_cast<int>(cudaGetLastError());
}

int blest_scatter_or(void* out, const void* rows, const void* marks,
                     int64_t t, int kw, void* stream) {
  constexpr int64_t kWords = int64_t{kScatterWarps} * kScatterRun
                             * kScatterRuns;  // a block's
  if (t < 1 || kw < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (t * kw + kWords - 1) / kWords;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = kw % 2 == 0 ? scatter_or_kernel<true>
                            : scatter_or_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), kScatterThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), static_cast<const int32_t*>(rows),
      static_cast<const uint32_t*>(marks), t, kw);
  return static_cast<int>(cudaGetLastError());
}

const char* blest_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
