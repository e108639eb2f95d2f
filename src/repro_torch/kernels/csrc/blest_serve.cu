// Serve-engine kernels for Hopper (sm_90a): the dense packed level with the
// pull fused into the OR-scatter, in its selective-OR and its MMA-operand
// form, and the packed pull over a queued list of active VSSs (the engine's
// per-level dense/queued sweeps, kappa lanes of 32-bit words).
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes.  Every entry point takes
// device pointers and a cudaStream_t, launches on that stream, allocates
// nothing, does not synchronise, and returns the launch's cudaError_t so
// that the Python wrapper can raise on a refused launch.  The queued pull
// is the queued instance of ms_pull.cuh's template (blest_ms.cu has the
// dense one); the MMA word code is ms_words.cuh's, shared with blest_ms.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ms_pull.cuh"
#include "ms_words.cuh"

namespace {

// The fused levels' launch geometry, here alone: a thread per slot, 8
// warps; a block takes a run of VSSs of kFusedSlots slots (32 VSSs at
// tau = 128), fewer where their frontier tiles would pass kFusedSmem bytes;
// a slot builds its words 8 at a time (kChunk).
constexpr int kFusedThreads = 256;
constexpr int kFusedWarps = kFusedThreads / 32;
constexpr int kFusedSlots = 4096;
constexpr int kChunk = 8;
constexpr int kFusedSmem = 32 * 1024;  // + 9 KB of staging: under 48 KB
constexpr int kFusedMinBlocks = 6;     // 48 warps an SM: <= 40 registers

// Tile row stride in words: kw rounded up to a chunk (the pad is zero).
__host__ __device__ inline int fused_kwp(int kw) {
  return (kw + kChunk - 1) / kChunk * kChunk;
}

// The run of VSSs a block takes, or 0 when one VSS's tile does not fit.
int fused_vss_per_block(int tau, int sigma, int kw) {
  if (tau < 1 || sigma < 1 || sigma > 8 || kw < 1 || kw > kFusedSmem) {
    return 0;
  }
  const int tile = 4 * sigma * fused_kwp(kw);
  const int runs = (kFusedSlots + tau - 1) / tau, fit = kFusedSmem / tile;
  return runs < fit ? runs : fit;
}

// Replaces repro/kernels/pull_scatter_ms_packed.py::pull_scatter_ms_packed
// (kMma = false) and repro/kernels/pull_mma_ms_packed.py::
// pull_scatter_mma_ms_packed (kMma = true).  Pallas: one grid of
// n_rows + N_q*tau steps, an init copy of v then, per slot e = q*tau + j, the
// slot's mark row (selective OR over its mask bits, or the (1, sigma) x
// (sigma, kappa) int8 product of its plane row with the unpacked frontier
// planes, thresholded) ORed into out[rows[e]] in a live output block;
// correct only because TPU grid steps run in order on one core.  Here the
// wrapper copies v into a fresh out and the words are ORed in with atomics:
// OR is commutative and idempotent, so duplicate rows combine exactly in any
// order, and each slot is thresholded on its own before the OR, as the TPU
// kernel does.
//
// What bounds it: device-memory bytes (kron-22, kappa = 256: masks 103 MB
// or int8 planes 826 MB, int32 rows 413 MB, v in and out 268 MB, the
// frontier tiles 134 MB), then the L2 atomics of the OR-scatter.  The MMA
// form stays off the tensor cores: its 0.42 T operations take 0.21 ms at
// the int8 tensor-core rate, under half its 0.49 ms byte bound, and
// K = sigma = 8 fills a quarter of the k = 32 that mma.sync takes for int8
// (0.85 ms padded); the 0/1 planes of prep_mma_tiles reduce to the
// selective OR of the positive weights, so only the pool's random planes
// with negative weights reach the exact count loop.
//
// Design.  Block b takes the run of vpb VSSs from q0 = b * vpb
// (fused_vss_per_block; the last run may be shorter):
//  1. a warp per VSS of the run: lane 0 loads v2r[q] once, the warp loads
//     the parent's (sigma, kw) frontier tile into shared memory with 16-byte
//     loads (row stride kwp = kw rounded up to kChunk, the pad zero);
//  2. a thread per slot s = ql * tau + j of the run (ql, j stepped, never
//     divided), 32 consecutive slots to a warp: it loads the slot's mask
//     byte, or its plane row in one 8-byte load, one slot ahead (the first
//     beside the tiles); a slot with no positive weight (40% of kron-22's)
//     stops there, a warp of such slots skips the rest; the others build
//     their words kChunk at a time from the shared tile (two 16-byte shared
//     loads per set mask bit);
//  3. per chunk, the lanes with a nonzero word (ballot + popc, compacted)
//     load their int32 row (kappa <= 256 is one chunk) and leave it and
//     their words in shared memory; the warp ORs them in with
//     consecutive lanes on consecutive words of one row, so the atomics of
//     a row's words land in one request: one 64-bit atomicOr per word pair
//     where kw is even (rows then start 8-byte aligned, since out is a
//     fresh tensor), one 32-bit atomicOr per word where kw is odd; a slot
//     takes a power of two of lanes, as many as its words in the chunk
//     (pairs) need, so kw = 1 spends one lane a slot.  A slot whose words
//     are zero (most of road's, on a sparse frontier) loads no row; zero
//     words and zero pairs cost no atomic.
// rows must lie in [0, n_rows) and v2r in [0, num_sets_ext): both are read
// unchecked, as the TPU kernels read them.
//
// Geometry: 256 threads and 6 blocks an SM at <= 40 registers (ptxas -v:
// 40 in both forms, the MMA form spilling 8 bytes; 9,216 bytes of static
// shared memory), runs of 32 VSSs at tau = 128 (25,200 blocks at kron-22,
// 190 an SM of the H100's 132).
// tools/ab_fused_levels.py prints the registers and times this kernel
// against the one it replaced, with and without the 64-bit pairs and the
// int32 rows; PERF.md has the numbers.
template <bool kMma>
__global__ void __launch_bounds__(kFusedThreads, kFusedMinBlocks)
    pull_scatter_kernel(uint32_t* __restrict__ out,
                        const void* __restrict__ lead,
                        const uint32_t* __restrict__ f,
                        const int32_t* __restrict__ v2r,
                        const int32_t* __restrict__ rows, int n_q, int tau,
                        int sigma, int kw, int vpb) {
  extern __shared__ uint4 tile_mem[];  // (vpb, sigma, kwp) frontier words
  __shared__ uint4 stage[kFusedWarps][32][kChunk / 4];
  __shared__ int32_t stage_row[kFusedWarps][32];
  uint32_t* tiles = reinterpret_cast<uint32_t*>(tile_mem);
  const int kwp = fused_kwp(kw);
  const bool pairs = kw % 2 == 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * vpb;
  const int nv = min(vpb, n_q - q0);
  const int slots = nv * tau;
  const int64_t e0 = static_cast<int64_t>(q0) * tau;
  const unsigned sigma_bits = (1u << sigma) - 1u;
  // slot s's positive weights: its mask bits, or those of its plane row
  auto weights = [&](int s, uint64_t& prow) -> unsigned {
    if (kMma) {
      prow = blest::plane_row(static_cast<const int8_t*>(lead)
                                  + (e0 + s) * sigma, sigma);
      return blest::positive_bits(prow);
    }
    return static_cast<const uint8_t*>(lead)[e0 + s] & sigma_bits;
  };
  // a thread's first slot loads beside the tiles, each next one a step ahead
  int base = warp * 32;
  uint64_t prow_next = 0;
  unsigned m_next = base + lane < slots ? weights(base + lane, prow_next) : 0u;

  const bool vec = kw % 4 == 0 && (reinterpret_cast<uintptr_t>(f) & 15u) == 0;
  for (int v = warp; v < nv; v += kFusedWarps) {
    int p = 0;
    if (lane == 0) p = v2r[q0 + v];
    p = __shfl_sync(0xffffffffu, p, 0);
    const uint32_t* src = f + static_cast<int64_t>(p) * sigma * kw;
    uint32_t* dst = tiles + v * sigma * kwp;
    if (vec) {
      const int kw4 = kw / 4, kwp4 = kwp / 4;
      const uint4* src4 = reinterpret_cast<const uint4*>(src);
      for (int i = lane; i < sigma * kwp4; i += 32) {
        const int b = i / kwp4, w4 = i - b * kwp4;
        reinterpret_cast<uint4*>(dst)[i] =
            w4 < kw4 ? __ldg(src4 + b * kw4 + w4) : make_uint4(0, 0, 0, 0);
      }
    } else {
      for (int i = lane; i < sigma * kwp; i += 32) {
        const int b = i / kwp, w = i - b * kwp;
        dst[i] = w < kw ? __ldg(src + b * kw + w) : 0u;
      }
    }
  }
  __syncthreads();

  int ql = threadIdx.x / tau, j = threadIdx.x - ql * tau;
  const int dq = kFusedThreads / tau, dj = kFusedThreads - dq * tau;
  for (; base < slots; base += kFusedThreads) {
    const int s = base + lane;
    const unsigned m = m_next;
    const uint64_t prow = prow_next;
    m_next = 0u;
    if (s + kFusedThreads < slots) {
      m_next = weights(s + kFusedThreads, prow_next);
    }
    if (__any_sync(0xffffffffu, m != 0)) {
      const uint32_t* tile = tiles + ql * sigma * kwp;
      const bool counted = kMma && m && blest::has_negative(prow);
      const bool warp_counted = kMma && __any_sync(0xffffffffu, counted);
      for (int c = 0; c < kwp; c += kChunk) {
        uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
        if (warp_counted) {
          // a negative weight: the exact count, word by word, through the
          // lane's own staging row, before the selective OR below holds
          // any word (so the count loop has the registers)
          if (counted) {
            uint32_t* words = reinterpret_cast<uint32_t*>(stage[warp][lane]);
            for (int k = 0; k < kChunk; ++k) {
              uint32_t fw[8];
#pragma unroll
              for (int b = 0; b < 8; ++b) {
                fw[b] = blest::weight(prow, b) ? tile[b * kwp + c + k] : 0u;
              }
              words[k] = blest::count_word(prow, fw);
            }
            lo = stage[warp][lane][0];
            hi = stage[warp][lane][1];
          }
          __syncwarp();
        }
        if (m && !counted) {
          for (unsigned mm = m; mm; mm &= mm - 1) {
            const uint4* t = reinterpret_cast<const uint4*>(
                tile + (__ffs(mm) - 1) * kwp + c);
            const uint4 a = t[0], b = t[1];
            lo.x |= a.x; lo.y |= a.y; lo.z |= a.z; lo.w |= a.w;
            hi.x |= b.x; hi.y |= b.y; hi.z |= b.z; hi.w |= b.w;
          }
        }
        const bool any =
            (lo.x | lo.y | lo.z | lo.w | hi.x | hi.y | hi.z | hi.w) != 0;
        // the lanes with a nonzero word in the chunk, compacted
        const unsigned live = __ballot_sync(0xffffffffu, any);
        if (!live) continue;
        if (any) {
          const int32_t row = rows[e0 + s];  // in L1 after a first chunk
          const int pos = __popc(live & ((1u << lane) - 1u));
          stage[warp][pos][0] = lo;
          stage[warp][pos][1] = hi;
          stage_row[warp][pos] = row;
        }
        const int cnt = __popc(live);
        __syncwarp();
        const int cw = min(kChunk, kw - c);     // the chunk's words below kw
        const int items = pairs ? cw / 2 : cw;  // a slot's, on 1 << sh lanes
        const int sh = 32 - __clz(items - 1);
        for (int it = lane; it < cnt << sh; it += 32) {
          const int sl = it >> sh, k = it & ((1 << sh) - 1);
          if (k >= items) continue;
          uint32_t* dst =
              out + static_cast<int64_t>(stage_row[warp][sl]) * kw + c;
          if (pairs) {
            const uint2 x = reinterpret_cast<const uint2*>(stage[warp][sl])[k];
            if (x.x | x.y) {
              atomicOr(reinterpret_cast<unsigned long long*>(dst + 2 * k),
                       static_cast<unsigned long long>(x.x)
                           | static_cast<unsigned long long>(x.y) << 32);
            }
          } else {
            const uint32_t x =
                reinterpret_cast<const uint32_t*>(stage[warp][sl])[k];
            if (x) atomicOr(dst + k, x);
          }
        }
        __syncwarp();
      }
    }
    ql += dq;
    j += dj;
    if (j >= tau) {
      j -= tau;
      ++ql;
    }
  }
}

template <bool kMma>
int launch_pull_scatter(void* out, const void* lead, const void* f,
                        const void* v2r, const void* rows, int64_t n_q,
                        int tau, int sigma, int kw, void* stream) {
  const int vpb = fused_vss_per_block(tau, sigma, kw);
  if (n_q < 1 || n_q > INT32_MAX || vpb < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = vpb * sigma * fused_kwp(kw) * 4;
  const int64_t blocks = (n_q + vpb - 1) / vpb;
  pull_scatter_kernel<kMma><<<static_cast<unsigned>(blocks), kFusedThreads,
                              static_cast<size_t>(smem),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), lead, static_cast<const uint32_t*>(f),
      static_cast<const int32_t*>(v2r), static_cast<const int32_t*>(rows),
      static_cast<int>(n_q), tau, sigma, kw, vpb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int blest_pull_scatter_ms_packed(void* out, const void* masks, const void* f,
                                 const void* v2r, const void* rows,
                                 int64_t n_q, int tau, int sigma, int kw,
                                 void* stream) {
  return launch_pull_scatter<false>(out, masks, f, v2r, rows, n_q, tau, sigma,
                                    kw, stream);
}

int blest_pull_scatter_mma_ms_packed(void* out, const void* a_planes,
                                     const void* f, const void* v2r,
                                     const void* rows, int64_t n_q, int tau,
                                     int sigma, int kw, void* stream) {
  return launch_pull_scatter<true>(out, a_planes, f, v2r, rows, n_q, tau,
                                   sigma, kw, stream);
}

// The run of VSSs a block of the fused kernels takes (0: kw too large).
int blest_fused_vss_per_block(int tau, int sigma, int kw) {
  return fused_vss_per_block(tau, sigma, kw);
}

int blest_pull_ms_packed_queued(const void* masks, const void* f,
                                const void* v2r, const void* qids, void* marks,
                                int64_t b, int tau, int sigma, int kw,
                                void* stream) {
  return blest::launch_pull_ms_packed<true>(masks, f, v2r, qids, marks, b,
                                            tau, sigma, kw, stream);
}

const char* blest_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
