// The packed multi-source pull for Hopper (sm_90a), one template for its
// dense form (kernel 5, instantiated in blest_ms.cu), its queued form
// (kernel 9, instantiated in blest_serve.cu) and its MMA-operand form
// (kernel 7, the dense form on int8 plane rows, in blest_ms.cu).
//
// Replaces repro/kernels/pull_ms_packed.py::pull_ms_packed (:37) and
// repro/kernels/pull_ms_packed_queued.py::pull_ms_packed_queued (:50)
// (Pallas: one VSS per grid step, its mask row and its parent's (sigma, kw)
// frontier tile selected by scalar-prefetched index maps, through qids and
// v2r[qids] in the queued form, sigma selective ORs).  For the run's i-th
// VSS, q = i (dense) or q = qids[i] (queued):
//   marks[i, j, w] = OR_{b < sigma : bit_b(masks[q, j])} f[v2r[q], b, w]
// The plane-row form (kPlanes) replaces repro/kernels/pull_mma_ms_packed.py::
// pull_mma_ms_packed (:177; Pallas: a batched (block, tau, sigma) x (block,
// sigma, kappa) int8 product on the MXU over pre-gathered tiles, the sign of
// the counts packed into words):
//   marks[q, j, w] = pack_l( sum_b a_planes[q, j, b] * bit_l(f[v2r[q], b, w]) > 0 )
// Where a row has no negative weight, a count is > 0 exactly when some
// positively weighted plane has the lane's bit, so the word is the selective
// OR over the row's positive weights (blest::positive_bits); a row with a
// negative weight takes the exact count loop (blest::count_word).  Its
// plane rows (8 bytes a slot at sigma = 8, 826 MB at kron-22 against the
// masks' 103 MB) are most of what it reads beside the marks it writes.
// What bounds it: device-memory bytes, almost all of them the (tau, kw)
// marks written a VSS (kron-22 at kappa = 256: 3.30 GB of 3.54); a word is
// at most sigma ORs.  A block per VSS (the first port) spent its time
// scheduling blocks (806,384 at kron-22, each storing 4 KB, and 131k at
// road-20 storing 512 bytes), stored single words, divided by kw a word
// and reread the tile through L1 for every set mask bit.
//
// Design.  Block b takes the run of vpb VSSs from i0 = b * vpb
// (packed_vss_per_block: kPackedWords output words, fewer where the run's
// tiles and masks would pass kPackedSmem bytes or where the grid would not
// fill the card once, at least one VSS; vpb is rounded so that every run's
// output starts 16-byte aligned):
//  1. a thread per VSS of the run loads its id q (qids[i] where queued) and
//     v2r[q] into shared memory;
//  2. the block copies the run's parent tiles (16-byte loads where a tile
//     is a multiple of 4 words) and mask rows (16-byte loads where tau is
//     a multiple of 16), the masks ANDed with the sigma bits; the plane-row
//     form loads the run's rows (16-byte loads, 16 / sigma rows each, where
//     sigma divides 16 and the run's rows start 16-byte aligned) and keeps
//     a byte of each row's positive weights and a byte flagging a negative
//     weight;
//  3. the run's output is nv * tau * kw flat words, taken in items of four
//     words (16 bytes): thread t takes items t, t + 256, ..., its position
//     stepped, never divided, so consecutive threads store consecutive 16
//     bytes, each once, with a streaming store.  Where kw % 4 == 0 (kQuad)
//     an item is four words of one slot: the OR of the 16-byte tile rows
//     of its mask's set bits, one shared load a bit.  Where kw is 1 or 2
//     and tau a multiple of 4 / kw (kSlots, road's kw = 1) it is the words
//     of 4 / kw slots of one VSS, their masks one 4- or 2-byte shared load.
//     Any other kw or tau (kWords: kw = 3; tau < 4 / kw, where an item
//     spans VSSs) steps (VSS, slot, word) a word at a time inside the
//     item, each word with its own slot's mask.  A zero mask reads no
//     tile.  Words past the output's end (the last run's last item) are
//     stored one by one, as is every word of a run whose output is not
//     16-byte aligned.  In the plane-row form a slot whose flag is set
//     rereads its row and counts its words exactly from the shared tile.
// Exactness: a plain OR of u32 words, equal to the reference on any input
// (zero masks, bits above sigma, repeated ids, the pad VSS num_vss whose
// mask row is zero); the plane-row form equal to its reference on any int8
// weights.  v2r and qids are read unchecked, as the TPU kernels read them:
// v2r must index f, qids must index masks and v2r.
//
// Geometry: 256 threads, ptxas -v: 32 registers in each of the six mask
// instances, no spill; the three plane-row instances are compiled for 8
// resident blocks an SM (kPlanesMinBlocks): 32 registers and 8-16 bytes of
// stack, where the count loop left them 57-64 registers, 4 blocks an SM and
// 12% slower at kron-22 on an H100; at kron-22 (tau = 128, sigma = 8,
// kw = 8) 8 VSSs a block, 100,798 blocks, 3 KB of dynamic shared memory
// (the plane-row form 4 KB: its positive and flag bytes); at road-20
// (kw = 1) 64 VSSs a block, 11 KB, and the queued pull's bucket of 16,384
// ids 16 a block, 1,024 blocks (a run of 64 left 256 blocks, a quarter of
// the card).
// tools/ab_ms_kernels.py and tools/ab_sweep_mma.py print the registers and
// time this template against the kernels it replaced; PERF.md has the
// numbers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ms_words.cuh"

namespace blest {

// The launch geometry, here alone: 8 warps a block; a run of kPackedWords
// output words (32 KB of marks), its tiles and masks within kPackedSmem;
// shorter runs where the grid would have fewer than kPackedMinBlocks
// blocks (8 resident blocks on each of the H100's 132 SMs).
constexpr int kPackedThreads = 256;
constexpr int kPackedWords = 8192;
constexpr int kPackedSmem = 32 * 1024;
constexpr int kPackedMinBlocks = 1024;
// kernel 7's plane-row instance: resident blocks an SM it is compiled for
// (8: 32 registers, as the mask instances take unforced; 6 was level with
// it at kron-22 and 3% slower at road-20)
constexpr int kPlanesMinBlocks = 8;

// The run of VSSs a block takes over n_q VSSs: kPackedWords words of output,
// at most what kPackedSmem holds (a tile, mask_rows mask rows of tau bytes,
// an id and a parent a VSS; the plane-row form keeps two rows, positive
// weights and flags), at most n_q / kPackedMinBlocks rounded up, at least
// one; a multiple of 4 / gcd(tau * kw, 4) where that leaves at least one, so
// that every run's output is 16-byte aligned.
inline int packed_vss_per_block(int64_t n_q, int tau, int sigma, int kw,
                                int mask_rows = 1) {
  const int64_t per_vss = int64_t{tau} * kw;  // output words a VSS
  const int align = per_vss % 4 == 0 ? 1 : (per_vss % 2 == 0 ? 2 : 4);
  const int64_t runs = kPackedWords / per_vss;
  const int64_t fit =
      kPackedSmem / (4 * int64_t{sigma} * kw + int64_t{mask_rows} * tau + 8);
  const int64_t share =
      (n_q + int64_t{kPackedMinBlocks} * align - 1)
      / (int64_t{kPackedMinBlocks} * align) * align;
  int64_t vpb = runs < fit ? runs : fit;
  if (share < vpb) vpb = share;
  if (vpb >= align) vpb -= vpb % align;
  return vpb < 1 ? 1 : static_cast<int>(vpb);
}

// Dynamic shared memory of a run: tiles (16-byte rounded), mask_rows
// arrays of mask rows (16-byte rounded each), then the VSS ids and parents
// (int32 each).
inline int64_t packed_smem(int vpb, int tau, int sigma, int kw,
                           int mask_rows = 1) {
  const int64_t tiles = (int64_t{vpb} * sigma * kw * 4 + 15) / 16 * 16;
  const int64_t masks = (int64_t{vpb} * tau + 15) / 16 * 16;
  return tiles + mask_rows * masks + 8 * int64_t{vpb};
}

// The exact word w of a slot whose int8 weights start at aj (a row with a
// negative weight) from its parent's tile t in shared memory (row stride
// kw); a zero weight reads no frontier word.
__device__ __forceinline__ uint32_t exact_word(const int8_t* aj, int sigma,
                                               const uint32_t* t, int kw,
                                               int w) {
  const uint64_t row = plane_row(aj, sigma);
  uint32_t fw[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) fw[b] = weight(row, b) ? t[b * kw + w] : 0u;
  return count_word(row, fw);
}

// marks written as items of 4 words at word k of out (words in all):
// one 16-byte streaming store where the item is whole and aligned.
__device__ __forceinline__ void store_item(uint32_t* out, int k, int words,
                                           bool vec, const uint4& r) {
  if (vec && k + 4 <= words) {
    __stcs(reinterpret_cast<uint4*>(out + k), r);
    return;
  }
  if (k < words) __stcs(out + k, r.x);
  if (k + 1 < words) __stcs(out + k + 1, r.y);
  if (k + 2 < words) __stcs(out + k + 2, r.z);
  if (k + 3 < words) __stcs(out + k + 3, r.w);
}

// How an item's four words map onto slots (the launcher picks it).
enum Items {
  kQuad,   // kw % 4 == 0: four words of one slot
  kSlots,  // kw 1 or 2, tau a multiple of 4 / kw: 4 / kw slots of a VSS
  kWords,  // any other: the words stepped one at a time
};

// The body of a block: masks are (n, tau) mask bytes, or with kPlanes
// (n, tau, sigma) int8 plane rows (the dense form only).
template <bool kQueued, Items kItems, bool kPlanes>
__device__ __forceinline__ void packed_run(const uint8_t* __restrict__ masks,
                                           const uint32_t* __restrict__ f,
                                           const int32_t* __restrict__ v2r,
                                           const int32_t* __restrict__ qids,
                                           uint32_t* __restrict__ marks,
                                           int64_t n_q, int tau, int sigma,
                                           int kw, int vpb) {
  static_assert(!(kQueued && kPlanes), "plane rows: the dense form only");
  extern __shared__ uint4 run_mem[];
  const int tile = sigma * kw;  // words a parent tile
  const int rows_s = (vpb * tau + 15) & ~15;  // bytes of a (vpb, tau) array
  uint32_t* tiles = reinterpret_cast<uint32_t*>(run_mem);
  uint8_t* m_s = reinterpret_cast<uint8_t*>(run_mem)
                 + ((vpb * tile * 4 + 15) & ~15);  // (vpb, tau)
  uint8_t* neg_s = m_s + rows_s;  // (vpb, tau) flags, kPlanes only
  int32_t* ids = reinterpret_cast<int32_t*>(m_s + (kPlanes ? 2 : 1) * rows_s);
  int32_t* par = ids + vpb;
  const int8_t* planes = reinterpret_cast<const int8_t*>(masks);
  // the int8 weights of slot j of the run's VSS v (kPlanes)
  auto plane = [&](int v, int j) {
    return planes + (static_cast<int64_t>(ids[v]) * tau + j) * sigma;
  };
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * vpb;
  const int nv = n_q - i0 < vpb ? static_cast<int>(n_q - i0) : vpb;

  // 1. ids and parents
  for (int v = threadIdx.x; v < nv; v += kPackedThreads) {
    const int32_t q = kQueued ? qids[i0 + v] : static_cast<int32_t>(i0 + v);
    ids[v] = q;
    par[v] = v2r[q];
  }
  __syncthreads();

  // 2. the run's tiles and mask rows
  if (tile % 4 == 0 && (reinterpret_cast<uintptr_t>(f) & 15u) == 0) {
    const int n4 = tile / 4;
    for (int i = threadIdx.x; i < nv * n4; i += kPackedThreads) {
      const int v = i / n4;
      run_mem[i] = __ldg(reinterpret_cast<const uint4*>(
                             f + static_cast<int64_t>(par[v]) * tile)
                         + (i - v * n4));
    }
  } else {
    for (int i = threadIdx.x; i < nv * tile; i += kPackedThreads) {
      const int v = i / tile;
      tiles[i] = __ldg(f + static_cast<int64_t>(par[v]) * tile
                       + (i - v * tile));
    }
  }
  const unsigned sigma_bits = (1u << sigma) - 1u;
  if (kPlanes) {
    // plane rows -> positive-weight bytes and negative-weight flags; the
    // run's rows are contiguous (dense): 16-byte loads of 16 / sigma rows
    const int slots = nv * tau;
    const int8_t* a = planes + i0 * tau * sigma;
    int first = 0;  // the slots before it came in 16-byte loads
    if (16 % sigma == 0 && (reinterpret_cast<uintptr_t>(a) & 15u) == 0) {
      const int per = 16 / sigma;
      const uint64_t keep = sigma == 8 ? ~0ull : (1ull << (8 * sigma)) - 1;
      for (int i = threadIdx.x; i < slots / per; i += kPackedThreads) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(a) + i);
        const uint64_t lo = x.x | static_cast<uint64_t>(x.y) << 32;
        const uint64_t hi = x.z | static_cast<uint64_t>(x.w) << 32;
        for (int k = 0; k < per; ++k) {
          const int bit = 8 * sigma * k;
          const uint64_t row =
              (bit < 64 ? lo >> bit : hi >> (bit - 64)) & keep;
          m_s[i * per + k] = positive_bits(row);
          neg_s[i * per + k] = has_negative(row);
        }
      }
      first = slots / per * per;
    }
    for (int i = first + threadIdx.x; i < slots; i += kPackedThreads) {
      const uint64_t row = plane_row(a + static_cast<int64_t>(i) * sigma,
                                     sigma);
      m_s[i] = positive_bits(row);
      neg_s[i] = has_negative(row);
    }
  } else if (tau % 16 == 0
             && (reinterpret_cast<uintptr_t>(masks) & 15u) == 0) {
    const int n16 = tau / 16;
    const uint32_t keep = sigma_bits * 0x01010101u;
    for (int i = threadIdx.x; i < nv * n16; i += kPackedThreads) {
      const int v = i / n16;
      uint4 x = __ldg(reinterpret_cast<const uint4*>(
                          masks + static_cast<int64_t>(ids[v]) * tau)
                      + (i - v * n16));
      x.x &= keep; x.y &= keep; x.z &= keep; x.w &= keep;
      reinterpret_cast<uint4*>(m_s)[i] = x;
    }
  } else {
    for (int i = threadIdx.x; i < nv * tau; i += kPackedThreads) {
      const int v = i / tau;
      m_s[i] = masks[static_cast<int64_t>(ids[v]) * tau + (i - v * tau)]
               & sigma_bits;
    }
  }
  __syncthreads();

  // 3. items of four output words
  const int words = nv * tau * kw;
  uint32_t* out = marks + i0 * tau * kw;
  const bool vec = (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
  if (kItems == kQuad) {
    const int groups = kw / 4;  // items a slot
    const int per_vss = tau * groups;
    int g = threadIdx.x % groups;
    int j = (threadIdx.x / groups) % tau;
    int v = threadIdx.x / per_vss;
    const int dg = kPackedThreads % groups;
    const int dj = (kPackedThreads / groups) % tau;
    const int dv = kPackedThreads / per_vss;
    for (int it = threadIdx.x; it < nv * per_vss; it += kPackedThreads) {
      const uint4* t = reinterpret_cast<const uint4*>(tiles + v * tile) + g;
      uint4 acc = make_uint4(0, 0, 0, 0);
      if (kPlanes && neg_s[v * tau + j]) {
        const int8_t* aj = plane(v, j);
        const uint32_t* tv = tiles + v * tile;
        acc = make_uint4(exact_word(aj, sigma, tv, kw, 4 * g),
                         exact_word(aj, sigma, tv, kw, 4 * g + 1),
                         exact_word(aj, sigma, tv, kw, 4 * g + 2),
                         exact_word(aj, sigma, tv, kw, 4 * g + 3));
      } else {
        for (unsigned m = m_s[v * tau + j]; m; m &= m - 1) {
          const uint4 x = t[(__ffs(m) - 1) * groups];
          acc.x |= x.x; acc.y |= x.y; acc.z |= x.z; acc.w |= x.w;
        }
      }
      store_item(out, 4 * it, words, vec, acc);
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
  } else if (kItems == kSlots) {
    const int per = 4 / kw;        // slots an item
    const int items = tau / per;   // items a VSS
    int j = threadIdx.x % items * per;
    int v = threadIdx.x / items;
    const int dj = kPackedThreads % items * per;
    const int dv = kPackedThreads / items;
    for (int it = threadIdx.x; it < nv * items; it += kPackedThreads) {
      const uint32_t* t = tiles + v * tile;
      const uint8_t* ms = m_s + v * tau + j;  // 4 / kw-byte aligned
      uint32_t r[4] = {0, 0, 0, 0};
      if (kw == 1) {
        const uint32_t m4 = *reinterpret_cast<const uint32_t*>(ms);
        const uint32_t n4 =
            kPlanes ? *reinterpret_cast<const uint32_t*>(ms + rows_s) : 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kPlanes && ((n4 >> (8 * e)) & 0xffu)) {
            r[e] = exact_word(plane(v, j + e), sigma, t, 1, 0);
            continue;
          }
          for (unsigned m = (m4 >> (8 * e)) & 0xffu; m; m &= m - 1) {
            r[e] |= t[__ffs(m) - 1];
          }
        }
      } else {
        const uint32_t m2 = *reinterpret_cast<const uint16_t*>(ms);
        const uint32_t n2 =
            kPlanes ? *reinterpret_cast<const uint16_t*>(ms + rows_s) : 0u;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (kPlanes && ((n2 >> (8 * e)) & 0xffu)) {
            r[2 * e] = exact_word(plane(v, j + e), sigma, t, 2, 0);
            r[2 * e + 1] = exact_word(plane(v, j + e), sigma, t, 2, 1);
            continue;
          }
          for (unsigned m = (m2 >> (8 * e)) & 0xffu; m; m &= m - 1) {
            const uint2 x = *reinterpret_cast<const uint2*>(
                t + 2 * (__ffs(m) - 1));
            r[2 * e] |= x.x;
            r[2 * e + 1] |= x.y;
          }
        }
      }
      store_item(out, 4 * it, words, vec, make_uint4(r[0], r[1], r[2], r[3]));
      j += dj;
      if (j >= tau) {
        j -= tau;
        ++v;
      }
      v += dv;
    }
  } else {
    // word 4 * t of the run is word w of slot j of VSS v
    constexpr int kStep = 4 * kPackedThreads;  // words between a thread's
    const int k0 = 4 * threadIdx.x;
    int w = k0 % kw;
    int j = (k0 / kw) % tau;
    int v = k0 / (kw * tau);
    const int dw = kStep % kw, dj = (kStep / kw) % tau;
    const int dv = kStep / (kw * tau);
    for (int k = k0; k < words; k += kStep) {
      uint32_t r[4];
      int vv = v, jj = j, ww = w;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t acc = 0;
        if (kPlanes && k + e < words && neg_s[vv * tau + jj]) {
          acc = exact_word(plane(vv, jj), sigma, tiles + vv * tile, kw,
                           ww);
        } else if (k + e < words) {
          const uint32_t* t = tiles + vv * tile + ww;
          for (unsigned m = m_s[vv * tau + jj]; m; m &= m - 1) {
            acc |= t[(__ffs(m) - 1) * kw];
          }
        }
        r[e] = acc;
        if (++ww == kw) {
          ww = 0;
          if (++jj == tau) {
            jj = 0;
            ++vv;
          }
        }
      }
      store_item(out, k, words, vec, make_uint4(r[0], r[1], r[2], r[3]));
      w += dw;
      if (w >= kw) {
        w -= kw;
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
}

// Kernels 5 and 9: the mask instances.
template <bool kQueued, Items kItems>
__global__ void __launch_bounds__(kPackedThreads)
    pull_ms_packed_run(const uint8_t* __restrict__ masks,
                       const uint32_t* __restrict__ f,
                       const int32_t* __restrict__ v2r,
                       const int32_t* __restrict__ qids,
                       uint32_t* __restrict__ marks, int64_t n_q, int tau,
                       int sigma, int kw, int vpb) {
  packed_run<kQueued, kItems, false>(masks, f, v2r, qids, marks, n_q, tau,
                                     sigma, kw, vpb);
}

// Kernel 7: the plane-row instance, its registers capped so that
// kPlanesMinBlocks blocks fit on an SM (the count loop would take 57-64).
template <Items kItems>
__global__ void __launch_bounds__(kPackedThreads, kPlanesMinBlocks)
    pull_mma_planes_run(const uint8_t* __restrict__ planes,
                        const uint32_t* __restrict__ f,
                        const int32_t* __restrict__ v2r,
                        const int32_t* __restrict__ qids,
                        uint32_t* __restrict__ marks, int64_t n_q, int tau,
                        int sigma, int kw, int vpb) {
  packed_run<false, kItems, true>(planes, f, v2r, qids, marks, n_q, tau,
                                  sigma, kw, vpb);
}

// The instance of item shape kItems (kPlanes: kernel 7's).
template <bool kQueued, Items kItems, bool kPlanes>
constexpr auto run_kernel() {
  if constexpr (kPlanes) {
    return pull_mma_planes_run<kItems>;
  } else {
    return pull_ms_packed_run<kQueued, kItems>;
  }
}

// Launches the pull over n_q VSSs (dense: the first n_q; queued: qids[0,
// n_q)) on stream, from mask bytes or (kPlanes) int8 plane rows; returns
// the launch's cudaError_t.
template <bool kQueued, bool kPlanes = false>
int launch_pull_ms_packed(const void* masks, const void* f, const void* v2r,
                          const void* qids, void* marks, int64_t n_q,
                          int tau, int sigma, int kw, void* stream) {
  if (n_q < 1 || n_q > INT32_MAX || tau < 1 || sigma < 1 || sigma > 8
      || kw < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = kPlanes ? 2 : 1;
  const int vpb = packed_vss_per_block(n_q, tau, sigma, kw, rows);
  const int64_t smem = packed_smem(vpb, tau, sigma, kw, rows);
  if (smem > INT32_MAX || int64_t{vpb} * tau * kw > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n_q + vpb - 1) / vpb;
  auto kernel = kw % 4 == 0 ? run_kernel<kQueued, kQuad, kPlanes>()
                : kw <= 2 && tau % (4 / kw) == 0
                    ? run_kernel<kQueued, kSlots, kPlanes>()
                    : run_kernel<kQueued, kWords, kPlanes>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), kPackedThreads,
           static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(masks), static_cast<const uint32_t*>(f),
      static_cast<const int32_t*>(v2r), static_cast<const int32_t*>(qids),
      static_cast<uint32_t*>(marks), n_q, tau, sigma, kw, vpb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace blest
