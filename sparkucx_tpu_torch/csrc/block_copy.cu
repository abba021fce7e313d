// Ragged block gather and block scatter for Hopper (sm_90a).
//
// Replaces the Pallas kernels of sparkucx_tpu/ops/pallas_kernels.py:
//   * block_gather_launch  <- _pallas_gather (_gather_dma_kernel / _gather_tiled_kernel):
//       out[outs[b] + k] = src[starts[b] + k]   for k < counts[b]
//   * block_scatter_launch <- _pallas_scatter (_scatter_dma_kernel / _scatter_tiled_kernel):
//       dst[starts[b] + k] = src[outs[b] + k]   in place; uncovered dst rows keep their bytes
// Rows are `row_bytes` wide: 512 B on the shuffle's main path, 100 B on TeraSort's
// exchange, 36 B and 12 B on the GROUP BY exchanges.
//
// Bound: pure data movement.  Each kernel reads every packed row once and writes it
// once, so its least time is 2 * packed_rows * row_bytes over the card's memory
// bandwidth (3.35 TB/s on an H100 SXM).  Nothing is computed on the data.
//
// K1's design (the gather).  A block is contiguous on both sides, so the gather
// copies byte spans, not rows: block b's bytes [starts[b] * row_bytes, (starts[b] +
// counts[b]) * row_bytes) of src go to [outs[b] * row_bytes, ...) of out, and the
// packed side is one run of bytes.  That run is cut into kSpanChunk-byte chunks,
// one CTA a chunk, so several CTAs sit on an SM and the next starts as one ends
// (K3's design); the grid is sized by out's rows and capped at kCtasPerSm
// CTAs an SM, which stride over the chunks up to the packed total that only the
// device knows.  A CTA finds the block holding its chunk's first byte by a
// warp-wide 32-ary search of the plan's row prefix ends = outs + counts (the plan
// itself: the host uploads nothing new), then reads the plan kBatch blocks at a
// time; a chunk may cross into later blocks.  Each block's piece of the chunk is
// copied with 16-byte stores: a head of 4-byte words up to the destination's
// 16-byte boundary, a body of 16-byte words, a tail of 4-byte words.  Where source
// and destination agree mod 16 the body takes 16-byte loads; where they do not, it
// takes two aligned 16-byte loads a word and picks the four 4-byte lanes it needs
// in registers, so the row width no longer picks the path (a 100-, 36- or 12-byte
// row moves as fast as a 512-byte one).  Pieces of at least kCtaPiece bytes are
// copied by the whole CTA, smaller ones one a warp, so a chunk of many one-row
// blocks keeps every warp busy.  Zero-count blocks own no bytes, so count = 0 pad
// entries (even with outs equal to the packed total), B = 0 and a total of 0 are
// no-ops; bytes of out past the packed total are left as they were.  A block is cut
// where it would run past either buffer, and no load or store leaves a block's own
// source and destination bytes, so no plan can make the kernel touch memory outside
// its two buffers (the Python side validates plans before upload; this guard keeps
// a bad one from faulting the context).  All address math is 64-bit.
//
// K2's design (the scatter), shared with the fused send side (row_copy.cuh): one
// CTA per resident slot of the card takes an equal contiguous span of packed rows;
// each row's block is found by binary search over the plan, and each warp copies
// whole rows with 16-byte words (4-byte words when the row width or a pointer is
// off 16 bytes), several rows in flight per thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_copy.cuh"

namespace {

// -- K1 ---------------------------------------------------------------------------

constexpr int kSpanThreads = 256;
constexpr int kSpanWarps = kSpanThreads / 32;
// Occupancy decides the constants below, chosen by a sweep of chunk size, grid
// cap, words in flight and CTAs an SM on an H100: with four 16-byte words in
// flight a thread the kernel took 96 registers, two CTAs an SM, and each
// chunk's plan search and batch read went unhidden; two words in flight and at
// least five CTAs an SM (48 registers, no spills) over 64 KB chunks bring it
// near one contiguous copy of the same bytes (PERF.md §6).  They favour
// 100-byte rows over 512-byte ones, which a larger unroll copies a little
// faster.
constexpr long long kSpanChunk = 64 * 1024;  // packed bytes one CTA copies at a time
constexpr int kCtasPerSm = 256;              // the grid's cap, per SM
constexpr int kUnroll = 2;                   // 16-byte words in flight a thread
constexpr int kMinCtasPerSm = 5;             // __launch_bounds__: at most 48 registers
constexpr long long kCtaPiece = 4 * 1024;  // pieces this large are copied by the whole CTA
constexpr int kBatch = 32;                 // blocks of the plan a CTA reads at once

// First block in [0, num_blocks) whose end (outs + counts) lies past packed row p,
// or num_blocks when none does; ends never decrease.  Called by one whole warp:
// each step tests 32 pivots at once.
__device__ __forceinline__ int find_block_warp(const int* __restrict__ counts,
                                               const int* __restrict__ outs, int num_blocks,
                                               long long p) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = num_blocks;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const long long pivot = lo + static_cast<long long>(lane + 1) * step - 1;
    const bool past = pivot < hi && static_cast<long long>(__ldg(outs + pivot)) +
                                            __ldg(counts + pivot) > p;
    const unsigned ballot = __ballot_sync(0xffffffffu, past);
    if (ballot == 0) {  // past the last pivot below hi
      lo += min(32, (hi - lo) / step) * step;
    } else {
      const int f = __ffs(ballot) - 1;
      const int found = lo + (f + 1) * step - 1;
      if (f > 0) lo = lo + f * step;
      hi = found;
    }
  }
  return lo;
}

// The four 4-byte lanes of source bytes [k, k + 16) of the aligned pair (a, b).
__device__ __forceinline__ uint4 realign(const uint4& a, const uint4& b, int k) {
  if (k == 4) return make_uint4(a.y, a.z, a.w, b.x);
  if (k == 8) return make_uint4(a.z, a.w, b.x, b.y);
  return make_uint4(a.w, b.x, b.y, b.z);
}

__device__ __forceinline__ uint4 load_words(const uint8_t* s) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(s);
  return make_uint4(__ldg(w), __ldg(w + 1), __ldg(w + 2), __ldg(w + 3));
}

// n bytes from s to d (both 4-byte aligned, n a multiple of 4), by the `size`
// threads of a group, this one being `rank`.  Only bytes of [s, s + n) are read and
// only bytes of [d, d + n) written.
__device__ __forceinline__ void copy_span(const uint8_t* s, uint8_t* d, long long n, int rank,
                                          int size) {
  long long head = (16 - static_cast<long long>(reinterpret_cast<uintptr_t>(d) & 15)) & 15;
  if (head > n) head = n;
  if (rank < head / 4) {
    reinterpret_cast<uint32_t*>(d)[rank] = __ldg(reinterpret_cast<const uint32_t*>(s) + rank);
  }
  s += head;
  d += head;
  n -= head;
  const long long words = n / 16;
  uint4* dw = reinterpret_cast<uint4*>(d);
  const int k = static_cast<int>(reinterpret_cast<uintptr_t>(s) & 15);
  if (k == 0) {
    const uint4* sw = reinterpret_cast<const uint4*>(s);
    long long i = rank;
    for (; i + (kUnroll - 1) * size < words; i += kUnroll * size) {
      uint4 x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x[u] = __ldg(sw + i + u * size);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) dw[i + u * size] = x[u];
    }
    for (; i < words; i += size) dw[i] = __ldg(sw + i);
  } else {
    // word i's bytes lie in the aligned words sa[i] and sa[i + 1]; the first and the
    // last word would read past the span there, so they take 4-byte loads
    const uint4* sa = reinterpret_cast<const uint4*>(s - k);
    long long i = rank;
    for (; i + (kUnroll - 1) * size < words; i += kUnroll * size) {
      uint4 x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long w = i + u * size;
        x[u] = (w == 0 || w == words - 1) ? load_words(s + w * 16)
                                          : realign(__ldg(sa + w), __ldg(sa + w + 1), k);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) dw[i + u * size] = x[u];
    }
    for (; i < words; i += size) {
      dw[i] = (i == 0 || i == words - 1) ? load_words(s + i * 16)
                                         : realign(__ldg(sa + i), __ldg(sa + i + 1), k);
    }
  }
  const long long tail = (n - words * 16) / 4;
  if (rank < tail) {
    reinterpret_cast<uint32_t*>(d + words * 16)[rank] =
        __ldg(reinterpret_cast<const uint32_t*>(s + words * 16) + rank);
  }
}

// One chunk [chunk0, chunk1) of the packed bytes: its blocks' pieces, kBatch
// blocks of the plan at a time.  Called by the whole CTA.
__device__ __forceinline__ void gather_chunk(const int* __restrict__ starts,
                                             const int* __restrict__ counts,
                                             const int* __restrict__ outs, int num_blocks,
                                             const uint8_t* __restrict__ src,
                                             uint8_t* __restrict__ out, long long src_rows,
                                             long long out_rows, long long row_bytes,
                                             long long chunk0, long long chunk1) {
  __shared__ long long piece_src[kBatch], piece_dst[kBatch], piece_len[kBatch];
  __shared__ int first_block, more;
  const int last = num_blocks - 1;
  if (threadIdx.x < 32) {
    const int b = find_block_warp(counts, outs, num_blocks, chunk0 / row_bytes);
    if (threadIdx.x == 0) first_block = b;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int b = first_block; b < num_blocks; b += kBatch) {
    if (threadIdx.x < kBatch) {
      const int k = b + threadIdx.x;
      long long len = 0, from = 0, to = 0;
      if (k < num_blocks) {
        const long long o = __ldg(outs + k), s = __ldg(starts + k);
        // the block's rows inside both buffers
        const long long rows = min(static_cast<long long>(__ldg(counts + k)), min(src_rows - s, out_rows - o));
        const long long lo = max(o * row_bytes, chunk0);
        const long long hi = min((o + max(rows, 0LL)) * row_bytes, chunk1);
        if (hi > lo) {
          len = hi - lo;
          to = lo;
          from = s * row_bytes + (lo - o * row_bytes);
        }
      }
      piece_src[threadIdx.x] = from;
      piece_dst[threadIdx.x] = to;
      piece_len[threadIdx.x] = len;
      if (threadIdx.x == kBatch - 1) {  // the chunk runs on past this batch's last block
        more = k < last && (static_cast<long long>(__ldg(outs + k)) + __ldg(counts + k)) * row_bytes < chunk1;
      }
    }
    __syncthreads();
    // a large piece takes the whole CTA, a small one the warp it falls to; no
    // barrier between pieces, so each warp walks the batch at its own pace
    for (int p = 0; p < kBatch; ++p) {
      const long long len = piece_len[p];
      const bool whole = len >= kCtaPiece;
      if (len == 0 || (!whole && p % kSpanWarps != warp)) continue;
      copy_span(src + piece_src[p], out + piece_dst[p], len, whole ? threadIdx.x : lane,
                whole ? kSpanThreads : 32);
    }
    const bool again = more;
    __syncthreads();  // the batch and first_block are rewritten next
    if (!again) break;
  }
}

// The CTAs stride over the chunks up to the packed total, which only the device
// knows (the last block's end): the grid is sized by out's rows, capped, so a call
// whose out is far larger than what it packs costs no wave of idle CTAs.
__global__ void __launch_bounds__(kSpanThreads, kMinCtasPerSm)
block_gather_kernel(const int* __restrict__ starts, const int* __restrict__ counts,
                    const int* __restrict__ outs, int num_blocks, const uint8_t* __restrict__ src,
                    uint8_t* __restrict__ out, long long src_rows, long long out_rows,
                    long long row_bytes) {
  const int last = num_blocks - 1;
  const long long packed_bytes =
      min(static_cast<long long>(__ldg(outs + last)) + __ldg(counts + last), out_rows) * row_bytes;
  for (long long chunk0 = static_cast<long long>(blockIdx.x) * kSpanChunk; chunk0 < packed_bytes;
       chunk0 += static_cast<long long>(gridDim.x) * kSpanChunk) {
    gather_chunk(starts, counts, outs, num_blocks, src, out, src_rows, out_rows, row_bytes, chunk0,
                 min(chunk0 + kSpanChunk, packed_bytes));
  }
}

// -- K2 ---------------------------------------------------------------------------

using rowcopy::kRows;
using rowcopy::kThreads;

template <typename Vec>
__global__ void __launch_bounds__(kThreads)
block_scatter_kernel(const int* __restrict__ starts, const int* __restrict__ counts,
                     const int* __restrict__ outs, int num_blocks, const Vec* __restrict__ src,
                     Vec* __restrict__ dst, long long packed_rows, long long unpacked_rows,
                     long long vecs_per_row, long long rows_per_cta) {
  __shared__ rowcopy::Scratch sh;
  const long long cta_begin = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const long long cta_end = min(cta_begin + rows_per_cta, packed_rows);
  rowcopy::copy_packed_rows<Vec>(starts, counts, outs, num_blocks, src, dst, cta_begin,
                                        cta_end, unpacked_rows, vecs_per_row, sh);
}

template <typename Vec>
int launch_scatter(const int* starts, const int* counts, const int* outs, int num_blocks,
                   const void* src, void* dst, long long packed_rows, long long unpacked_rows,
                   long long row_bytes, cudaStream_t stream) {
  static int slots = 0;  // resident CTAs on the card: occupancy x SMs
  if (slots == 0) {
    int ctas_per_sm = 0, device = 0, sm_count = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas_per_sm, block_scatter_kernel<Vec>, kThreads, 0);
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    slots = sm_count * (ctas_per_sm < 1 ? 1 : ctas_per_sm);
  }
  const long long tiles = (packed_rows + kRows - 1) / kRows;
  long long grid = slots;
  if (grid > tiles) grid = tiles;
  const long long rows_per_cta = ((tiles + grid - 1) / grid) * kRows;
  grid = (packed_rows + rows_per_cta - 1) / rows_per_cta;
  const long long vecs_per_row = row_bytes / static_cast<long long>(sizeof(Vec));

  block_scatter_kernel<Vec><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      starts, counts, outs, num_blocks, static_cast<const Vec*>(src), static_cast<Vec*>(dst),
      packed_rows, unpacked_rows, vecs_per_row, rows_per_cta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (out_rows x row_bytes) <- blocks of src (src_rows x row_bytes), packed back to
// back.  Rows of out past the packed total are left as they were.  src and out are
// 4-byte aligned and do not overlap.
int block_gather_launch(const int* starts, const int* counts, const int* outs, int num_blocks,
                        const void* src, void* out, long long out_rows, long long src_rows,
                        long long row_bytes, void* stream) {
  if (num_blocks <= 0 || out_rows <= 0) return 0;
  if (row_bytes <= 0 || row_bytes % 4 != 0 || src_rows < 0 ||
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out)) & 3) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int cap = 0;  // CTAs of the largest grid: kCtasPerSm x SMs
  if (cap == 0) {
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cap = kCtasPerSm * sms;
  }
  long long chunks = (out_rows * row_bytes + kSpanChunk - 1) / kSpanChunk;
  if (chunks > cap) chunks = cap;
  block_gather_kernel<<<static_cast<unsigned>(chunks), kSpanThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      starts, counts, outs, num_blocks, static_cast<const uint8_t*>(src),
      static_cast<uint8_t*>(out), src_rows, out_rows, row_bytes);
  return static_cast<int>(cudaGetLastError());
}

// dst (dst_rows x row_bytes) <- packed src (src_rows x row_bytes), in place.
int block_scatter_launch(const int* starts, const int* counts, const int* outs,
                         int num_blocks, const void* src, void* dst, long long src_rows,
                         long long dst_rows, long long row_bytes, void* stream) {
  if (num_blocks <= 0 || src_rows <= 0) return 0;
  if (row_bytes <= 0 || row_bytes % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  if (wide) {
    return launch_scatter<int4>(starts, counts, outs, num_blocks, src, dst, src_rows, dst_rows,
                                row_bytes, s);
  }
  return launch_scatter<int>(starts, counts, outs, num_blocks, src, dst, src_rows, dst_rows,
                             row_bytes, s);
}

const char* block_copy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
