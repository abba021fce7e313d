// Row-span copy between a packed buffer and an unpacked one, shared by the block
// gather and scatter (block_copy.cu: K1, K2) and the scatter phase of the fused
// send side (ring_exchange.cu: K5).
//
// A plan is three int32 arrays of num_blocks entries: starts (row of each block on
// the unpacked side), counts (rows per block) and outs (row of each block on the
// packed side, the exclusive cumsum of counts; outs + counts never decreases, so
// zero-count pads go at the packed end).  The work is split by packed rows, never
// by blocks: a CTA takes a contiguous span of packed rows.  For each sub-tile of
// kRows rows, kRows threads binary-search the block owning their row over
// ends = outs + counts; the search of the first sub-tile starts at block 0, later
// ones start at the block of the previous sub-tile's last row, which bounds every
// later row from below.  Packed row p of block b maps to starts[b] + p - outs[b].
// Then each warp copies whole rows as words of type Vec (16 bytes where the row
// width and both pointers allow), several rows in flight per thread.  Zero-count
// blocks own no row.  A row whose unpacked index falls outside the unpacked buffer
// is not copied.  All address math is 64-bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rowcopy {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;  // packed rows mapped per sub-tile
constexpr int kRowsPerWarp = kRows / kWarps;

// First block in [lo, num_blocks) whose end (outs + counts) lies past packed row p,
// or num_blocks when none does.  Requires non-decreasing ends.
__device__ __forceinline__ int find_block(const int* __restrict__ counts,
                                          const int* __restrict__ outs, int num_blocks,
                                          int lo, long long p) {
  int hi = num_blocks;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const long long end = static_cast<long long>(__ldg(outs + mid)) + __ldg(counts + mid);
    if (end > p) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// Per-CTA shared scratch of copy_packed_rows.
struct Scratch {
  long long row[kRows];  // unpacked-side row of each packed row, -1 = none
  int cursor;
};

// Copy the packed rows [begin, end) of one plan: gather (unpacked src -> packed
// dst) or scatter (packed src -> unpacked dst).  Called by every thread of a CTA
// of kThreads threads with the same arguments.
template <typename Vec, bool kGather>
__device__ __forceinline__ void copy_packed_rows(const int* __restrict__ starts,
                                                 const int* __restrict__ counts,
                                                 const int* __restrict__ outs, int num_blocks,
                                                 const Vec* __restrict__ src, Vec* __restrict__ dst,
                                                 long long begin, long long end,
                                                 long long unpacked_rows, long long vecs_per_row,
                                                 Scratch& sh) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int cursor = 0;

  for (long long tile = begin; tile < end; tile += kRows) {
    if (threadIdx.x < kRows) {
      const long long p = tile + threadIdx.x;
      const int b = find_block(counts, outs, num_blocks, cursor, p);
      long long row = -1;
      if (p < end && b < num_blocks) {
        const long long o = __ldg(outs + b);
        if (o <= p) row = static_cast<long long>(__ldg(starts + b)) + (p - o);
        if (row >= unpacked_rows) row = -1;
      }
      sh.row[threadIdx.x] = row;
      if (threadIdx.x == kRows - 1) sh.cursor = b;
    }
    __syncthreads();
    cursor = sh.cursor;

    for (long long c = lane; c < vecs_per_row; c += 32) {
      Vec v[kRowsPerWarp];
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        const int r = warp + k * kWarps;
        const long long other = sh.row[r];
        if (other >= 0) {
          const long long from = kGather ? other : tile + r;
          v[k] = src[from * vecs_per_row + c];
        }
      }
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        const int r = warp + k * kWarps;
        const long long other = sh.row[r];
        if (other >= 0) {
          const long long to = kGather ? tile + r : other;
          dst[to * vecs_per_row + c] = v[k];
        }
      }
    }
    __syncthreads();  // sh is rewritten by the next sub-tile
  }
}

}  // namespace rowcopy
