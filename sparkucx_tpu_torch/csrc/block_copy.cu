// Ragged block gather and block scatter for Hopper (sm_90a).
//
// Replaces the Pallas kernels of sparkucx_tpu/ops/pallas_kernels.py:
//   * block_gather_launch  <- _pallas_gather (_gather_dma_kernel / _gather_tiled_kernel):
//       out[outs[b] + k] = src[starts[b] + k]   for k < counts[b]
//   * block_scatter_launch <- _pallas_scatter (_scatter_dma_kernel / _scatter_tiled_kernel):
//       dst[starts[b] + k] = src[outs[b] + k]   in place; uncovered dst rows keep their bytes
// Rows are `row_bytes` wide (128 int32 lanes = 512 B on the shuffle's main path).
//
// Bound: pure data movement.  Each kernel reads every packed row once and writes it
// once, so its least time is 2 * packed_rows * row_bytes over the card's memory
// bandwidth (3.35 TB/s on an H100 SXM).  Nothing is computed on the data.
//
// Design: one mapping for both kernels, balanced for any skew.  The packed side is
// contiguous (outs is the exclusive cumsum of counts), so the work is split by packed
// rows, never by blocks: one CTA per resident slot of the card (a single persistent
// wave) takes an equal contiguous span of packed rows.  For each sub-tile of kRows
// rows, kRows threads binary-search the block owning their row over ends = outs +
// counts (the inversion of _xla_gather); the search of the first sub-tile starts at
// block 0, later ones start at the block of the previous sub-tile's last row, which
// bounds every later row from below.  Packed row p of block b maps to
// starts[b] + p - outs[b].  Then each warp copies whole rows with 16-byte vector loads
// and stores (a 512 B row is one coalesced 32 x 16 B warp access), several rows in
// flight per thread.  One huge block and forty thousand one-row blocks cost the
// same per byte.  Zero-count blocks own no row, so count = 0 pad entries (even with
// outs equal to the packed total), B = 0 and a total of 0 are no-ops.  A row whose
// unpacked index falls outside the unpacked buffer is not copied, so no plan can make
// the kernel touch memory outside its two buffers (the Python side validates plans
// before upload; this guard keeps a bad one from faulting the context).  All address
// math is 64-bit: byte offsets pass 2^31 at 4 M rows of 512 B.  If row_bytes is not
// a multiple of 16 or a pointer is not 16-byte aligned, the same kernel runs on
// 4-byte words.  The TPU kernel's DMA semaphore ring has no counterpart here; TMA
// bulk copies and finer scheduling are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename Vec, bool kGather>
__global__ void __launch_bounds__(kThreads)
block_copy_kernel(const int* __restrict__ starts, const int* __restrict__ counts,
                  const int* __restrict__ outs, int num_blocks, const Vec* __restrict__ src,
                  Vec* __restrict__ dst, long long packed_rows, long long unpacked_rows,
                  long long vecs_per_row, long long rows_per_cta) {
  __shared__ long long s_row[kRows];  // unpacked-side row of each packed row, -1 = none
  __shared__ int s_cursor;

  const long long cta_begin = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const long long cta_end = min(cta_begin + rows_per_cta, packed_rows);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int cursor = 0;

  for (long long tile = cta_begin; tile < cta_end; tile += kRows) {
    if (threadIdx.x < kRows) {
      const long long p = tile + threadIdx.x;
      const int b = find_block(counts, outs, num_blocks, cursor, p);
      long long row = -1;
      if (p < cta_end && b < num_blocks) {
        const long long o = __ldg(outs + b);
        if (o <= p) row = static_cast<long long>(__ldg(starts + b)) + (p - o);
        if (row >= unpacked_rows) row = -1;
      }
      s_row[threadIdx.x] = row;
      if (threadIdx.x == kRows - 1) s_cursor = b;
    }
    __syncthreads();
    cursor = s_cursor;

    for (long long c = lane; c < vecs_per_row; c += 32) {
      Vec v[kRowsPerWarp];
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        const int r = warp + k * kWarps;
        const long long other = s_row[r];
        if (other >= 0) {
          const long long from = kGather ? other : tile + r;
          v[k] = src[from * vecs_per_row + c];
        }
      }
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        const int r = warp + k * kWarps;
        const long long other = s_row[r];
        if (other >= 0) {
          const long long to = kGather ? tile + r : other;
          dst[to * vecs_per_row + c] = v[k];
        }
      }
    }
    __syncthreads();  // s_row and s_cursor are rewritten by the next sub-tile
  }
}

template <typename Vec, bool kGather>
int launch(const int* starts, const int* counts, const int* outs, int num_blocks,
           const void* src, void* dst, long long packed_rows, long long unpacked_rows,
           long long row_bytes, cudaStream_t stream) {
  static int ctas_per_sm = 0;
  if (ctas_per_sm == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas_per_sm, block_copy_kernel<Vec, kGather>, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (ctas_per_sm < 1) ctas_per_sm = 1;
  }
  int device = 0;
  int sm_count = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long tiles = (packed_rows + kRows - 1) / kRows;
  long long grid = static_cast<long long>(sm_count) * ctas_per_sm;
  if (grid > tiles) grid = tiles;
  const long long rows_per_cta = ((tiles + grid - 1) / grid) * kRows;
  grid = (packed_rows + rows_per_cta - 1) / rows_per_cta;
  const long long vecs_per_row = row_bytes / static_cast<long long>(sizeof(Vec));

  block_copy_kernel<Vec, kGather><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      starts, counts, outs, num_blocks, static_cast<const Vec*>(src), static_cast<Vec*>(dst),
      packed_rows, unpacked_rows, vecs_per_row, rows_per_cta);
  return static_cast<int>(cudaGetLastError());
}

template <bool kGather>
int dispatch(const int* starts, const int* counts, const int* outs, int num_blocks,
             const void* src, void* dst, long long packed_rows, long long unpacked_rows,
             long long row_bytes, void* stream) {
  if (num_blocks <= 0 || packed_rows <= 0) return 0;
  if (row_bytes <= 0 || row_bytes % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  if (wide) {
    return launch<int4, kGather>(starts, counts, outs, num_blocks, src, dst, packed_rows,
                                 unpacked_rows, row_bytes, s);
  }
  return launch<int, kGather>(starts, counts, outs, num_blocks, src, dst, packed_rows,
                              unpacked_rows, row_bytes, s);
}

}  // namespace

extern "C" {

// out (out_rows x row_bytes) <- blocks of src (src_rows x row_bytes), packed back to
// back.  Rows of out past the packed total are left as they were.
int block_gather_launch(const int* starts, const int* counts, const int* outs, int num_blocks,
                        const void* src, void* out, long long out_rows, long long src_rows,
                        long long row_bytes, void* stream) {
  return dispatch<true>(starts, counts, outs, num_blocks, src, out, out_rows, src_rows,
                        row_bytes, stream);
}

// dst (dst_rows x row_bytes) <- packed src (src_rows x row_bytes), in place.
int block_scatter_launch(const int* starts, const int* counts, const int* outs,
                         int num_blocks, const void* src, void* dst, long long src_rows,
                         long long dst_rows, long long row_bytes, void* stream) {
  return dispatch<false>(starts, counts, outs, num_blocks, src, dst, src_rows, dst_rows,
                         row_bytes, stream);
}

const char* block_copy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
