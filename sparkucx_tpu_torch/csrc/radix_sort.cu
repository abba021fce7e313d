// One stable LSD radix-sort pass over rows of 32-bit words, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of sparkucx_tpu/ops/radix.py: _radix_pass (:254) with
// _bin_kernel (:170).  A pass sorts rows of `row_words` 32-bit words stably by one
// kBits-wide digit of the uint32 key in word 0 (key and payload move together):
//   * radix_histogram_launch: hist[b, t] = rows of tile t whose digit is b, stored
//     bucket-major (256 x tiles);
//   * the caller turns hist into dests[b, t], the first output row of segment (b, t):
//     the rows of smaller buckets plus those of bucket b in earlier tiles, which in the
//     bucket-major order is ONE flat exclusive cumsum of hist (a torch op, as the JAX
//     package does its two cumsums in XLA outside its kernel);
//   * radix_scatter_launch: every row of tile t with digit b goes to dests[b, t] plus
//     its stable rank among the tile's rows with digit b, all of its words.
// kBits = 8: four passes sort the 32-bit key (the TPU kernel used 4-bit digits and
// eight passes; a stable sort gives the same rows either way).
//
// Bound: data movement.  The scatter reads every row once and writes it once; the
// histogram reads one key word per row.  Nothing else touches device memory but the
// (256, tiles) tables.  So a pass takes at least (2 * rows * row_bytes + 4 * rows)
// over the card's memory bandwidth (3.35 TB/s on an H100 SXM).
//
// Design.  One CTA of 256 threads per tile of kTileRows rows, a constant of the kernel
// (the caller sizes the (256, tiles) tables from radix_tile_rows()).  The histogram counts
// digits in shared memory, one shared atomic per digit per warp (__match_any_sync
// groups the warp's lanes by digit).  The scatter walks its tile in chunks of 256
// rows; warp w owns rows [32w, 32w + 32) of a chunk, and lane c holds word c of each
// of them in registers (rows of 100 B are not a multiple of 16 B, so no vector loads).
// Lane k takes row k's key, word 0, from lane 0 by shuffle.  A row's rank among the
// chunk's rows with its digit is the count of lower lanes of its warp with that digit
// (__match_any_sync, __popc) plus the counts of the lower warps (per-digit counts per
// warp, prefix-summed in shared memory by the digit's own thread).  Thread d keeps
// digit d's running output row across chunks in a register, starting at dests[d, t].
// Memory-level parallelism is what the kernel lives on: each warp loads the NEXT
// chunk's 32 rows before it stores this chunk's 32, so two chunks are in flight while
// the ranks are computed (143 registers, one CTA an SM; that beat two and three
// lighter CTAs an SM that load only their own chunk).  Rows of one digit in one chunk
// are consecutive in the output, and a tile's rows of one digit form one segment, so
// the writes merge in L2.  Every row and word index is 64-bit: a 10 GB buffer of
// 100 B rows holds 2.5e9 words.  The Mosaic workarounds of the TPU kernel (the VMEM
// one-hot band, its flat cumsum and the binary-search inverse) have no counterpart
// here; staging chunks in shared memory by TMA and a decoupled look-back that fuses
// the histogram into the scatter are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBits = 8;
constexpr int kBuckets = 1 << kBits;
constexpr int kThreads = 256;  // one row per thread per chunk; also one thread per digit
constexpr int kWarps = kThreads / 32;
constexpr long long kTileRows = 8192;  // rows per CTA
static_assert(kThreads == kBuckets, "the scatter's prefix step gives each digit one thread");
static_assert(kTileRows % kThreads == 0, "only the last tile ends inside a chunk");

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__global__ void __launch_bounds__(kThreads)
radix_histogram_kernel(const uint32_t* __restrict__ rows, long long num_rows,
                       long long row_words, int shift, int* __restrict__ hist) {
  __shared__ int s_hist[kBuckets];
  s_hist[threadIdx.x] = 0;
  __syncthreads();
  const long long begin = static_cast<long long>(blockIdx.x) * kTileRows;
  const long long end = min(begin + kTileRows, num_rows);
  const int lane = threadIdx.x & 31;
  for (long long base = begin; base < end; base += kThreads) {
    const long long row = base + threadIdx.x;
    const bool valid = row < end;
    const unsigned d =
        valid ? (__ldg(rows + row * row_words) >> shift) & (kBuckets - 1) : kBuckets;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (valid && lane == __ffs(peers) - 1) atomicAdd(&s_hist[d], __popc(peers));
  }
  __syncthreads();
  hist[static_cast<long long>(threadIdx.x) * gridDim.x + blockIdx.x] = s_hist[threadIdx.x];
}

__global__ void __launch_bounds__(kThreads)
radix_scatter_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                     long long num_rows, long long row_words, int shift,
                     const long long* __restrict__ dests) {
  __shared__ int s_count[kWarps][kBuckets];        // rows of digit d in warp w, this chunk
  __shared__ long long s_start[kWarps][kBuckets];  // output row of warp w's first digit-d row

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long begin = static_cast<long long>(blockIdx.x) * kTileRows;
  const long long end = min(begin + kTileRows, num_rows);
  // thread tid owns digit tid: the output row its next row goes to
  long long next = dests[static_cast<long long>(tid) * gridDim.x + blockIdx.x];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s_count[w][tid] = 0;
  __syncthreads();

  uint32_t v[32];
  {
    const long long warp_first = begin + warp * 32;
    const int warp_rows = static_cast<int>(max(0LL, min(32LL, end - warp_first)));
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      v[k] = 0;
      if (k < warp_rows && lane < row_words) v[k] = __ldg(src + (warp_first + k) * row_words + lane);
    }
  }
  for (long long chunk = begin; chunk < end; chunk += kThreads) {
    const long long warp_first = chunk + warp * 32;
    const int warp_rows = static_cast<int>(max(0LL, min(32LL, end - warp_first)));
    const bool col0 = lane < row_words;
    uint32_t key = 0;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const uint32_t w0 = __shfl_sync(0xffffffffu, v[k], 0);
      if (lane == k) key = w0;
    }
    const bool valid = lane < warp_rows;
    const unsigned d = valid ? (key >> shift) & (kBuckets - 1) : kBuckets;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & lanemask_lt());
    if (valid && lane == __ffs(peers) - 1) s_count[warp][d] = __popc(peers);
    __syncthreads();

#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_count[w][tid];
      s_start[w][tid] = next;
      next += c;
      s_count[w][tid] = 0;
    }
    __syncthreads();

    const long long to = valid ? s_start[warp][d] + rank : -1;
    uint32_t nv[32];
    {
      const long long nfirst = warp_first + kThreads;
      const int nrows = static_cast<int>(max(0LL, min(32LL, end - nfirst)));
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        nv[k] = 0;
        if (k < nrows && col0) nv[k] = __ldg(src + (nfirst + k) * row_words + lane);
      }
    }
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const long long out = __shfl_sync(0xffffffffu, to, k);
      if (k < warp_rows && col0) dst[out * row_words + lane] = v[k];
    }
    for (long long c0 = 32; c0 < row_words; c0 += 32) {
      const long long c = c0 + lane;
      const bool col = c < row_words;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        if (k < warp_rows && col) v[k] = __ldg(src + (warp_first + k) * row_words + c);
      }
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const long long out = __shfl_sync(0xffffffffu, to, k);
        if (k < warp_rows && col) dst[out * row_words + c] = v[k];
      }
    }
#pragma unroll
    for (int k = 0; k < 32; ++k) v[k] = nv[k];
  }
}

int check_args(const void* a, const void* b, long long num_rows, long long row_words,
               int shift, long long* tiles) {
  if (a == nullptr || b == nullptr || num_rows < 0 || row_words <= 0 || shift < 0 ||
      shift >= 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *tiles = (num_rows + kTileRows - 1) / kTileRows;
  if (*tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  return 0;
}

}  // namespace

extern "C" {

int radix_bits() { return kBits; }

long long radix_tile_rows() { return kTileRows; }

// hist (256 x tiles int32, bucket-major) <- digit counts of each tile of rows
// (num_rows x row_words); tiles = ceil(num_rows / radix_tile_rows()).
int radix_histogram_launch(const void* rows, long long num_rows, long long row_words,
                           int shift, int* hist, void* stream) {
  long long tiles = 0;
  const int rc = check_args(rows, hist, num_rows, row_words, shift, &tiles);
  if (rc != 0 || tiles == 0) return rc;
  radix_histogram_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), num_rows, row_words, shift, hist);
  return static_cast<int>(cudaGetLastError());
}

// dst <- src's rows placed stably by digit, from dests (256 x tiles int64,
// bucket-major).  src and dst must not overlap.
int radix_scatter_launch(const void* src, void* dst, long long num_rows, long long row_words,
                         int shift, const long long* dests, void* stream) {
  long long tiles = 0;
  int rc = check_args(src, dst, num_rows, row_words, shift, &tiles);
  if (rc == 0 && dests == nullptr) rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0 || tiles == 0) return rc;
  radix_scatter_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst), num_rows, row_words,
      shift, dests);
  return static_cast<int>(cudaGetLastError());
}

const char* radix_sort_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
