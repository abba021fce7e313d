// Stable LSD radix sort of rows of 32-bit words by the uint32 key in word 0, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel of sparkucx_tpu/ops/radix.py: _radix_pass (:254) with
// _bin_kernel (:170), which moved every whole row in each of its eight 4-bit passes.
//
// Bound: data movement.  The function reads every row once and writes it once, so it
// takes at least 2 * rows * row_bytes over the card's memory bandwidth (3.35 TB/s on
// an H100 SXM): 5.97 ms for 100M rows of 100 B.  A design that moves whole rows in
// every digit pass moves that NUM_PASSES times; this one sorts 8-byte (key, row
// number) pairs instead and moves each row once, at the end:
//   * radix_counts_launch: one read of word 0 of every row (a 32-byte sector a row),
//     which writes the keys (4 B a row) and counts every pass's digit at once (4 x 256
//     counts, in shared memory, added to the global counts once per CTA);
//   * radix_onesweep_launch, once a pass: pairs in, pairs out (the first pass makes
//     the row numbers itself and reads keys only; the last writes only the row
//     numbers, which form the permutation);
//   * radix_permute_launch: out[i] = rows[perm[i]], each row read once (4 sectors for
//     a 4-byte-aligned 100-byte row) and written once, sequentially.
// At 100M rows of 100 B that is about 33 GB (9.8 ms at the card's rate) where four
// whole-row passes move 81.6 GB.
//
// Design of a pass (Merrill and Garland's one-sweep radix sort, decoupled look-back).
// One CTA of 256 threads a tile of kTileRows = 4096 pairs, three CTAs an SM (smaller
// tiles and more CTAs ranked faster than 8192-pair tiles at two an SM); the tile
// number comes from an atomic ticket, so every tile a CTA waits on belongs to a CTA
// that started earlier and is resident (forward progress without a grid barrier).
// Warp w ranks the tile's rows [512 w, 512 w + 512) in 16 rounds of 32 keys held in
// registers: the lanes that share a digit find each other with __match_any_sync,
// their rank is the warp's running count of the digit (shared memory) plus the lower
// lanes of the group.
// Thread d then turns the warps' counts of digit d into warp offsets and the tile's
// count, publishes that count in the pass's look-back array (one 64-bit status word a
// (tile, digit): 1 = the tile's count, 2 = the inclusive prefix), and walks back over
// earlier tiles, adding counts until it meets an inclusive prefix; tile 0 starts from
// the digit's global start (an exclusive scan of the counts, inside the kernel).  The
// tile's pairs are then placed in shared memory in digit order and written out from
// there, so each digit's run leaves as contiguous, coalesced stores.  Row numbers are
// uint32 (the wrapper refuses 2**32 rows or more); the look-back words hold 32-bit
// counts and their flags side by side, so one store publishes both.
//
// Design of the permutation.  A warp copies 32 output rows at a time as one flat run
// of 32 x row_words words: lane l moves words l, l + 32, ..., reading each from its
// source row (the row's number comes from the lane that loaded it, by shuffle), eight
// loads in flight a lane.  Rows of 100 B are not 16-byte multiples, so words are 4
// bytes; the stores are sequential and coalesce.  Every row and word offset is 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBits = 8;
constexpr int kBuckets = 1 << kBits;
constexpr int kThreads = 256;  // also one thread per digit
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                      // keys a lane ranks per tile
constexpr int kWarpRows = 32 * kItems;          // rows a warp ranks per tile
constexpr long long kTileRows = 4096;           // rows per CTA tile
constexpr int kMaxPasses = 32 / kBits;
constexpr int kPermuteUnroll = 8;               // words in flight per lane
constexpr unsigned long long kCount = 1ull << 32;   // look-back: the tile's count
constexpr unsigned long long kPrefix = 2ull << 32;  // look-back: the inclusive prefix
static_assert(kThreads == kBuckets, "one thread per digit");
static_assert(kTileRows == static_cast<long long>(kWarps) * kWarpRows, "warps tile the tile");

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ unsigned digit_of(uint32_t key, int shift) {
  return (key >> shift) & (kBuckets - 1);
}

// Exclusive prefix of v over the CTA's threads, in thread order.
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v, unsigned* s_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_sums[warp] = x;
  __syncthreads();
  unsigned before = 0;
  for (int w = 0; w < warp; ++w) before += s_sums[w];
  __syncthreads();  // s_sums is reused by the next scan
  return before + x - v;
}

__global__ void __launch_bounds__(kThreads)
radix_counts_kernel(const uint32_t* __restrict__ rows, long long num_rows, long long row_words,
                    int shift, int passes, uint32_t* __restrict__ keys,
                    unsigned int* __restrict__ counts) {
  __shared__ unsigned int s_counts[kMaxPasses * kBuckets];
  for (int i = threadIdx.x; i < kMaxPasses * kBuckets; i += kThreads) s_counts[i] = 0;
  __syncthreads();
  constexpr int kUnroll = 4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       row < num_rows; row += kUnroll * stride) {
    uint32_t k[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = row + u * stride;
      k[u] = r < num_rows ? __ldg(rows + r * row_words) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = row + u * stride;
      if (r >= num_rows) continue;
      keys[r] = k[u];
      for (int p = 0; p < passes; ++p) {
        atomicAdd(&s_counts[p * kBuckets + digit_of(k[u], shift + p * kBits)], 1u);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * kBuckets; i += kThreads) {
    if (s_counts[i] != 0) atomicAdd(counts + i, s_counts[i]);
  }
}

// One pass.  kFirst: the row numbers are the positions (vals_in unused); kLast: only
// the row numbers are written (keys_out unused).
template <bool kFirst, bool kLast>
__global__ void __launch_bounds__(kThreads, 3)
radix_onesweep_kernel(const uint32_t* __restrict__ keys_in, const uint32_t* __restrict__ vals_in,
                      uint32_t* __restrict__ keys_out, uint32_t* __restrict__ vals_out,
                      long long num_rows, int shift, const unsigned int* __restrict__ counts,
                      unsigned long long* lookback, unsigned int* ticket) {
  extern __shared__ uint32_t s_pairs[];              // keys [kTileRows], then row numbers
  __shared__ unsigned int s_warp[kWarps][kBuckets];  // rows of digit d in warp w, then offsets
  __shared__ unsigned int s_local[kBuckets];         // tile-local first row of digit d
  __shared__ long long s_base[kBuckets];             // output row of local row 0 of digit d
  __shared__ unsigned int s_sums[kWarps];
  __shared__ unsigned int s_tile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(ticket, 1u);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s_warp[w][tid] = 0;
  __syncthreads();
  const long long tile = s_tile;
  const long long tile_first = tile * kTileRows;
  const long long warp_first = tile_first + warp * kWarpRows;

  uint32_t key[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long r = warp_first + i * 32 + lane;
    key[i] = r < num_rows ? __ldg(keys_in + r) : 0u;
  }

  // stable ranks inside the warp: rows in order i, then lane
  uint32_t rank[kItems / 2];  // two 16-bit ranks a register (a warp ranks 512 rows)
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool valid = warp_first + i * 32 + lane < num_rows;
    const unsigned d = valid ? digit_of(key[i], shift) : kBuckets;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const unsigned before = valid ? s_warp[warp][d] : 0u;
    const unsigned r = before + __popc(peers & lanemask_lt());
    if (i % 2 == 0) {
      rank[i / 2] = r;
    } else {
      rank[i / 2] |= r << 16;
    }
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) s_warp[warp][d] = before + __popc(peers);
    __syncwarp();
  }

  // the row numbers, in flight while the CTA looks back
  uint32_t val[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long r = warp_first + i * 32 + lane;
    val[i] = kFirst ? static_cast<uint32_t>(r) : (r < num_rows ? __ldg(vals_in + r) : 0u);
  }
  __syncthreads();

  // thread d: the warps' offsets for digit d and the tile's count of it
  const int d = tid;
  unsigned total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = s_warp[w][d];
    s_warp[w][d] = total;
    total += c;
  }
  const unsigned digit_start = block_exclusive_scan(counts[d], s_sums);
  const unsigned local = block_exclusive_scan(total, s_sums);
  volatile unsigned long long* status = lookback;
  unsigned long long excl;
  if (tile == 0) {
    excl = digit_start;
    status[d] = kPrefix | (digit_start + total);
  } else {
    status[tile * kBuckets + d] = kCount | total;
    excl = 0;
    for (long long t = tile - 1;; --t) {
      unsigned long long v;
      do {
        v = status[t * kBuckets + d];
      } while ((v >> 32) == 0);
      excl += static_cast<uint32_t>(v);
      if ((v >> 32) == (kPrefix >> 32)) break;
    }
    status[tile * kBuckets + d] = kPrefix | (excl + total);
  }
  s_local[d] = local;
  s_base[d] = static_cast<long long>(excl) - local;
  __syncthreads();

  // the tile in digit order in shared memory
  uint32_t* s_keys = s_pairs;
  uint32_t* s_vals = s_pairs + kTileRows;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (warp_first + i * 32 + lane >= num_rows) continue;
    const unsigned dg = digit_of(key[i], shift);
    const unsigned pos = s_local[dg] + s_warp[warp][dg] + ((rank[i / 2] >> (16 * (i % 2))) & 0xFFFFu);
    s_keys[pos] = key[i];
    s_vals[pos] = val[i];
  }
  __syncthreads();

  // each digit's run leaves contiguously
  const int tile_rows = static_cast<int>(min(kTileRows, num_rows - tile_first));
  for (int p = tid; p < tile_rows; p += kThreads) {
    const uint32_t k = s_keys[p];
    const long long out = s_base[digit_of(k, shift)] + p;
    if (!kLast) keys_out[out] = k;
    vals_out[out] = s_vals[p];
  }
}

__global__ void __launch_bounds__(kThreads)
radix_permute_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                     const uint32_t* __restrict__ perm, long long num_rows, int row_words) {
  const int lane = threadIdx.x & 31;
  const long long groups = (num_rows + 31) / 32;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const int dr = 32 / row_words, dc = 32 % row_words;  // (row, column) step of 32 words
  for (long long g = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5); g < groups;
       g += warps) {
    const long long first = g * 32;
    const int rows = static_cast<int>(min(32LL, num_rows - first));
    const long long from = lane < rows ? static_cast<long long>(__ldg(perm + first + lane)) * row_words : 0;
    const int words = rows * row_words;
    uint32_t* out = dst + first * row_words;
    int r = lane / row_words, c = lane - (lane / row_words) * row_words;  // word `lane`
    for (int q0 = 0; q0 < words; q0 += 32 * kPermuteUnroll) {
      uint32_t v[kPermuteUnroll];
#pragma unroll
      for (int u = 0; u < kPermuteUnroll; ++u) {
        const long long s = __shfl_sync(0xffffffffu, from, r & 31);
        v[u] = q0 + u * 32 + lane < words ? __ldg(src + s + c) : 0u;
        c += dc;
        r += dr;
        if (c >= row_words) {
          c -= row_words;
          ++r;
        }
      }
#pragma unroll
      for (int u = 0; u < kPermuteUnroll; ++u) {
        const int q = q0 + u * 32 + lane;
        if (q < words) out[q] = v[u];
      }
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
      count = 132;
    }
  }
  return count;
}

constexpr size_t kPairBytes = 2 * kTileRows * sizeof(uint32_t);

template <bool kFirst, bool kLast>
int launch_onesweep(const uint32_t* keys_in, const uint32_t* vals_in, uint32_t* keys_out,
                    uint32_t* vals_out, long long num_rows, int shift, const unsigned int* counts,
                    unsigned long long* lookback, unsigned int* ticket, cudaStream_t stream) {
  auto kernel = radix_onesweep_kernel<kFirst, kLast>;
  static cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kPairBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long tiles = (num_rows + kTileRows - 1) / kTileRows;
  kernel<<<static_cast<unsigned>(tiles), kThreads, kPairBytes, stream>>>(
      keys_in, vals_in, keys_out, vals_out, num_rows, shift, counts, lookback, ticket);
  return static_cast<int>(cudaGetLastError());
}

bool rows_ok(long long num_rows) { return num_rows >= 0 && num_rows <= 0xffffffffLL; }

}  // namespace

extern "C" {

int radix_bits() { return kBits; }

long long radix_tile_rows() { return kTileRows; }

// keys (num_rows uint32) <- word 0 of every row of rows (num_rows x row_words);
// counts (passes x 256 uint32, zero or a running sum) += each row's digits at shifts
// shift, shift + 8, ..., shift + 8 (passes - 1).
int radix_counts_launch(const void* rows, long long num_rows, long long row_words, int shift,
                        int passes, void* keys, void* counts, void* stream) {
  if (rows == nullptr || keys == nullptr || counts == nullptr || !rows_ok(num_rows) ||
      row_words <= 0 || passes < 1 || passes > kMaxPasses || shift < 0 ||
      shift + kBits * (passes - 1) >= 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rows == 0) return 0;
  long long grid = (num_rows + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * 8;
  if (grid > cap) grid = cap;
  radix_counts_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), num_rows, row_words, shift, passes,
      static_cast<uint32_t*>(keys), static_cast<unsigned int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// One stable pass on the digit at `shift`: (keys_in, vals_in) -> (keys_out, vals_out),
// num_rows pairs of uint32.  vals_in == nullptr: the row numbers are the positions
// (the first pass); keys_out == nullptr: only the row numbers are written (the last).
// counts: this pass's 256 digit counts; lookback (ceil(num_rows / radix_tile_rows())
// x 256 uint64) and ticket (uint32) zeroed.
int radix_onesweep_launch(const void* keys_in, const void* vals_in, void* keys_out,
                          void* vals_out, long long num_rows, int shift, const void* counts,
                          void* lookback, void* ticket, void* stream) {
  if (keys_in == nullptr || vals_out == nullptr || counts == nullptr || lookback == nullptr ||
      ticket == nullptr || !rows_ok(num_rows) || shift < 0 || shift >= 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rows == 0) return 0;
  const auto* ki = static_cast<const uint32_t*>(keys_in);
  const auto* vi = static_cast<const uint32_t*>(vals_in);
  auto* ko = static_cast<uint32_t*>(keys_out);
  auto* vo = static_cast<uint32_t*>(vals_out);
  const auto* c = static_cast<const unsigned int*>(counts);
  auto* lb = static_cast<unsigned long long*>(lookback);
  auto* tk = static_cast<unsigned int*>(ticket);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vi == nullptr) {
    return ko == nullptr ? launch_onesweep<true, true>(ki, vi, ko, vo, num_rows, shift, c, lb, tk, s)
                         : launch_onesweep<true, false>(ki, vi, ko, vo, num_rows, shift, c, lb, tk, s);
  }
  return ko == nullptr ? launch_onesweep<false, true>(ki, vi, ko, vo, num_rows, shift, c, lb, tk, s)
                       : launch_onesweep<false, false>(ki, vi, ko, vo, num_rows, shift, c, lb, tk, s);
}

// dst[i] <- src[perm[i]], rows of row_words 32-bit words; src and dst must not overlap.
int radix_permute_launch(const void* src, void* dst, const void* perm, long long num_rows,
                         long long row_words, void* stream) {
  if (src == nullptr || dst == nullptr || perm == nullptr || !rows_ok(num_rows) ||
      row_words <= 0 || row_words > 0x7fffffffLL / 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rows == 0) return 0;
  long long grid = ((num_rows + 31) / 32 + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sm_count()) * 16;
  if (grid > cap) grid = cap;
  radix_permute_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst),
      static_cast<const uint32_t*>(perm), num_rows, static_cast<int>(row_words));
  return static_cast<int>(cudaGetLastError());
}

const char* radix_sort_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
