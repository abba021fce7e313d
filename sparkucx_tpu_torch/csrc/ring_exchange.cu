// Scheduled ring exchange (K3), ring exchange with receive-side combine (K4) and
// the fused send side (K5) for Hopper (sm_90a), for executors that share one card.
//
// Replaces the Pallas kernels of sparkucx_tpu/ops/pallas_kernels.py:
//   * ring_exchange_launch               <- ring_exchange_grid (kernel :623, walk
//     _ring_exchange_steps :509): every executor's destination-major staging in,
//     every executor's sender-major grid out.  Receiver j's grid row
//     i*slot + c*w holds sender i's row j*slot + c*w: the own slot and one window
//     per schedule item (offset d, chunk c) from sender (j - d) mod n.
//   * ring_fold_launch + ring_merge_launch (shared tier), or ring_exchange_launch
//     + the ring_round_launch rounds (global tier) <- ring_combine_grid
//     (kernel :720): the same grid, and every landed window of
//     [key | payload | count] rows folded into receiver j's dense accumulator
//     (G, width) + counts (G, 1), own slot first, then the items in step order.
//   * fused_scatter_launch               <- fused_scatter_ring_grid (:805, kernel
//     :850): K2's scatter of every executor's packed map-output blocks into its
//     slot-layout staging (in place: the JAX kernel aliased staging to its second
//     output), then K3's copies straight out of that staging, in ONE launch.
//
// The Python side (ops/ring_kernels.py) turns the schedule into a window table,
// receiver-major and in that canonical order within a receiver, 5 int64 a window:
// (receiver, sender, src_row, dst_row, rows).  Executors' staging and grids are
// addressed through tables of pointers, one per executor (K3 carries its tables
// in the launch's parameters, K4's fold and K5 read them from device memory), so
// the same kernels can later take peer pointers.
//
// Bound: bytes.  K3 reads every staged row once and writes it once
// (2 * n * n * slot * row_bytes).  K4 moves the same bytes plus its O(groups)
// accumulator; its fold is a handful of integer or float operations per valid
// row, far below the card's rate.  K5's function reads every packed row, writes
// it into the staging, reads the staging rows no block covers and writes the
// grid: packed bytes + 2 * grid bytes.  This two-phase design moves 2 * packed +
// 2 * grid bytes, what K2 and K3 move back to back (it reads the scattered rows
// back out of the staging), so fusing saves a launch and none of the bytes; a
// write-through design that stores each packed row to the staging and the grid
// at once, never reading it back, would move the bound's bytes (later work).
//
// K3's design.  A pure copy at the memory's rate needs the card's bytes in flight
// (about latency x bandwidth, some 25 KB an SM) and no per-call host work.  The
// window table and its row prefix depend only on the schedule, so the wrapper keeps
// them on the device (a bounded cache) and passes the executors' staging and grid
// base pointers by value, in the launch's parameters (at most kMaxExecs executors);
// a call uploads nothing.  The windows, laid end to end in table order, form one
// byte stream cut into kChunkBytes chunks, one CTA a chunk, as a large device copy
// is cut: the hardware keeps up to 8 of these CTAs on an SM and starts the next one
// as one ends, so an SM keeps up to 128 KB of loads in flight.  A CTA finds its
// chunk's window in the cached row prefix (a binary search over a few hundred
// bytes that stay in cache) and steps into the next window where the chunk crosses
// one.  Pieces that are 16-byte multiples in address and length are copied by all
// the CTA's threads with 16-byte loads, kVectorUnroll in flight a thread; others
// (rows of 36 B, a view off the alignment) in 4-byte words, inside the same launch.
// All offsets are 64-bit.
// Measured on an H100 at chip_smoke.py phase 13's shape (4 x 4 x 623,182 rows of
// 512 B; bound 3.05 ms, one contiguous device copy of the same bytes 3.36-3.40 ms):
// the first redesign, persistent CTAs (one an SM) taking every 132nd 64 KB chunk
// with 8 loads in flight a thread, took 3.52-3.57 ms; a ring of 6 shared-memory
// stages of 32 KB a CTA, thread 0 issuing a TMA bulk load (cp.async.bulk global ->
// shared, completion on the stage's mbarrier) and a bulk store per stage, took
// 3.61-3.65 ms.  PERF.md has this design's times.
//
// K5's design.  The TPU kernel ordered every peer's scatter before any remote
// read with a barrier; here the two phases are separated by a grid-wide barrier
// inside one cooperative launch (cudaLaunchCooperativeKernel), whose grid is the
// number of CTAs that can be resident at once (occupancy x SMs), so every CTA
// reaches the barrier.  The barrier is a counter in device memory: each CTA
// fences its writes, adds one, and spins (volatile loads) until all of this
// launch have arrived.
// Phase 1 walks each executor's packed rows in equal spans per CTA with K2's
// mapping (row_copy.cuh), through per-executor pointer tables; phase 2 walks K3's
// first design's spans grid-stride, reading the staging with L2-only loads
// (__ldcg), since rows written by other SMs in phase 1 must not come from a stale
// L1 line.  Staging rows no block covers carry into the grid unchanged; zero-count
// blocks are no-ops.  All offsets are 64-bit.
//
// K4's design.  Every window is cut into spans of `span_rows` rows, one span per
// CTA (a span never crosses a window; K3's first design); a span is walked in tiles
// of 256 rows: the tile is copied as a flat run of 16-byte words (4-byte words where
// the row width or a pointer is not 16-byte aligned), then folded while its rows
// are still in L1.  All offsets are 64-bit.
//
// The fold is deterministic and uses no float atomics.  Shared-memory tier
// (G * (width + 1) words fit in shared memory): a CTA folds its span into a
// dense partial in shared memory, tile by tile; inside a tile each warp merges
// the lanes that share a key (__match_any_sync) in lane order, and the warps
// apply their merged rows one warp after another.  Each span's partial goes to
// a scratch table, and ring_merge_kernel folds, per (receiver, group, lane),
// the spans of a window in order into a window partial and the windows in
// canonical order into the accumulator: acc = op(acc, window), the structure
// of the JAX fold acc + sum(window).  Global tier (larger G, e.g. 2^23 groups):
// the grid is copied first (K3's launch), then each canonical window index is folded in
// rounds: every pending valid row bids its row index for its group with an
// integer atomicMin, the lowest bidder applies its row to the accumulator with
// plain loads and stores, and the rest wait for the next round.  A window whose
// keys are distinct folds in one round; duplicates fold in row order, one row
// per group and round.  Integer folds are bit-equal to the plain version
// always, float folds whenever no key repeats inside a window.  Quantized
// payloads are dequantized in the kernel exactly as dequantize_rows does:
// q * scale rounded once in float32 (__fmul_rn, never contracted into an FMA).

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#include "row_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = kThreads;  // rows folded per tile: one per thread
constexpr int kMaxWidth = 16;        // aggregate columns a row may carry
constexpr int kWindowWords = 5;      // receiver, sender, src_row, dst_row, rows

enum : int { kSum = 0, kMin = 1, kMax = 2 };

struct Ops {
  int op[kMaxWidth];
};

struct FoldGeometry {
  int num_groups;  // G
  int width;       // aggregate columns
  int lanes;       // 32-bit words of one row
  int qblock;      // quantize block size (values per scale), 0 = plain lanes
  int wq4;         // packed int8 words of a quantized payload
};

template <typename T>
__device__ __forceinline__ T from_bits(uint32_t w);
template <>
__device__ __forceinline__ int from_bits<int>(uint32_t w) { return static_cast<int>(w); }
template <>
__device__ __forceinline__ float from_bits<float>(uint32_t w) { return __uint_as_float(w); }

__device__ __forceinline__ uint32_t to_bits(int v) { return static_cast<uint32_t>(v); }
__device__ __forceinline__ uint32_t to_bits(float v) { return __float_as_uint(v); }

__device__ __forceinline__ int add(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

template <typename T>
__device__ __forceinline__ T identity(int op);
template <>
__device__ __forceinline__ int identity<int>(int op) {
  return op == kMin ? INT_MAX : (op == kMax ? INT_MIN : 0);
}
template <>
__device__ __forceinline__ float identity<float>(int op) {
  return op == kMin ? FLT_MAX : (op == kMax ? -FLT_MAX : 0.0f);
}

// op(a, b) with a the running value: min/max keep a on ties, as torch's
// scatter_reduce amin/amax and torch.minimum/maximum do.
template <typename T>
__device__ __forceinline__ T fold(int op, T a, T b) {
  if (op == kSum) return add(a, b);
  if (op == kMin) return b < a ? b : a;
  return a < b ? b : a;
}

// Lane `lane` of the accumulator: a value column (lane < width) or the count.
template <typename T>
__device__ __forceinline__ uint32_t fold_bits(const Ops& ops, int width, int lane, uint32_t a,
                                              uint32_t b) {
  if (lane == width) return to_bits(add(from_bits<int>(a), from_bits<int>(b)));
  return to_bits(fold<T>(ops.op[lane], from_bits<T>(a), from_bits<T>(b)));
}

template <typename T>
__device__ __forceinline__ uint32_t identity_bits(const Ops& ops, int width, int lane) {
  return lane == width ? 0u : to_bits(identity<T>(ops.op[lane]));
}

// Value column c of one row, dequantized when the payload is quantized.
template <typename T, bool kQuant>
__device__ __forceinline__ T load_value(const uint32_t* row, int c, const FoldGeometry& g) {
  if (!kQuant) return from_bits<T>(row[1 + c]);
  const uint32_t word = row[1 + (c >> 2)];
  const int q = static_cast<int>(static_cast<int8_t>((word >> (8 * (c & 3))) & 0xFFu));
  const float scale = __uint_as_float(row[1 + g.wq4 + c / g.qblock]);
  return static_cast<T>(__fmul_rn(static_cast<float>(q), scale));
}

// Window of a span: the last window whose first span is <= span.
__device__ __forceinline__ int find_window(const long long* __restrict__ span_start,
                                           int num_windows, long long span) {
  int lo = 0, hi = num_windows - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(span_start + mid) <= span) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

template <typename Word>
__device__ __forceinline__ void copy_words(const Word* __restrict__ src, Word* __restrict__ dst,
                                           long long words) {
  long long k = threadIdx.x;
  for (; k + 3 * kThreads < words; k += 4 * kThreads) {
    const Word a = src[k], b = src[k + kThreads], c = src[k + 2 * kThreads],
               d = src[k + 3 * kThreads];
    dst[k] = a;
    dst[k + kThreads] = b;
    dst[k + 2 * kThreads] = c;
    dst[k + 3 * kThreads] = d;
  }
  for (; k < words; k += kThreads) dst[k] = src[k];
}

// -- K3 -------------------------------------------------------------------------

constexpr int kMaxExecs = 64;          // executors whose pointers one K3 launch carries
constexpr int kCopyThreads = 256;
constexpr int kChunkBytes = 32 * 1024; // the bytes of the stream one CTA copies
constexpr int kVectorUnroll = 4;       // 16-byte loads in flight a thread

struct RingCopyArgs {
  const long long* windows;    // (num_windows, kWindowWords), the wrapper's cached table
  const long long* row_start;  // (num_windows + 1) rows before each window, in table order
  int num_windows;
  int num_execs;
  long long row_bytes;
  const uint8_t* src[kMaxExecs];  // executor i's staging
  uint8_t* dst[kMaxExecs];        // receiver j's grid
};

// All the CTA's threads copy n bytes as Words, kUnroll loads in flight a thread.
template <typename Word, int kUnroll>
__device__ __forceinline__ void copy_piece(const uint8_t* s, uint8_t* d, long long n) {
  const Word* sw = reinterpret_cast<const Word*>(s);
  Word* dw = reinterpret_cast<Word*>(d);
  const long long words = n / static_cast<long long>(sizeof(Word));
  long long k = threadIdx.x;
  for (; k + (kUnroll - 1) * kCopyThreads < words; k += kUnroll * kCopyThreads) {
    Word x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x[u] = sw[k + u * kCopyThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dw[k + u * kCopyThreads] = x[u];
  }
  for (; k < words; k += kCopyThreads) dw[k] = sw[k];
}

// The window holding byte `at` of the stream of windows: its bounds in the stream
// and its source and destination bases.
struct WindowCursor {
  int v;
  long long begin, end;
  const uint8_t* src;
  uint8_t* dst;

  __device__ void load(const RingCopyArgs& a, int window) {
    v = window;
    begin = __ldg(a.row_start + v) * a.row_bytes;
    end = __ldg(a.row_start + v + 1) * a.row_bytes;
    const long long* win = a.windows + static_cast<long long>(v) * kWindowWords;
    src = a.src[__ldg(win + 1)] + __ldg(win + 2) * a.row_bytes;
    dst = a.dst[__ldg(win + 0)] + __ldg(win + 3) * a.row_bytes;
  }
};

// One CTA a chunk of the stream; the chunk may cross from one window into the next.
__global__ void __launch_bounds__(kCopyThreads) ring_exchange_kernel(const __grid_constant__ RingCopyArgs a) {
  const long long total = __ldg(a.row_start + a.num_windows) * a.row_bytes;
  long long at = static_cast<long long>(blockIdx.x) * kChunkBytes;
  const long long stop = min(at + kChunkBytes, total);
  int lo = 0, hi = a.num_windows - 1;  // the last window starting at or before `at`
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(a.row_start + mid) * a.row_bytes <= at) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  WindowCursor w;
  w.load(a, lo);
  while (at < stop) {
    while (at >= w.end) w.load(a, w.v + 1);
    const long long n = min(stop, w.end) - at;
    const uint8_t* s = w.src + (at - w.begin);
    uint8_t* d = w.dst + (at - w.begin);
    if (((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d) |
          static_cast<uintptr_t>(n)) & 15) != 0) {
      copy_piece<uint32_t, 4>(s, d, n);
    } else {
      copy_piece<int4, kVectorUnroll>(s, d, n);
    }
    at += n;
  }
}

// K4's copy and shared-memory fold.  One CTA a span, grid-stride.
template <typename Word, typename T, bool kQuant>
__global__ void __launch_bounds__(kThreads)
ring_span_kernel(const long long* __restrict__ windows, const long long* __restrict__ span_start,
                 int num_windows, long long span_rows, const uint8_t* const* __restrict__ src,
                 uint8_t* const* __restrict__ dst, long long row_bytes, Ops ops, FoldGeometry g,
                 uint32_t* __restrict__ partials) {
  extern __shared__ uint32_t part[];  // (G, width + 1) words
  const long long total_spans = span_start[num_windows];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int part_words = g.num_groups * (g.width + 1);

  for (long long span = blockIdx.x; span < total_spans; span += gridDim.x) {
    const int w = find_window(span_start, num_windows, span);
    const long long* win = windows + static_cast<long long>(w) * kWindowWords;
    const long long receiver = win[0], sender = win[1], rows = win[4];
    const long long r0 = (span - span_start[w]) * span_rows;
    const long long r1 = min(r0 + span_rows, rows);
    const uint8_t* s = src[sender] + (win[2] + r0) * row_bytes;
    uint8_t* d = dst[receiver] + (win[3] + r0) * row_bytes;

    for (int i = threadIdx.x; i < part_words; i += kThreads) {
      part[i] = identity_bits<T>(ops, g.width, i % (g.width + 1));
    }
    __syncthreads();
    for (long long t = 0; t < r1 - r0; t += kTileRows) {
      const long long tile_rows = min(static_cast<long long>(kTileRows), r1 - r0 - t);
      const long long words = tile_rows * row_bytes / static_cast<long long>(sizeof(Word));
      copy_words(reinterpret_cast<const Word*>(s + t * row_bytes),
                 reinterpret_cast<Word*>(d + t * row_bytes), words);

      const uint32_t* row =
          reinterpret_cast<const uint32_t*>(s + (t + threadIdx.x) * row_bytes);
      bool valid = threadIdx.x < tile_rows;
      uint32_t key = 0;
      int count = 0;
      if (valid) {
        key = row[0];
        count = static_cast<int>(row[g.lanes - 1]);
        valid = count > 0 && key < static_cast<uint32_t>(g.num_groups);
      }
      if (!__syncthreads_or(valid)) continue;

      // lanes sharing a key merge into their lowest lane, in lane order
      const unsigned peers = __match_any_sync(0xffffffffu, valid ? key : 0xffffffffu);
      const bool leader = valid && (__ffs(peers) - 1) == lane;
      T merged[kMaxWidth];
      int merged_count = 0;
      if (__any_sync(0xffffffffu, valid)) {
        for (int c = 0; c < g.width; ++c) {
          const T v = valid ? load_value<T, kQuant>(row, c, g) : identity<T>(ops.op[c]);
          T acc = identity<T>(ops.op[c]);
          for (int l = 0; l < 32; ++l) {
            const T other = __shfl_sync(0xffffffffu, v, l);
            if ((peers >> l) & 1u) acc = fold<T>(ops.op[c], acc, other);
          }
          merged[c] = acc;
        }
        for (int l = 0; l < 32; ++l) {
          const int other = __shfl_sync(0xffffffffu, count, l);
          if ((peers >> l) & 1u) merged_count = add(merged_count, other);
        }
      }
      // warps apply in row order; a warp's leaders hold distinct keys
      for (int wi = 0; wi < kWarps; ++wi) {
        if (warp == wi && leader) {
          uint32_t* p = part + static_cast<long long>(key) * (g.width + 1);
          for (int c = 0; c < g.width; ++c) {
            p[c] = to_bits(fold<T>(ops.op[c], from_bits<T>(p[c]), merged[c]));
          }
          p[g.width] = to_bits(add(from_bits<int>(p[g.width]), merged_count));
        }
        __syncthreads();
      }
    }
    __syncthreads();
    uint32_t* out = partials + span * part_words;
    for (int i = threadIdx.x; i < part_words; i += kThreads) out[i] = part[i];
    __syncthreads();  // the partial is re-initialised by the next span
  }
}

// K4, shared-memory tier: one thread per (receiver, group, lane).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_merge_kernel(const long long* __restrict__ span_start, int num_receivers,
                  int windows_per_receiver, const uint32_t* __restrict__ partials, Ops ops,
                  FoldGeometry g, uint32_t* __restrict__ acc_vals, int* __restrict__ acc_counts) {
  const int lanes = g.width + 1;
  const long long part_words = static_cast<long long>(g.num_groups) * lanes;
  const long long total = static_cast<long long>(num_receivers) * part_words;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int j = static_cast<int>(i / part_words);
    const long long gl = i - j * part_words;  // group * lanes + lane
    const int lane = static_cast<int>(gl % lanes);
    const long long group = gl / lanes;
    uint32_t acc = identity_bits<T>(ops, g.width, lane);
    for (int w = j * windows_per_receiver; w < (j + 1) * windows_per_receiver; ++w) {
      uint32_t wp = identity_bits<T>(ops, g.width, lane);
      for (long long s = span_start[w]; s < span_start[w + 1]; ++s) {
        wp = fold_bits<T>(ops, g.width, lane, wp, __ldg(partials + s * part_words + gl));
      }
      acc = fold_bits<T>(ops, g.width, lane, acc, wp);
    }
    if (lane == g.width) {
      acc_counts[static_cast<long long>(j) * g.num_groups + group] = static_cast<int>(acc);
    } else {
      acc_vals[(static_cast<long long>(j) * g.num_groups + group) * g.width + lane] = acc;
    }
  }
}

// K4, global tier: the rows of canonical window `index` of every receiver,
// read from the landed grids (receiver j's at grid + j * grid_bytes).  grid.y =
// receiver.
struct RoundArgs {
  const long long* windows;
  int windows_per_receiver;
  int index;
  const uint8_t* grid;
  long long grid_bytes;
  long long row_bytes;
  long long max_rows;  // rows of the largest window of this index
  uint8_t* done;       // (receivers, max_rows) rows already folded
  int* owner;          // (receivers, G) lowest pending row per group, INT_MAX = none
  int* pending;        // set when a row has to wait for the next round
};

template <bool kApply, typename T, bool kQuant>
__global__ void __launch_bounds__(kThreads)
ring_round_kernel(RoundArgs a, Ops ops, FoldGeometry g, uint32_t* __restrict__ acc_vals,
                  int* __restrict__ acc_counts) {
  const int j = blockIdx.y;
  const long long* win =
      a.windows + (static_cast<long long>(j) * a.windows_per_receiver + a.index) * kWindowWords;
  const long long rows = win[4];
  const uint8_t* base = a.grid + j * a.grid_bytes + win[3] * a.row_bytes;
  uint8_t* done = a.done + j * a.max_rows;
  int* owner = a.owner + static_cast<long long>(j) * g.num_groups;
  for (long long r = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; r < rows;
       r += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (done[r]) continue;
    const uint32_t* row = reinterpret_cast<const uint32_t*>(base + r * a.row_bytes);
    const uint32_t key = row[0];
    const int count = static_cast<int>(row[g.lanes - 1]);
    if (count <= 0 || key >= static_cast<uint32_t>(g.num_groups)) {
      done[r] = 1;
      continue;
    }
    int* bid = owner + key;
    if (!kApply) {
      atomicMin(bid, static_cast<int>(r));
      continue;
    }
    if (*bid != static_cast<int>(r)) {
      *a.pending = 1;
      continue;
    }
    const long long slot = static_cast<long long>(j) * g.num_groups + key;
    uint32_t* v = acc_vals + slot * g.width;
    for (int c = 0; c < g.width; ++c) {
      v[c] = to_bits(fold<T>(ops.op[c], from_bits<T>(v[c]), load_value<T, kQuant>(row, c, g)));
    }
    acc_counts[slot] = add(acc_counts[slot], count);
    done[r] = 1;
    *bid = INT_MAX;
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess) return 132;
    if (cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
      count = 132;
    }
  }
  return count;
}

Ops make_ops(const int* ops, int width) {
  Ops o{};
  for (int c = 0; c < width && c < kMaxWidth; ++c) o.op[c] = ops[c];
  return o;
}

template <typename Word, typename T, bool kQuant>
int launch_spans(const long long* windows, const long long* span_start, int num_windows,
                 long long total_spans, long long span_rows, const void* src_ptrs,
                 const void* dst_ptrs, long long row_bytes, Ops ops, FoldGeometry g,
                 void* partials, cudaStream_t stream) {
  auto kernel = ring_span_kernel<Word, T, kQuant>;
  const size_t smem = static_cast<size_t>(g.num_groups) * (g.width + 1) * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  long long grid = total_spans;
  const long long cap = static_cast<long long>(sm_count()) * 64;
  if (grid > cap) grid = cap;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      windows, span_start, num_windows, span_rows,
      static_cast<const uint8_t* const*>(src_ptrs), static_cast<uint8_t* const*>(dst_ptrs),
      row_bytes, ops, g, static_cast<uint32_t*>(partials));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kQuant>
int dispatch_word(bool wide, const long long* windows, const long long* span_start,
                  int num_windows, long long total_spans, long long span_rows,
                  const void* src_ptrs, const void* dst_ptrs, long long row_bytes, Ops ops,
                  FoldGeometry g, void* partials, cudaStream_t stream) {
  if (wide) {
    return launch_spans<int4, T, kQuant>(windows, span_start, num_windows, total_spans,
                                                span_rows, src_ptrs, dst_ptrs, row_bytes, ops,
                                                g, partials, stream);
  }
  return launch_spans<int, T, kQuant>(windows, span_start, num_windows, total_spans,
                                             span_rows, src_ptrs, dst_ptrs, row_bytes, ops, g,
                                             partials, stream);
}

bool check_geometry(const FoldGeometry& g, int is_float, long long row_bytes) {
  if (g.num_groups <= 0 || g.width < 0 || g.width > kMaxWidth) return false;
  if (g.lanes * 4LL != row_bytes || g.lanes < 2) return false;
  if (g.qblock > 0 && (!is_float || g.qblock % 4 != 0)) return false;
  return true;
}

// K5: everything one launch needs.
struct FusedArgs {
  const int* starts;  // (num_execs, num_blocks): staging row of each block
  const int* counts;  // (num_execs, num_blocks): rows of each block
  const int* outs;    // (num_execs, num_blocks): packed row of each block
  int num_blocks;
  int num_execs;
  const uint8_t* const* packed;     // per-executor packed map output
  long long packed_rows;            // rows of one executor's packed map output
  uint8_t* const* staging;          // per-executor slot-layout staging (written)
  long long staging_rows;           // rows of one executor's staging
  const long long* windows;         // K3's window table
  const long long* span_start;      // K3's span prefix
  int num_windows;
  long long span_rows;
  uint8_t* const* grid;             // per-executor sender-major grid
  long long row_bytes;
  unsigned int* arrived;            // barrier counter, a multiple of the grid size at launch
};

// Copy `words` words, reading through L2 only (data written earlier in this launch).
template <typename Word>
__device__ __forceinline__ void copy_words_cg(const Word* src, Word* dst, long long words) {
  long long k = threadIdx.x;
  for (; k + 3 * kThreads < words; k += 4 * kThreads) {
    const Word a = __ldcg(src + k), b = __ldcg(src + k + kThreads),
               c = __ldcg(src + k + 2 * kThreads), d = __ldcg(src + k + 3 * kThreads);
    dst[k] = a;
    dst[k + kThreads] = b;
    dst[k + 2 * kThreads] = c;
    dst[k + 3 * kThreads] = d;
  }
  for (; k < words; k += kThreads) dst[k] = __ldcg(src + k);
}

// Every CTA of the (co-resident) grid arrives before any leaves.  The counter only
// grows: a launch's arrivals take it from k * gridDim.x to (k + 1) * gridDim.x, so
// launches of one grid size in stream order can reuse it without a reset.
__device__ __forceinline__ void grid_barrier(unsigned int* arrived) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int before = atomicAdd(arrived, 1u);
    const unsigned int target = (before / gridDim.x + 1) * gridDim.x;
    while (*reinterpret_cast<volatile unsigned int*>(arrived) < target) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

template <typename Word>
__global__ void __launch_bounds__(kThreads) fused_scatter_ring_kernel(FusedArgs a) {
  __shared__ rowcopy::Scratch sh;
  const long long words_per_row = a.row_bytes / static_cast<long long>(sizeof(Word));

  // phase 1: K2's scatter, executor by executor, equal packed-row spans per CTA;
  // a packed plan's last block ends at its executor's packed total
  for (int e = 0; e < a.num_execs; ++e) {
    const long long last = static_cast<long long>(e) * a.num_blocks + a.num_blocks - 1;
    const long long total =
        a.num_blocks > 0
            ? min(static_cast<long long>(__ldg(a.outs + last)) + __ldg(a.counts + last), a.packed_rows)
            : 0;
    const long long tiles = (total + rowcopy::kRows - 1) / rowcopy::kRows;
    const long long rows_per_cta = ((tiles + gridDim.x - 1) / gridDim.x) * rowcopy::kRows;
    const long long begin = static_cast<long long>(blockIdx.x) * rows_per_cta;
    const long long end = min(begin + rows_per_cta, total);
    if (begin >= end) continue;
    const long long plan = static_cast<long long>(e) * a.num_blocks;
    rowcopy::copy_packed_rows<Word, false>(
        a.starts + plan, a.counts + plan, a.outs + plan, a.num_blocks,
        reinterpret_cast<const Word*>(a.packed[e]), reinterpret_cast<Word*>(a.staging[e]), begin,
        end, a.staging_rows, words_per_row, sh);
  }

  grid_barrier(a.arrived);

  // phase 2: K3's window copies out of the staging just written
  const long long total_spans = a.span_start[a.num_windows];
  for (long long span = blockIdx.x; span < total_spans; span += gridDim.x) {
    const int w = find_window(a.span_start, a.num_windows, span);
    const long long* win = a.windows + static_cast<long long>(w) * kWindowWords;
    const long long receiver = win[0], sender = win[1], rows = win[4];
    const long long r0 = (span - a.span_start[w]) * a.span_rows;
    const long long r1 = min(r0 + a.span_rows, rows);
    const uint8_t* s = a.staging[sender] + (win[2] + r0) * a.row_bytes;
    uint8_t* d = a.grid[receiver] + (win[3] + r0) * a.row_bytes;
    copy_words_cg(reinterpret_cast<const Word*>(s), reinterpret_cast<Word*>(d),
                  (r1 - r0) * words_per_row);
  }
}

// CTAs of one cooperative K5 launch: all that can be resident at once.
template <typename Word>
int fused_grid_size(int* ctas) {
  int device = 0, cooperative = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch, device);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_scatter_ring_kernel<Word>,
                                                        kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!cooperative || per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *ctas = per_sm * sms;
  return 0;
}

template <typename Word>
int launch_fused(FusedArgs a, cudaStream_t stream) {
  int ctas = 0;
  const int rc = fused_grid_size<Word>(&ctas);
  if (rc != 0) return rc;
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_scatter_ring_kernel<Word>), dim3(ctas), dim3(kThreads),
      args, 0, stream));
}

}  // namespace

extern "C" {

// K3: every window of the table (all n * n regions) in one launch.  `table` (device)
// holds the (num_windows x 5) window table, then its (num_windows + 1) row prefix,
// whose last entry is total_rows.  Executor i's staging starts at src_base + i *
// exec_bytes and receiver j's grid at dst_base + j * exec_bytes; the launch carries
// them as tables of pointers, by value.
int ring_exchange_launch(const long long* table, int num_windows, long long total_rows,
                         int num_execs, long long src_base, long long dst_base,
                         long long exec_bytes, long long row_bytes, void* stream) {
  if (num_windows <= 0 || total_rows <= 0) return 0;
  if (table == nullptr || num_execs < 1 || num_execs > kMaxExecs || row_bytes <= 0 ||
      row_bytes % 4 != 0 || src_base == 0 || dst_base == 0 || exec_bytes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RingCopyArgs a{};
  a.windows = table;
  a.row_start = table + static_cast<long long>(num_windows) * kWindowWords;
  a.num_windows = num_windows;
  a.num_execs = num_execs;
  a.row_bytes = row_bytes;
  for (int i = 0; i < num_execs; ++i) {
    a.src[i] = reinterpret_cast<const uint8_t*>(src_base + i * exec_bytes);
    a.dst[i] = reinterpret_cast<uint8_t*>(dst_base + i * exec_bytes);
  }
  const long long chunks = (total_rows * row_bytes + kChunkBytes - 1) / kChunkBytes;
  if (chunks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  ring_exchange_kernel<<<static_cast<unsigned>(chunks), kCopyThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int ring_max_execs() { return kMaxExecs; }

// K4 shared-memory tier, step 1: copy every window and fold each span into
// partials (total_spans, G, width + 1) words.
int ring_fold_launch(const long long* windows, const long long* span_start, int num_windows,
                     long long total_spans, long long span_rows, const void* src_ptrs,
                     const void* dst_ptrs, long long row_bytes, int wide, const int* ops,
                     int width, int num_groups, int is_float, int qblock, int wq4,
                     void* partials, void* stream) {
  if (num_windows <= 0 || total_spans <= 0) return 0;
  FoldGeometry g{num_groups, width, static_cast<int>(row_bytes / 4), qblock, wq4};
  if (!check_geometry(g, is_float, row_bytes) || span_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Ops o = make_ops(ops, width);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool w = wide != 0;
  if (!is_float) {
    return dispatch_word<int, false>(w, windows, span_start, num_windows, total_spans,
                                           span_rows, src_ptrs, dst_ptrs, row_bytes, o, g,
                                           partials, s);
  }
  if (qblock > 0) {
    return dispatch_word<float, true>(w, windows, span_start, num_windows, total_spans,
                                            span_rows, src_ptrs, dst_ptrs, row_bytes, o, g,
                                            partials, s);
  }
  return dispatch_word<float, false>(w, windows, span_start, num_windows, total_spans,
                                           span_rows, src_ptrs, dst_ptrs, row_bytes, o, g,
                                           partials, s);
}

// K4 shared-memory tier, step 2: fold the partials in canonical order into
// acc_vals (receivers, G, width) and acc_counts (receivers, G).
int ring_merge_launch(const long long* span_start, int num_receivers, int windows_per_receiver,
                      const void* partials, const int* ops, int width, int num_groups,
                      int is_float, void* acc_vals, void* acc_counts, void* stream) {
  const long long total = static_cast<long long>(num_receivers) * num_groups * (width + 1);
  if (total <= 0) return 0;
  if (width < 0 || width > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
  const Ops o = make_ops(ops, width);
  FoldGeometry g{num_groups, width, width + 2, 0, 0};
  long long grid = (total + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * 16;
  if (grid > cap) grid = cap;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_float) {
    ring_merge_kernel<float><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        span_start, num_receivers, windows_per_receiver, static_cast<const uint32_t*>(partials),
        o, g, static_cast<uint32_t*>(acc_vals), static_cast<int*>(acc_counts));
  } else {
    ring_merge_kernel<int><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        span_start, num_receivers, windows_per_receiver, static_cast<const uint32_t*>(partials),
        o, g, static_cast<uint32_t*>(acc_vals), static_cast<int*>(acc_counts));
  }
  return static_cast<int>(cudaGetLastError());
}

// K4 global tier: one round over canonical window `index` of every receiver, over
// the grids K3's launch landed (receiver j's at grid_base + j * grid_bytes).
// apply = 0 bids (atomicMin of the row index per group), apply = 1 folds the
// winning rows into the accumulator and raises *pending for the others.
int ring_round_launch(int apply, const long long* windows, int num_receivers,
                      int windows_per_receiver, int index, const void* grid_base,
                      long long grid_bytes, long long row_bytes, long long max_rows, void* done,
                      void* owner, void* pending, const int* ops, int width, int num_groups,
                      int is_float, int qblock, int wq4, void* acc_vals, void* acc_counts,
                      void* stream) {
  if (num_receivers <= 0 || max_rows <= 0) return 0;
  FoldGeometry g{num_groups, width, static_cast<int>(row_bytes / 4), qblock, wq4};
  if (!check_geometry(g, is_float, row_bytes)) return static_cast<int>(cudaErrorInvalidValue);
  const Ops o = make_ops(ops, width);
  RoundArgs a{windows, windows_per_receiver, index, static_cast<const uint8_t*>(grid_base),
              grid_bytes, row_bytes, max_rows, static_cast<uint8_t*>(done), static_cast<int*>(owner),
              static_cast<int*>(pending)};
  long long blocks = (max_rows + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * 16;
  if (blocks > cap) blocks = cap;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(num_receivers));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* av = static_cast<uint32_t*>(acc_vals);
  int* ac = static_cast<int*>(acc_counts);
  if (!is_float) {
    if (apply) ring_round_kernel<true, int, false><<<grid, kThreads, 0, s>>>(a, o, g, av, ac);
    else ring_round_kernel<false, int, false><<<grid, kThreads, 0, s>>>(a, o, g, av, ac);
  } else if (qblock > 0) {
    if (apply) ring_round_kernel<true, float, true><<<grid, kThreads, 0, s>>>(a, o, g, av, ac);
    else ring_round_kernel<false, float, true><<<grid, kThreads, 0, s>>>(a, o, g, av, ac);
  } else {
    if (apply) ring_round_kernel<true, float, false><<<grid, kThreads, 0, s>>>(a, o, g, av, ac);
    else ring_round_kernel<false, float, false><<<grid, kThreads, 0, s>>>(a, o, g, av, ac);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5: every executor's blocks scattered into its staging, then every window of
// the table copied into the grids, in one cooperative launch.  `tables` holds, as
// int64, the packed, staging and grid pointer tables (num_execs each), then the
// barrier counter (zero, or left by earlier launches of these tables).  `wide`
// selects 16-byte words; the caller sets it only when row_bytes and every pointer
// are 16-byte aligned.
int fused_scatter_launch(const int* starts, const int* counts, const int* outs, int num_blocks,
                         int num_execs, const long long* tables, long long packed_rows,
                         long long staging_rows, const long long* windows,
                         const long long* span_start, int num_windows, long long span_rows,
                         long long row_bytes, int wide, void* stream) {
  if (num_execs <= 0 || num_windows <= 0) return 0;
  if (row_bytes <= 0 || row_bytes % 4 != 0 || span_rows <= 0 || num_blocks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long* ptrs = tables;
  FusedArgs a{starts, counts, outs, num_blocks, num_execs,
              reinterpret_cast<const uint8_t* const*>(ptrs), packed_rows,
              reinterpret_cast<uint8_t* const*>(ptrs + num_execs), staging_rows,
              windows, span_start, num_windows, span_rows,
              reinterpret_cast<uint8_t* const*>(ptrs + 2 * num_execs), row_bytes,
              reinterpret_cast<unsigned int*>(const_cast<long long*>(ptrs + 3 * num_execs))};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wide ? launch_fused<int4>(a, s) : launch_fused<int>(a, s);
}

// CTAs a K5 launch uses on the current device (16-byte words when `wide`).
int fused_scatter_grid_size(int wide) {
  int ctas = 0;
  const int rc = wide ? fused_grid_size<int4>(&ctas) : fused_grid_size<int>(&ctas);
  return rc != 0 ? -rc : ctas;
}

int ring_max_width() { return kMaxWidth; }

const char* ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
