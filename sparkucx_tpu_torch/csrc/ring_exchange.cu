// Scheduled ring exchange (K3), ring exchange with receive-side combine (K4) and
// the fused send side (K5) for Hopper (sm_90a), for executors that share one card.
//
// Replaces the Pallas kernels of sparkucx_tpu/ops/pallas_kernels.py:
//   * ring_exchange_launch               <- ring_exchange_grid (kernel :623, walk
//     _ring_exchange_steps :509): every executor's destination-major staging in,
//     every executor's sender-major grid out.  Receiver j's grid row
//     i*slot + c*w holds sender i's row j*slot + c*w: the own slot and one window
//     per schedule item (offset d, chunk c) from sender (j - d) mod n.
//   * ring_fold_launch + ring_merge_launch (shared tier), or ring_acc_launch and
//     ring_combine_global_launch, or ring_exchange_launch + ring_ordered_fold_launch
//     (global tier) <- ring_combine_grid (kernel :720): the same grid, and every
//     landed window of [key | payload | count] rows folded into receiver j's dense
//     accumulator (G, width) + counts (G, 1), own slot first, then the items in
//     step order.
//   * fused_scatter_launch               <- fused_scatter_ring_grid (:805, kernel
//     :850): K2's scatter of every executor's packed map-output blocks into its
//     slot-layout staging (in place: the JAX kernel aliased staging to its second
//     output), then K3's copies straight out of that staging, in ONE launch.
//
// The Python side (ops/ring_kernels.py) turns the schedule into a window table,
// receiver-major and in that canonical order within a receiver, 5 int64 a window:
// (receiver, sender, src_row, dst_row, rows).  Receivers' grids are addressed
// through tables of pointers, one per receiver (K3 carries its table in the
// launch's parameters, at most kMaxExecs receivers a launch; K4's shared tier and
// K5 read theirs from device memory), so the same kernels can later take peer
// pointers.
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
// them on the device (a bounded cache) and passes the receivers' grid pointers by
// value, in the launch's parameters, with the senders' staging as one base and
// stride; a call uploads nothing.  A launch addresses at most kMaxExecs receivers:
// the windows of receivers [first, first + kMaxExecs) are contiguous in the
// receiver-major table, so a call launches the same kernel once per such group,
// at an offset into the table and its prefix (any number of executors, as the
// TPU kernel takes; one launch up to kMaxExecs).  The windows, laid end to end in table order, form one
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
// Min and max fold on the JAX package's order (XLA's minimum/maximum): -0.0 lies
// below +0.0, and a NaN anywhere makes the result that NaN, its bits passed on.
// Float32 compares on fold_key, an int image of the bits with every NaN past the
// numbers on the fold's side (ops/combine.py fold_key), a total order, so the
// fold is associative and commutative and its bits do not depend on the order it
// meets the rows in.
//
// The fold is deterministic and uses no float atomics.  Shared-memory tier
// (G * (width + 1) words fit in shared memory): a CTA folds its span into a
// dense partial in shared memory, tile by tile; inside a tile each warp merges
// the lanes that share a key (__match_any_sync) in lane order, and the warps
// apply their merged rows one warp after another.  Each span's partial goes to
// a scratch table, and ring_merge_kernel folds, per (receiver, group, lane),
// the spans of a window in order into a window partial and the windows in
// canonical order into the accumulator: acc = op(acc, window), the structure
// of the JAX fold acc + sum(window).  Global tier (larger G, e.g. 2^23 groups, the
// accumulator in device memory): one call issues a fixed number of launches and
// never waits for the device (ring_acc_launch writes the identities first).
//   * No float sum column (int32 sums, the counts, min and max): the fold does not
//     depend on the order, since int32 addition wraps exactly and min/max are
//     total orders, so K3's chunk kernel folds while it copies: after copying its
//     chunk, a CTA folds every row whose first byte lies in the chunk, read back
//     from the staging it just read (in L1 or L2), into the accumulator with integer
//     atomics (atomicAdd, atomicMin/Max; float min/max a compare-and-swap loop
//     round fold that ends without a write once the value there wins).  One
//     launch a group of receivers, one pass over the bytes.
//   * A float sum column keeps the canonical order, own slot first, then the
//     windows in step order, rows in row order: K3 lands the group's grid, then
//     one cooperative launch loops on the device over window index and round.
//     In a round every pending valid row bids its row index for its group with
//     an integer atomicMin, a grid barrier (K5's counter barrier), then the
//     lowest bidder applies its whole row with plain loads and stores and the
//     rest raise `pending` (the last round in which a row waited), a barrier,
//     and every CTA reads `pending` to decide whether another round follows.
//     A window whose keys are distinct folds in one round; duplicates fold in
//     row order, one row per group and round.
// Integer folds are bit-equal to the plain version always, float folds whenever
// no key repeats inside a window (the plain version's scatter_reduce_ sums
// duplicates in its own order).  Quantized
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

// How far a min (+) or max (-) fold_key turns the ordered image round the int32
// range: the 2^23 - 1 NaNs of one sign then pass its end.
constexpr uint32_t kNanSpan = 0x7fffffu;

// An int image of a float's bits that orders as the floats do, -0.0 below +0.0,
// turned so that every NaN lies below -inf for min and above +inf for max
// (ops/combine.py fold_key); one key a bit pattern.
__device__ __forceinline__ int fold_key(int op, float v) {
  const int b = __float_as_int(v);
  const uint32_t image = static_cast<uint32_t>(b ^ ((b >> 31) & 0x7fffffff));
  return static_cast<int>(op == kMin ? image + kNanSpan : image - kNanSpan);
}

// op(a, b) with a the running value.
__device__ __forceinline__ int fold(int op, int a, int b) {
  if (op == kSum) return add(a, b);
  if (op == kMin) return b < a ? b : a;
  return a < b ? b : a;
}
__device__ __forceinline__ float fold(int op, float a, float b) {
  if (op == kSum) return add(a, b);
  const bool take_b = op == kMin ? fold_key(op, b) < fold_key(op, a) : fold_key(op, a) < fold_key(op, b);
  return take_b ? b : a;
}

// Lane `lane` of the accumulator: a value column (lane < width) or the count.
template <typename T>
__device__ __forceinline__ uint32_t fold_bits(const Ops& ops, int width, int lane, uint32_t a,
                                              uint32_t b) {
  if (lane == width) return to_bits(add(from_bits<int>(a), from_bits<int>(b)));
  return to_bits(fold(ops.op[lane], from_bits<T>(a), from_bits<T>(b)));
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

constexpr int kMaxExecs = 64;          // receivers whose grid pointers one K3 launch carries
constexpr int kCopyThreads = 256;
constexpr int kChunkBytes = 32 * 1024; // the bytes of the stream one CTA copies
constexpr int kVectorUnroll = 4;       // 16-byte loads in flight a thread

struct RingCopyArgs {
  const long long* windows;    // the group's first window of the wrapper's cached table
  const long long* row_start;  // its entry of the table's row prefix (rows before each window)
  int num_windows;             // windows of the group
  int first_receiver;          // the receiver of dst[0]
  long long row_bytes;
  const uint8_t* src;          // executor i's staging at src + i * exec_bytes
  long long exec_bytes;
  uint8_t* dst[kMaxExecs];     // receiver first_receiver + k's grid
};

// K4's global tier, when K3's kernel folds as it copies (an order-free fold).
struct GlobalFold {
  Ops ops;
  FoldGeometry g;
  uint32_t* acc_vals;  // (receivers, G, width)
  int* acc_counts;     // (receivers, G)
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

// The window holding byte `at` of the stream of windows: its bounds in the stream,
// its receiver and its source and destination bases.
struct WindowCursor {
  int v;
  long long begin, end, receiver;
  const uint8_t* src;
  uint8_t* dst;

  __device__ void load(const RingCopyArgs& a, int window) {
    v = window;
    begin = __ldg(a.row_start + v) * a.row_bytes;
    end = __ldg(a.row_start + v + 1) * a.row_bytes;
    const long long* win = a.windows + static_cast<long long>(v) * kWindowWords;
    receiver = __ldg(win + 0);
    src = a.src + __ldg(win + 1) * a.exec_bytes + __ldg(win + 2) * a.row_bytes;
    dst = a.dst[receiver - a.first_receiver] + __ldg(win + 3) * a.row_bytes;
  }
};

// op into *p, atomically; the op does not depend on the order the rows come in.
__device__ __forceinline__ void atomic_fold(int op, uint32_t* p, int v) {
  int* q = reinterpret_cast<int*>(p);
  if (op == kSum) {
    atomicAdd(q, v);
  } else if (op == kMin) {
    atomicMin(q, v);
  } else {
    atomicMax(q, v);
  }
}
// Float min/max (float sums never come here: the launcher refuses them): a
// compare-and-swap loop round fold, which stops without a write once the value
// already there wins.
__device__ __forceinline__ void atomic_fold(int op, uint32_t* p, float v) {
  uint32_t seen = *reinterpret_cast<volatile uint32_t*>(p);
  for (;;) {
    const uint32_t want = __float_as_uint(fold(op, __uint_as_float(seen), v));
    if (want == seen) return;
    const uint32_t prev = atomicCAS(p, seen, want);
    if (prev == seen) return;
    seen = prev;
  }
}

template <typename T, bool kQuant>
__device__ __forceinline__ void fold_row_atomic(const uint32_t* row, long long receiver,
                                                const GlobalFold& f) {
  const uint32_t key = row[0];
  const int count = static_cast<int>(row[f.g.lanes - 1]);
  if (count <= 0 || key >= static_cast<uint32_t>(f.g.num_groups)) return;
  const long long slot = receiver * f.g.num_groups + key;
  uint32_t* v = f.acc_vals + slot * f.g.width;
  for (int c = 0; c < f.g.width; ++c) atomic_fold(f.ops.op[c], v + c, load_value<T, kQuant>(row, c, f.g));
  atomicAdd(f.acc_counts + slot, count);
}

// One CTA a chunk of the group's stream; the chunk may cross from one window into
// the next.  kFold: then fold every row whose first byte lies in the chunk.
template <bool kFold, typename T, bool kQuant>
__global__ void __launch_bounds__(kCopyThreads)
ring_exchange_kernel(const __grid_constant__ RingCopyArgs a, const __grid_constant__ GlobalFold f) {
  const long long total = __ldg(a.row_start + a.num_windows) * a.row_bytes;
  const long long first = __ldg(a.row_start) * a.row_bytes + static_cast<long long>(blockIdx.x) * kChunkBytes;
  const long long stop = min(first + kChunkBytes, total);
  int lo = 0, hi = a.num_windows - 1;  // the last window starting at or before `first`
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(a.row_start + mid) * a.row_bytes <= first) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  WindowCursor w;
  w.load(a, lo);
  for (long long at = first; at < stop;) {
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
  if constexpr (kFold) {
    w.load(a, lo);
    for (long long at = first; at < stop;) {
      while (at >= w.end) w.load(a, w.v + 1);
      const long long piece_end = min(stop, w.end);
      const long long r0 = (at - w.begin + a.row_bytes - 1) / a.row_bytes;
      const long long r1 = (piece_end - w.begin + a.row_bytes - 1) / a.row_bytes;
      for (long long r = r0 + threadIdx.x; r < r1; r += kCopyThreads) {
        fold_row_atomic<T, kQuant>(reinterpret_cast<const uint32_t*>(w.src + r * a.row_bytes),
                                   w.receiver, f);
      }
      at = piece_end;
    }
  }
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
            if ((peers >> l) & 1u) acc = fold(ops.op[c], acc, other);
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
            p[c] = to_bits(fold(ops.op[c], from_bits<T>(p[c]), merged[c]));
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

// K4, global tier, with a float sum column: a group of receivers' windows folded in
// canonical order (own slot, windows in step order, rows in row order) from the
// grids K3 landed, in one cooperative launch (module note).
struct OrderedArgs {
  const long long* windows;  // the group's first window (receiver-major)
  int windows_per_receiver;
  int num_receivers;         // receivers of the group
  const uint8_t* grid;       // receiver j's grid at grid + j * exec_bytes
  long long exec_bytes;
  long long row_bytes;
  long long max_rows;        // rows of the own slot, the largest window
  int* done;                 // (all receivers, max_rows): window index + 1 once folded
  int* owner;                // (all receivers, G): lowest pending row per group, INT_MAX = none
  unsigned int* arrived;     // grid barrier counter
  unsigned int* pending;     // the last round in which a row had to wait
};

template <typename T, bool kQuant>
__global__ void __launch_bounds__(kThreads)
ring_ordered_fold_kernel(OrderedArgs a, Ops ops, FoldGeometry g, uint32_t* __restrict__ acc_vals,
                         int* __restrict__ acc_counts) {
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  unsigned int round = 0;
  for (int index = 0; index < a.windows_per_receiver; ++index) {
    const int stamp = index + 1;
    const long long rows = __ldg(a.windows + static_cast<long long>(index) * kWindowWords + 4);
    const long long total = rows * a.num_receivers;
    bool more = true;
    while (more) {
      ++round;
      for (int apply = 0; apply < 2; ++apply) {
        // (receiver of the group, row) pairs; a thread meets the same rows every round
        for (long long i = first; i < total; i += stride) {
          const long long k = i / rows, r = i - k * rows;
          const long long* win =
              a.windows + (k * a.windows_per_receiver + index) * kWindowWords;
          const long long j = __ldg(win + 0);
          int* done = a.done + j * a.max_rows + r;
          if (*done == stamp) continue;
          const uint32_t* row = reinterpret_cast<const uint32_t*>(
              a.grid + j * a.exec_bytes + (__ldg(win + 3) + r) * a.row_bytes);
          const uint32_t key = row[0];
          const int count = static_cast<int>(row[g.lanes - 1]);
          if (count <= 0 || key >= static_cast<uint32_t>(g.num_groups)) {
            *done = stamp;
            continue;
          }
          const long long slot = j * g.num_groups + key;
          int* bid = a.owner + slot;
          if (!apply) {
            atomicMin(bid, static_cast<int>(r));
            continue;
          }
          // owner and the accumulator change under other SMs within this launch: read
          // them through L2 (__ldcg), never from a stale L1 line
          if (__ldcg(bid) != static_cast<int>(r)) {
            atomicMax(a.pending, round);
            continue;
          }
          uint32_t* v = acc_vals + slot * g.width;
          for (int c = 0; c < g.width; ++c) {
            v[c] = to_bits(fold(ops.op[c], from_bits<T>(__ldcg(v + c)), load_value<T, kQuant>(row, c, g)));
          }
          acc_counts[slot] = add(__ldcg(acc_counts + slot), count);
          *done = stamp;
          *bid = INT_MAX;
        }
        grid_barrier(a.arrived);
      }
      more = *reinterpret_cast<volatile unsigned int*>(a.pending) >= round;
    }
  }
}

// K4, global tier: every value lane's fold identity.
__global__ void __launch_bounds__(kThreads)
ring_acc_kernel(int is_float, Ops ops, int width, long long slots, uint32_t* acc_vals) {
  const long long total = slots * width;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int op = ops.op[i % width];
    acc_vals[i] = is_float ? to_bits(identity<float>(op)) : to_bits(identity<int>(op));
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
    rowcopy::copy_packed_rows<Word>(
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

// One group's K3 launch arguments: the windows [first_window, first_window +
// num_windows) of the table, whose receivers are [first_receiver, first_receiver +
// num_receivers).  Returns 0, or the error of arguments that do not fit.
int copy_args(const long long* table, int table_windows, int first_window, int num_windows,
              int first_receiver, int num_receivers, long long src_base, long long dst_base,
              long long exec_bytes, long long row_bytes, RingCopyArgs* a) {
  if (table == nullptr || table_windows < 1 || first_window < 0 || num_windows < 1 ||
      first_window + num_windows > table_windows || first_receiver < 0 || num_receivers < 1 ||
      num_receivers > kMaxExecs || row_bytes <= 0 || row_bytes % 4 != 0 || src_base == 0 ||
      dst_base == 0 || exec_bytes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *a = RingCopyArgs{};
  a->windows = table + static_cast<long long>(first_window) * kWindowWords;
  a->row_start = table + static_cast<long long>(table_windows) * kWindowWords + first_window;
  a->num_windows = num_windows;
  a->first_receiver = first_receiver;
  a->row_bytes = row_bytes;
  a->src = reinterpret_cast<const uint8_t*>(src_base);
  a->exec_bytes = exec_bytes;
  for (int k = 0; k < num_receivers; ++k) {
    a->dst[k] = reinterpret_cast<uint8_t*>(dst_base + (first_receiver + k) * exec_bytes);
  }
  return 0;
}

template <bool kFold, typename T, bool kQuant>
int launch_copy(const RingCopyArgs& a, const GlobalFold& f, long long rows, cudaStream_t stream) {
  const long long chunks = (rows * a.row_bytes + kChunkBytes - 1) / kChunkBytes;
  if (chunks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  ring_exchange_kernel<kFold, T, kQuant><<<static_cast<unsigned>(chunks), kCopyThreads, 0, stream>>>(a, f);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of one cooperative ordered-fold launch: all that can be resident at once.
template <typename T, bool kQuant>
int ordered_grid_size(int* ctas) {
  static int cached = 0;
  if (cached == 0) {
    int device = 0, cooperative = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch, device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_ordered_fold_kernel<T, kQuant>,
                                                          kThreads, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!cooperative || per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    cached = per_sm * sms;
  }
  *ctas = cached;
  return 0;
}

template <typename T, bool kQuant>
int launch_ordered(OrderedArgs a, Ops ops, FoldGeometry g, uint32_t* acc_vals, int* acc_counts,
                   cudaStream_t stream) {
  int ctas = 0;
  const int rc = ordered_grid_size<T, kQuant>(&ctas);
  if (rc != 0) return rc;
  void* args[] = {&a, &ops, &g, &acc_vals, &acc_counts};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ring_ordered_fold_kernel<T, kQuant>), dim3(ctas), dim3(kThreads),
      args, 0, stream));
}

}  // namespace

extern "C" {

// K3 for one group of at most kMaxExecs receivers: the windows [first_window,
// first_window + num_windows) of `table` (device), which holds the (table_windows
// x 5) window table, then its (table_windows + 1) row prefix; those windows are
// receivers [first_receiver, first_receiver + num_receivers)'s and hold `rows`
// rows.  Executor i's staging starts at src_base + i * exec_bytes and receiver j's
// grid at dst_base + j * exec_bytes; the launch carries the group's grid pointers
// by value.
int ring_exchange_launch(const long long* table, int table_windows, int first_window,
                         int num_windows, long long rows, int first_receiver, int num_receivers,
                         long long src_base, long long dst_base, long long exec_bytes,
                         long long row_bytes, void* stream) {
  if (num_windows <= 0 || rows <= 0) return 0;
  RingCopyArgs a;
  const int rc = copy_args(table, table_windows, first_window, num_windows, first_receiver,
                           num_receivers, src_base, dst_base, exec_bytes, row_bytes, &a);
  if (rc != 0) return rc;
  return launch_copy<false, int, false>(a, GlobalFold{}, rows, static_cast<cudaStream_t>(stream));
}

// K4 global tier, no float sum column: K3's launch for one group (the same
// arguments), folding every landed row into acc_vals (receivers, G, width) and
// acc_counts (receivers, G) with atomics as it copies.  The accumulator holds the
// fold identities (ring_acc_launch) and the counts zeros before the first group.
int ring_combine_global_launch(const long long* table, int table_windows, int first_window,
                               int num_windows, long long rows, int first_receiver,
                               int num_receivers, long long src_base, long long dst_base,
                               long long exec_bytes, long long row_bytes, const int* ops, int width,
                               int num_groups, int is_float, int qblock, int wq4, void* acc_vals,
                               void* acc_counts, void* stream) {
  if (num_windows <= 0 || rows <= 0) return 0;
  RingCopyArgs a;
  const int rc = copy_args(table, table_windows, first_window, num_windows, first_receiver,
                           num_receivers, src_base, dst_base, exec_bytes, row_bytes, &a);
  if (rc != 0) return rc;
  GlobalFold f{make_ops(ops, width), FoldGeometry{num_groups, width, static_cast<int>(row_bytes / 4), qblock, wq4},
               static_cast<uint32_t*>(acc_vals), static_cast<int*>(acc_counts)};
  if (!check_geometry(f.g, is_float, row_bytes) || acc_vals == nullptr || acc_counts == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int c = 0; c < width; ++c) {  // a float sum depends on the order: ring_ordered_fold_launch
    if (is_float && f.ops.op[c] == kSum) return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_float) return launch_copy<true, int, false>(a, f, rows, s);
  if (qblock > 0) return launch_copy<true, float, true>(a, f, rows, s);
  return launch_copy<true, float, false>(a, f, rows, s);
}

// K4 global tier with a float sum column: one group's windows (receiver-major,
// from first_window, num_receivers * windows_per_receiver of them) folded in
// canonical order from the grids K3 landed (receiver j's at grid_base + j *
// exec_bytes), in one cooperative launch.  done (all receivers x max_rows int32)
// and sync (the barrier counter) start at zero for the call, owner (all receivers
// x G int32) at INT_MAX; pending is a zeroed word of this group's own.
int ring_ordered_fold_launch(const long long* table, int first_window, int windows_per_receiver,
                             int num_receivers, long long grid_base, long long exec_bytes,
                             long long row_bytes, long long max_rows, void* done, void* owner,
                             void* sync, void* pending, const int* ops, int width, int num_groups,
                             int qblock, int wq4, void* acc_vals, void* acc_counts, void* stream) {
  if (num_receivers <= 0 || windows_per_receiver <= 0 || max_rows <= 0) return 0;
  FoldGeometry g{num_groups, width, static_cast<int>(row_bytes / 4), qblock, wq4};
  if (table == nullptr || first_window < 0 || grid_base == 0 || exec_bytes < 0 ||
      !check_geometry(g, 1, row_bytes) || done == nullptr || owner == nullptr || sync == nullptr ||
      pending == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  OrderedArgs a{table + static_cast<long long>(first_window) * kWindowWords, windows_per_receiver,
                num_receivers, reinterpret_cast<const uint8_t*>(grid_base), exec_bytes, row_bytes,
                max_rows, static_cast<int*>(done), static_cast<int*>(owner),
                static_cast<unsigned int*>(sync), static_cast<unsigned int*>(pending)};
  const Ops o = make_ops(ops, width);
  uint32_t* av = static_cast<uint32_t*>(acc_vals);
  int* ac = static_cast<int*>(acc_counts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qblock > 0) return launch_ordered<float, true>(a, o, g, av, ac, s);
  return launch_ordered<float, false>(a, o, g, av, ac, s);
}

// K4 global tier: the fold identities into acc_vals (slots x width).
int ring_acc_launch(const int* ops, int width, int is_float, long long slots,
                    void* acc_vals, void* stream) {
  const long long total = slots * width;
  if (total <= 0) return 0;
  if (width > kMaxWidth || acc_vals == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  long long grid = (total + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * 16;
  if (grid > cap) grid = cap;
  ring_acc_kernel<<<static_cast<unsigned>(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      is_float, make_ops(ops, width), width, slots, static_cast<uint32_t*>(acc_vals));
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
