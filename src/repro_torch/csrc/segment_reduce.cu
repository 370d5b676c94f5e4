// Segment reduction for the compiled executor's grouped aggregates:
// (n,) values + (n,) int64 segment ids -> (S,) per-segment COUNT, SUM, MIN
// or MAX, computed in int64 or float64.
//
// Replaces the Pallas TPU kernel repro/kernels/segment_ops.py
// (segment_reduce_pallas).  That kernel built a (512, Sp) one-hot block of
// the rows' ids against every segment and folded it into a VMEM-resident
// (Sp,) accumulator, in int32/float32.  Sp is 3,155 on the wifi main path
// and can reach hundreds of thousands (a GROUP BY on a time column), so a
// block per segment count does not carry over; and a float sum folded in
// block order is not the order of the reference's serving member
// (kernels/ops.py _segment_numpy: a stable grouping of the rows by
// segment, then numpy's pairwise slice.sum()).  This design keeps that
// order, so every op equals the numpy member bit for bit.
//
// What bounds it on an H100: memory.  Each row's id and value are read
// once and the (S,) results written once: 16 n + 8 S bytes, 0.0069 ms at
// the main path's call (1,433,226 rows into 3,155 segments) at 3.35 TB/s.
//
// Steps (the wrapper, kernels/segment_ops.py, runs them in order):
//   1. segment_count_kernel, one thread per row: the row's slot (its id,
//      or -1 for a negative id or one >= S, which drops the row), and a
//      count per (chunk of rows, segment) -- or, for COUNT, an int64 count
//      per segment, which is all of COUNT.  Rows of a warp with one id
//      add their count with one atomic (__match_any_sync).  For at most
//      8,064 segments, segment_chunk_count_kernel instead: a block per
//      chunk, its counts in a shared-memory histogram.
//   2. segment_scan_kernel, 1 or 8 threads per segment: an exclusive scan of
//      the chunk counts down the chunks (each chunk's offset inside the
//      segment's range) and the segment's count.
//   3. (host glue) an exclusive scan of the counts: each segment's start.
//   4. segment_place_kernel, one block per (range of at most 8,064
//      segments, row chunk): the rows of the chunk whose slots lie in the
//      range land at their segment's start + the chunk's offset, in row
//      order -- a tile's few owned rows ranked by __match_any_sync, as the
//      hash join's place step, its many by a stable radix sort in shared
//      memory.  Each segment's range comes out ascending.
//   5. the reduce, by size class of the segment:
//        - at most 128 rows (one numpy leaf): one thread, which also files
//          every larger segment in a list by class (segment_small_kernel);
//        - 129 to 4,096 rows: one warp each (segment_medium_kernel);
//        - more: one block of 512 threads each (segment_large_kernel).
//      The warp and block kernels are persistent grids that walk the
//      lists built on the device, so the host never waits for a count.
//
// The float64 SUM follows numpy: the segment is cut into blocks of the
// size numpy's reduce hands its inner loop (the wrapper passes it,
// kernels/ref.py numpy_sum_block; 0: the whole segment); s = 0.0, then
// s += pairwise(block) block by block.  pairwise(n): n < 8 a sequential
// sum from 0.0; n <= 128 eight running sums r[j] += a[i + j] over the
// largest multiple of 8, ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)), then the
// rest in order; else pairwise(left) + pairwise(right), split at
// n/2 - (n/2 mod 8).  The tree is fixed by n alone, so a group of threads
// evaluates it in parallel (kernels/ref.py _pairwise_tree is the
// specification): the group's octets (8 lanes) each take one node at a
// fixed depth (2 for a warp, 6 for a block), found by descending from the
// root along the octet's index; an octet walks its node's leaves in
// order, the 8 lanes of a leaf each keeping one running sum, combined by
// shuffles in numpy's order; then the nodes are combined level by level,
// inner node = left + right.  Built with -fmad=false, there are only
// adds, in numpy's order.  The blocks of one segment are summed in turn
// and added to 0.0 in block order.
//
// int64 SUM wraps modulo 2^64 and is associative, so it is summed in any
// order.  MIN/MAX compare (not fmin/fmax, which drop NaN), return NaN for
// a segment that holds one, and keep, among equal values (-0.0 == 0.0),
// the one of the first row, as a scan in row order does.  Empty segments
// hold the identity.
//
// Against the first version (one owner block for up to 8,064 segments,
// which read every row's slot: 5.86 ms of the 6.18 ms sum at the main
// path's call; one thread per segment, 41 ms for one segment of 1M rows),
// the chunks spread the place step over ~264 blocks when segments are
// few, and the size classes put a warp or a block on a long segment.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kLeaf = 128;       // numpy's pairwise-sum leaf
constexpr int kDepth = 32;           // pairwise frames; 2^31 values need <= 26
constexpr int kPlacePer = 8;         // slots a thread reads per tile
constexpr int kPlaceTile = kThreads * kPlacePer;
static_assert(kPlacePer * kWarps == 2 * 32, "one scan of 2 counts a lane");
constexpr int kSharedSlots = 8064;   // a place block's cursors in shared memory
constexpr int64_t kMediumMax = 4096; // the longest segment a warp reduces
constexpr int kLargeThreads = 512;
constexpr int kLargeOctets = kLargeThreads / 8;
constexpr int kMediumBlocks = 132 * 8;
constexpr int kLargeBlocks = 132 * 2;

enum Op { kSum = 0, kMin = 1, kMax = 2 };

// -------------------------------------------------------------------------
// 1-2. counts
// -------------------------------------------------------------------------
// chunk_counts (chunks, S) int32, or null for COUNT's int64 counts; a chunk
// is chunk_rows rows, a multiple of the block, so a warp lies in one chunk
__global__ void __launch_bounds__(kThreads)
segment_count_kernel(const int64_t* __restrict__ seg, int64_t n,
                     int64_t num_segments, int64_t chunk_rows,
                     int32_t* __restrict__ row_slot,
                     unsigned long long* counts, int* chunk_counts) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t s = i < n ? seg[i] : -1;
  const bool ok = s >= 0 && s < num_segments;
  if (i < n && row_slot != nullptr) {
    row_slot[i] = ok ? static_cast<int32_t>(s) : -1;
  }
  const unsigned valid = __ballot_sync(kFull, ok);
  if (ok) {
    const unsigned grp =
        __match_any_sync(valid, static_cast<unsigned long long>(s));
    if ((threadIdx.x & 31) == __ffs(grp) - 1) {
      if (chunk_counts != nullptr) {
        atomicAdd(chunk_counts + (i / chunk_rows) * num_segments + s,
                  __popc(grp));
      } else {
        atomicAdd(counts + s, static_cast<unsigned long long>(__popc(grp)));
      }
    }
  }
}

// The same for few segments (S <= kSharedSlots): one block per chunk
// counts its rows in a shared-memory histogram and writes its row of
// chunk_counts whole (no atomics to memory, no zeroing).
constexpr int kCountBatch = 8;

__global__ void __launch_bounds__(kThreads)
segment_chunk_count_kernel(const int64_t* __restrict__ seg, int64_t n,
                           int64_t num_segments, int64_t chunk_rows,
                           int32_t* __restrict__ row_slot,
                           int* __restrict__ chunk_counts) {
  __shared__ int hist[kSharedSlots];
  for (int64_t i = threadIdx.x; i < num_segments; i += kThreads) hist[i] = 0;
  __syncthreads();
  const int64_t row_lo = static_cast<int64_t>(blockIdx.x) * chunk_rows;
  const int64_t row_hi = row_lo + chunk_rows < n ? row_lo + chunk_rows : n;
  for (int64_t base = row_lo; base < row_hi; base += kThreads * kCountBatch) {
    int64_t sv[kCountBatch];
#pragma unroll
    for (int u = 0; u < kCountBatch; ++u) {
      const int64_t r = base + u * kThreads + threadIdx.x;
      sv[u] = r < row_hi ? seg[r] : -1;
    }
#pragma unroll
    for (int u = 0; u < kCountBatch; ++u) {
      const int64_t r = base + u * kThreads + threadIdx.x;
      const bool ok = sv[u] >= 0 && sv[u] < num_segments;
      if (r < row_hi) row_slot[r] = ok ? static_cast<int32_t>(sv[u]) : -1;
      if (ok) atomicAdd(hist + sv[u], 1);
    }
  }
  __syncthreads();
  int* out = chunk_counts + static_cast<int64_t>(blockIdx.x) * num_segments;
  for (int64_t i = threadIdx.x; i < num_segments; i += kThreads) {
    out[i] = hist[i];
  }
}

// chunk_counts becomes each chunk's offset inside its segment's range.
// Each segment's column is cut into kParts parts of at most kScanPart
// chunks, one thread a part (neighbouring threads take neighbouring
// segments, so a warp reads 32 neighbouring entries of a row at a time);
// a thread scans its part and adds the totals of the parts above.  One
// part when the chunks are few, eight when there are up to 264.
constexpr int kScanPart = 33;  // 8 x 33 >= 264 chunks

template <int kParts>
__global__ void __launch_bounds__(kThreads)
segment_scan_kernel(int* chunk_counts, int64_t chunks, int64_t num_segments,
                    int64_t* __restrict__ counts) {
  constexpr int kSegs = kThreads / kParts;  // segments a block takes
  __shared__ int part_total[kParts][kSegs];
  const int j = threadIdx.x % kSegs;
  const int part = threadIdx.x / kSegs;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kSegs + j;
  const int64_t per = (chunks + kParts - 1) / kParts;
  const int64_t c0 = part * per;
  int* col = chunk_counts + s;
  int v[kScanPart];
  int run = 0;  // a segment holds fewer than 2^31 rows
#pragma unroll
  for (int u = 0; u < kScanPart; ++u) {
    const int64_t c = c0 + u;
    v[u] = s < num_segments && u < per && c < chunks ? col[c * num_segments]
                                                       : 0;
  }
#pragma unroll
  for (int u = 0; u < kScanPart; ++u) {
    const int x = v[u];
    v[u] = run;
    run += x;
  }
  int above = 0;
  if (kParts > 1) {
    part_total[part][j] = run;
    __syncthreads();
    for (int p = 0; p < part; ++p) above += part_total[p][j];
  }
  if (s >= num_segments) return;
#pragma unroll
  for (int u = 0; u < kScanPart; ++u) {
    const int64_t c = c0 + u;
    if (u < per && c < chunks) col[c * num_segments] = above + v[u];
  }
  if (part == kParts - 1) counts[s] = above + run;
}

// -------------------------------------------------------------------------
// 4. place
// -------------------------------------------------------------------------
__device__ __forceinline__ void load_slots(const int32_t* __restrict__ row_slot,
                                           int64_t row_hi, int64_t base,
                                           int32_t (&s)[kPlacePer]) {
#pragma unroll
  for (int u = 0; u < kPlacePer; ++u) {
    const int64_t r = base + u * kThreads + threadIdx.x;
    s[u] = r < row_hi ? row_slot[r] : -1;
  }
}

// Exclusive scan, by warp 0, of the 64 per-(u, warp) counts in `count`
// (u major: the order of the rows of a tile); `total` gets their sum.
// Called between two __syncthreads.
__device__ __forceinline__ void scan_step_counts(int* count, int* total) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int c0 = count[2 * lane];
    const int c1 = count[2 * lane + 1];
    int incl = c0 + c1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    count[2 * lane] = incl - c0 - c1;
    count[2 * lane + 1] = incl - c1;
    if (lane == 31) *total = incl;
  }
}

// Block (x, y) owns the slots [x * span, (x + 1) * span) (span <= 8,064,
// so their cursors live in shared memory) and the rows of chunk y, and
// places those rows, in row order, at starts[slot] + offset[y][slot].
// Per tile of kPlaceTile rows: every thread reads kPlacePer slots
// (coalesced; the next tile's are read while this one is placed) and the
// block compacts the rows it owns into a shared list in row order
// (ballots and a scan of the per-(u, warp) counts).  A short list is
// placed by warp 0, 32 rows at a time, ranking equal slots with
// __match_any_sync.  A long one -- every row, when the segments are few --
// is sorted by slot with a stable radix sort in shared memory (one
// ballot-and-scan split per bit), after which each run of one slot is
// contiguous: its head moves the slot's cursor back by its position, every
// row lands at cursor + position, its tail moves the cursor past the run.
__global__ void __launch_bounds__(kThreads)
segment_place_kernel(const int32_t* __restrict__ row_slot, int64_t n,
                     int64_t chunk_rows, const int64_t* __restrict__ starts,
                     const int* __restrict__ offsets,
                     int32_t* __restrict__ grouped, int64_t num_segments,
                     int64_t span) {
  __shared__ int32_t list_row[kPlaceTile];
  __shared__ int32_t list_slot[kPlaceTile];  // slot - lo
  __shared__ int32_t local_cursor[kSharedSlots];
  __shared__ int step_count[kPlacePer * kWarps];  // per (u, warp)
  __shared__ int list_len;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower_lanes = (1u << lane) - 1u;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * span;
  const int64_t hi = lo + span < num_segments ? lo + span : num_segments;
  const int64_t row_lo = static_cast<int64_t>(blockIdx.y) * chunk_rows;
  const int64_t row_hi = row_lo + chunk_rows < n ? row_lo + chunk_rows : n;
  const int* offset = offsets + static_cast<int64_t>(blockIdx.y) * num_segments;
  // positions in `grouped` are below n < 2^31
  for (int64_t i = threadIdx.x; lo + i < hi; i += kThreads) {
    local_cursor[i] = static_cast<int32_t>(starts[lo + i] + offset[lo + i]);
  }
  const int sentinel = static_cast<int>(hi - lo);  // sorts after every slot
  const int key_bits = 32 - __clz(sentinel);
  int32_t next[kPlacePer];
  load_slots(row_slot, row_hi, row_lo, next);
  for (int64_t base = row_lo; base < row_hi; base += kPlaceTile) {
    // row base + u * kThreads + threadIdx.x: (u, warp, lane) is row order
    int32_t s[kPlacePer];
#pragma unroll
    for (int u = 0; u < kPlacePer; ++u) s[u] = next[u];
    load_slots(row_slot, row_hi, base + kPlaceTile, next);
    unsigned owned[kPlacePer];
#pragma unroll
    for (int u = 0; u < kPlacePer; ++u) {
      owned[u] = __ballot_sync(kFull, s[u] >= lo && s[u] < hi);
      if (lane == 0) step_count[u * kWarps + warp] = __popc(owned[u]);
    }
    __syncthreads();
    scan_step_counts(step_count, &list_len);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPlacePer; ++u) {
      if ((owned[u] >> lane) & 1u) {
        const int pos = step_count[u * kWarps + warp]
                        + __popc(owned[u] & lower_lanes);
        list_row[pos] = static_cast<int32_t>(base + u * kThreads
                                             + threadIdx.x);
        list_slot[pos] = static_cast<int32_t>(s[u] - lo);
      }
    }
    __syncthreads();
    const int len = list_len;
    if (len <= 64) {
      if (warp == 0) {
        for (int j = 0; j < len; j += 32) {
          const bool valid = j + lane < len;
          const unsigned m = __ballot_sync(kFull, valid);
          if (valid) {
            const int32_t rel = list_slot[j + lane];
            const unsigned grp = __match_any_sync(m, rel);
            const int rank = __popc(grp & lower_lanes);
            grouped[local_cursor[rel] + rank] = list_row[j + lane];
            __syncwarp(m);  // the group reads its cursor before it moves
            if (rank == 0) local_cursor[rel] += __popc(grp);
          }
          __syncwarp();  // the move is seen by the next step's readers
        }
      }
    } else {
      // the list's entry p = u * kThreads + threadIdx.x, padded with the
      // sentinel; LSD radix sort by slot, one stable split per bit
      int32_t key[kPlacePer], row[kPlacePer];
#pragma unroll
      for (int u = 0; u < kPlacePer; ++u) {
        const int p = u * kThreads + threadIdx.x;
        key[u] = p < len ? list_slot[p] : sentinel;
        row[u] = list_row[p];
      }
      for (int bit = 0; bit < key_bits; ++bit) {
        unsigned zeros[kPlacePer];
#pragma unroll
        for (int u = 0; u < kPlacePer; ++u) {
          zeros[u] = __ballot_sync(kFull, !((key[u] >> bit) & 1));
          if (lane == 0) step_count[u * kWarps + warp] = __popc(zeros[u]);
        }
        __syncthreads();  // and every entry is in registers
        scan_step_counts(step_count, &list_len);
        __syncthreads();
        const int total_zeros = list_len;
#pragma unroll
        for (int u = 0; u < kPlacePer; ++u) {
          const int p = u * kThreads + threadIdx.x;
          const int zb = step_count[u * kWarps + warp]
                         + __popc(zeros[u] & lower_lanes);
          const int pos = ((key[u] >> bit) & 1) ? total_zeros + (p - zb) : zb;
          list_slot[pos] = key[u];
          list_row[pos] = row[u];
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < kPlacePer; ++u) {
          const int p = u * kThreads + threadIdx.x;
          key[u] = list_slot[p];
          row[u] = list_row[p];
        }
      }
      // runs of one slot: head, every row, tail
#pragma unroll
      for (int u = 0; u < kPlacePer; ++u) {
        const int p = u * kThreads + threadIdx.x;
        if (key[u] != sentinel && (p == 0 || list_slot[p - 1] != key[u]))
          local_cursor[key[u]] -= p;
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kPlacePer; ++u) {
        const int p = u * kThreads + threadIdx.x;
        if (key[u] != sentinel) grouped[local_cursor[key[u]] + p] = row[u];
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kPlacePer; ++u) {
        const int p = u * kThreads + threadIdx.x;
        if (key[u] != sentinel &&
            (p == kPlaceTile - 1 || list_slot[p + 1] != key[u]))
          local_cursor[key[u]] += p + 1;
      }
    }
    __syncthreads();  // the list, the counts and the cursors are reused
  }
}

// -------------------------------------------------------------------------
// 5. reduce
// -------------------------------------------------------------------------
__device__ __forceinline__ int64_t pairwise_split(int64_t n) {
  const int64_t half = n / 2;
  return half - half % 8;
}

// numpy's pairwise_sum on a leaf of n <= 128 values, by one thread
__device__ double leaf_sum(const double* __restrict__ vals,
                           const int32_t* __restrict__ idx, int64_t n) {
  if (n < 8) {
    double res = 0.0;
    for (int64_t i = 0; i < n; ++i) res += vals[idx[i]];
    return res;
  }
  double r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = vals[idx[j]];
  int64_t i = 8;
  for (; i < n - (n % 8); i += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] += vals[idx[i + j]];
  }
  double res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
  for (; i < n; ++i) res += vals[idx[i]];
  return res;
}

// the same by the 8 lanes of an octet (all with the same n): lane j keeps
// the running sum r[j], loading its <= 16 values at once; the shuffles
// give every lane ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)) (IEEE addition is
// commutative), then the rest is added in order
__device__ double octet_leaf_sum(const double* __restrict__ vals,
                                 const int32_t* __restrict__ idx, int64_t n) {
  if (n < 8) {
    double res = 0.0;
    for (int64_t i = 0; i < n; ++i) res += vals[idx[i]];
    return res;
  }
  const int j = threadIdx.x & 7;
  const unsigned mask = 0xffu << (threadIdx.x & 24);
  const int m8 = static_cast<int>(n - n % 8);
  double a[kLeaf / 8];
#pragma unroll
  for (int u = 0; u < kLeaf / 8; ++u) {
    const int i = 8 * u + j;
    a[u] = i < m8 ? vals[idx[i]] : 0.0;
  }
  double r = a[0];
#pragma unroll
  for (int u = 1; u < kLeaf / 8; ++u) {
    if (8 * u < m8) r += a[u];
  }
  r = r + __shfl_xor_sync(mask, r, 1);
  r = r + __shfl_xor_sync(mask, r, 2);
  r = r + __shfl_xor_sync(mask, r, 4);
  for (int64_t i = m8; i < n; ++i) r += vals[idx[i]];
  return r;
}

// numpy's pairwise_sum on n values: the recursion
// pairwise(lo, n) = pairwise(lo, n2) + pairwise(lo + n2, n - n2), run on
// an explicit stack of frames in the same order of additions; Octet: the
// 8 lanes of an octet run it together (the control flow depends on n only)
template <bool Octet>
__device__ double tree_sum(const double* __restrict__ vals,
                           const int32_t* __restrict__ idx, int64_t n) {
  auto leaf = [&](int64_t lo, int64_t m) {
    return Octet ? octet_leaf_sum(vals, idx + lo, m)
                 : leaf_sum(vals, idx + lo, m);
  };
  if (n <= kLeaf) return leaf(0, n);
  int64_t f_lo[kDepth], f_n[kDepth];
  double f_left[kDepth];
  bool f_right[kDepth];  // the frame's left half is done
  int top = 0;
  f_lo[0] = 0;
  f_n[0] = n;
  f_right[0] = false;
  double val = 0.0;
  bool have = false;  // val holds the value of frame `top`
  while (true) {
    if (!have) {
      if (f_n[top] <= kLeaf) {
        val = leaf(f_lo[top], f_n[top]);
        have = true;
      } else {  // descend into the left half
        const int64_t n2 = pairwise_split(f_n[top]);
        f_lo[top + 1] = f_lo[top];
        f_n[top + 1] = n2;
        f_right[top + 1] = false;
        ++top;
        continue;
      }
    }
    if (top == 0) return val;
    --top;  // hand val to the parent
    if (!f_right[top]) {  // left half done: descend into the right half
      const int64_t n2 = pairwise_split(f_n[top]);
      f_left[top] = val;
      f_right[top] = true;
      f_lo[top + 1] = f_lo[top] + n2;
      f_n[top + 1] = f_n[top] - n2;
      f_right[top + 1] = false;
      ++top;
      have = false;
    } else {
      val = f_left[top] + val;
    }
  }
}

__host__ __device__ constexpr int log2_of(int x) {
  return x <= 1 ? 0 : 1 + log2_of(x / 2);
}

template <typename T>
__host__ __device__ constexpr bool is_float() { return T(0.5) != T(0); }

template <bool Block>
__device__ __forceinline__ void group_sync() {
  if (Block) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

// pairwise(n) by a group of 8 * kOctets threads (g: the thread's index in
// the group), every thread returning it.  Octet o takes the node at depth
// K = log2(kOctets) along the path of o's bits, most significant first;
// where the path meets a leaf above depth K, the octet whose remaining
// bits are 0 takes it.  inner: bit d set if the path's node at depth d is
// inner, so its value is left + right.  scratch holds kOctets doubles.
template <int kOctets, bool Block>
__device__ double group_tree_sum(const double* __restrict__ vals,
                                 const int32_t* __restrict__ idx, int64_t n,
                                 int g, double* scratch) {
  constexpr int K = log2_of(kOctets);
  static_assert((1 << K) == kOctets, "a power of two of octets");
  const int o = g >> 3;
  int64_t lo = 0, m = n;
  unsigned inner = 0;
  bool owner = true;
  for (int d = 0; d < K; ++d) {
    if (m <= kLeaf) {
      owner = (o & ((1 << (K - d)) - 1)) == 0;
      break;
    }
    inner |= 1u << d;
    const int64_t n2 = pairwise_split(m);
    if ((o >> (K - 1 - d)) & 1) {
      lo += n2;
      m -= n2;
    } else {
      m = n2;
    }
  }
  const double v = owner ? tree_sum<true>(vals, idx + lo, m) : 0.0;
  if ((g & 7) == 0) scratch[o] = v;
  group_sync<Block>();
#pragma unroll
  for (int j = 0; j < K; ++j) {  // combine depth K - 1 - j
    const int stride = 1 << j;
    if ((g & 7) == 0 && (o & (2 * stride - 1)) == 0 &&
        ((inner >> (K - 1 - j)) & 1u)) {
      scratch[o] = scratch[o] + scratch[o + stride];
    }
    group_sync<Block>();
  }
  const double total = scratch[0];
  group_sync<Block>();  // scratch is free for the next call
  return total;
}

// numpy's sum of a segment: s = 0.0, s += pairwise(block) block by block
template <int kOctets, bool Block>
__device__ double group_segment_sum(const double* __restrict__ vals,
                                    const int32_t* __restrict__ idx,
                                    int64_t count, int64_t block, int g,
                                    double* scratch) {
  if (block <= 0) block = count;  // numpy's reduce takes the whole slice
  double s = 0.0;
  for (int64_t c = 0; c < count; c += block) {
    const int64_t n = count - c < block ? count - c : block;
    s += group_tree_sum<kOctets, Block>(vals, idx + c, n, g, scratch);
  }
  return s;
}

__device__ __forceinline__ bool is_nan(double v) { return v != v; }
__device__ __forceinline__ bool is_nan(int64_t) { return false; }

template <typename T>
__device__ __forceinline__ T nan_of();
template <>
__device__ __forceinline__ double nan_of<double>() {
  return __longlong_as_double(0x7ff8000000000000ll);  // numpy's NaN
}
template <>
__device__ __forceinline__ int64_t nan_of<int64_t>() { return 0; }

// a MIN/MAX partial: the best value, the first row holding it, NaN seen
template <typename T>
struct Best {
  T v;
  int64_t at;
  bool nan;
};

template <typename T, int kOp>
__device__ __forceinline__ Best<T> better(Best<T> a, Best<T> b) {
  const bool take = (kOp == kMin ? b.v < a.v : b.v > a.v) ||
                    (b.v == a.v && b.at < a.at);
  Best<T> r = take ? b : a;
  r.nan = a.nan || b.nan;
  return r;
}

template <typename T>
__device__ __forceinline__ Best<T> shfl_best(Best<T> x, int lane_mask) {
  Best<T> y;
  y.v = __shfl_xor_sync(kFull, x.v, lane_mask);
  y.at = __shfl_xor_sync(kFull, x.at, lane_mask);
  y.nan = __shfl_xor_sync(kFull, static_cast<int>(x.nan), lane_mask) != 0;
  return y;
}

// an associative op (int64 SUM, MIN, MAX) over the segment by a group of
// kThreadsG threads (a warp, or a block with `scratch` of one entry per
// warp); every thread returns the result
template <typename T, int kOp, int kThreadsG, bool Block>
__device__ T group_assoc(const T* __restrict__ vals,
                         const int32_t* __restrict__ idx, int64_t count,
                         T ident, int g, Best<T>* scratch) {
  const int lane = threadIdx.x & 31;
  if constexpr (kOp == kSum) {  // int64: wraps modulo 2^64, any order
    unsigned long long s = 0;
    for (int64_t i = g; i < count; i += kThreadsG) {
      s += static_cast<unsigned long long>(vals[idx[i]]);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(kFull, s, d);
    if (Block) {
      Best<T>* part = scratch;
      if (lane == 0) part[g >> 5].v = static_cast<T>(s);
      __syncthreads();
      s = 0;
      for (int w = 0; w < kThreadsG / 32; ++w) {
        s += static_cast<unsigned long long>(part[w].v);
      }
      __syncthreads();
    }
    return static_cast<T>(s);
  } else {
    Best<T> b{ident, INT64_MAX, false};
    for (int64_t i = g; i < count; i += kThreadsG) {
      const T v = vals[idx[i]];
      if (is_nan(v)) {
        b.nan = true;
      } else if (kOp == kMin ? v < b.v : v > b.v) {
        b.v = v;  // the first (lowest) row of this thread's stride
        b.at = i;
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      b = better<T, kOp>(b, shfl_best(b, d));
    }
    if (Block) {
      if (lane == 0) scratch[g >> 5] = b;
      __syncthreads();
      b = scratch[0];
      for (int w = 1; w < kThreadsG / 32; ++w) {
        b = better<T, kOp>(b, scratch[w]);
      }
      __syncthreads();
    }
    return b.nan ? nan_of<T>() : b.v;
  }
}

template <typename T, int kOp>
__device__ T seq_reduce(const T* __restrict__ vals,
                        const int32_t* __restrict__ idx, int64_t count,
                        int64_t block, T ident) {
  if constexpr (kOp == kSum) {
    if constexpr (is_float<T>()) {
      if (block <= 0) block = count;
      double s = 0.0;
      for (int64_t c = 0; c < count; c += block) {
        const int64_t n = count - c < block ? count - c : block;
        s += tree_sum<false>(vals, idx + c, n);
      }
      return s;
    } else {
      unsigned long long s = 0;
      for (int64_t i = 0; i < count; ++i) {
        s += static_cast<unsigned long long>(vals[idx[i]]);
      }
      return static_cast<T>(s);
    }
  } else {
    T r = ident;
    bool nan = false;
    for (int64_t i = 0; i < count; ++i) {
      const T v = vals[idx[i]];
      if (is_nan(v)) {
        nan = true;
      } else if (kOp == kMin ? v < r : v > r) {
        r = v;
      }
    }
    return nan ? nan_of<T>() : r;
  }
}

// one thread per segment of at most kLeaf rows; longer ones are filed in
// lists[0] (warps) or lists[1] (blocks), lists[c] holding up to S entries
template <typename T, int kOp>
__global__ void __launch_bounds__(kThreads)
segment_small_kernel(const T* __restrict__ vals,
                     const int32_t* __restrict__ grouped,
                     const int64_t* __restrict__ starts,
                     const int64_t* __restrict__ counts, int64_t num_segments,
                     int64_t block, T ident, T* __restrict__ out,
                     int32_t* __restrict__ lists, int* list_len) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= num_segments) return;
  const int64_t count = counts[s];
  if (count > kLeaf) {
    const int cls = count > kMediumMax ? 1 : 0;
    const int at = atomicAdd(list_len + cls, 1);
    lists[cls * num_segments + at] = static_cast<int32_t>(s);
    return;
  }
  out[s] = count == 0 ? ident
                      : seq_reduce<T, kOp>(vals, grouped + starts[s], count,
                                           block, ident);
}

// one warp per segment of lists[0]
template <typename T, int kOp>
__global__ void __launch_bounds__(kThreads)
segment_medium_kernel(const T* __restrict__ vals,
                      const int32_t* __restrict__ grouped,
                      const int64_t* __restrict__ starts,
                      const int64_t* __restrict__ counts, int64_t block,
                      T ident, T* __restrict__ out,
                      const int32_t* __restrict__ list,
                      const int* __restrict__ list_len) {
  __shared__ double scratch[kWarps][4];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int len = *list_len;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kWarps + warp; j < len;
       j += static_cast<int64_t>(gridDim.x) * kWarps) {
    const int32_t s = list[j];
    const int32_t* idx = grouped + starts[s];
    const int64_t count = counts[s];
    T r;
    if constexpr (kOp == kSum && is_float<T>()) {
      r = group_segment_sum<4, false>(vals, idx, count, block, lane,
                                      scratch[warp]);
    } else {
      r = group_assoc<T, kOp, 32, false>(vals, idx, count, ident, lane,
                                         nullptr);
    }
    if (lane == 0) out[s] = r;
  }
}

// one block per segment of lists[1]
template <typename T, int kOp>
__global__ void __launch_bounds__(kLargeThreads)
segment_large_kernel(const T* __restrict__ vals,
                     const int32_t* __restrict__ grouped,
                     const int64_t* __restrict__ starts,
                     const int64_t* __restrict__ counts, int64_t block,
                     T ident, T* __restrict__ out,
                     const int32_t* __restrict__ list,
                     const int* __restrict__ list_len) {
  __shared__ double scratch[kLargeOctets];
  __shared__ Best<T> parts[kLargeThreads / 32];
  const int len = *list_len;
  for (int64_t j = blockIdx.x; j < len; j += gridDim.x) {
    const int32_t s = list[j];
    const int32_t* idx = grouped + starts[s];
    const int64_t count = counts[s];
    T r;
    if constexpr (kOp == kSum && is_float<T>()) {
      r = group_segment_sum<kLargeOctets, true>(vals, idx, count, block,
                                                threadIdx.x, scratch);
    } else {
      r = group_assoc<T, kOp, kLargeThreads, true>(vals, idx, count, ident,
                                                   threadIdx.x, parts);
    }
    if (threadIdx.x == 0) out[s] = r;
  }
}

inline unsigned blocks_for(int64_t n, int threads = kThreads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

template <typename T, int kOp>
int launch_op(const T* v, const int32_t* g, const int64_t* st,
              const int64_t* c, int64_t num_segments, int64_t block, T ident,
              T* o, int32_t* lists, int* list_len, cudaStream_t stream) {
  segment_small_kernel<T, kOp><<<blocks_for(num_segments), kThreads, 0,
                                 stream>>>(v, g, st, c, num_segments, block,
                                           ident, o, lists, list_len);
  int64_t medium = (num_segments + kWarps - 1) / kWarps;
  if (medium > kMediumBlocks) medium = kMediumBlocks;
  segment_medium_kernel<T, kOp><<<static_cast<unsigned>(medium), kThreads, 0,
                                  stream>>>(v, g, st, c, block, ident, o,
                                            lists, list_len);
  const int64_t large =
      num_segments < kLargeBlocks ? num_segments : kLargeBlocks;
  segment_large_kernel<T, kOp><<<static_cast<unsigned>(large), kLargeThreads,
                                 0, stream>>>(v, g, st, c, block, ident, o,
                                              lists + num_segments,
                                              list_len + 1);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_reduce(const void* vals, int op, const void* grouped,
                  const void* starts, const void* counts, int64_t num_segments,
                  int64_t block, T ident, void* lists, void* list_len,
                  void* out, cudaStream_t stream) {
  const T* v = static_cast<const T*>(vals);
  const int32_t* g = static_cast<const int32_t*>(grouped);
  const int64_t* st = static_cast<const int64_t*>(starts);
  const int64_t* c = static_cast<const int64_t*>(counts);
  T* o = static_cast<T*>(out);
  int32_t* l = static_cast<int32_t*>(lists);
  int* ll = static_cast<int*>(list_len);
  switch (op) {
    case kSum:
      return launch_op<T, kSum>(v, g, st, c, num_segments, block, ident, o, l,
                                ll, stream);
    case kMin:
      return launch_op<T, kMin>(v, g, st, c, num_segments, block, ident, o, l,
                                ll, stream);
    case kMax:
      return launch_op<T, kMax>(v, g, st, c, num_segments, block, ident, o, l,
                                ll, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Every entry point launches on `stream` and returns cudaGetLastError() as
// an int (0 = success).

// counts (int64, zeroed) for COUNT, or chunk_counts ((chunks, S) int32;
// counts is then null) with chunk_rows a multiple of 256; row_slot may be
// null (a COUNT needs no grouping).
extern "C" int quipt_segment_count(const void* seg, int64_t n,
                                   int64_t num_segments, int64_t chunk_rows,
                                   void* row_slot, void* counts,
                                   void* chunk_counts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunk_counts == nullptr) {
    if (n == 0) return 0;
    segment_count_kernel<<<blocks_for(n), kThreads, 0, st>>>(
        static_cast<const int64_t*>(seg), n, num_segments, chunk_rows,
        static_cast<int32_t*>(row_slot),
        static_cast<unsigned long long*>(counts), nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  if (chunk_rows <= 0 || chunk_rows % kThreads || row_slot == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks = n == 0 ? 1 : (n + chunk_rows - 1) / chunk_rows;
  if (num_segments <= kSharedSlots) {
    segment_chunk_count_kernel<<<static_cast<unsigned>(chunks), kThreads, 0,
                                 st>>>(
        static_cast<const int64_t*>(seg), n, num_segments, chunk_rows,
        static_cast<int32_t*>(row_slot), static_cast<int*>(chunk_counts));
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t err = cudaMemsetAsync(
      chunk_counts, 0, sizeof(int) * chunks * num_segments, st);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  segment_count_kernel<<<blocks_for(n), kThreads, 0, st>>>(
      static_cast<const int64_t*>(seg), n, num_segments, chunk_rows,
      static_cast<int32_t*>(row_slot), nullptr,
      static_cast<int*>(chunk_counts));
  return static_cast<int>(cudaGetLastError());
}

// chunk_counts becomes the chunks' offsets; counts (int64) is written
extern "C" int quipt_segment_scan(void* chunk_counts, int64_t chunks,
                                  int64_t num_segments, void* counts,
                                  void* stream) {
  if (num_segments == 0) return 0;
  if (chunks < 1 || chunks > kWarps * kScanPart)
    return static_cast<int>(cudaErrorInvalidValue);
  int* cc = static_cast<int*>(chunk_counts);
  int64_t* c = static_cast<int64_t*>(counts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunks <= kScanPart) {
    segment_scan_kernel<1><<<blocks_for(num_segments), kThreads, 0, st>>>(
        cc, chunks, num_segments, c);
  } else {
    segment_scan_kernel<kWarps><<<blocks_for(num_segments, kThreads / kWarps),
                                  kThreads, 0, st>>>(cc, chunks,
                                                     num_segments, c);
  }
  return static_cast<int>(cudaGetLastError());
}

// ranges x chunks blocks, a range of at most 8,064 segments; offsets from
// quipt_segment_scan
extern "C" int quipt_segment_place(const void* row_slot, int64_t n,
                                   int64_t chunk_rows, int64_t chunks,
                                   const void* starts, const void* offsets,
                                   void* grouped, int64_t num_segments,
                                   int64_t ranges, void* stream) {
  if (n == 0 || num_segments == 0) return 0;
  const int64_t span = ranges < 1 ? 0 : (num_segments + ranges - 1) / ranges;
  if (span < 1 || span > kSharedSlots || chunks < 1 || chunks > 65535 ||
      chunk_rows < 1 || ranges > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(ranges), static_cast<unsigned>(chunks));
  segment_place_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_slot), n, chunk_rows,
      static_cast<const int64_t*>(starts), static_cast<const int*>(offsets),
      static_cast<int32_t*>(grouped), num_segments, span);
  return static_cast<int>(cudaGetLastError());
}

// op: 0 sum, 1 min, 2 max; is_float: 1 for float64 values, 0 for int64.
// block: the values numpy's reduce adds per inner-loop call (0: all).
// ident_bits is the identity's 64 bits (an int64, or a float64's bits).
// lists: 2 S int32 scratch; list_len: 2 int32, zeroed.
extern "C" int quipt_segment_reduce(const void* vals, int is_float, int op,
                                    const void* grouped, const void* starts,
                                    const void* counts, int64_t num_segments,
                                    int64_t block, int64_t ident_bits,
                                    void* lists, void* list_len, void* out,
                                    void* stream) {
  if (num_segments == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_float) {
    double ident;
    std::memcpy(&ident, &ident_bits, sizeof ident);
    return launch_reduce<double>(vals, op, grouped, starts, counts,
                                 num_segments, block, ident, lists, list_len,
                                 out, st);
  }
  return launch_reduce<int64_t>(vals, op, grouped, starts, counts,
                                num_segments, block, ident_bits, lists,
                                list_len, out, st);
}
