// Hash join of two int64 key vectors for the QUIP join spine: every
// (probe_idx, build_idx) pair with equal keys, probe-major, build rows
// ascending within a probe (the order of core/triggers.py multi_match).
//
// Replaces the Pallas TPU kernels repro/kernels/hash_join.py
// (hash_join_build_pallas, hash_join_probe_pallas).  Those folded the keys
// to uint32 (the TPU has no 64-bit lanes), inserted every build row into
// its own slot of a linear-probing table in one sequential loop, and had
// the probe walk the whole chain into a (n, max_dup) match block.  On the
// join spine keys repeat heavily (a run of 831 copies of one key at full
// wifi scale, and every missing key shares one sentinel), so one slot per
// copy makes the build and every probe quadratic in a key's copies.
//
// Design here:
//   build  1. join_insert_kernel, one thread per build row: the table holds
//             DISTINCT full int64 keys (no folding, so no fold collisions
//             to verify on the host).  A slot stores 1 + the row of the key
//             it was claimed for (atomicCAS from 0) and a count of the
//             key's rows; each row records its slot and its slot's owner,
//             the range of kOwnerSlots (8,064) slots it falls in.
//          2. the rows partitioned by owner, stably: the segment kernels of
//             csrc/segment_reduce.cu with the owners as segments
//             (kernels/segment_ops.py group_rows: a count per (chunk of
//             rows, owner) in a shared-memory histogram, a scan down the
//             chunks, a place per (chunk, owner range)), so each owner's
//             rows lie together in ascending row order.
//          3. (host glue) an exclusive scan of the slot counts gives each
//             key its range of the grouped row array.
//          4. join_place_kernel, one block per owner: its slots' cursors in
//             shared memory, it walks only its own rows, in row order, a
//             tile of 2,048 at a time, sorts the tile by slot with a stable
//             radix sort and moves each slot's cursor once per run.  A key
//             has one owner that sees its rows in ascending order, so every
//             range comes out ascending -- the order an atomicAdd cursor
//             would lose -- and a key with many copies costs no more than
//             many keys with one.
//   probe  5. join_probe_scan_kernel, one thread per probe key: find the
//             key's slot (expected O(1) steps at load factor <= 1/2) and
//             its match count (the difference of neighbouring slot
//             starts); a block-wide scan of the counts in shared
//             memory, then a single-pass decoupled look-back across blocks
//             (each block's status word holds a flag and its aggregate or
//             inclusive prefix, in one 64-bit word) gives each probe its
//             end in the output and the last block the grand total.  Each
//             probe also gets where its key's rows start in `grouped`.
//          6. (host) the one wait of the call: the 8-byte total, copied
//             to pinned host memory, sizes the outputs.
//          7. join_emit_kernel, a merge-path emit: the probes' ends and
//             the output pairs, merged, are cut into tiles of kEmitTile
//             items; one search along each tile's diagonal (by the whole
//             block, kThreads points a round) finds its first probe and
//             pair, the tile's probe ends and row starts go to
//             shared memory, and each pair finds its probe there and copies
//             one build row from its key's contiguous range.  A tile holds
//             at most kEmitTile probes, so runs of probes without a match
//             cost no more than pairs, and a probe with 831 matches is
//             spread over the tiles its pairs fall in.
//
// What bounds it on an H100: memory.  The pairs (16 bytes each) and the
// keys (8 bytes each) are streamed once; the table's slots and the key
// gathers are random accesses into arrays that fit the 50 MB L2 at the
// main path's sizes.  At the main path's probe sizes (4,000 keys) the
// probe is a few microseconds of device work: what the caller waits for
// is the launches and the one host round trip for the total.  The first place step had every owner block read the
// slot of every build row (about 260 blocks x 1M rows from L2 at 1M build
// rows: 0.54 of the build's 0.64 ms); the partition reads each row a
// fixed number of times, however many owners there are.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPlacePer = 8;  // build rows a thread reads per tile
constexpr int kPlaceTile = kThreads * kPlacePer;
static_assert(kPlacePer * kWarps == 2 * 32, "one scan of 2 counts a lane");
// an owner's cursors fit in shared memory (the place kernel's static
// shared memory then stays within 48 KB); kernels/hash_join.py OWNER_SLOTS
constexpr int kOwnerSlots = 8064;

// splitmix64 finaliser of the full key; the top log2cap bits pick the home
__device__ __forceinline__ uint64_t home_slot(int64_t key, int log2cap) {
  uint64_t x = static_cast<uint64_t>(key);
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ull;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBull;
  x ^= x >> 31;
  return x >> (64 - log2cap);
}

__global__ void __launch_bounds__(kThreads)
join_insert_kernel(const int64_t* __restrict__ keys, int64_t n, int log2cap,
                   int32_t* slot_row, int32_t* slot_count,
                   int32_t* __restrict__ row_slot,
                   int64_t* __restrict__ row_owner) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t key = keys[i];
  const uint64_t mask = (1ull << log2cap) - 1;
  uint64_t s = home_slot(key, log2cap);
  while (true) {
    // a slot goes from 0 to its final row once: a stale 0 only sends
    // this thread to the atomicCAS, which returns the current value
    int32_t cur = slot_row[s];
    if (cur == 0) {
      cur = atomicCAS(slot_row + s, 0, static_cast<int32_t>(i + 1));
      if (cur == 0) break;  // claimed: the first row of a new key
    }
    if (keys[cur - 1] == key) break;
    s = (s + 1) & mask;
  }
  row_slot[i] = static_cast<int32_t>(s);
  row_owner[i] = static_cast<int64_t>(s / kOwnerSlots);
  atomicAdd(slot_count + s, 1);
}

// Exclusive scan, by warp 0, of the 64 per-(u, warp) counts in `count`
// (u major: the order of a tile's entries); `total` gets their sum.
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

// Block o owns the slots [o * kOwnerSlots, (o + 1) * kOwnerSlots) and
// places its rows -- perm[owner_start[o] .. + owner_count[o]), ascending --
// at their slots' cursors, which start at slot_start and live in shared
// memory.  Per tile of kPlaceTile rows (entry p = u * kThreads + thread,
// in row order): each thread loads kPlacePer rows and their slots, the
// tile is sorted by slot with a stable LSD radix sort (one ballot-and-scan
// split per bit of the slot's offset in the range), after which each run
// of one slot is contiguous: its head moves the slot's cursor back by its
// position, every row lands at cursor + position, its tail moves the
// cursor past the run.
__global__ void __launch_bounds__(kThreads)
join_place_kernel(const int32_t* __restrict__ perm,
                  const int64_t* __restrict__ owner_start,
                  const int64_t* __restrict__ owner_count,
                  const int32_t* __restrict__ row_slot,
                  const int64_t* __restrict__ slot_start,
                  int32_t* __restrict__ grouped, int64_t cap) {
  __shared__ int32_t list_row[kPlaceTile];
  __shared__ int32_t list_slot[kPlaceTile];  // slot - lo
  __shared__ int32_t local_cursor[kOwnerSlots];
  __shared__ int step_count[kPlacePer * kWarps];  // per (u, warp)
  __shared__ int zeros_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower_lanes = (1u << lane) - 1u;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * kOwnerSlots;
  const int64_t hi = lo + kOwnerSlots < cap ? lo + kOwnerSlots : cap;
  // positions in `grouped` are below n < 2^31
  for (int64_t i = threadIdx.x; lo + i < hi; i += kThreads) {
    local_cursor[i] = static_cast<int32_t>(slot_start[lo + i]);
  }
  const int64_t beg = owner_start[blockIdx.x];
  const int64_t end = beg + owner_count[blockIdx.x];
  const int sentinel = static_cast<int>(hi - lo);  // sorts after every slot
  const int key_bits = 32 - __clz(sentinel);
  __syncthreads();
  for (int64_t base = beg; base < end; base += kPlaceTile) {
    int32_t key[kPlacePer], row[kPlacePer];
#pragma unroll
    for (int u = 0; u < kPlacePer; ++u) {
      const int64_t p = base + u * kThreads + threadIdx.x;
      row[u] = p < end ? perm[p] : 0;
    }
#pragma unroll
    for (int u = 0; u < kPlacePer; ++u) {
      const int64_t p = base + u * kThreads + threadIdx.x;
      key[u] = p < end ? static_cast<int>(row_slot[row[u]] - lo) : sentinel;
    }
    for (int bit = 0; bit < key_bits; ++bit) {
      unsigned zeros[kPlacePer];
#pragma unroll
      for (int u = 0; u < kPlacePer; ++u) {
        zeros[u] = __ballot_sync(kFull, !((key[u] >> bit) & 1));
        if (lane == 0) step_count[u * kWarps + warp] = __popc(zeros[u]);
      }
      __syncthreads();  // and the last split's entries are in registers
      scan_step_counts(step_count, &zeros_total);
      __syncthreads();
      const int total_zeros = zeros_total;
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
    __syncthreads();  // the list, the counts and the cursors are reused
  }
}

// Status words of the probe's look-back: the flag in the top two bits,
// the block's aggregate or inclusive prefix in the low 62.
constexpr uint64_t kFlagAggregate = 1ull << 62;
constexpr uint64_t kFlagPrefix = 2ull << 62;
constexpr uint64_t kValueMask = (1ull << 62) - 1;
constexpr int kEmitPer = 4;  // merged items a thread covers per tile
constexpr int kEmitTile = kThreads * kEmitPer;

// The probe's int64 words, one buffer (quipt_join_probe_words): the
// scratch, zeroed on the stream before the probe — [0] the grand total,
// [1] the next block's ticket, [2 + b] block b's status word — then each
// probe's end (m words), then its key's start in `grouped` (m words).
constexpr int kScratchTotal = 0;
constexpr int kScratchTicket = 1;
constexpr int kScratchStatus = 2;

inline int64_t probe_blocks(int64_t m) { return (m + kThreads - 1) / kThreads; }
inline int64_t probe_scratch_words(int64_t m) {
  return kScratchStatus + probe_blocks(m);
}

__device__ __forceinline__ int64_t warp_inclusive_sum(int64_t v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t t = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

// Blocks take tickets in the order they start, so a block only waits on
// blocks that are already running: the look-back cannot deadlock.  A
// hit's count is the difference of two neighbouring slot starts (one
// sector, no read of slot_count).
__global__ void __launch_bounds__(kThreads)
join_probe_scan_kernel(const int64_t* __restrict__ build_keys, int64_t n,
                       const int32_t* __restrict__ slot_row,
                       const int64_t* __restrict__ slot_start,
                       const int64_t* __restrict__ probe_keys, int64_t m,
                       int log2cap, int64_t* __restrict__ ends,
                       int64_t* __restrict__ src,
                       unsigned long long* scratch) {
  __shared__ int64_t warp_sum[kWarps];
  __shared__ int64_t block_prefix;
  __shared__ int64_t ticket;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0)
    ticket = static_cast<int64_t>(atomicAdd(scratch + kScratchTicket, 1ull));
  __syncthreads();
  const int64_t block = ticket;
  const int64_t i = block * kThreads + threadIdx.x;
  int64_t count = 0, start = 0;
  if (i < m) {
    const int64_t key = probe_keys[i];
    const uint64_t mask = (1ull << log2cap) - 1;
    uint64_t s = home_slot(key, log2cap);
    while (true) {
      const int32_t cur = slot_row[s];
      if (cur == 0) break;  // an empty slot ends the chain: no match
      if (build_keys[cur - 1] == key) {
        start = slot_start[s];
        count = (s == mask ? n : slot_start[s + 1]) - start;
        break;
      }
      s = (s + 1) & mask;
    }
  }
  // the block's inclusive scan: within each warp, then over the warps
  const int64_t incl = warp_inclusive_sum(count, lane);
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int64_t w = lane < kWarps ? warp_sum[lane] : 0;
    const int64_t wincl = warp_inclusive_sum(w, lane);
    if (lane < kWarps) warp_sum[lane] = wincl - w;  // exclusive
    const int64_t aggregate = __shfl_sync(kFull, wincl, kWarps - 1);
    volatile unsigned long long* status = scratch + kScratchStatus;
    int64_t prefix = 0;
    if (block == 0) {
      if (lane == 0)
        status[0] = kFlagPrefix | static_cast<uint64_t>(aggregate);
    } else {
      if (lane == 0)
        status[block] = kFlagAggregate | static_cast<uint64_t>(aggregate);
      // look back 32 predecessors at a time, nearest in lane 0, until one
      // has published its inclusive prefix
      for (int64_t base = block - 1;; base -= 32) {
        const int64_t pred = base - lane;
        uint64_t word = pred >= 0 ? status[pred] : kFlagPrefix;
        while (__any_sync(kFull, (word >> 62) == 0)) {
          if ((word >> 62) == 0) {
            __nanosleep(20);
            word = status[pred];
          }
        }
        const unsigned done = __ballot_sync(kFull, (word >> 62) == 2);
        const int stop = done ? __ffs(done) - 1 : 31;
        int64_t v = lane <= stop ? static_cast<int64_t>(word & kValueMask) : 0;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
        prefix += v;
        if (done) break;
      }
      if (lane == 0)
        status[block] = kFlagPrefix | static_cast<uint64_t>(prefix + aggregate);
    }
    if (lane == 0) {
      block_prefix = prefix;
      if (block == gridDim.x - 1)
        scratch[kScratchTotal] = static_cast<uint64_t>(prefix + aggregate);
    }
  }
  __syncthreads();
  if (i < m) {
    ends[i] = block_prefix + warp_sum[warp] + incl;
    src[i] = start;
  }
}

// The merge path of the probes' ends (ends[0..m)) and the pairs (0..total):
// the number of probe ends among the first d merged items, a pair p going
// before an end e when p < e.  With P(a) = (ends[a] <= d - 1 - a), which
// holds below the split and fails from it on, the split is the first a in
// [lo, hi] where P fails (hi if none).  The whole block searches: each
// round tests kThreads points spread over the range and keeps the gap
// between the last that holds and the first that fails, so a range of a
// million probes takes three rounds of one load each.  Called by every
// thread of the block with the same arguments.
__device__ int64_t merge_split(const int64_t* __restrict__ ends, int64_t d,
                               int64_t lo, int64_t hi) {
  while (lo < hi) {
    const int64_t span = hi - lo;
    const bool exact = span <= kThreads;
    const int64_t x = exact ? lo + threadIdx.x
                            : lo + span * threadIdx.x / kThreads;
    const bool holds = (!exact || threadIdx.x < span) && ends[x] <= d - 1 - x;
    const int held = __syncthreads_count(holds);
    if (exact) return lo + held;
    hi = lo + span * held / kThreads;  // the first point that failed
    if (held > 0) lo += span * (held - 1) / kThreads + 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
join_emit_kernel(const int64_t* __restrict__ ends,
                 const int64_t* __restrict__ src, int64_t m,
                 const int32_t* __restrict__ grouped, int64_t total,
                 int64_t* __restrict__ out_probe,
                 int64_t* __restrict__ out_build) {
  __shared__ int64_t tile_end[kEmitTile + 1];
  __shared__ int64_t tile_off[kEmitTile + 1];  // row start - first pair
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * kEmitTile;
  const int64_t d1 = d0 + kEmitTile < m + total ? d0 + kEmitTile : m + total;
  const int64_t a0 = merge_split(ends, d0, d0 > total ? d0 - total : 0,
                                 d0 < m ? d0 : m);
  // the next split lies at most a tile further on
  const int64_t lo1 = d1 - total > a0 ? d1 - total : a0;
  const int64_t hi1 = a0 + (d1 - d0) < m ? a0 + (d1 - d0) : m;
  const int64_t a1 = merge_split(ends, d1, lo1, hi1);
  const int64_t p0 = d0 - a0, p1 = d1 - a1;
  // the tile's pairs belong to probes a0 .. min(a1, m - 1)
  const int probes = static_cast<int>((a1 < m ? a1 : m - 1) - a0 + 1);
  for (int j = threadIdx.x; j < probes; j += kThreads) {
    const int64_t i = a0 + j;
    tile_end[j] = ends[i];
    tile_off[j] = src[i] - (i == 0 ? 0 : ends[i - 1]);
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kEmitPer; ++u) {
    const int64_t p = p0 + u * kThreads + threadIdx.x;
    if (p < p1) {
      int lo = 0, hi = probes - 1;  // the first probe whose end is past p
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (tile_end[mid] > p) hi = mid; else lo = mid + 1;
      }
      out_probe[p] = a0 + lo;
      out_build[p] = grouped[tile_off[lo] + p];
    }
  }
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// Every entry point launches on `stream` and returns cudaGetLastError() as
// an int (0 = success).  slot_row and slot_count arrive zeroed.
// row_owner (int64) gets each row's owner, its slot / 8,064.
extern "C" int quipt_join_insert(const void* keys, int64_t n, int log2cap,
                                 void* slot_row, void* slot_count,
                                 void* row_slot, void* row_owner,
                                 void* stream) {
  if (n == 0) return 0;
  join_insert_kernel<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), n, log2cap,
      static_cast<int32_t*>(slot_row), static_cast<int32_t*>(slot_count),
      static_cast<int32_t*>(row_slot), static_cast<int64_t*>(row_owner));
  return static_cast<int>(cudaGetLastError());
}

// One block per owner, ceil(cap / 8,064) of them; perm lists the rows
// grouped by owner, owner_start / owner_count (int64) each owner's range
// of it, slot_start (int64) each slot's start in `grouped`.
extern "C" int quipt_join_place(const void* perm, const void* owner_start,
                                const void* owner_count, int64_t owners,
                                const void* row_slot, const void* slot_start,
                                void* grouped, int64_t cap, void* stream) {
  if (owners != (cap + kOwnerSlots - 1) / kOwnerSlots || owners > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  join_place_kernel<<<static_cast<unsigned>(owners), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(perm),
      static_cast<const int64_t*>(owner_start),
      static_cast<const int64_t*>(owner_count),
      static_cast<const int32_t*>(row_slot),
      static_cast<const int64_t*>(slot_start), static_cast<int32_t*>(grouped),
      cap);
  return static_cast<int>(cudaGetLastError());
}

// The int64 words a probe of m keys needs (its `words` buffer).
extern "C" int64_t quipt_join_probe_words(int64_t m) {
  return probe_scratch_words(m) + 2 * m;
}

// The merged items (probe ends and pairs) an emit block covers.
extern "C" int quipt_join_emit_tile() { return kEmitTile; }

// words: quipt_join_probe_words(m) int64 words (n_words, checked), laid out
// as above; its scratch is zeroed here on `stream`, and words[0] gets the
// number of pairs.  n: the build rows (the end of the last slot's range).
extern "C" int quipt_join_probe(const void* build_keys, int64_t n,
                                const void* slot_row, const void* slot_start,
                                const void* probe_keys, int64_t m, int log2cap,
                                void* words, int64_t n_words, void* stream) {
  if (m == 0) return 0;
  const int64_t blocks = probe_blocks(m);
  if (blocks > INT32_MAX || n_words != quipt_join_probe_words(m))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t scratch_words = probe_scratch_words(m);
  const cudaError_t zeroed =
      cudaMemsetAsync(words, 0, scratch_words * sizeof(int64_t), s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  int64_t* ends = static_cast<int64_t*>(words) + scratch_words;
  join_probe_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const int64_t*>(build_keys), n,
      static_cast<const int32_t*>(slot_row),
      static_cast<const int64_t*>(slot_start),
      static_cast<const int64_t*>(probe_keys), m, log2cap, ends, ends + m,
      static_cast<unsigned long long*>(words));
  return static_cast<int>(cudaGetLastError());
}

// ceil((m + total) / 1,024) blocks, one tile of the merge path each.
// words: the probe's buffer, after quipt_join_probe.
extern "C" int quipt_join_emit(const void* words, int64_t m,
                               const void* grouped, int64_t total,
                               void* out_probe, void* out_build, void* stream) {
  if (total == 0) return 0;
  const int64_t* ends =
      static_cast<const int64_t*>(words) + probe_scratch_words(m);
  const int64_t tiles = (m + total + kEmitTile - 1) / kEmitTile;
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  join_emit_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      ends, ends + m, m,
      static_cast<const int32_t*>(grouped), total,
      static_cast<int64_t*>(out_probe), static_cast<int64_t*>(out_build));
  return static_cast<int>(cudaGetLastError());
}
