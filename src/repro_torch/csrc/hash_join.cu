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
//   probe  5. join_probe_kernel, one thread per probe key: find the key's
//             slot (expected O(1) steps at load factor <= 1/2), write its
//             match count.
//          6. (host glue) an inclusive scan of the counts gives each probe
//             its range of the output.
//          7. join_emit_kernel, one thread per output pair: a binary search
//             of the scanned counts finds the pair's probe, which copies
//             one build row from its key's range.  A probe with 831
//             matches is spread over 831 threads.
//
// What bounds it on an H100: memory.  The pairs (16 bytes each) and the
// keys (8 bytes each) are streamed once; the table's slots and the key
// gathers are random accesses into arrays that fit the 50 MB L2 at the
// main path's sizes.  The first place step had every owner block read the
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

__global__ void __launch_bounds__(kThreads)
join_probe_kernel(const int64_t* __restrict__ build_keys,
                  const int32_t* __restrict__ slot_row,
                  const int32_t* __restrict__ slot_count,
                  const int64_t* __restrict__ probe_keys, int64_t m,
                  int log2cap, int32_t* __restrict__ probe_slot,
                  int64_t* __restrict__ counts) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int64_t key = probe_keys[i];
  const uint64_t mask = (1ull << log2cap) - 1;
  uint64_t s = home_slot(key, log2cap);
  int32_t found = -1;
  int64_t count = 0;
  while (true) {
    const int32_t cur = slot_row[s];
    if (cur == 0) break;  // an empty slot ends the chain: no match
    if (build_keys[cur - 1] == key) {
      found = static_cast<int32_t>(s);
      count = slot_count[s];
      break;
    }
    s = (s + 1) & mask;
  }
  probe_slot[i] = found;
  counts[i] = count;
}

__global__ void __launch_bounds__(kThreads)
join_emit_kernel(const int64_t* __restrict__ ends, int64_t m,
                 const int32_t* __restrict__ probe_slot,
                 const int64_t* __restrict__ slot_start,
                 const int32_t* __restrict__ grouped, int64_t total,
                 int64_t* __restrict__ out_probe,
                 int64_t* __restrict__ out_build) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= total) return;
  // the probe whose range holds p: the first i with ends[i] > p
  int64_t lo = 0, hi = m - 1;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (ends[mid] > p) hi = mid; else lo = mid + 1;
  }
  const int64_t first = lo == 0 ? 0 : ends[lo - 1];
  out_probe[p] = lo;
  out_build[p] = grouped[slot_start[probe_slot[lo]] + (p - first)];
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

extern "C" int quipt_join_probe(const void* build_keys, const void* slot_row,
                                const void* slot_count, const void* probe_keys,
                                int64_t m, int log2cap, void* probe_slot,
                                void* counts, void* stream) {
  if (m == 0) return 0;
  join_probe_kernel<<<blocks_for(m), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(build_keys),
      static_cast<const int32_t*>(slot_row),
      static_cast<const int32_t*>(slot_count),
      static_cast<const int64_t*>(probe_keys), m, log2cap,
      static_cast<int32_t*>(probe_slot), static_cast<int64_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int quipt_join_emit(const void* ends, int64_t m,
                               const void* probe_slot, const void* slot_start,
                               const void* grouped, int64_t total,
                               void* out_probe, void* out_build, void* stream) {
  if (total == 0) return 0;
  join_emit_kernel<<<blocks_for(total), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ends), m,
      static_cast<const int32_t*>(probe_slot),
      static_cast<const int64_t*>(slot_start),
      static_cast<const int32_t*>(grouped), total,
      static_cast<int64_t*>(out_probe), static_cast<int64_t*>(out_build));
  return static_cast<int>(cudaGetLastError());
}
