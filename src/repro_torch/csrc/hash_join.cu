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
//             key's rows; each row records its slot.
//          2. (host glue) an exclusive scan of the counts gives each key
//             its range of the grouped row array.
//          3. join_place_kernel: each block owns a range of slots and
//             scans the build rows in row order, placing the rows of its
//             keys at their key's cursor.  A key has one owner that sees
//             its rows in ascending order, so every range comes out
//             ascending -- the order an atomicAdd cursor would lose -- and
//             a key with many copies costs no more than many keys with one.
//   probe  4. join_probe_kernel, one thread per probe key: find the key's
//             slot (expected O(1) steps at load factor <= 1/2), write its
//             match count.
//          5. (host glue) an inclusive scan of the counts gives each probe
//             its range of the output.
//          6. join_emit_kernel, one thread per output pair: a binary search
//             of the scanned counts finds the pair's probe, which copies
//             one build row from its key's range.  A probe with 831
//             matches is spread over 831 threads.
//
// What bounds it on an H100: memory.  The pairs (16 bytes each) and the
// keys (8 bytes each) are streamed once; the table's slots and the key
// gathers are random accesses into arrays that fit the 50 MB L2 at the
// main path's sizes.  Step 3 reads the slot of every build row once per
// owning block from L2; that, not HBM, is its cost.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPlacePer = 8;  // build rows a thread reads per tile
constexpr int kPlaceTile = kThreads * kPlacePer;
static_assert(kPlacePer * kWarps == 2 * 32, "one scan of 2 counts a lane");
// a block's cursors fit in shared memory up to this many slots (the
// kernel's static shared memory then stays within 48 KB)
constexpr int kSharedSlots = 8064;
constexpr int64_t kMaxPlaceBlocks = 2 * 132;  // two per SM

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
                   int32_t* __restrict__ row_slot) {
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
  atomicAdd(slot_count + s, 1);
}

__device__ __forceinline__ void load_slots(const int32_t* __restrict__ row_slot,
                                           int64_t n, int64_t base,
                                           int32_t (&s)[kPlacePer]) {
#pragma unroll
  for (int u = 0; u < kPlacePer; ++u) {
    const int64_t r = base + u * kThreads + threadIdx.x;
    s[u] = r < n ? row_slot[r] : -1;
  }
}

// Each block owns the slots [lo, lo + span) and places the rows of those
// keys, in row order, at cursor[slot] (the key's next free position).  Per
// tile of kPlaceTile build rows: every thread reads kPlacePer slots
// (coalesced; the next tile's are read while this one is placed), the block
// compacts the rows it owns into a shared list in row order (ballots and a
// scan of the per-warp counts), and warp 0 walks the list 32 rows at a
// time, ranking equal slots with __match_any_sync.  When the block's range
// fits, its cursors live in shared memory.
__global__ void __launch_bounds__(kThreads)
join_place_kernel(const int32_t* __restrict__ row_slot, int64_t n,
                  int64_t* cursor, int32_t* __restrict__ grouped,
                  int64_t cap, int64_t span) {
  __shared__ int32_t list_row[kPlaceTile];
  __shared__ int32_t list_slot[kPlaceTile];  // slot - lo
  __shared__ int32_t local_cursor[kSharedSlots];
  __shared__ int step_count[kPlacePer * kWarps];  // owned rows per (u, warp)
  __shared__ int list_len;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower_lanes = (1u << lane) - 1u;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * span;
  const int64_t hi = lo + span < cap ? lo + span : cap;
  const bool local = span <= kSharedSlots;
  if (local) {  // positions in `grouped` are below n < 2^31
    for (int64_t i = threadIdx.x; lo + i < hi; i += kThreads) {
      local_cursor[i] = static_cast<int32_t>(cursor[lo + i]);
    }
  }
  int32_t next[kPlacePer];
  load_slots(row_slot, n, 0, next);
  for (int64_t base = 0; base < n; base += kPlaceTile) {
    // row base + u * kThreads + threadIdx.x: (u, warp, lane) is row order
    int32_t s[kPlacePer];
#pragma unroll
    for (int u = 0; u < kPlacePer; ++u) s[u] = next[u];
    load_slots(row_slot, n, base + kPlaceTile, next);
    unsigned owned[kPlacePer];
#pragma unroll
    for (int u = 0; u < kPlacePer; ++u) {
      owned[u] = __ballot_sync(kFull, s[u] >= lo && s[u] < hi);
      if (lane == 0) step_count[u * kWarps + warp] = __popc(owned[u]);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the counts, 2 a lane
      const int c0 = step_count[2 * lane];
      const int c1 = step_count[2 * lane + 1];
      int incl = c0 + c1;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += t;
      }
      step_count[2 * lane] = incl - c0 - c1;
      step_count[2 * lane + 1] = incl - c1;
      if (lane == 31) list_len = incl;
    }
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
    if (warp == 0) {
      const int len = list_len;
      for (int j = 0; j < len; j += 32) {
        const bool valid = j + lane < len;
        const unsigned m = __ballot_sync(kFull, valid);
        if (valid) {
          const int32_t rel = list_slot[j + lane];
          const unsigned grp = __match_any_sync(m, rel);
          const int rank = __popc(grp & lower_lanes);
          const int64_t pos =
              (local ? local_cursor[rel] : cursor[lo + rel]) + rank;
          grouped[pos] = list_row[j + lane];
          __syncwarp(m);  // the group reads its cursor before it moves
          if (rank == 0) {
            const int64_t moved = pos + __popc(grp);
            if (local) {
              local_cursor[rel] = static_cast<int32_t>(moved);
            } else {
              cursor[lo + rel] = moved;
            }
          }
        }
        __syncwarp();  // the move is seen by the next step's readers
      }
    }
    __syncthreads();  // the list and the counts are reused by the next tile
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
extern "C" int quipt_join_insert(const void* keys, int64_t n, int log2cap,
                                 void* slot_row, void* slot_count,
                                 void* row_slot, void* stream) {
  if (n == 0) return 0;
  join_insert_kernel<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), n, log2cap,
      static_cast<int32_t*>(slot_row), static_cast<int32_t*>(slot_count),
      static_cast<int32_t*>(row_slot));
  return static_cast<int>(cudaGetLastError());
}

// cursor arrives holding each slot's start in `grouped`; it is consumed.
extern "C" int quipt_join_place(const void* row_slot, int64_t n, void* cursor,
                                void* grouped, int64_t cap, void* stream) {
  if (n == 0) return 0;
  int64_t blocks = (cap + kSharedSlots - 1) / kSharedSlots;
  if (blocks > kMaxPlaceBlocks) blocks = kMaxPlaceBlocks;
  const int64_t span = (cap + blocks - 1) / blocks;
  join_place_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_slot), n,
      static_cast<int64_t*>(cursor), static_cast<int32_t*>(grouped), cap,
      span);
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
