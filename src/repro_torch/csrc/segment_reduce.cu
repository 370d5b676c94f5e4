// Segment reduction for the compiled executor's grouped aggregates:
// (n,) values + (n,) int64 segment ids -> (S,) per-segment COUNT, SUM, MIN
// or MAX, computed in int64 or float64.
//
// Replaces the Pallas TPU kernel repro/kernels/segment_ops.py
// (segment_reduce_pallas).  That kernel built a (512, Sp) one-hot block of
// the rows' ids against every segment and folded it into a VMEM-resident
// (Sp,) accumulator, in int32/float32.  Sp is 3,166 on the wifi main path
// and can reach hundreds of thousands (a GROUP BY on a time column), so a
// block per segment count does not carry over; and a float sum folded in
// block order is not the order of the reference's serving member
// (kernels/ops.py _segment_numpy: a stable grouping of the rows by
// segment, then numpy's pairwise slice.sum()).  This design keeps that
// order, so every op equals the numpy member bit for bit:
//
//   1. segment_count_kernel, one thread per row: the row's slot (its id,
//      or -1 for a negative id or one >= S, which drops the row) and an
//      int64 count per segment.  Rows of a warp with one id add their
//      count with one atomicAdd (__match_any_sync).  This is all of COUNT.
//   2. (host glue) an exclusive scan of the counts gives each segment its
//      range of the grouped row array.
//   3. join_place_kernel (csrc/hash_join.cu, quipt_join_place) with the
//      slots as its keys' slots: each segment's rows land in its range in
//      ascending row order.
//   4. segment_reduce_kernel, one thread per segment, reads its rows'
//      values through the grouped indices:
//        - float64 SUM: numpy's order.  The segment is cut into blocks of
//          the size numpy's reduce hands its inner loop (8,192 values up
//          to numpy 2.2; the wrapper passes the size it finds,
//          kernels/ref.py numpy_sum_block); s = 0.0, then
//          s += pairwise(block) block by block.  pairwise(n): n < 8 a
//          sequential sum from 0.0;
//          n <= 128 eight running sums r[j] += a[i + j] over the largest
//          multiple of 8, ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)), then the
//          rest in order; else a split at n/2 - (n/2 mod 8).  Built with
//          -fmad=false, there are only adds, in that order.
//        - int64 SUM wraps as numpy's does; MIN/MAX compare (not
//          fmin/fmax, which drop NaN) and return NaN for a segment that
//          holds one.  Empty segments hold the identity.
//
// What bounds it on an H100: memory.  Each row's id and value are read
// once and the (S,) results written once.  This first version leaves two
// costs above that bound (ROADMAP): the place step reads every row's slot
// once per owner block, and one thread reduces a whole segment, so one
// segment of a million rows is a million dependent loads and adds on one
// thread (the eight running sums give it some instruction-level
// parallelism).

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int64_t kLeaf = 128;  // numpy's pairwise-sum leaf
constexpr int kDepth = 32;      // pairwise frames; 2^31 values need <= 26

enum Op { kSum = 0, kMin = 1, kMax = 2 };

__global__ void __launch_bounds__(kThreads)
segment_count_kernel(const int64_t* __restrict__ seg, int64_t n,
                     int64_t num_segments, int32_t* __restrict__ row_slot,
                     unsigned long long* counts) {
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
      atomicAdd(counts + s, static_cast<unsigned long long>(__popc(grp)));
    }
  }
}

// numpy's pairwise_sum on a block of n <= 128 values, read through `idx`
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

__device__ __forceinline__ int64_t pairwise_split(int64_t n) {
  const int64_t half = n / 2;
  return half - half % 8;
}

// numpy's pairwise_sum on a block of n values: the recursion
// pairwise(lo, n) = pairwise(lo, n2) + pairwise(lo + n2, n - n2), run on
// an explicit stack of frames in the same order of additions
__device__ double chunk_sum(const double* __restrict__ vals,
                            const int32_t* __restrict__ idx, int64_t n) {
  if (n <= kLeaf) return leaf_sum(vals, idx, n);
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
        val = leaf_sum(vals, idx + f_lo[top], f_n[top]);
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

__device__ __forceinline__ double sum_segment(const double* __restrict__ vals,
                                              const int32_t* __restrict__ idx,
                                              int64_t count, int64_t block) {
  if (block <= 0) block = count;  // numpy's reduce takes the whole slice
  double s = 0.0;
  for (int64_t c = 0; c < count; c += block) {
    const int64_t n = count - c < block ? count - c : block;
    s += chunk_sum(vals, idx + c, n);
  }
  return s;
}

__device__ __forceinline__ int64_t sum_segment(const int64_t* __restrict__ vals,
                                               const int32_t* __restrict__ idx,
                                               int64_t count, int64_t) {
  unsigned long long s = 0;  // wraps modulo 2^64, as numpy's int64 sum
  for (int64_t i = 0; i < count; ++i) {
    s += static_cast<unsigned long long>(vals[idx[i]]);
  }
  return static_cast<int64_t>(s);
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

template <typename T, int kOp>
__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const T* __restrict__ vals,
                      const int32_t* __restrict__ grouped,
                      const int64_t* __restrict__ starts,
                      const int64_t* __restrict__ counts, int64_t num_segments,
                      int64_t block, T ident, T* __restrict__ out) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= num_segments) return;
  const int32_t* idx = grouped + starts[s];
  const int64_t count = counts[s];
  if (kOp == kSum) {
    out[s] = count == 0 ? ident : sum_segment(vals, idx, count, block);
    return;
  }
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
  out[s] = nan ? nan_of<T>() : r;
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

template <typename T>
int launch_reduce(const void* vals, int op, const void* grouped,
                  const void* starts, const void* counts, int64_t num_segments,
                  int64_t block, T ident, void* out, cudaStream_t stream) {
  const T* v = static_cast<const T*>(vals);
  const int32_t* g = static_cast<const int32_t*>(grouped);
  const int64_t* st = static_cast<const int64_t*>(starts);
  const int64_t* c = static_cast<const int64_t*>(counts);
  T* o = static_cast<T*>(out);
  const unsigned blocks = blocks_for(num_segments);
  switch (op) {
    case kSum:
      segment_reduce_kernel<T, kSum><<<blocks, kThreads, 0, stream>>>(
          v, g, st, c, num_segments, block, ident, o);
      break;
    case kMin:
      segment_reduce_kernel<T, kMin><<<blocks, kThreads, 0, stream>>>(
          v, g, st, c, num_segments, block, ident, o);
      break;
    case kMax:
      segment_reduce_kernel<T, kMax><<<blocks, kThreads, 0, stream>>>(
          v, g, st, c, num_segments, block, ident, o);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry point launches on `stream` and returns cudaGetLastError() as
// an int (0 = success).  counts arrives zeroed; row_slot may be null (a
// COUNT needs no grouping).
extern "C" int quipt_segment_count(const void* seg, int64_t n,
                                   int64_t num_segments, void* row_slot,
                                   void* counts, void* stream) {
  if (n == 0) return 0;
  segment_count_kernel<<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(seg), n, num_segments,
      static_cast<int32_t*>(row_slot),
      static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// op: 0 sum, 1 min, 2 max; is_float: 1 for float64 values, 0 for int64.
// block: the values numpy's reduce adds per inner-loop call (0: all).
// ident_bits is the identity's 64 bits (an int64, or a float64's bits).
extern "C" int quipt_segment_reduce(const void* vals, int is_float, int op,
                                    const void* grouped, const void* starts,
                                    const void* counts, int64_t num_segments,
                                    int64_t block, int64_t ident_bits,
                                    void* out, void* stream) {
  if (num_segments == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_float) {
    double ident;
    std::memcpy(&ident, &ident_bits, sizeof ident);
    return launch_reduce<double>(vals, op, grouped, starts, counts,
                                 num_segments, block, ident, out, st);
  }
  return launch_reduce<int64_t>(vals, op, grouped, starts, counts,
                                num_segments, block, ident_bits, out, st);
}
