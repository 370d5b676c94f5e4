// Per-row aggregation of the k neighbours' targets after the KNN top-k:
// the mean for float attributes, the mode for integer ones.
//
// Replaces the Pallas TPU kernels repro/kernels/neighbor_agg.py
// (neighbor_mean_pallas, neighbor_mode_pallas).  The TPU mode kernel took
// dictionary codes compressed on the host (np.unique) and built a
// (rows, num_classes) one-hot count block in VMEM.  Here the mode works on
// the raw int64 values: for each of a row's k values it counts the equal
// values in the row (k * k compares, k = 5 on the main path), so neither
// the host compression nor a class-wide count block is needed.  Keeping
// the highest count with ties to the smallest value is the reference's
// first-maximum argmax over ascending classes.
//
// The mode takes either the (b, k) values or the (b, k) neighbour ids of
// the KNN top-k with the reference rows' (n_ref,) targets, and then
// gathers the values itself: no (b, k) matrix of values is written and
// read back, and no separate gather is launched.
//
// What bounds them on an H100: memory, and at the main path's batch of
// 1024 rows, the launch.  Each row reads k values (or k ids and k
// targets) and writes one; the arithmetic is a handful of adds or
// compares per value.  The mode's block of 64 rows loads its rows' k
// values or ids -- one contiguous run -- with coalesced loads into shared
// memory, every gather of a target independent of the others; each thread
// then counts its row in registers, unrolled for k up to 16 (a template
// argument there; a larger k counts from global memory).  A 1024-row batch
// spreads over 16 SMs.  One thread per row
// keeps the mean's sum in column order: with -fmad=false and the explicit
// round-to-nearest intrinsics its bits equal those of
// repro_torch/kernels/ref.py neighbor_mean_ref.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
neighbor_mean_kernel(const float* __restrict__ vals, int64_t b, int k,
                     float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const float* row = vals + i * k;
  float s = k > 0 ? row[0] : 0.0f;
  for (int j = 1; j < k; ++j) s = __fadd_rn(s, row[j]);
  out[i] = __fdiv_rn(s, static_cast<float>(k));
}

constexpr int kModeRows = 64;  // rows (threads) a mode block takes

__device__ __forceinline__ void keep_mode(int64_t v, int count,
                                          int64_t* best, int* best_count) {
  if (count > *best_count || (count == *best_count && v < *best)) {
    *best_count = count;
    *best = v;
  }
}

// kIds: `src` holds ids into `targets`; else `src` holds the values.
// K > 0: k == K, staged and counted in registers; K == 0: any k, each
// thread reading its row from global memory (k > 16).
template <bool kIds, int K>
__global__ void __launch_bounds__(kModeRows)
neighbor_mode_kernel(const int64_t* __restrict__ src,
                     const int64_t* __restrict__ targets, int64_t b, int k,
                     int64_t* __restrict__ out) {
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kModeRows;
  const int64_t i = row0 + threadIdx.x;
  if (K == 0) {
    if (i >= b) return;
    const int64_t* row = src + i * k;
    int64_t best = kIds ? targets[row[0]] : row[0];
    int best_count = 0;
    for (int a = 0; a < k; ++a) {
      const int64_t v = kIds ? targets[row[a]] : row[a];
      int count = 0;
      for (int j = 0; j < k; ++j)
        count += (kIds ? targets[row[j]] : row[j]) == v;
      keep_mode(v, count, &best, &best_count);
    }
    out[i] = best;
    return;
  }
  constexpr int kK = K > 0 ? K : 1;
  // the block's rows are one run of rows * K values (or ids): coalesced
  // loads, every thread's K loads (and gathers) independent
  __shared__ int64_t stage[kModeRows * kK];
  const int rows = b - row0 < kModeRows ? static_cast<int>(b - row0)
                                        : kModeRows;
  const int n = rows * kK;
  const int64_t* base = src + row0 * kK;
  int64_t x[kK];
#pragma unroll
  for (int u = 0; u < kK; ++u) {
    const int e = u * kModeRows + threadIdx.x;
    if (e < n) x[u] = base[e];
  }
  if (kIds) {
#pragma unroll
    for (int u = 0; u < kK; ++u) {
      const int e = u * kModeRows + threadIdx.x;
      if (e < n) x[u] = targets[x[u]];
    }
  }
#pragma unroll
  for (int u = 0; u < kK; ++u) {
    const int e = u * kModeRows + threadIdx.x;
    if (e < n) stage[e] = x[u];
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= rows) return;
  int64_t v[kK];
#pragma unroll
  for (int a = 0; a < kK; ++a) v[a] = stage[threadIdx.x * kK + a];
  int64_t best = v[0];
  int best_count = 0;
#pragma unroll
  for (int a = 0; a < kK; ++a) {
    int count = 0;
#pragma unroll
    for (int j = 0; j < kK; ++j) count += v[j] == v[a];
    keep_mode(v[a], count, &best, &best_count);
  }
  out[i] = best;
}

template <bool kIds>
void launch_mode(const int64_t* src, const int64_t* targets, int64_t b, int k,
                 int64_t* out, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((b + kModeRows - 1) /
                                                kModeRows);
#define QUIPT_MODE_CASE(K)                                                   \
  case K:                                                                    \
    neighbor_mode_kernel<kIds, K><<<blocks, kModeRows, 0, s>>>(src, targets, \
                                                              b, k, out);    \
    return;
  switch (k) {
    QUIPT_MODE_CASE(1) QUIPT_MODE_CASE(2) QUIPT_MODE_CASE(3)
    QUIPT_MODE_CASE(4) QUIPT_MODE_CASE(5) QUIPT_MODE_CASE(6)
    QUIPT_MODE_CASE(7) QUIPT_MODE_CASE(8) QUIPT_MODE_CASE(9)
    QUIPT_MODE_CASE(10) QUIPT_MODE_CASE(11) QUIPT_MODE_CASE(12)
    QUIPT_MODE_CASE(13) QUIPT_MODE_CASE(14) QUIPT_MODE_CASE(15)
    QUIPT_MODE_CASE(16)
    default:
      neighbor_mode_kernel<kIds, 0><<<blocks, kModeRows, 0, s>>>(
          src, targets, b, k, out);
  }
#undef QUIPT_MODE_CASE
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() as an int.
extern "C" int quipt_neighbor_mean(const void* vals, int64_t b, int k,
                                   void* out, void* stream) {
  if (b == 0) return 0;
  neighbor_mean_kernel<<<blocks_for(b), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), b, k, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// targets == nullptr: `src` holds the (b, k) values; else the (b, k) ids
// into targets, each in [0, len(targets)).
extern "C" int quipt_neighbor_mode(const void* src, const void* targets,
                                   int64_t b, int k, void* out, void* stream) {
  if (b == 0) return 0;
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* in = static_cast<const int64_t*>(src);
  const int64_t* t = static_cast<const int64_t*>(targets);
  int64_t* o = static_cast<int64_t*>(out);
  if (t != nullptr)
    launch_mode<true>(in, t, b, k, o, s);
  else
    launch_mode<false>(in, t, b, k, o, s);
  return static_cast<int>(cudaGetLastError());
}
