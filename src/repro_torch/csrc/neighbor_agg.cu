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
// Both take either the (b, k) values or the (b, k) neighbour ids of the
// KNN top-k with the reference rows' (n_ref,) targets, and then gather the
// values themselves: no (b, k) matrix of values is written and read back,
// and no separate gather is launched.
//
// What bounds them on an H100: memory, and at the main path's batch of
// 1024 rows, the launch.  Each row reads k values (or k ids and k
// targets) and writes one; the arithmetic is a handful of adds or
// compares per value.  A block of 64 rows loads its rows' k values or ids
// -- one contiguous run -- with coalesced loads into shared memory, every
// gather of a target independent of the others; each thread then reduces
// its row in registers, unrolled for k up to 16 (a template argument
// there; a larger k reads its row from global memory).  A 1024-row batch
// spreads over 16 SMs.  The mean keeps its sum in column order: with
// -fmad=false and the explicit round-to-nearest intrinsics (__fadd_rn,
// then one __fdiv_rn by k) its bits equal those of
// repro_torch/kernels/ref.py neighbor_mean_ref.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;  // rows (threads) a block takes

// Stages the block's rows * K values (or the targets their ids name) in
// `stage`: one coalesced run of loads, every thread's K loads (and
// gathers) independent.  Returns the block's row count.
template <bool kIds, int K, typename T>
__device__ __forceinline__ int stage_rows(const void* __restrict__ src,
                                          const T* __restrict__ targets,
                                          int64_t b, T* stage) {
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows = b - row0 < kRows ? static_cast<int>(b - row0) : kRows;
  const int n = rows * K;
  T x[K];
  if (kIds) {
    const int64_t* base = static_cast<const int64_t*>(src) + row0 * K;
    int64_t id[K];
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int e = u * kRows + threadIdx.x;
      if (e < n) id[u] = base[e];
    }
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int e = u * kRows + threadIdx.x;
      if (e < n) x[u] = targets[id[u]];
    }
  } else {
    const T* base = static_cast<const T*>(src) + row0 * K;
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int e = u * kRows + threadIdx.x;
      if (e < n) x[u] = base[e];
    }
  }
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const int e = u * kRows + threadIdx.x;
    if (e < n) stage[e] = x[u];
  }
  __syncthreads();
  return rows;
}

// kIds: `src` holds int64 ids into `targets`; else `src` holds the float
// values.  K > 0: k == K, staged and summed in registers; K == 0: any k,
// each thread reading its row from global memory (k > 16, or k == 0,
// whose 0 / 0 is the NaN of a mean over no values).
template <bool kIds, int K>
__global__ void __launch_bounds__(kRows)
neighbor_mean_kernel(const void* __restrict__ src,
                     const float* __restrict__ targets, int64_t b, int k,
                     float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.x;
  if (K == 0) {
    if (i >= b) return;
    const int64_t* ids = static_cast<const int64_t*>(src) + i * k;
    const float* vals = static_cast<const float*>(src) + i * k;
    float s = 0.0f;
    for (int j = 0; j < k; ++j) {
      const float v = kIds ? targets[ids[j]] : vals[j];
      s = j == 0 ? v : __fadd_rn(s, v);
    }
    out[i] = __fdiv_rn(s, static_cast<float>(k));
    return;
  }
  constexpr int kK = K > 0 ? K : 1;
  __shared__ float stage[kRows * kK];
  const int rows = stage_rows<kIds, kK>(src, targets, b, stage);
  if (static_cast<int>(threadIdx.x) >= rows) return;
  const float* row = stage + threadIdx.x * kK;
  float s = row[0];
#pragma unroll
  for (int j = 1; j < kK; ++j) s = __fadd_rn(s, row[j]);
  out[i] = __fdiv_rn(s, static_cast<float>(kK));
}

template <bool kIds>
void launch_mean(const void* src, const float* targets, int64_t b, int k,
                 float* out, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((b + kRows - 1) / kRows);
#define QUIPT_MEAN_CASE(K)                                                  \
  case K:                                                                   \
    neighbor_mean_kernel<kIds, K><<<blocks, kRows, 0, s>>>(src, targets, b, \
                                                          k, out);          \
    return;
  switch (k) {
    QUIPT_MEAN_CASE(1) QUIPT_MEAN_CASE(2) QUIPT_MEAN_CASE(3)
    QUIPT_MEAN_CASE(4) QUIPT_MEAN_CASE(5) QUIPT_MEAN_CASE(6)
    QUIPT_MEAN_CASE(7) QUIPT_MEAN_CASE(8) QUIPT_MEAN_CASE(9)
    QUIPT_MEAN_CASE(10) QUIPT_MEAN_CASE(11) QUIPT_MEAN_CASE(12)
    QUIPT_MEAN_CASE(13) QUIPT_MEAN_CASE(14) QUIPT_MEAN_CASE(15)
    QUIPT_MEAN_CASE(16)
    default:
      neighbor_mean_kernel<kIds, 0><<<blocks, kRows, 0, s>>>(src, targets, b,
                                                            k, out);
  }
#undef QUIPT_MEAN_CASE
}

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
__global__ void __launch_bounds__(kRows)
neighbor_mode_kernel(const int64_t* __restrict__ src,
                     const int64_t* __restrict__ targets, int64_t b, int k,
                     int64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.x;
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
  __shared__ int64_t stage[kRows * kK];
  const int rows = stage_rows<kIds, kK>(src, targets, b, stage);
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
  const unsigned blocks = static_cast<unsigned>((b + kRows - 1) / kRows);
#define QUIPT_MODE_CASE(K)                                                  \
  case K:                                                                   \
    neighbor_mode_kernel<kIds, K><<<blocks, kRows, 0, s>>>(src, targets, b, \
                                                          k, out);          \
    return;
  switch (k) {
    QUIPT_MODE_CASE(1) QUIPT_MODE_CASE(2) QUIPT_MODE_CASE(3)
    QUIPT_MODE_CASE(4) QUIPT_MODE_CASE(5) QUIPT_MODE_CASE(6)
    QUIPT_MODE_CASE(7) QUIPT_MODE_CASE(8) QUIPT_MODE_CASE(9)
    QUIPT_MODE_CASE(10) QUIPT_MODE_CASE(11) QUIPT_MODE_CASE(12)
    QUIPT_MODE_CASE(13) QUIPT_MODE_CASE(14) QUIPT_MODE_CASE(15)
    QUIPT_MODE_CASE(16)
    default:
      neighbor_mode_kernel<kIds, 0><<<blocks, kRows, 0, s>>>(src, targets, b,
                                                            k, out);
  }
#undef QUIPT_MODE_CASE
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() as an int.
// targets == nullptr: `src` holds the (b, k) values; else the (b, k) int64
// ids into targets, each in [0, len(targets)).
extern "C" int quipt_neighbor_mean(const void* src, const void* targets,
                                   int64_t b, int k, void* out, void* stream) {
  if (b == 0) return 0;
  if (k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(targets);
  float* o = static_cast<float*>(out);
  if (t != nullptr)
    launch_mean<true>(src, t, b, k, o, s);
  else
    launch_mean<false>(src, t, b, k, o, s);
  return static_cast<int>(cudaGetLastError());
}

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
