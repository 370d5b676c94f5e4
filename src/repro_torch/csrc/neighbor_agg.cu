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
// What bounds them on an H100: memory, and at the main path's batch of
// 1024 rows, the launch.  Each row reads k values and writes one; the
// arithmetic is a handful of adds or compares per value.  One thread per
// row keeps the mean's sum in column order: with -fmad=false and the
// explicit round-to-nearest intrinsics its bits equal those of
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

__global__ void __launch_bounds__(kThreads)
neighbor_mode_kernel(const int64_t* __restrict__ vals, int64_t b, int k,
                     int64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const int64_t* row = vals + i * k;
  int64_t best = row[0];
  int best_count = 0;
  for (int a = 0; a < k; ++a) {
    const int64_t v = row[a];
    int count = 0;
    for (int j = 0; j < k; ++j) count += row[j] == v;
    if (count > best_count || (count == best_count && v < best)) {
      best_count = count;
      best = v;
    }
  }
  out[i] = best;
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

extern "C" int quipt_neighbor_mode(const void* vals, int64_t b, int k,
                                   void* out, void* stream) {
  if (b == 0) return 0;
  neighbor_mode_kernel<<<blocks_for(b), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(vals), b, k, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
