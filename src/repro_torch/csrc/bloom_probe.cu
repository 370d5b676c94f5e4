// Bloom-filter probe for the QUIP join triggers and the VF-list semi-join.
//
// Replaces the Pallas TPU kernel repro/kernels/bloom_probe.py
// (bloom_probe_pallas), which kept the whole bitset in VMEM and streamed
// 1024-key blocks through a vectorised word gather.
//
// What bounds it on an H100: memory.  Each key reads 4 bytes and writes a
// 1-byte flag, n * 5 bytes streamed against 3.35 TB/s, plus num_hashes
// random 4-byte word gathers from the bitset.  The bitset is at most
// 2^23 bits = 1 MiB, so after the first touches it lives in the 50 MB L2
// and the gathers cost L2, not HBM, bandwidth.
//
// Design: one thread per key, the hash constants in __constant__ memory
// (every thread of a warp reads the same word: a broadcast), native uint32
// wraparound for the multiply-shift, bitset words read through the
// read-only path (__ldg).  Neighbouring threads read and write neighbouring
// keys, so the streamed traffic is coalesced.  The keys arrive as int32
// storage holding uint32 bits; the kernel reinterprets them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxHashes = 8;

// must equal repro_torch/kernels/hashing.py MULTIPLIERS / OFFSETS
__constant__ uint32_t kMultipliers[kMaxHashes] = {
    0x85EBCA6Bu, 0xC2B2AE35u, 0x27D4EB2Fu, 0x165667B1u,
    0x9E3779B1u, 0xFF51AFD7u, 0xC4CEB9FFu, 0x2545F491u};
__constant__ uint32_t kOffsets[kMaxHashes] = {
    0x1B873593u, 0xE6546B64u, 0x85EBCA77u, 0xC2B2AE3Du,
    0x27D4EB4Fu, 0x165667C5u, 0x9E3779B9u, 0xFF51AFD9u};

__global__ void __launch_bounds__(256)
bloom_probe_kernel(const uint32_t* __restrict__ bits,
                   const uint32_t* __restrict__ folded,
                   bool* __restrict__ out, int64_t n, int num_hashes,
                   int shift) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t f = folded[i];
  bool ok = true;
  for (int h = 0; h < num_hashes; ++h) {
    const uint32_t pos = (f * kMultipliers[h] + kOffsets[h]) >> shift;
    const uint32_t word = __ldg(bits + (pos >> 5));
    ok &= ((word >> (pos & 31u)) & 1u) != 0u;
  }
  out[i] = ok;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() as an int (0 = success).
extern "C" int quipt_bloom_probe(const void* bits, const void* folded,
                                 void* out, int64_t n, int num_hashes,
                                 int log2m, void* stream) {
  if (n == 0) return 0;
  constexpr int kThreads = 256;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  bloom_probe_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), static_cast<const uint32_t*>(folded),
      static_cast<bool*>(out), n, num_hashes, 32 - log2m);
  return static_cast<int>(cudaGetLastError());
}
