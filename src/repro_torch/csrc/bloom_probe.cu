// Bloom-filter probe for the QUIP join triggers and the VF-list semi-join.
//
// Replaces the Pallas TPU kernel repro/kernels/bloom_probe.py
// (bloom_probe_pallas), which kept the whole bitset in VMEM and streamed
// 1024-key blocks through a vectorised word gather.  The TPU kernel took
// keys folded to uint32 on the host (x32-mode JAX and the TPU's vector
// unit have no 64-bit integer lanes); an H100 has them, so the keys entry
// below takes the raw int64 keys and folds each in the kernel.  The folded
// entry, whose signature mirrors the reference's, stays.
//
// What bounds it on an H100: memory.  The keys entry reads 8 bytes a key
// and writes a 1-byte flag, n * 9 bytes streamed against 3.35 TB/s, plus
// num_hashes random 4-byte word gathers from the bitset.  The bitset is
// at most 2^23 bits = 1 MiB (128 KiB at the default log2m = 20), so after
// the first touches it lives in the 50 MB L2.  A gather of 32 random words
// through the L1 costs up to 32 cache lines, one a cycle, so at n * H
// lookups on keys spread over the whole bitset the gathers, not the key
// stream, set the pace.  Staging the whole bitset in each block's shared
// memory first was tried: it won on keys spread at random, and lost on
// the main path's join keys, so the gathers stay on the read-only path
// (__ldg).
//
// Design of the keys entry: a thread takes four keys -- two 16-byte loads
// in with the streaming hint (__ldcs), so that they do not push the bitset
// out of the caches, one 4-byte store of four flags out -- folds each
// (lo ^ hi * 0x9E3779B9 in uint32 wraparound, repro_torch/kernels/
// hashing.py fold64), and issues all 4 * num_hashes word gathers before it
// tests any bit, so they are in flight together (num_hashes is a template
// argument, the loops unrolled).  Keys that sit 8 bytes past a 16-byte
// boundary (a view such as keys[1:]) take one 16-byte and two 8-byte
// loads a thread; the last n % 4 keys are probed one at a time by one
// thread.  The hash constants are in __constant__ memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxHashes = 8;
constexpr int kThreads = 256;
constexpr uint32_t kPhi = 0x9E3779B9u;  // hashing.py PHI

// must equal repro_torch/kernels/hashing.py MULTIPLIERS / OFFSETS
__constant__ uint32_t kMultipliers[kMaxHashes] = {
    0x85EBCA6Bu, 0xC2B2AE35u, 0x27D4EB2Fu, 0x165667B1u,
    0x9E3779B1u, 0xFF51AFD7u, 0xC4CEB9FFu, 0x2545F491u};
__constant__ uint32_t kOffsets[kMaxHashes] = {
    0x1B873593u, 0xE6546B64u, 0x85EBCA77u, 0xC2B2AE3Du,
    0x27D4EB4Fu, 0x165667C5u, 0x9E3779B9u, 0xFF51AFD9u};

__global__ void __launch_bounds__(kThreads)
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

__device__ __forceinline__ uint32_t fold64(long long key) {
  const unsigned long long u = static_cast<unsigned long long>(key);
  return static_cast<uint32_t>(u) ^ (static_cast<uint32_t>(u >> 32) * kPhi);
}

// The flags of kKeys folded keys, byte j of the result holding key j's
// (0 or 1): every word gather is issued before the first bit test.
template <int H, int kKeys>
__device__ __forceinline__ uint32_t probe(const uint32_t* __restrict__ bits,
                                          const uint32_t (&f)[kKeys],
                                          int shift) {
  uint32_t word[kKeys][H];
  uint32_t bit[kKeys][H];
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const uint32_t pos = (f[j] * kMultipliers[h] + kOffsets[h]) >> shift;
      word[j][h] = __ldg(bits + (pos >> 5));
      bit[j][h] = pos & 31u;
    }
  }
  uint32_t flags = 0;
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    uint32_t ok = 1u;
#pragma unroll
    for (int h = 0; h < H; ++h) ok &= word[j][h] >> bit[j][h];
    flags |= (ok & 1u) << (8 * j);
  }
  return flags;
}

// Keys 4g .. 4g + 3 folded, streamed past the caches: two 16-byte loads
// when the keys sit on a 16-byte boundary (kAligned), else one 16-byte
// load between two 8-byte ones.
template <bool kAligned>
__device__ __forceinline__ void load4(const long long* __restrict__ keys,
                                      int64_t g, uint32_t (&f)[4]) {
  const long long* p = keys + 4 * g;
  long long k[4];
  if (kAligned) {
    const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(p));
    const longlong2 b = __ldcs(reinterpret_cast<const longlong2*>(p + 2));
    k[0] = a.x; k[1] = a.y; k[2] = b.x; k[3] = b.y;
  } else {
    const longlong2 m = __ldcs(reinterpret_cast<const longlong2*>(p + 1));
    k[0] = __ldcs(p);
    k[1] = m.x; k[2] = m.y;
    k[3] = __ldcs(p + 3);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = fold64(k[j]);
}

// The last n % 4 keys, one at a time.
template <int H>
__device__ __forceinline__ void probe_tail(const uint32_t* __restrict__ bits,
                                           const long long* __restrict__ keys,
                                           uint8_t* __restrict__ out,
                                           int64_t n, int shift) {
  for (int64_t t = n & ~int64_t{3}; t < n; ++t) {
    const uint32_t f[1] = {fold64(__ldcs(keys + t))};
    out[t] = static_cast<uint8_t>(probe<H, 1>(bits, f, shift));
  }
}

// A thread a group of four keys; the thread after the last group probes
// the n % 4 keys left.
template <int H, bool kAligned>
__global__ void __launch_bounds__(kThreads)
bloom_probe_keys_kernel(const uint32_t* __restrict__ bits,
                        const long long* __restrict__ keys,
                        uint8_t* __restrict__ out, int64_t n, int shift) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g < n / 4) {
    uint32_t f[4];
    load4<kAligned>(keys, g, f);
    __stcs(reinterpret_cast<unsigned int*>(out) + g,
           probe<H, 4>(bits, f, shift));
  } else if (g == n / 4) {
    probe_tail<H>(bits, keys, out, n, shift);
  }
}

template <bool kAligned>
void launch_keys(const uint32_t* bits, const long long* keys, uint8_t* out,
                 int64_t n, int num_hashes, int log2m, cudaStream_t s) {
  const unsigned blocks =
      static_cast<unsigned>((n / 4 + 1 + kThreads - 1) / kThreads);
  const int shift = 32 - log2m;
#define QUIPT_KEYS_CASE(H)                                                  \
  case H:                                                                   \
    bloom_probe_keys_kernel<H, kAligned><<<blocks, kThreads, 0, s>>>(       \
        bits, keys, out, n, shift);                                         \
    return;
  switch (num_hashes) {
    QUIPT_KEYS_CASE(1) QUIPT_KEYS_CASE(2) QUIPT_KEYS_CASE(3)
    QUIPT_KEYS_CASE(4) QUIPT_KEYS_CASE(5) QUIPT_KEYS_CASE(6)
    QUIPT_KEYS_CASE(7) QUIPT_KEYS_CASE(8)
  }
#undef QUIPT_KEYS_CASE
}

}  // namespace

// Both entries launch on `stream` and return cudaGetLastError() as an int
// (0 = success).
extern "C" int quipt_bloom_probe(const void* bits, const void* folded,
                                 void* out, int64_t n, int num_hashes,
                                 int log2m, void* stream) {
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  bloom_probe_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), static_cast<const uint32_t*>(folded),
      static_cast<bool*>(out), n, num_hashes, 32 - log2m);
  return static_cast<int>(cudaGetLastError());
}

// keys: (n,) int64, 8-byte aligned; out: (n,) bool, 4-byte aligned.
extern "C" int quipt_bloom_probe_keys(const void* bits, const void* keys,
                                      void* out, int64_t n, int num_hashes,
                                      int log2m, void* stream) {
  if (n == 0) return 0;
  const uintptr_t k = reinterpret_cast<uintptr_t>(keys);
  if (k % 8 != 0 || reinterpret_cast<uintptr_t>(out) % 4 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (num_hashes < 1 || num_hashes > kMaxHashes)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* b = static_cast<const uint32_t*>(bits);
  const long long* kp = static_cast<const long long*>(keys);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (k % 16 == 0)
    launch_keys<true>(b, kp, o, n, num_hashes, log2m, s);
  else
    launch_keys<false>(b, kp, o, n, num_hashes, log2m, s);
  return static_cast<int>(cudaGetLastError());
}
