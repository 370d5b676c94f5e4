// Flash attention for grouped-query attention: causal and/or sliding-window
// online-softmax attention that never writes the score matrix to memory.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_pallas).  That kernel walks a (B, H, NQ, NK) grid whose
// innermost key axis runs in order on one TPU core, carrying the running
// max, sum and accumulator in VMEM from one grid step to the next, on
// copies of q/k/v moved to (B, H, S, D) and padded to the block size.
// Here one CTA owns one (64-row query tile, query head, batch) and loops
// over the key tiles itself, so the carried state lives in its registers;
// q (B, S, H, D) and k/v (B, S, KV, D) are read in place through their
// strides, query head h reading KV head h / (H / KV), and the ragged edge
// is masked instead of padded.
//
// Per key tile of 64 rows: K and V are staged in shared memory as float32
// (bf16 inputs are widened on load); each thread computes a 4 x 4 block
// of the 64 x 64 score tile on CUDA cores (query rows ty + 16 i, key
// columns tx + 16 j), masks it to -1e30 exactly as the reference does
// (key past S, above the diagonal, left of the window), and updates the
// online max and sum of its rows; the 16 threads of a row reduce with warp
// shuffles.  The probabilities go through shared memory to the P.V
// product, whose float32 accumulator is spread over the CTA: each thread
// holds 4 rows x ceil(D / 16) columns.  Key tiles wholly above the
// diagonal or left of the window are skipped.  Masked scores stay at
// -1e30 and never become -inf: exp(-1e30 - (-1e30)) = 1 while a row has
// seen only masked keys, and the first kept key's alpha = exp(-1e30 - m)
// = 0 wipes that, as in the reference (-inf would give inf - inf = NaN).
// The output is acc / max(l, 1e-30), written in q's dtype.
//
// Its route (kernels/flash_attention.py): float32 at every head width
// (hubert-xlarge's D 80 included), and bf16 at head widths other than 64,
// 80, 128 and 256 (D 96, say); bf16 at those widths runs the tensor-core
// kernel (flash_attention_tc.cu).
//
// What bounds it on an H100: operations.  At the slice's call in float32
// (B 2, S 4096, H 16, KV 2, D 128, causal) the two products do
// 4 * B * H * D * 8.39M kept pairs = 137 GFLOP, ~2.05 ms at the CUDA
// cores' 67 TFLOP/s.  This kernel uses CUDA cores and float32 and is
// limited by its shared-memory reads (two loads per two FMAs in the score
// loop).  Float32 takes no TF32 or bf16 products, which would leave the
// 2e-4 it is held to.  The products use explicit
// fmaf (the library compiles with -fmad=false) and exp uses expf, not
// __expf, so float32 inputs stay within 2e-4 of the plain version.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;               // query rows per CTA
constexpr int kBK = 64;               // key rows per tile
constexpr int kTX = 16;               // threads across a row's columns
constexpr int kTY = 16;               // thread rows
constexpr int kThreads = kTX * kTY;   // 256
constexpr int kRows = kBQ / kTY;      // query rows per thread
constexpr int kCols = kBK / kTX;      // key columns per thread
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float row_max(float x) {
  for (int o = kTX / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
  for (int o = kTX / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int d) {
  const int ld = d + 1;
  return sizeof(float) *
         (static_cast<size_t>(kBQ) * ld + static_cast<size_t>(kBK) * ld +
          static_cast<size_t>(kBK) * d + kBQ * kBK);
}

// DJ: accumulator columns per thread, ceil(D / 16) rounded up to a power
// of two (the compile-time bound of the loops over D).
template <typename T, int DJ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int H, int KV, int D, int causal, int window,
                       float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;  // padded stride: the score loop reads columns
  float* qs = smem;              // [kBQ][ld]
  float* ks = qs + kBQ * ld;     // [kBK][ld]
  float* vs = ks + kBK * ld;     // [kBK][D]
  float* ps = vs + kBK * D;      // [kBQ][kBK]

  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * kBQ;  // long tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int64_t q_step = static_cast<int64_t>(H) * D;
  const int64_t kv_step = static_cast<int64_t>(KV) * D;
  const T* qb = q + (static_cast<int64_t>(b) * S * H + h) * D;
  const T* kb = k + (static_cast<int64_t>(b) * S * KV + kvh) * D;
  const T* vb = v + (static_cast<int64_t>(b) * S * KV + kvh) * D;

  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int s = q_lo + r;
    qs[r * ld + d] = s < S ? to_f32(qb[s * q_step + d]) : 0.0f;
  }

  float m[kRows], l[kRows], acc[kRows][DJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  // the key tiles some row of this query tile keeps
  const int q_hi = min(q_lo + kBQ - 1, S - 1);
  const int kt_end = (causal ? q_hi : S - 1) / kBK;
  int kt_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0) kt_begin = (q_lo - window + 1) / kBK;

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k_lo = kt * kBK;
    __syncthreads();  // the last tile's readers are done with ks, vs, ps
    for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
      const int r = i / D;
      const int d = i - r * D;
      const int s = k_lo + r;
      const bool in = s < S;
      ks[r * ld + d] = in ? to_f32(kb[s * kv_step + d]) : 0.0f;
      vs[r * D + d] = in ? to_f32(vb[s * kv_step + d]) : 0.0f;
    }
    __syncthreads();

    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + kTY * i) * ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + kTX * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kTY * i;
      const int qpos = q_lo + r;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k_lo + tx + kTX * j;
        bool ok = kpos < S;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        sc[i][j] = ok ? sc[i][j] * scale : kNeg;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps[r * kBK + tx + kTX * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + kTY * i) * kBK + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + kTX * j;
        if (d < D) {
          const float vv = vs[c * D + d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

  T* ob = out + (static_cast<int64_t>(b) * S * H + h) * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q_lo + ty + kTY * i;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + kTX * j;
      if (d < D) ob[qpos * q_step + d] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int DJ>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, int D, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, DJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KV, D, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int H, int KV, int D, int causal, int window, float scale,
             cudaStream_t stream) {
  if (D <= 16)
    return launch<T, 1>(q, k, v, out, B, S, H, KV, D, causal, window, scale,
                        stream);
  if (D <= 32)
    return launch<T, 2>(q, k, v, out, B, S, H, KV, D, causal, window, scale,
                        stream);
  if (D <= 64)
    return launch<T, 4>(q, k, v, out, B, S, H, KV, D, causal, window, scale,
                        stream);
  if (D <= 128)
    return launch<T, 8>(q, k, v, out, B, S, H, KV, D, causal, window, scale,
                        stream);
  return launch<T, 16>(q, k, v, out, B, S, H, KV, D, causal, window, scale,
                       stream);
}

}  // namespace

// q (B, S, H, D), k/v (B, S, KV, D), out (B, S, H, D), all contiguous and
// of one dtype: float32 (bf16 == 0) or bfloat16 (bf16 == 1); 1 <= D <= 256,
// H a multiple of KV.  window <= 0 means no window.  Launches on `stream`
// and returns cudaGetLastError() as an int.
extern "C" int quipt_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int S,
                                     int H, int KV, int D, int bf16,
                                     int causal, int window, float scale,
                                     void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (D < 1 || D > 256 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, S, H, KV, D, causal,
                                   window, scale, st);
  return dispatch<float>(q, k, v, out, B, S, H, KV, D, causal, window, scale,
                         st);
}
