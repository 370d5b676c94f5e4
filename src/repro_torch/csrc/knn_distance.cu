// Masked partial-L2 distances for KNN imputation: the (nq, nr) matrix, and
// the k nearest reference rows of each query row with the matrix never
// written.
//
// masked_distance_kernel replaces the Pallas TPU kernel
// repro/kernels/knn_distance.py (masked_distance_pallas), which ran the
// four sums as MXU matmuls over (128, 128) output blocks and wrote a
// (2, nq, nr) scratch.  masked_knn_select_kernel and
// masked_knn_merge_kernel replace the same kernel together with the
// jax.lax.top_k that repro/kernels/ops.py (masked_knn) runs on its output.
//
// out[i, j] = max((q2 + r2 - 2 cross) * (d / n), 0) where n > 0, else +inf,
// with, over the features k in ascending order,
//   qv = q*qm, rv = r*rm,
//   q2 += qv*qv*rm,  r2 += qm*rv*rv,  cross += qv*rv,  n += qm*rm.
//
// Both compute each 32 x 128 tile of outputs the same way (tile_distances):
// 256 threads, each thread owning 4 rows x 4 columns of the tile with four
// fp32 accumulators per output in registers.  Feature chunks of q, qm, r,
// rm (and the squared values) are staged in shared memory feature-major,
// so that a warp's stores and loads hit 32 banks; any d works, in chunks
// of kChunk, and only the chunk's kc features are staged (all kChunk of
// them, row-major, put 16-way bank conflicts on the stores, which took
// about as long as the arithmetic at d = 4).
// Every operation is a separate round-to-nearest multiply or add
// (__fmul_rn / __fadd_rn: no FMA contraction) in the order of the plain
// torch version (repro_torch/kernels/ref.py masked_distance_ref), so the
// two agree bit for bit.  Full fp32 on the CUDA cores: TF32 tensor cores
// would break the 2e-4 tolerance against the reference.
//
// masked_distance_kernel writes the (nq, nr) result, each warp storing 32
// consecutive floats of one row.  What bounds it on an H100: memory by
// count.  At the main path's widths (d of 4 to 10) the work is under 10
// flop per output byte, so the bound is the nq*nr*4-byte output write
// against 3.35 TB/s (about 2 GB, 0.6 ms, for a 1024-row batch against
// 486k reference rows); in practice the arithmetic, issued one multiply or
// add at a time, takes longer than the write.
//
// The KNN path needs only the k smallest of each row (k = 5 by default),
// in ascending order with ties to the lowest column (the order of
// jax.lax.top_k on the negated matrix).  Each output becomes one unique
// 64-bit key (float bits << 32) | column -- the bits of a non-negative
// float, +inf included, order like its value -- so comparing keys is the
// tie rule (ref.py smallest_k builds the same keys).
//   1. masked_knn_select_kernel, grid (splits, query tiles): a block takes
//      32 query rows and a contiguous range of 128-column tiles, about
//      2 x 132 blocks in all.  A row belongs to one warp (the warp's 32
//      lanes hold its 128 columns), which keeps the row's 32 smallest keys
//      so far as a sorted list in registers (lane i holds the i-th) and the
//      k-th as a threshold.  Each output costs one 64-bit compare against
//      it; a ballot of 32 outputs that all fail (nearly every one after
//      the first tiles) costs nothing more.  Survivors go to the row's
//      32-key buffer in shared memory; when it would overflow, and at the
//      end, the warp merges buffer and list (a bitonic sort of the buffer,
//      the smaller of list[i] and buffer[31 - i], a bitonic merge) and
//      lowers the threshold.  The block writes each row's k keys to an
//      (nq, splits, k) scratch, padded with UINT64_MAX where a split saw
//      fewer than k columns; every real key is below the pad.
//   2. masked_knn_merge_kernel, one warp per query row: the k smallest of
//      the row's splits * k keys, by the same merge, 32 keys at a time;
//      writes dists (the high word) and idx (the low word).
// ref.py masked_knn_split_ref emulates these steps on the CPU.  What
// bounds the pair on an H100: operations, nq*nr*(8d + 7) of them (the four
// accumulations, the finish step, the compare): at 67 TFLOP/s about
// 0.29 ms for a 1024-row batch against 486k rows at d = 4.  Built with
// -fmad=false (kernels/build.py), every multiply and add issues alone, so
// the kernel's own floor is about twice that.  Writes are (nq, k) plus
// the scratch, a few MB at most, where the matrix and smallest_k's key
// matrix took 6 GB.  k is at most 32 (the list is one key a lane); the
// wrapper routes a larger k to masked_distance_kernel and smallest_k.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileRows = 32;   // query rows per block
constexpr int kTileCols = 128;  // reference rows per tile
constexpr int kThreadsX = 32;   // one warp across the columns
constexpr int kThreadsY = 8;
constexpr int kRowsPerThread = kTileRows / kThreadsY;  // 4
constexpr int kColsPerThread = kTileCols / kThreadsX;  // 4
constexpr int kChunk = 16;      // features staged per pass
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kMaxK = 32;       // the select kernel's list: one key a lane
constexpr int kBuffer = 32;     // survivors a row buffers before a merge
constexpr int kMergeWarps = kThreads / 32;
constexpr uint64_t kPad = ~0ull;

// one feature chunk of a tile, [k][row] so that a warp reads consecutive
// banks
struct Stage {
  float qv[kChunk][kTileRows];
  float qv2[kChunk][kTileRows];
  float qm[kChunk][kTileRows];
  float rv[kChunk][kTileCols];
  float rv2[kChunk][kTileCols];
  float rm[kChunk][kTileCols];
};

// The outputs (row0 + ty + 8 m, col0 + tx + 32 c) of the tile at
// (row0, col0) into v[m][c]; an output past nq or nr comes out +inf (its
// inputs stage as zeros).  Called by all 256 threads.
__device__ __forceinline__ void tile_distances(
    Stage& st, const float* __restrict__ q, const float* __restrict__ qm,
    const float* __restrict__ r, const float* __restrict__ rm, int nq, int nr,
    int d, int row0, int col0, float (&v)[kRowsPerThread][kColsPerThread]) {
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;

  float acc_q2[kRowsPerThread][kColsPerThread];
  float acc_r2[kRowsPerThread][kColsPerThread];
  float acc_x[kRowsPerThread][kColsPerThread];
  float acc_n[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) {
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      acc_q2[m][c] = 0.f;
      acc_r2[m][c] = 0.f;
      acc_x[m][c] = 0.f;
      acc_n[m][c] = 0.f;
    }
  }

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    const int kc = min(kChunk, d - k0);
    // stage the chunk feature-major: a warp takes 32 rows or columns of
    // one feature (its stores hit 32 banks), and skips features past kc
#pragma unroll
    for (int it = 0; it < kTileRows * kChunk / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int k = e / kTileRows, row = e % kTileRows;
      if (k < kc) {
        const int gi = row0 + row;
        float x = 0.f, m = 0.f;
        if (gi < nq) {
          const int64_t off = static_cast<int64_t>(gi) * d + k0 + k;
          x = q[off];
          m = qm[off];
        }
        const float xx = __fmul_rn(x, m);
        st.qv[k][row] = xx;
        st.qv2[k][row] = __fmul_rn(xx, xx);
        st.qm[k][row] = m;
      }
    }
#pragma unroll
    for (int it = 0; it < kTileCols * kChunk / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int k = e / kTileCols, col = e % kTileCols;
      if (k < kc) {
        const int gj = col0 + col;
        float x = 0.f, m = 0.f;
        if (gj < nr) {
          const int64_t off = static_cast<int64_t>(gj) * d + k0 + k;
          x = r[off];
          m = rm[off];
        }
        const float xx = __fmul_rn(x, m);
        st.rv[k][col] = xx;
        st.rv2[k][col] = __fmul_rn(xx, xx);
        st.rm[k][col] = m;
      }
    }
    __syncthreads();

    for (int k = 0; k < kc; ++k) {
      float qv[kRowsPerThread], qv2[kRowsPerThread], qmk[kRowsPerThread];
      float rv[kColsPerThread], rv2[kColsPerThread], rmk[kColsPerThread];
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m) {
        const int row = ty + m * kThreadsY;
        qv[m] = st.qv[k][row];
        qv2[m] = st.qv2[k][row];
        qmk[m] = st.qm[k][row];
      }
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        const int col = tx + c * kThreadsX;
        rv[c] = st.rv[k][col];
        rv2[c] = st.rv2[k][col];
        rmk[c] = st.rm[k][col];
      }
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m) {
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          acc_q2[m][c] = __fadd_rn(acc_q2[m][c], __fmul_rn(qv2[m], rmk[c]));
          acc_r2[m][c] = __fadd_rn(acc_r2[m][c], __fmul_rn(qmk[m], rv2[c]));
          acc_x[m][c] = __fadd_rn(acc_x[m][c], __fmul_rn(qv[m], rv[c]));
          acc_n[m][c] = __fadd_rn(acc_n[m][c], __fmul_rn(qmk[m], rmk[c]));
        }
      }
    }
    __syncthreads();
  }

  const float d_total = static_cast<float>(d);
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) {
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const float n = acc_n[m][c];
      float x = INFINITY;
      if (n > 0.f) {
        const float sq = __fsub_rn(__fadd_rn(acc_q2[m][c], acc_r2[m][c]),
                                   __fmul_rn(2.f, acc_x[m][c]));
        const float scale = __fdiv_rn(d_total, fmaxf(n, 1.f));
        x = fmaxf(__fmul_rn(sq, scale), 0.f);
      }
      v[m][c] = x;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
masked_distance_kernel(const float* __restrict__ q,
                       const float* __restrict__ qm,
                       const float* __restrict__ r,
                       const float* __restrict__ rm,
                       float* __restrict__ out, int nq, int nr, int d) {
  __shared__ Stage st;
  const int row0 = blockIdx.y * kTileRows;
  const int col0 = blockIdx.x * kTileCols;
  float v[kRowsPerThread][kColsPerThread];
  tile_distances(st, q, qm, r, rm, nq, nr, d, row0, col0, v);
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) {
    const int gi = row0 + threadIdx.y + m * kThreadsY;
    if (gi >= nq) continue;
    float* out_row = out + static_cast<int64_t>(gi) * nr;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int gj = col0 + threadIdx.x + c * kThreadsX;
      if (gj < nr) out_row[gj] = v[m][c];
    }
  }
}

__device__ __forceinline__ uint64_t umin64(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint64_t umax64(uint64_t a, uint64_t b) {
  return a < b ? b : a;
}

// the warp's 32 keys, one a lane, sorted ascending in lane order
__device__ __forceinline__ uint64_t warp_sort(uint64_t v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      const uint64_t o = __shfl_xor_sync(kFull, v, stride);
      const bool ascending = (lane & size) == 0;  // this lane's run
      const bool lower = (lane & stride) == 0;
      v = lower == ascending ? umin64(v, o) : umax64(v, o);
    }
  }
  return v;
}

// the 32 smallest of a sorted list (lane i holds its i-th key) and 32 more
// keys, sorted: list[i] against the candidates' (31 - i)-th keeps the 32
// smallest as a bitonic sequence, which a bitonic merge sorts
__device__ __forceinline__ uint64_t warp_merge(uint64_t list, uint64_t cand,
                                               int lane) {
  cand = warp_sort(cand, lane);
  uint64_t v = umin64(list, __shfl_sync(kFull, cand, 31 - lane));
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const uint64_t o = __shfl_xor_sync(kFull, v, stride);
    v = (lane & stride) == 0 ? umin64(v, o) : umax64(v, o);
  }
  return v;
}

// a row's selection state, the same in every lane of its warp but `list`
struct Selection {
  uint64_t list;  // this lane's key of the row's 32 smallest so far
  uint64_t thr;   // the k-th smallest so far: only a smaller key can stay
  int len;        // keys in the row's buffer
};

__device__ __forceinline__ Selection flush(Selection s, const uint64_t* buf,
                                           int k, int lane) {
  __syncwarp();  // the buffer's keys are written
  const uint64_t cand = lane < s.len ? buf[lane] : kPad;
  __syncwarp();  // and read before the buffer fills again
  s.list = warp_merge(s.list, cand, lane);
  s.thr = __shfl_sync(kFull, s.list, k - 1);
  s.len = 0;
  return s;
}

// one key a lane, of which at least one passes the threshold: buffer the
// ones that pass, in lane order, merging first if the buffer would
// overflow (a call, not inlined: it runs rarely)
__device__ __noinline__ Selection offer(Selection s, uint64_t key,
                                        uint64_t* buf, int k, int lane) {
  bool pass = key < s.thr;
  unsigned ball = __ballot_sync(kFull, pass);
  if (s.len + __popc(ball) > kBuffer) {
    s = flush(s, buf, k, lane);
    pass = key < s.thr;
    ball = __ballot_sync(kFull, pass);
  }
  if (pass) buf[s.len + __popc(ball & ((1u << lane) - 1u))] = key;
  s.len += __popc(ball);
  return s;
}

// Block (split, query tile): the k smallest keys of each of the tile's
// rows over the column tiles [split * per, (split + 1) * per), into
// part[(row * splits + split) * k + i].  Capped at 128 registers so that
// two blocks fit an SM (the grid is sized for it).
__global__ void __launch_bounds__(kThreads, 2)
masked_knn_select_kernel(const float* __restrict__ q,
                         const float* __restrict__ qm,
                         const float* __restrict__ r,
                         const float* __restrict__ rm, int nq, int nr, int d,
                         int k, int per, uint64_t* __restrict__ part) {
  __shared__ Stage st;
  __shared__ uint64_t buf[kTileRows][kBuffer];
  const int lane = threadIdx.x;
  const int row0 = blockIdx.y * kTileRows;
  const int tiles = (nr + kTileCols - 1) / kTileCols;
  const int t_lo = blockIdx.x * per;
  const int t_hi = min(t_lo + per, tiles);
  Selection sel[kRowsPerThread];
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) sel[m] = {kPad, kPad, 0};

  for (int t = t_lo; t < t_hi; ++t) {
    const int col0 = t * kTileCols;
    float v[kRowsPerThread][kColsPerThread];
    tile_distances(st, q, qm, r, rm, nq, nr, d, row0, col0, v);
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m) {
      const int row = threadIdx.y + m * kThreadsY;
      const bool row_ok = row0 + row < nq;
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        const int gj = col0 + lane + c * kThreadsX;
        const uint64_t key =
            row_ok && gj < nr
                ? (static_cast<uint64_t>(__float_as_uint(v[m][c])) << 32) |
                      static_cast<uint32_t>(gj)
                : kPad;
        if (__ballot_sync(kFull, key < sel[m].thr)) {
          sel[m] = offer(sel[m], key, buf[row], k, lane);
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) {
    const int row = threadIdx.y + m * kThreadsY;
    if (sel[m].len) sel[m] = flush(sel[m], buf[row], k, lane);
    const int gi = row0 + row;
    if (gi < nq && lane < k) {
      part[(static_cast<int64_t>(gi) * gridDim.x + blockIdx.x) * k + lane] =
          sel[m].list;
    }
  }
}

// One warp per query row: the k smallest of its splits * k keys, 32 at a
// time, written as dists (the float in the high word) and idx (the column).
__global__ void __launch_bounds__(kThreads)
masked_knn_merge_kernel(const uint64_t* __restrict__ part, int nq, int splits,
                        int k, float* __restrict__ dists,
                        int64_t* __restrict__ idx) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kMergeWarps + (threadIdx.x >> 5);
  if (row >= nq) return;  // the whole warp
  const int total = splits * k;
  const uint64_t* p = part + row * total;
  uint64_t list = kPad;
  for (int base = 0; base < total; base += 32) {
    const uint64_t cand = base + lane < total ? p[base + lane] : kPad;
    list = warp_merge(list, cand, lane);
  }
  if (lane < k) {
    dists[row * k + lane] = __uint_as_float(static_cast<uint32_t>(list >> 32));
    idx[row * k + lane] = static_cast<int64_t>(list & 0xffffffffu);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() as an int (0 = success).
extern "C" int quipt_masked_distance(const void* q, const void* qm,
                                     const void* r, const void* rm, void* out,
                                     int nq, int nr, int d, void* stream) {
  if (nq == 0 || nr == 0) return 0;
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((nr + kTileCols - 1) / kTileCols,
                  (nq + kTileRows - 1) / kTileRows);
  masked_distance_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(qm),
      static_cast<const float*>(r), static_cast<const float*>(rm),
      static_cast<float*>(out), nq, nr, d);
  return static_cast<int>(cudaGetLastError());
}

// The k (1 to 32, at most nr) nearest of each query row: the select kernel
// over `splits` ranges of column tiles into part ((nq, splits, k) uint64
// scratch), then the merge into dists ((nq, k) float32) and idx ((nq, k)
// int64).  Both launch on `stream`; returns cudaGetLastError() as an int.
extern "C" int quipt_masked_knn(const void* q, const void* qm, const void* r,
                                const void* rm, int nq, int nr, int d, int k,
                                int splits, void* part, void* dists,
                                void* idx, void* stream) {
  if (nq == 0) return 0;
  if (k < 1 || k > kMaxK || k > nr || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (nr + kTileCols - 1) / kTileCols;
  const int per = (tiles + splits - 1) / splits;
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid(splits, (nq + kTileRows - 1) / kTileRows);
  masked_knn_select_kernel<<<grid, block, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(qm),
      static_cast<const float*>(r), static_cast<const float*>(rm), nq, nr, d,
      k, per, static_cast<uint64_t*>(part));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  masked_knn_merge_kernel<<<(nq + kMergeWarps - 1) / kMergeWarps, kThreads, 0,
                            st>>>(static_cast<const uint64_t*>(part), nq,
                                  splits, k, static_cast<float*>(dists),
                                  static_cast<int64_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}
