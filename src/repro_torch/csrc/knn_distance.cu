// Masked partial-L2 distance matrix for KNN imputation.
//
// Replaces the Pallas TPU kernel repro/kernels/knn_distance.py
// (masked_distance_pallas), which ran the four sums as MXU matmuls over
// (128, 128) output blocks and wrote a (2, nq, nr) scratch.
//
// out[i, j] = max((q2 + r2 - 2 cross) * (d / n), 0) where n > 0, else +inf,
// with, over the features k in ascending order,
//   qv = q*qm, rv = r*rm,
//   q2 += qv*qv*rm,  r2 += qm*rv*rv,  cross += qv*rv,  n += qm*rm.
//
// What bounds it on an H100: memory.  At the main path's widths (d of 4
// to 10) the work is under 10 flop per output byte, so the bound is the
// nq*nr*4-byte output write against 3.35 TB/s (about 2 GB, 0.6 ms, for a
// 1024-row batch against 486k reference rows).  The inputs are small and
// are re-read from L2.
//
// Design: a 2-D grid of 32 x 128 output tiles, 256 threads, each thread
// owning 4 rows x 4 columns of the tile with four fp32 accumulators per
// output in registers.  Feature chunks of q, qm, r, rm (and the squared
// values) are staged in shared memory, transposed so that a warp reads
// consecutive banks; any d works, in chunks of kChunk.  The finish step
// runs in the kernel, and only the (nq, nr) result is written, each warp
// storing 32 consecutive floats of one row.  Every operation is a separate
// round-to-nearest multiply or add (__fmul_rn / __fadd_rn: no FMA
// contraction) in the order of the plain torch version
// (repro_torch/kernels/ref.py masked_distance_ref), so the two agree bit
// for bit.  Full fp32 on the CUDA cores: TF32 tensor cores would break the
// 2e-4 tolerance against the reference.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 32;   // query rows per block
constexpr int kTileCols = 128;  // reference rows per block
constexpr int kThreadsX = 32;   // one warp across the columns
constexpr int kThreadsY = 8;
constexpr int kRowsPerThread = kTileRows / kThreadsY;  // 4
constexpr int kColsPerThread = kTileCols / kThreadsX;  // 4
constexpr int kChunk = 16;      // features staged per pass
constexpr int kThreads = kThreadsX * kThreadsY;

__global__ void __launch_bounds__(kThreads)
masked_distance_kernel(const float* __restrict__ q,
                       const float* __restrict__ qm,
                       const float* __restrict__ r,
                       const float* __restrict__ rm,
                       float* __restrict__ out, int nq, int nr, int d) {
  // [k][row] layouts: threads of a warp read consecutive columns
  __shared__ float s_qv[kChunk][kTileRows];
  __shared__ float s_qv2[kChunk][kTileRows];
  __shared__ float s_qm[kChunk][kTileRows];
  __shared__ float s_rv[kChunk][kTileCols];
  __shared__ float s_rv2[kChunk][kTileCols];
  __shared__ float s_rm[kChunk][kTileCols];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int row0 = blockIdx.y * kTileRows;
  const int col0 = blockIdx.x * kTileCols;

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
    // stage the chunk with a fixed, unrolled trip count so every thread
    // issues all its global loads before the first shared store; rows past
    // the edge and features past d load as zeros (never used or stored)
#pragma unroll
    for (int it = 0; it < kTileRows * kChunk / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int row = e / kChunk, k = e % kChunk;
      const int gi = row0 + row;
      float v = 0.f, m = 0.f;
      if (gi < nq && k < kc) {
        const int64_t off = static_cast<int64_t>(gi) * d + k0 + k;
        v = q[off];
        m = qm[off];
      }
      const float vv = __fmul_rn(v, m);
      s_qv[k][row] = vv;
      s_qv2[k][row] = __fmul_rn(vv, vv);
      s_qm[k][row] = m;
    }
#pragma unroll
    for (int it = 0; it < kTileCols * kChunk / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int col = e / kChunk, k = e % kChunk;
      const int gj = col0 + col;
      float v = 0.f, m = 0.f;
      if (gj < nr && k < kc) {
        const int64_t off = static_cast<int64_t>(gj) * d + k0 + k;
        v = r[off];
        m = rm[off];
      }
      const float vv = __fmul_rn(v, m);
      s_rv[k][col] = vv;
      s_rv2[k][col] = __fmul_rn(vv, vv);
      s_rm[k][col] = m;
    }
    __syncthreads();

    for (int k = 0; k < kc; ++k) {
      float qv[kRowsPerThread], qv2[kRowsPerThread], qmk[kRowsPerThread];
      float rv[kColsPerThread], rv2[kColsPerThread], rmk[kColsPerThread];
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m) {
        const int row = ty + m * kThreadsY;
        qv[m] = s_qv[k][row];
        qv2[m] = s_qv2[k][row];
        qmk[m] = s_qm[k][row];
      }
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        const int col = tx + c * kThreadsX;
        rv[c] = s_rv[k][col];
        rv2[c] = s_rv2[k][col];
        rmk[c] = s_rm[k][col];
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
    const int gi = row0 + ty + m * kThreadsY;
    if (gi >= nq) continue;
    float* out_row = out + static_cast<int64_t>(gi) * nr;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int gj = col0 + tx + c * kThreadsX;
      if (gj >= nr) continue;
      const float n = acc_n[m][c];
      float v = INFINITY;
      if (n > 0.f) {
        const float sq = __fsub_rn(__fadd_rn(acc_q2[m][c], acc_r2[m][c]),
                                   __fmul_rn(2.f, acc_x[m][c]));
        const float scale = __fdiv_rn(d_total, fmaxf(n, 1.f));
        v = fmaxf(__fmul_rn(sq, scale), 0.f);
      }
      out_row[gj] = v;
    }
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
