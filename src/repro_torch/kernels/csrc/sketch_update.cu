// Count-min sketch second moment for Hopper (sm_90a), fp32 throughout.
//
// Replaces the Pallas TPU kernel sketch_update_pallas of
// src/repro/kernels/sketch_update.py, which computes in one grid
//
//   S_t[j, b, :] = b2 * S[j, b, :] + (1 - b2) * sum_{i : idx[j, i] = b} G[i, :]^2
//   vhat[i, :]   = min_j S_t[j, idx[j, i], :]
//
// with one-hot MXU matmuls and a two-phase grid that relies on the TPU
// running grid steps in order (scatter for every row block, then query).
// CUDA blocks run in no order, so here the two phases are two launches on
// the caller's stream:
//
//   * sketch_scatter_kernel: one block per (bucket b, depth j); its
//     threads walk the columns, and each sums G[i, c]^2 over the rows of
//     bucket b in ascending row order (the bucket-sorted row order and
//     the bucket offsets are built once per leaf by the wrapper's caller),
//     then writes b2 * S + (1 - b2) * sum.  An empty bucket still decays.
//     Every sum has one owner, so there are no float atomics and two
//     launches on the same input give the same bits.  The products and
//     sums use the _rn intrinsics (no fma contraction), the same rounding
//     as the plain version's index_add_ on the CPU.
//   * sketch_query_kernel: one block per row i; each thread takes the min
//     over depth of S_t[j, idx[j, i], c] for its columns (NaN propagates,
//     as torch.min does).
//
// Loads of a G row and of a table row are contiguous across a warp.  Rows,
// widths and a d that is no multiple of any vector width are handled by
// the loops' bounds; G is never copied or padded.
//
// What bounds it: bytes.  The work is a few flops per element moved.  For
// GPT-2 117M's embed (50257 x 768, depth 4, width 2048) the function must
// read G and write vhat (2 * 50257 * 768 * 4 B = 308.8 MB), read and write
// the table (2 * 4 * 2048 * 768 * 4 B = 50.3 MB) and read the indices
// (0.8 MB): 359.9 MB, 0.107 ms at 3.35 TB/s.  pos_embed (1024 x 768) adds
// 56.6 MB, mostly the table, 0.017 ms.  This simple design reads each G
// row once per depth in the scatter (4x the bound's G traffic) and is the
// first thing a faster version would change.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void sketch_scatter_kernel(const float* __restrict__ table,
                                      const float* __restrict__ g,
                                      const int* __restrict__ order,
                                      const int* __restrict__ offsets,
                                      float* __restrict__ out, int rows,
                                      int width, int d, float b2,
                                      float omb2) {
  const int b = blockIdx.x, j = blockIdx.y;
  const int* ord = order + (size_t)j * rows;
  const int* off = offsets + (size_t)j * (width + 1);
  const int start = off[b], stop = off[b + 1];
  const size_t tab = ((size_t)j * width + b) * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float sum = 0.f;
#pragma unroll 4
    for (int k = start; k < stop; ++k) {
      const float x = g[(size_t)ord[k] * d + c];
      sum = __fadd_rn(sum, __fmul_rn(x, x));
    }
    out[tab + c] = __fadd_rn(__fmul_rn(b2, table[tab + c]),
                             __fmul_rn(omb2, sum));
  }
}

__global__ void sketch_query_kernel(const float* __restrict__ table,
                                    const int* __restrict__ idx,
                                    float* __restrict__ vhat, int rows,
                                    int width, int depth, int d) {
  const int i = blockIdx.x;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < depth; ++j) {
      const int b = idx[(size_t)j * rows + i];
      const float v = table[((size_t)j * width + b) * d + c];
      acc = (j == 0 || v < acc || v != v) ? v : acc;
    }
    vhat[(size_t)i * d + c] = acc;
  }
}

}  // namespace

extern "C" {

// table, out (depth, width, d) fp32; g (rows, d) fp32; order (depth, rows)
// int32, the rows of each depth sorted by bucket, ascending within a
// bucket; offsets (depth, width + 1) int32, bucket b of depth j holding
// order[j, offsets[j, b] : offsets[j, b + 1]].  All contiguous, every size
// at least 1.
int sketch_scatter_f32(const float* table, const float* g, const int* order,
                       const int* offsets, float* out, int rows, int width,
                       int depth, int d, float b2, float omb2, int threads,
                       void* stream) {
  if (rows < 1 || width < 1 || depth < 1 || d < 1 || depth > 65535)
    return (int)cudaErrorInvalidValue;
  sketch_scatter_kernel<<<dim3(width, depth), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      table, g, order, offsets, out, rows, width, d, b2, omb2);
  return (int)cudaGetLastError();
}

// table (depth, width, d) fp32 (the updated sketch); idx (depth, rows)
// int32 buckets in [0, width); vhat (rows, d) fp32.
int sketch_query_f32(const float* table, const int* idx, float* vhat,
                     int rows, int width, int depth, int d, int threads,
                     void* stream) {
  if (rows < 1 || width < 1 || depth < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  sketch_query_kernel<<<rows, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      table, idx, vhat, rows, width, depth, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
