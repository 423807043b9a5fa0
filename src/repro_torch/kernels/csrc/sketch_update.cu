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
// the caller's stream.
//
// What bounds it: bytes.  The work is a few flops per element moved.  The
// function must read G once, read and write the table once, write vhat
// once and read the indices.  For GPT-2 117M's embed (50257 x 768, depth
// 4, width 2048) that is 359.9 MB, 0.107 ms at 3.35 TB/s; G and vhat are
// most of it.  For Mamba2-370m's untied lm_head (1024 x 50280) the (4,
// 2048, 50280) table, 1.65 GB read and written, is most of its 3.7 GB.
//
// Design.  Both kernels cut d into 64-column slices, one 16-byte load of
// four columns per lane and 16 lanes a task (256 contiguous bytes of a row
// of G, of the table or of vhat), and order their grids by column slice:
// the block index runs over buckets (or rows) fastest, then depth, then the
// slice.  So the four depth passes over a slice of G run together and read
// it from the 50 MB L2 after the first (one slice of embed's G is 12.9 MB),
// instead of reading all of G once per depth from memory.
//
//   * sketch_scatter_kernel: one task per (slice, depth j, bucket b) sums
//     G[i, c]^2 over the rows of bucket b in ascending row order (the
//     bucket-sorted row order and the bucket offsets are built once per
//     leaf by the wrapper's caller), four rows' loads in flight at a time,
//     then writes b2 * S + (1 - b2) * sum.  An empty bucket still decays.
//     Every sum has one owner, so there are no float atomics and two
//     launches on the same input give the same bits.  The products and
//     sums use the _rn intrinsics (no fma contraction), the same rounding
//     as the plain version's index_add_ on the CPU.
//   * sketch_query_kernel: one task per (slice, row i) takes the min over
//     depth of S_t[j, idx[j, i], c] (NaN propagates, as torch.min does).
//     For the embeddings the new table (25-33 MB) is still in L2 from the
//     scatter; for lm_head the gathers, 4 x 1024 rows, come from memory.
//
// Measured (PERF.md section 6): 1.8x the bound at GPT-2's embeddings, 1.6x
// at Mamba2's, where lm_head's query gathers are the excess.
//
// With d % 4 == 0 every lane's four columns are in or out together and
// load as one float4; otherwise (rows not 16-byte aligned) each column
// loads alone, masked.  G is never copied or padded.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 16;               // lanes a task
constexpr int SW = 4 * LANES;           // columns a slice
constexpr int THREADS = 256;
constexpr int TASKS = THREADS / LANES;  // tasks a block

__device__ __forceinline__ float4 load4(const float* __restrict__ p,
                                        size_t o, int c, int d, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p + o);
  float4 x = make_float4(p[o], 0.f, 0.f, 0.f);
  if (c + 1 < d) x.y = p[o + 1];
  if (c + 2 < d) x.z = p[o + 2];
  if (c + 3 < d) x.w = p[o + 3];
  return x;
}

__device__ __forceinline__ void store4(float* __restrict__ p, size_t o,
                                       float4 x, int c, int d, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p + o) = x;
    return;
  }
  p[o] = x.x;
  if (c + 1 < d) p[o + 1] = x.y;
  if (c + 2 < d) p[o + 2] = x.z;
  if (c + 3 < d) p[o + 3] = x.w;
}

__device__ __forceinline__ void add_sq(float4& s, float4 x) {
  s.x = __fadd_rn(s.x, __fmul_rn(x.x, x.x));
  s.y = __fadd_rn(s.y, __fmul_rn(x.y, x.y));
  s.z = __fadd_rn(s.z, __fmul_rn(x.z, x.z));
  s.w = __fadd_rn(s.w, __fmul_rn(x.w, x.w));
}

__device__ __forceinline__ float ema(float b2, float t, float omb2, float s) {
  return __fadd_rn(__fmul_rn(b2, t), __fmul_rn(omb2, s));
}

// the running min over depth; NaN propagates
__device__ __forceinline__ float min_nan(float acc, float v) {
  return (v < acc || v != v) ? v : acc;
}

__global__ void __launch_bounds__(THREADS)
sketch_scatter_kernel(const float* __restrict__ table,
                      const float* __restrict__ g,
                      const int* __restrict__ order,
                      const int* __restrict__ offsets,
                      float* __restrict__ out, int rows, int width, int depth,
                      int d, float b2, float omb2) {
  const int nbb = (width + TASKS - 1) / TASKS;
  const int bx = blockIdx.x;
  const int j = bx / nbb % depth, sl = bx / (nbb * depth);
  const int b = bx % nbb * TASKS + threadIdx.x / LANES;
  const int c = sl * SW + 4 * (threadIdx.x % LANES);
  if (b >= width || c >= d) return;
  const bool vec = (d & 3) == 0;
  const int* ord = order + (size_t)j * rows;
  const int* off = offsets + (size_t)j * (width + 1);
  const int start = off[b], stop = off[b + 1];
  const size_t tab = ((size_t)j * width + b) * d + c;
  const float4 t = load4(table, tab, c, d, vec);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  int k = start;
  for (; k + 4 <= stop; k += 4) {
    const int i0 = ord[k], i1 = ord[k + 1], i2 = ord[k + 2], i3 = ord[k + 3];
    const float4 x0 = load4(g, (size_t)i0 * d + c, c, d, vec);
    const float4 x1 = load4(g, (size_t)i1 * d + c, c, d, vec);
    const float4 x2 = load4(g, (size_t)i2 * d + c, c, d, vec);
    const float4 x3 = load4(g, (size_t)i3 * d + c, c, d, vec);
    add_sq(s, x0);
    add_sq(s, x1);
    add_sq(s, x2);
    add_sq(s, x3);
  }
  for (; k < stop; ++k) add_sq(s, load4(g, (size_t)ord[k] * d + c, c, d, vec));
  store4(out, tab,
         make_float4(ema(b2, t.x, omb2, s.x), ema(b2, t.y, omb2, s.y),
                     ema(b2, t.z, omb2, s.z), ema(b2, t.w, omb2, s.w)),
         c, d, vec);
}

__global__ void __launch_bounds__(THREADS)
sketch_query_kernel(const float* __restrict__ table,
                    const int* __restrict__ idx, float* __restrict__ vhat,
                    int rows, int width, int depth, int d) {
  const int nrb = (rows + TASKS - 1) / TASKS;
  const int bx = blockIdx.x;
  const int sl = bx / nrb;
  const int i = bx % nrb * TASKS + threadIdx.x / LANES;
  const int c = sl * SW + 4 * (threadIdx.x % LANES);
  if (i >= rows || c >= d) return;
  const bool vec = (d & 3) == 0;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < depth; ++j) {
    const int b = idx[(size_t)j * rows + i];
    const float4 v = load4(table, ((size_t)j * width + b) * d + c, c, d, vec);
    if (j == 0) {
      acc = v;
    } else {
      acc.x = min_nan(acc.x, v.x);
      acc.y = min_nan(acc.y, v.y);
      acc.z = min_nan(acc.z, v.z);
      acc.w = min_nan(acc.w, v.w);
    }
  }
  store4(vhat, (size_t)i * d + c, acc, c, d, vec);
}

}  // namespace

extern "C" {

// table, out (depth, width, d) fp32; g (rows, d) fp32; order (depth, rows)
// int32, the rows of each depth sorted by bucket, ascending within a
// bucket; offsets (depth, width + 1) int32, bucket b of depth j holding
// order[j, offsets[j, b] : offsets[j, b + 1]].  All contiguous, every size
// at least 1; slices = ceil(d / 64), the column slices of the grid.
int sketch_scatter_f32(const float* table, const float* g, const int* order,
                       const int* offsets, float* out, int rows, int width,
                       int depth, int d, float b2, float omb2, int slices,
                       void* stream) {
  if (rows < 1 || width < 1 || depth < 1 || d < 1 ||
      slices != (d + SW - 1) / SW)
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)((width + TASKS - 1) / TASKS) * depth * slices;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sketch_scatter_kernel<<<(unsigned)blocks, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      table, g, order, offsets, out, rows, width, depth, d, b2, omb2);
  return (int)cudaGetLastError();
}

// table (depth, width, d) fp32 (the updated sketch); idx (depth, rows)
// int32 buckets in [0, width); vhat (rows, d) fp32; slices as above.
int sketch_query_f32(const float* table, const int* idx, float* vhat,
                     int rows, int width, int depth, int d, int slices,
                     void* stream) {
  if (rows < 1 || width < 1 || depth < 1 || d < 1 ||
      slices != (d + SW - 1) / SW)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)((rows + TASKS - 1) / TASKS) * slices;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sketch_query_kernel<<<(unsigned)blocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      table, idx, vhat, rows, width, depth, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
