// The single-pass Adapprox update for Hopper (sm_90a): fp32 in and out,
// Q U^T on the tensor cores in 3xTF32.
//
// Replaces the Pallas TPU kernel lowrank_update_pallas
// (src/repro/kernels/lowrank_update.py), the update of Adapprox's
// use_kernels path without fused_update:
//     V    = b2 * max(Q U^T, 0) + (1 - b2) G^2        (never stored)
//     out  = G / (sqrt(V) + eps)
// plus per-block partials of sum(V^2), summed by the wrapper.
//
// It is pass 1 of fused_update.cu without the guidance and fold riders and
// with only the sum(V^2) partial: the same tile loop (pass1.cuh), a
// kernel of its own.  What bounds it on an H100: Q U^T at r = 128 in the
// three tf32 products that hold the fp32 tolerance is 6 m n r operations
// (768 a G entry, 1.55 us a million entries at 495 TFLOP/s) against 8 m n
// bytes of G and out (2.39 us a million entries at 3.35 TB/s), so the
// bytes bound it.  The tile loop runs the products on wgmma with the next
// slice's loads in flight, holds G in registers from the tile's start and
// writes out straight from the accumulator fragments: G and out are
// touched once.  It reads about 3x its bound (PERF.md section 6): staging,
// products and epilogue run in turn, one block an SM.  No float atomics:
// runs repeat bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (no --use_fast_math).

#include <cuda_runtime.h>
#include <stdint.h>

#include "pass1.cuh"

namespace {

using pass1::BM;
using pass1::BN;
using pass1::Factor;
using pass1::THREADS;

__global__ void __launch_bounds__(THREADS, 1)
lowrank_update_kernel(const float* __restrict__ q,
                      const float* __restrict__ u,
                      const float* __restrict__ g, float* __restrict__ out,
                      float* __restrict__ part, int m, int n, int r,
                      int tiles_per_group, float b2, float omb2, float eps) {
  __shared__ float red[THREADS / 32];
  float* sm = reinterpret_cast<float*>(smem_tiles());
  const int jt = blockIdx.x, grp = blockIdx.y, l = blockIdx.z;
  const size_t mn = (size_t)m * n;
  const Factor qf = {q + (size_t)l * m * r, nullptr, nullptr, nullptr};
  const Factor uf = {u + (size_t)l * n * r, nullptr, nullptr, nullptr};
  const int tiles_m = (m + BM - 1) / BM;
  const int t_begin = grp * tiles_per_group;
  const int t_end = min(t_begin + tiles_per_group, tiles_m);
  const pass1::Partials p = pass1::tile_loop<false, false, false>(
      qf, uf, g + (size_t)l * mn, nullptr, out + (size_t)l * mn, nullptr, sm,
      m, n, r, jt * BN, t_begin, t_end, b2, omb2, eps);
  const float sv = pass1::block_sum(p.v, red);
  if (threadIdx.x == 0)
    part[((size_t)l * gridDim.y + grp) * gridDim.x + jt] = sv;
}

}  // namespace

extern "C" {

// q (batch, m, r), u (batch, n, r), g (batch, m, n), fp32 and contiguous,
// r a multiple of 16.  Writes out (batch, m, n) and part (batch, groups,
// ceil(n/128)) = per-block sum(V^2).  Row tiles [grp * tiles_per_group,
// ...) of 64 rows belong to row group grp.
int lowrank_update_f32(const float* q, const float* u, const float* g,
                       float* out, float* part, int batch, int m, int n,
                       int r, int groups, int tiles_per_group, float b2,
                       float omb2, float eps, void* stream) {
  if (r % 16 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = pass1::smem_bytes(false);
  if (int err = (int)cudaFuncSetAttribute(
          lowrank_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem))
    return err;
  const dim3 grid((n + BN - 1) / BN, groups, batch);
  lowrank_update_kernel<<<grid, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      q, u, g, out, part, m, n, r, tiles_per_group, b2, omb2, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
