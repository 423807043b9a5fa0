// Fused two-pass Adapprox update for Hopper (sm_90a): fp32 in and out,
// pass 1's products on the tensor cores in 3xTF32.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fused_update.py:
//
//   * precond_kernel  <- fused_precond_pallas (_make_precond_kernel), pass 1:
//       V     = b2 * max(Q U^T, 0) + (1 - b2) G^2        (never stored)
//       u_hat = G / (sqrt(V) + eps)
//     plus per-block partials of sum(V^2), sum(u_hat^2) and, guided,
//     sum(m1 * u_hat), sum(m1^2); with FOLD also per-row-group partials of
//     the amortized-refresh fold (G^2)^T Q.  QUANT is the int8 variant
//     (_make_precond_kernel(quantized=True), its tile dequant _deq_tile):
//     Q and U arrive as the codec of core/quantized.py and are dequantized
//     as they are staged (pass1.cuh).
//   * apply_kernel    <- fused_apply_pallas / fused_apply_shared_pallas,
//     pass 2: u_c = u_hat / denom, acc = b1 m1 + (1 - b1) u_c,
//     m_out = acc * out_scale, m1_new = acc * store_scale, written over
//     m1 in place, or into a fresh buffer when the caller must keep the
//     pre-step m1 (the skip-step guard): the same bytes either way.
//
// What bounds them on an H100, and what the design does about it:
//
//   * Pass 1 at r = 128 is two small GEMMs (Q U^T, and with the fold
//     rider (G^2)^T Q, 2 m n r operations each) fused with an elementwise
//     pass over G: ~1,540 operations a G entry in the three tf32 products
//     per product that hold the fp32 tolerance, against 8 bytes (G read,
//     u_hat written).  That is about the tensor cores' ratio of TF32 rate
//     to memory rate (495 TFLOP/s / 3.35 TB/s = 148 operations a byte, so
//     ~1,180 for 8 bytes): the operations bound it, the bytes nearly.
//     The tile loop (pass1.cuh) runs both products on wgmma in 3xTF32,
//     stages Q, U and G^2 through registers while the previous slice's
//     products run, keeps G and u_hat in registers in the accumulator's
//     layout (each touched once), and reads Q U^T out of the fragments.
//     The fold costs one partial per row group instead of one per tile;
//     the row-group count is chosen by the wrapper to fill whole waves of
//     one block an SM, and the groups are summed by the wrapper.  What
//     holds it now (PERF.md section 6): about 4x its bound, because a
//     tile's phases (staging, products, epilogue, fold) run one after
//     another in the one block an SM; a producer warp and a deeper ring
//     are next.  The int8 factors cut the factor reads 4x; the dequant
//     adds two operations per staged factor value, small beside the
//     products.
//   * Pass 2 is a streaming read-modify-write, bound by bytes: float4
//     grid-stride loop, one read of u_hat and m1, one or two writes.
//
// No float atomics anywhere: block sums use a fixed shuffle tree, so runs
// repeat bit for bit.  Kernels allocate nothing and run on the caller's
// stream; every entry point returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (no --use_fast_math: pass 2 needs IEEE
//        division; pass 1's approximate root and reciprocal are explicit;
//        wgmma needs the "a" target).

#include <cuda_runtime.h>
#include <stdint.h>

#include "pass1.cuh"

namespace {

using pass1::BM;
using pass1::BN;
using pass1::Factor;
using pass1::THREADS;
constexpr int APPLY_THREADS = 256;

template <bool GUIDED, bool FOLD, bool QUANT>
__global__ void __launch_bounds__(THREADS, 1)
precond_kernel(Factor q, Factor u, const float* __restrict__ g,
               const float* __restrict__ m1, float* __restrict__ out,
               float* __restrict__ part, float* __restrict__ yfold, int m,
               int n, int r, int tiles_per_group, float b2, float omb2,
               float eps) {
  __shared__ float red[THREADS / 32];
  float* sm = reinterpret_cast<float*>(smem_tiles());
  const int tid = threadIdx.x;
  const int jt = blockIdx.x, grp = blockIdx.y, l = blockIdx.z;
  const int gn = gridDim.x, groups = gridDim.y;
  const size_t mn = (size_t)m * n;
  const int tiles_m = (m + BM - 1) / BM;
  const int t_begin = grp * tiles_per_group;
  const int t_end = min(t_begin + tiles_per_group, tiles_m);
  const pass1::Partials p = pass1::tile_loop<GUIDED, FOLD, QUANT>(
      pass1::batch_slice(q, l, m, r), pass1::batch_slice(u, l, n, r),
      g + (size_t)l * mn, GUIDED ? m1 + (size_t)l * mn : nullptr,
      out + (size_t)l * mn,
      FOLD ? yfold + ((size_t)l * groups + grp) * n * r : nullptr, sm, m, n,
      r, jt * BN, t_begin, t_end, b2, omb2, eps);

  // ---- per-block partials: part[l][grp][jt][0..3]
  float* pb = part + (((size_t)l * groups + grp) * gn + jt) * 4;
  const float sv = pass1::block_sum(p.v, red);
  if (tid == 0) pb[0] = sv;
  const float su = pass1::block_sum(p.u, red);
  if (tid == 0) pb[1] = su;
  if (GUIDED) {
    const float smd = pass1::block_sum(p.md, red);
    if (tid == 0) pb[2] = smd;
    const float sms = pass1::block_sum(p.ms, red);
    if (tid == 0) pb[3] = sms;
  } else if (tid == 0) {
    pb[2] = 0.f;
    pb[3] = 0.f;
  }
}

template <bool SHARED>
__global__ void __launch_bounds__(APPLY_THREADS)
apply_kernel(const float* __restrict__ u_hat, const float* m1_in,
             float* m1, float* __restrict__ out,
             const float* __restrict__ scalars, long long size) {
  // m1_in and m1 are the same buffer (in place) or two (fresh output):
  // each element is read, then written, by one thread, so no restrict.
  const int l = blockIdx.y;
  const float* s = scalars + 5 * l;
  const float denom = s[0], b1 = s[1], omb1 = s[2], os = s[3], ss = s[4];
  const float* ub = u_hat + (size_t)l * size;
  const float* mi = m1_in + (size_t)l * size;
  float* mb = m1 + (size_t)l * size;
  float* obp = SHARED ? nullptr : out + (size_t)l * size;
  const long long stride = (long long)gridDim.x * APPLY_THREADS;
  const long long first =
      (long long)blockIdx.x * APPLY_THREADS + threadIdx.x;
  if ((size & 3) == 0) {
    const long long n4 = size >> 2;
    for (long long i = first; i < n4; i += stride) {
      const float4 u4 = reinterpret_cast<const float4*>(ub)[i];
      const float4 m4 = reinterpret_cast<const float4*>(mi)[i];
      float4 a;
      a.x = b1 * m4.x + omb1 * (u4.x / denom);
      a.y = b1 * m4.y + omb1 * (u4.y / denom);
      a.z = b1 * m4.z + omb1 * (u4.z / denom);
      a.w = b1 * m4.w + omb1 * (u4.w / denom);
      if (!SHARED)
        reinterpret_cast<float4*>(obp)[i] =
            make_float4(a.x * os, a.y * os, a.z * os, a.w * os);
      reinterpret_cast<float4*>(mb)[i] =
          make_float4(a.x * ss, a.y * ss, a.z * ss, a.w * ss);
    }
  } else {
    for (long long i = first; i < size; i += stride) {
      const float a = b1 * mi[i] + omb1 * (ub[i] / denom);
      if (!SHARED) obp[i] = a * os;
      mb[i] = a * ss;
    }
  }
}

template <bool GUIDED, bool FOLD, bool QUANT>
cudaError_t launch_precond(const Factor& q, const Factor& u, const float* g,
                           const float* m1, float* out, float* part,
                           float* yfold, int batch, int m, int n, int r,
                           int groups, int tiles_per_group, float b2,
                           float omb2, float eps, cudaStream_t stream) {
  const size_t smem = pass1::smem_bytes(FOLD);
  cudaError_t err = cudaFuncSetAttribute(
      precond_kernel<GUIDED, FOLD, QUANT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BN - 1) / BN, groups, batch);
  precond_kernel<GUIDED, FOLD, QUANT><<<grid, THREADS, smem, stream>>>(
      q, u, g, m1, out, part, yfold, m, n, r, tiles_per_group, b2, omb2, eps);
  return cudaGetLastError();
}

template <bool QUANT>
int precond(const Factor& q, const Factor& u, const float* g,
            const float* m1, float* out, float* part, float* yfold,
            int batch, int m, int n, int r, int groups, int tiles_per_group,
            float b2, float omb2, float eps, int fold, cudaStream_t s) {
  if (r % 16 != 0 || (fold && r > pass1::R_MAX))
    return (int)cudaErrorInvalidValue;
  if (m1 != nullptr)
    return fold ? launch_precond<true, true, QUANT>(
                      q, u, g, m1, out, part, yfold, batch, m, n, r, groups,
                      tiles_per_group, b2, omb2, eps, s)
                : launch_precond<true, false, QUANT>(
                      q, u, g, m1, out, part, yfold, batch, m, n, r, groups,
                      tiles_per_group, b2, omb2, eps, s);
  return fold ? launch_precond<false, true, QUANT>(
                    q, u, g, m1, out, part, yfold, batch, m, n, r, groups,
                    tiles_per_group, b2, omb2, eps, s)
              : launch_precond<false, false, QUANT>(
                    q, u, g, m1, out, part, yfold, batch, m, n, r, groups,
                    tiles_per_group, b2, omb2, eps, s);
}

}  // namespace

extern "C" {

// q (batch, m, r), u (batch, n, r), g (batch, m, n), m1 (batch, m, n) or
// NULL, all fp32 and contiguous, r a multiple of 16 (with fold != 0 at
// most 128).  Writes out (batch, m, n), part (batch, groups, ceil(n/128),
// 4) and, with fold != 0, yfold (batch, groups, n, r).  Row tiles [grp *
// tiles_per_group, ...) of 64 rows belong to row group grp.
int fused_precond_f32(const float* q, const float* u, const float* g,
                      const float* m1, float* out, float* part, float* yfold,
                      int batch, int m, int n, int r, int groups,
                      int tiles_per_group, float b2, float omb2, float eps,
                      int fold, void* stream) {
  const Factor qf = {q, nullptr, nullptr, nullptr};
  const Factor uf = {u, nullptr, nullptr, nullptr};
  return precond<false>(qf, uf, g, m1, out, part, yfold, batch, m, n, r,
                        groups, tiles_per_group, b2, omb2, eps, fold,
                        static_cast<cudaStream_t>(stream));
}

// The int8 variant: q8 (batch, m, r) and u8 (batch, n, r) int8, their
// scale / zero (batch, ceil(rows / 256), r) fp32, as core/quantized.py
// lays them out; everything else as fused_precond_f32.
int fused_precond_int8(const int8_t* q8, const float* q_scale,
                       const float* q_zero, const int8_t* u8,
                       const float* u_scale, const float* u_zero,
                       const float* g, const float* m1, float* out,
                       float* part, float* yfold, int batch, int m, int n,
                       int r, int groups, int tiles_per_group, float b2,
                       float omb2, float eps, int fold, void* stream) {
  const Factor qf = {nullptr, q8, q_scale, q_zero};
  const Factor uf = {nullptr, u8, u_scale, u_zero};
  return precond<true>(qf, uf, g, m1, out, part, yfold, batch, m, n, r,
                       groups, tiles_per_group, b2, omb2, eps, fold,
                       static_cast<cudaStream_t>(stream));
}
// u_hat, m1_in, m1 (batch, size) fp32 contiguous; scalars (batch, 5) fp32
// = [denom, b1, 1 - b1, out_scale, store_scale].  m1 receives
// acc * store_scale from m1_in (m1 == m1_in: in place); out (batch, size)
// receives acc * out_scale unless out is NULL (shared variant: the caller
// reads m1 as the step direction).
int fused_apply_f32(const float* u_hat, const float* m1_in, float* m1,
                    float* out, const float* scalars, int batch,
                    long long size, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks, batch);
  if (out == nullptr)
    apply_kernel<true><<<grid, APPLY_THREADS, 0, s>>>(u_hat, m1_in, m1, out,
                                                      scalars, size);
  else
    apply_kernel<false><<<grid, APPLY_THREADS, 0, s>>>(u_hat, m1_in, m1,
                                                       out, scalars, size);
  return (int)cudaGetLastError();
}

}  // extern "C"
