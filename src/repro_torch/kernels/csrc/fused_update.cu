// Fused two-pass Adapprox update for Hopper (sm_90a), fp32 throughout.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fused_update.py:
//
//   * precond_kernel  <- fused_precond_pallas (_make_precond_kernel), pass 1:
//       V     = b2 * max(Q U^T, 0) + (1 - b2) G^2        (never stored)
//       u_hat = G / (sqrt(V) + eps)
//     plus per-block partials of sum(V^2), sum(u_hat^2) and, guided,
//     sum(m1 * u_hat), sum(m1^2); with FOLD also per-row-group partials of
//     the amortized-refresh fold (G^2)^T Q.
//   * apply_kernel    <- fused_apply_pallas / fused_apply_shared_pallas,
//     pass 2: u_c = u_hat / denom, acc = b1 m1 + (1 - b1) u_c,
//     m_out = acc * out_scale, m1 <- acc * store_scale (in place).
//
// What bounds them on an H100, and what the design does about it:
//
//   * Pass 1 at r = 128 is a small fp32 GEMM (Q U^T, 2 m n r flops) fused
//     with an elementwise pass over G; with the fold rider it is two such
//     GEMMs.  At GPT-2 117M shapes that is ~64 GFLOP against ~1.2 GB of
//     traffic, so it is bound by fp32 operations (no tensor cores: parity
//     with the fp32 reference comes first, so no TF32).  A block owns one
//     64-column strip of G and walks a group of 64-row tiles; Q and U are
//     staged through shared memory in 16-deep slices and each thread keeps
//     a 4x4 register tile of Q U^T.  G, m1 and u_hat are touched once.
//     The fold reuses the resident G tile: G^2 and a 64-column slice of Q
//     go to shared memory and the same 4x4 micro-kernel accumulates
//     (G^2)^T Q into a per-block (r, 64) shared accumulator that lives
//     across the block's row tiles, so the fold costs one partial per row
//     group instead of one per tile.  The row-group count is chosen by the
//     wrapper to fill the card; the groups are summed by the wrapper.
//   * Pass 2 is a streaming read-modify-write, bound by bytes: float4
//     grid-stride loop, one read of u_hat and m1, one or two writes.
//
// No float atomics anywhere: block sums use a fixed shuffle tree, so runs
// repeat bit for bit.  Kernels allocate nothing and run on the caller's
// stream; every entry point returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (no --use_fast_math: parity needs IEEE sqrt and
//        division).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // rows of G per tile
constexpr int BN = 64;         // columns of G per block
constexpr int KC = 16;         // depth of one Q U^T slice
constexpr int FK = 64;         // columns of Q per fold slice
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int LDS = BM + 4;    // padded leading dim of the smem tiles
constexpr int LDY = BN + 1;    // odd leading dim of the fold accumulator

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  return s;  // valid in thread 0 only
}

template <bool GUIDED, bool FOLD>
__global__ void __launch_bounds__(THREADS)
precond_kernel(const float* __restrict__ q, const float* __restrict__ u,
               const float* __restrict__ g, const float* __restrict__ m1,
               float* __restrict__ out, float* __restrict__ part,
               float* __restrict__ yfold, int m, int n, int r,
               int tiles_per_group, float b2, float omb2, float eps) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [KC][LDS]  Q slice, transposed
  float* Us = Qs + KC * LDS;           // [KC][LDS]  U slice, transposed
  float* G2 = Us + KC * LDS;           // [BM][LDS]  G^2 tile      (FOLD)
  float* Q2 = G2 + BM * LDS;           // [BM][LDS]  Q fold slice  (FOLD)
  float* Ys = Q2 + BM * LDS;           // [r][LDY]   fold accum    (FOLD)
  __shared__ float red[THREADS / 32];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int jt = blockIdx.x, grp = blockIdx.y, l = blockIdx.z;
  const int gn = gridDim.x, groups = gridDim.y;
  const int j0 = jt * BN;
  const size_t mn = (size_t)m * n;
  const float* qb = q + (size_t)l * m * r;
  const float* ub = u + (size_t)l * n * r;
  const float* gb = g + (size_t)l * mn;
  const float* mb = GUIDED ? m1 + (size_t)l * mn : nullptr;
  float* ob = out + (size_t)l * mn;
  const bool vec = (n & 3) == 0;

  if (FOLD)
    for (int i = tid; i < r * LDY; i += THREADS) Ys[i] = 0.f;

  float s_v = 0.f, s_u = 0.f, s_md = 0.f, s_ms = 0.f;
  const int tiles_m = (m + BM - 1) / BM;
  const int t_begin = grp * tiles_per_group;
  const int t_end = min(t_begin + tiles_per_group, tiles_m);

  for (int t = t_begin; t < t_end; ++t) {
    const int i0 = t * BM;
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

    // ---- low = Q_tile @ U_strip^T, 16-deep slices through smem
    for (int kc = 0; kc < r; kc += KC) {
      __syncthreads();
#pragma unroll
      for (int e = 0; e < (BM * KC) / THREADS; ++e) {
        const int idx = tid + e * THREADS, row = idx >> 4, k = idx & 15;
        const int gr = i0 + row, gc = j0 + row;
        Qs[k * LDS + row] = gr < m ? qb[(size_t)gr * r + kc + k] : 0.f;
        Us[k * LDS + row] = gc < n ? ub[(size_t)gc * r + kc + k] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const float4 a4 = *reinterpret_cast<const float4*>(&Qs[k * LDS + ty * 4]);
        const float4 b4 = *reinterpret_cast<const float4*>(&Us[k * LDS + tx * 4]);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
      }
    }

    // ---- elementwise epilogue on the resident tile
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = ty * 4 + a, gr = i0 + row;
      const int col0 = tx * 4, gc0 = j0 + col0;
      float gv[4] = {0.f, 0.f, 0.f, 0.f}, mv[4] = {0.f, 0.f, 0.f, 0.f};
      const bool rok = gr < m;
      const size_t off = (size_t)gr * n + gc0;
      if (rok && vec && gc0 + 3 < n) {
        const float4 g4 = *reinterpret_cast<const float4*>(gb + off);
        gv[0] = g4.x; gv[1] = g4.y; gv[2] = g4.z; gv[3] = g4.w;
        if (GUIDED) {
          const float4 m4 = *reinterpret_cast<const float4*>(mb + off);
          mv[0] = m4.x; mv[1] = m4.y; mv[2] = m4.z; mv[3] = m4.w;
        }
      } else if (rok) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (gc0 + b < n) {
            gv[b] = gb[off + b];
            if (GUIDED) mv[b] = mb[off + b];
          }
      }
      float ov[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const bool ok = rok && gc0 + b < n;
        const float v = b2 * fmaxf(acc[a][b], 0.f) + omb2 * gv[b] * gv[b];
        const float o = gv[b] / (sqrtf(v) + eps);
        ov[b] = o;
        if (ok) {
          s_v += v * v;
          s_u += o * o;
          if (GUIDED) {
            s_md += mv[b] * o;
            s_ms += mv[b] * mv[b];
          }
        }
        if (FOLD) G2[row * LDS + col0 + b] = ok ? gv[b] * gv[b] : 0.f;
      }
      if (rok && vec && gc0 + 3 < n) {
        *reinterpret_cast<float4*>(ob + off) = make_float4(ov[0], ov[1], ov[2], ov[3]);
      } else if (rok) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (gc0 + b < n) ob[off + b] = ov[b];
      }
    }

    // ---- fold rider: Ys[k][c] += sum_row G2[row][c] * Q[i0 + row][k]
    if (FOLD) {
      for (int kc = 0; kc < r; kc += FK) {
        __syncthreads();   // G2 written / previous Q2 slice consumed
#pragma unroll
        for (int e = 0; e < (BM * FK) / THREADS; ++e) {
          const int idx = tid + e * THREADS, row = idx >> 6, k = idx & 63;
          const int gr = i0 + row;
          Q2[row * LDS + k] =
              (gr < m && kc + k < r) ? qb[(size_t)gr * r + kc + k] : 0.f;
        }
        __syncthreads();
        float ya[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) ya[a][b] = 0.f;
        for (int row = 0; row < BM; ++row) {
          const float4 q4 = *reinterpret_cast<const float4*>(&Q2[row * LDS + ty * 4]);
          const float4 g4 = *reinterpret_cast<const float4*>(&G2[row * LDS + tx * 4]);
          const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
          const float g2v[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) ya[a][b] = fmaf(g2v[b], qv[a], ya[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int k = kc + ty * 4 + a;
          if (k < r)
#pragma unroll
            for (int b = 0; b < 4; ++b) Ys[k * LDY + tx * 4 + b] += ya[a][b];
        }
      }
      __syncthreads();     // G2 is rewritten by the next tile's epilogue
    }
  }

  // ---- per-block partials: part[l][grp][jt][0..3]
  float* pb = part + (((size_t)l * groups + grp) * gn + jt) * 4;
  const float sv = block_sum(s_v, red);
  if (tid == 0) pb[0] = sv;
  const float su = block_sum(s_u, red);
  if (tid == 0) pb[1] = su;
  if (GUIDED) {
    const float smd = block_sum(s_md, red);
    if (tid == 0) pb[2] = smd;
    const float sms = block_sum(s_ms, red);
    if (tid == 0) pb[3] = sms;
  } else if (tid == 0) {
    pb[2] = 0.f;
    pb[3] = 0.f;
  }

  // ---- fold partial: yfold[l][grp][j0 + c][k]
  if (FOLD) {
    __syncthreads();
    float* yb = yfold + ((size_t)l * groups + grp) * n * r;
    const int cols = min(BN, n - j0);
    for (int idx = tid; idx < cols * r; idx += THREADS) {
      const int c = idx / r, k = idx - c * r;
      yb[(size_t)(j0 + c) * r + k] = Ys[k * LDY + c];
    }
  }
}

template <bool SHARED>
__global__ void __launch_bounds__(THREADS)
apply_kernel(const float* __restrict__ u_hat, float* __restrict__ m1,
             float* __restrict__ out, const float* __restrict__ scalars,
             long long size) {
  const int l = blockIdx.y;
  const float* s = scalars + 5 * l;
  const float denom = s[0], b1 = s[1], omb1 = s[2], os = s[3], ss = s[4];
  const float* ub = u_hat + (size_t)l * size;
  float* mb = m1 + (size_t)l * size;
  float* obp = SHARED ? nullptr : out + (size_t)l * size;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  if ((size & 3) == 0) {
    const long long n4 = size >> 2;
    for (long long i = first; i < n4; i += stride) {
      const float4 u4 = reinterpret_cast<const float4*>(ub)[i];
      const float4 m4 = reinterpret_cast<const float4*>(mb)[i];
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
      const float a = b1 * mb[i] + omb1 * (ub[i] / denom);
      if (!SHARED) obp[i] = a * os;
      mb[i] = a * ss;
    }
  }
}

template <bool GUIDED, bool FOLD>
cudaError_t launch_precond(const float* q, const float* u, const float* g,
                           const float* m1, float* out, float* part,
                           float* yfold, int batch, int m, int n, int r,
                           int groups, int tiles_per_group, float b2,
                           float omb2, float eps, cudaStream_t stream) {
  const size_t base = (size_t)2 * KC * LDS * sizeof(float);
  const size_t smem =
      FOLD ? base + (size_t)(2 * BM * LDS + r * LDY) * sizeof(float) : base;
  if (FOLD) {
    cudaError_t err = cudaFuncSetAttribute(
        precond_kernel<GUIDED, FOLD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + BN - 1) / BN, groups, batch);
  precond_kernel<GUIDED, FOLD><<<grid, THREADS, smem, stream>>>(
      q, u, g, m1, out, part, yfold, m, n, r, tiles_per_group, b2, omb2, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (batch, m, r), u (batch, n, r), g (batch, m, n), m1 (batch, m, n) or
// NULL, all fp32 and contiguous, r a multiple of 16.  Writes out (batch, m,
// n), part (batch, groups, ceil(n/64), 4) and, with fold != 0, yfold
// (batch, groups, n, r).  Row tiles [grp * tiles_per_group, ...) of 64 rows
// belong to row group grp.
int fused_precond_f32(const float* q, const float* u, const float* g,
                      const float* m1, float* out, float* part, float* yfold,
                      int batch, int m, int n, int r, int groups,
                      int tiles_per_group, float b2, float omb2, float eps,
                      int fold, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r % KC != 0) return (int)cudaErrorInvalidValue;
  if (m1 != nullptr)
    return fold ? launch_precond<true, true>(q, u, g, m1, out, part, yfold,
                                             batch, m, n, r, groups,
                                             tiles_per_group, b2, omb2, eps, s)
                : launch_precond<true, false>(q, u, g, m1, out, part, yfold,
                                              batch, m, n, r, groups,
                                              tiles_per_group, b2, omb2, eps, s);
  return fold ? launch_precond<false, true>(q, u, g, m1, out, part, yfold,
                                            batch, m, n, r, groups,
                                            tiles_per_group, b2, omb2, eps, s)
              : launch_precond<false, false>(q, u, g, m1, out, part, yfold,
                                             batch, m, n, r, groups,
                                             tiles_per_group, b2, omb2, eps, s);
}

// u_hat, m1 (batch, size) fp32 contiguous; scalars (batch, 5) fp32 =
// [denom, b1, 1 - b1, out_scale, store_scale].  m1 is updated in place to
// acc * store_scale; out (batch, size) receives acc * out_scale unless
// out is NULL (shared variant: the caller reads m1 as the step direction).
int fused_apply_f32(const float* u_hat, float* m1, float* out,
                    const float* scalars, int batch, long long size,
                    int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks, batch);
  if (out == nullptr)
    apply_kernel<true><<<grid, THREADS, 0, s>>>(u_hat, m1, out, scalars, size);
  else
    apply_kernel<false><<<grid, THREADS, 0, s>>>(u_hat, m1, out, scalars, size);
  return (int)cudaGetLastError();
}

}  // extern "C"
