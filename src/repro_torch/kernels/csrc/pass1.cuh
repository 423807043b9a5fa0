// The pass-1 tile loop shared by precond_kernel (fused_update.cu) and
// lowrank_update_kernel (lowrank_update.cu), for Hopper (sm_90a), fp32.
//
// Per 64 x 64 tile of G it rebuilds
//     V     = b2 * max(Q U^T, 0) + (1 - b2) G^2        (never stored)
//     u_hat = G / (sqrt(V) + eps)
// writes u_hat once, and accumulates each thread's share of sum(V^2),
// sum(u_hat^2) and, GUIDED, sum(m1 * u_hat), sum(m1^2); with FOLD it also
// adds (G^2)^T Q over the tile into a per-block shared accumulator.  A
// caller reduces what it needs: unused partials are dead code.
//
// A block owns one 64-column strip of G and walks a group of 64-row tiles;
// Q and U are staged through shared memory in 16-deep slices and each
// thread keeps a 4x4 register tile of Q U^T.  G, m1 and u_hat are touched
// once.  The fold reuses the resident G tile: G^2 and a 64-column slice of
// Q go to shared memory and the same 4x4 micro-kernel accumulates
// (G^2)^T Q into an (r, 64) accumulator that lives across the block's row
// tiles.
//
// QUANT: the factors arrive as the int8 codec of core/quantized.py (q8,
// and per 256-row block and column an fp32 scale and zero).  Each factor
// value is dequantized as it is staged, deq = (q8 + 127) * scale + zero
// with __fmul_rn / __fadd_rn (no fma contraction), which is
// core/quantized.dequantize bit for bit; a row finds its cell at
// row / QBLOCK, so the 64-row tile need not equal the codec's block.  The
// fp32 factors are never formed in memory.  Rows past m / n read as 0 on
// both paths.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pass1 {

constexpr int BM = 64;         // rows of G per tile
constexpr int BN = 64;         // columns of G per block
constexpr int KC = 16;         // depth of one Q U^T slice
constexpr int FK = 64;         // columns of Q per fold slice
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int LDS = BM + 4;    // padded leading dim of the smem tiles
constexpr int LDY = BN + 1;    // odd leading dim of the fold accumulator
constexpr int QBLOCK = 256;    // rows per (scale, zero) cell of the codec

// One factor, (rows, r) fp32 or its int8 codec.
struct Factor {
  const float* f;
  const int8_t* q8;
  const float* scale;   // (ceil(rows / QBLOCK), r)
  const float* zero;
};

// The factor of matrix l of a batch of (rows, r) factors.
__device__ __forceinline__ Factor batch_slice(const Factor& F, int l,
                                              int rows, int r) {
  const size_t cells = (size_t)((rows + QBLOCK - 1) / QBLOCK) * r;
  Factor s;
  s.f = F.f ? F.f + (size_t)l * rows * r : nullptr;
  s.q8 = F.q8 ? F.q8 + (size_t)l * rows * r : nullptr;
  s.scale = F.scale ? F.scale + (size_t)l * cells : nullptr;
  s.zero = F.zero ? F.zero + (size_t)l * cells : nullptr;
  return s;
}

template <bool QUANT>
__device__ __forceinline__ float factor_at(const Factor& F, int row, int k,
                                           int r) {
  if (QUANT) {
    const size_t cell = (size_t)(row / QBLOCK) * r + k;
    const float q = (float)F.q8[(size_t)row * r + k] + 127.f;
    return __fadd_rn(__fmul_rn(q, F.scale[cell]), F.zero[cell]);
  }
  return F.f[(size_t)row * r + k];
}

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

struct Partials {
  float v, u, md, ms;   // sum V^2, sum u_hat^2, sum m1 u_hat, sum m1^2
};

// Dynamic shared memory the loop needs, in floats.
__host__ __device__ constexpr size_t smem_floats(bool fold, int r) {
  return (size_t)2 * KC * LDS +
         (fold ? (size_t)2 * BM * LDS + (size_t)r * LDY : 0);
}

// The fold accumulator Ys (r, LDY) inside the dynamic shared memory.
__device__ __forceinline__ float* fold_accum(float* smem) {
  return smem + 2 * KC * LDS + 2 * BM * LDS;
}

// Row tiles [t_begin, t_end) of the strip at column j0 of one matrix:
// Q (m, r), U (n, r), G / m1 / out (m, n).  With FOLD, Ys (r, LDY) must be
// zeroed by the caller and holds the strip's (G^2)^T Q on return.
template <bool GUIDED, bool FOLD, bool QUANT>
__device__ __forceinline__ Partials tile_loop(
    const Factor& Q, const Factor& U, const float* __restrict__ gb,
    const float* __restrict__ mb, float* __restrict__ ob, float* smem,
    int m, int n, int r, int j0, int t_begin, int t_end, float b2,
    float omb2, float eps) {
  float* Qs = smem;                    // [KC][LDS]  Q slice, transposed
  float* Us = Qs + KC * LDS;           // [KC][LDS]  U slice, transposed
  float* G2 = Us + KC * LDS;           // [BM][LDS]  G^2 tile      (FOLD)
  float* Q2 = G2 + BM * LDS;           // [BM][LDS]  Q fold slice  (FOLD)
  float* Ys = fold_accum(smem);        // [r][LDY]   fold accum    (FOLD)
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const bool vec = (n & 3) == 0;
  Partials p = {0.f, 0.f, 0.f, 0.f};

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
        Qs[k * LDS + row] = gr < m ? factor_at<QUANT>(Q, gr, kc + k, r) : 0.f;
        Us[k * LDS + row] = gc < n ? factor_at<QUANT>(U, gc, kc + k, r) : 0.f;
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
          p.v += v * v;
          p.u += o * o;
          if (GUIDED) {
            p.md += mv[b] * o;
            p.ms += mv[b] * mv[b];
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
          Q2[row * LDS + k] = (gr < m && kc + k < r)
                                  ? factor_at<QUANT>(Q, gr, kc + k, r)
                                  : 0.f;
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
  return p;
}

}  // namespace pass1
