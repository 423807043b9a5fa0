// The pass-1 tile loop shared by precond_kernel (fused_update.cu) and
// lowrank_update_kernel (lowrank_update.cu), for Hopper (sm_90a), on the
// tensor cores in 3xTF32.
//
// Per 64-row tile of a block's 128-column strip of G it rebuilds
//     V     = b2 * max(Q U^T, 0) + (1 - b2) G^2        (never stored)
//     u_hat = G / (sqrt(V) + eps)
// writes u_hat once, and accumulates each thread's share of sum(V^2),
// sum(u_hat^2) and, GUIDED, sum(m1 * u_hat), sum(m1^2); with FOLD it also
// adds the tile's (G^2)^T Q into the block's fold accumulator.  A caller
// reduces what it needs: unused partials are dead code.
//
// Arithmetic.  Q, U and G^2 are fp32 and not tf32-exact, and u_hat is held
// to 1e-5 of its largest entry (chip_smoke.py TOL_PRECOND).  As in
// srsi_matmul.cu, each operand x is split into big = tf32(x) and small =
// tf32(x - big) as it is staged, and every product is small.big +
// big.small + big.big, three wgmma .tf32 into fp32 (m64n64k8 for Q U^T,
// m64n128k8 for the fold).  Each product starts a fresh accumulator per
// 32-deep slice of r (Q U^T) or per 64-row tile (the fold) and adds it
// into a register (or shared) sum by ordinary fp32 adds: wgmma's own
// accumulation rounds worse than round-to-nearest, and the fold contracts
// over all m rows.  On cancelling factors the split's error in Q U^T is
// the plain fp32 product's at r = 128 and 2-4x it at r = 5; bf16 hi + lo
// reads 10x to 90x (tests/test_torch_kernels.py emulates both).
//
// Layout.  A block is two warpgroups, one per 64-column half of its strip;
// both read the same Q tile.  (One warpgroup a block, two blocks an SM,
// read 19% slower at GPT-2's leaves and 59% slower in int8: each Q tile
// then serves 64 columns.)  Q U^T walks r in 32-deep slices: the Q slice
// ([64][32], A) and the U slice ([128][32], B) are staged K-major in the
// 128-byte swizzle, big and small apart, through registers (coalesced
// along r, which is contiguous in both), in two stages: the next slice's
// loads are in flight while the current slice's 12 wgmma run.  G (and m1)
// are loaded into registers in the accumulator's layout when the tile
// starts, so they arrive during the products, and the elementwise
// epilogue reads Q U^T straight out of the accumulator fragments.
//
// The fold rider.  (G^2)^T Q contracts over the rows of G, and tf32
// operands enter wgmma K-major only, so both operands are staged with the
// rows contiguous: the epilogue writes G^2 from its registers transposed
// into [128 columns][64 rows] (A; each warpgroup reads its 64 columns),
// and Q is restaged whole as [R_MAX = 128 columns of Q][64 rows] (B), both
// over the ring of the Q U^T slices, so each warpgroup's fold is one chain
// of m64n128k8 products a tile (two chains of m64n64k8, each restaging
// half of Q, read 8-9% slower on an H100).  Its (64, 128) sum lives in
// shared memory across the block's row tiles, 64 values a thread in
// thread-private places.
//
// QUANT: the factors arrive as the int8 codec of core/quantized.py (q8,
// and per 256-row block and column an fp32 scale and zero).  Each factor
// value is dequantized as it is staged, deq = (q8 + 127) * scale + zero
// with __fmul_rn / __fadd_rn (no fma contraction), which is
// core/quantized.dequantize bit for bit, then split.  A 64-row Q tile and
// a 128-row U strip lie inside one 256-row codec block, so a staged chunk
// of four values takes one 4-byte q8 load and one 16-byte load each of
// scale and zero.  The fp32 factors are never formed in memory.  Rows
// past m / n and columns past r read as 0 on both paths.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace pass1 {

constexpr int BM = 64;            // rows of G per tile (the wgmma M)
constexpr int NW = 2;             // warpgroups a block, 64 columns each
constexpr int BN = NW * WT;       // columns of G per block
constexpr int THREADS = NW * WG;
constexpr int KC = 32;            // depth of one slice: a 128-byte row
constexpr int QBLOCK = 256;       // rows per (scale, zero) cell of the codec
constexpr int R_MAX = 128;        // with the fold: its N, and Q^T staged whole

// Shared memory, in floats from the 1024-byte aligned base.  Stage t of
// Q U^T: Q big, Q small ([64][32] each), U big, U small ([128][32]).
constexpr int QS = BM * KC;
constexpr int US = BN * KC;
constexpr int STAGE = 2 * QS + 2 * US;
constexpr int RING = 2 * STAGE;
// The fold, over the ring once a tile's Q U^T is done: G^2 big, G^2 small
// ([2][128][32]: its 64 rows in two 32-deep blocks), Q^T big, Q^T small
// ([2][R_MAX][32]); then the fold sums, per warpgroup [64][WG].
constexpr int G2S = 2 * BN * KC;
constexpr int QTS = 2 * R_MAX * KC;
constexpr int FOLD_TILES = 2 * G2S + 2 * QTS;
constexpr int FOLD_SUMS = NW * 64 * WG;

// Dynamic shared memory a launch asks for, with 1024 bytes of alignment.
__host__ __device__ constexpr size_t smem_bytes(bool fold) {
  return (fold ? (size_t)FOLD_TILES + FOLD_SUMS : (size_t)RING) *
             sizeof(float) +
         1024;
}
static_assert(FOLD_TILES >= RING, "the fold's sums would overlap the ring");

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

__device__ __forceinline__ float deq(int q, float scale, float zero) {
  return __fadd_rn(__fmul_rn((float)q + 127.f, scale), zero);
}

// Offset of (row, chunk c4) in an [R][32] fp32 tile: 128-byte rows, the
// 16-byte chunk c4 at c4 ^ (row % 8).
__device__ __forceinline__ int off32(int row, int c4) {
  return row * KC + ((c4 ^ (row & 7)) << 2);
}

// tf32 k8 step kk of an [R][32] tile read K-major.
__device__ __forceinline__ uint64_t kdesc(const float* t, int kk) {
  return desc(t + kk * 8, 16, 1024);
}

// Store x split into tf32 big and small at element offset o of two tiles.
__device__ __forceinline__ void split4(const float (&x)[4], float* big,
                                      float* small, int o) {
  float b[4], s[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    b[e] = tf32(x[e]);
    s[e] = tf32(x[e] - b[e]);
  }
  *reinterpret_cast<float4*>(big + o) = make_float4(b[0], b[1], b[2], b[3]);
  *reinterpret_cast<float4*>(small + o) = make_float4(s[0], s[1], s[2], s[3]);
}

// One thread's share of an [R][32] slice of a factor, K-major: rows
// [row0, row0 + R) (0 at and past rows), r-indices [k0, k0 + 32) (0 at and
// past r), r contiguous in memory: eight lanes load one 128-byte row.
// Rows row0 .. row0 + R - 1 lie in one codec block (R divides QBLOCK).
template <bool QUANT, int R>
struct RowSlice {
  static constexpr int PER = R * KC / 4 / THREADS;
  float v[PER][4];

  __device__ __forceinline__ static void at(int j, int& row, int& c4) {
    const int i = threadIdx.x + j * THREADS;
    row = i >> 3;
    c4 = i & 7;
  }

  __device__ __forceinline__ void load(const Factor& F, int row0, int rows,
                                       int k0, int r) {
    const size_t cell = (size_t)(row0 / QBLOCK) * r;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      int tr, c4;
      at(j, tr, c4);
      const int row = row0 + tr, k = k0 + 4 * c4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < rows && k < r) {
        const size_t o = (size_t)row * r + k;
        if (QUANT) {
          const char4 q = *reinterpret_cast<const char4*>(F.q8 + o);
          const float4 s =
              *reinterpret_cast<const float4*>(F.scale + cell + k);
          const float4 z =
              *reinterpret_cast<const float4*>(F.zero + cell + k);
          x = make_float4(deq(q.x, s.x, z.x), deq(q.y, s.y, z.y),
                          deq(q.z, s.z, z.z), deq(q.w, s.w, z.w));
        } else {
          x = *reinterpret_cast<const float4*>(F.f + o);
        }
      }
      v[j][0] = x.x;
      v[j][1] = x.y;
      v[j][2] = x.z;
      v[j][3] = x.w;
    }
  }

  __device__ __forceinline__ void store(float* big, float* small) const {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      int tr, c4;
      at(j, tr, c4);
      split4(v[j], big, small, off32(tr, c4));
    }
  }
};

// One thread's share of Q^T for the fold, [R_MAX r-indices][64 rows] as
// two [R_MAX][32] tiles K-major along the rows: rows [row0, row0 + 64) (0
// at and past rows), every r-index (0 at and past r).  Lanes run along r,
// contiguous in memory; each thread loads four rows of one r-index.
template <bool QUANT>
struct ColSlice {
  static constexpr int PER = R_MAX * BM / 4 / THREADS;
  float v[PER][4];

  __device__ __forceinline__ static void at(int j, int& tk, int& c4) {
    const int i = threadIdx.x + j * THREADS;
    tk = i % R_MAX;
    c4 = i / R_MAX;   // 4-row chunk, 0 .. 15
  }

  __device__ __forceinline__ void load(const Factor& F, int row0, int rows,
                                       int r) {
    const size_t cell = (size_t)(row0 / QBLOCK) * r;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      int tk, c4;
      at(j, tk, c4);
      const int k = tk;
      float s = 0.f, z = 0.f;
      if (QUANT && k < r) {
        s = F.scale[cell + k];
        z = F.zero[cell + k];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 4 * c4 + e;
        const size_t o = (size_t)row * r + k;
        float x = 0.f;
        if (k < r && row < rows) x = QUANT ? deq(F.q8[o], s, z) : F.f[o];
        v[j][e] = x;
      }
    }
  }

  __device__ __forceinline__ void store(float* big, float* small) const {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      int tk, c4;
      at(j, tk, c4);
      split4(v[j], big, small, (c4 >> 3) * (R_MAX * KC) + off32(tk, c4 & 7));
    }
  }
};

// A 64 x 64 fragment of an (m, n) fp32 matrix in the accumulator's layout:
// v[4 j + 2 h + x] = src[row + 8 h][col + 8 j + x], 0 past either edge;
// col is even, so with n even each pair is one aligned 8-byte load.
__device__ __forceinline__ void load_frag(const float* __restrict__ src,
                                          float (&v)[32], int m, int n,
                                          int row, int col) {
  const bool vec = (n & 1) == 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = row + 8 * h, cc = col + 8 * j;
      const size_t o = (size_t)rr * n + cc;
      float2 x = make_float2(0.f, 0.f);
      if (rr < m && cc < n) {
        if (vec) {
          x = *reinterpret_cast<const float2*>(src + o);
        } else {
          x.x = src[o];
          if (cc + 1 < n) x.y = src[o + 1];
        }
      }
      v[4 * j + 2 * h] = x.x;
      v[4 * j + 2 * h + 1] = x.y;
    }
}

// u_hat = g / (sqrt(v) + eps) by the hardware's approximate square root
// and reciprocal (sqrt.approx, __fdividef: a few ulp together).  The IEEE
// sequences were 10% of the kernel's time on an H100, and u_hat is held to
// 1e-5 of its largest entry.
__device__ __forceinline__ float uhat(float g, float v, float eps) {
  float s;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(s) : "f"(v));
  return __fdividef(g, s + eps);
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

// Row tiles [t_begin, t_end) of the strip at column j0 of one matrix:
// Q (m, r), U (n, r), G / m1 / out (m, n), r a multiple of 16 (and at most
// R_MAX with FOLD).  With FOLD the strip's (G^2)^T Q over those tiles is
// written to yb[j0 + c][k] ((n, r)).  sm is the aligned dynamic shared
// memory (smem_bytes).
template <bool GUIDED, bool FOLD, bool QUANT>
__device__ __forceinline__ Partials tile_loop(
    const Factor& Q, const Factor& U, const float* __restrict__ gb,
    const float* __restrict__ mb, float* __restrict__ ob,
    float* __restrict__ yb, float* sm, int m, int n, int r, int j0,
    int t_begin, int t_end, float b2, float omb2, float eps) {
  const int tid = threadIdx.x, w = tid / WG, tw = tid % WG, ln = tid & 31;
  const int r0 = tw / 32 * 16 + (ln >> 2);   // fragment rows r0, r0 + 8
  const int c0 = 2 * (ln & 3);               // columns 8 j + c0 + {0, 1}
  const int cw = j0 + w * WT;                // this warpgroup's columns
  const int ns = (r + KC - 1) / KC;
  float* g2 = sm;                            // fold: G^2 big, then small
  float* qt = sm + 2 * G2S;                  // fold: Q^T big, then small
  float* ys = sm + FOLD_TILES + w * 64 * WG + tw;  // fold sums
  Partials p = {0.f, 0.f, 0.f, 0.f};
  if (FOLD)
    for (int e = 0; e < 64; ++e) ys[e * WG] = 0.f;

  RowSlice<QUANT, BM> qa;
  RowSlice<QUANT, BN> ua;
  ColSlice<QUANT> qc;
  bool staged = false;   // the tile's first slice is in qa / ua already
  for (int t = t_begin; t < t_end; ++t) {
    const int i0 = t * BM;
    // the epilogue's G (and m1), in flight during the products
    float gv[32], mv[32];
    load_frag(gb, gv, m, n, i0 + r0, cw + c0);
    if (GUIDED) load_frag(mb, mv, m, n, i0 + r0, cw + c0);
    if (!staged) {
      qa.load(Q, i0, m, 0, r);
      ua.load(U, j0, n, 0, r);
    }
    staged = false;
    qa.store(sm, sm + QS);
    ua.store(sm + 2 * QS, sm + 2 * QS + US);
    async_fence();
    __syncthreads();

    // ---- Q U^T, 32-deep slices, each from a fresh accumulator
    float acc[32], part[32];
    zero(acc);
    for (int s = 0; s < ns; ++s) {
      const float* st = sm + (s & 1) * STAGE;
      const bool more = s + 1 < ns;
      if (more) {
        qa.load(Q, i0, m, (s + 1) * KC, r);
        ua.load(U, j0, n, (s + 1) * KC, r);
      } else if (!FOLD && t + 1 < t_end) {   // the next tile's first slice
        qa.load(Q, i0 + BM, m, 0, r);
        ua.load(U, j0, n, 0, r);
        staged = true;
      }
      keep(part);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {
        const uint64_t ab = kdesc(st, kk), as = kdesc(st + QS, kk);
        const uint64_t bb = kdesc(st + 2 * QS + w * WT * KC, kk);
        const uint64_t bs = kdesc(st + 2 * QS + US + w * WT * KC, kk);
        mma_tf32(part, as, bb, kk > 0);
        mma_tf32(part, ab, bs, 1);
        mma_tf32(part, ab, bb, 1);
      }
      wg_commit();
      if (more) {   // the other stage, read by no wgmma in flight
        float* nx = sm + ((s + 1) & 1) * STAGE;
        qa.store(nx, nx + QS);
        ua.store(nx + 2 * QS, nx + 2 * QS + US);
      }
      wg_wait();
      keep(part);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] += part[e];
      async_fence();
      __syncthreads();
    }

    // ---- elementwise epilogue on the accumulator fragments
    if (FOLD) qc.load(Q, i0, m, r);   // in flight during the epilogue
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r0 + 8 * h, row = i0 + rr, col = cw + 8 * j + c0;
        float o[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int e = 4 * j + 2 * h + x;
          const float g = gv[e];
          const float v = b2 * fmaxf(acc[e], 0.f) + omb2 * g * g;
          o[x] = uhat(g, v, eps);
          if (row < m && col + x < n) {
            p.v += v * v;
            p.u += o[x] * o[x];
            if (GUIDED) {
              p.md += mv[e] * o[x];
              p.ms += mv[e] * mv[e];
            }
          }
          if (FOLD) {   // G^2 transposed: row c of the [128][64] tile
            const int c = w * WT + 8 * j + c0 + x;
            const int at = (rr >> 5) * (BN * KC) + off32(c, (rr & 31) >> 2) +
                           (rr & 3);
            const float g2v = g * g, big = tf32(g2v);
            g2[at] = big;
            g2[G2S + at] = tf32(g2v - big);
          }
        }
        if (row < m && col < n) {
          const size_t off = (size_t)row * n + col;
          if ((n & 1) == 0) {
            *reinterpret_cast<float2*>(ob + off) = make_float2(o[0], o[1]);
          } else {
            ob[off] = o[0];
            if (col + 1 < n) ob[off + 1] = o[1];
          }
        }
      }

    // ---- fold rider: (G^2)^T Q over the tile's 64 rows, one chain from a
    // fresh accumulator, added into the shared sums
    if (FOLD) {
      qc.store(qt, qt + QTS);
      async_fence();
      __syncthreads();
      if (t + 1 < t_end) {   // the next tile's first slice
        qa.load(Q, i0 + BM, m, 0, r);
        ua.load(U, j0, n, 0, r);
        staged = true;
      }
      float yp[64];
      keep(yp);
      wg_fence();
#pragma unroll
      for (int kb = 0; kb < 2; ++kb)
#pragma unroll
        for (int kk = 0; kk < KC / 8; ++kk) {
          const float* a = g2 + kb * (BN * KC) + w * WT * KC;
          const float* b = qt + kb * (R_MAX * KC);
          const uint64_t ab = kdesc(a, kk), as = kdesc(a + G2S, kk);
          const uint64_t bb = kdesc(b, kk), bs = kdesc(b + QTS, kk);
          mma_tf32(yp, as, bb, kb > 0 || kk > 0);
          mma_tf32(yp, ab, bs, 1);
          mma_tf32(yp, ab, bb, 1);
        }
      wg_commit();
      wg_wait();
      keep(yp);
#pragma unroll
      for (int e = 0; e < 64; ++e) ys[e * WG] += yp[e];
      __syncthreads();   // the next tile restages over the fold's tiles
    }
  }

  // ---- the strip's fold: yb[cw + c][k], c = r0 + 8 h, k = 8 j + c0 + x
  // (r is even, so each pair is in or out)
  if (FOLD)
#pragma unroll
    for (int j = 0; j < R_MAX / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = cw + r0 + 8 * h, k = 8 * j + c0;
        const float* y = ys + (4 * j + 2 * h) * WG;
        if (col < n && k < r)
          *reinterpret_cast<float2*>(yb + (size_t)col * r + k) =
              make_float2(y[0], y[WG]);
      }
  return p;
}

}  // namespace pass1
