// The Mamba2 SSD intra-chunk block for Hopper (sm_90a): forward and
// recompute backward, every product in fp32 on the CUDA cores, fp32 or
// bf16 x / B / C.
//
// Replaces the Pallas TPU kernel ssd_chunk_pallas
// (src/repro/kernels/ssd_chunk.py), a forward only, and for the backward
// jax.vjp of the jnp path the JAX model differentiates in its place
// (src/repro/models/mamba2.py::ssd_chunked).  Per chunk of q rows and
// head h it computes, with L[i][j] = exp(cums_i - cums_j) for j <= i:
//
//     Y = (C (dt B)^T * L) X + exp(cums) * (C h_in) + d_skip X
//
// Layout is the model's: x and y (B, S, H, P), B and C (B, S, G, N), head
// h reading group h / (H / G), so neither the groups nor the heads are
// copied or transposed in memory; dt and cums (B, S, H) fp32, cums the
// within-chunk cumsum of dt a; h_in (B, nc, H, N, P) fp32, the state
// entering each chunk (the inter-chunk scan stays outside); d_skip (H,).
// q = S / nc, P <= 128 and N <= 128 are masked, never padded in memory.
// Three kernels, 64-row tiles, 256 threads a block, each thread owning a
// 4 x 4 block of every 64 x 64 product, as in flash_attention.cu:
//
//   * ssd_fwd_kernel: one block per (chunk, head, 64-row i-tile).  It
//     stages C_i once, then for each j-tile <= i stages (dt B)_j
//     transposed and X_j, forms the 64 x 64 CB tile, scales it by L on
//     and below the diagonal only (no exp of the positive differences
//     above it), and accumulates (CB * L) X_j in registers; then adds
//     exp(cums_i) (C_i h_in) and d_skip X_i.  No (q, q) tensor is written.
//   * ssd_bwd_rows_kernel: one block per (chunk, head), looping over the
//     i-tiles.  For each it recomputes CB and dM = dY X^T against every
//     j-tile <= i, forms dS = dM * L and T = dS * CB, and accumulates
//     dC = dS (dt B) + exp(cums) (dY h_in^T) (per head), the row part of
//     dcums (rowsum T + exp(cums) sum_n C (dY h_in^T)), and over all the
//     chunk's rows dh_in = C^T (exp(cums) dY) in registers.
//   * ssd_bwd_cols_kernel: one block per (chunk, head, j-tile), after the
//     rows kernel (it reads the row part of dcums).  Over the i-tiles >=
//     j it recomputes M^T and dS^T, accumulates dX = M^T dY and
//     d(dt B) = dS^T C, and writes dX + d_skip dY, dB = dt d(dt B) (per
//     head), ddt = sum_n d(dt B) B, dcums = row part - colsum T, and the
//     tile's partial of dd_skip = sum dY X.
//
// The per-head dB and dC are summed over each group's heads, and the
// dd_skip partials over the tiles, by the wrapper in a fixed order: no
// float atomics, every output repeats bit for bit.
//
// What bounds it on an H100: operations.  Mamba2-370m at batch 8 x 1024
// (chunk 256, 32 heads, P 64, N 128, 48 layers a step) has 32,896 live
// (i, j) pairs a chunk and head.  The forward does 2 N pairs (CB) + 2 P
// pairs ((CB L) X) + 2 q N P (C h_in) operations a program, 16.8 MFLOP,
// 827 GFLOP a step.  Priced by operand type: with the model's bf16 B and
// C, CB = dt_j (C_i . B_j) is a bf16 product with fp32 sums (dt only
// scales its column), half the forward's operations at the 989 TFLOP/s
// tensor-core peak; (CB L) X and C h_in have an fp32 operand (L, h_in)
// and run at the 67 TFLOP/s fp32 peak.  That bounds the forward at 6.6
// ms a step, its bytes at ~2 ms.  The backward's seven products (CB, dM,
// dX, dC intra, d(dt B), dC inter, dh_in) are 42.1 MFLOP a program; CB
// and dM = dY X^T (dY is bf16-valued on the model's path: the gradient of
// y cast to bf16) are bf16 products, the rest fp32: 22.2 ms a step.  This
// design runs all of them in fp32 on the CUDA cores from shared memory,
// and recomputes CB and dM in both backward kernels (nine products), so
// CB and dM on the tensor cores (wgmma, TMA) are the first levers for a
// later version.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (no --use_fast_math: expf stays exact to an
//        ulp).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BT = 64;            // rows of every tile
constexpr int THREADS = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr int TS = BT + 4;        // row stride of a transposed tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Stage rows [0, nrows) x columns [0, ncols) of a global tile (row stride
// rs elements), each row times rscale[r] when given, as fp32 into a
// row-major [BT][W] tile and / or a transposed [W][TS] tile; rows and
// columns past the edge are 0.
template <typename T, int W>
__device__ void stage(const T* __restrict__ g, long rs, int nrows,
                      int ncols, const float* rscale, float* rowm,
                      float* tr) {
  for (int i = threadIdx.x; i < BT * W; i += THREADS) {
    const int r = i / W, c = i % W;
    float v = 0.f;
    if (r < nrows && c < ncols) {
      v = to_f(g[r * rs + c]);
      if (rscale) v *= rscale[r];
    }
    if (rowm) rowm[r * W + c] = v;
    if (tr) tr[c * TS + r] = v;
  }
}

// C[i][g * 4 + j] += sum_{x < X} A[(ty * 4 + i) * SA + x]
//                               * B[x * SB + g * 64 + tx * 4 + j]
template <int X, int SA, int SB, int NG>
__device__ __forceinline__ void mma(float (&c)[4][4 * NG],
                                    const float* __restrict__ A,
                                    const float* __restrict__ B, int ty,
                                    int tx) {
#pragma unroll 2
  for (int x = 0; x < X; x += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * SA + x);
#pragma unroll
    for (int xx = 0; xx < 4; ++xx) {
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 b = *reinterpret_cast<const float4*>(
            B + (x + xx) * SB + g * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = comp(a[i], xx);
          c[i][g * 4 + 0] += av * b.x;
          c[i][g * 4 + 1] += av * b.y;
          c[i][g * 4 + 2] += av * b.z;
          c[i][g * 4 + 3] += av * b.w;
        }
      }
    }
  }
}

// Write a thread's 4 x 4 block row-major into a [BT][BT] tile.
__device__ __forceinline__ void put4x4(float* t, const float (&v)[4][4],
                                       int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(t + (ty * 4 + i) * BT + tx * 4) =
        make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
}

// Sum over the 16 threads of a row group (lanes 0-15 or 16-31).
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Dims {
  int B, S, H, G, P, N, nc, q;
};

// Where a block's (chunk, head) lives: z = b * nc + c.
struct Chunk {
  int b, c, h, g;
  long row0;  // global row (b * S + c * q) of the chunk's first token
  __device__ Chunk(int bch, const Dims& d) {
    const int z = bch / d.H;
    h = bch % d.H;
    b = z / d.nc;
    c = z % d.nc;
    g = h / (d.H / d.G);
    row0 = (long)b * d.S + (long)c * d.q;
  }
  // element offsets of token r of the chunk
  __device__ long x(int r, const Dims& d) const {
    return ((row0 + r) * d.H + h) * d.P;
  }
  __device__ long bc(int r, const Dims& d) const {
    return ((row0 + r) * d.G + g) * d.N;
  }
  __device__ long s(int r, const Dims& d) const {
    return (row0 + r) * d.H + h;
  }
  __device__ long hin(const Dims& d) const {
    return (((long)b * d.nc + c) * d.H + h) * d.N * d.P;
  }
};

// Load a per-token fp32 scalar (dt or cums) of rows [r0, r0 + BT) into
// smem, 0 past the chunk's edge.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          const Chunk& ch, int r0, int nr,
                                          const Dims& d) {
  if (threadIdx.x < BT)
    dst[threadIdx.x] = threadIdx.x < nr ? src[ch.s(r0 + threadIdx.x, d)]
                                        : 0.f;
}

template <typename T, int PP, int NP>
__global__ void __launch_bounds__(THREADS)
ssd_fwd_kernel(const T* __restrict__ x, const T* __restrict__ bm,
               const T* __restrict__ cm, const float* __restrict__ dt,
               const float* __restrict__ cums,
               const float* __restrict__ hin,
               const float* __restrict__ dskip, float* __restrict__ y,
               Dims d) {
  extern __shared__ __align__(16) float sm[];
  float* cs = sm;                 // [BT][NP]  C_i
  float* bxT = cs + BT * NP;      // [NP][TS]  (dt B)_j^T
  float* xs = bxT + NP * TS;      // [BT][PP]  X_j
  float* ps = xs + BT * PP;       // [BT][BT]  CB * L
  float* hs = bxT;                // [NP][PP]  h_in, after the j loop
  float* ci = ps + BT * BT;       // [BT]
  float* cj = ci + BT;            // [BT]
  float* dtj = cj + BT;           // [BT]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const Chunk ch(blockIdx.x, d);
  const int it = gridDim.y - 1 - blockIdx.y;  // the longest tiles first
  const int i0 = it * BT, ni = min(BT, d.q - i0);
  const long brs = (long)d.G * d.N, xrs = (long)d.H * d.P;
  stage<T, NP>(cm + ch.bc(i0, d), brs, ni, d.N, nullptr, cs, nullptr);
  load_rows(ci, cums, ch, i0, ni, d);
  float acc[4][PP / 16] = {};
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * BT, nj = min(BT, d.q - j0);
    __syncthreads();
    load_rows(dtj, dt, ch, j0, nj, d);
    load_rows(cj, cums, ch, j0, nj, d);
    __syncthreads();
    stage<T, NP>(bm + ch.bc(j0, d), brs, nj, d.N, dtj, nullptr, bxT);
    stage<T, PP>(x + ch.x(j0, d), xrs, nj, d.P, nullptr, xs, nullptr);
    __syncthreads();
    float s[4][4] = {};
    mma<NP, NP, TS, 1>(s, cs, bxT, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        const bool live = r < ni && c < nj && j0 + c <= i0 + r;
        s[i][j] = live ? s[i][j] * expf(ci[r] - cj[c]) : 0.f;
      }
    }
    put4x4(ps, s, ty, tx);
    __syncthreads();
    mma<BT, BT, PP, PP / 64>(acc, ps, xs, ty, tx);
  }
  __syncthreads();  // done with bxT, xs and ps: h_in goes over them
  const float* hsrc = hin + ch.hin(d);
  for (int i = tid; i < NP * PP; i += THREADS) {
    const int n = i / PP, p = i % PP;
    hs[i] = n < d.N && p < d.P ? hsrc[n * d.P + p] : 0.f;
  }
  __syncthreads();
  float inter[4][PP / 16] = {};
  mma<NP, NP, PP, PP / 64>(inter, cs, hs, ty, tx);
  const float dsk = dskip[ch.h];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= ni) continue;
    const float e = expf(ci[r]);
    const long off = ch.x(i0 + r, d);
#pragma unroll
    for (int g = 0; g < PP / 64; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = g * 64 + tx * 4 + j;
        if (p < d.P)
          y[off + p] = acc[i][g * 4 + j] + e * inter[i][g * 4 + j] +
                       dsk * to_f(x[off + p]);
      }
  }
}

template <typename T, int PP, int NP>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                    const T* __restrict__ cm, const float* __restrict__ dt,
                    const float* __restrict__ cums,
                    const float* __restrict__ hin,
                    const float* __restrict__ dy,
                    float* __restrict__ dc_h, float* __restrict__ dcums_row,
                    float* __restrict__ dhin, Dims d) {
  extern __shared__ __align__(16) float sm[];
  float* cs = sm;                 // [BT][NP]  C_i
  float* dys = cs + BT * NP;      // [BT][PP]  dY_i
  float* xT = dys + BT * PP;      // [PP][TS]  (e dY_i)^T, then X_j^T
  float* bxT = xT + PP * TS;      // [NP][TS]  (dt B)_j^T, then row-major
  float* ps = bxT + NP * TS;      // [BT][BT]  dS
  float* hT = ps + BT * BT;       // [PP][NP]  h_in^T
  float* ci = hT + PP * NP;       // [BT]
  float* ei = ci + BT;            // [BT]  exp(cums_i)
  float* cj = ei + BT;            // [BT]
  float* dtj = cj + BT;           // [BT]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const Chunk ch(blockIdx.x, d);
  const long brs = (long)d.G * d.N, xrs = (long)d.H * d.P;
  {
    const float* hsrc = hin + ch.hin(d);
    for (int i = tid; i < PP * NP; i += THREADS) {
      const int p = i / NP, n = i % NP;
      hT[i] = n < d.N && p < d.P ? hsrc[n * d.P + p] : 0.f;
    }
  }
  float dh[PP / 64][4][NP / 16] = {};  // dh_in^T: rows p, columns n
  const int nt = (d.q + BT - 1) / BT;
  for (int it = 0; it < nt; ++it) {
    const int i0 = it * BT, ni = min(BT, d.q - i0);
    __syncthreads();
    load_rows(ci, cums, ch, i0, ni, d);
    if (tid < BT) ei[tid] = tid < ni ? expf(ci[tid]) : 0.f;
    stage<T, NP>(cm + ch.bc(i0, d), brs, ni, d.N, nullptr, cs, nullptr);
    stage<float, PP>(dy + ch.x(i0, d), xrs, ni, d.P, nullptr, dys,
                     nullptr);
    __syncthreads();
    stage<float, PP>(dy + ch.x(i0, d), xrs, ni, d.P, ei, nullptr, xT);
    __syncthreads();
#pragma unroll
    for (int rg = 0; rg < PP / 64; ++rg)
      mma<BT, TS, NP, NP / 64>(dh[rg], xT + rg * 64 * TS, cs, ty, tx);
    // the inter-chunk part: Z = dY_i h_in^T; dC = e Z, dcums = e sum C Z
    float dc[4][NP / 16] = {};
    mma<PP, PP, NP, NP / 64>(dc, dys, hT, ty, tx);
    float rowp[4], tp[4] = {};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      float sum = 0.f;
#pragma unroll
      for (int g = 0; g < NP / 64; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = g * 64 + tx * 4 + j;
          dc[i][g * 4 + j] *= ei[r];
          sum += cs[r * NP + n] * dc[i][g * 4 + j];
        }
      rowp[i] = row_sum(sum);
    }
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * BT, nj = min(BT, d.q - j0);
      __syncthreads();  // every thread is done with xT, bxT and ps
      load_rows(dtj, dt, ch, j0, nj, d);
      load_rows(cj, cums, ch, j0, nj, d);
      __syncthreads();
      stage<T, NP>(bm + ch.bc(j0, d), brs, nj, d.N, dtj, nullptr, bxT);
      stage<T, PP>(x + ch.x(j0, d), xrs, nj, d.P, nullptr, nullptr, xT);
      __syncthreads();
      float s[4][4] = {}, dm[4][4] = {};
      mma<NP, NP, TS, 1>(s, cs, bxT, ty, tx);
      mma<PP, PP, TS, 1>(dm, dys, xT, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx * 4 + j;
          const bool live = r < ni && c < nj && j0 + c <= i0 + r;
          const float l = live ? expf(ci[r] - cj[c]) : 0.f;
          dm[i][j] *= l;               // dS
          tp[i] += dm[i][j] * s[i][j];  // T
        }
      }
      __syncthreads();  // every thread is done with bxT
      stage<T, NP>(bm + ch.bc(j0, d), brs, nj, d.N, dtj, bxT, nullptr);
      put4x4(ps, dm, ty, tx);
      __syncthreads();
      mma<BT, BT, NP, NP / 64>(dc, ps, bxT, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const float rs = rowp[i] + row_sum(tp[i]);
      if (r >= ni) continue;
      const long soff = ch.s(i0 + r, d);
      if (tx == 0) dcums_row[soff] = rs;
      float* row = dc_h + soff * d.N;
#pragma unroll
      for (int g = 0; g < NP / 64; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = g * 64 + tx * 4 + j;
          if (n < d.N) row[n] = dc[i][g * 4 + j];
        }
    }
  }
  float* dst = dhin + ch.hin(d);
#pragma unroll
  for (int rg = 0; rg < PP / 64; ++rg)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = rg * 64 + ty * 4 + i;
      if (p >= d.P) continue;
#pragma unroll
      for (int g = 0; g < NP / 64; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = g * 64 + tx * 4 + j;
          if (n < d.N) dst[(long)n * d.P + p] = dh[rg][i][g * 4 + j];
        }
    }
}

template <typename T, int PP, int NP>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_cols_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                    const T* __restrict__ cm, const float* __restrict__ dt,
                    const float* __restrict__ cums,
                    const float* __restrict__ dskip,
                    const float* __restrict__ dy,
                    const float* __restrict__ dcums_row,
                    T* __restrict__ dx, float* __restrict__ db_h,
                    float* __restrict__ ddt, float* __restrict__ dcums,
                    float* __restrict__ dskip_part, Dims d) {
  extern __shared__ __align__(16) float sm[];
  float* bxs = sm;                // [BT][NP]  (dt B)_j
  float* xs = bxs + BT * NP;      // [BT][PP]  X_j
  float* cT = xs + BT * PP;       // [NP][TS]  C_i^T, then row-major
  float* dyT = cT + NP * TS;      // [PP][TS]  dY_i^T, then row-major
  float* ps = dyT + PP * TS;      // [BT][BT]  M^T, then dS^T
  float* ci = ps + BT * BT;       // [BT]
  float* cj = ci + BT;            // [BT]
  float* dtj = cj + BT;           // [BT]
  float* red = dtj + BT;          // [THREADS / 32]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const Chunk ch(blockIdx.x, d);
  const int nt = gridDim.y;
  const int jt = blockIdx.y;
  const int j0 = jt * BT, nj = min(BT, d.q - j0);
  const long brs = (long)d.G * d.N, xrs = (long)d.H * d.P;
  load_rows(dtj, dt, ch, j0, nj, d);
  load_rows(cj, cums, ch, j0, nj, d);
  __syncthreads();
  stage<T, NP>(bm + ch.bc(j0, d), brs, nj, d.N, dtj, bxs, nullptr);
  stage<T, PP>(x + ch.x(j0, d), xrs, nj, d.P, nullptr, xs, nullptr);
  float dxa[4][PP / 16] = {}, dbx[4][NP / 16] = {}, tp[4] = {};
  for (int it = jt; it < nt; ++it) {
    const int i0 = it * BT, ni = min(BT, d.q - i0);
    __syncthreads();  // every thread is done with cT, dyT and ps
    load_rows(ci, cums, ch, i0, ni, d);
    stage<T, NP>(cm + ch.bc(i0, d), brs, ni, d.N, nullptr, nullptr, cT);
    stage<float, PP>(dy + ch.x(i0, d), xrs, ni, d.P, nullptr, nullptr,
                     dyT);
    __syncthreads();
    // rows: tokens j0 + ty * 4 + i; columns: tokens i0 + tx * 4 + j
    float s[4][4] = {}, dm[4][4] = {};
    mma<NP, NP, TS, 1>(s, bxs, cT, ty, tx);
    mma<PP, PP, TS, 1>(dm, xs, dyT, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        const bool live = r < nj && c < ni && i0 + c >= j0 + r;
        const float l = live ? expf(ci[c] - cj[r]) : 0.f;
        dm[i][j] *= l;               // dS^T
        tp[i] += dm[i][j] * s[i][j];  // T^T
        s[i][j] *= l;                // M^T
      }
    }
    __syncthreads();  // every thread is done with cT and dyT
    stage<T, NP>(cm + ch.bc(i0, d), brs, ni, d.N, nullptr, cT, nullptr);
    stage<float, PP>(dy + ch.x(i0, d), xrs, ni, d.P, nullptr, dyT,
                     nullptr);
    put4x4(ps, s, ty, tx);
    __syncthreads();
    mma<BT, BT, PP, PP / 64>(dxa, ps, dyT, ty, tx);
    __syncthreads();
    put4x4(ps, dm, ty, tx);
    __syncthreads();
    mma<BT, BT, NP, NP / 64>(dbx, ps, cT, ty, tx);
  }
  const float dsk = dskip[ch.h];
  float skip = 0.f;  // this thread's part of sum dY X over the tile
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const bool row = r < nj;
    const long soff = row ? ch.s(j0 + r, d) : 0;
    const long xoff = row ? ch.x(j0 + r, d) : 0;
    const long boff = row ? ch.bc(j0 + r, d) : 0;
#pragma unroll
    for (int g = 0; g < PP / 64; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = g * 64 + tx * 4 + j;
        if (row && p < d.P) {
          const float gy = dy[xoff + p];
          dx[xoff + p] = from_f<T>(dxa[i][g * 4 + j] + dsk * gy);
          skip += gy * xs[r * PP + p];
        }
      }
    float ddt_part = 0.f;
#pragma unroll
    for (int g = 0; g < NP / 64; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = g * 64 + tx * 4 + j;
        if (row && n < d.N) {
          const float v = dbx[i][g * 4 + j];
          db_h[soff * d.N + n] = dtj[r] * v;
          ddt_part += v * to_f(bm[boff + n]);
        }
      }
    const float colsum = row_sum(tp[i]);
    ddt_part = row_sum(ddt_part);
    if (row && tx == 0) {
      ddt[soff] = ddt_part;
      dcums[soff] = dcums_row[soff] - colsum;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    skip += __shfl_xor_sync(0xffffffffu, skip, o);
  if ((tid & 31) == 0) red[tid >> 5] = skip;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) t += red[w];
    dskip_part[(long)blockIdx.x * nt + jt] = t;
  }
}

constexpr size_t fwd_smem(int pp, int np) {
  return sizeof(float) * (BT * np + np * TS + BT * pp + BT * BT + 3 * BT);
}
constexpr size_t rows_smem(int pp, int np) {
  return sizeof(float) *
         (BT * np + BT * pp + pp * TS + np * TS + BT * BT + pp * np + 4 * BT);
}
constexpr size_t cols_smem(int pp, int np) {
  return sizeof(float) * (BT * np + BT * pp + np * TS + pp * TS + BT * BT +
                          3 * BT + THREADS / 32);
}

// Dynamic shared memory above 48 KB has to be asked for per kernel.
template <typename K>
int allow_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int n_tiles(const Dims& d) { return (d.q + BT - 1) / BT; }

template <typename T, int PP, int NP>
int fwd(const void* x, const void* b, const void* c, const float* dt,
        const float* cums, const float* hin, const float* dskip, float* y,
        Dims d, cudaStream_t st) {
  auto kern = ssd_fwd_kernel<T, PP, NP>;
  const size_t smem = fwd_smem(PP, NP);
  if (int err = allow_smem(kern, smem)) return err;
  const dim3 grid(d.B * d.nc * d.H, n_tiles(d));
  kern<<<grid, THREADS, smem, st>>>((const T*)x, (const T*)b, (const T*)c,
                                    dt, cums, hin, dskip, y, d);
  return (int)cudaGetLastError();
}

template <typename T, int PP, int NP>
int bwd(const void* x, const void* b, const void* c, const float* dt,
        const float* cums, const float* hin, const float* dskip,
        const float* dy, float* dc_h, float* dcums_row, float* dhin,
        void* dx, float* db_h, float* ddt, float* dcums, float* dskip_part,
        int which, Dims d, cudaStream_t st) {
  if (which == 0) {
    auto kern = ssd_bwd_rows_kernel<T, PP, NP>;
    const size_t smem = rows_smem(PP, NP);
    if (int err = allow_smem(kern, smem)) return err;
    kern<<<d.B * d.nc * d.H, THREADS, smem, st>>>(
        (const T*)x, (const T*)b, (const T*)c, dt, cums, hin, dy, dc_h,
        dcums_row, dhin, d);
  } else {
    auto kern = ssd_bwd_cols_kernel<T, PP, NP>;
    const size_t smem = cols_smem(PP, NP);
    if (int err = allow_smem(kern, smem)) return err;
    const dim3 grid(d.B * d.nc * d.H, n_tiles(d));
    kern<<<grid, THREADS, smem, st>>>(
        (const T*)x, (const T*)b, (const T*)c, dt, cums, dskip, dy,
        dcums_row, (T*)dx, db_h, ddt, dcums, dskip_part, d);
  }
  return (int)cudaGetLastError();
}

// Instantiate a launcher for (dtype, P, N): dtype 0 fp32, 1 bf16; P and
// N <= 64 take 64-wide tiles, <= 128 the 128-wide.  Anything else is
// refused with cudaErrorInvalidValue (the wrapper checks first).
#define SSD_DISPATCH_N(FN, T, PP, ...)                          \
  return d.N <= 64 ? FN<T, PP, 64>(__VA_ARGS__)                 \
                   : FN<T, PP, 128>(__VA_ARGS__)
#define SSD_DISPATCH_P(FN, T, ...)                              \
  do {                                                          \
    if (d.P <= 64) SSD_DISPATCH_N(FN, T, 64, __VA_ARGS__);      \
    SSD_DISPATCH_N(FN, T, 128, __VA_ARGS__);                    \
  } while (0)
#define SSD_DISPATCH(FN, ...)                                               \
  do {                                                                      \
    if (d.P < 1 || d.P > 128 || d.N < 1 || d.N > 128 || d.q < 1 ||          \
        d.G < 1 || d.H % d.G)                                               \
      return (int)cudaErrorInvalidValue;                                    \
    if (dtype == 0) SSD_DISPATCH_P(FN, float, __VA_ARGS__);                 \
    if (dtype == 1) SSD_DISPATCH_P(FN, __nv_bfloat16, __VA_ARGS__);         \
    return (int)cudaErrorInvalidValue;                                      \
  } while (0)

}  // namespace

extern "C" {

// x (B, S, H, P), b / c (B, S, G, N) in dtype; dt, cums (B, S, H), h_in
// (B, nc, H, N, P), d_skip (H,), y (B, S, H, P), all fp32.
int ssd_fwd(int dtype, const void* x, const void* b, const void* c,
            const float* dt, const float* cums, const float* hin,
            const float* dskip, float* y, int B, int S, int H, int G, int P,
            int N, int nc, void* stream) {
  const Dims d{B, S, H, G, P, N, nc, nc > 0 ? S / nc : 0};
  SSD_DISPATCH(fwd, x, b, c, dt, cums, hin, dskip, y, d,
               static_cast<cudaStream_t>(stream));
}

// which 0: the rows kernel writes dc_h (B, S, H, N), dcums_row (B, S, H)
// and dhin (B, nc, H, N, P); which 1: the columns kernel reads dcums_row
// and writes dx (like x), db_h (B, S, H, N), ddt and dcums (B, S, H), and
// dskip_part (B * nc * H, tiles).  Launch 0, then 1, on one stream.
int ssd_bwd(int dtype, int which, const void* x, const void* b,
            const void* c, const float* dt, const float* cums,
            const float* hin, const float* dskip, const float* dy,
            float* dc_h, float* dcums_row, float* dhin, void* dx,
            float* db_h, float* ddt, float* dcums, float* dskip_part, int B,
            int S, int H, int G, int P, int N, int nc, void* stream) {
  const Dims d{B, S, H, G, P, N, nc, nc > 0 ? S / nc : 0};
  SSD_DISPATCH(bwd, x, b, c, dt, cums, hin, dskip, dy, dc_h, dcums_row, dhin,
               dx, db_h, ddt, dcums, dskip_part, which, d,
               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
