// The Mamba2 SSD intra-chunk block for Hopper (sm_90a): forward and
// recompute backward; bf16 x / B / C on the tensor cores (wgmma), fp32
// x / B / C on the CUDA cores.
//
// Replaces the Pallas TPU kernel ssd_chunk_pallas
// (src/repro/kernels/ssd_chunk.py, body _kernel), a forward only, and for
// the backward jax.vjp of the jnp path the JAX model differentiates in
// its place (src/repro/models/mamba2.py::ssd_chunked).  Per chunk of q
// rows and head h it computes, with L[i][j] = exp(cums_i - cums_j) for
// j <= i:
//
//     Y = (C (dt B)^T * L) X + exp(cums) * (C h_in) + d_skip X
//
// Layout is the model's: x and y (B, S, H, P), B and C (B, S, G, N), head
// h reading group h / (H / G), so neither the groups nor the heads are
// copied or transposed in memory; dt and cums (B, S, H) fp32, cums the
// within-chunk cumsum of dt a; h_in (B, nc, H, N, P) fp32, the state
// entering each chunk (the inter-chunk scan stays outside); d_skip (H,).
// q = S / nc, P <= 128 and N <= 128 are masked, never padded in memory.
// Three kernels, 64-row tiles:
//
//   * forward: one block per (chunk, head, 64-row i-tile).  Over the
//     j-tiles <= i it forms the 64 x 64 CB tile, scales it by dt_j and by
//     L on and below the diagonal only (no exp of the positive
//     differences above it, so every output stays finite where the decay
//     overflows), and accumulates (CB * L) X_j; with exp(cums_i)
//     (C_i h_in) and d_skip X_i.  No (q, q) tensor is written.
//   * rows: one block per (chunk, head), over the i-tiles.  For each it
//     recomputes CB and dM = dY X^T against every j-tile <= i, forms
//     dS = dM * L and T = dS * CB, and accumulates dC = dS (dt B) +
//     exp(cums) (dY h_in^T) (per head), the row part of dcums (rowsum T +
//     exp(cums) sum_n C (dY h_in^T)), and over all the chunk's rows
//     dh_in = C^T (exp(cums) dY).
//   * columns: one block per (chunk, head, j-tile), after the rows kernel
//     (it reads the row part of dcums), in the transposed frame (rows j,
//     columns i).  Over the i-tiles >= j it recomputes M^T and dS^T,
//     accumulates dX = M^T dY and d(dt B) = dS^T C, and writes dX +
//     d_skip dY, dB = dt d(dt B) (per head), ddt = sum_n d(dt B) B,
//     dcums = row part - colsum T, and the tile's partial of dd_skip =
//     sum dY X.
// The per-head dB and dC are summed over each group's heads, and the
// dd_skip partials over the tiles, by the wrapper in a fixed order: no
// float atomics, every output repeats bit for bit.
//
// bf16 inputs (the model's path), *_wgmma kernels: one warpgroup (128
// threads) per block, every product a chain of wgmma m64nNk16
// .f32.bf16.bf16 (N = 64, or P / N padded to 128) on the building blocks
// of wgmma.cuh, which flash_attention.cu's bf16 kernels share.  Every
// tile sits in shared memory once in the 128-byte swizzle and a
// descriptor reads it K-major or MN-major, so one tile serves both sides:
// C B^T and dY X^T read both operands K-major as they lie in memory;
// (CB L) X, dS (dt B), M^T dY and dS^T C take the fp32 64 x 64 tile
// from registers as A (the accumulator's layout is the A fragment's) and
// X, B, dY, C MN-major as B; C h_in, dY h_in^T and (e dY)^T C read h_in
// or C MN-major, and the last its A (e dY) MN-major too.  Nothing is
// transposed by a store.  The columns kernel's frame (rows j) makes M^T
// and dS^T accumulator tiles already in registers.  The j-tiles (forward,
// rows: B_j, X_j, dt_j, cums_j) and the i-tiles (columns: C_i, cums_i)
// come through a two-stage ring of cp.async 16-byte copies that write the
// swizzle themselves and zero-fill past the chunk's edge (P or N % 8 != 0:
// plain stores); the columns kernel's next dY_i is loaded into registers
// before the current tile's products and split into the other stage
// after them.  Shared memory: 66 / 99 / 90 KB at P 64, N 128, so three
// forward and two backward blocks an SM.  The decay is exp2 of one
// multiply by ex2.approx (exp_fast).
//
// Arithmetic of the bf16 kernels.  C B^T and dY X^T with a bf16-valued
// dY are bf16 products (exact products, fp32 sums); dt_j and L multiply
// the fp32 accumulator.  Every product with an fp32 operand -- M = CB L,
// h_in, dS dt, dS, exp(cums) dY, and dY itself, which reaches the
// backward as fp32 -- splits that operand into hi = bf16(x) and lo =
// bf16(x - hi), 16 significant bits, and runs two wgmma into one fp32
// accumulator; with both operands fp32 (dY h_in^T, M^T dY) it runs
// hi.hi + hi.lo + lo.hi.  The lo products of dY are skipped for a tile
// whose dY lo half is all zero, which a block-wide vote
// (__syncthreads_or) decides from the data as the tile is staged: that is
// the model's path, where dY is the gradient of y.to(bf16), but it is
// never assumed.  The vote is broadcast from lane 0 (uniform()): under a
// branch ptxas cannot prove warp-uniform, it serializes every wgmma of
// the kernel.  Emulated on the CPU (tests/test_torch_ssd.py, one
// Mamba2 chunk and the ragged shape, dY bf16-valued and fp32) every
// output lies within chip_smoke.py's rule: y at 0.26-0.49 of 1e-5 of its
// largest entry, the bf16 gradients within 0.78-0.94 of one bf16 ulp of
// themselves plus 1e-4 of the largest, the fp32 ones under 0.05 of 1e-4;
// the same operands rounded to bf16 instead put y 166-288x outside.
//
// fp32 inputs (off the model's path; they hold the fp32 smoke model's
// parity runs and stay exact to fp32, which no tensor-core type is):
// 256 threads a block, each owning a 4 x 4 block of every 64 x 64
// product on the CUDA cores, operands widened into shared memory and
// re-staged transposed where a product needs it.
//
// What bounds it on an H100, Mamba2-370m at batch 8 x 1024 (chunk 256,
// 32 heads, P 64, N 128, 48 layers a step, 32,896 live (i, j) pairs a
// chunk and head), priced at the arithmetic that holds the tolerances
// (chip_smoke.py::ssd_bounds): with bf16 inputs C B^T and dY X^T are one
// bf16 product each and every product with an fp32 operand two, all at
// the 989 TFLOP/s bf16 peak.  The forward is 1.25 ms of operations a
// step against 2.01 ms of bytes (x, B, C, dt, cums, h_in read, y written
// in fp32): the bytes bound it.  The backward's seven products are 3.55
// ms of operations against 3.06 ms of bytes: the operations bound it;
// this design recomputes CB and dM in both backward kernels (nine
// products for seven).  fp32 inputs: every product at the 67 TFLOP/s
// fp32 peak.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (no --use_fast_math: expf stays exact to an
//        ulp where it is used; the bf16 kernels' per-entry decay takes
//        ex2.approx, exp_fast below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int BT = 64;            // rows of every tile
constexpr int THREADS = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr int TS = BT + 4;        // row stride of a transposed tile

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
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

// ---- bf16 inputs: wgmma on the tensor cores -----------------------------

// The decay exp(x) as 2^(x log2 e), one multiply and ex2.approx (~2 ulp,
// results below 2^-126 flushed to 0): the per-entry exp of the bf16
// kernels, 64 x 64 a tile; with expf it took 9-15% more time on an H100.
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n"
      : "=f"(y)
      : "f"(x * 1.4426950408889634f));
  return y;
}

// Eight fp32 values at columns [c, c + 8) of a global row (0 past ncols,
// or all 0 when the row is outside); vec4: 16-byte loads where all eight
// are inside.
__device__ __forceinline__ void load8(float (&v)[8],
                                      const float* __restrict__ src,
                                      bool row_in, int c, int ncols,
                                      int vec4) {
  if (vec4 && row_in && c + 8 <= ncols) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    const float4 b = *reinterpret_cast<const float4*>(src + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = row_in && c + k < ncols ? src[k] : 0.f;
  }
}

// Store v as hi = bf16(v) and lo = bf16(v - hi), 16 bytes each, at
// element o of two tiles.  Returns whether a lo is nonzero.
__device__ __forceinline__ bool store8(bf16* hi, bf16* lo, int o,
                                       const float (&v)[8]) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    h[k] = pack_bf16(v[2 * k], v[2 * k + 1]);
    l[k] = pack_lo(v[2 * k], v[2 * k + 1], h[k]);
  }
  *reinterpret_cast<uint4*>(hi + o) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo + o) = make_uint4(l[0], l[1], l[2], l[3]);
  return (l[0] | l[1] | l[2] | l[3]) != 0u;
}

// Split rows [0, nrows) x columns [0, ncols) of an fp32 global tile (row
// stride rs) into swizzled [R][CP] bf16 tiles hi and lo, 0 past either
// edge; with rscale, (rscale[r] v) into shi and slo too.  Returns
// whether this thread wrote a nonzero lo of v.
template <int R, int CP>
__device__ bool stage_split(bf16* hi, bf16* lo, const float* __restrict__ g,
                            long rs, int nrows, int ncols, int vec4,
                            const float* rscale = nullptr,
                            bf16* shi = nullptr, bf16* slo = nullptr) {
  bool any = false;
  for (int i = threadIdx.x; i < R * CP / 8; i += WG) {
    const int r = i / (CP / 8), c = i % (CP / 8) * 8;
    float v[8];
    load8(v, g + r * rs + c, r < nrows, c, ncols, vec4);
    any |= store8(hi, lo, swz<R>(r, c), v);
    if (rscale) {
      const float sc = rscale[r];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] *= sc;
      store8(shi, slo, swz<R>(r, c), v);
    }
  }
  return any;
}

// One thread's chunks of an fp32 [64][CP] tile held in registers between
// its global loads and its split into shared memory (the columns
// kernel's prefetch of the next dY_i).
template <int CP>
struct Prefetch {
  static constexpr int PER = WT * CP / 8 / WG;
  float v[PER][8];
  __device__ __forceinline__ void load(const float* __restrict__ g, long rs,
                                       int nrows, int ncols, int vec4) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * WG;
      const int r = i / (CP / 8), c = i % (CP / 8) * 8;
      load8(v[j], g + r * rs + c, r < nrows, c, ncols, vec4);
    }
  }
  __device__ __forceinline__ bool store(bf16* hi, bf16* lo) const {
    bool any = false;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * WG;
      const int r = i / (CP / 8), c = i % (CP / 8) * 8;
      any |= store8(hi, lo, swz(r, c), v[j]);
    }
    return any;
  }
};

// Per-token fp32 scalars (dt, cums) of rows [j0, j0 + 64) into smem by
// cp.async, 0 past the chunk's edge.
__device__ __forceinline__ void rows_async(float* dst, const float* src,
                                           const Chunk& ch, int j0, int nj,
                                           const Dims& d) {
  if (threadIdx.x < WT) {
    const bool in = threadIdx.x < nj;
    cp_async4(dst + threadIdx.x,
              src + (in ? ch.s(j0 + threadIdx.x, d) : 0), in ? 4 : 0);
  }
}

// The block-wide vote as lane 0 of the warp has it: a value ptxas can see
// is warp-uniform, so wgmma under a branch on it are not serialized.
__device__ __forceinline__ bool uniform(int vote) {
  return __shfl_sync(0xffffffffu, vote, 0) != 0;
}

// Wait for every cp.async group of this thread, then make its shared
// memory writes visible to wgmma.
__device__ __forceinline__ void wait_all_async() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  async_fence();
}

// Accumulator entry e of this thread: row half (e >> 1) & 1, column
// (e >> 2) 8 + c0 + (e & 1).
__device__ __forceinline__ int acc_col(int e, int c0) {
  return (e >> 2) * 8 + c0 + (e & 1);
}

template <int PP, int NP>
__global__ void __launch_bounds__(WG, 3)
ssd_fwd_kernel_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ bm,
                     const bf16* __restrict__ cm,
                     const float* __restrict__ dt,
                     const float* __restrict__ cums,
                     const float* __restrict__ hin,
                     const float* __restrict__ dskip, float* __restrict__ y,
                     Dims d, int vec, int vec4) {
  constexpr int CT = WT * NP, XT = WT * PP, STAGE = CT + XT;
  bf16* cs = smem_tiles();        // [64][NP]  C_i
  bf16* ring = cs + CT;           // stage s: B_j, then X_j, at ring + s STAGE
  bf16* hh = ring;                // [NP][PP]  h_in = hh + hl, before the j loop
  bf16* hl = ring + NP * PP;
  float* ci = reinterpret_cast<float*>(ring + 2 * STAGE);  // [64]
  float* rv = ci + WT;            // stage s: dt_j at rv + 2 s 64, cums_j after
  const int tid = threadIdx.x, ln = tid & 31;
  const int r0 = (tid >> 5) * 16 + (ln >> 2);  // rows r0, r0 + 8
  const int c0 = 2 * (ln & 3);
  const Chunk ch(blockIdx.x, d);
  const int it = gridDim.y - 1 - blockIdx.y;  // the longest tiles first
  const int i0 = it * WT, ni = min(WT, d.q - i0);
  const long brs = (long)d.G * d.N, xrs = (long)d.H * d.P;
  load_tile<NP>(cs, cm + ch.bc(i0, d), brs, ni, d.N, vec);
  cp_async_commit();
  stage_split<NP, PP>(hh, hl, hin + ch.hin(d), d.P, d.N, d.P, vec4);
  if (tid < WT) ci[tid] = tid < ni ? cums[ch.s(i0 + tid, d)] : 0.f;
  wait_all_async();
  __syncthreads();
  // acc = exp(cums_i) (C_i h_in), h_in as hi + lo
  float acc[PP / 2];
  zero(acc);
  keep(acc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < NP / 16; ++kk) {
    mma_ss_t<0, 1>(acc, kmajor(cs, kk), mnmajor<NP>(hh, kk), 1);
    mma_ss_t<0, 1>(acc, kmajor(cs, kk), mnmajor<NP>(hl, kk), 1);
  }
  wg_commit_wait();
  keep(acc);
  float cir[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) cir[i] = ci[r0 + 8 * i];
#pragma unroll
  for (int e = 0; e < PP / 2; ++e) acc[e] *= expf(cir[(e >> 1) & 1]);
  __syncthreads();  // done with h_in: the ring takes its space
  auto load_j = [&](int jt) {
    const int j0 = jt * WT, nj = min(WT, d.q - j0);
    bf16* st = ring + (jt & 1) * STAGE;
    load_tile<NP>(st, bm + ch.bc(j0, d), brs, nj, d.N, vec);
    load_tile<PP>(st + CT, x + ch.x(j0, d), xrs, nj, d.P, vec);
    rows_async(rv + (jt & 1) * 2 * WT, dt, ch, j0, nj, d);
    rows_async(rv + (jt & 1) * 2 * WT + WT, cums, ch, j0, nj, d);
  };
  load_j(0);
  cp_async_commit();
  for (int jt = 0; jt <= it; ++jt) {
    if (jt < it) load_j(jt + 1);
    cp_async_commit();
    tile_ready();
    const bf16* bs = ring + (jt & 1) * STAGE;
    const float* dtj = rv + (jt & 1) * 2 * WT;
    const float* cj = dtj + WT;
    const int j0 = jt * WT, nj = min(WT, d.q - j0);
    float s[32];  // C_i B_j^T
    keep(s);
    wg_fence();
    mma_qk<NP>(s, cs, bs);
    wg_commit_wait();
    keep(s);
    // M = (C B^T) dt_j L, L on and below the diagonal only
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = r0 + 8 * ((e >> 1) & 1), c = acc_col(e, c0);
      const bool live = r < ni && c < nj && j0 + c <= i0 + r;
      s[e] = live ? s[e] * dtj[c] * exp_fast(cir[(e >> 1) & 1] - cj[c])
                   : 0.f;
    }
    uint32_t hi[4][4], lo[4][4];
    split_frags(s, hi, lo);
    keep(acc);
    wg_fence();
    mma_split(acc, hi, lo, bs + CT);
    wg_commit_wait();
    keep(acc);
    __syncthreads();  // every thread is done with this stage
  }
  const float dsk = dskip[ch.h];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= ni) continue;
    const long off = ch.x(i0 + r, d);
#pragma unroll
    for (int e = 2 * i; e < PP / 2; e += 4)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int p = (e >> 2) * 8 + c0 + j;
        if (p < d.P)
          y[off + p] = acc[e + j] + dsk * __bfloat162float(x[off + p]);
      }
  }
}

template <int PP, int NP>
__global__ void __launch_bounds__(WG, 2)
ssd_bwd_rows_kernel_wgmma(const bf16* __restrict__ x,
                          const bf16* __restrict__ bm,
                          const bf16* __restrict__ cm,
                          const float* __restrict__ dt,
                          const float* __restrict__ cums,
                          const float* __restrict__ hin,
                          const float* __restrict__ dy,
                          float* __restrict__ dc_h,
                          float* __restrict__ dcums_row,
                          float* __restrict__ dhin, Dims d, int vec,
                          int vec4) {
  constexpr int CT = WT * NP, XT = WT * PP, STAGE = CT + XT;
  bf16* cs = smem_tiles();        // [64][NP]  C_i
  bf16* dyh = cs + CT;            // [64][PP]  dY_i = dyh + dyl
  bf16* dyl = dyh + XT;
  bf16* eyh = dyl + XT;           // [64][PP]  exp(cums_i) dY_i = eyh + eyl
  bf16* eyl = eyh + XT;
  bf16* ring = eyl + XT;          // stage s: B_j, then X_j, at ring + s STAGE
  bf16* hh = ring;                // [NP][PP]  h_in = hh + hl, before the j loop
  bf16* hl = ring + NP * PP;
  float* ci = reinterpret_cast<float*>(ring + 2 * STAGE);  // [64]
  float* ei = ci + WT;            // [64]  exp(cums_i)
  float* rv = ei + WT;            // stage s: dt_j at rv + 2 s 64, cums_j after
  const int tid = threadIdx.x, ln = tid & 31;
  const int r0 = (tid >> 5) * 16 + (ln >> 2);
  const int c0 = 2 * (ln & 3);
  const Chunk ch(blockIdx.x, d);
  const long brs = (long)d.G * d.N, xrs = (long)d.H * d.P;
  float dht[PP / 64][NP / 2];     // dh_in^T: rows p, columns n
#pragma unroll
  for (int mt = 0; mt < PP / 64; ++mt) zero(dht[mt]);
  const int nt = (d.q + WT - 1) / WT;
  for (int it = 0; it < nt; ++it) {
    const int i0 = it * WT, ni = min(WT, d.q - i0);
    __syncthreads();  // every thread is done with the previous tile
    load_tile<NP>(cs, cm + ch.bc(i0, d), brs, ni, d.N, vec);
    cp_async_commit();
    if (tid < WT) {
      const float c = tid < ni ? cums[ch.s(i0 + tid, d)] : 0.f;
      ci[tid] = c;
      ei[tid] = tid < ni ? expf(c) : 0.f;
    }
    __syncthreads();
    const bool mine = stage_split<WT, PP>(dyh, dyl, dy + ch.x(i0, d), xrs,
                                          ni, d.P, vec4, ei, eyh, eyl);
    stage_split<NP, PP>(hh, hl, hin + ch.hin(d), d.P, d.N, d.P, vec4);
    wait_all_async();
    // the lo products of dY are skipped where no thread wrote a lo != 0
    const bool dlo = uniform(__syncthreads_or(mine));
    // dh_in^T += (e dY_i)^T C_i;  Z = dY_i h_in^T (hi.hi + hi.lo + lo.hi)
    float z[NP / 2];
    zero(z);
    keep(z);
#pragma unroll
    for (int mt = 0; mt < PP / 64; ++mt) keep(dht[mt]);
    wg_fence();
#pragma unroll
    for (int mt = 0; mt < PP / 64; ++mt)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma_ss_t<1, 1>(dht[mt], mnmajor(eyh + mt * WT * 64, kk),
                       mnmajor(cs, kk), 1);
        mma_ss_t<1, 1>(dht[mt], mnmajor(eyl + mt * WT * 64, kk),
                       mnmajor(cs, kk), 1);
      }
#pragma unroll
    for (int kk = 0; kk < PP / 16; ++kk) {
      mma_ss_t<0, 0>(z, kmajor(dyh, kk), kmajor<NP>(hh, kk), 1);
      mma_ss_t<0, 0>(z, kmajor(dyh, kk), kmajor<NP>(hl, kk), 1);
    }
    if (dlo)
#pragma unroll
      for (int kk = 0; kk < PP / 16; ++kk)
        mma_ss_t<0, 0>(z, kmajor(dyl, kk), kmajor<NP>(hh, kk), 1);
    wg_commit_wait();
    keep(z);
#pragma unroll
    for (int mt = 0; mt < PP / 64; ++mt) keep(dht[mt]);
    // dC = e Z (then + dS (dt B)); the row part of dcums: e sum_n C Z
    float cir[2], rowp[2] = {0.f, 0.f}, tp[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) cir[i] = ci[r0 + 8 * i];
#pragma unroll
    for (int e = 0; e < NP / 2; ++e) {
      const int i = (e >> 1) & 1;
      z[e] *= ei[r0 + 8 * i];
      rowp[i] += __bfloat162float(cs[swz(r0 + 8 * i, acc_col(e, c0))]) * z[e];
    }
    __syncthreads();  // done with h_in: the ring takes its space
    auto load_j = [&](int jt) {
      const int j0 = jt * WT, nj = min(WT, d.q - j0);
      bf16* st = ring + (jt & 1) * STAGE;
      load_tile<NP>(st, bm + ch.bc(j0, d), brs, nj, d.N, vec);
      load_tile<PP>(st + CT, x + ch.x(j0, d), xrs, nj, d.P, vec);
      rows_async(rv + (jt & 1) * 2 * WT, dt, ch, j0, nj, d);
      rows_async(rv + (jt & 1) * 2 * WT + WT, cums, ch, j0, nj, d);
    };
    load_j(0);
    cp_async_commit();
    for (int jt = 0; jt <= it; ++jt) {
      if (jt < it) load_j(jt + 1);
      cp_async_commit();
      tile_ready();
      const bf16* bs = ring + (jt & 1) * STAGE;
      const bf16* xs = bs + CT;
      const float* dtj = rv + (jt & 1) * 2 * WT;
      const float* cj = dtj + WT;
      const int j0 = jt * WT, nj = min(WT, d.q - j0);
      float s[32], dm[32];  // C_i B_j^T, dY_i X_j^T
      keep(s);
      keep(dm);
      wg_fence();
      mma_qk<NP>(s, cs, bs);
      mma_qk<PP>(dm, dyh, xs);
      if (dlo)
#pragma unroll
        for (int kk = 0; kk < PP / 16; ++kk)
          mma_ss(dm, kmajor(dyl, kk), kmajor(xs, kk), 1);
      wg_commit_wait();
      keep(s);
      keep(dm);
      // dS = dM L; T = dS CB (CB = (C B^T) dt_j); dm becomes dS dt_j
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1, c = acc_col(e, c0);
        const int r = r0 + 8 * i;
        const bool live = r < ni && c < nj && j0 + c <= i0 + r;
        const float ds = live ? dm[e] * exp_fast(cir[i] - cj[c]) : 0.f;
        tp[i] += ds * (s[e] * dtj[c]);
        dm[e] = ds * dtj[c];
      }
      uint32_t hi[4][4], lo[4][4];
      split_frags(dm, hi, lo);
      keep(z);
      wg_fence();
      mma_split(z, hi, lo, bs);
      wg_commit_wait();
      keep(z);
      __syncthreads();  // every thread is done with this stage
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      const float total = quad_sum(rowp[i]) + quad_sum(tp[i]);
      if (r >= ni) continue;
      const long soff = ch.s(i0 + r, d);
      if ((ln & 3) == 0) dcums_row[soff] = total;
      float* row = dc_h + soff * d.N;
#pragma unroll
      for (int e = 2 * i; e < NP / 2; e += 4)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = (e >> 2) * 8 + c0 + j;
          if (n < d.N) row[n] = z[e + j];
        }
    }
  }
  float* dst = dhin + ch.hin(d);
#pragma unroll
  for (int mt = 0; mt < PP / 64; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = mt * 64 + r0 + 8 * i;
      if (p >= d.P) continue;
#pragma unroll
      for (int e = 2 * i; e < NP / 2; e += 4)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = (e >> 2) * 8 + c0 + j;
          if (n < d.N) dst[(long)n * d.P + p] = dht[mt][e + j];
        }
    }
}

template <int PP, int NP>
__global__ void __launch_bounds__(WG, 2)
ssd_bwd_cols_kernel_wgmma(const bf16* __restrict__ x,
                          const bf16* __restrict__ bm,
                          const bf16* __restrict__ cm,
                          const float* __restrict__ dt,
                          const float* __restrict__ cums,
                          const float* __restrict__ dskip,
                          const float* __restrict__ dy,
                          const float* __restrict__ dcums_row,
                          bf16* __restrict__ dx, float* __restrict__ db_h,
                          float* __restrict__ ddt, float* __restrict__ dcums,
                          float* __restrict__ dskip_part, Dims d, int vec,
                          int vec4) {
  constexpr int CT = WT * NP, XT = WT * PP, STAGE = CT + 2 * XT;
  bf16* bs = smem_tiles();        // [64][NP]  B_j
  bf16* xs = bs + CT;             // [64][PP]  X_j
  bf16* ring = xs + XT;           // stage s: C_i, dY_i hi, dY_i lo
  float* dtj = reinterpret_cast<float*>(ring + 2 * STAGE);  // [64]
  float* cj = dtj + WT;           // [64]
  float* civ = cj + WT;           // stage s: cums_i at civ + s 64
  float* red = civ + 2 * WT;      // [WG / 32]
  const int tid = threadIdx.x, ln = tid & 31;
  const int r0 = (tid >> 5) * 16 + (ln >> 2);  // rows: tokens j0 + r0 + {0, 8}
  const int c0 = 2 * (ln & 3);  // columns: tokens i0 + 8 k + c0 + {0, 1}
  const Chunk ch(blockIdx.x, d);
  const int nt = gridDim.y, jt = blockIdx.y;
  const int j0 = jt * WT, nj = min(WT, d.q - j0);
  const long brs = (long)d.G * d.N, xrs = (long)d.H * d.P;
  auto load_c = [&](int it) {  // C_i and cums_i into stage (it - jt) & 1
    const int i0 = it * WT, ni = min(WT, d.q - i0), st = (it - jt) & 1;
    load_tile<NP>(ring + st * STAGE, cm + ch.bc(i0, d), brs, ni, d.N, vec);
    rows_async(civ + st * WT, cums, ch, i0, ni, d);
  };
  load_tile<NP>(bs, bm + ch.bc(j0, d), brs, nj, d.N, vec);
  load_tile<PP>(xs, x + ch.x(j0, d), xrs, nj, d.P, vec);
  load_c(jt);
  cp_async_commit();
  if (tid < WT) {
    dtj[tid] = tid < nj ? dt[ch.s(j0 + tid, d)] : 0.f;
    cj[tid] = tid < nj ? cums[ch.s(j0 + tid, d)] : 0.f;
  }
  const bool mine = stage_split<WT, PP>(ring + CT, ring + CT + XT,
                                        dy + ch.x(j0, d), xrs, nj, d.P, vec4);
  wait_all_async();
  bool dlo = uniform(__syncthreads_or(mine));
  float dtr[2], cjr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dtr[i] = dtj[r0 + 8 * i];
    cjr[i] = cj[r0 + 8 * i];
  }
  float dxa[PP / 2], dbx[NP / 2], tp[2] = {0.f, 0.f};
  zero(dxa);
  zero(dbx);
  Prefetch<PP> pf;
  for (int it = jt; it < nt; ++it) {
    const int st = (it - jt) & 1;
    const int i0 = it * WT, ni = min(WT, d.q - i0);
    const bool more = it + 1 < nt;
    const bf16* cs = ring + st * STAGE;
    const bf16* dyh = cs + CT;
    const bf16* dyl = dyh + XT;
    const float* ci = civ + st * WT;
    if (more) load_c(it + 1);
    cp_async_commit();
    if (more)  // in flight while this tile's products run
      pf.load(dy + ch.x(i0 + WT, d), xrs, min(WT, d.q - i0 - WT), d.P, vec4);
    // rows j, columns i: CB^T = (B_j C_i^T) dt_j, dM^T = X_j dY_i^T
    float s[32], dm[32];
    keep(s);
    keep(dm);
    wg_fence();
    mma_qk<NP>(s, bs, cs);
    mma_qk<PP>(dm, xs, dyh);
    if (dlo)
#pragma unroll
      for (int kk = 0; kk < PP / 16; ++kk)
        mma_ss(dm, kmajor(xs, kk), kmajor(dyl, kk), 1);
    wg_commit_wait();
    keep(s);
    keep(dm);
    // s becomes M^T = CB^T L^T, dm dS^T = dM^T L^T; T^T = dS^T CB^T
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1, c = acc_col(e, c0);
      const int r = r0 + 8 * i;
      const bool live = r < nj && c < ni && i0 + c >= j0 + r;
      const float l = live ? exp_fast(ci[c] - cjr[i]) : 0.f;
      const float cb = s[e] * dtr[i];
      const float ds = dm[e] * l;
      tp[i] += ds * cb;
      s[e] = cb * l;
      dm[e] = ds;
    }
    // dX += M^T dY_i (hi.hi + lo.hi + hi.lo), d(dt B) += dS^T C_i
    uint32_t mh[4][4], ml[4][4], dh[4][4], dl[4][4];
    split_frags(s, mh, ml);
    split_frags(dm, dh, dl);
    keep(dxa);
    keep(dbx);
    wg_fence();
    mma_split(dxa, mh, ml, dyh);
    if (dlo)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma_rs(dxa, mh[kk], mnmajor(dyl, kk));
    mma_split(dbx, dh, dl, cs);
    wg_commit_wait();
    keep(dxa);
    keep(dbx);
    bool next_lo = false;
    if (more) {  // the other stage, read by no wgmma in flight
      bf16* nx = ring + (st ^ 1) * STAGE + CT;
      next_lo = pf.store(nx, nx + XT);
    }
    wait_all_async();
    dlo = uniform(__syncthreads_or(next_lo));
  }
  const float dsk = dskip[ch.h];
  float skip = 0.f;  // this thread's part of sum dY X over the tile
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const bool row = r < nj;
    const long soff = row ? ch.s(j0 + r, d) : 0;
    const long xoff = row ? ch.x(j0 + r, d) : 0;
#pragma unroll
    for (int e = 2 * i; e < PP / 2; e += 4)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int p = (e >> 2) * 8 + c0 + j;
        if (row && p < d.P) {
          const float gy = dy[xoff + p];
          dx[xoff + p] = __float2bfloat16_rn(dxa[e + j] + dsk * gy);
          skip += gy * __bfloat162float(x[xoff + p]);
        }
      }
    float ddt_part = 0.f;
#pragma unroll
    for (int e = 2 * i; e < NP / 2; e += 4)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = (e >> 2) * 8 + c0 + j;
        if (row && n < d.N) {
          const float v = dbx[e + j];
          db_h[soff * d.N + n] = dtr[i] * v;
          ddt_part += v * __bfloat162float(bs[swz(r, n)]);
        }
      }
    const float colsum = quad_sum(tp[i]);
    ddt_part = quad_sum(ddt_part);
    if (row && (ln & 3) == 0) {
      ddt[soff] = ddt_part;
      dcums[soff] = dcums_row[soff] - colsum;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    skip += __shfl_xor_sync(0xffffffffu, skip, o);
  if (ln == 0) red[tid >> 5] = skip;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int w = 0; w < WG / 32; ++w) t += red[w];
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

// The bf16 kernels' tiles: C / B [64][NP], X / dY [64][PP] bf16, the
// row vectors, and 1024 bytes to align the first tile to the swizzle.
constexpr size_t fwd_smem_wgmma(int pp, int np) {
  return 2 * (BT * np + 2 * (BT * np + BT * pp)) + 4 * 5 * BT + 1024;
}
constexpr size_t rows_smem_wgmma(int pp, int np) {
  return 2 * (BT * np + 4 * BT * pp + 2 * (BT * np + BT * pp)) + 4 * 6 * BT +
         1024;
}
constexpr size_t cols_smem_wgmma(int pp, int np) {
  return 2 * (BT * np + BT * pp + 2 * (BT * np + 2 * BT * pp)) +
         4 * (4 * BT + WG / 32) + 1024;
}

// x / b / c rows in 16-byte copies (P and N multiples of 8); fp32 dY and
// h_in rows in 16-byte loads (P a multiple of 4).
int vec8(const Dims& d) { return d.P % 8 == 0 && d.N % 8 == 0; }
int vec4(const Dims& d) { return d.P % 4 == 0; }

template <typename T, int PP, int NP>
int fwd(const void* x, const void* b, const void* c, const float* dt,
        const float* cums, const float* hin, const float* dskip, float* y,
        Dims d, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    auto kern = ssd_fwd_kernel_wgmma<PP, NP>;
    const size_t smem = fwd_smem_wgmma(PP, NP);
    if (int err = allow_smem(kern, smem)) return err;
    const dim3 grid(d.B * d.nc * d.H, n_tiles(d));
    kern<<<grid, WG, smem, st>>>((const bf16*)x, (const bf16*)b,
                                 (const bf16*)c, dt, cums, hin, dskip, y, d,
                                 vec8(d), vec4(d));
    return (int)cudaGetLastError();
  } else {
    auto kern = ssd_fwd_kernel<T, PP, NP>;
    const size_t smem = fwd_smem(PP, NP);
    if (int err = allow_smem(kern, smem)) return err;
    const dim3 grid(d.B * d.nc * d.H, n_tiles(d));
    kern<<<grid, THREADS, smem, st>>>((const T*)x, (const T*)b, (const T*)c,
                                      dt, cums, hin, dskip, y, d);
    return (int)cudaGetLastError();
  }
}

template <typename T, int PP, int NP>
int bwd(const void* x, const void* b, const void* c, const float* dt,
        const float* cums, const float* hin, const float* dskip,
        const float* dy, float* dc_h, float* dcums_row, float* dhin,
        void* dx, float* db_h, float* ddt, float* dcums, float* dskip_part,
        int which, Dims d, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (which == 0) {
      auto kern = ssd_bwd_rows_kernel_wgmma<PP, NP>;
      const size_t smem = rows_smem_wgmma(PP, NP);
      if (int err = allow_smem(kern, smem)) return err;
      kern<<<d.B * d.nc * d.H, WG, smem, st>>>(
          (const bf16*)x, (const bf16*)b, (const bf16*)c, dt, cums, hin, dy,
          dc_h, dcums_row, dhin, d, vec8(d), vec4(d));
    } else {
      auto kern = ssd_bwd_cols_kernel_wgmma<PP, NP>;
      const size_t smem = cols_smem_wgmma(PP, NP);
      if (int err = allow_smem(kern, smem)) return err;
      const dim3 grid(d.B * d.nc * d.H, n_tiles(d));
      kern<<<grid, WG, smem, st>>>(
          (const bf16*)x, (const bf16*)b, (const bf16*)c, dt, cums, dskip, dy,
          dcums_row, (bf16*)dx, db_h, ddt, dcums, dskip_part, d, vec8(d),
          vec4(d));
    }
    return (int)cudaGetLastError();
  } else {
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
    if (dtype == 1) SSD_DISPATCH_P(FN, bf16, __VA_ARGS__);                  \
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
