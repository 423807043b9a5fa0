// Flash attention for Hopper (sm_90a): forward and recompute backward,
// bf16 inputs on the tensor cores (wgmma), fp32 inputs on the CUDA cores.
//
// Replaces the Pallas TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py), a forward only, and the jnp
// chunked path the JAX model differentiates in its place
// (src/repro/models/attention.py::_sdpa_chunked under jax.checkpoint).
// Layout is the model's: q (B, Sq, H, dh), k / v (B, Sk, KV, dh), all
// contiguous; query head h reads KV head h / (H / KV), so GQA needs no
// copy of k or v; dh <= 128 is not padded in memory (the kernels zero-fill
// and mask it).  Three kernels for each input type, 64-row tiles:
//
//   * forward: one block per (b * H + h, q tile).  It walks the k / v
//     tiles up to the diagonal (causal) or to Sk; the running (m, l, acc)
//     stay in registers in fp32:
//         s = scale (q k^T), -1e30 where k_pos > q_pos (causal)
//         m' = max(m, rowmax s); p = exp(s - m'); corr = exp(m - m')
//         l' = l corr + rowsum p; acc' = acc corr + p v
//     and it writes o = acc / max(l, 1e-30) in the input type and the
//     log-sum-exp m + log l in fp32.
//   * dQ: one block per (b * H + h, q tile).  Its prologue computes
//     D = rowsum(dO * O) and writes it; then over the same k tiles it
//     recomputes P = exp(s - lse), dP = dO v^T, dS = P (dP - D) and
//     accumulates dQ = scale (dS k) in registers.
//   * dK / dV: one block per (b * KV + kv, k tile), after the dQ launch
//     (it reads D).  It loops over the group's query heads and the q tiles
//     at or below the diagonal and accumulates dV = P^T dO and
//     dK = scale (dS^T q) in registers: the group's heads add into one
//     tile inside the block, so there are no float atomics and every
//     output repeats bit for bit.
//
// bf16 inputs (the model's path), *_wgmma kernels: one warpgroup (128
// threads) per 64-row tile, every product a chain of wgmma
// m64nNk16.f32.bf16.bf16.  Each tile sits in shared memory once, as
// DP / 64 column blocks of [64][64] whose 128-byte rows have their
// 16-byte chunks swizzled (chunk c of row r at c ^ (r % 8)).  A
// descriptor reads such a tile K-major (q k^T and dO v^T; k q^T and
// v dO^T in the dK / dV kernel, whose rows are keys) or MN-major (v in
// p v, k in dS k, dO in P^T dO, q in dS^T q), so nothing is transposed
// by a store.  The k / v tiles (forward, dQ) and the q / dO tiles
// (dK / dV) come through a two-stage ring filled by cp.async 16-byte
// copies that write the swizzle themselves and zero-fill past the edge
// (dh % 8 != 0: plain stores), the next tile's copies in flight while
// the current one is used.  The scale multiplies the fp32 accumulator,
// so q enters wgmma as stored for every dh.  S and dP stay in
// registers; P and dS feed the next product from registers as its A
// operand, since the accumulator's layout is the A fragment's.  Only
// the diagonal tile and the tiles at the ragged edges are masked; exp
// is exp2 of one fma (ex2.approx, ~2 ulp, results below 2^-126 flushed
// to 0).  At dh 64 the launch bounds hold the forward and dQ kernels to
// 128 registers (four blocks an SM) and dK / dV to 168 (three); two
// warpgroups a block sharing the streamed tiles measured no faster.
// P and dS are fp32.  Rounded to bf16, as SDPA rounds P, they put bf16
// outputs outside one bf16 ulp of themselves plus 1e-5 of the largest
// entry of the plain version (TOL_FLASH; emulated on the CPU at S 1024,
// dh 64 and S 1000, dh 80 by tests/test_torch_attention.py); so each is
// split into hi = bf16(x) and lo = bf16(x - hi), which carry 16
// significant bits, and each product with it is two wgmma into one fp32
// accumulator.  The other operand (v, k, dO, q) is bf16-exact, so every
// product is the fp32 product to ~2^-17 of each term; softmax, m, l,
// lse, D and dS = P (dP - D) stay fp32.  Measured on an H100
// (chip_smoke.py): every bf16 output within 0.98-1.0 of that per-entry
// bound (the one-ulp term: both sides round an fp32 value once), the
// fp32 lse within 1.5e-7 of its largest entry.
//
// fp32 inputs (off the model's path; they hold the smoke model's parity
// runs and stay exact to fp32, which no tensor-core type is): 256
// threads a block, each thread owning a 4 x 4 block of every 64 x 64
// product on the CUDA cores.  Each product C[r][c] += sum_x A[r][x]
// B[x][c] reads A row-major (its rows are the thread's rows: one float4
// feeds four x, and the eight threads of a 16-byte load phase share the
// row, a broadcast) and B with the output column contiguous (tx * 4: 128
// contiguous bytes a phase), so operands that are the "B" side of one
// product and the "A" side of another are staged twice (transposed and
// row-major); the backward kernels restage the row-major copy into the
// transposed one's space once the transposed one is read, to stay at
// two blocks an SM.
//
// What bounds it on an H100: operations.  Causal GPT-2 117M (B 8, H 12,
// S 1024, dh 64, 524,800 live pairs a head) costs 6.449 GFLOP a product
// a layer.  With bf16 inputs q k^T and dO v^T are one bf16 product each
// and every product with P or dS two, at 989 TFLOP/s: the forward is
// three products' worth, the backward's five distinct products eight, so
// the 12 layers are bound at 0.2347 ms forward and 0.6260 ms backward
// (bytes: 0.18 / 0.36 ms).  This design recomputes S and dP in both
// backward kernels (ten products' worth).  fp32 inputs run every
// product at the fp32 peak, 67 TFLOP/s.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (no --use_fast_math: expf and logf stay exact
//        to an ulp).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int BT = 64;            // rows of every q and k tile
constexpr int THREADS = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr int TS = BT + 4;        // row stride of a transposed tile
constexpr float NEG_INF = -1e30f; // the reference's mask value

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Stage rows [0, nrows) x columns [0, dh) of a global tile (row stride rs
// elements), times scale, as fp32 into a row-major [BT][DP] tile and / or
// a transposed [DP][TS] tile; rows and columns past the edge are 0.
template <typename T, int DP>
__device__ void stage(const T* __restrict__ g, long rs, int nrows, int dh,
                      float scale, float* rowm, float* tr) {
  for (int i = threadIdx.x; i < BT * DP; i += THREADS) {
    const int r = i / DP, c = i % DP;
    float x = 0.f;
    if (r < nrows && c < dh) x = to_f(g[r * rs + c]) * scale;
    if (rowm) rowm[r * DP + c] = x;
    if (tr) tr[c * TS + r] = x;
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

// Reductions over the 16 threads of a row group (lanes 0-15 or 16-31).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// k tiles a causal q tile [q0, q0 + 64) reads: those starting at or below
// its last row.
__device__ __forceinline__ int k_tiles(int q0, int sq, int sk, int causal) {
  const int nk = (sk + BT - 1) / BT;
  return causal ? min(nk, (min(q0 + BT, sq) - 1) / BT + 1) : nk;
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int KV, int sq, int sk,
                 int dh, float scale, int causal) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                 // [BT][DP]  q * scale
  float* kT = qs + BT * DP;       // [DP][TS]
  float* vs = kT + DP * TS;       // [BT][DP]
  float* ps = vs + BT * DP;       // [BT][BT]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / KV);
  // the longest causal tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BT;
  const long qrs = (long)H * dh, krs = (long)KV * dh;
  stage<T, DP>(q + ((long)b * sq + q0) * qrs + (long)h * dh, qrs,
               min(BT, sq - q0), dh, scale, qs, nullptr);
  float m[4], l[4], acc[4][DP / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) acc[i][c] = 0.f;
  }
  const int last = k_tiles(q0, sq, sk, causal);
  for (int kt = 0; kt < last; ++kt) {
    const int k0 = kt * BT;
    const long off = ((long)b * sk + k0) * krs + (long)kvh * dh;
    __syncthreads();
    stage<T, DP>(k + off, krs, min(BT, sk - k0), dh, 1.f, nullptr, kT);
    stage<T, DP>(v + off, krs, min(BT, sk - k0), dh, 1.f, vs, nullptr);
    __syncthreads();
    float s[4][4] = {};
    mma<DP, DP, TS, 1>(s, qs, kT, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        if (kp >= sk) s[i][j] = -INFINITY;           // past the edge
        else if (causal && kp > qp) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
#pragma unroll
      for (int c = 0; c < DP / 16; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    put4x4(ps, s, ty, tx);
    __syncthreads();
    mma<BT, BT, DP, DP / 64>(acc, ps, vs, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + ((long)b * sq + r) * qrs + (long)h * dh;
#pragma unroll
    for (int g = 0; g < DP / 64; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = g * 64 + tx * 4 + j;
        if (c < dh) orow[c] = from_f<T>(acc[i][g * 4 + j] / den);
      }
    if (tx == 0) lse[((long)b * H + h) * sq + r] = m[i] + logf(l[i]);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dsum,
                    T* __restrict__ dq, int H, int KV, int sq, int sk,
                    int dh, float scale, int causal) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                 // [BT][DP]  q * scale
  float* dos = qs + BT * DP;      // [BT][DP]  dO
  float* kT = dos + BT * DP;      // [DP][TS]  k, then k row-major [BT][DP]
  float* vT = kT + DP * TS;       // [DP][TS]
  float* ds = vT + DP * TS;       // [BT][BT]
  float* lse_s = ds + BT * BT;    // [BT]
  float* d_s = lse_s + BT;        // [BT]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BT;
  const long qrs = (long)H * dh, krs = (long)KV * dh;
  const long qoff = ((long)b * sq + q0) * qrs + (long)h * dh;
  const int nq = min(BT, sq - q0);
  stage<T, DP>(q + qoff, qrs, nq, dh, scale, qs, nullptr);
  stage<T, DP>(dout + qoff, qrs, nq, dh, 1.f, dos, nullptr);
  __syncthreads();
  {  // D = rowsum(dO * O): four threads a row
    const int r = tid >> 2, part = tid & 3;
    float d = 0.f;
    if (r < nq)
      for (int c = part; c < dh; c += 4)
        d += dos[r * DP + c] * to_f(o[qoff + r * qrs + c]);
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (part == 0) {
      const long at = ((long)b * H + h) * sq + q0 + r;
      d_s[r] = r < nq ? d : 0.f;
      lse_s[r] = r < nq ? lse[at] : 0.f;
      if (r < nq) dsum[at] = d;
    }
  }
  float acc[4][DP / 16] = {};
  const int last = k_tiles(q0, sq, sk, causal);
  for (int kt = 0; kt < last; ++kt) {
    const int k0 = kt * BT, nk = min(BT, sk - k0);
    const long off = ((long)b * sk + k0) * krs + (long)kvh * dh;
    __syncthreads();
    stage<T, DP>(k + off, krs, nk, dh, 1.f, nullptr, kT);
    stage<T, DP>(v + off, krs, nk, dh, 1.f, nullptr, vT);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mma<DP, DP, TS, 1>(s, qs, kT, ty, tx);
    mma<DP, DP, TS, 1>(dp, dos, vT, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        const bool live = r < nq && kp < sk && !(causal && kp > q0 + r);
        const float p = live ? expf(s[i][j] - lse_s[r]) : 0.f;
        s[i][j] = p * (dp[i][j] - d_s[r]);
      }
    }
    __syncthreads();  // every thread is done with kT
    stage<T, DP>(k + off, krs, nk, dh, 1.f, kT, nullptr);
    put4x4(ds, s, ty, tx);
    __syncthreads();
    mma<BT, BT, DP, DP / 64>(acc, ds, kT, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nq) continue;
    T* row = dq + qoff + r * qrs;
#pragma unroll
    for (int g = 0; g < DP / 64; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = g * 64 + tx * 4 + j;
        if (c < dh) row[c] = from_f<T>(acc[i][g * 4 + j] * scale);
      }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int KV, int sq, int sk,
                      int dh, float scale, int causal) {
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                 // [BT][DP]
  float* vs = ks + BT * DP;       // [BT][DP]
  float* qT = vs + BT * DP;       // [DP][TS]  q * scale, then row-major
  float* doT = qT + DP * TS;      // [DP][TS]  dO, then row-major
  float* buf = doT + DP * TS;     // [BT][BT]  P^T, then dS^T
  float* lse_s = buf + BT * BT;   // [BT]
  float* d_s = lse_s + BT;        // [BT]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bkv = blockIdx.x, b = bkv / KV, kvh = bkv % KV;
  const int groups = H / KV;
  const int k0 = blockIdx.y * BT, nk = min(BT, sk - k0);
  const long qrs = (long)H * dh, krs = (long)KV * dh;
  const long koff = ((long)b * sk + k0) * krs + (long)kvh * dh;
  stage<T, DP>(k + koff, krs, nk, dh, 1.f, ks, nullptr);
  stage<T, DP>(v + koff, krs, nk, dh, 1.f, vs, nullptr);
  float dka[4][DP / 16] = {}, dva[4][DP / 16] = {};
  const int nqt = (sq + BT - 1) / BT;
  for (int g = 0; g < groups; ++g) {
    const int h = kvh * groups + g;
    for (int qt = causal ? k0 / BT : 0; qt < nqt; ++qt) {
      const int q0 = qt * BT, nq = min(BT, sq - q0);
      const long qoff = ((long)b * sq + q0) * qrs + (long)h * dh;
      __syncthreads();
      stage<T, DP>(q + qoff, qrs, nq, dh, scale, nullptr, qT);
      stage<T, DP>(dout + qoff, qrs, nq, dh, 1.f, nullptr, doT);
      if (tid < BT) {
        const long at = ((long)b * H + h) * sq + q0 + tid;
        lse_s[tid] = tid < nq ? lse[at] : 0.f;
        d_s[tid] = tid < nq ? dsum[at] : 0.f;
      }
      __syncthreads();
      // rows: keys k0 + ty * 4 + i; columns: queries q0 + tx * 4 + j
      float s[4][4] = {}, dp[4][4] = {};
      mma<DP, DP, TS, 1>(s, ks, qT, ty, tx);
      mma<DP, DP, TS, 1>(dp, vs, doT, ty, tx);
      float ds[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx * 4 + j;
          const bool live = c < nq && kp < sk && !(causal && kp > q0 + c);
          const float p = live ? expf(s[i][j] - lse_s[c]) : 0.f;
          s[i][j] = p;
          ds[i][j] = p * (dp[i][j] - d_s[c]);
        }
      }
      __syncthreads();  // every thread is done with qT and doT
      stage<T, DP>(q + qoff, qrs, nq, dh, scale, qT, nullptr);
      stage<T, DP>(dout + qoff, qrs, nq, dh, 1.f, doT, nullptr);
      put4x4(buf, s, ty, tx);
      __syncthreads();
      mma<BT, BT, DP, DP / 64>(dva, buf, doT, ty, tx);
      __syncthreads();
      put4x4(buf, ds, ty, tx);
      __syncthreads();
      mma<BT, BT, DP, DP / 64>(dka, buf, qT, ty, tx);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nk) continue;
    T* krow = dk + koff + r * krs;
    T* vrow = dv + koff + r * krs;
#pragma unroll
    for (int g = 0; g < DP / 64; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = g * 64 + tx * 4 + j;
        if (c < dh) {
          krow[c] = from_f<T>(dka[i][g * 4 + j]);
          vrow[c] = from_f<T>(dva[i][g * 4 + j]);
        }
      }
  }
}

// ---- bf16 inputs: wgmma on the tensor cores -----------------------------
// (the building blocks are in wgmma.cuh)

constexpr float LOG2E = 1.4426950408889634f;

// 2^x, flushing results below 2^-126 to 0 (a p that small adds nothing
// to a row sum of at least 1); ~2 ulp.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The launch bounds ask for 4 (forward, dQ) and 3 (dK / dV) blocks an SM
// at the GPT-2 head width (dh 64), where the registers, not shared
// memory, set how many fit.

template <int DP>
__global__ void __launch_bounds__(WG, DP == 64 ? 4 : 1)
flash_fwd_kernel_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       float* __restrict__ lse, int H, int KV, int sq,
                       int sk, int dh, float scale, int causal, int vec) {
  constexpr int TILE = BT * DP;
  bf16* qs = smem_tiles();        // [64][DP]
  bf16* kvs = qs + TILE;          // stage s: k at kvs + 2 s TILE, v after it
  const int tid = threadIdx.x, ln = tid & 31;
  const int r0 = (tid >> 5) * 16 + (ln >> 2);  // rows r0, r0 + 8
  const int c0 = 2 * (ln & 3);                 // columns 8 j + c0 + {0, 1}
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / KV);
  // the longest causal tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BT;
  const long qrs = (long)H * dh, krs = (long)KV * dh;
  const long qoff = ((long)b * sq + q0) * qrs + (long)h * dh;
  const int last = k_tiles(q0, sq, sk, causal);
  auto load_kv = [&](int kt) {
    const int k0 = kt * BT;
    const long off = ((long)b * sk + k0) * krs + (long)kvh * dh;
    bf16* st = kvs + (kt & 1) * 2 * TILE;
    load_tile<DP>(st, k + off, krs, min(BT, sk - k0), dh, vec);
    load_tile<DP>(st + TILE, v + off, krs, min(BT, sk - k0), dh, vec);
  };
  load_tile<DP>(qs, q + qoff, qrs, min(BT, sq - q0), dh, vec);
  load_kv(0);
  cp_async_commit();
  const float sl2 = scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, acc[DP / 2];
  zero(acc);
  for (int kt = 0; kt < last; ++kt) {
    if (kt + 1 < last) load_kv(kt + 1);
    cp_async_commit();
    tile_ready();
    const bf16* ks = kvs + (kt & 1) * 2 * TILE;
    float s[32];  // q k^T, unscaled
    keep(s);
    wg_fence();
    mma_qk<DP>(s, qs, ks);
    wg_commit_wait();
    keep(s);
    const int k0 = kt * BT;
    // only the diagonal tile and the tile at Sk have masked entries
    // (-inf here, -1e30 in the reference: both give p = 0, as key 0 is
    // live in every row)
    if (k0 + BT > sk || (causal && k0 + BT - 1 > q0)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int kp = k0 + (e >> 2) * 8 + c0 + (e & 1);
        if (kp >= sk || (causal && kp > q0 + r0 + 8 * ((e >> 1) & 1)))
          s[e] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY}, corr[2], mb[2];
#pragma unroll
    for (int e = 0; e < 32; ++e)
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // scale > 0, so the max of the scaled scores is the scaled max
      const float m_new = fmaxf(m[i], quad_max(mx[i]) * scale);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
      mb[i] = m_new * LOG2E;
      l[i] *= corr[i];    // this thread's share of the row sum
    }
    // p = exp(scale s - m) as exp2(s (scale log2 e) - m log2 e)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      s[e] = exp2_ftz(fmaf(s[e], sl2, -mb[(e >> 1) & 1]));
      l[(e >> 1) & 1] += s[e];
    }
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) acc[e] *= corr[(e >> 1) & 1];
    uint32_t hi[4][4], lo[4][4];
    split_frags(s, hi, lo);
    keep(acc);
    wg_fence();
    mma_split(acc, hi, lo, ks + TILE);
    wg_commit_wait();
    keep(acc);
    __syncthreads();  // every thread is done with this stage
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + r0 + 8 * i;
    const float lsum = quad_sum(l[i]);
    if (r >= sq) continue;
    const float den = fmaxf(lsum, 1e-30f);
    bf16* orow = o + ((long)b * sq + r) * qrs + (long)h * dh;
#pragma unroll
    for (int e = 2 * i; e < DP / 2; e += 4)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = (e >> 2) * 8 + c0 + j;
        if (c < dh) orow[c] = __float2bfloat16_rn(acc[e + j] / den);
      }
    if ((ln & 3) == 0) lse[((long)b * H + h) * sq + r] = m[i] + logf(lsum);
  }
}

template <int DP>
__global__ void __launch_bounds__(WG, DP == 64 ? 4 : 1)
flash_bwd_dq_kernel_wgmma(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ o,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ dsum, bf16* __restrict__ dq,
                          int H, int KV, int sq, int sk, int dh, float scale,
                          int causal, int vec) {
  constexpr int TILE = BT * DP;
  bf16* qs = smem_tiles();        // [64][DP]
  bf16* dos = qs + TILE;          // [64][DP]
  bf16* kvs = dos + TILE;         // stage s: k at kvs + 2 s TILE, v after it
  float* d_s = reinterpret_cast<float*>(kvs + 4 * TILE);  // [64]
  const int tid = threadIdx.x, ln = tid & 31;
  const int r0 = (tid >> 5) * 16 + (ln >> 2);
  const int c0 = 2 * (ln & 3);
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BT;
  const long qrs = (long)H * dh, krs = (long)KV * dh;
  const long qoff = ((long)b * sq + q0) * qrs + (long)h * dh;
  const int nq = min(BT, sq - q0);
  const int last = k_tiles(q0, sq, sk, causal);
  auto load_kv = [&](int kt) {
    const int k0 = kt * BT;
    const long off = ((long)b * sk + k0) * krs + (long)kvh * dh;
    bf16* st = kvs + (kt & 1) * 2 * TILE;
    load_tile<DP>(st, k + off, krs, min(BT, sk - k0), dh, vec);
    load_tile<DP>(st + TILE, v + off, krs, min(BT, sk - k0), dh, vec);
  };
  load_tile<DP>(qs, q + qoff, qrs, nq, dh, vec);
  load_tile<DP>(dos, dout + qoff, qrs, nq, dh, vec);
  load_kv(0);
  cp_async_commit();
  {  // D = rowsum(dO * O): two threads a row
    const int r = tid >> 1, part = tid & 1;
    const bf16* orow = o + qoff + r * qrs;
    const bf16* drow = dout + qoff + r * qrs;
    float d = 0.f;
    if (r < nq && vec) {  // 16-byte loads, eight columns each
      for (int c = part * 8; c < dh; c += 16) {
        const uint4 a = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 g = *reinterpret_cast<const uint4*>(drow + c);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 x = __bfloat1622float2(a2[j]);
          const float2 y = __bfloat1622float2(g2[j]);
          d += x.x * y.x;
          d += x.y * y.y;
        }
      }
    } else if (r < nq) {
      for (int c = part; c < dh; c += 2)
        d += __bfloat162float(drow[c]) * __bfloat162float(orow[c]);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (part == 0) {
      d_s[r] = r < nq ? d : 0.f;
      if (r < nq) dsum[((long)b * H + h) * sq + q0 + r] = d;
    }
  }
  __syncthreads();
  const float sl2 = scale * LOG2E;
  float lse2[2], d_r[2];  // log2 e lse and D of rows r0, r0 + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    d_r[i] = d_s[r];
    lse2[i] = r < nq ? lse[((long)b * H + h) * sq + q0 + r] * LOG2E : 0.f;
  }
  float acc[DP / 2];
  zero(acc);
  for (int kt = 0; kt < last; ++kt) {
    if (kt + 1 < last) load_kv(kt + 1);
    cp_async_commit();
    tile_ready();
    const bf16* ks = kvs + (kt & 1) * 2 * TILE;
    float s[32], dp[32];  // q k^T (unscaled), dO v^T
    keep(s);
    keep(dp);
    wg_fence();
    mma_qk<DP>(s, qs, ks);
    mma_qk<DP>(dp, dos, ks + TILE);
    wg_commit_wait();
    keep(s);
    keep(dp);
    const int k0 = kt * BT;
    // P = exp(scale s - lse) as exp2(s (scale log2 e) - lse log2 e)
#pragma unroll
    for (int e = 0; e < 32; ++e)
      s[e] = exp2_ftz(fmaf(s[e], sl2, -lse2[(e >> 1) & 1]));
    if (nq < BT || k0 + BT > sk || (causal && k0 + BT - 1 > q0)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int kp = k0 + (e >> 2) * 8 + c0 + (e & 1);
        const int r = r0 + 8 * ((e >> 1) & 1);
        if (r >= nq || kp >= sk || (causal && kp > q0 + r)) s[e] = 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] *= dp[e] - d_r[(e >> 1) & 1];  // dS
    uint32_t hi[4][4], lo[4][4];
    split_frags(s, hi, lo);
    keep(acc);
    wg_fence();
    mma_split(acc, hi, lo, ks);
    wg_commit_wait();
    keep(acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= nq) continue;
    bf16* row = dq + qoff + r * qrs;
#pragma unroll
    for (int e = 2 * i; e < DP / 2; e += 4)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = (e >> 2) * 8 + c0 + j;
        if (c < dh) row[c] = __float2bfloat16_rn(acc[e + j] * scale);
      }
  }
}

template <int DP>
__global__ void __launch_bounds__(WG, DP == 64 ? 3 : 1)
flash_bwd_dkdv_kernel_wgmma(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ dsum,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int H, int KV, int sq, int sk, int dh,
                            float scale, int causal, int vec) {
  constexpr int TILE = BT * DP;
  bf16* ks = smem_tiles();        // [64][DP]
  bf16* vs = ks + TILE;           // [64][DP]
  bf16* qds = vs + TILE;          // stage s: q at qds + 2 s TILE, dO after it
  // stage s: lse of its 64 queries at rows + 2 s 64, D after them
  float* rows = reinterpret_cast<float*>(qds + 4 * TILE);
  const int tid = threadIdx.x, ln = tid & 31;
  const int r0 = (tid >> 5) * 16 + (ln >> 2);  // keys k0 + r0 + {0, 8}
  const int c0 = 2 * (ln & 3);  // queries q0 + 8 j + c0 + {0, 1}
  const int bkv = blockIdx.x, b = bkv / KV, kvh = bkv % KV;
  const int groups = H / KV;
  const int k0 = blockIdx.y * BT, nk = min(BT, sk - k0);
  const long qrs = (long)H * dh, krs = (long)KV * dh;
  const long koff = ((long)b * sk + k0) * krs + (long)kvh * dh;
  // (query head, q tile) pairs: the group's heads, each over the q tiles
  // at or below the diagonal
  const int nqt = (sq + BT - 1) / BT, qt0 = causal ? k0 / BT : 0;
  const int per = max(nqt - qt0, 0), n = groups * per;
  auto load_q = [&](int it) {
    const int h = kvh * groups + it / per, q0 = (qt0 + it % per) * BT;
    const int nq = min(BT, sq - q0);
    const long qoff = ((long)b * sq + q0) * qrs + (long)h * dh;
    bf16* st = qds + (it & 1) * 2 * TILE;
    load_tile<DP>(st, q + qoff, qrs, nq, dh, vec);
    load_tile<DP>(st + TILE, dout + qoff, qrs, nq, dh, vec);
    float* rs = rows + (it & 1) * 2 * BT;
    if (tid < BT) {
      const long at = ((long)b * H + h) * sq + q0 + tid;
      const bool in = tid < nq;
      cp_async4(rs + tid, in ? lse + at : lse, in ? 4 : 0);
      cp_async4(rs + BT + tid, in ? dsum + at : dsum, in ? 4 : 0);
    }
  };
  load_tile<DP>(ks, k + koff, krs, nk, dh, vec);
  load_tile<DP>(vs, v + koff, krs, nk, dh, vec);
  if (n > 0) load_q(0);
  cp_async_commit();
  const float sl2 = scale * LOG2E;
  float dka[DP / 2], dva[DP / 2];
  zero(dka);
  zero(dva);
  for (int it = 0; it < n; ++it) {
    if (it + 1 < n) load_q(it + 1);
    cp_async_commit();
    tile_ready();
    const bf16* qs = qds + (it & 1) * 2 * TILE;
    const bf16* dos = qs + TILE;
    const float* lse_s = rows + (it & 1) * 2 * BT;
    const float* d_s = lse_s + BT;
    const int q0 = (qt0 + it % per) * BT;
    // rows: keys; columns: queries
    float s[32], dp[32];  // k q^T (unscaled), v dO^T
    keep(s);
    keep(dp);
    wg_fence();
    mma_qk<DP>(s, ks, qs);
    mma_qk<DP>(dp, vs, dos);
    wg_commit_wait();
    keep(s);
    keep(dp);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int c = (e >> 2) * 8 + c0 + (e & 1);
      s[e] = exp2_ftz(fmaf(s[e], sl2, -lse_s[c] * LOG2E));
    }
    if (q0 + BT > sq || nk < BT || (causal && k0 + BT - 1 > q0)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int kp = k0 + r0 + 8 * ((e >> 1) & 1);
        const int qp = q0 + (e >> 2) * 8 + c0 + (e & 1);
        if (qp >= sq || kp >= sk || (causal && kp > qp)) s[e] = 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < 32; ++e)
      dp[e] = s[e] * (dp[e] - d_s[(e >> 2) * 8 + c0 + (e & 1)]);  // dS
    uint32_t phi[4][4], plo[4][4], dhi[4][4], dlo[4][4];
    split_frags(s, phi, plo);
    split_frags(dp, dhi, dlo);
    keep(dva);
    keep(dka);
    wg_fence();
    mma_split(dva, phi, plo, dos);
    mma_split(dka, dhi, dlo, qs);
    wg_commit_wait();
    keep(dva);
    keep(dka);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= nk) continue;
    bf16* krow = dk + koff + r * krs;
    bf16* vrow = dv + koff + r * krs;
#pragma unroll
    for (int e = 2 * i; e < DP / 2; e += 4)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = (e >> 2) * 8 + c0 + j;
        if (c < dh) {
          krow[c] = __float2bfloat16_rn(dka[e + j] * scale);
          vrow[c] = __float2bfloat16_rn(dva[e + j]);
        }
      }
  }
}

constexpr size_t fwd_smem(int dp) {
  return sizeof(float) * (2 * BT * dp + dp * TS + BT * BT);
}
constexpr size_t dq_smem(int dp) {
  return sizeof(float) * (2 * BT * dp + 2 * dp * TS + BT * BT + 2 * BT);
}
constexpr size_t dkdv_smem(int dp) { return dq_smem(dp); }

// Dynamic shared memory above 48 KB has to be asked for per kernel.
template <typename K>
int allow_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Dims {
  int B, H, KV, sq, sk, dh;
  float scale;
  int causal;
};

template <typename T, int DP>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        Dims d, cudaStream_t st) {
  auto kern = flash_fwd_kernel<T, DP>;
  const size_t smem = fwd_smem(DP);
  if (int err = allow_smem(kern, smem)) return err;
  const dim3 grid(d.B * d.H, (d.sq + BT - 1) / BT);
  kern<<<grid, THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, d.H, d.KV, d.sq,
      d.sk, d.dh, d.scale, d.causal);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int bwd_dq(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dsum, void* dq, Dims d,
           cudaStream_t st) {
  auto kern = flash_bwd_dq_kernel<T, DP>;
  const size_t smem = dq_smem(DP);
  if (int err = allow_smem(kern, smem)) return err;
  const dim3 grid(d.B * d.H, (d.sq + BT - 1) / BT);
  kern<<<grid, THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout,
      lse, dsum, (T*)dq, d.H, d.KV, d.sq, d.sk, d.dh, d.scale, d.causal);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* dsum, void* dk, void* dv, Dims d,
             cudaStream_t st) {
  auto kern = flash_bwd_dkdv_kernel<T, DP>;
  const size_t smem = dkdv_smem(DP);
  if (int err = allow_smem(kern, smem)) return err;
  const dim3 grid(d.B * d.KV, (d.sk + BT - 1) / BT);
  kern<<<grid, THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum,
      (T*)dk, (T*)dv, d.H, d.KV, d.sq, d.sk, d.dh, d.scale, d.causal);
  return (int)cudaGetLastError();
}

// bf16: five ([64][DP] q, two stages of k and v) or six tiles, the row
// vectors, and 1024 bytes to align the first tile to the swizzle.
template <int DP>
int fwd_wgmma(const void* q, const void* k, const void* v, void* o,
              float* lse, Dims d, cudaStream_t st) {
  auto kern = flash_fwd_kernel_wgmma<DP>;
  const size_t smem = 5 * BT * DP * sizeof(bf16) + 1024;
  if (int err = allow_smem(kern, smem)) return err;
  const dim3 grid(d.B * d.H, (d.sq + BT - 1) / BT);
  kern<<<grid, WG, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, d.H,
      d.KV, d.sq, d.sk, d.dh, d.scale, d.causal, d.dh % 8 == 0);
  return (int)cudaGetLastError();
}

template <int DP>
int bwd_dq_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* dsum, void* dq,
                 Dims d, cudaStream_t st) {
  auto kern = flash_bwd_dq_kernel_wgmma<DP>;
  const size_t smem = 6 * BT * DP * sizeof(bf16) + BT * sizeof(float) + 1024;
  if (int err = allow_smem(kern, smem)) return err;
  const dim3 grid(d.B * d.H, (d.sq + BT - 1) / BT);
  kern<<<grid, WG, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
      (const bf16*)dout, lse, dsum, (bf16*)dq, d.H, d.KV, d.sq, d.sk, d.dh,
      d.scale, d.causal, d.dh % 8 == 0);
  return (int)cudaGetLastError();
}

template <int DP>
int bwd_dkdv_wgmma(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* dsum,
                   void* dk, void* dv, Dims d, cudaStream_t st) {
  auto kern = flash_bwd_dkdv_kernel_wgmma<DP>;
  const size_t smem =
      6 * BT * DP * sizeof(bf16) + 4 * BT * sizeof(float) + 1024;
  if (int err = allow_smem(kern, smem)) return err;
  const dim3 grid(d.B * d.KV, (d.sk + BT - 1) / BT);
  kern<<<grid, WG, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
      dsum, (bf16*)dk, (bf16*)dv, d.H, d.KV, d.sq, d.sk, d.dh, d.scale,
      d.causal, d.dh % 8 == 0);
  return (int)cudaGetLastError();
}

// Instantiate a launcher for (dtype, dh): dtype 0 fp32 (the SIMT
// kernels), 1 bf16 (the wgmma kernels); dh <= 64 takes the 64-wide
// tiles, dh <= 128 the 128-wide.  Anything else is refused with
// cudaErrorInvalidValue (the wrapper checks first).
#define FLASH_DISPATCH(FN, ...)                                     \
  do {                                                              \
    if (d.dh < 1 || d.dh > 128) return (int)cudaErrorInvalidValue;  \
    if (dtype == 0)                                                 \
      return d.dh <= 64 ? FN<float, 64>(__VA_ARGS__)                \
                        : FN<float, 128>(__VA_ARGS__);              \
    if (dtype == 1)                                                 \
      return d.dh <= 64 ? FN##_wgmma<64>(__VA_ARGS__)               \
                        : FN##_wgmma<128>(__VA_ARGS__);             \
    return (int)cudaErrorInvalidValue;                              \
  } while (0)

}  // namespace

extern "C" {

// q (B, sq, H, dh), k / v (B, sk, KV, dh), o like q, lse (B, H, sq) fp32.
int flash_fwd(int dtype, const void* q, const void* k, const void* v,
              void* o, float* lse, int B, int H, int KV, int sq, int sk,
              int dh, float scale, int causal, void* stream) {
  const Dims d{B, H, KV, sq, sk, dh, scale, causal};
  FLASH_DISPATCH(fwd, q, k, v, o, lse, d, static_cast<cudaStream_t>(stream));
}

// Also writes dsum = rowsum(dO * O) (B, H, sq) fp32 for flash_bwd_dkdv.
int flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, const float* lse,
                 float* dsum, void* dq, int B, int H, int KV, int sq, int sk,
                 int dh, float scale, int causal, void* stream) {
  const Dims d{B, H, KV, sq, sk, dh, scale, causal};
  FLASH_DISPATCH(bwd_dq, q, k, v, o, dout, lse, dsum, dq, d,
                 static_cast<cudaStream_t>(stream));
}

int flash_bwd_dkdv(int dtype, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* dsum,
                   void* dk, void* dv, int B, int H, int KV, int sq, int sk,
                   int dh, float scale, int causal, void* stream) {
  const Dims d{B, H, KV, sq, sk, dh, scale, causal};
  FLASH_DISPATCH(bwd_dkdv, q, k, v, dout, lse, dsum, dk, dv, d,
                 static_cast<cudaStream_t>(stream));
}

}  // extern "C"
