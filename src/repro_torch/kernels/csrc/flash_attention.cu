// Flash attention for Hopper (sm_90a): forward and recompute backward,
// fp32 scores and products on the CUDA cores, fp32 or bf16 q / k / v.
//
// Replaces the Pallas TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py), a forward only, and the jnp
// chunked path the JAX model differentiates in its place
// (src/repro/models/attention.py::_sdpa_chunked under jax.checkpoint).
// Layout is the model's: q (B, Sq, H, dh), k / v (B, Sk, KV, dh), all
// contiguous; query head h reads KV head h / (H / KV), so GQA needs no
// copy of k or v; dh is not padded in memory (dh <= 128, masked in the
// kernels).  Three kernels, 64-row tiles, 256 threads a block, each thread
// owning a 4 x 4 block of every 64 x 64 product:
//
//   * flash_fwd_kernel: one block per (b * H + h, q tile).  It stages its
//     q tile (times scale) once, then walks the k / v tiles up to the
//     diagonal (causal) or to Sk, staging each in shared memory; the
//     running (m, l, acc) stay in registers in fp32:
//         s = (q scale) k^T, -1e30 where k_pos > q_pos (causal)
//         m' = max(m, rowmax s); p = exp(s - m'); corr = exp(m - m')
//         l' = l corr + rowsum p; acc' = acc corr + p v
//     and it writes o = acc / max(l, 1e-30) in the input type and the
//     log-sum-exp m + log l in fp32.
//   * flash_bwd_dq_kernel: one block per (b * H + h, q tile).  Its
//     prologue computes D = rowsum(dO * O) and writes it; then over the
//     same k tiles it recomputes P = exp(s - lse), dP = dO v^T,
//     dS = P (dP - D) and accumulates dQ = dS k scale in registers.
//   * flash_bwd_dkdv_kernel: one block per (b * KV + kv, k tile), after
//     the dq launch (it reads D).  It loops over the group's query heads
//     and the q tiles at or below the diagonal and accumulates
//     dV = P^T dO and dK = dS^T (q scale) in registers: the group's heads
//     add into one tile inside the block, so there are no float atomics
//     and every output repeats bit for bit.
//
// Each product C[r][c] += sum_x A[r][x] B[x][c] reads A row-major (its
// rows are the thread's rows: one float4 feeds four x, and the eight
// threads of a 16-byte load phase share the row, a broadcast) and B with
// the output column contiguous (tx * 4: 128 contiguous bytes a phase), so
// operands that are the "B" side of one product and the "A" side of
// another are staged twice (transposed and row-major); the backward
// kernels restage the row-major copy into the transposed one's space once
// the transposed one is read, to stay at two blocks an SM.
//
// What bounds it on an H100: operations.  Causal GPT-2 117M (B 8, H 12,
// S 1024, dh 64, bf16) does 2 S^2 dh multiply-adds a head forward (two
// products over half the score matrix).  With bf16 inputs and a
// power-of-two scale, (q scale) k^T and the backward's dO v^T are bf16
// products with fp32 sums, which the tensor cores compute at 989
// TFLOP/s as the same function; p v, P^T dO, dS k and dS^T q have an
// fp32 operand and run at the fp32 peak, 67 TFLOP/s.  So the 12 layers'
// forward is bound at 1.23 ms (~0.2 ms of bytes) and the backward's five
// products at 3.62 ms (this design recomputes S and dP in both backward
// kernels: seven).  Everything here is fp32 on the CUDA cores; wgmma
// for the bf16 products, TMA, and a tolerance decision for the fp32
// ones are the levers for a later version.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (no --use_fast_math: expf and logf stay exact
//        to an ulp).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BT = 64;            // rows of every q and k tile
constexpr int THREADS = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr int TS = BT + 4;        // row stride of a transposed tile
constexpr float NEG_INF = -1e30f; // the reference's mask value

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

// Instantiate a launcher for (dtype, dh): dtype 0 fp32, 1 bf16; dh <= 64
// takes the 64-wide tiles, dh <= 128 the 128-wide.  Anything else is
// refused with cudaErrorInvalidValue (the wrapper checks first).
#define FLASH_DISPATCH(FN, ...)                                     \
  do {                                                              \
    if (d.dh < 1 || d.dh > 128) return (int)cudaErrorInvalidValue;  \
    if (dtype == 0)                                                 \
      return d.dh <= 64 ? FN<float, 64>(__VA_ARGS__)                \
                        : FN<float, 128>(__VA_ARGS__);              \
    if (dtype == 1)                                                 \
      return d.dh <= 64 ? FN<__nv_bfloat16, 64>(__VA_ARGS__)        \
                        : FN<__nv_bfloat16, 128>(__VA_ARGS__);      \
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
