// Square-and-matmul for Hopper (sm_90a), fp32 throughout.
//
// Replaces the Pallas TPU kernel sq_matmul_pallas
// (src/repro/kernels/srsi_matmul.py) and the transpose that
// ops.sq_matmul_t puts in front of it:
//     TRANS = false:  Y = (G * G) X      G (m, n), X (n, s) -> Y (m, s)
//     TRANS = true:   Z = (G * G)^T Y    G (m, n), Y (m, s) -> Z (n, s)
// G^2 is formed in shared memory as G is staged and never written to
// memory.  The transposed variant reads G through its own row-major
// layout (each staged slice is 16 rows x 64 contiguous columns), so no
// transposed copy of G is made; XLA makes one on the TPU.
//
// The Pallas grid accumulates into one output tile across its contraction
// axis and relies on the TPU running grid steps in order.  Here a block
// OWNS its output tile, 64 rows x s (s whole, in passes of 128 columns),
// and loops over the contraction axis itself.  To fill the card the
// wrapper may split the contraction into groups; each group writes its
// own partial tile and the wrapper sums them after the launch.  No float
// atomics: runs repeat bit for bit.
//
// What bounds it on an H100: 2 m n s fp32 operations against 4 m n bytes
// of G (s = 128 on the Adapprox fold), so operations (fp32 outside the
// tensor cores, for parity with the fp32 reference).  Each thread keeps a
// 4 x 8 register tile; slices of G^2 and X go through shared memory 16
// deep.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (no --use_fast_math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BO = 64;          // output rows per block
constexpr int KC = 16;          // contraction depth of one smem slice
constexpr int SC = 128;         // output columns per pass over the slices
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 8 outputs each
constexpr int LDA = BO + 4;
constexpr int LDB = SC + 4;

template <bool TRANS>
__global__ void __launch_bounds__(THREADS)
sq_matmul_kernel(const float* __restrict__ g, const float* __restrict__ x,
                 float* __restrict__ y, int m, int n, int s,
                 int slices_per_group) {
  __shared__ __align__(16) float As[KC * LDA];   // G^2, [c][o]
  __shared__ __align__(16) float Bs[KC * LDB];   // X,   [c][k]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int grp = blockIdx.y, l = blockIdx.z, groups = gridDim.y;
  const int out_rows = TRANS ? n : m;
  const int depth = TRANS ? m : n;
  const int o0 = blockIdx.x * BO;
  const int c_begin = grp * slices_per_group * KC;
  const int c_end = min(c_begin + slices_per_group * KC, depth);
  const float* gb = g + (size_t)l * m * n;
  const float* xb = x + (size_t)l * depth * s;
  float* yb = y + ((size_t)l * groups + grp) * out_rows * s;

  for (int s0 = 0; s0 < s; s0 += SC) {
    float acc[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

    for (int c0 = c_begin; c0 < c_end; c0 += KC) {
      __syncthreads();
#pragma unroll
      for (int e = 0; e < (KC * BO) / THREADS; ++e) {
        const int idx = tid + e * THREADS;
        // TRANS: 16 rows of G, 64 contiguous columns each (coalesced);
        // else: 64 rows of G, 16 contiguous columns each.
        const int c = TRANS ? idx >> 6 : idx & 15;
        const int o = TRANS ? idx & 63 : idx >> 4;
        const int gc = c0 + c, go = o0 + o;
        float v = 0.f;
        if (gc < c_end && go < out_rows)
          v = TRANS ? gb[(size_t)gc * n + go] : gb[(size_t)go * n + gc];
        As[c * LDA + o] = v * v;
      }
#pragma unroll
      for (int e = 0; e < (KC * SC) / THREADS; ++e) {
        const int idx = tid + e * THREADS, c = idx >> 7, k = idx & 127;
        const int gc = c0 + c, gk = s0 + k;
        Bs[c * LDB + k] = (gc < c_end && gk < s) ? xb[(size_t)gc * s + gk]
                                                 : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const float4 a4 = *reinterpret_cast<const float4*>(&As[c * LDA + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[c * LDB + tx * 8]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[c * LDB + tx * 8 + 4]);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
      }
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int o = o0 + ty * 4 + a;
      if (o >= out_rows) continue;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int k = s0 + tx * 8 + b;
        if (k < s) yb[(size_t)o * s + k] = acc[a][b];
      }
    }
  }
}

}  // namespace

extern "C" {

// g (batch, m, n); x (batch, n, s), or with trans != 0 (batch, m, s); all
// fp32 and contiguous.  Writes y (batch, groups, m or n, s): group grp
// sums contraction indices [grp * slices_per_group * 16, ...) and the
// caller sums the groups.
int sq_matmul_f32(const float* g, const float* x, float* y, int batch, int m,
                  int n, int s, int trans, int groups, int slices_per_group,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int out_rows = trans ? n : m;
  const dim3 grid((out_rows + BO - 1) / BO, groups, batch);
  if (trans)
    sq_matmul_kernel<true><<<grid, THREADS, 0, st>>>(g, x, y, m, n, s,
                                                     slices_per_group);
  else
    sq_matmul_kernel<false><<<grid, THREADS, 0, st>>>(g, x, y, m, n, s,
                                                      slices_per_group);
  return (int)cudaGetLastError();
}

}  // extern "C"
