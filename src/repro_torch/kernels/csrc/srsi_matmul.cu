// Square-and-matmul for Hopper (sm_90a) on the tensor cores, in 3xTF32.
//
// Replaces the Pallas TPU kernel sq_matmul_pallas
// (src/repro/kernels/srsi_matmul.py, body _kernel) and the transpose that
// ops.sq_matmul_t puts in front of it:
//     TRANS = false:  Y = (G * G) X      G (m, n), X (n, s) -> Y (m, s)
//     TRANS = true:   Z = (G * G)^T Y    G (m, n), Y (m, s) -> Z (n, s)
// all fp32, batched over a leading L.  G^2 is formed as G is staged and
// never written to memory, and no transposed copy of G is made (XLA makes
// one on the TPU).
//
// Arithmetic.  G^2 and X are fp32 and not tf32- or bf16-exact, and the
// product is held to 1e-5 of its largest entry (chip_smoke.py
// TOL_MATMUL).  Each operand x is split into big = tf32(x) (cvt.rna, 10
// mantissa bits) and small = tf32(x - big), and every product is
// big.big + big.small + small.big, three wgmma m64n64k8 .f32.tf32.tf32
// into one fp32 accumulator: the dropped small.small and small's own
// rounding are ~2^-22 of each term.  Emulated on the CPU at the fold's
// shapes (tests/test_torch_legacy_kernels.py), this reads ~1e-7 of the
// largest entry, under plain fp32 (~5e-7); bf16 x3 reads ~5e-6, too close
// to the tolerance.
//
// Sums.  wgmma adds into its fp32 accumulator with less than fp32's
// round-to-nearest: carried over a whole contraction (3,072 deep at the
// fold, x 3 products) its error grows with the depth and reached 1.0e-5
// of the largest entry on an H100.  So each 32-deep slice's twelve wgmma
// start from a fresh accumulator (small terms first), and the slice's sum
// is added into the running fp32 sum in registers by ordinary adds.
//
// Layout.  tf32 operands enter wgmma K-major only.  A block owns a 64-row
// output tile x s in passes of 64 NW columns, one warpgroup per 64
// columns (NW = 1 for s <= 64, else 2), and loops over the contraction in
// 32-deep slices.  Each slice of G (A = G^2, rows = output rows, shared
// by the warpgroups) and of X (B, rows = output columns) is staged as
// [rows][32] fp32 tiles in the 128-byte swizzle, K-major, big and small
// apart: every thread loads its share into registers (coalesced along
// whichever index is contiguous in memory: the output rows of G and the
// columns of X in the transposed form), squares G, splits, and stores 16
// bytes a chunk at its swizzled place, so the transpose of the MN-major
// operands costs nothing beyond the staging.  Two slice buffers: the
// next slice's global loads are issued before the current slice's wgmma
// chain and stored while it runs.
//
// What bounds it on an H100: the operations that hold the tolerance,
// 3 x 2 m n s at the 495 TFLOP/s dense TF32 peak, against 4 L (m n +
// (m + n) s) bytes; at the fold's shapes (s = 128) the operations.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (no --use_fast_math).

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int BO = 64;          // output rows per block
constexpr int KC = 32;          // contraction depth of one slice

// Offset of (r, c) in an [R][32] fp32 tile: 128-byte rows, 16-byte chunk
// c / 4 at (c / 4) ^ (r % 8).
__device__ __forceinline__ int off32(int r, int c4) {
  return r * KC + ((c4 ^ (r & 7)) << 2);
}

// tf32 k8 step kk of an [R][32] tile read K-major.
__device__ __forceinline__ uint64_t kdesc(const float* t, int kk) {
  return desc(t + kk * 8, 16, 1024);
}

// One thread's share (of NT threads) of an [R][32] operand slice: rows
// [r0, r_end) and contraction indices [c0, c_end) of a source laid out
// with the contraction contiguous (KCONTIG, element (r, c) at r ld + c) or
// the rows contiguous (at c ld + r), 0 past either edge.
template <bool KCONTIG, int R, int NT>
struct Slice {
  static constexpr int PER = R * KC / 4 / NT;  // 4-element chunks a thread
  float v[PER][4];

  __device__ __forceinline__ void at(int j, int& r, int& c4) const {
    const int i = threadIdx.x + j * NT;
    // lanes along the contiguous index: coalesced loads; eight lanes
    // write eight distinct swizzled chunks, free of bank conflicts
    r = KCONTIG ? i >> 3 : i % R;
    c4 = KCONTIG ? i & 7 : i / R;
  }

  __device__ __forceinline__ void load(const float* __restrict__ src,
                                       long ld, int r0, int r_end, int c0,
                                       int c_end) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      int r, c4;
      at(j, r, c4);
      const int rr = r0 + r, c = c0 + c4 * 4;
      const float* p = src + (KCONTIG ? rr * ld + c : c * ld + rr);
      const long step = KCONTIG ? 1 : ld;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[j][e] = rr < r_end && c + e < c_end ? p[e * step] : 0.f;
    }
  }

  // Store big and small parts (of the square, with sq) into their tiles.
  __device__ __forceinline__ void store(float* big, float* small,
                                        bool sq) const {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      int r, c4;
      at(j, r, c4);
      float b[4], s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sq ? v[j][e] * v[j][e] : v[j][e];
        b[e] = tf32(x);
        s[e] = tf32(x - b[e]);
      }
      *reinterpret_cast<float4*>(big + off32(r, c4)) =
          make_float4(b[0], b[1], b[2], b[3]);
      *reinterpret_cast<float4*>(small + off32(r, c4)) =
          make_float4(s[0], s[1], s[2], s[3]);
    }
  }
};

template <int NW>
__host__ __device__ constexpr int stage_floats() {
  return 2 * BO * KC + 2 * WT * NW * KC;
}

template <bool TRANS, int NW>
__global__ void __launch_bounds__(NW * WG, 2)
sq_matmul_kernel(const float* __restrict__ g, const float* __restrict__ x,
                 float* __restrict__ y, int m, int n, int s,
                 int slices_per_group) {
  constexpr int NT = NW * WG;            // threads
  constexpr int AT = BO * KC;            // one A tile, floats
  constexpr int BW = WT * NW;            // output columns a pass
  constexpr int BTL = BW * KC;           // one B tile
  constexpr int STAGE = stage_floats<NW>();
  // stage t: A big, A small, B big, B small at sm + t STAGE
  float* sm = reinterpret_cast<float*>(smem_tiles());
  const int w = threadIdx.x / WG;              // this warpgroup's 64 columns
  const int ln = threadIdx.x & 31;
  const int r0 = (threadIdx.x % WG) / 32 * 16 + (ln >> 2);  // rows r0, r0 + 8
  const int c0 = 2 * (ln & 3);                 // columns 8 j + c0 + {0, 1}
  const int grp = blockIdx.y, l = blockIdx.z, groups = gridDim.y;
  const int out_rows = TRANS ? n : m;
  const int depth = TRANS ? m : n;
  const int o0 = blockIdx.x * BO;
  const int c_begin = grp * slices_per_group * KC;
  const int c_end = min(c_begin + slices_per_group * KC, depth);
  const int ns = (c_end - c_begin + KC - 1) / KC;
  const float* gb = g + (size_t)l * m * n;
  const float* xb = x + (size_t)l * depth * s;
  float* yb = y + ((size_t)l * groups + grp) * out_rows * s;
  // A = G^2: TRANS reads G (m, n) along its rows (the output rows are its
  // contiguous columns), else along its contiguous contraction.  B = X
  // (depth, s): its output columns are contiguous.
  Slice<!TRANS, BO, NT> a;
  Slice<false, BW, NT> b;

  for (int s0 = 0; s0 < s; s0 += BW) {
    const bool live = s0 + w * WT < s;  // this warpgroup's columns exist
    float acc[32], part[32];
    zero(acc);
    a.load(gb, n, o0, out_rows, c_begin, c_end);
    b.load(xb, s, s0, s, c_begin, c_end);
    a.store(sm, sm + AT, true);
    b.store(sm + 2 * AT, sm + 2 * AT + BTL, false);
    async_fence();
    __syncthreads();
    for (int t = 0; t < ns; ++t) {
      const float* st = sm + (t & 1) * STAGE;
      const bool more = t + 1 < ns;
      if (more) {  // in flight while this slice's products run
        a.load(gb, n, o0, out_rows, c_begin + (t + 1) * KC, c_end);
        b.load(xb, s, s0, s, c_begin + (t + 1) * KC, c_end);
      }
      // every warpgroup runs its products, past s on zero columns: a wgmma
      // under a branch ptxas cannot prove uniform is serialized
      keep(part);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {
        const uint64_t ab = kdesc(st, kk), as = kdesc(st + AT, kk);
        const uint64_t bb = kdesc(st + 2 * AT + w * WT * KC, kk);
        const uint64_t bs = kdesc(st + 2 * AT + BTL + w * WT * KC, kk);
        mma_tf32(part, as, bb, kk > 0);
        mma_tf32(part, ab, bs, 1);
        mma_tf32(part, ab, bb, 1);
      }
      wg_commit();
      if (more) {  // the other buffer, read by no wgmma in flight
        float* nx = sm + ((t + 1) & 1) * STAGE;
        a.store(nx, nx + AT, true);
        b.store(nx + 2 * AT, nx + 2 * AT + BTL, false);
      }
      wg_wait();
      keep(part);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] += part[e];
      async_fence();
      __syncthreads();
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = o0 + r0 + 8 * h;
      if (!live || o >= out_rows) continue;
#pragma unroll
      for (int e = 2 * h; e < 32; e += 4)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int k = s0 + w * WT + (e >> 2) * 8 + c0 + j;
          if (k < s) yb[(size_t)o * s + k] = acc[e + j];
        }
    }
    __syncthreads();  // the next pass restages buffer 0
  }
}

template <bool TRANS, int NW>
int launch(const float* g, const float* x, float* y, int m, int n, int s,
           int slices_per_group, dim3 grid, cudaStream_t st) {
  auto kern = sq_matmul_kernel<TRANS, NW>;
  const size_t smem = 2 * stage_floats<NW>() * sizeof(float) + 1024;
  if (int err = (int)cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return err;
  kern<<<grid, NW * WG, smem, st>>>(g, x, y, m, n, s, slices_per_group);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// g (batch, m, n); x (batch, n, s), or with trans != 0 (batch, m, s); all
// fp32 and contiguous.  Writes y (batch, groups, m or n, s): group grp
// sums contraction indices [grp * slices_per_group * 32, ...) and the
// caller sums the groups.
int sq_matmul_f32(const float* g, const float* x, float* y, int batch, int m,
                  int n, int s, int trans, int groups, int slices_per_group,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int out_rows = trans ? n : m;
  const dim3 grid((out_rows + BO - 1) / BO, groups, batch);
  if (s <= WT)
    return trans ? launch<true, 1>(g, x, y, m, n, s, slices_per_group, grid,
                                   st)
                 : launch<false, 1>(g, x, y, m, n, s, slices_per_group, grid,
                                    st);
  return trans ? launch<true, 2>(g, x, y, m, n, s, slices_per_group, grid, st)
               : launch<false, 2>(g, x, y, m, n, s, slices_per_group, grid,
                                  st);
}

}  // extern "C"
