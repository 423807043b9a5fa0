// Building blocks of the port's Hopper (sm_90a) tensor-core kernels:
// warpgroup matrix multiplies (wgmma) on tiles in shared memory in the
// 128-byte swizzle, the cp.async copies that fill them, and the bf16
// hi + lo split that lets an fp32 operand through bf16 products.
// Included by flash_attention.cu (B6), ssd_chunk.cu (B7), srsi_matmul.cu
// (B3) and pass1.cuh (B1, B4), the last two for the tf32 product.
//
// Tile layout.  A tile of R rows holds its columns in blocks of 128 bytes
// (64 bf16 or 32 fp32 values), each block R rows x 128 bytes, and the
// 16-byte chunk j of row r at chunk j ^ (r % 8): the 128-byte swizzle,
// which a descriptor names with layout type 1.  A descriptor reads such a
// tile K-major (the contraction along its columns: A's rows, or B's rows
// as the output's columns) or MN-major (the contraction along its rows,
// the output's columns along its columns), so one staged tile serves
// either side of a product and nothing is transposed by a store.  tf32
// operands are read K-major only (the transpose bits apply to 16-bit
// types).
//
// Accumulators.  D is 64 x N fp32 in registers: thread t of the
// warpgroup holds rows 16 (t / 32) + (t % 32) / 4 + {0, 8} and columns
// 8 j + 2 (t % 4) + {0, 1}, as entry [4 j + 2 row_half + col].

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int WG = 128;           // threads of a warpgroup
constexpr int WT = 64;            // rows of a wgmma tile (its M)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory from its first 1024-byte boundary (the
// swizzle repeats every 1024 bytes of address; launches ask for 1024
// bytes more than they use).
__device__ __forceinline__ bf16* smem_tiles() {
  extern __shared__ __align__(16) float sm[];
  char* raw = reinterpret_cast<char*>(sm);
  const uint32_t pad = (1024 - (smem_u32(raw) & 1023)) & 1023;
  return reinterpret_cast<bf16*>(raw + pad);
}

// 16 (4) bytes global -> shared without the registers; n < 16 (4) source
// bytes zero-fill the rest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Make this thread's shared-memory writes visible to wgmma (the async
// proxy); a barrier after it makes every thread's.
__device__ __forceinline__ void async_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Wait until at most one group (the prefetch) is in flight, then make
// the block's shared-memory writes visible to wgmma (the async proxy).
__device__ __forceinline__ void tile_ready() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// Element offset of (r, c) in an [R][DP] bf16 tile: column block c / 64
// (R x 64 elements), then the row's 128 bytes with 16-byte chunk
// j = (c / 8) % 8 at j ^ (r % 8).
template <int R = WT>
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * (R * 64) + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) +
         (c & 7);
}

// Load rows [0, nrows) x columns [0, dh) of a global tile (row stride rs
// elements) into a swizzled [64][DP] tile, 0 past either edge.
template <int DP>
__device__ __forceinline__ void load_tile(bf16* t, const bf16* g, long rs,
                                          int nrows, int dh, int vec) {
  if (vec) {  // dh % 8 == 0: every 16-byte chunk is inside or outside
#pragma unroll
    for (int j = 0; j < WT * DP / 8 / WG; ++j) {
      const int i = threadIdx.x + j * WG;
      const int r = i / (DP / 8), c = i % (DP / 8) * 8;
      const bool in = r < nrows && c < dh;
      cp_async16(t + swz(r, c), in ? g + r * rs + c : g, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < WT * DP; i += WG) {
      const int r = i / DP, c = i % DP;
      t[swz(r, c)] = r < nrows && c < dh ? g[r * rs + c]
                                         : __float2bfloat16_rn(0.f);
    }
  }
}

// wgmma shared-memory descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}
// An [R][.] tile read K-major, the contraction along its columns (A = its
// 64 rows, or B = its R rows as the output's columns): k16 step kk is
// column block kk / 4, 32 bytes a step inside it; 8-row groups 1024 bytes
// apart.
template <int R = WT>
__device__ __forceinline__ uint64_t kmajor(const bf16* t, int kk) {
  return desc(t + (kk >> 2) * (R * 64) + (kk & 3) * 16, 16, 1024);
}
// An [R][.] tile read MN-major, the contraction along its rows: k16 step
// kk is rows 16 kk .. 16 kk + 15; the output's columns (or A's rows) are
// the tile's, in column blocks R x 128 bytes apart.
template <int R = WT>
__device__ __forceinline__ uint64_t mnmajor(const bf16* t, int kk) {
  return desc(t + kk * 16 * 64, R * 128, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                            \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                       \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                     \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_D64                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                            \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                       \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                     \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                     \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                     \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                     \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                     \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define WG_OUT32(d)                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),    \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),    \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])
#define WG_OUT64(d)                                                        \
  WG_OUT32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),         \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),     \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),     \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),     \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),     \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),     \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// D += A B for one k16 step of bf16, D 64 x N fp32 in registers.
// mma_ss: A and B from shared memory, both K-major (N = 64); acc 0
// overwrites D.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT32(d)
      : "l"(a), "l"(b), "r"(acc));
}

// The same with A MN-major (TA = 1) and / or B MN-major (TB = 1), N = 64
// (32 registers) or 128 (64).
template <int TA, int TB>
__device__ __forceinline__ void mma_ss_t(float (&d)[32], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : WG_OUT32(d)
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}
template <int TA, int TB>
__device__ __forceinline__ void mma_ss_t(float (&d)[64], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : WG_OUT64(d)
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

// mma_rs: A from registers (four bf16x2 per thread, see split_frags), B
// MN-major from shared memory; always accumulates.  N = 64 or 128.
__device__ __forceinline__ void mma_rs(float (&d)[32],
                                       const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void mma_rs(float (&d)[64],
                                       const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_OUT64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D += A B for one k8 step of tf32, A and B from shared memory, both
// K-major (tf32 has no transpose), N = 64; acc 0 overwrites D.
__device__ __forceinline__ void mma_tf32(float (&d)[32], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_D32
      ", %32, %33, p, 1, 1;\n}\n"
      : WG_OUT32(d)
      : "l"(a), "l"(b), "r"(acc));
}

// The same with N = 128 (64 registers).
__device__ __forceinline__ void mma_tf32(float (&d)[64], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WG_D64
      ", %64, %65, p, 1, 1;\n}\n"
      : WG_OUT64(d)
      : "l"(a), "l"(b), "r"(acc));
}

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero, as an fp32 value with the low 13 bits 0.
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// (bf16(x0), bf16(x1)) rounded to nearest, packed x0 in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(x1), "f"(x0));
  return r;
}
// The low bf16x2 of a pair x0, x1 whose high one is h: bf16(x - hi).
__device__ __forceinline__ uint32_t pack_lo(float x0, float x1, uint32_t h) {
  return pack_bf16(x0 - __uint_as_float(h << 16),
                   x1 - __uint_as_float(h & 0xffff0000u));
}

// The A fragments of a 64 x 64 fp32 accumulator tile x, as x = hi + lo
// with hi = bf16(x), lo = bf16(x - hi): for k16 step kk, register r holds
// the entries 8 kk + 2 r and 8 kk + 2 r + 1 (low half first).
__device__ __forceinline__ void split_frags(const float (&x)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = x[8 * kk + 2 * r], x1 = x[8 * kk + 2 * r + 1];
      const uint32_t h = pack_bf16(x0, x1);
      hi[kk][r] = h;
      lo[kk][r] = pack_lo(x0, x1, h);
    }
}

// D += (hi + lo) B over the 64-deep contraction, B MN-major from t.
template <int N>
__device__ __forceinline__ void mma_split(float (&d)[N],
                                          const uint32_t (&hi)[4][4],
                                          const uint32_t (&lo)[4][4],
                                          const bf16* t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    mma_rs(d, hi[kk], mnmajor(t, kk));
    mma_rs(d, lo[kk], mnmajor(t, kk));
  }
}

// D = A B^T over DP, A and B 64-row tiles read K-major.
template <int DP>
__device__ __forceinline__ void mma_qk(float (&d)[32], const bf16* a,
                                       const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    mma_ss(d, kmajor(a, kk), kmajor(b, kk), kk > 0);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// Max and sum over the four threads that share an accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace
