// Shared pieces of the attention kernels (attention.cu, attention_train.cu):
// 16-byte cp.async staging (or, for a head_dim that is not a multiple of 8
// or a row that is not 16-byte aligned, plain element loads), ldmatrix,
// mma.sync m16n8k16 bf16 -> f32, and the tile geometry.  Four warps per block by default (the staging helpers take
// the block's thread count as a template parameter), one 16-row MMA tile per
// warp, 64-row tiles staged in shared memory with a row stride of DP + 8
// bf16 (DP = head dim padded to the MMA depth 16), which keeps ldmatrix free
// of bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace dd {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;  // one 16-row MMA tile per warp
constexpr int kBlockK = 64;
constexpr int kTile = 64;  // rows of every staged tile (kBlockQ == kBlockK)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

static_assert(kBlockQ == kTile && kBlockK == kTile, "one tile loader");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; zero-fills the destination when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows [row0, row0 + 64) of one head of a (rows, ld) bf16 matrix into
// a shared tile of row stride S; rows >= nrows are zero-filled.  THREADS:
// the block's thread count.
template <int S, int THREADS = kThreads>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* g, int row0,
                                          int nrows, int ld, int chunks) {
  for (int c = threadIdx.x; c < kTile * chunks; c += THREADS) {
    int r = c / chunks;
    int ch = c - r * chunks;
    int row = row0 + r;
    bool valid = row < nrows;
    const bf16* src = g + (size_t)(valid ? row : 0) * ld + ch * 8;
    cp_async16(tile + r * S + ch * 8, src, valid);
  }
}

// load_tile for any head_dim d <= DP and any alignment: plain 2-byte loads,
// synchronous; columns [d, DP) and rows >= nrows are written as zeros.
template <int S, int DP, int THREADS = kThreads>
__device__ __forceinline__ void load_tile_any(bf16* tile, const bf16* g,
                                              int row0, int nrows, int ld,
                                              int d) {
  for (int i = threadIdx.x; i < kTile * DP; i += THREADS) {
    const int r = i / DP;
    const int col = i - r * DP;
    const int row = row0 + r;
    bf16 x = __float2bfloat16(0.f);
    if (row < nrows && col < d) x = g[(size_t)row * ld + col];
    tile[r * S + col] = x;
  }
}

// Stage one 64-row tile: cp.async (load_tile) when VEC, which needs
// d % 8 == 0 and 16-byte aligned rows, else load_tile_any.
template <int S, int DP, bool VEC, int THREADS = kThreads>
__device__ __forceinline__ void stage_tile(bf16* tile, const bf16* g,
                                           int row0, int nrows, int ld,
                                           int d) {
  if constexpr (VEC)
    load_tile<S, THREADS>(tile, g, row0, nrows, ld, d / 8);
  else
    load_tile_any<S, DP, THREADS>(tile, g, row0, nrows, ld, d);
}

// The VEC condition for a (rows, heads * d) bf16 matrix: with d % 8 == 0
// every head's row segment starts 16-byte aligned when the base does.
inline bool vec_ok(int d, const void* a, const void* b, const void* c,
                   const void* e, const void* f = nullptr,
                   const void* g = nullptr) {
  uintptr_t bits = 0;
  for (const void* p : {a, b, c, e, f, g})
    bits |= reinterpret_cast<uintptr_t>(p);
  return d % 8 == 0 && bits % 16 == 0;
}

// Columns [d, DP) of n_tiles consecutive tiles (row stride S) stay zero;
// cp.async never writes them.
template <int DP, int THREADS = kThreads>
__device__ __forceinline__ void zero_pad_columns(bf16* tiles, int n_tiles,
                                                 int d) {
  constexpr int S = DP + 8;
  if (d < DP) {
    const int pad = DP - d;
    for (int i = threadIdx.x; i < n_tiles * kTile * pad; i += THREADS)
      tiles[(i / pad) * S + d + i % pad] = __float2bfloat16(0.f);
  }
}

// A operand (16 rows x 16 depth) of warp tile rows [16w, 16w + 16) at
// depth step kt, from a row-major tile of stride S.
template <int S>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int warp, int kt, int lane) {
  ldmatrix_x4(a, tile + (warp * 16 + (lane & 15)) * S + kt * 16 +
                     (lane >> 4) * 8);
}

// B operand for X . Y^T with Y row-major (rows = output columns): output
// columns [16 j2, 16 j2 + 16) at depth step kt -> b[0..1] for the first 8
// columns, b[2..3] for the next 8.
template <int S>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const bf16* tile,
                                            int j2, int kt, int lane) {
  ldmatrix_x4(b, tile + (j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * S +
                     kt * 16 + ((lane >> 3) & 1) * 8);
}

// B operand for P . Y with Y row-major (rows = depth): depth step kk,
// output columns [16 n2, 16 n2 + 16) -> b[0..1], b[2..3] as above.
template <int S>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const bf16* tile,
                                            int kk, int n2, int lane) {
  ldmatrix_x4_trans(b, tile + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                                  S + n2 * 16 + ((lane >> 4) << 3));
}

// A operand (16 x 16) from accumulator fragments x[2kk], x[2kk + 1] of a
// 16 x 64 product, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&x)[kTile / 8][4],
                                         int kk) {
  a[0] = pack_bf16x2(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack_bf16x2(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack_bf16x2(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack_bf16x2(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

// Write a warp's 16 x DP f32 accumulator times `mul` as bf16 rows r0 and
// r0 + 8 of a (rows, ld) matrix; only rows < nrows and columns < d.  VEC:
// column pairs as one 4-byte store (d even, rows 4-byte aligned); else one
// element at a time, for any d and alignment.
template <int NT, bool VEC = true>
__device__ __forceinline__ void store_rows(bf16* g, const float (&acc)[NT][4],
                                           float mul, int r0, int nrows,
                                           int ld, int d, int tq) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int col = i * 8 + 2 * tq;
    if (col >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (r0 + 8 * h >= nrows) continue;
      bf16* p = g + (size_t)(r0 + 8 * h) * ld + col;
      if constexpr (VEC) {
        *reinterpret_cast<uint32_t*>(p) =
            pack_bf16x2(acc[i][2 * h] * mul, acc[i][2 * h + 1] * mul);
      } else {
        p[0] = __float2bfloat16(acc[i][2 * h] * mul);
        if (col + 1 < d) p[1] = __float2bfloat16(acc[i][2 * h + 1] * mul);
      }
    }
  }
}

// head_dim -> padded DP dispatch over the 10 instances d in 1..160.
#define DD_DISPATCH_DP(d, CALL)                      \
  switch (((d) + 15) / 16 * 16) {                    \
    case 16: return CALL(16);                        \
    case 32: return CALL(32);                        \
    case 48: return CALL(48);                        \
    case 64: return CALL(64);                        \
    case 80: return CALL(80);                        \
    case 96: return CALL(96);                        \
    case 112: return CALL(112);                      \
    case 128: return CALL(128);                      \
    case 144: return CALL(144);                      \
    case 160: return CALL(160);                      \
  }

}  // namespace dd
