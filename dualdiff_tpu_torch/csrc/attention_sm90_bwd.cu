// Attention backward for Hopper (sm_90a): TMA, wgmma, warp specialisation.
//
// What it replaces.  The TPU kernels _bwd_dq_kernel_t and _bwd_dkv_kernel_t
// (dualdiff_tpu/ops/attention.py:719, :751, called by _packed_train_t_bwd)
// and _bwd_dq_kernel and _bwd_dkv_kernel (:160, :184, called by
// _flash_padded_bwd): with P = exp(s q.k - lse) (lse from the training
// forward) and delta = sum_d dO * O per query and head,
//
//   dq = s * sum_k [P * (dO V^T - delta)] K
//   dv = P^T dO,   dk = s * [P * (dO V^T - delta)]^T Q
//
// keys >= Lk and queries >= Lq contributing nothing.  Two kernels behind
// the four wrappers packed_attention_bwd_dq / _dkv and flash_attention_bwd_dq
// / _dkv (ops/attention.py), for head dims d <= 80 with d % 8 == 0 and
// 16-byte aligned rows (ops.attention.sm90_in_scope); every other shape
// stays on attention_train.cu's mma.sync template.  A contiguous
// (B, L, H, D) tensor is the packed (B, L, C) memory, so the four are two.
//
// What bounds it.  At the flagship's 6 x 1400 x 1400 (C = 320, 8 heads,
// d = 40) dq does three products, 22.6 GFLOP (23 us at 989 TFLOP/s), and
// dk/dv four, 30.1 GFLOP (30 us), against 27 and 33 MB (8 and 10 us at
// 3.35 TB/s).  At d = 40 the K-major products (S, dP) run 48 of their 64
// padded depth columns (1.2x) and the MN-major ones (dQ, dK, dV) whole
// 64-column atoms (1.6x): 30 and 43 us of padded MMA work.  Each kernel
// also takes one exponential per score, 94 M here, 22.5 us at 16 a clock
// on 132 SMs at 1980 MHz.  So the products set the pace, and a kernel that
// runs its exponentials in lock-step with them pays both: the template,
// one 16-row mma.sync tile per warp, ran at 6-7x its FLOP bound.
//
// Design (the forward's, attention_sm90.cu, with more products).
// - A work item is 128 rows of one (row, head): 128 queries in dq, 128 keys
//   in dk/dv, over two consumer warpgroups of 64 rows each, and one
//   producer warp (a third warpgroup whose other three warps exit at once).
//   setmaxnreg moves registers from the producer warpgroup (24 a thread)
//   to the consumers (240).  Persistent grid: one block per SM walks the
//   items, so the producer loads the next item while the consumers finish
//   this one.
// - Each block owns its output rows alone: no atomics, a deterministic
//   result, as the template's.  (A single fused kernel does 5 products
//   instead of 7 but adds dq atomics in float32 and a pass to convert.)
// - The item's own operands (dq: Q and dO; dk/dv: K and V) are loaded once
//   into one of two buffers; the other side streams through a ring of
//   kStages tiles of 64 rows (dq: K and V; dk/dv: Q and dO), every buffer
//   and stage guarded by a "full" mbarrier (transaction bytes) and an
//   "empty" one (the 8 consumer warps).  All through TMA with the 64-wide
//   128-byte-swizzled box of sm90.cuh: columns d..63 and rows past L read
//   as zero.  At d = 72, 80 (KSTEPS = 5) every item buffer and ring tile
//   adds the 16-wide, 32-byte-swizzled second box at column 64 (4 KB an
//   item operand, 2 KB a ring tile), under the same mbarrier: 161 KB of
//   shared memory against 129 KB below d = 65, the stage count unchanged.
// - dq, per key tile: S = Q K^T and dP = dO V^T (wgmma m64n64k16, both
//   operands K-major in shared memory, ceil(d / 16) depth steps, the fifth
//   over the second boxes at d = 72, 80);
//   P = ex2(S s log2e - lse log2e), keys >= Lk masked in the last tile;
//   dS = P (dP - delta); dQ += dS K with dS rounded to bf16 in registers
//   as the A fragment and K read MN-major (the forward's P V with V
//   replaced by K).  lse and delta of the thread's two rows stay in
//   registers.
// - dk/dv, per query tile: S^T = K Q^T and dP^T = V dO^T; P^T and dS^T as
//   above with lse and delta per column, read from shared memory where
//   each warpgroup stages the tile's 64 + 64 floats (loaded one tile ahead
//   into a register per thread; a query >= Lq gets lse = +inf, so its P is
//   exactly 0 with no mask); dV += P^T dO and dK += dS^T Q, A from
//   registers, dO and Q MN-major.  At d = 72, 80 each register-A product
//   (dQ, dK, dV) is an n64 over the first box plus an n16 over the second.
// - Overlap.  Within a warpgroup, tile t's two K-major products are issued
//   together with tile t-1's register-A products, and tile t's
//   exponentials run while those are in flight.  In dk/dv, named barriers
//   also hand the tensor cores from one warpgroup to the other in turns
//   (ping-pong), as in the forward: 1-2% faster there
//   (tests/torch_sm90_ablate.py).  dq, which sits near its data-movement
//   floor (below), runs as fast without it and has none.
// - Tiles of 64 streamed rows keep the registers a consumer thread holds
//   across a product in flight at 112 (dq: S, dP, dQ 32 floats each, dS 16
//   words) and 160 (dk/dv: S^T, dP^T, dK, dV, P^T and dS^T), 120 and 176
//   at d = 72, 80 (dQ, dK, dV 8 floats more each): under the 240
//   setmaxnreg gives.  -Xptxas=-v (kept in
//   build/dualdiff_tpu_torch/attention_sm90_bwd-*.log): 168 registers at
//   launch (the cap of 384 threads a block), 0 bytes of spill and no
//   warning, all ten instances.  128-row streamed tiles would hold 192
//   (dq) and 256 (dk/dv).
// - What it reaches (PERF.md, kernel table; an H100 80GB HBM3 at 700 W):
//   0.0677 + 0.1166 ms at the flagship's shape, 3.0x and 3.8x the FLOP
//   bound: under the template's 0.3469, but over SDPA's fastest backward
//   (cuDNN, 0.1756 ms for dq, dk and dv, a 5-product design).  Taking every
//   product out (tests/torch_sm90_ablate.py) leaves 0.0595 and 0.0750 ms of
//   TMA ring and barriers: each 128-row item reads all of the other side's
//   tiles from L2, so dq sits on its data movement.  More rows per item,
//   TMA multicast across a two-block cluster, or one fused kernel that
//   reads each tile pair once for all five products would cut it.  At
//   d = 80, 6 x 1296 x 1296 (HD's second level, same card): 0.0855 +
//   0.1402 ms against the template's 0.1945 + 0.3067 and cuDNN's 0.2352.
// - P and dS are bf16 MMA operands with float32 accumulators, as in the
//   template and in SDPA's FLASH backward (the TPU kernels keep them in
//   float32; ROADMAP Queue 3 #3 has what that does to the gradients).
// - Output: dq * s, dk * s and dv rounded to bf16, stored from registers as
//   4-byte pairs, rows < L and columns < d only.

#include "sm90.cuh"

namespace {

using dd::bf16;
using namespace dd::sm90;

constexpr int kRows = 128;          // rows of a work item
constexpr int kTile = 64;           // rows of a streamed tile
constexpr int kStages = 4;          // ring depth
constexpr int kRowBytes = 128;      // one 64-wide bf16 row, swizzled
constexpr int kItemBytes = kRows * kRowBytes;  // 16 KB
constexpr int kTileBytes = kTile * kRowBytes;  // 8 KB
// d = 72 and 80 (KSTEPS = 5): a second box of columns 64..79 per tile
constexpr int kRow2Bytes = 32;      // one 16-wide bf16 row, swizzled
constexpr int kItem2Bytes = kRows * kRow2Bytes;  // 4 KB
constexpr int kTile2Bytes = kTile * kRow2Bytes;  // 2 KB
constexpr int kConsumers = 256;     // two warpgroups
constexpr int kThreads = kConsumers + 128;

// 2 x 2 item buffers, the ring of 2 x kStages tiles (with KSTEPS = 5 also
// their second boxes), 12 mbarriers, 1024 bytes of alignment slack:
// 132,224 bytes at KSTEPS 1-4, 164,992 at 5
template <int KSTEPS>
constexpr int smem_bytes() {
  return 4 * (kItemBytes + (KSTEPS == 5 ? kItem2Bytes : 0)) +
         2 * kStages * (kTileBytes + (KSTEPS == 5 ? kTile2Bytes : 0)) + 128 +
         1024;
}

// Shared-memory layout of either kernel: item operands a and b (2 buffers
// each), ring operands c and d (kStages each), with `wide` (KSTEPS = 5)
// their second boxes a2, b2, c2 and d2, then the mbarriers.
struct Layout {
  uint32_t a, b, c, d, a2, b2, c2, d2, bars;
  __device__ Layout(uint32_t base, bool wide)
      : a(base),
        b(base + 2 * kItemBytes),
        c(base + 4 * kItemBytes),
        d(base + 4 * kItemBytes + kStages * kTileBytes),
        a2(base + 4 * kItemBytes + 2 * kStages * kTileBytes),
        b2(a2 + 2 * kItem2Bytes),
        c2(a2 + 4 * kItem2Bytes),
        d2(c2 + kStages * kTile2Bytes),
        bars(wide ? d2 + kStages * kTile2Bytes : a2) {}
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (kStages + s); }
  __device__ uint32_t ifull(int b) const {
    return bars + 8 * (2 * kStages + b);
  }
  __device__ uint32_t iempty(int b) const {
    return bars + 8 * (2 * kStages + 2 + b);
  }
};

__device__ __forceinline__ void init_barriers(const Layout& sm) {
  for (int s = 0; s < kStages; ++s) {
    mbar_init(sm.full(s), 1);
    mbar_init(sm.empty(s), kConsumers / 32);
  }
  for (int b = 0; b < 2; ++b) {
    mbar_init(sm.ifull(b), 1);
    mbar_init(sm.iempty(b), kConsumers / 32);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer thread: item w's operands (maps ta, tb, rows 128) into
// buffer it & 1, then its n_tiles streamed tiles (maps tc, td, rows 64)
// into the ring; WIDE, each with its second box (maps ta2 .. td2, at
// column 64) under the same mbarrier.  Item w is row block w % n_blocks of
// head (w / n_blocks) % heads of row w / (n_blocks * heads).
template <bool WIDE>
__device__ __forceinline__ void produce(
    const Layout& sm, const CUtensorMap* ta, const CUtensorMap* tb,
    const CUtensorMap* tc, const CUtensorMap* td, const CUtensorMap* ta2,
    const CUtensorMap* tb2, const CUtensorMap* tc2, const CUtensorMap* td2,
    int n_blocks, int heads, int n_items, int n_tiles) {
  int kv = 0, it = 0;
  for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++it) {
    const int blk = w % n_blocks, head = (w / n_blocks) % heads,
              row = w / (n_blocks * heads);
    const int ib = it & 1;
    if (it >= 2) mbar_wait(sm.iempty(ib), ((it >> 1) - 1) & 1);
    mbar_expect_tx(sm.ifull(ib),
                   2 * (kItemBytes + (WIDE ? kItem2Bytes : 0)));
    tma_load(sm.a + ib * kItemBytes, ta, sm.ifull(ib), 0, head, blk * kRows,
             row);
    tma_load(sm.b + ib * kItemBytes, tb, sm.ifull(ib), 0, head, blk * kRows,
             row);
    if constexpr (WIDE) {
      tma_load(sm.a2 + ib * kItem2Bytes, ta2, sm.ifull(ib), 64, head,
               blk * kRows, row);
      tma_load(sm.b2 + ib * kItem2Bytes, tb2, sm.ifull(ib), 64, head,
               blk * kRows, row);
    }
    for (int t = 0; t < n_tiles; ++t, ++kv) {
      const int s = kv % kStages;
      if (kv >= kStages) mbar_wait(sm.empty(s), ((kv / kStages) - 1) & 1);
      mbar_expect_tx(sm.full(s), 2 * (kTileBytes + (WIDE ? kTile2Bytes : 0)));
      tma_load(sm.c + s * kTileBytes, tc, sm.full(s), 0, head, t * kTile,
               row);
      tma_load(sm.d + s * kTileBytes, td, sm.full(s), 0, head, t * kTile,
               row);
      if constexpr (WIDE) {
        tma_load(sm.c2 + s * kTile2Bytes, tc2, sm.full(s), 64, head,
                 t * kTile, row);
        tma_load(sm.d2 + s * kTile2Bytes, td2, sm.full(s), 64, head,
                 t * kTile, row);
      }
    }
  }
}

// acc (64 x 64) (+)= A (this warpgroup's 64 rows) . B (64 rows)^T, both
// K-major, in KSTEPS = ceil(d / 16) depth steps of 32 bytes: up to 4 over
// the first boxes (da, db) and, at 5, one over the second (da2, db2)
template <int KSTEPS>
__device__ __forceinline__ void issue_ss(float (&acc)[32], uint64_t da,
                                         uint64_t db, uint64_t da2,
                                         uint64_t db2) {
#pragma unroll
  for (int kt = 0; kt < (KSTEPS < 4 ? KSTEPS : 4); ++kt)
    wgmma_ss_n64(acc, da + 2 * kt, db + 2 * kt, kt);
  if constexpr (KSTEPS == 5) wgmma_ss_n64(acc, da2, db2, 1);
}

// acc (64 x 64) += A (64 x 64 bf16, registers) . B (64 x 64, MN-major): 4
// depth steps of 16 rows = 2048 bytes; WIDE, also acc2 (64 x 16) += A .
// B's second box (16 x 16 a step, 512 bytes)
template <bool WIDE>
__device__ __forceinline__ void issue_rs(float (&acc)[32],
                                         float (&acc2)[WIDE ? 8 : 1],
                                         const uint32_t (&a)[4][4],
                                         uint64_t db, uint64_t db2) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_n64(acc, a[kk], db + kk * (16 * kRowBytes >> 4));
  if constexpr (WIDE) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n16(acc2, a[kk], db2 + kk * (16 * kRow2Bytes >> 4));
  }
}

// An accumulator of a 64-column product (S's layout: warp w of the group,
// lane l holds rows 16w + l/4 (r0) and r0 + 8, columns 8j + 2(l%4) + {0, 1}
// in s[4j + {0, 1}] (r0) and s[4j + {2, 3}] (r0 + 8)) rounded to bf16 is
// the A fragment of a product whose depth is those 64 columns: one
// fragment per 16-column step.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = dd::pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = dd::pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = dd::pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = dd::pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// Rows r0 and r0 + 8 (< lim) of an N / 2-wide accumulator (columns col0
// ...) times `mul`, as bf16 pairs into g (row stride ld), columns < d.
template <int N>
__device__ __forceinline__ void store_rows(bf16* g, const float (&acc)[N],
                                           float mul, int r0, int lim,
                                           int ld, int d, int col0 = 0) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int col = col0 + 8 * j + 2 * c;
    if (col >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r < lim)
        *reinterpret_cast<uint32_t*>(g + (size_t)r * ld + col) =
            dd::pack_bf16x2(acc[4 * j + 2 * h] * mul,
                            acc[4 * j + 2 * h + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------- dq
// dS = P (dP - delta) of one key tile (keys key0 ...) for rows r0 and
// r0 + 8, into s; P = ex2(s * scale_log2 - lse2), keys >= lk masked to
// P = 0 (last tile only).
__device__ __forceinline__ void dq_ds(float (&s)[32], const float (&dp)[32],
                                      const float (&lse2)[2],
                                      const float (&dlt)[2], int key0, int lk,
                                      float scale_log2) {
  if (key0 + kTile > lk) {
    const int col0 = key0 + 2 * (threadIdx.x & 3);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col0 + 8 * j + (e & 1) >= lk) s[4 * j + e] = -INFINITY;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    const float p = ex2(fmaf(s[i], scale_log2, -lse2[r]));
    s[i] = p * (dp[i] - dlt[r]);
  }
}

// Work item: 128 queries of one (row, head) (a: Q, b: dO); the ring
// streams K (c) and V (d) in tiles of 64 keys.
// KSTEPS = ceil(d / 16); at 5 (d = 72, 80) every tile also has its second
// box (maps tq2 .. tv2, unread below 5).
template <int KSTEPS>
__global__ void __launch_bounds__(kThreads, 1)
    sm90_bwd_dq_kernel(__grid_constant__ const CUtensorMap tq,
                       __grid_constant__ const CUtensorMap tdo,
                       __grid_constant__ const CUtensorMap tk,
                       __grid_constant__ const CUtensorMap tv,
                       __grid_constant__ const CUtensorMap tq2,
                       __grid_constant__ const CUtensorMap tdo2,
                       __grid_constant__ const CUtensorMap tk2,
                       __grid_constant__ const CUtensorMap tv2,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dq, int batch, int lq, int lk,
                       int heads, int d, float scale, float scale_log2) {
  constexpr bool kWide = KSTEPS == 5;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 128-byte swizzled TMA tiles need 1024-byte alignment
  const Layout sm((saddr(smem_raw) + 1023) & ~1023u, kWide);
  const int tid = threadIdx.x;
  const int n_blocks = (lq + kRows - 1) / kRows;
  const int n_items = n_blocks * heads * batch;
  const int n_tiles = (lk + kTile - 1) / kTile;

  if (tid == 0) init_barriers(sm);
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumers)
      produce<kWide>(sm, &tq, &tdo, &tk, &tv, &tq2, &tdo2, &tk2, &tv2,
                     n_blocks, heads, n_items, n_tiles);
  } else {
    // ---- two consumer warpgroups, 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;

    float s[32], dp[32], acc[32], lse2[2], dlt[2];
    float acc2[kWide ? 8 : 1];  // dq's columns 64..79
    uint32_t ds[4][4];
    int kv = 0, it = 0;
#pragma unroll 1
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++it) {
      const int blk = w % n_blocks, head = (w / n_blocks) % heads,
                row = w / (n_blocks * heads);
      const int ib = it & 1;
      const uint64_t dqa = desc_sw128(sm.a + ib * kItemBytes +
                                      wg * 64 * kRowBytes);
      const uint64_t doa = desc_sw128(sm.b + ib * kItemBytes +
                                      wg * 64 * kRowBytes);
      const uint64_t dqa2 = desc_sw32(sm.a2 + ib * kItem2Bytes +
                                      wg * 64 * kRow2Bytes);
      const uint64_t doa2 = desc_sw32(sm.b2 + ib * kItem2Bytes +
                                      wg * 64 * kRow2Bytes);
      // lse (log2 domain) and delta of rows r0, r0 + 8; rows >= lq get 0
      // (their dO is zero, so dS is)
      const int r0 = blk * kRows + wg * 64 + warp * 16 + (lane >> 2);
      const size_t rh = ((size_t)row * heads + head) * lq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = r0 + 8 * r;
        lse2[r] = qi < lq ? lse[rh + qi] * dd::kLog2e : 0.f;
        dlt[r] = qi < lq ? delta[rh + qi] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      if constexpr (kWide) {
#pragma unroll
        for (int i = 0; i < 8; ++i) acc2[i] = 0.f;
      }
      mbar_wait(sm.ifull(ib), (it >> 1) & 1);

      // key tile 0: S and dP only
      int st = kv % kStages;
      mbar_wait(sm.full(st), (kv / kStages) & 1);
      wg_fence();
      issue_ss<KSTEPS>(s, dqa, desc_sw128(sm.c + st * kTileBytes), dqa2,
                       desc_sw32(sm.c2 + st * kTile2Bytes));
      issue_ss<KSTEPS>(dp, doa, desc_sw128(sm.d + st * kTileBytes), doa2,
                       desc_sw32(sm.d2 + st * kTile2Bytes));
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      dq_ds(s, dp, lse2, dlt, 0, lk, scale_log2);
      pack_a(ds, s);
      int prev = st;
      ++kv;

      // key tile t: S and dP of t and dQ += dS K of t - 1 issued together;
      // the exponentials of t run while dS K is in flight
#pragma unroll 1
      for (int t = 1; t < n_tiles; ++t, ++kv) {
        st = kv % kStages;
        mbar_wait(sm.full(st), (kv / kStages) & 1);
        wg_fence();
        issue_ss<KSTEPS>(s, dqa, desc_sw128(sm.c + st * kTileBytes), dqa2,
                         desc_sw32(sm.c2 + st * kTile2Bytes));
        issue_ss<KSTEPS>(dp, doa, desc_sw128(sm.d + st * kTileBytes), doa2,
                         desc_sw32(sm.d2 + st * kTile2Bytes));
        wg_commit();
        issue_rs<kWide>(acc, acc2, ds, desc_sw128(sm.c + prev * kTileBytes),
                        desc_sw32(sm.c2 + prev * kTile2Bytes));
        wg_commit();
        wg_wait<1>();
        fence_regs(s);
        fence_regs(dp);
        dq_ds(s, dp, lse2, dlt, t * kTile, lk, scale_log2);
        wg_wait<0>();
        fence_regs(acc);
        if constexpr (kWide) fence_regs(acc2);
        __syncwarp();
        if (lane == 0) mbar_arrive(sm.empty(prev));
        pack_a(ds, s);
        prev = st;
      }

      // every product that reads Q and dO is done: the buffer is free
      if (lane == 0) mbar_arrive(sm.iempty(ib));
      wg_fence();
      issue_rs<kWide>(acc, acc2, ds, desc_sw128(sm.c + prev * kTileBytes),
                      desc_sw32(sm.c2 + prev * kTile2Bytes));
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
      if constexpr (kWide) fence_regs(acc2);
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty(prev));

      const int ld = heads * d;
      bf16* g = dq + (size_t)row * lq * ld + (size_t)head * d;
      store_rows(g, acc, scale, r0, lq, ld, d);
      if constexpr (kWide) store_rows(g, acc2, scale, r0, lq, ld, d, 64);
    }
  }
}

// -------------------------------------------------------------------- dk/dv
// P^T and dS^T = P^T (dP^T - delta) of one query tile, rows (keys) r0 and
// r0 + 8, columns (queries) 8j + 2c + {0, 1}: P^T into s, dS^T into dp.
// sl holds the tile's lse (log2 domain; +inf for queries >= lq, so their
// P is 0) and delta (0 there).
__device__ __forceinline__ void dkv_p_ds(float (&s)[32], float (&dp)[32],
                                         const float* sl, float scale_log2) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(sl + 8 * j + 2 * c);
    const float2 dl =
        *reinterpret_cast<const float2*>(sl + kTile + 8 * j + 2 * c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const float p = ex2(fmaf(s[i], scale_log2, (e & 1) ? -l.y : -l.x));
      s[i] = p;
      dp[i] = p * (dp[i] - ((e & 1) ? dl.y : dl.x));
    }
  }
}

// Work item: 128 keys of one (row, head) (a: K, b: V); the ring streams Q
// (c) and dO (d) in tiles of 64 queries.
template <int KSTEPS>
__global__ void __launch_bounds__(kThreads, 1)
    sm90_bwd_dkv_kernel(__grid_constant__ const CUtensorMap tk,
                        __grid_constant__ const CUtensorMap tv,
                        __grid_constant__ const CUtensorMap tq,
                        __grid_constant__ const CUtensorMap tdo,
                        __grid_constant__ const CUtensorMap tk2,
                        __grid_constant__ const CUtensorMap tv2,
                        __grid_constant__ const CUtensorMap tq2,
                        __grid_constant__ const CUtensorMap tdo2,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                        int batch, int lq, int lk, int heads, int d,
                        float scale, float scale_log2) {
  constexpr bool kWide = KSTEPS == 5;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // per warpgroup, two tiles' lse (log2 domain) then delta
  __shared__ __align__(16) float sld[2][2][2 * kTile];
  const Layout sm((saddr(smem_raw) + 1023) & ~1023u, kWide);
  const int tid = threadIdx.x;
  const int n_blocks = (lk + kRows - 1) / kRows;
  const int n_items = n_blocks * heads * batch;
  const int n_tiles = (lq + kTile - 1) / kTile;

  if (tid == 0) init_barriers(sm);
  __syncthreads();

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumers)
      produce<kWide>(sm, &tk, &tv, &tq, &tdo, &tk2, &tv2, &tq2, &tdo2,
                     n_blocks, heads, n_items, n_tiles);
  } else {
    // ---- two consumer warpgroups, 64 key rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    // ping-pong: warpgroup wg issues its products on barrier 1 + wg and
    // hands the turn to the other; warpgroup 1 lets warpgroup 0 go first
    // and leaves its last turn of the block unpassed (nobody takes it)
    const int my_bar = 1 + wg, other_bar = 2 - wg;
    if (wg == 1) bar_arrive<kConsumers>(other_bar);

    // thread i of the warpgroup stages lse (i < 64) or delta (i >= 64) of
    // query (i & 63) of each tile, fetched one tile ahead
    const int i = tid & 127;
    const float* src = i < kTile ? lse : delta;
    auto fetch = [&](int w, int t) {
      const int head = (w / n_blocks) % heads, row = w / (n_blocks * heads);
      const int qi = t * kTile + (i & (kTile - 1));
      if (qi >= lq) return i < kTile ? INFINITY : 0.f;
      const float x = src[((size_t)row * heads + head) * lq + qi];
      return i < kTile ? x * dd::kLog2e : x;
    };
    float nxt = blockIdx.x < n_items ? fetch(blockIdx.x, 0) : 0.f;

    float s[32], dp[32], ak[32], av[32];
    float ak2[kWide ? 8 : 1], av2[kWide ? 8 : 1];  // columns 64..79
    uint32_t pa[4][4], dsa[4][4];
    int kv = 0, it = 0;
#pragma unroll 1
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++it) {
      const int blk = w % n_blocks, head = (w / n_blocks) % heads,
                row = w / (n_blocks * heads);
      const bool last_item = w + (int)gridDim.x >= n_items;
      const int ib = it & 1;
      const uint64_t ka = desc_sw128(sm.a + ib * kItemBytes +
                                     wg * 64 * kRowBytes);
      const uint64_t va = desc_sw128(sm.b + ib * kItemBytes +
                                     wg * 64 * kRowBytes);
      const uint64_t ka2 = desc_sw32(sm.a2 + ib * kItem2Bytes +
                                     wg * 64 * kRow2Bytes);
      const uint64_t va2 = desc_sw32(sm.b2 + ib * kItem2Bytes +
                                     wg * 64 * kRow2Bytes);
#pragma unroll
      for (int j = 0; j < 32; ++j) ak[j] = av[j] = 0.f;
      if constexpr (kWide) {
#pragma unroll
        for (int j = 0; j < 8; ++j) ak2[j] = av2[j] = 0.f;
      }
      mbar_wait(sm.ifull(ib), (it >> 1) & 1);

      // this tile's lse and delta into shared memory (buffer kv & 1: the
      // last readers of that buffer passed the previous tile's barrier),
      // then the next tile's (or the next item's first) into nxt
      auto stage = [&](int t) {
        sld[wg][kv & 1][i] = nxt;
        bar_sync<128>(3 + wg);
        if (t + 1 < n_tiles)
          nxt = fetch(w, t + 1);
        else if (!last_item)
          nxt = fetch(w + gridDim.x, 0);
      };

      // query tile 0: S^T and dP^T only
      int st = kv % kStages;
      mbar_wait(sm.full(st), (kv / kStages) & 1);
      bar_sync<kConsumers>(my_bar);
      wg_fence();
      issue_ss<KSTEPS>(s, ka, desc_sw128(sm.c + st * kTileBytes), ka2,
                       desc_sw32(sm.c2 + st * kTile2Bytes));
      issue_ss<KSTEPS>(dp, va, desc_sw128(sm.d + st * kTileBytes), va2,
                       desc_sw32(sm.d2 + st * kTile2Bytes));
      wg_commit();
      if (wg == 0 || !(last_item && n_tiles == 1))
        bar_arrive<kConsumers>(other_bar);
      stage(0);
      wg_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      dkv_p_ds(s, dp, sld[wg][kv & 1], scale_log2);
      pack_a(pa, s);
      pack_a(dsa, dp);
      int prev = st;
      ++kv;

      // query tile t: S^T and dP^T of t, dV += P^T dO and dK += dS^T Q of
      // t - 1 issued together; the exponentials of t run meanwhile
#pragma unroll 1
      for (int t = 1; t < n_tiles; ++t, ++kv) {
        st = kv % kStages;
        mbar_wait(sm.full(st), (kv / kStages) & 1);
        bar_sync<kConsumers>(my_bar);
        wg_fence();
        issue_ss<KSTEPS>(s, ka, desc_sw128(sm.c + st * kTileBytes), ka2,
                         desc_sw32(sm.c2 + st * kTile2Bytes));
        issue_ss<KSTEPS>(dp, va, desc_sw128(sm.d + st * kTileBytes), va2,
                         desc_sw32(sm.d2 + st * kTile2Bytes));
        wg_commit();
        issue_rs<kWide>(av, av2, pa, desc_sw128(sm.d + prev * kTileBytes),
                        desc_sw32(sm.d2 + prev * kTile2Bytes));
        issue_rs<kWide>(ak, ak2, dsa, desc_sw128(sm.c + prev * kTileBytes),
                        desc_sw32(sm.c2 + prev * kTile2Bytes));
        wg_commit();
        if (wg == 0 || !(last_item && t + 1 == n_tiles))
          bar_arrive<kConsumers>(other_bar);
        stage(t);
        wg_wait<1>();
        fence_regs(s);
        fence_regs(dp);
        dkv_p_ds(s, dp, sld[wg][kv & 1], scale_log2);
        wg_wait<0>();
        fence_regs(av);
        fence_regs(ak);
        if constexpr (kWide) {
          fence_regs(av2);
          fence_regs(ak2);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(sm.empty(prev));
        pack_a(pa, s);
        pack_a(dsa, dp);
        prev = st;
      }

      // every product that reads K and V is done: the buffer is free
      if (lane == 0) mbar_arrive(sm.iempty(ib));
      wg_fence();
      issue_rs<kWide>(av, av2, pa, desc_sw128(sm.d + prev * kTileBytes),
                      desc_sw32(sm.d2 + prev * kTile2Bytes));
      issue_rs<kWide>(ak, ak2, dsa, desc_sw128(sm.c + prev * kTileBytes),
                      desc_sw32(sm.c2 + prev * kTile2Bytes));
      wg_commit();
      wg_wait<0>();
      fence_regs(av);
      fence_regs(ak);
      if constexpr (kWide) {
        fence_regs(av2);
        fence_regs(ak2);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty(prev));

      const int ld = heads * d;
      const int r0 = blk * kRows + wg * 64 + warp * 16 + (lane >> 2);
      const size_t off = (size_t)row * lk * ld + (size_t)head * d;
      store_rows(dk + off, ak, scale, r0, lk, ld, d);
      store_rows(dv + off, av, 1.f, r0, lk, ld, d);
      if constexpr (kWide) {
        store_rows(dk + off, ak2, scale, r0, lk, ld, d, 64);
        store_rows(dv + off, av2, 1.f, r0, lk, ld, d, 64);
      }
    }
  }
}

// ------------------------------------------------------------------- host
// The dynamic shared-memory size of dq's and dk/dv's instance KSTEPS.
template <int KSTEPS>
bool set_smem() {
  return cudaFuncSetAttribute(sm90_bwd_dq_kernel<KSTEPS>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<KSTEPS>()) == cudaSuccess &&
         cudaFuncSetAttribute(sm90_bwd_dkv_kernel<KSTEPS>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<KSTEPS>()) == cudaSuccess;
}

// Per device, once: the dynamic shared-memory size of each of the ten
// instances, set outside any stream capture, and the SM count (0 after a
// failure).
int prepare(int device) {
  static int sms[64] = {0};
  if (device < 0 || device >= 64) return 0;
  if (sms[device]) return sms[device];
  if (!set_smem<1>() || !set_smem<2>() || !set_smem<3>() || !set_smem<4>() ||
      !set_smem<5>())
    return 0;
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return 0;
  return sms[device] = n;
}

// Argument checks, the device's SM count and the tensor maps: the item's
// operands a, b (item_len rows, boxes of 128) and the streamed c, d
// (ring_len rows, boxes of 64), then, for head_dim > 64, their second
// boxes (16 columns at column 64; below that maps[4..7] repeat maps[0..3],
// unread).  Returns cudaSuccess or an error; the grid of a launch over
// `items` work items in *grid.
cudaError_t setup(const void* a, const void* b, const void* c,
                  const void* dd_, int item_len, int ring_len, int batch,
                  int heads, int head_dim, CUtensorMap (&maps)[8],
                  int* grid) {
  if (head_dim <= 0 || head_dim > 80 || batch <= 0 || item_len <= 0 ||
      ring_len <= 0 || heads <= 0 || batch > 65535 || heads > 65535)
    return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const int sms = prepare(device);
  if (sms == 0) return cudaErrorInvalidValue;
  const bool wide = head_dim > 64;
  for (int box = 0; box < (wide ? 2 : 1); ++box) {
    CUtensorMap* m = maps + 4 * box;
    const int w = box ? 16 : 64;
    if (!make_map(&m[0], a, batch, item_len, heads, head_dim, kRows, w) ||
        !make_map(&m[1], b, batch, item_len, heads, head_dim, kRows, w) ||
        !make_map(&m[2], c, batch, ring_len, heads, head_dim, kTile, w) ||
        !make_map(&m[3], dd_, batch, ring_len, heads, head_dim, kTile, w))
      return cudaErrorInvalidValue;
  }
  if (!wide)
    for (int i = 0; i < 4; ++i) maps[4 + i] = maps[i];
  const long long items =
      (long long)((item_len + kRows - 1) / kRows) * heads * batch;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  *grid = items > sms ? sms : (int)items;
  return cudaSuccess;
}

}  // namespace

// q, dout, dq (B, Lq, H*d), k, v (B, Lk, H*d): contiguous bf16, 16-byte
// aligned, d % 8 == 0 and d <= 80 (the packed and the split layout alike);
// lse and delta (B*H, Lq) float32.  Returns a cudaError_t.
extern "C" int dd_sm90_attention_bwd_dq(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dq, int batch, int lq, int lk,
                                        int heads, int head_dim, float scale,
                                        void* stream) {
  if (!dd::vec_ok(head_dim, q, k, v, dout, dq) || lk <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[8];
  int grid = 0;
  cudaError_t err = setup(q, dout, k, v, lq, lk, batch, heads, head_dim,
                          maps, &grid);
  if (err != cudaSuccess) return (int)err;
  auto kernel = sm90_bwd_dq_kernel<4>;
  switch ((head_dim + 15) / 16) {
    case 1: kernel = sm90_bwd_dq_kernel<1>; break;
    case 2: kernel = sm90_bwd_dq_kernel<2>; break;
    case 3: kernel = sm90_bwd_dq_kernel<3>; break;
    case 5: kernel = sm90_bwd_dq_kernel<5>; break;
  }
  const int smem = head_dim > 64 ? smem_bytes<5>() : smem_bytes<4>();
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7],
      static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), batch, lq, lk,
      heads, head_dim, scale, scale * dd::kLog2e);
  return (int)cudaGetLastError();
}

// The same inputs; dk, dv (B, Lk, H*d).
extern "C" int dd_sm90_attention_bwd_dkv(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dk, void* dv, int batch,
                                         int lq, int lk, int heads,
                                         int head_dim, float scale,
                                         void* stream) {
  if (!dd::vec_ok(head_dim, q, k, v, dout, dk, dv) || lq <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[8];
  int grid = 0;
  cudaError_t err = setup(k, v, q, dout, lk, lq, batch, heads, head_dim,
                          maps, &grid);
  if (err != cudaSuccess) return (int)err;
  auto kernel = sm90_bwd_dkv_kernel<4>;
  switch ((head_dim + 15) / 16) {
    case 1: kernel = sm90_bwd_dkv_kernel<1>; break;
    case 2: kernel = sm90_bwd_dkv_kernel<2>; break;
    case 3: kernel = sm90_bwd_dkv_kernel<3>; break;
    case 5: kernel = sm90_bwd_dkv_kernel<5>; break;
  }
  const int smem = head_dim > 64 ? smem_bytes<5>() : smem_bytes<4>();
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7],
      static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), batch, lq, lk, heads, head_dim, scale,
      scale * dd::kLog2e);
  return (int)cudaGetLastError();
}
