// Attention forward for Hopper (sm_90a): TMA, wgmma, warp specialisation.
//
// What it replaces.  Seven TPU kernels of dualdiff_tpu/ops/attention.py, one
// function: softmax(scale q k^T) v per (row, head), keys >= Lk masked to
// -inf exactly, float32 softmax, P rounded to bf16 for the second product,
// bf16 output.  Without lse (LSE = false): _fwd_kernel_t (called by
// _packed_infer), _fwd_kernel_t_capped (called by _packed_infer_capped over
// the VMEM score cap) and _fwd_kernel_nolse (called by _fwd_core for the
// split-layout flash_attention), behind packed_attention_fwd,
// packed_attention_capped_fwd and flash_attention_fwd.  With lse (LSE =
// true: also lse = log sum_k exp(scale q.k), float32, (B*H, Lq)):
// _fwd_kernel_t_lse and _fwd_kernel_t_capped_lse (called by
// _packed_train_t_fwd) and _fwd_kernel (called by _fwd_core), behind
// packed_attention_lse_fwd, packed_attention_capped_lse_fwd and
// flash_attention_lse_fwd; the backward kernels read that lse.  The camera
// ring (NBR = true): _fwd_kernel_t_nbr (dualdiff_tpu/ops/attention.py:671,
// called by _flash_packed_nbr :1059), behind packed_attention_nbr_fwd: for
// row r = b N + n, attn(q_r, K/V of row b N + (n-1) mod N) + attn(q_r, K/V
// of row b N + (n+1) mod N), each half its own softmax and normalised
// alone, the two summed in float32 and rounded to bf16 once (the TPU kernel
// rounds each half to bf16 before the sum).  All for head dims d <= 80 with
// d % 8 == 0 and 16-byte aligned rows (ops/attention.py::sm90_in_scope);
// every other shape stays on attention.cu's mma.sync template.  A
// contiguous (B, L, H, D) tensor is the packed (B, L, C) memory, so the
// packed and the split layout are one layout.
//
// What bounds it.  At the flagship's 24 x 1400 x 1400 (C = 320, 8 heads,
// d = 40) a call is 60.2 GFLOP, 61 us at 989 TFLOP/s, against 86 MB (26 us
// at 3.35 TB/s), and 376 M exponentials: about 96 us at the SFU's 16 per
// clock per SM.  The video ST-Attn (96 x 1400 x 2800) is 0.487 ms of FLOPs
// and 3.0 G exponentials, about 0.78 ms.  The ring does two such
// attentions per query: 120 GFLOP (0.122 ms) and 752 M exponentials (about
// 0.18 ms) at 24 x 1400 x 1400, four times that for a clip's 96 rows.  So
// the floor is the exponentials, and a kernel that runs them in lock-step
// with its matrix products pays both: attention.cu's template, one 16-row
// mma.sync tile per warp, ran at 6.4-8.4x the FLOP bound (the ring at 7.6x).
//
// Design.
// - A work item is 128 queries of one (row, head): two consumer warpgroups
//   of 64 rows each and one producer warp (a third warpgroup whose other
//   three warps exit at once).  setmaxnreg moves registers from the
//   producer warpgroup (24 a thread) to the consumers (240).
// - Grid: persistent, one block per SM walking the items.  It beat one
//   block per item at every measured shape, most at short K: the producer
//   loads the next item's q tile and first K/V tiles while the consumers
//   finish the current one (attn2, 24 x 1400 x 158, on an H100 80GB HBM3
//   at 700 W: 0.0618 against 0.0960 ms; PERF.md, kernel table).
// - The producer loads q tiles into two buffers and K/V tiles of 128 keys
//   into a ring of kStages stages with TMA, each buffer and stage guarded
//   by a "full" mbarrier (transaction bytes) and an "empty" one (the 8
//   consumer warps).
// - q, k and v are described to TMA as 4-D tensors (d, H, L, B) with
//   byte strides 2d, 2C and 2LC, multiples of 16 for every d % 8 == 0.  A
//   64-element inner box with 128-byte swizzle reads one head's d columns
//   at column h*d and zero-fills columns d..63 and rows past L, so every
//   tile is the padded 64-wide, 128-row tile wgmma wants with no masking
//   code and no read of the next head.
// - Head dims 72 and 80 (HD's second level; KSTEPS = 5): every tile adds a
//   second box, 16 columns at column 64 with 32-byte swizzle (4 KB a
//   128-row tile, the d..79 columns zero-filled at d = 72), loaded under
//   the same mbarrier as the first (the transaction bytes count both).
//   Shared memory is 2 q buffers and 3 K/V stages of 16 + 4 KB: 161 KB
//   against 129 KB below d = 65, one block an SM either way.  A zero-padded
//   128-wide row (two 128-byte boxes) would need 256 KB, so a ring stage or
//   a q buffer less, and pay 1.6x on the MN-major product.
// - S = Q K^T: wgmma m64n128k16, Q and K from shared memory, K-major, in
//   ceil(d / 16) depth steps (48 of the 64 padded columns at d = 40); at
//   d = 72, 80 four over the first box and the fifth over the second
//   (desc_sw32).
// - O += P V: wgmma m64n64k16 with P from registers (S's accumulator
//   rounded to bf16 is already the A fragment layout) and V from shared
//   memory as an MN-major B operand.  N stays 64: an MN-major swizzled
//   operand is whole 64-element atoms, so d = 40 pays 1.6x on this product
//   (1.4x over both), under the exponential floor.  At d = 72, 80 also
//   m64n16k16 over V's second box, into 8 more accumulator floats a thread
//   (o2; the ring keeps 8 more in kept2): no padding at d = 80, and the
//   FLOP bound over the exp floor (at 24 x 1296 x 1296 on an H100 SXM at
//   700 W, 989 TFLOP/s and 1980 MHz: 0.1043 against 0.0771 ms).
// - Online softmax in float32 registers; the scale and log2(e) fold into
//   one FMA before ex2.approx; the key mask runs in the last key tile only.
// - Overlap.  Within a warpgroup, tile t's S product is issued together
//   with tile t-1's P V product, and tile t's softmax runs while P V is in
//   flight.  Across the two warpgroups, named barriers hand the tensor
//   cores over in turns (ping-pong): one warpgroup issues its products
//   while the other runs its exponentials.
// - Output: the normalised accumulator rounded to bf16, stored from
//   registers as 4-byte pairs, rows < Lq and columns < d only.  With lse,
//   the first lane of each quad (the quad holds the whole row sum l after
//   two shuffles) also stores lse = m scale + ln l of its two rows < Lq: 4
//   bytes a query row against 2d of output.
// - The ring (NBR).  Both neighbours belong to one item: nothing carries
//   over between blocks, so two items could only be summed with atomics or
//   a second pass over a bf16 output.  The q tile is loaded once; the
//   producer then streams the left view's K/V tiles and the right view's
//   through the same ring, K/V read in place (only the row coordinate of
//   the TMA box differs).  The consumers walk the 2 n_tiles tiles as one
//   sequence, so the S(t) || P V(t-1) overlap runs across the boundary and
//   an item pays one prologue: pass 1's first S product goes out with pass
//   0's last P V.  After that P V the consumers keep pass 0's output,
//   normalised by its own l, in 32 more float registers a thread (kept),
//   reset o, m and l in place of the rescale by alpha (so the two passes
//   never mix), and add kept to pass 1's normalised output at the store.
// - Host: tensor maps are encoded per call through cuTensorMapEncodeTiled,
//   found with cudaGetDriverEntryPoint (no -lcuda), passed as
//   __grid_constant__ parameters (the second boxes' three only above d =
//   64; below, the first three again, unread); each instance's dynamic
//   shared-memory size (smem_bytes<KSTEPS>) is set once per device,
//   outside any stream capture.
// - Registers: -Xptxas=-v (kept in build/dualdiff_tpu_torch/
//   attention_sm90-*.log) reports 0 bytes of spill for all fifteen
//   instances.
// - What it reaches at d = 80 (PERF.md, HD table; an H100 80GB HBM3 at
//   700 W): 0.2547 ms at 24 x 1296 x 1296 against the template's 0.6379
//   and SDPA's fastest (cuDNN) 0.3270; the ring at 24 x 1296 0.5327
//   against 1.2990.
//
// Not tried yet: 48-wide K tiles for P V (an MN-major operand narrower
// than its 64-element swizzle atom), a TMA store of the output, two blocks
// an SM (registers allow one).

#include "sm90.cuh"

namespace {

using dd::bf16;
using namespace dd::sm90;

constexpr int kQ = 128;             // queries per block
constexpr int kKeys = 128;          // keys per tile
constexpr int kStages = 3;          // K/V ring depth
constexpr int kRowBytes = 128;      // one 64-wide bf16 row, swizzled
constexpr int kTileBytes = kKeys * kRowBytes;  // 16 KB, q tile too
// d = 72 and 80 (KSTEPS = 5): a second box of columns 64..79 per tile
constexpr int kRow2Bytes = 32;      // one 16-wide bf16 row, swizzled
constexpr int kTile2Bytes = kKeys * kRow2Bytes;  // 4 KB, q tile too
constexpr int kConsumers = 256;     // two warpgroups
constexpr int kThreads = kConsumers + 128;

// 2 q buffers and the K/V ring (with KSTEPS = 5 also their second boxes),
// 10 mbarriers, 1024 bytes of alignment slack: 132,224 bytes at KSTEPS
// 1-4, 164,992 at 5
template <int KSTEPS>
constexpr int smem_bytes() {
  return (kTileBytes + (KSTEPS == 5 ? kTile2Bytes : 0)) * (2 + 2 * kStages) +
         128 + 1024;
}

// ------------------------------------------------------------------ kernel
// Accumulator layout (wgmma m64nN, per warpgroup): warp w of the group,
// lane l holds rows 16w + l/4 (r0) and r0 + 8, columns 8j + 2(l%4) + {0, 1}
// in d[4j + {0, 1}] (r0) and d[4j + {2, 3}] (r0 + 8).

// One key tile (keys key0 ...) of the online softmax for rows r0 and r0 + 8:
// mask keys >= lk (last tile only), update m and l, turn s into P (float32) and return
// the rescale factor of each row.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2],
                                             float (&alpha)[2], int key0,
                                             int lk, float scale_log2) {
  if (key0 + kKeys > lk) {
    const int col0 = key0 + 2 * (threadIdx.x & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col0 + 8 * j + (e & 1) >= lk) s[4 * j + e] = -INFINITY;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // finite: key 0 is real, so a row's first tile has a finite score
    alpha[r] = ex2((m[r] - mx) * scale_log2);
    m[r] = mx;
    const float neg = -mx * scale_log2;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = ex2(fmaf(s[4 * j + 2 * r + e], scale_log2, neg));
        s[4 * j + 2 * r + e] = x;
        sum += x;
      }
    l[r] = l[r] * alpha[r] + sum;
  }
}

// P (float32, S's layout) -> bf16 A fragments of the P . V product, one
// per 16-key depth step.
__device__ __forceinline__ void pack_p(uint32_t (&p)[8][4],
                                       const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    p[kk][0] = dd::pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = dd::pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = dd::pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = dd::pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// S = Q K^T: min(KSTEPS, 4) depth steps over the first boxes (dq, dk),
// and with KSTEPS = 5 a fifth over the second (dq2, dk2)
template <int KSTEPS>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint64_t dq,
                                         uint64_t dk, uint64_t dq2,
                                         uint64_t dk2) {
#pragma unroll
  for (int kt = 0; kt < (KSTEPS < 4 ? KSTEPS : 4); ++kt)
    wgmma_ss_n128(s, dq + 2 * kt, dk + 2 * kt, kt);  // 32 bytes a step
  if constexpr (KSTEPS == 5) wgmma_ss_n128(s, dq2, dk2, 1);
}

// O += P V: columns 0..63 from V's first box (dv) into o and, WIDE,
// columns 64..79 from its second (dv2) into o2
template <bool WIDE>
__device__ __forceinline__ void issue_pv(float (&o)[32],
                                         float (&o2)[WIDE ? 8 : 1],
                                         const uint32_t (&p)[8][4],
                                         uint64_t dv, uint64_t dv2) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)  // 16 keys = 2048 bytes a step
    wgmma_rs_n64(o, p[kk], dv + kk * (16 * kRowBytes >> 4));
  if constexpr (WIDE) {
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)  // 16 keys = 512 bytes a step
      wgmma_rs_n16(o2, p[kk], dv2 + kk * (16 * kRow2Bytes >> 4));
  }
}

// Work item w: query tile w % n_qt of head (w / n_qt) % heads of row
// w / (n_qt * heads); consecutive blocks share a head's K/V in L2.  A block
// walks items blockIdx.x, blockIdx.x + gridDim.x, ... (one item when the
// grid covers them all).  KSTEPS = ceil(d / 16); at 5 (d = 72, 80) every
// tile also has its second box (maps tq2, tk2, tv2, unread below 5).
// LSE: also write lse (B*H, Lq) float32 (unread and may be null without
// it).  NBR: the camera ring over n_cam views a batch (lq == lk; n_cam,
// n_local and view0 unread without it): q row r is global view view0 +
// r % n_local of sample r / n_local, and K/V (n_cam views a sample, their
// own maps' batch) are read at that sample's rows of views -1 and +1 mod
// n_cam of it; n_local == n_cam, view0 == 0 is the whole ring.
template <int KSTEPS, bool LSE, bool NBR>
__global__ void __launch_bounds__(kThreads, 1)
    sm90_attention_kernel(__grid_constant__ const CUtensorMap tq,
                          __grid_constant__ const CUtensorMap tk,
                          __grid_constant__ const CUtensorMap tv,
                          __grid_constant__ const CUtensorMap tq2,
                          __grid_constant__ const CUtensorMap tk2,
                          __grid_constant__ const CUtensorMap tv2,
                          bf16* __restrict__ out, float* __restrict__ lse,
                          int batch, int lq, int lk, int heads, int d,
                          int n_cam, int n_local, int view0,
                          float scale_log2) {
  static_assert(!(NBR && LSE), "the ring kernel writes no lse");
  constexpr bool kWide = KSTEPS == 5;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 128-byte swizzled TMA tiles need 1024-byte alignment
  const uint32_t base = (saddr(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;  // 2 q buffers
  const uint32_t sk = sq + 2 * kTileBytes;
  const uint32_t sv = sk + kStages * kTileBytes;
  // the second boxes (kWide), each 4 KB: 2 q buffers, the K/V ring
  const uint32_t sq2 = sv + kStages * kTileBytes;
  const uint32_t sk2 = sq2 + 2 * kTile2Bytes;
  const uint32_t sv2 = sk2 + kStages * kTile2Bytes;
  const uint32_t bars = kWide ? sv2 + kStages * kTile2Bytes : sq2;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  auto qfull = [&](int b) { return bars + 8 * (2 * kStages + b); };
  auto qempty = [&](int b) { return bars + 8 * (2 * kStages + 2 + b); };

  const int tid = threadIdx.x;
  const int n_qt = (lq + kQ - 1) / kQ;
  const int n_items = n_qt * heads * batch;
  const int n_tiles = (lk + kKeys - 1) / kKeys;
  // key tiles an item walks: the ring's two passes are one sequence
  const int n_steps = NBR ? 2 * n_tiles : n_tiles;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers / 32);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(qfull(b), 1);
      mbar_init(qempty(b), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumers) {
      int kv = 0, it = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++it) {
        const int qt = w % n_qt, head = (w / n_qt) % heads,
                  row = w / (n_qt * heads);
        const int qb = it & 1;
        if (it >= 2) mbar_wait(qempty(qb), ((it >> 1) - 1) & 1);
        mbar_expect_tx(qfull(qb), kTileBytes + (kWide ? kTile2Bytes : 0));
        tma_load(sq + qb * kTileBytes, &tq, qfull(qb), 0, head, qt * kQ,
                 row);
        if constexpr (kWide)
          tma_load(sq2 + qb * kTile2Bytes, &tq2, qfull(qb), 64, head,
                   qt * kQ, row);
        for (int u = 0; u < n_steps; ++u, ++kv) {
          // the ring: tiles of the left view (n - 1), then the right (n + 1)
          int kv_row = row, t = u;
          if (NBR) {
            const int b = row / n_local, n = view0 + row - b * n_local;
            const bool right = u >= n_tiles;
            kv_row = b * n_cam + (n + (right ? 1 : n_cam - 1)) % n_cam;
            if (right) t -= n_tiles;
          }
          const int s = kv % kStages;
          if (kv >= kStages) mbar_wait(empty(s), ((kv / kStages) - 1) & 1);
          mbar_expect_tx(full(s),
                         2 * (kTileBytes + (kWide ? kTile2Bytes : 0)));
          tma_load(sk + s * kTileBytes, &tk, full(s), 0, head, t * kKeys,
                   kv_row);
          tma_load(sv + s * kTileBytes, &tv, full(s), 0, head, t * kKeys,
                   kv_row);
          if constexpr (kWide) {
            tma_load(sk2 + s * kTile2Bytes, &tk2, full(s), 64, head,
                     t * kKeys, kv_row);
            tma_load(sv2 + s * kTile2Bytes, &tv2, full(s), 64, head,
                     t * kKeys, kv_row);
          }
        }
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int c = lane & 3;
    // ping-pong: warpgroup wg issues its products on barrier 1 + wg and
    // hands the turn to the other; warpgroup 1 lets warpgroup 0 go first
    // and leaves its last turn of the block unpassed (nobody takes it)
    const int my_bar = 1 + wg, other_bar = 2 - wg;
    if (wg == 1) bar_arrive<kConsumers>(other_bar);

    float s[64], o[32], m[2], l[2], alpha[2];
    float o2[kWide ? 8 : 1];  // columns 64..79
    // the ring's pass 0 output, normalised
    float kept[NBR ? 32 : 1], kept2[NBR && kWide ? 8 : 1];
    uint32_t p[8][4];
    int kv = 0, it = 0;
#pragma unroll 1
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++it) {
      const int qt = w % n_qt, head = (w / n_qt) % heads,
                row = w / (n_qt * heads);
      const bool last_item = w + (int)gridDim.x >= n_items;
      const int qb = it & 1;
      const uint64_t dq =
          desc_sw128(sq + qb * kTileBytes + wg * 64 * kRowBytes);
      const uint64_t dq2 =
          desc_sw32(sq2 + qb * kTile2Bytes + wg * 64 * kRow2Bytes);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      if constexpr (kWide) {
#pragma unroll
        for (int i = 0; i < 8; ++i) o2[i] = 0.f;
      }
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
      mbar_wait(qfull(qb), (it >> 1) & 1);

      // key tile 0: S only
      int st = kv % kStages;
      mbar_wait(full(st), (kv / kStages) & 1);
      bar_sync<kConsumers>(my_bar);
      wg_fence();
      issue_qk<KSTEPS>(s, dq, desc_sw128(sk + st * kTileBytes), dq2,
                       desc_sw32(sk2 + st * kTile2Bytes));
      wg_commit();
      if (wg == 0 || !(last_item && n_steps == 1))
        bar_arrive<kConsumers>(other_bar);
      wg_wait<0>();
      fence_regs(s);
      softmax_tile(s, m, l, alpha, 0, lk, scale_log2);
      pack_p(p, s);
      int prev = st;
      ++kv;

      // key tile u: S of u and P . V of u - 1 issued together; the
      // softmax of u runs while P . V is in flight.  The ring's pass 1
      // starts at u = n_tiles (the boundary), without a prologue of its own
#pragma unroll 1
      for (int u = 1; u < n_steps; ++u, ++kv) {
        const bool boundary = NBR && u == n_tiles;
        const int t = NBR && u >= n_tiles ? u - n_tiles : u;
        st = kv % kStages;
        mbar_wait(full(st), (kv / kStages) & 1);
        bar_sync<kConsumers>(my_bar);
        wg_fence();
        issue_qk<KSTEPS>(s, dq, desc_sw128(sk + st * kTileBytes), dq2,
                         desc_sw32(sk2 + st * kTile2Bytes));
        wg_commit();
        issue_pv<kWide>(o, o2, p, desc_sw128(sv + prev * kTileBytes),
                        desc_sw32(sv2 + prev * kTile2Bytes));
        wg_commit();
        if (wg == 0 || !(last_item && u + 1 == n_steps))
          bar_arrive<kConsumers>(other_bar);
        wg_wait<1>();
        fence_regs(s);
        float l0[2] = {l[0], l[1]};  // at the boundary: pass 0's sums
        if (boundary) {  // pass 1's softmax starts afresh
          m[0] = m[1] = -INFINITY;
          l[0] = l[1] = 0.f;
        }
        softmax_tile(s, m, l, alpha, t * kKeys, lk, scale_log2);
        wg_wait<0>();
        fence_regs(o);
        if constexpr (kWide) fence_regs(o2);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(prev));
        if constexpr (NBR) {
          if (boundary) {
            // o holds the whole of pass 0: keep it normalised, start anew
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              l0[r] += __shfl_xor_sync(0xffffffffu, l0[r], 1);
              l0[r] += __shfl_xor_sync(0xffffffffu, l0[r], 2);
              l0[r] = 1.f / l0[r];
            }
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              kept[i] = o[i] * l0[(i >> 1) & 1];
              o[i] = 0.f;
            }
            if constexpr (kWide) {
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                kept2[i] = o2[i] * l0[(i >> 1) & 1];
                o2[i] = 0.f;
              }
            }
          }
        }
        if (!boundary) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[4 * j + 0] *= alpha[0];
            o[4 * j + 1] *= alpha[0];
            o[4 * j + 2] *= alpha[1];
            o[4 * j + 3] *= alpha[1];
          }
          if constexpr (kWide) {
#pragma unroll
            for (int i = 0; i < 8; ++i) o2[i] *= alpha[(i >> 1) & 1];
          }
        }
        pack_p(p, s);
        prev = st;
      }

      // every S product of this item is done: the q buffer is free
      if (lane == 0) mbar_arrive(qempty(qb));
      wg_fence();
      issue_pv<kWide>(o, o2, p, desc_sw128(sv + prev * kTileBytes),
                      desc_sw32(sv2 + prev * kTile2Bytes));
      wg_commit();
      wg_wait<0>();
      fence_regs(o);
      if constexpr (kWide) fence_regs(o2);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(prev));

      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = 1.f / l[r];
      }
      const int ld = heads * d;
      const int r0 = qt * kQ + wg * 64 + warp * 16 + (lane >> 2);
      bf16* g = out + (size_t)row * lq * ld + (size_t)head * d;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * c;
        if (col >= d) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          float x0 = o[4 * j + 2 * h] * inv[h];
          float x1 = o[4 * j + 2 * h + 1] * inv[h];
          if constexpr (NBR) {  // the two halves summed in float32
            x0 += kept[4 * j + 2 * h];
            x1 += kept[4 * j + 2 * h + 1];
          }
          if (r < lq)
            *reinterpret_cast<uint32_t*>(g + (size_t)r * ld + col) =
                dd::pack_bf16x2(x0, x1);
        }
      }
      if constexpr (kWide) {  // columns 64 .. d-1
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 64 + 8 * j + 2 * c;
          if (col >= d) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            float x0 = o2[4 * j + 2 * h] * inv[h];
            float x1 = o2[4 * j + 2 * h + 1] * inv[h];
            if constexpr (NBR) {
              x0 += kept2[4 * j + 2 * h];
              x1 += kept2[4 * j + 2 * h + 1];
            }
            if (r < lq)
              *reinterpret_cast<uint32_t*>(g + (size_t)r * ld + col) =
                  dd::pack_bf16x2(x0, x1);
          }
        }
      }
      if constexpr (LSE) {
        // m is the raw maximum: l = sum 2^((s - m) scale log2e), so
        // lse = m scale + ln l, in the natural log of the scaled logits
        if (c == 0) {
          float* lg = lse + ((size_t)row * heads + head) * lq;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (r0 + 8 * h < lq)
              lg[r0 + 8 * h] = m[h] * scale_log2 * dd::kLn2 + logf(l[h]);
        }
      }
    }
  }
}

// The dynamic shared-memory size of one instance.
template <int KSTEPS, bool LSE, bool NBR>
bool set_smem() {
  return cudaFuncSetAttribute(sm90_attention_kernel<KSTEPS, LSE, NBR>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<KSTEPS>()) == cudaSuccess;
}

template <bool LSE, bool NBR>
bool set_smem_all() {
  return set_smem<1, LSE, NBR>() && set_smem<2, LSE, NBR>() &&
         set_smem<3, LSE, NBR>() && set_smem<4, LSE, NBR>() &&
         set_smem<5, LSE, NBR>();
}

// Per device, once: the dynamic shared-memory size of each of the fifteen
// instances (without and with lse, the ring; each at KSTEPS 1-5), set
// outside any stream capture, and the SM count (0 after a failure).  A
// launch of an instance left out here fails.
int prepare(int device) {
  static int sms[64] = {0};
  if (device < 0 || device >= 64) return 0;
  if (sms[device]) return sms[device];
  if (!set_smem_all<false, false>() || !set_smem_all<true, false>() ||
      !set_smem_all<false, true>())
    return 0;
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return 0;
  return sms[device] = n;
}

// The three entries' shared checks, tensor maps and launch.  NBR: lq ==
// lk, q batch rows of n_local views each (global views view0 .. view0 +
// n_local - 1 of n_cam), K/V batch / n_local samples of n_cam views.
template <bool LSE, bool NBR>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int batch, int lq, int lk, int heads, int head_dim,
           int n_cam, int n_local, int view0, float scale, void* stream) {
  if (head_dim <= 0 || head_dim > 80 || !dd::vec_ok(head_dim, q, k, v, out) ||
      batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || batch > 65535 ||
      heads > 65535 || (LSE && lse == nullptr) ||
      (NBR && (n_local < 1 || n_local > n_cam || batch % n_local ||
               view0 < 0 || view0 + n_local > n_cam || lq != lk ||
               (long long)batch / n_local * n_cam > 65535)))
    return (int)cudaErrorInvalidValue;
  // K/V rows: the q rows' samples, all n_cam views each (the ring's)
  const int batch_kv = NBR ? batch / n_local * n_cam : batch;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const int sms = prepare(device);
  if (sms == 0) return (int)cudaErrorInvalidValue;
  const bool wide = head_dim > 64;
  // the second boxes' maps; below d = 65 the kernel reads none of them
  CUtensorMap tq, tk, tv, tq2, tk2, tv2;
  if (!make_map(&tq, q, batch, lq, heads, head_dim, kQ) ||
      !make_map(&tk, k, batch_kv, lk, heads, head_dim, kKeys) ||
      !make_map(&tv, v, batch_kv, lk, heads, head_dim, kKeys))
    return (int)cudaErrorInvalidValue;
  if (!wide) {
    tq2 = tq, tk2 = tk, tv2 = tv;
  } else if (!make_map(&tq2, q, batch, lq, heads, head_dim, kQ, 16) ||
             !make_map(&tk2, k, batch_kv, lk, heads, head_dim, kKeys, 16) ||
             !make_map(&tv2, v, batch_kv, lk, heads, head_dim, kKeys, 16)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long items = (long long)((lq + kQ - 1) / kQ) * heads * batch;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = items > sms ? sms : (int)items;
  auto kernel = sm90_attention_kernel<4, LSE, NBR>;
  switch ((head_dim + 15) / 16) {
    case 1: kernel = sm90_attention_kernel<1, LSE, NBR>; break;
    case 2: kernel = sm90_attention_kernel<2, LSE, NBR>; break;
    case 3: kernel = sm90_attention_kernel<3, LSE, NBR>; break;
    case 5: kernel = sm90_attention_kernel<5, LSE, NBR>; break;
  }
  const int smem = wide ? smem_bytes<5>() : smem_bytes<4>();
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tq2, tk2, tv2, static_cast<bf16*>(out), lse, batch, lq, lk,
      heads, head_dim, n_cam, n_local, view0, scale * dd::kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Lq, H*d), k/v (B, Lk, H*d), out (B, Lq, H*d): contiguous bf16,
// 16-byte aligned, d % 8 == 0 and d <= 80 (the packed and the split layout
// alike).  One block per SM walks the work items.  Returns a cudaError_t.
extern "C" int dd_sm90_attention_fwd(const void* q, const void* k,
                                     const void* v, void* out, int batch,
                                     int lq, int lk, int heads, int head_dim,
                                     float scale, void* stream) {
  return launch<false, false>(q, k, v, out, nullptr, batch, lq, lk, heads,
                              head_dim, 1, 1, 0, scale, stream);
}

// The same, also writing lse (B*H, Lq) contiguous float32: the training
// forward, whose lse the backward kernels read.
extern "C" int dd_sm90_attention_lse_fwd(const void* q, const void* k,
                                         const void* v, void* out, void* lse,
                                         int batch, int lq, int lk, int heads,
                                         int head_dim, float scale,
                                         void* stream) {
  return launch<true, false>(q, k, v, out, static_cast<float*>(lse), batch,
                             lq, lk, heads, head_dim, 1, 1, 0, scale, stream);
}

// The camera ring, the arguments and checks of dd_packed_attention_nbr_fwd:
// q, out (batch = B * n_local, l, H*d), k, v (B * n_cam, l, H*d); q row
// b n_local + i is global view n = view0 + i of sample b, over that
// sample's K/V views n - 1 and n + 1 (mod n_cam), K/V read in place.
// n_local == n_cam, view0 == 0: every view of each sample (the whole
// ring, one process's call).  Returns a cudaError_t.
extern "C" int dd_sm90_attention_nbr_fwd(const void* q, const void* k,
                                         const void* v, void* out, int batch,
                                         int l, int heads, int head_dim,
                                         int n_cam, int n_local, int view0,
                                         float scale, void* stream) {
  if (n_local < 1 || batch % n_local) return (int)cudaErrorInvalidValue;
  return launch<false, true>(q, k, v, out, nullptr, batch, l, l, heads,
                             head_dim, n_cam, n_local, view0, scale, stream);
}
