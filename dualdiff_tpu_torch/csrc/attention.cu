// Forward attention kernels for Hopper (sm_90a), channel-packed layout.
//
// Since attention_sm90.cu (TMA, wgmma) took every forward, the camera ring
// included, for head dims d <= 80 with d % 8 == 0 and 16-byte aligned rows
// (ops.attention.sm90_in_scope), these mma.sync kernels serve them only
// outside that scope (d = 160, d % 8 != 0, unaligned rows) and under
// route="template", the yardstick chip_smoke.py times beside it.
//
// packed_attention_fwd replaces the TPU kernel _fwd_kernel_t
// (dualdiff_tpu/ops/attention.py, body _attn_body_t, called by
// _packed_infer).  packed_attention_nbr_fwd replaces _fwd_kernel_t_nbr
// (same file, called by _flash_packed_nbr).  packed_attention_lse_fwd
// replaces _fwd_kernel_t_lse (called by _packed_train_t_fwd): the same
// forward, also writing lse = m + log(l) per (row, head, query) in float32
// for the backward kernels (attention_train.cu).  packed_attention_capped_fwd
// replaces _fwd_kernel_t_capped (called by _packed_infer_capped for shapes
// whose padded score tile is over the TPU's VMEM cap, such as the video
// ST-Attn 1400 queries x 2800 keys); see "Long K" below.
// packed_attention_capped_lse_fwd replaces _fwd_kernel_t_capped_lse (called
// by _packed_train_t_fwd over the same cap): the long-K forward with the
// lse epilogue, for ST-Attn under grad; see "Long K under grad" below.
//
// Layout.  q (B, Lq, C), k/v (B, Lk, C), out (B, Lq, C), bf16, contiguous,
// head h in columns [h*d, (h+1)*d); lse (B*H, Lq) float32.  The TPU kernels
// took a transposed (B, C, L) layout so that heads became sublane blocks; on
// this card a head is d contiguous bf16 values of a row (80 bytes at d = 40),
// read with 16-byte cp.async, so no relayout is needed.
//
// What bounds it.  Self-attention at the flagship shape (B = 24, Lq = Lk =
// 1400, C = 320) is 4*B*Lq*Lk*C = 60.2 GFLOP, 61 us at the H100's 989
// TFLOP/s bf16 peak, against 86 MB of q/k/v/o (26 us at 3.35 TB/s): compute.
// With d = 40 the softmax is heavy beside the products: 376 M exponentials
// per call, about 96 us at the SFU's 16 per clock per SM, so this shape is
// bound by exponentials before tensor cores.  Cross-attention (Lk = 158) is
// memory-bound (about 14 us); the ring kernel does the self-attention work
// twice (120 GFLOP, about 122 us).  The lse output adds 4 bytes per query
// and head, under 1% of the bytes.
//
// Design.  The TPU kernel kept the whole (Lk, Lq) score tile of a head in
// VMEM (capped at 2 * 1024^2 scores).  A block here owns 64 queries of one
// head of one batch row (4 warps x 16 rows) and walks K/V in 64-key tiles
// staged in shared memory by cp.async, two stages deep, with an online
// softmax in float32 (scores scaled in float32, exp2 with log2(e) folded
// into the scale).  No score ever goes to device memory and no score tile
// bounds the length.  Both products are mma.sync m16n8k16 bf16 -> f32 with
// operands fed by ldmatrix (V through ldmatrix.trans); P is rounded to bf16
// for the second product, the accumulators stay f32.  d is zero-padded to a
// multiple of 16 (the MMA depth) inside shared memory only.  Keys >= Lk are
// masked to -inf: exact, unlike the TPU inference kernel, which subtracts
// n_pad * exp(-m) from the denominator and cancels catastrophically when
// every real logit of a row is far below zero.  The ring kernel runs the
// same K/V loop over view n-1 and then view n+1, each with its own softmax;
// the first normalized result waits in shared memory (float32) and the two
// are summed in float32 and written once.
//
// Long K.  The TPU needed a second kernel (K/V blocked on the grid, m, l and
// acc carried in VMEM scratch) only because a whole-sequence score tile did
// not fit in VMEM.  The kernel above already walks K/V in tiles with an
// online softmax, so the capped entry is an instance of it, with the warps
// per block as its one parameter of its own.  At the ST-Attn shape (B = 96,
// Lq = 1400, Lk = 2800, C = 320) a call is 4*B*Lq*Lk*C = 481.7 GFLOP, 0.487
// ms at 989 TFLOP/s, against 0.52 GB of q/k/v/o (0.15 ms at 3.35 TB/s):
// compute-bound, and 3.0 G exponentials.  Every query block reads all of its
// head's K/V tiles, so 8 warps (128 queries per block) halve the K/V traffic
// through L2 and shared memory against 4 warps (64 queries).
//
// Long K under grad.  The training forward over the cap is the same
// long-K instance with the lse epilogue of packed_attention_lse_fwd.  Its
// lse feeds the backward kernels of attention_train.cu, which already walk
// the other axis in tiles at any length.  At the video training shape (B =
// 12: one 2-frame clip x 6 views, Lq = 1400, Lk = 2800, C = 320) a call is
// 60.2 GFLOP, 61 us at 989 TFLOP/s, against 65 MB of q/k/v/o/lse (19 us at
// 3.35 TB/s): compute-bound like the inference instance, 376 M
// exponentials.  The TPU kernel masked keys >= Lk to -inf too, so its lse is
// the same exact function.
//
// Split layout.  flash_attention_fwd replaces _fwd_kernel_nolse and
// flash_attention_lse_fwd replaces _fwd_kernel (called by _fwd_core for
// _flash_padded, the JAX package's flash_attention): the split-layout
// (B*H, L, D) online-softmax forward with the kv_len mask and optional lse.
// Its caller here is multi_head_attention with both lengths >= 1024, the
// SFA+ stage-2 self-attention of the 28x50 = 1400-token condition map
// (generation: B = 24 rows, C = 320, 8 heads, d = 40, 60.2 GFLOP, 61 us at
// 989 TFLOP/s against 86 MB, 26 us: compute-bound, and 376 M
// exponentials; training: 6 rows, a quarter of that).  A contiguous
// (B, L, H, D) tensor is the packed (B, L, C) memory, so both entries are
// this kernel on the same layout; what they add is the contract: any
// head_dim from 1 to 160.  Where d % 8 != 0, or a row does not start
// 16-byte aligned, rows cannot be staged with 16-byte cp.async: the VEC =
// false instances stage them with 2-byte loads and write the output one
// element at a time, still padding d to the MMA depth in shared memory
// only.  The TPU's sequence padding to its blocks is not carried over:
// keys >= Lk are masked exactly, as above.
// Simple first: no wgmma, TMA or warp specialisation yet.

#include "mma_tile.cuh"

namespace {

using namespace dd;

// DP: head_dim padded to a multiple of 16.  NBR: camera-ring variant: q
// row r is global view view0 + r % n_local of sample r / n_local, over that
// sample's K/V rows (n_cam views a sample) of views -1 and +1 mod n_cam.
// LSE: also write lse (B*H, Lq) float32 (not with NBR).  WARPS: warps per
// block, a multiple of 4; the block owns 16 * WARPS queries.  VEC: stage
// and store with 16- and 4-byte accesses (d % 8 == 0, aligned rows); else
// element by element, for any head_dim.
template <int DP, bool NBR, bool LSE, int WARPS, bool VEC>
__global__ void __launch_bounds__(32 * WARPS)
    attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int lq, int lk, int ld, int d,
                     int n_cam, int n_local, int view0, float scale_log2) {
  constexpr int S = DP + 8;   // shared row stride: ldmatrix conflict-free
  constexpr int KT = DP / 16;  // MMA depth steps of q.k
  constexpr int NT = DP / 8;   // 8-column tiles of the output
  constexpr int THREADS = 32 * WARPS;
  constexpr int BQ = 16 * WARPS;  // queries per block
  static_assert(!(NBR && LSE), "the ring kernel writes no lse");
  static_assert(WARPS % 4 == 0, "the q tile is whole 64-row tiles");

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);  // BQ x S
  bf16* sk = sq + BQ * S;                    // 2 stages x kBlockK x S
  bf16* sv = sk + 2 * kBlockK * S;           // 2 stages x kBlockK x S
  float* stash = reinterpret_cast<float*>(sv + 2 * kBlockK * S);  // NBR

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int row = blockIdx.z;
  const size_t head_off = (size_t)blockIdx.y * d;

  // q tile + 2 K and 2 V stages
  zero_pad_columns<DP, THREADS>(sq, BQ / kTile + 4, d);
#pragma unroll
  for (int i = 0; i < BQ / kTile; ++i)
    stage_tile<S, DP, VEC, THREADS>(sq + i * kTile * S,
                                    q + (size_t)row * lq * ld + head_off,
                                    q0 + i * kTile, lq, ld, d);

  uint32_t qf[KT][4];
  float acc[NT][4];
  float m[2], l[2];
  const int n_tiles = (lk + kBlockK - 1) / kBlockK;
  const int g = lane >> 2;  // accumulator row (and row + 8)
  const int tq = lane & 3;  // accumulator column pair

#pragma unroll 1
  for (int pass = 0; pass < (NBR ? 2 : 1); ++pass) {
    int kv_row = row;
    if (NBR) {
      const int b = row / n_local, n = view0 + row - b * n_local;
      kv_row = b * n_cam + (pass == 0 ? (n + n_cam - 1) % n_cam
                                      : (n + 1) % n_cam);
    }
    const bf16* kg = k + (size_t)kv_row * lk * ld + head_off;
    const bf16* vg = v + (size_t)kv_row * lk * ld + head_off;

#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;

    stage_tile<S, DP, VEC, THREADS>(sk, kg, 0, lk, ld, d);
    stage_tile<S, DP, VEC, THREADS>(sv, vg, 0, lk, ld, d);
    cp_async_commit();  // (pass 0: this group also holds the q tile)

#pragma unroll 1
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t & 1;
      if (t + 1 < n_tiles) {
        stage_tile<S, DP, VEC, THREADS>(sk + (st ^ 1) * kBlockK * S, kg,
                                        (t + 1) * kBlockK, lk, ld, d);
        stage_tile<S, DP, VEC, THREADS>(sv + (st ^ 1) * kBlockK * S, vg,
                                        (t + 1) * kBlockK, lk, ld, d);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      if (pass == 0 && t == 0) {
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) load_a<S>(qf[kt], sq, warp, kt, lane);
      }

      const bf16* tk = sk + st * kBlockK * S;
      const bf16* tv = sv + st * kBlockK * S;

      // scores: 16 rows x 64 keys per warp
      float s[kBlockK / 8][4];
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
        for (int j2 = 0; j2 < kBlockK / 16; ++j2) {
          uint32_t b[4];
          load_b_rows<S>(b, tk, j2, kt, lane);
          mma16816(s[2 * j2], qf[kt], b[0], b[1]);
          mma16816(s[2 * j2 + 1], qf[kt], b[2], b[3]);
        }
      }

      // online softmax, rows g and g + 8 of the warp's tile
      float mx[2] = {-INFINITY, -INFINITY};
      const int key0 = t * kBlockK + 2 * tq;
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (key0 + j * 8 + (e & 1) >= lk) x = -INFINITY;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);  // finite: key 0 is real
        const float alpha = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha;
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          acc[i][2 * r] *= alpha;
          acc[i][2 * r + 1] *= alpha;
        }
      }
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[j][e] - m[e >> 1]);
          s[j][e] = p;
          l[e >> 1] += p;
        }

      // acc += P (bf16) . V
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        uint32_t a[4];
        acc_to_a(a, s, kk);
#pragma unroll
        for (int n2 = 0; n2 < NT / 2; ++n2) {
          uint32_t b[4];
          load_b_cols<S>(b, tv, kk, n2, lane);
          mma16816(acc[2 * n2], a, b[0], b[1]);
          mma16816(acc[2 * n2 + 1], a, b[2], b[3]);
        }
      }
      __syncthreads();  // the next prefetch overwrites this stage
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / l[r];
    }
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float o = acc[i][e] * inv[e >> 1];
        if (NBR) {
          float* slot = stash + (i * 4 + e) * THREADS + tid;
          if (pass == 0)
            *slot = o;
          else
            o += *slot;
        }
        acc[i][e] = o;
      }
  }

  // write rows g and g + 8 of this warp's tile, real columns only
  const int r0 = q0 + warp * 16 + g;
  store_rows<NT, VEC>(out + (size_t)row * lq * ld + head_off, acc, 1.f, r0,
                      lq, ld, d, tq);
  if (LSE && tq == 0) {
    // natural-log lse of the scaled logits: m is in the log2 domain
    float* lg = lse + ((size_t)row * gridDim.y + blockIdx.y) * lq;
    if (r0 < lq) lg[r0] = m[0] * kLn2 + logf(l[0]);
    if (r0 + 8 < lq) lg[r0 + 8] = m[1] * kLn2 + logf(l[1]);
  }
}

template <int DP, bool NBR, bool LSE, int WARPS, bool VEC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int batch, int lq, int lk, int heads, int d,
                   int n_cam, int n_local, int view0, float scale,
                   cudaStream_t stream) {
  constexpr int BQ = 16 * WARPS;
  constexpr int THREADS = 32 * WARPS;
  const size_t smem = (size_t)(BQ + 4 * kBlockK) * (DP + 8) * sizeof(bf16) +
                      (NBR ? (size_t)THREADS * (DP / 2) * sizeof(float) : 0);
  auto kernel = attention_kernel<DP, NBR, LSE, WARPS, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((lq + BQ - 1) / BQ, heads, batch);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, lq, lk,
      heads * d, d, n_cam, n_local, view0, scale * kLog2e);
  return cudaGetLastError();
}

template <bool NBR, bool LSE, int WARPS = kWarps, bool VEC = true>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int batch, int lq, int lk, int heads, int d,
             int n_cam, int n_local, int view0, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || (VEC && d % 8) || d > 160) return (int)cudaErrorInvalidValue;
#define DD_CALL(P)                                                         \
  (int)launch<P, NBR, LSE, WARPS, VEC>(q, k, v, out, lse, batch, lq, lk, \
                                       heads, d, n_cam, n_local, view0,  \
                                       scale, s)
  DD_DISPATCH_DP(d, DD_CALL)
#undef DD_CALL
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int dd_packed_attention_fwd(const void* q, const void* k,
                                       const void* v, void* out, int batch,
                                       int lq, int lk, int heads, int head_dim,
                                       float scale, void* stream) {
  return dispatch<false, false>(q, k, v, out, nullptr, batch, lq, lk, heads,
                                head_dim, 1, 1, 0, scale, stream);
}

// The camera ring: q, out (batch = B * n_local, l, H*d), k, v (B * n_cam,
// l, H*d); q row b n_local + i is global view n = view0 + i of sample b,
// over that sample's K/V views n - 1 and n + 1 (mod n_cam).  n_local ==
// n_cam, view0 == 0: the whole ring.
extern "C" int dd_packed_attention_nbr_fwd(const void* q, const void* k,
                                           const void* v, void* out,
                                           int batch, int l, int heads,
                                           int head_dim, int n_cam,
                                           int n_local, int view0,
                                           float scale, void* stream) {
  if (n_local < 1 || n_local > n_cam || batch % n_local || view0 < 0 ||
      view0 + n_local > n_cam)
    return (int)cudaErrorInvalidValue;
  return dispatch<true, false>(q, k, v, out, nullptr, batch, l, l, heads,
                               head_dim, n_cam, n_local, view0, scale,
                               stream);
}

extern "C" int dd_packed_attention_lse_fwd(const void* q, const void* k,
                                           const void* v, void* out,
                                           void* lse, int batch, int lq,
                                           int lk, int heads, int head_dim,
                                           float scale, void* stream) {
  return dispatch<false, true>(q, k, v, out, static_cast<float*>(lse), batch,
                               lq, lk, heads, head_dim, 1, 1, 0, scale, stream);
}

// warps: 4 (64 queries per block) or 8 (128 queries per block, half the
// K/V traffic per query).
extern "C" int dd_packed_attention_capped_fwd(const void* q, const void* k,
                                              const void* v, void* out,
                                              int batch, int lq, int lk,
                                              int heads, int head_dim,
                                              int warps, float scale,
                                              void* stream) {
  if (warps == 8)
    return dispatch<false, false, 8>(q, k, v, out, nullptr, batch, lq, lk,
                                     heads, head_dim, 1, 1, 0, scale, stream);
  if (warps == 4)
    return dispatch<false, false, 4>(q, k, v, out, nullptr, batch, lq, lk,
                                     heads, head_dim, 1, 1, 0, scale, stream);
  return (int)cudaErrorInvalidValue;
}

// the long-K forward of capped_fwd with the lse epilogue; warps as there
extern "C" int dd_packed_attention_capped_lse_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int batch, int lq, int lk, int heads, int head_dim, int warps,
    float scale, void* stream) {
  float* l = static_cast<float*>(lse);
  if (warps == 8)
    return dispatch<false, true, 8>(q, k, v, out, l, batch, lq, lk, heads,
                                    head_dim, 1, 1, 0, scale, stream);
  if (warps == 4)
    return dispatch<false, true, 4>(q, k, v, out, l, batch, lq, lk, heads,
                                    head_dim, 1, 1, 0, scale, stream);
  return (int)cudaErrorInvalidValue;
}

// Split layout (B, L, H, D), the JAX package's flash_attention: any
// head_dim from 1 to 160; 16-byte staging where d % 8 == 0 and the rows are
// aligned, element loads otherwise.
extern "C" int dd_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int lq, int lk, int heads, int head_dim,
                                      float scale, void* stream) {
  if (dd::vec_ok(head_dim, q, k, v, out))
    return dispatch<false, false>(q, k, v, out, nullptr, batch, lq, lk,
                                  heads, head_dim, 1, 1, 0, scale, stream);
  return dispatch<false, false, dd::kWarps, false>(
      q, k, v, out, nullptr, batch, lq, lk, heads, head_dim, 1, 1, 0, scale,
      stream);
}

// flash_attention_fwd with the lse epilogue
extern "C" int dd_flash_attention_lse_fwd(const void* q, const void* k,
                                          const void* v, void* out, void* lse,
                                          int batch, int lq, int lk,
                                          int heads, int head_dim,
                                          float scale, void* stream) {
  float* l = static_cast<float*>(lse);
  if (dd::vec_ok(head_dim, q, k, v, out))
    return dispatch<false, true>(q, k, v, out, l, batch, lq, lk, heads,
                                 head_dim, 1, 1, 0, scale, stream);
  return dispatch<false, true, dd::kWarps, false>(
      q, k, v, out, l, batch, lq, lk, heads, head_dim, 1, 1, 0, scale, stream);
}
