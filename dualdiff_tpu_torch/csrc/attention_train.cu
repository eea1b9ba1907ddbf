// Backward attention kernels for Hopper (sm_90a), channel-packed layout.
//
// Since attention_sm90_bwd.cu (TMA, wgmma) took the backward for head dims
// d <= 80 with d % 8 == 0 and 16-byte aligned rows
// (ops.attention.sm90_in_scope), these mma.sync kernels serve it only
// outside that scope (d = 160, d % 8 != 0, unaligned rows) and under
// route="template", the yardstick chip_smoke.py times beside it.
//
// packed_attention_bwd_dq replaces the TPU kernel _bwd_dq_kernel_t and
// packed_attention_bwd_dkv replaces _bwd_dkv_kernel_t
// (dualdiff_tpu/ops/attention.py, both called by _packed_train_t_bwd).  With
// P = exp(s * Q K^T - lse) (lse from packed_attention_lse_fwd) and
// delta = sum_d dO * O per query and head:
//
//   dq = s * sum_k [P * (dO V^T - delta)] K
//   dv = P^T dO,   dk = s * [P * (dO V^T - delta)]^T Q
//
// Layout.  q/do/dq (B, Lq, C), k/v/dk/dv (B, Lk, C), bf16, contiguous, head
// h in columns [h*d, (h+1)*d); lse and delta (B*H, Lq) float32.
//
// What bounds them.  At the flagship training shape (B = 12 stacked attn4
// rows or 6 attn1 rows, Lq = Lk = 1400, C = 320, d = 40) dq does three
// products (6*B*Lq*Lk*C FLOP) and dkv four (8*B*Lq*Lk*C) against a few MB
// of q/k/v/dO/lse/delta: both are compute bound on paper (12 rows: 45 and
// 60 GFLOP, 46 and 61 us at 989 TFLOP/s), and like the forward they also
// take an exponential per score (dkv recomputes P).  Cross-attention
// (Lk = 78 + boxes) is bound by the bytes of q and dO.
//
// Design.  On the TPU a sequential grid axis carried the dq (or dk/dv)
// accumulator in VMEM scratch across K (or Q) blocks of 512.  Blocks here
// run in parallel in no order, so that axis becomes a loop inside the
// block, and each block owns its output rows alone: no atomics, and the
// result is deterministic.
//
// * dq: one block per (row, head, 64-query tile); Q and dO stay in shared
//   memory, lse and delta in registers (rows g and g + 8 of each warp).
//   The block walks K/V in 64-key tiles, double-buffered with cp.async.
//   Per tile a warp computes S = Q K^T and dP = dO V^T (16 x 64 each),
//   P = exp2(S * s * log2e - lse * log2e), dS = P * (dP - delta), and
//   accumulates dQ += dS K in float32; dQ * s is written once.
// * dkv: one block per (row, head, 64-key tile); K and V stay in shared
//   memory, and the block walks Q, dO (double-buffered) and lse, delta in
//   64-query tiles.  A warp owns 16 keys and computes the transposed tiles
//   S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q.
//
// Keys >= Lk and queries >= Lq are masked to P = 0 explicitly (the TPU dkv
// kernel left garbage in padded K rows and sliced it off; these kernels
// never produce such rows).  Products are mma.sync m16n8k16 bf16 -> f32;
// P and dS are rounded to bf16 as MMA operands, as the forward does with P,
// while every accumulator stays float32.  d is zero-padded to a multiple of
// 16 in shared memory only.
//
// Split layout.  flash_attention_bwd_dq replaces _bwd_dq_kernel and
// flash_attention_bwd_dkv replaces _bwd_dkv_kernel (both called by
// _flash_padded_bwd, the VJP of the JAX package's flash_attention).  The
// math is the same (the scale applied after the q.k product, keys >= Lk and
// queries >= Lq contributing nothing), on the same memory: a contiguous
// (B, L, H, D) tensor is the packed (B, L, C).  Their entries take any
// head_dim from 1 to 160: where d % 8 != 0 or a row is not 16-byte aligned
// the VEC = false instances stage with 2-byte loads and store one element
// at a time.  On the SFA+ training path (6 rows, 1400 x 1400, C = 320,
// d = 40) dq is 22.6 GFLOP (23 us at 989 TFLOP/s) and dk/dv 30.1 GFLOP
// (30 us) against 27 and 33 MB (8 and 10 us at 3.35 TB/s): compute-bound,
// like the packed instances.
// Simple first: no wgmma, TMA or warp specialisation yet.

#include "mma_tile.cuh"

namespace {

using namespace dd;

// VEC: 16-byte staging and 4-byte stores (d % 8 == 0, aligned rows); else
// element by element, for any head_dim (the split-layout entries).
template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int lq, int lk, int ld, int d, float scale,
                  float scale_log2) {
  constexpr int S = DP + 8;
  constexpr int KT = DP / 16;
  constexpr int NT = DP / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);  // kBlockQ x S
  bf16* sdo = sq + kBlockQ * S;              // kBlockQ x S
  bf16* sk = sdo + kBlockQ * S;              // 2 stages x kBlockK x S
  bf16* sv = sk + 2 * kBlockK * S;           // 2 stages x kBlockK x S

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * kBlockQ;
  const int row = blockIdx.z;
  const size_t head_off = (size_t)blockIdx.y * d;
  const bf16* kg = k + (size_t)row * lk * ld + head_off;
  const bf16* vg = v + (size_t)row * lk * ld + head_off;

  zero_pad_columns<DP>(sq, 6, d);
  stage_tile<S, DP, VEC>(sq, q + (size_t)row * lq * ld + head_off, q0, lq,
                         ld, d);
  stage_tile<S, DP, VEC>(sdo, dout + (size_t)row * lq * ld + head_off, q0,
                         lq, ld, d);
  stage_tile<S, DP, VEC>(sk, kg, 0, lk, ld, d);
  stage_tile<S, DP, VEC>(sv, vg, 0, lk, ld, d);
  cp_async_commit();

  const int g = lane >> 2;
  const int tq = lane & 3;
  const int r0 = q0 + warp * 16 + g;
  const float* lrow = lse + ((size_t)row * gridDim.y + blockIdx.y) * lq;
  const float* drow = delta + ((size_t)row * gridDim.y + blockIdx.y) * lq;
  float lse2[2], dlt[2];  // padded query rows: 0 (their dO is zero)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    lse2[r] = qi < lq ? lrow[qi] * kLog2e : 0.f;
    dlt[r] = qi < lq ? drow[qi] : 0.f;
  }

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  const int n_tiles = (lk + kBlockK - 1) / kBlockK;
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      stage_tile<S, DP, VEC>(sk + (st ^ 1) * kBlockK * S, kg,
                             (t + 1) * kBlockK, lk, ld, d);
      stage_tile<S, DP, VEC>(sv + (st ^ 1) * kBlockK * S, vg,
                             (t + 1) * kBlockK, lk, ld, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tk = sk + st * kBlockK * S;
    const bf16* tv = sv + st * kBlockK * S;

    // S = Q K^T and dP = dO V^T: 16 queries x 64 keys per warp
    float s[kBlockK / 8][4], dp[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t qa[4], da[4];
      load_a<S>(qa, sq, warp, kt, lane);
      load_a<S>(da, sdo, warp, kt, lane);
#pragma unroll
      for (int j2 = 0; j2 < kBlockK / 16; ++j2) {
        uint32_t b[4];
        load_b_rows<S>(b, tk, j2, kt, lane);
        mma16816(s[2 * j2], qa, b[0], b[1]);
        mma16816(s[2 * j2 + 1], qa, b[2], b[3]);
        load_b_rows<S>(b, tv, j2, kt, lane);
        mma16816(dp[2 * j2], da, b[0], b[1]);
        mma16816(dp[2 * j2 + 1], da, b[2], b[3]);
      }
    }

    // dS = P * (dP - delta), keys >= lk masked to P = 0
    const int key0 = t * kBlockK + 2 * tq;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = key0 + j * 8 + (e & 1) < lk
                            ? exp2f(s[j][e] * scale_log2 - lse2[e >> 1])
                            : 0.f;
        s[j][e] = p * (dp[j][e] - dlt[e >> 1]);
      }

    // dQ += dS (bf16) . K
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s, kk);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t b[4];
        load_b_cols<S>(b, tk, kk, n2, lane);
        mma16816(acc[2 * n2], a, b[0], b[1]);
        mma16816(acc[2 * n2 + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // the next prefetch overwrites this stage
  }

  store_rows<NT, VEC>(dq + (size_t)row * lq * ld + head_off, acc, scale, r0,
                      lq, ld, d, tq);
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads)
    bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int lq, int lk, int ld, int d,
                   float scale, float scale_log2) {
  constexpr int S = DP + 8;
  constexpr int KT = DP / 16;
  constexpr int NT = DP / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);  // kBlockK x S
  bf16* sv = sk + kBlockK * S;               // kBlockK x S
  bf16* sq = sv + kBlockK * S;               // 2 stages x kBlockQ x S
  bf16* sdo = sq + 2 * kBlockQ * S;          // 2 stages x kBlockQ x S
  float* slse = reinterpret_cast<float*>(sdo + 2 * kBlockQ * S);  // kBlockQ
  float* sdelta = slse + kBlockQ;                                 // kBlockQ

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k0 = blockIdx.x * kBlockK;
  const int row = blockIdx.z;
  const size_t head_off = (size_t)blockIdx.y * d;
  const bf16* qg = q + (size_t)row * lq * ld + head_off;
  const bf16* dog = dout + (size_t)row * lq * ld + head_off;
  const float* lrow = lse + ((size_t)row * gridDim.y + blockIdx.y) * lq;
  const float* drow = delta + ((size_t)row * gridDim.y + blockIdx.y) * lq;

  zero_pad_columns<DP>(sk, 6, d);
  stage_tile<S, DP, VEC>(sk, k + (size_t)row * lk * ld + head_off, k0, lk,
                         ld, d);
  stage_tile<S, DP, VEC>(sv, v + (size_t)row * lk * ld + head_off, k0, lk,
                         ld, d);
  stage_tile<S, DP, VEC>(sq, qg, 0, lq, ld, d);
  stage_tile<S, DP, VEC>(sdo, dog, 0, lq, ld, d);
  cp_async_commit();

  const int g = lane >> 2;
  const int tq = lane & 3;
  const int r0 = k0 + warp * 16 + g;  // this thread's key rows r0, r0 + 8
  const bool key_ok[2] = {r0 < lk, r0 + 8 < lk};

  float acc_k[NT][4], acc_v[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  const int n_tiles = (lq + kBlockQ - 1) / kBlockQ;
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    // this tile's lse (log2 domain) and delta; the previous tile's readers
    // are past the trailing __syncthreads of the last iteration
    if (tid < kBlockQ) {
      const int qi = t * kBlockQ + tid;
      slse[tid] = qi < lq ? lrow[qi] * kLog2e : 0.f;
    } else {
      const int qi = t * kBlockQ + tid - kBlockQ;
      sdelta[tid - kBlockQ] = qi < lq ? drow[qi] : 0.f;
    }
    if (t + 1 < n_tiles) {
      stage_tile<S, DP, VEC>(sq + (st ^ 1) * kBlockQ * S, qg,
                             (t + 1) * kBlockQ, lq, ld, d);
      stage_tile<S, DP, VEC>(sdo + (st ^ 1) * kBlockQ * S, dog,
                             (t + 1) * kBlockQ, lq, ld, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tqs = sq + st * kBlockQ * S;
    const bf16* tdo = sdo + st * kBlockQ * S;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 queries per warp
    float s[kBlockQ / 8][4], dp[kBlockQ / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t ka[4], va[4];
      load_a<S>(ka, sk, warp, kt, lane);
      load_a<S>(va, sv, warp, kt, lane);
#pragma unroll
      for (int j2 = 0; j2 < kBlockQ / 16; ++j2) {
        uint32_t b[4];
        load_b_rows<S>(b, tqs, j2, kt, lane);
        mma16816(s[2 * j2], ka, b[0], b[1]);
        mma16816(s[2 * j2 + 1], ka, b[2], b[3]);
        load_b_rows<S>(b, tdo, j2, kt, lane);
        mma16816(dp[2 * j2], va, b[0], b[1]);
        mma16816(dp[2 * j2 + 1], va, b[2], b[3]);
      }
    }

    // P^T and dS^T = P^T * (dP^T - delta); queries >= lq and keys >= lk
    // masked to P = 0
    const int qbase = t * kBlockQ;
#pragma unroll
    for (int j = 0; j < kBlockQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + 2 * tq + (e & 1);
        const float p = (qbase + qc < lq && key_ok[e >> 1])
                            ? exp2f(s[j][e] * scale_log2 - slse[qc])
                            : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - sdelta[qc]);
      }

    // dV += P^T (bf16) . dO and dK += dS^T (bf16) . Q
#pragma unroll
    for (int kk = 0; kk < kBlockQ / 16; ++kk) {
      uint32_t ap[4], ads[4];
      acc_to_a(ap, s, kk);
      acc_to_a(ads, dp, kk);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t b[4];
        load_b_cols<S>(b, tdo, kk, n2, lane);
        mma16816(acc_v[2 * n2], ap, b[0], b[1]);
        mma16816(acc_v[2 * n2 + 1], ap, b[2], b[3]);
        load_b_cols<S>(b, tqs, kk, n2, lane);
        mma16816(acc_k[2 * n2], ads, b[0], b[1]);
        mma16816(acc_k[2 * n2 + 1], ads, b[2], b[3]);
      }
    }
    __syncthreads();  // the next prefetch overwrites this stage
  }

  const size_t out_off = (size_t)row * lk * ld + head_off;
  store_rows<NT, VEC>(dk + out_off, acc_k, scale, r0, lk, ld, d, tq);
  store_rows<NT, VEC>(dv + out_off, acc_v, 1.f, r0, lk, ld, d, tq);
}

template <int DP, bool VEC>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int batch, int lq, int lk, int heads, int d,
                      float scale, cudaStream_t stream) {
  const size_t smem = (size_t)6 * kTile * (DP + 8) * sizeof(bf16);
  auto kernel = bwd_dq_kernel<DP, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((lq + kBlockQ - 1) / kBlockQ, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), lq, lk, heads * d, d, scale, scale * kLog2e);
  return cudaGetLastError();
}

template <int DP, bool VEC>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int batch, int lq, int lk,
                       int heads, int d, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)6 * kTile * (DP + 8) * sizeof(bf16) +
                      (size_t)2 * kBlockQ * sizeof(float);
  auto kernel = bwd_dkv_kernel<DP, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((lk + kBlockK - 1) / kBlockK, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), lq, lk, heads * d, d,
      scale, scale * kLog2e);
  return cudaGetLastError();
}

template <bool VEC>
int dispatch_dq(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dq, int batch, int lq, int lk, int heads, int d,
                float scale, void* stream) {
  if (d <= 0 || (VEC && d % 8) || d > 160) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define DD_CALL(P)                                                          \
  (int)launch_dq<P, VEC>(q, k, v, dout, l, dl, dq, batch, lq, lk, heads, d, \
                         scale, s)
  DD_DISPATCH_DP(d, DD_CALL)
#undef DD_CALL
  return (int)cudaErrorInvalidValue;
}

template <bool VEC>
int dispatch_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int batch, int lq, int lk, int heads,
                 int d, float scale, void* stream) {
  if (d <= 0 || (VEC && d % 8) || d > 160) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define DD_CALL(P)                                                         \
  (int)launch_dkv<P, VEC>(q, k, v, dout, l, dl, dk, dv, batch, lq, lk,     \
                          heads, d, scale, s)
  DD_DISPATCH_DP(d, DD_CALL)
#undef DD_CALL
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int dd_packed_attention_bwd_dq(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          void* dq, int batch, int lq, int lk,
                                          int heads, int head_dim, float scale,
                                          void* stream) {
  return dispatch_dq<true>(q, k, v, dout, lse, delta, dq, batch, lq, lk,
                           heads, head_dim, scale, stream);
}

extern "C" int dd_packed_attention_bwd_dkv(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse, const void* delta,
                                           void* dk, void* dv, int batch,
                                           int lq, int lk, int heads,
                                           int head_dim, float scale,
                                           void* stream) {
  return dispatch_dkv<true>(q, k, v, dout, lse, delta, dk, dv, batch, lq, lk,
                            heads, head_dim, scale, stream);
}

// Split layout (B, L, H, D): any head_dim from 1 to 160; 16-byte staging
// where d % 8 == 0 and every row is aligned, element loads otherwise.
extern "C" int dd_flash_attention_bwd_dq(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dq, int batch, int lq, int lk,
                                         int heads, int head_dim, float scale,
                                         void* stream) {
  if (dd::vec_ok(head_dim, q, k, v, dout, dq))
    return dispatch_dq<true>(q, k, v, dout, lse, delta, dq, batch, lq, lk,
                             heads, head_dim, scale, stream);
  return dispatch_dq<false>(q, k, v, dout, lse, delta, dq, batch, lq, lk,
                            heads, head_dim, scale, stream);
}

extern "C" int dd_flash_attention_bwd_dkv(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          void* dk, void* dv, int batch,
                                          int lq, int lk, int heads,
                                          int head_dim, float scale,
                                          void* stream) {
  if (dd::vec_ok(head_dim, q, k, v, dout, dk, dv))
    return dispatch_dkv<true>(q, k, v, dout, lse, delta, dk, dv, batch, lq,
                              lk, heads, head_dim, scale, stream);
  return dispatch_dkv<false>(q, k, v, dout, lse, delta, dk, dv, batch, lq,
                             lk, heads, head_dim, scale, stream);
}
