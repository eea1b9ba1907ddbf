// Inference attention kernels for Hopper (sm_90a), channel-packed layout.
//
// packed_attention_fwd replaces the TPU kernel _fwd_kernel_t
// (dualdiff_tpu/ops/attention.py, body _attn_body_t, called by
// _packed_infer).  packed_attention_nbr_fwd replaces _fwd_kernel_t_nbr
// (same file, called by _flash_packed_nbr).
//
// Layout.  q (B, Lq, C), k/v (B, Lk, C), out (B, Lq, C), bf16, contiguous,
// head h in columns [h*d, (h+1)*d).  The TPU kernels took a transposed
// (B, C, L) layout so that heads became sublane blocks; on this card a head
// is d contiguous bf16 values of a row (80 bytes at d = 40), read with
// 16-byte cp.async, so no relayout is needed.
//
// What bounds it.  Self-attention at the flagship shape (B = 24, Lq = Lk =
// 1400, C = 320) is 4*B*Lq*Lk*C = 60.2 GFLOP, 61 us at the H100's 989
// TFLOP/s bf16 peak, against 86 MB of q/k/v/o (26 us at 3.35 TB/s): compute.
// With d = 40 the softmax is heavy beside the products: 376 M exponentials
// per call, about 96 us at the SFU's 16 per clock per SM, so this shape is
// bound by exponentials before tensor cores.  Cross-attention (Lk = 158) is
// memory-bound (about 14 us); the ring kernel does the self-attention work
// twice (120 GFLOP, about 122 us).
//
// Design.  The TPU kernel kept the whole (Lk, Lq) score tile of a head in
// VMEM.  A block here owns 64 queries of one head of one batch row (4 warps
// x 16 rows) and walks K/V in 64-key tiles staged in shared memory by
// cp.async, two stages deep, with an online softmax in float32 (scores
// scaled in float32, exp2 with log2(e) folded into the scale).  No score
// ever goes to device memory.  Both products are mma.sync m16n8k16 bf16 ->
// f32 with operands fed by ldmatrix (V through ldmatrix.trans); P is rounded
// to bf16 for the second product, the accumulators stay f32.  d is
// zero-padded to a multiple of 16 (the MMA depth) inside shared memory only.
// Keys >= Lk are masked to -inf: exact, unlike the TPU kernel, which
// subtracts n_pad * exp(-m) from the denominator and cancels
// catastrophically when every real logit of a row is far below zero.
// The ring kernel runs the same K/V loop over view n-1 and then view n+1,
// each with its own softmax; the first normalized result waits in shared
// memory (float32) and the two are summed in float32 and written once.
// Simple first: no wgmma, TMA or warp specialisation yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;  // one 16-row MMA tile per warp
constexpr int kBlockK = 64;
constexpr float kLog2e = 1.4426950408889634f;

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
// a shared tile of row stride S; rows >= nrows are zero-filled.
template <int S>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* g, int row0,
                                          int nrows, int ld, int chunks) {
  for (int c = threadIdx.x; c < kBlockK * chunks; c += kThreads) {
    int r = c / chunks;
    int ch = c - r * chunks;
    int row = row0 + r;
    bool valid = row < nrows;
    const bf16* src = g + (size_t)(valid ? row : 0) * ld + ch * 8;
    cp_async16(tile + r * S + ch * 8, src, valid);
  }
}

// DP: head_dim padded to a multiple of 16.  NBR: camera-ring variant.
template <int DP, bool NBR>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     int lq, int lk, int ld, int d, int n_cam,
                     float scale_log2) {
  constexpr int S = DP + 8;   // shared row stride: ldmatrix conflict-free
  constexpr int KT = DP / 16;  // MMA depth steps of q.k
  constexpr int NT = DP / 8;   // 8-column tiles of the output
  static_assert(kBlockQ == kBlockK, "one tile loader serves q and k/v");

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);  // kBlockQ x S
  bf16* sk = sq + kBlockQ * S;               // 2 stages x kBlockK x S
  bf16* sv = sk + 2 * kBlockK * S;           // 2 stages x kBlockK x S
  float* stash = reinterpret_cast<float*>(sv + 2 * kBlockK * S);  // NBR

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * kBlockQ;
  const int row = blockIdx.z;
  const size_t head_off = (size_t)blockIdx.y * d;
  const int chunks = d / 8;

  // columns [d, DP) of every tile stay zero; cp.async never writes them
  if (d < DP) {
    const int pad = DP - d;
    for (int i = tid; i < (kBlockQ + 4 * kBlockK) * pad; i += kThreads)
      sq[(i / pad) * S + d + i % pad] = __float2bfloat16(0.f);
  }

  load_tile<S>(sq, q + (size_t)row * lq * ld + head_off, q0, lq, ld, chunks);

  uint32_t qf[KT][4];
  float acc[NT][4];
  const int n_tiles = (lk + kBlockK - 1) / kBlockK;
  const int g = lane >> 2;  // accumulator row (and row + 8)
  const int tq = lane & 3;  // accumulator column pair

#pragma unroll 1
  for (int pass = 0; pass < (NBR ? 2 : 1); ++pass) {
    int kv_row = row;
    if (NBR) {
      const int b = row / n_cam, n = row - b * n_cam;
      kv_row = b * n_cam + (pass == 0 ? (n + n_cam - 1) % n_cam
                                      : (n + 1) % n_cam);
    }
    const bf16* kg = k + (size_t)kv_row * lk * ld + head_off;
    const bf16* vg = v + (size_t)kv_row * lk * ld + head_off;

#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};

    load_tile<S>(sk, kg, 0, lk, ld, chunks);
    load_tile<S>(sv, vg, 0, lk, ld, chunks);
    cp_async_commit();  // (pass 0: this group also holds the q tile)

#pragma unroll 1
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t & 1;
      if (t + 1 < n_tiles) {
        load_tile<S>(sk + (st ^ 1) * kBlockK * S, kg, (t + 1) * kBlockK, lk,
                     ld, chunks);
        load_tile<S>(sv + (st ^ 1) * kBlockK * S, vg, (t + 1) * kBlockK, lk,
                     ld, chunks);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      if (pass == 0 && t == 0) {
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
          ldmatrix_x4(qf[kt], sq + (warp * 16 + (lane & 15)) * S + kt * 16 +
                                  (lane >> 4) * 8);
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
          ldmatrix_x4(b, tk + (j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * S +
                             kt * 16 + ((lane >> 3) & 1) * 8);
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
        const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int n2 = 0; n2 < NT / 2; ++n2) {
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, tv + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * S +
                     n2 * 16 + ((lane >> 4) << 3));
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
          float* slot = stash + (i * 4 + e) * kThreads + tid;
          if (pass == 0)
            *slot = o;
          else
            o += *slot;
        }
        acc[i][e] = o;
      }
  }

  // write rows g and g + 8 of this warp's tile, real columns only
  bf16* og = out + (size_t)row * lq * ld + head_off;
  const int r0 = q0 + warp * 16 + g;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int col = i * 8 + 2 * tq;
    if (col >= d) continue;
    if (r0 < lq)
      *reinterpret_cast<uint32_t*>(og + (size_t)r0 * ld + col) =
          pack_bf16x2(acc[i][0], acc[i][1]);
    if (r0 + 8 < lq)
      *reinterpret_cast<uint32_t*>(og + (size_t)(r0 + 8) * ld + col) =
          pack_bf16x2(acc[i][2], acc[i][3]);
  }
}

template <int DP, bool NBR>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int lq, int lk, int heads, int d, int n_cam,
                   float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(kBlockQ + 4 * kBlockK) * (DP + 8) * sizeof(bf16) +
                      (NBR ? (size_t)kThreads * (DP / 2) * sizeof(float) : 0);
  auto kernel = attention_kernel<DP, NBR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((lq + kBlockQ - 1) / kBlockQ, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lq, lk, heads * d,
      d, n_cam, scale * kLog2e);
  return cudaGetLastError();
}

template <bool NBR>
int dispatch(const void* q, const void* k, const void* v, void* out,
             int batch, int lq, int lk, int heads, int d, int n_cam,
             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 8 || d > 160) return (int)cudaErrorInvalidValue;
  const int dp = (d + 15) / 16 * 16;
#define DD_CASE(P)                                                        \
  case P:                                                                 \
    return (int)launch<P, NBR>(q, k, v, out, batch, lq, lk, heads, d,     \
                               n_cam, scale, s);
  switch (dp) {
    DD_CASE(16)
    DD_CASE(32)
    DD_CASE(48)
    DD_CASE(64)
    DD_CASE(80)
    DD_CASE(96)
    DD_CASE(112)
    DD_CASE(128)
    DD_CASE(144)
    DD_CASE(160)
  }
#undef DD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int dd_packed_attention_fwd(const void* q, const void* k,
                                       const void* v, void* out, int batch,
                                       int lq, int lk, int heads, int head_dim,
                                       float scale, void* stream) {
  return dispatch<false>(q, k, v, out, batch, lq, lk, heads, head_dim, 1,
                         scale, stream);
}

extern "C" int dd_packed_attention_nbr_fwd(const void* q, const void* k,
                                           const void* v, void* out,
                                           int batch, int l, int heads,
                                           int head_dim, int n_cam,
                                           float scale, void* stream) {
  if (n_cam < 1 || batch % n_cam) return (int)cudaErrorInvalidValue;
  return dispatch<true>(q, k, v, out, batch, l, l, heads, head_dim, n_cam,
                        scale, stream);
}
