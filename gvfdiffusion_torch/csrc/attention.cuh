// Softmax attention tile kernels for Hopper (sm_90a).
//
// attn_kernel serves K2 alone (fused_sublayer.cu's temporal sublayer, heads
// of 32 and 64): K1, K5 and K3's bf16 forms run attention_sm90.cuh's core,
// which shares AttnParams below. It is the first version, written to be
// right first.
//
// attn_kernel: one CTA (4 warps) per (64-query tile, head, row block z).
// Per 64-key tile staged in shared memory: S = Q K^T on tensor cores (WMMA
// 16x16x16, bf16 in, fp32 out), a softmax in fp32, P rounded to bf16 for the
// P V product, whose fp32 result adds into a register accumulator. The row
// sum is taken from the fp32 P, as the TPU kernels take it. The softmax is
// either online with a true running maximum, or (FIXED) the TPU kernels'
// fixed shift: P = exp2(S * scale * log2(e) - 30), which needs no maximum
// and no rescale. Keys past Lk are masked; an optional fp32 additive logit
// bias per key (-inf masks the key) is read from device memory by the
// softmax step; a row with no visible key returns 0, never NaN. Optional
// per-head RMS norm of q/k in the load (the DiT's self/temporal sublayers).
// q/k/v are read as bf16 or fp32 and rounded to bf16; the output is written
// as TO (bf16 or fp32).

#pragma once

#include <float.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

namespace gvf {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

inline unsigned cdiv(long long a, long long b) { return (unsigned)((a + b - 1) / b); }

// Row block z splits as (z / nb2, z % nb2) with strides s1 / s2, rows within
// a block step by si (queries) or sj (keys / values). Offsets in elements;
// head h starts h * D elements into a row.
struct AttnParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;  // TO
  long long q_s1, q_s2, q_si;
  long long k_s1, k_s2, k_sj;  // and v's, unless v_sj is set
  long long o_s1, o_s2, o_si;
  int nb2, Lq, Lk;
  const bf16* qg;  // [C] gamma * sqrt(D), or null: no RMS norm on q
  const bf16* kg;  // likewise for k (attention_sm90.cuh takes none)
  const float* bias = nullptr;  // [row block z1][Lk] logit bias, or null
  long long bias_s1 = 0;
  float scale;
  float scale_log2 = 0.f;  // scale * log2(e), rounded once: attn_kernel's
                           // FIXED form and attention_sm90.cuh
  // the Hopper core only (attention_sm90.cuh, attention_sm90_tf32.cuh; K7):
  // v on strides of its own (v_sj = 0: k's), the key validity bytes of row
  // block z1 at valid + z1 * valid_s1 (0 masks the key), and the key tiles
  // to visit, at tiles + z1 * tiles_s1: their count, then their indices in
  // ascending order (null: every tile)
  long long v_s1 = 0, v_sj = 0;
  const unsigned char* valid = nullptr;
  long long valid_s1 = 0;
  const int* tiles = nullptr;
  long long tiles_s1 = 0;
  // attention_sm90_tf32.cuh only: the [z1][H][Lq] row logsumexp out, or
  // null; o_lo: null, or o is written split, tf32(o) there and tf32(o -
  // tf32(o)) at o_lo (the operand of K3's 3xTF32 out projection)
  float* lse = nullptr;
  void* o_lo = nullptr;
};

constexpr int ABQ = 64, ABK = 64;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float EXP2_SHIFT = 30.f;  // the TPU kernels' fixed exp2 shift

// Loads one row half (D/2 values) of a q or k row, RMS-normalizes it across
// the thread pair that holds the row, and stores it as bf16.
template <int D, typename T>
__device__ __forceinline__ void load_row_half(const T* src, bool valid,
                                              const bf16* gamma, bf16* dst) {
  float vals[D / 2];
  float ss = 0.f;
#pragma unroll
  for (int d = 0; d < D / 2; ++d) {
    vals[d] = valid ? to_f(src[d]) : 0.f;
    ss += vals[d] * vals[d];
  }
  ss += __shfl_xor_sync(0xffffffffu, ss, 1);
  const float f = gamma ? rsqrtf(ss + 1e-12f) : 1.f;
#pragma unroll
  for (int d = 0; d < D / 2; ++d) {
    const float g = gamma ? to_f(gamma[d]) : 1.f;
    dst[d] = __float2bfloat16(vals[d] * f * g);
  }
}

// per warp: the scores [16][64] fp32, then the P V tile [16][D <= 64]
template <int D>
__host__ __device__ constexpr int attn_s_floats() { return 16 * ABK; }

// Dynamic shared memory: Q, K, V [64][D] bf16, per warp the score / P V
// area and P [16][64] bf16: 36 KB at D = 32, 48 KB at 64.
template <int D>
__host__ __device__ constexpr int attn_smem_bytes() {
  return 3 * 64 * D * 2 + 4 * attn_s_floats<D>() * 4 + 4 * 16 * ABK * 2;
}

template <int D, typename TQ, typename TKV, typename TO, bool FIXED>
__global__ void __launch_bounds__(128) attn_kernel(AttnParams p) {
  extern __shared__ __align__(128) unsigned char attn_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(attn_smem);
  bf16* sK = sQ + ABQ * D;
  bf16* sV = sK + ABK * D;
  float* sS = reinterpret_cast<float*>(sV + ABK * D);
  bf16* sP = reinterpret_cast<bf16*>(sS + 4 * attn_s_floats<D>());

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y;
  const long long z1 = blockIdx.z / p.nb2, z2 = blockIdx.z % p.nb2;
  const TQ* qb = (const TQ*)p.q + z1 * p.q_s1 + z2 * p.q_s2 + h * D;
  const TKV* kb = (const TKV*)p.k + z1 * p.k_s1 + z2 * p.k_s2 + h * D;
  const TKV* vb = (const TKV*)p.v + z1 * p.k_s1 + z2 * p.k_s2 + h * D;
  TO* ob = (TO*)p.o + z1 * p.o_s1 + z2 * p.o_s2 + h * D;
  const float* bb = p.bias ? p.bias + z1 * p.bias_s1 : nullptr;
  const int q0 = blockIdx.x * ABQ;

  // prologue: Q tile, two threads per row
  const int lr = tid >> 1, lh = (tid & 1) * (D / 2);
  {
    const int qi = q0 + lr;
    load_row_half<D>(qb + (long long)qi * p.q_si + lh, qi < p.Lq,
                     p.qg ? p.qg + h * D + lh : nullptr, sQ + lr * D + lh);
  }

  // softmax state: lanes (2r, 2r+1) of a warp own query row r of its 16
  const int r = lane >> 1, half = lane & 1;
  float m_run = neg_inf(), l_run = 0.f;
  float o_acc[D / 2];
#pragma unroll
  for (int d = 0; d < D / 2; ++d) o_acc[d] = 0.f;
  float* sSw = sS + warp * attn_s_floats<D>();
  bf16* sPw = sP + warp * 16 * ABK;

  for (int j0 = 0; j0 < p.Lk; j0 += ABK) {
    __syncthreads();  // the previous tile's K/V are no longer read
    {
      const int kj = j0 + lr;
      const bool ok = kj < p.Lk;
      load_row_half<D>(kb + (long long)kj * p.k_sj + lh, ok,
                       p.kg ? p.kg + h * D + lh : nullptr, sK + lr * D + lh);
      const TKV* vr = vb + (long long)kj * p.k_sj + lh;
#pragma unroll
      for (int d = 0; d < D / 2; ++d)
        sV[lr * D + lh + d] = __float2bfloat16(ok ? to_f(vr[d]) : 0.f);
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 query rows
#pragma unroll
    for (int j = 0; j < ABK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sQ + warp * 16 * D + kk, D);
        wmma::load_matrix_sync(fb, sK + j * 16 * D + kk, D);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sSw + j * 16, acc, ABK, wmma::mem_row_major);
    }
    __syncwarp();

    // softmax: each lane takes 32 keys of its row
    float sv[32];
    float alpha = 1.f, psum = 0.f;
    if (FIXED) {
      // exp2(s * scale * log2 e - (30 - bias * log2 e)), the TPU kernels'
      // rounding points: no maximum, so nothing rescales (alpha = 1)
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int j = j0 + half * 32 + c;
        float e = 0.f;
        if (j < p.Lk) {
          const float b = bb ? EXP2_SHIFT - bb[j] * LOG2E : EXP2_SHIFT;
          e = exp2f(sSw[r * ABK + half * 32 + c] * p.scale_log2 - b);
        }
        sv[c] = e;
        psum += e;
      }
    } else {
      // online: a tile whose keys are all masked leaves m_new at -inf; the
      // branch below then adds nothing, so exp(-inf - -inf) is never formed
      float mx = neg_inf();
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int j = j0 + half * 32 + c;
        float s = neg_inf();
        if (j < p.Lk) {
          s = sSw[r * ABK + half * 32 + c] * p.scale;
          if (bb) s += bb[j];
        }
        sv[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_run, mx);
      if (m_new == neg_inf()) {
#pragma unroll
        for (int c = 0; c < 32; ++c) sv[c] = 0.f;
      } else {
        alpha = expf(m_run - m_new);
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          sv[c] = expf(sv[c] - m_new);
          psum += sv[c];
        }
      }
      m_run = m_new;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_run = l_run * alpha + psum;
#pragma unroll
    for (int c = 0; c < 32; ++c)
      sPw[r * ABK + half * 32 + c] = __float2bfloat16(sv[c]);
    __syncwarp();

    // P V into the (now free) score area as [16, D]
#pragma unroll
    for (int dj = 0; dj < D / 16; ++dj) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < ABK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sPw + kk, ABK);
        wmma::load_matrix_sync(fb, sV + kk * D + dj * 16, D);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sSw + dj * 16, acc, D, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int d = 0; d < D / 2; ++d)
      o_acc[d] = o_acc[d] * alpha + sSw[r * D + half * (D / 2) + d];
    __syncwarp();
  }

  const int qi = q0 + warp * 16 + r;
  if (qi < p.Lq) {
    const float inv = l_run > 0.f ? 1.f / l_run : 0.f;  // fully masked row -> 0
    TO* orow = ob + (long long)qi * p.o_si + half * (D / 2);
#pragma unroll
    for (int d = 0; d < D / 2; ++d) orow[d] = from_f<TO>(o_acc[d] * inv);
  }
}

// grid: (query tiles, heads, row blocks); heads of 32 or 64 (at most 48 KB
// of dynamic shared memory, the default limit)
template <int D, typename TQ, typename TKV, typename TO = bf16,
          bool FIXED = false>
cudaError_t launch_attn(const AttnParams& p, int H, long long nb1,
                        cudaStream_t s) {
  static_assert(D == 32 || D == 64, "attn_kernel takes heads of 32 or 64");
  dim3 grid(cdiv(p.Lq, ABQ), H, (unsigned)(nb1 * p.nb2));
  constexpr int bytes = attn_smem_bytes<D>();
  attn_kernel<D, TQ, TKV, TO, FIXED><<<grid, 128, bytes, s>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// For K7's backward (flash_attention_bwd.cu): the TPU kernel's additive mask
// value on an invalid key, and short fp32 reads from shared memory.

constexpr float F32_MASK_VALUE = -0.7f * FLT_MAX;

// n consecutive floats (n = 2, 4 or 8) from 8-byte-aligned shared memory
template <int N>
__device__ __forceinline__ void lds_f32(const float* src, float* dst) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int u = 0; u < N; u += 4) {
      const float4 t = *reinterpret_cast<const float4*>(src + u);
      dst[u] = t.x; dst[u + 1] = t.y; dst[u + 2] = t.z; dst[u + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < N; u += 2) {
      const float2 t = *reinterpret_cast<const float2*>(src + u);
      dst[u] = t.x; dst[u + 1] = t.y;
    }
  }
}

}  // namespace gvf
