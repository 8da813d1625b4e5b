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
//
// attn_f32_kernel: the same softmax attention with no rounding anywhere, for
// K7 in fp32 (flash_attention.cu) and the attention of K3's single-context
// form at compute_dtype=float32 (fused_sublayer.cu): fp32 operands, fp32
// FFMA products and sums on the CUDA cores, P kept in fp32 for P V. See
// its own comment below.

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
  long long k_s1, k_s2, k_sj;  // shared by k and v
  long long o_s1, o_s2, o_si;
  int nb2, Lq, Lk;
  const bf16* qg;  // [C] gamma * sqrt(D), or null: no RMS norm on q
  const bf16* kg;  // likewise for k (attention_sm90.cuh takes none)
  const float* bias = nullptr;  // [row block z1][Lk] logit bias, or null
  long long bias_s1 = 0;
  float scale;
  float scale_log2 = 0.f;  // scale * log2(e), rounded once: attn_kernel's
                           // FIXED form and attention_sm90.cuh
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
// attn_f32_kernel: one CTA (128 threads) per (64-query tile, head, batch
// row). Q, each 64-key tile of K and V, and P sit in shared memory as fp32
// rows padded to D + 4 floats (so 16-byte reads of neighbouring rows fall in
// other banks); every product is an fp32 FFMA, so no operand is rounded.
// Thread (ty, tx) = (tid / 16, tid % 16) owns query rows 8 ty .. 8 ty + 7:
// for S it takes keys tx + 16 j (j < 4), each q . k read 4 lanes at a time;
// for P V it takes output lanes tx * D/16 .. The softmax is online, with a
// true running maximum per row reduced across the 16 threads of the half
// warp that owns it; the row sum comes from the fp32 P.
//
// Key validity (valid != null, K7): an invalid key gets the additive mask
// value -0.7 * FLT_MAX (the TPU kernel's, not -inf), a 64-key tile with no
// valid key (counts) is skipped, which is exact (it would add exp(mask - m)
// = 0 to every row), and a batch row with no valid key at all takes P = 1 on
// every key and divides by lk_pad, the key count padded to the TPU kernel's
// 512. Without validity every key below Lk is visible.
//
// With lse set (K7's forward under autograd, the residual its backward
// reads; the TPU kernel saves its running max m and sum l instead), each
// row's logsumexp m + log(l) over the scores with the mask added, in fp32;
// a batch row with no valid key writes log(lk_pad), and the backward takes
// P = 1 / lk_pad there itself.
//
// What bounds it on the H100: fp32 operations on the CUDA cores (67 TFLOP/s
// on the datasheet), 4 * Lq * Lk_visited * D per head; per 4 lanes of the
// head a thread issues 12 16-byte shared loads against 128 FFMAs. A first
// version, written to be right: no tensor cores (a 3xTF32 split would be the
// next step), no cp.async pipelining of the K/V tiles.

constexpr float F32_MASK_VALUE = -0.7f * FLT_MAX;

struct F32AttnParams {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, o_sb, o_sl;  // in floats
  const unsigned char* valid;  // [B, Lk] bool, or null: every key valid
  const int* counts;           // [B, tiles] valid keys per tile (with valid)
  float* lse;                  // [B, H, Lq] row logsumexp out, or null
  int Lq, Lk, tiles, lk_pad;
  float scale;
};

template <int D>
__host__ __device__ constexpr int attn_f32_smem_bytes() {
  return (3 * 64 * (D + 4) + 64 * (64 + 4)) * (int)sizeof(float);
}

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

template <int D>
__global__ void __launch_bounds__(128) attn_f32_kernel(F32AttnParams p) {
  extern __shared__ __align__(16) float f32_smem[];
  constexpr int LD = D + 4, LP = 64 + 4, DT = D / 16, CH = D / 4;
  float* sQ = f32_smem;
  float* sK = sQ + 64 * LD;
  float* sV = sK + 64 * LD;
  float* sP = sV + 64 * LD;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * 64;
  const float* qb = p.q + b * p.q_sb + h * D;
  const float* kb = p.k + b * p.k_sb + h * D;
  const float* vb = p.v + b * p.v_sb + h * D;
  const unsigned char* vld = p.valid ? p.valid + (long long)b * p.Lk : nullptr;
  const int* cnt = p.counts ? p.counts + (long long)b * p.tiles : nullptr;

  // a batch row with no valid key takes every key, each with P = 1
  bool uniform = false;
  if (cnt) {
    int any = 0;
    for (int t = tid; t < p.tiles; t += 128) any |= cnt[t];
    uniform = !__syncthreads_or(any);
  }

  // 64 rows of D floats, strided by sl, into [64][LD]; rows past n are zero
  auto load = [&](const float* src, long long sl, int n, float* dst) {
    for (int idx = tid; idx < 64 * CH; idx += 128) {
      const int r = idx / CH, c = (idx % CH) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < n) val = *reinterpret_cast<const float4*>(src + r * sl + c);
      *reinterpret_cast<float4*>(dst + r * LD + c) = val;
    }
  };
  load(qb + (long long)q0 * p.q_sl, p.q_sl, p.Lq - q0, sQ);

  float m_run[8], l_run[8], o_acc[8][DT];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_run[i] = neg_inf();
    l_run[i] = 0.f;
#pragma unroll
    for (int u = 0; u < DT; ++u) o_acc[i][u] = 0.f;
  }

  for (int t = 0; t < p.tiles; ++t) {
    if (cnt && !uniform && cnt[t] == 0) continue;  // uniform across the CTA
    const int j0 = t * 64;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load(kb + (long long)j0 * p.k_sl, p.k_sl, p.Lk - j0, sK);
    load(vb + (long long)j0 * p.v_sl, p.v_sl, p.Lk - j0, sV);
    __syncthreads();

    // S = Q K^T: rows 8 ty + i, keys tx + 16 j
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(sQ + (ty * 8 + i) * LD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv.x, kv[j].x, a);
          a = fmaf(qv.y, kv[j].y, a);
          a = fmaf(qv.z, kv[j].z, a);
          s[i][j] = fmaf(qv.w, kv[j].w, a);
        }
      }
    }

    // online softmax per row; every visited tile holds a key below Lk, whose
    // score is finite, so the running maximum is finite from the first tile
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = neg_inf();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = j0 + tx + 16 * j;
        float v = neg_inf();
        if (key < p.Lk) {
          if (uniform) {
            v = 0.f;
          } else {
            v = s[i][j] * p.scale;
            if (vld && !vld[key]) v += F32_MASK_VALUE;
          }
        }
        s[i][j] = v;
        mx = fmaxf(mx, v);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        psum += e;
        sP[(ty * 8 + i) * LP + tx + 16 * j] = e;
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l_run[i] = l_run[i] * alpha + psum;
      m_run[i] = m_new;
#pragma unroll
      for (int u = 0; u < DT; ++u) o_acc[i][u] *= alpha;
    }
    __syncwarp();  // a row's P is written and read by one half warp

    // O += P V: rows 8 ty + i, lanes tx * DT .. tx * DT + DT - 1
#pragma unroll 2
    for (int kk = 0; kk < 64; kk += 4) {
      float4 pv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        pv[i] = *reinterpret_cast<const float4*>(sP + (ty * 8 + i) * LP + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vv[DT];
        lds_f32<DT>(sV + (kk + e) * LD + tx * DT, vv);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float pk = e == 0 ? pv[i].x : e == 1 ? pv[i].y
                         : e == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int u = 0; u < DT; ++u) o_acc[i][u] = fmaf(pk, vv[u], o_acc[i][u]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qi = q0 + ty * 8 + i;
    if (qi < p.Lq) {
      const float inv = 1.f / (uniform ? (float)p.lk_pad : l_run[i]);
      float* orow = p.o + b * p.o_sb + qi * p.o_sl + h * D + tx * DT;
#pragma unroll
      for (int u = 0; u < DT; ++u) orow[u] = o_acc[i][u] * inv;
      if (p.lse && tx == 0)
        p.lse[((long long)b * gridDim.y + h) * p.Lq + qi] =
            uniform ? logf((float)p.lk_pad) : m_run[i] + logf(l_run[i]);
    }
  }
}

// grid: (query tiles, heads, batch rows); heads of 32, 64 or 128
inline cudaError_t launch_attn_f32(const F32AttnParams& p, int H, int B, int D,
                                   cudaStream_t s) {
  const dim3 grid(cdiv(p.Lq, 64), H, B);
  cudaError_t err;
#define GVF_LAUNCH_F32(DV)                                                   \
  err = cudaFuncSetAttribute(attn_f32_kernel<DV>,                            \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,    \
                             attn_f32_smem_bytes<DV>());                     \
  if (err != cudaSuccess) return err;                                        \
  attn_f32_kernel<DV><<<grid, 128, attn_f32_smem_bytes<DV>(), s>>>(p);
  if (D == 32) {
    GVF_LAUNCH_F32(32)
  } else if (D == 64) {
    GVF_LAUNCH_F32(64)
  } else if (D == 128) {
    GVF_LAUNCH_F32(128)
  } else {
    return cudaErrorInvalidValue;
  }
#undef GVF_LAUNCH_F32
  return cudaGetLastError();
}

}  // namespace gvf
