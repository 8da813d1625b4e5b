// The Hopper attention core's fp32 path (sm_90a), under K7 in fp32
// (flash_attention.cu: with and without its logsumexp residual) and K3's
// single context at compute_dtype=float32 (fused_sublayer.cu): softmax
// attention in which no operand is rounded to bf16, its two products by the
// 3xTF32 split on the tensor cores (attention_sm90.cuh: x = hi + lo, a.b =
// lo.hi' + hi.lo' + hi.hi', in short chains summed in fp32: about fp32's
// precision).
//
// Replaces, on the card, the attention of
//   gvfdiffusion_tpu/sparse/attention.py:57 `_flash_full_attention` (the
//     stock Pallas TPU flash attention) in fp32 (K7);
//   gvfdiffusion_tpu/ops/fused_sublayer.py:839 fused_cross_sublayer, body
//     _cross_sublayer_kernel :589, at compute_dtype=float32 (K3, one
//     context).
//
// What it computes: O = softmax(Q K^T * scale) V per (query row, head,
// batch row), q/k/v/o fp32 on their own strides (q optionally RMS-normed
// per head in fp32 with the gamma qg_f32: K3's rms); the softmax online with a
// true running maximum in fp32 (exp2 with the scale's log2 e folded in, the
// accurate exp2f), the row sum from the fp32 P, P split (not rounded) for P
// V, the output normalised once. Keys past Lk are masked; with key validity
// (K7) an invalid key takes the TPU kernel's mask value, -inf once times
// log2 e, and the CTA visits only its batch row's listed key tiles (each
// holds a valid key, so a row's maximum is a real score); a batch row with
// no listed tile writes 0 here (flash_attention.cu then writes its mean of
// V). With lse set, each row's natural logsumexp m ln 2 + ln l, the
// residual of K7's backward; with o_lo set, O written split into tf32
// halves, the A operand of K3's 3xTF32 out projection.
//
// Design: attention_sm90.cuh's core with fp32 tiles. One CTA per (query
// tile of 64 NWG rows, head, batch row): NWG consumer warpgroups, then four
// producer warps that fill a ring of 2 stages. Per stage the producers
// load BK keys of K and V as fp32 (16-byte loads), split each value and
// store K's hi and lo K-major in wgmma's 128-byte swizzle (rows of D fp32:
// Sw<2 D>'s bytes) and V's transposed, [D][BK] K-major (Sw<2 BK>; a warp
// on 32 keys, so that its 4-byte stores fill a row's banks), with the
// keys of each group of 8 permuted (key 2 t at k-column t, key 2 t + 1 at
// t + 4) so that the S accumulator's registers are, as they stand, P's
// register A operand of m64nDk8 (a thread holds keys 2 t and 2 t + 1 of
// each group, the A operand k-columns t and t + 4); plus the tile's bias
// row. Each consumer warpgroup splits its 64 query rows once into hi and
// lo tiles; per key tile S = lo.hi' + hi.lo' + hi.hi' with m64nBKk8 (both
// from shared memory), the softmax on the accumulator in registers, P split
// in registers and Plo.Vhi + Phi.Vlo + Phi.Vhi with m64nDk8, each half of
// the tile's keys into a fresh accumulator that is added into O in fp32:
// the tensor cores' accumulation, over a long chain of products, loses
// more than fp32 adds (with O accumulated across all tiles on the tensor
// cores K7 read 2.6e-5 against fp64, its plain fp32 version 1.1e-6). O is
// written from the registers.
//   heads of 32 and 64: 64-key tiles, 2 warpgroups (128 query rows), 128 /
//   192 KB of shared memory; heads of 128: 32-key tiles, 1 warpgroup, 192
//   KB.
//
// What bounds it on the H100: three tf32 products for each of S and P V,
// 12 Lq Lk_visited D flops a head at 495 TFLOP/s, against the fp32 FFMA
// bound's 4 Lq Lk D at 67 (3xTF32 is 2.5x that bound's rate); under them
// the producers' loads, splits and stores.

#pragma once

#include "attention_sm90.cuh"

namespace gvf {
namespace sm90 {

template <int D>
struct Tf32Cfg {
  static constexpr int BK = D == 128 ? 32 : 64;
  static constexpr int NWG = D == 128 ? 1 : 2;
  static constexpr int STAGES = 2;
  // Shared memory, from a 1024-byte aligned base: Q hi / lo [NWG][2][64][D],
  // per stage K hi / lo [2][BK][D] and V^T hi / lo [2][D][BK], the bias rows
  // [STAGES][BK], the full / empty mbarriers
  static constexpr int QT = 64 * D * 4;  // one 64-row Q tile
  static constexpr int KT = BK * D * 4;  // one K or V^T tile
  static constexpr int Q = 0;
  static constexpr int STAGE = Q + NWG * 2 * QT;
  static constexpr int BIAS = STAGE + STAGES * 4 * KT;
  static constexpr int BAR = BIAS + STAGES * BK * 4;
  static constexpr int BYTES = BAR + 2 * STAGES * 8 + 1024;  // + alignment
};

// the k-column of key e (< 8) of its group of 8 in the V^T tile
__device__ __forceinline__ int key_col(int e) {
  return (e & 1) ? 4 + (e >> 1) : e >> 1;
}

// QN: q RMS-normed with p.qg_f32 (K3's single context with rms)
template <int D, bool QN>
__global__ void __launch_bounds__(Tf32Cfg<D>::NWG * 128 + 128, 1)
    attn_tf32_kernel(const AttnParams p) {
  using C = Tf32Cfg<D>;
  constexpr int BK = C::BK, NWG = C::NWG, STAGES = C::STAGES;
  using SQ = Sw<2 * D>;   // Q and K: rows of D fp32
  using SV = Sw<2 * BK>;  // V^T: rows of BK fp32
  extern __shared__ __align__(1024) unsigned char fsmem_raw[];
  unsigned char* smem =
      fsmem_raw + ((1024 - (smem_u32(fsmem_raw) & 1023)) & 1023);
  float* sB = reinterpret_cast<float*>(smem + C::BIAS);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const long long z1 = blockIdx.z;
  const int q0 = blockIdx.x * (64 * NWG);
  const int* tl = p.tiles ? p.tiles + z1 * p.tiles_s1 : nullptr;
  const int tiles = tl ? tl[0] : (p.Lk + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NWG * 128) {
    // ---- producer warps: K/V tiles split into hi / lo, and the bias row
    const int pt = tid - NWG * 128;
    const float* kb = (const float*)p.k + z1 * p.k_s1 + h * D;
    const float* vb = (const float*)p.v + z1 * p.v_s1 + h * D;
    const unsigned char* vl = p.valid ? p.valid + z1 * p.valid_s1 : nullptr;
    for (int t = 0; t < tiles; ++t) {
      const int s = t % STAGES;
      if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
      const int j0 = (tl ? tl[1 + t] : t) * BK;
      unsigned char* sk = smem + C::STAGE + s * 4 * C::KT;
      unsigned char* sv = sk + 2 * C::KT;
      // K: 4 fp32 of a row a lane, a row's lanes side by side (coalesced
      // loads, 16-byte stores free of bank conflicts)
#pragma unroll 4
      for (int idx = pt; idx < BK * D / 4; idx += 128) {
        const int r = idx / (D / 4), c = idx % (D / 4);
        const int j = j0 + r;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j < p.Lk)
          a = *reinterpret_cast<const float4*>(kb + (long long)j * p.k_sj +
                                               c * 4);
        uint4 hi, lo;
        split_tf32(a.x, hi.x, lo.x);
        split_tf32(a.y, hi.y, lo.y);
        split_tf32(a.z, hi.z, lo.z);
        split_tf32(a.w, hi.w, lo.w);
        const int o = SQ::off(r, c, BK);
        *reinterpret_cast<uint4*>(sk + o) = hi;
        *reinterpret_cast<uint4*>(sk + C::KT + o) = lo;
      }
      // V transposed: a warp's lanes take 32 consecutive keys at the same 4
      // head lanes, so that each of its 4-byte stores fills one V^T row's 32
      // banks; key r sits at k-column (r & ~7) + key_col(r & 7)
#pragma unroll 4
      for (int idx = pt; idx < BK * D / 4; idx += 128) {
        const int r = idx % BK, c = idx / BK;
        const int j = j0 + r;
        float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j < p.Lk)
          b = *reinterpret_cast<const float4*>(vb + (long long)j * p.v_sj +
                                               c * 4);
        const int col = (r & ~7) + key_col(r & 7);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t vh, vlo;
          split_tf32(bv[e], vh, vlo);
          const int ov = SV::off(c * 4 + e, col >> 2, D) + (col & 3) * 4;
          *reinterpret_cast<uint32_t*>(sv + ov) = vh;
          *reinterpret_cast<uint32_t*>(sv + C::KT + ov) = vlo;
        }
      }
      for (int i = pt; i < BK; i += 128) {
        const int j = j0 + i;
        // an invalid key: the mask value -0.7 FLT_MAX times log2 e, -inf
        sB[s * BK + i] = j < p.Lk && !(vl && !vl[j]) ? 0.f : neg_inf();
      }
      fence_async();  // the tiles' plain stores, before wgmma reads them
      mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63
  const int wg = tid >> 7, tw = tid & 127, warp = tw >> 5, lane = tid & 31;
  unsigned char* sQw = smem + C::Q + wg * 2 * C::QT;
  {
    // two threads per row, D / 2 values each: load, RMS norm (QN:
    // q * rsqrt(sum q^2 + 1e-12) * gamma per head, in fp32), split
    const int r = tw >> 1, hf = tw & 1;
    const int qi = q0 + wg * 64 + r;
    const float* src = (const float*)p.q + z1 * p.q_s1 + h * D +
                       (long long)(qi < p.Lq ? qi : 0) * p.q_si + hf * (D / 2);
    auto put = [&](int c, const float4 a) {
      uint4 hi, lo;
      split_tf32(a.x, hi.x, lo.x);
      split_tf32(a.y, hi.y, lo.y);
      split_tf32(a.z, hi.z, lo.z);
      split_tf32(a.w, hi.w, lo.w);
      const int o = SQ::off(r, hf * (D / 8) + c, 64);
      *reinterpret_cast<uint4*>(sQw + o) = hi;
      *reinterpret_cast<uint4*>(sQw + C::QT + o) = lo;
    };
    if constexpr (QN) {
      float4 qv[D / 8];
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        qv[c] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (qi < p.Lq) qv[c] = *reinterpret_cast<const float4*>(src + c * 4);
      }
      float ss = 0.f;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        ss += qv[c].x * qv[c].x + qv[c].y * qv[c].y + qv[c].z * qv[c].z +
              qv[c].w * qv[c].w;
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      const float f = rsqrtf(ss + 1e-12f);
      const float* g = p.qg_f32 + h * D + hf * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        qv[c].x = qv[c].x * f * g[4 * c];
        qv[c].y = qv[c].y * f * g[4 * c + 1];
        qv[c].z = qv[c].z * f * g[4 * c + 2];
        qv[c].w = qv[c].w * f * g[4 * c + 3];
        put(c, qv[c]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        if (qi < p.Lq) a = *reinterpret_cast<const float4*>(src + c * 4);
        put(c, a);
      }
    }
    fence_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  }

  const uint32_t qhi = smem_u32(sQw), qlo = qhi + C::QT;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {neg_inf(), neg_inf()}, l_run[2] = {0.f, 0.f};
  float sc[BK / 2], part[D / 2];
  uint32_t ph[BK / 16][4], pl[BK / 16][4];
  const int quad = lane & 3;

  for (int t = 0; t < tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    fence_async();
    const uint32_t khi = smem_u32(smem + C::STAGE + s * 4 * C::KT);
    const uint32_t klo = khi + C::KT, vhi = khi + 2 * C::KT,
                   vlo = khi + 3 * C::KT;
    // S = Q K^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      wgmma_tf32_ss<BK>(sc, SQ::kmajor(qlo, kk, 64), SQ::kmajor(khi, kk, BK),
                        kk > 0);
      wgmma_tf32_ss<BK>(sc, SQ::kmajor(qhi, kk, 64), SQ::kmajor(klo, kk, BK),
                        1);
      wgmma_tf32_ss<BK>(sc, SQ::kmajor(qhi, kk, 64), SQ::kmajor(khi, kk, BK),
                        1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BK / 2>(sc);

    // the online softmax on the accumulator: sc[4 i + 2 hr + e] is row
    // (16 warp + lane / 4 + 8 hr), key 8 i + 2 quad + e of the tile
    const float* bias_t = sB + s * BK;
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const float2 b =
          *reinterpret_cast<const float2*>(bias_t + 8 * i + 2 * quad);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float& x0 = sc[4 * i + 2 * hr];
        float& x1 = sc[4 * i + 2 * hr + 1];
        x0 = fmaf(x0, p.scale_log2, b.x);
        x1 = fmaf(x1, p.scale_log2, b.y);
        mx[hr] = fmaxf(mx[hr], fmaxf(x0, x1));
      }
    }
    float m_use[2], alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m_run[hr], mx[hr]);
      // while every key so far is masked the maximum is -inf: take 0
      m_use[hr] = m_new == neg_inf() ? 0.f : m_new;
      alpha[hr] = exp2f(m_run[hr] - m_use[hr]);
      m_run[hr] = m_new;
    }
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float& x0 = sc[4 * i + 2 * hr];
        float& x1 = sc[4 * i + 2 * hr + 1];
        x0 = exp2f(x0 - m_use[hr]);
        x1 = exp2f(x1 - m_use[hr]);
        ls[hr] += x0 + x1;
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l_run[hr] = l_run[hr] * alpha[hr] + ls[hr];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[4 * i] *= alpha[0];
      o[4 * i + 1] *= alpha[0];
      o[4 * i + 2] *= alpha[1];
      o[4 * i + 3] *= alpha[1];
    }

    // O += P V, each half of the tile's keys into a fresh accumulator that
    // is then added into O in fp32
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        // P's A operand for k-step i: rows g, g + 8 at k-columns t (key
        // 2 t) and t + 4 (key 2 t + 1)
        const int i = half * (BK / 16) + j;
        split_tf32(sc[4 * i + 0], ph[j][0], pl[j][0]);
        split_tf32(sc[4 * i + 2], ph[j][1], pl[j][1]);
        split_tf32(sc[4 * i + 1], ph[j][2], pl[j][2]);
        split_tf32(sc[4 * i + 3], ph[j][3], pl[j][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const int kk = half * (BK / 16) + j;
        wgmma_tf32_rs<D>(part, pl[j], SV::kmajor(vhi, kk, D), j > 0);
        wgmma_tf32_rs<D>(part, ph[j], SV::kmajor(vlo, kk, D), 1);
        wgmma_tf32_rs<D>(part, ph[j], SV::kmajor(vhi, kk, D), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(part);
      fence_regs_u<BK / 4>(&ph[0][0]);
      fence_regs_u<BK / 4>(&pl[0][0]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] += part[i];
    }
    mbar_arrive(&empty[s]);
  }

  // normalise (a row with no visible key has l = 0 and gives 0) and write
  // the rows from the registers; the quad's lane 0 writes the logsumexp
  float* ob = (float*)p.o + z1 * p.o_s1 + h * D;
  float* olb = p.o_lo ? (float*)p.o_lo + z1 * p.o_s1 + h * D : nullptr;
  const int r0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_run[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qi = r0 + 8 * hr;
    if (qi >= p.Lq) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const long long ro = (long long)qi * p.o_si + 2 * quad;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const float a = o[4 * i + 2 * hr] * inv, b = o[4 * i + 2 * hr + 1] * inv;
      if (p.o_lo) {
        uint2 hi, lo;
        split_tf32(a, hi.x, lo.x);
        split_tf32(b, hi.y, lo.y);
        *reinterpret_cast<uint2*>(ob + ro + 8 * i) = hi;
        *reinterpret_cast<uint2*>(olb + ro + 8 * i) = lo;
      } else {
        *reinterpret_cast<float2*>(ob + ro + 8 * i) = make_float2(a, b);
      }
    }
    if (p.lse && quad == 0)
      p.lse[(z1 * gridDim.y + h) * p.Lq + qi] =
          m_run[hr] * 0.69314718055994531f + logf(l);
  }
}

// grid: (query tiles, heads, batch rows); heads of 32, 64 or 128; q, k, v
// and o fp32, 16-byte aligned, with row and batch strides a multiple of 4
// elements; v on its own strides (v_sj = 0: k's)
template <int D>
cudaError_t launch_attn_tf32(const AttnParams& pa, int H, long long nb1,
                             cudaStream_t s) {
  using C = Tf32Cfg<D>;
  AttnParams p = pa;
  if (!p.v_sj) {
    p.v_s1 = p.k_s1;
    p.v_sj = p.k_sj;
  }
  if (nb1 < 1 || nb1 > 65535 || p.nb2 != 1 || H < 1 || H > 65535 ||
      p.Lq < 1 || p.Lk < 1 || p.qg || p.kg || p.bias || p.seg)
    return cudaErrorInvalidValue;
  auto misaligned = [](const void* ptr, long long stride) {
    return ((uintptr_t)ptr % 16) != 0 || stride % 4 != 0;
  };
  if (misaligned(p.q, p.q_si) || misaligned(p.q, p.q_s1) ||
      misaligned(p.k, p.k_sj) || misaligned(p.k, p.k_s1) ||
      misaligned(p.v, p.v_sj) || misaligned(p.v, p.v_s1) ||
      misaligned(p.o, p.o_si) || misaligned(p.o, p.o_s1) ||
      (uintptr_t)p.o_lo % 16)
    return cudaErrorMisalignedAddress;
  const bool qn = p.qg_f32 != nullptr;
  auto kern = qn ? attn_tf32_kernel<D, true> : attn_tf32_kernel<D, false>;
  static bool opted[2] = {false, false};  // the shared-memory opt-in, once
  if (!opted[qn]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
    if (err != cudaSuccess) return err;
    opted[qn] = true;
  }
  kern<<<dim3(cdiv(p.Lq, 64 * C::NWG), H, (unsigned)nb1), C::NWG * 128 + 128,
         C::BYTES, s>>>(p);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace gvf
