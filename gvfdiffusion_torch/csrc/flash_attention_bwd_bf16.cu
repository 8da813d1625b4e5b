// K7's backward in bf16 for Hopper (sm_90a): the gradient of
// flash_attention.cu's bf16 streaming attention over key validity, at heads
// of 32, 64 and 128 (the static VAE built with dtype=bfloat16 in `full`
// attention: [2, 32768, 12, 64], or 24 heads of 32, or 6 of 128).
//
// Replaces, in bf16, the stock Pallas TPU flash attention's two backward
// kernels that gvfdiffusion_tpu/sparse/attention.py:57
// `_flash_full_attention` differentiates through (jax/experimental/pallas/
// ops/tpu/flash_attention.py: `_flash_attention_bwd_dkv` ->
// `_flash_attention_dkv_kernel` :796, and `_flash_attention_bwd_dq` ->
// `_flash_attention_dq_kernel` :1146), kept as two kernels: dkv writes dK
// and dV, dq writes dQ; no atomics, deterministic. Their arithmetic in bf16,
// kept here: S = q k^T and dP = dO v^T from bf16 operands into fp32, P =
// exp(s - lse) from the forward's fp32 row logsumexp (taken as exp2(s scale
// log2 e - lse log2 e), an invalid key's mask -inf, whose exp2 is the TPU's
// 0), dS = P (dP - di) scale with di = rowsum(o dO) in fp32 (the wrapper's,
// as JAX computes it outside the kernels); P^T rounded to bf16 before dV =
// P^T dO (:900), dS rounded to bf16 before dK = dS^T Q (:918) and dQ = dS K
// (:1258); fp32 accumulation, each output rounded to bf16 once at the end
// (:937-938, :1283). Every query row is computed; a batch row with no valid
// key takes P = 1 / lk_pad on every key below Lk (flash_attention_bwd.cu
// says why); keys past Lk add nothing.
//
// Both kernels walk the bf16 forward's list of key tiles (128 keys at heads
// of 32 and 64, 64 at 128) in visits of 64 keys (flash_attention_bwd.cuh):
// a 128-key tile is two visits. Unlisted tiles have P = 0 exactly, their dK
// and dV stay the wrapper's zeros.
//
// Design: bf16 wgmma takes a shared-memory operand K-major or MN-major, so
// each tile is stored once, [row][d] in wgmma's swizzle (Sw<D>, the forward
// core's layout), and read both ways: as the K-major B of S = A B^T (the
// sum over d) and as the MN-major B of the products that sum over its rows.
// The accumulator of a score tile, rounded to bf16 pairs, is as it stands
// the register A operand (k16) of the product that sums over its columns
// (the forward's P V).
//   dkv: one CTA per (visit of 64 keys, head, batch row): one consumer
//   warpgroup holds K and V and walks the query tiles of BQ rows (64; 32 at
//   heads of 128, for registers): S^T = K Q^T and dP^T = V dO^T (m64nBQk16,
//   both operands in shared memory), P^T and dS^T on the accumulators, then
//   dV += P^T dO and dK += dS^T Q (m64nDk16, the register A operand against
//   dO and Q MN-major), accumulated on the tensor cores over every query
//   tile (its output is rounded to bf16). Four producer warps fill a ring
//   of 3 stages of Q and dO tiles (16-byte loads and stores) with the
//   tile's lse log2 e and di.
//   dq: one CTA per 128 query rows: two consumer warpgroups of 64 rows each
//   hold Q and dO and walk the visits: S = Q K^T, dP = dO V^T, dS on the
//   accumulators, dQ += dS K (K MN-major). The producers fill a ring of 2
//   stages of K and V tiles with the visit's key mask.
//
// What bounds it on the H100: the gradient's products over the valid keys
// Nv, dkv 8 B H Lq Nv D operations (S, dP, dV, dK) and dq 6 (S, dP, dQ),
// at the 989 TFLOP/s of dense bf16 (at the static VAE's [2, 32768, 12, 64]
// with 15721 + 12219 valid keys, dkv 5.69 ms and dq 4.27 ms); under them the
// SFU's exp2 per score and the softmax work on the accumulators, which run
// between the products of one warpgroup.

#include "flash_attention_bwd.cuh"

namespace gvf {
namespace sm90 {

// S^T over a query tile of 32 (dkv at heads of 128): m64n32k16
template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

}  // namespace sm90
}  // namespace gvf

namespace {

using namespace gvf;
using namespace gvf::fbwd;

// The key of row r (< U) of visit v over a list of LT-key tiles (lst: the
// count, then the indices), or -1 where the visit has no tile there
template <int LT, int U>
__device__ __forceinline__ int visit_key(const int* lst, bool uniform, int v,
                                         int r) {
  if (uniform) return v * U + r;
  if constexpr (LT >= U) {
    return lst[1 + v / (LT / U)] * LT + (v % (LT / U)) * U + r;
  } else {
    const int i = v * (U / LT) + r / LT;
    return i < lst[0] ? lst[1 + i] * LT + r % LT : -1;
  }
}

// the visits of one batch row
template <int LT, int U>
__device__ __forceinline__ int visit_count(const int* lst, bool uniform,
                                           int Lk) {
  if (uniform) return (Lk + U - 1) / U;
  if constexpr (LT >= U)
    return lst[0] * (LT / U);
  else
    return (lst[0] + U / LT - 1) / (U / LT);
}

// a key that counts: listed (not -1), below Lk and valid (every key below
// Lk counts in a batch row with no valid key)
__device__ __forceinline__ bool key_ok(int key, int Lk, bool uniform,
                                       const unsigned char* vld) {
  return key >= 0 && key < Lk && (uniform || vld[key]);
}

template <int D>
struct BfCfg {
  static constexpr int LT = D == 128 ? 64 : 128;  // the bf16 forward's tile
  static constexpr int U = 64;                    // keys a visit
  static constexpr int BQ = D == 128 ? 32 : 64;   // dkv's query tile
  static constexpr int KS = 3;                    // dkv's ring stages
  static constexpr int QS = 2;                    // dq's ring stages
  static constexpr int NWG = 2;                   // dq's consumer warpgroups
  static constexpr int KT = U * D * 2;            // a [64][D] bf16 tile
  static constexpr int QT = BQ * D * 2;           // a [BQ][D] bf16 tile
};

// dkv's shared memory, from a 1024-byte aligned base: K, V; per stage Q,
// dO; per stage the tile's lse log2 e and di [2][BQ]; full / empty bars
template <int D>
struct DkvLayout {
  using C = BfCfg<D>;
  static constexpr int K = 0, V = C::KT, STAGE = 2 * C::KT;
  static constexpr int STATS = STAGE + C::KS * 2 * C::QT;
  static constexpr int BAR = STATS + C::KS * 2 * C::BQ * 4;
  static constexpr int BYTES = BAR + 2 * C::KS * 8 + 1024;
};

// dq's: per consumer warpgroup Q, dO; per stage K, V; per stage the visit's
// key mask [64]; full / empty bars
template <int D>
struct DqLayout {
  using C = BfCfg<D>;
  static constexpr int Q = 0, STAGE = C::NWG * 2 * C::KT;
  static constexpr int BIAS = STAGE + C::QS * 2 * C::KT;
  static constexpr int BAR = BIAS + C::QS * C::U * 4;
  static constexpr int BYTES = BAR + 2 * C::QS * 8 + 1024;
};

// `rows` rows of D bf16 into a Sw<D> tile by 128 threads (16-byte chunks;
// the chunks of a row side by side); row r from src(r), or zeros where it
// gives null
template <int D, typename F>
__device__ __forceinline__ void load_tile(unsigned char* dst, int rows, int t,
                                          F src) {
  using S = Sw<D>;
  for (int idx = t; idx < rows * (D / 8); idx += 128) {
    const int r = idx / (D / 8), c = idx % (D / 8);
    const bf16* row = src(r);
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row) x = *reinterpret_cast<const uint4*>(row + c * 8);
    *reinterpret_cast<uint4*>(dst + S::off(r, c, rows)) = x;
  }
}

// an fp32 accumulator tile of N columns as bf16 register A operands of k16
// steps: pa[kk] = rows g, g + 8 at columns 16 kk + 2 quad (+1) and 16 kk + 8
// + 2 quad (+1)
template <int N>
__device__ __forceinline__ void pack_a(const float* x, uint32_t (*pa)[4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pa[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

template <int D>
__global__ void __launch_bounds__(256, 1)
    flash_bwd_dkv_bf16_kernel(const BwdParams p) {
  using C = BfCfg<D>;
  using L = DkvLayout<D>;
  using S = Sw<D>;
  constexpr int BQ = C::BQ, KS = C::KS;
  extern __shared__ __align__(1024) unsigned char bdkv_smem_raw[];
  unsigned char* smem = aligned_smem(bdkv_smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + KS;

  const int tid = threadIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int x = blockIdx.x;
  const int* lst = p.list + (long long)b * (1 + p.tiles);
  const bool uniform = lst[0] == 0;  // no valid key: every tile
  if (x >= visit_count<C::LT, C::U>(lst, uniform, p.Lk)) return;
  const int nq = (p.Lq + BQ - 1) / BQ;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    // ---- producer warps: per query tile, Q and dO with lse log2 e and di
    const int pt = tid - 128;
    const bf16* qb = (const bf16*)p.q + b * p.q_sb + h * D;
    const long long o_sl = (long long)p.H * D;
    const bf16* ob = (const bf16*)p.dout + (long long)b * p.Lq * o_sl + h * D;
    const float* lse_b = p.lse + ((long long)b * p.H + h) * p.Lq;
    const float* di_b = p.di + ((long long)b * p.H + h) * p.Lq;
    for (int t = 0; t < nq; ++t) {
      const int s = t % KS, q0 = t * BQ;
      if (t >= KS) mbar_wait(&empty[s], ((t / KS) - 1) & 1);
      unsigned char* sq = smem + L::STAGE + s * 2 * C::QT;
      load_tile<D>(sq, BQ, pt, [&](int r) {
        return q0 + r < p.Lq ? qb + (long long)(q0 + r) * p.q_sl : nullptr;
      });
      load_tile<D>(sq + C::QT, BQ, pt, [&](int r) {
        return q0 + r < p.Lq ? ob + (long long)(q0 + r) * o_sl : nullptr;
      });
      float* st = reinterpret_cast<float*>(smem + L::STATS) + s * 2 * BQ;
      for (int i = pt; i < BQ; i += 128) {
        const bool in = q0 + i < p.Lq;
        st[i] = in ? lse_b[q0 + i] * LOG2E : pos_inf();
        st[BQ + i] = in ? di_b[q0 + i] : 0.f;
      }
      fence_async();
      mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- the consumer warpgroup: the visit's 64 keys
  const int warp = tid >> 5, lane = tid & 31, quad = lane & 3;
  const bf16* kb = (const bf16*)p.k + b * p.k_sb + h * D;
  const bf16* vb = (const bf16*)p.v + b * p.v_sb + h * D;
  auto key_of = [&](int r) {
    return visit_key<C::LT, C::U>(lst, uniform, x, r);
  };
  load_tile<D>(smem + L::K, C::U, tid, [&](int r) {
    const int j = key_of(r);
    return j >= 0 && j < p.Lk ? kb + (long long)j * p.k_sl : nullptr;
  });
  load_tile<D>(smem + L::V, C::U, tid, [&](int r) {
    const int j = key_of(r);
    return j >= 0 && j < p.Lk ? vb + (long long)j * p.v_sl : nullptr;
  });
  fence_async();
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  // the mask of this thread's two keys (rows g and g + 8 of its warp's 16)
  const unsigned char* vld = p.valid + (long long)b * p.Lk;
  float kbias[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
    kbias[hr] = key_ok(key_of(warp * 16 + (lane >> 2) + 8 * hr), p.Lk,
                       uniform, vld)
                    ? 0.f
                    : neg_inf();
  const float inv_pad = 1.f / (float)p.lk_pad;
  const uint32_t k_base = smem_u32(smem + L::K), v_base = smem_u32(smem + L::V);
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  float sc[BQ / 2], dp[BQ / 2];
  uint32_t pa[BQ / 16][4], da[BQ / 16][4];

  for (int t = 0; t < nq; ++t) {
    const int s = t % KS;
    mbar_wait(&full[s], (t / KS) & 1);
    fence_async();
    const uint32_t q_base = smem_u32(smem + L::STAGE + s * 2 * C::QT);
    const uint32_t o_base = q_base + C::QT;
    const float* sL = reinterpret_cast<const float*>(smem + L::STATS) +
                      s * 2 * BQ;
    const float* sD = sL + BQ;
    // S^T = K Q^T, then dP^T = V dO^T, in two commit groups
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ>(sc, S::kmajor(k_base, kk, C::U), S::kmajor(q_base, kk, BQ),
                   kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ>(dp, S::kmajor(v_base, kk, C::U), S::kmajor(o_base, kk, BQ),
                   kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs<BQ / 2>(sc);
    // P^T on the accumulator (sc[4 i + 2 hr + e]: key g + 8 hr, query 8 i
    // + 2 quad + e) while dP^T runs
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      const float2 l2 = *reinterpret_cast<const float2*>(sL + 8 * i + 2 * quad);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        sc[4 * i + 2 * hr] = prob(sc[4 * i + 2 * hr], kbias[hr], l2.x,
                                  uniform, p.scale_log2, inv_pad);
        sc[4 * i + 2 * hr + 1] = prob(sc[4 * i + 2 * hr + 1], kbias[hr], l2.y,
                                      uniform, p.scale_log2, inv_pad);
      }
    }
    wgmma_wait<0>();
    fence_regs<BQ / 2>(dp);
    // dS^T = P^T (dP^T - di) scale
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      const float2 d2 = *reinterpret_cast<const float2*>(sD + 8 * i + 2 * quad);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float* d = dp + 4 * i + 2 * hr;
        const float* pp = sc + 4 * i + 2 * hr;
        d[0] = pp[0] * (d[0] - d2.x) * p.scale;
        d[1] = pp[1] * (d[1] - d2.y) * p.scale;
      }
    }
    // dV += P^T dO, dK += dS^T Q: P^T and dS^T rounded to bf16
    pack_a<BQ>(sc, pa);
    pack_a<BQ>(dp, da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<D>(dv, pa[kk], S::mnmajor(o_base, kk, BQ));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<D>(dk, da[kk], S::mnmajor(q_base, kk, BQ));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(dv);
    fence_regs<D / 2>(dk);
    fence_regs_u<BQ / 4>(&pa[0][0]);
    fence_regs_u<BQ / 4>(&da[0][0]);
    mbar_arrive(&empty[s]);
  }

  // dk[4 i + 2 hr + e]: key (16 warp + g + 8 hr), lane 8 i + 2 quad + e
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = key_of(warp * 16 + (lane >> 2) + 8 * hr);
    if (key < 0 || key >= p.Lk) continue;
    const long long off = ((long long)b * p.Lk + key) * p.H * D + h * D +
                          2 * quad;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<uint32_t*>((bf16*)p.dk + off + 8 * i) =
          pack_bf16(dk[4 * i + 2 * hr], dk[4 * i + 2 * hr + 1]);
      *reinterpret_cast<uint32_t*>((bf16*)p.dv + off + 8 * i) =
          pack_bf16(dv[4 * i + 2 * hr], dv[4 * i + 2 * hr + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(BfCfg<D>::NWG * 128 + 128, 1)
    flash_bwd_dq_bf16_kernel(const BwdParams p) {
  using C = BfCfg<D>;
  using L = DqLayout<D>;
  using S = Sw<D>;
  constexpr int NWG = C::NWG, QS = C::QS, U = C::U;
  extern __shared__ __align__(1024) unsigned char bdq_smem_raw[];
  unsigned char* smem = aligned_smem(bdq_smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + QS;

  const int tid = threadIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * (64 * NWG);
  const int* lst = p.list + (long long)b * (1 + p.tiles);
  const bool uniform = lst[0] == 0;  // no valid key: every tile
  const int visits = visit_count<C::LT, U>(lst, uniform, p.Lk);
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < QS; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NWG * 128) {
    // ---- producer warps: per visit, K and V with the keys' mask
    const int pt = tid - NWG * 128;
    const bf16* kb = (const bf16*)p.k + b * p.k_sb + h * D;
    const bf16* vb = (const bf16*)p.v + b * p.v_sb + h * D;
    const unsigned char* vld = p.valid + (long long)b * p.Lk;
    for (int t = 0; t < visits; ++t) {
      const int s = t % QS;
      if (t >= QS) mbar_wait(&empty[s], ((t / QS) - 1) & 1);
      unsigned char* sk = smem + L::STAGE + s * 2 * C::KT;
      load_tile<D>(sk, U, pt, [&](int r) -> const bf16* {
        const int j = visit_key<C::LT, U>(lst, uniform, t, r);
        return j >= 0 && j < p.Lk ? kb + (long long)j * p.k_sl : nullptr;
      });
      load_tile<D>(sk + C::KT, U, pt, [&](int r) -> const bf16* {
        const int j = visit_key<C::LT, U>(lst, uniform, t, r);
        return j >= 0 && j < p.Lk ? vb + (long long)j * p.v_sl : nullptr;
      });
      float* sB = reinterpret_cast<float*>(smem + L::BIAS) + s * U;
      for (int i = pt; i < U; i += 128)
        sB[i] = key_ok(visit_key<C::LT, U>(lst, uniform, t, i), p.Lk, uniform,
                       vld)
                    ? 0.f
                    : neg_inf();
      fence_async();
      mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63
  const int wg = tid >> 7, tw = tid & 127, warp = tw >> 5, lane = tid & 31;
  const int quad = lane & 3;
  const int qw = q0 + wg * 64;
  const long long o_sl = (long long)p.H * D;
  unsigned char* sQ = smem + L::Q + wg * 2 * C::KT;
  const bf16* qb = (const bf16*)p.q + b * p.q_sb + h * D;
  const bf16* ob = (const bf16*)p.dout + (long long)b * p.Lq * o_sl + h * D;
  load_tile<D>(sQ, 64, tw, [&](int r) {
    return qw + r < p.Lq ? qb + (long long)(qw + r) * p.q_sl : nullptr;
  });
  load_tile<D>(sQ + C::KT, 64, tw, [&](int r) {
    return qw + r < p.Lq ? ob + (long long)(qw + r) * o_sl : nullptr;
  });
  fence_async();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  // this thread's two query rows (g and g + 8 of its warp's 16)
  const int r0 = qw + warp * 16 + (lane >> 2);
  float lq[2], di[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = r0 + 8 * hr;
    const long long at = ((long long)b * p.H + h) * p.Lq + qi;
    lq[hr] = qi < p.Lq ? p.lse[at] * LOG2E : pos_inf();
    di[hr] = qi < p.Lq ? p.di[at] : 0.f;
  }
  const float inv_pad = 1.f / (float)p.lk_pad;
  const uint32_t q_base = smem_u32(sQ), o_base = q_base + C::KT;
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float sc[U / 2], dp[U / 2];
  uint32_t da[U / 16][4];

  for (int t = 0; t < visits; ++t) {
    const int s = t % QS;
    mbar_wait(&full[s], (t / QS) & 1);
    fence_async();
    const uint32_t k_base = smem_u32(smem + L::STAGE + s * 2 * C::KT);
    const uint32_t v_base = k_base + C::KT;
    const float* sB = reinterpret_cast<const float*>(smem + L::BIAS) + s * U;
    // S = Q K^T, then dP = dO V^T, in two commit groups
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<U>(sc, S::kmajor(q_base, kk, 64), S::kmajor(k_base, kk, U),
                  kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<U>(dp, S::kmajor(o_base, kk, 64), S::kmajor(v_base, kk, U),
                  kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs<U / 2>(sc);
    // P on the accumulator (sc[4 i + 2 hr + e]: row g + 8 hr, key 8 i + 2
    // quad + e) while dP runs
#pragma unroll
    for (int i = 0; i < U / 8; ++i) {
      const float2 b2 = *reinterpret_cast<const float2*>(sB + 8 * i + 2 * quad);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        sc[4 * i + 2 * hr] = prob(sc[4 * i + 2 * hr], b2.x, lq[hr], uniform,
                                  p.scale_log2, inv_pad);
        sc[4 * i + 2 * hr + 1] = prob(sc[4 * i + 2 * hr + 1], b2.y, lq[hr],
                                      uniform, p.scale_log2, inv_pad);
      }
    }
    wgmma_wait<0>();
    fence_regs<U / 2>(dp);
    // dS = P (dP - di) scale, rounded to bf16; dQ += dS K
#pragma unroll
    for (int i = 0; i < U / 8; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 4 * i + 2 * hr + e;
          dp[j] = sc[j] * (dp[j] - di[hr]) * p.scale;
        }
    pack_a<U>(dp, da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < U / 16; ++kk)
      wgmma_rs<D>(dq, da[kk], S::mnmajor(k_base, kk, U));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(dq);
    fence_regs_u<U / 4>(&da[0][0]);
    mbar_arrive(&empty[s]);
  }

  // dq[4 i + 2 hr + e]: row (16 warp + g + 8 hr), lane 8 i + 2 quad + e
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = r0 + 8 * hr;
    if (qi >= p.Lq) continue;
    bf16* row = (bf16*)p.dq + ((long long)b * p.Lq + qi) * o_sl + h * D +
                2 * quad;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(row + 8 * i) =
          pack_bf16(dq[4 * i + 2 * hr], dq[4 * i + 2 * hr + 1]);
  }
}

template <int D>
cudaError_t launch_dkv(const BwdParams& p, int B, cudaStream_t s) {
  using L = DkvLayout<D>;
  static bool opted = false;  // the shared-memory opt-in, once
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_bf16_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  flash_bwd_dkv_bf16_kernel<D><<<
      dim3(max_visits<BfCfg<D>::LT, BfCfg<D>::U>(p.Lk), p.H, B), 256,
      L::BYTES, s>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const BwdParams& p, int B, cudaStream_t s) {
  using C = BfCfg<D>;
  using L = DqLayout<D>;
  static bool opted = false;
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_bf16_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  flash_bwd_dq_bf16_kernel<D><<<dim3(cdiv(p.Lq, 64 * C::NWG), p.H, B),
                                 C::NWG * 128 + 128, L::BYTES, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16, heads of D = 32, 64 or 128. q/k/v: element (b, i, h, d) at b * sb +
// i * sl + h * D + d (rows and batch strides 16-byte aligned); valid: bool
// [B, Lk]; list: the bf16 forward's tile list, int32 [B, 1 + ceil(Lk /
// LT)] (LT = 64 at D = 128, else 128); lse: the forward's [B, H, Lq] fp32;
// dout: [B, Lq, H, D] bf16 contiguous; di: [B, H, Lq] fp32; dk, dv: [B, Lk,
// H, D] bf16 contiguous out, zeroed by the caller (the unlisted tiles'
// gradients are 0 and not written).
int gvf_flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* valid,
    const void* list, const void* lse, const void* dout, const void* di,
    void* dk, void* dv, int B, int Lq, int Lk, int H, int D, long long q_sb,
    long long q_sl, long long k_sb, long long k_sl, long long v_sb,
    long long v_sl, float scale, int lk_pad, void* stream) {
  if (bad_shape(B, Lq, Lk, H, D, lk_pad)) return (int)cudaErrorInvalidValue;
  if (misaligned(q, k, v, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, 8))
    return (int)cudaErrorMisalignedAddress;
  BwdParams p = make_params(q, k, v, valid, list, lse, dout, di, Lq, Lk, H,
                            q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale, lk_pad,
                            D == 128 ? 64 : 128);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 32) return (int)launch_dkv<32>(p, B, s);
  if (D == 64) return (int)launch_dkv<64>(p, B, s);
  return (int)launch_dkv<128>(p, B, s);
}

// the same inputs; dq: [B, Lq, H, D] bf16 contiguous out
int gvf_flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* valid,
    const void* list, const void* lse, const void* dout, const void* di,
    void* dq, int B, int Lq, int Lk, int H, int D, long long q_sb,
    long long q_sl, long long k_sb, long long k_sl, long long v_sb,
    long long v_sl, float scale, int lk_pad, void* stream) {
  if (bad_shape(B, Lq, Lk, H, D, lk_pad)) return (int)cudaErrorInvalidValue;
  if (misaligned(q, k, v, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, 8))
    return (int)cudaErrorMisalignedAddress;
  BwdParams p = make_params(q, k, v, valid, list, lse, dout, di, Lq, Lk, H,
                            q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale, lk_pad,
                            D == 128 ? 64 : 128);
  p.dq = dq;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 32) return (int)launch_dq<32>(p, B, s);
  if (D == 64) return (int)launch_dq<64>(p, B, s);
  return (int)launch_dq<128>(p, B, s);
}

}  // extern "C"
