// K7's backward for Hopper (sm_90a): the gradient of flash_attention.cu's
// fp32 streaming attention over key validity, at heads of 64, which the
// static VAE's `full` attention mode trains through ([2, 32768, 12, 64]
// fp32, about 10-20 thousand valid voxel slots of 32768).
//
// Replaces the stock Pallas TPU flash attention's two backward kernels that
// gvfdiffusion_tpu/sparse/attention.py:57 `_flash_full_attention`
// differentiates through (jax/experimental/pallas/ops/tpu/flash_attention.py:
// `_flash_attention_bwd_dkv` -> `_flash_attention_dkv_kernel`, and
// `_flash_attention_bwd_dq` -> `_flash_attention_dq_kernel`), kept as two
// kernels: dkv writes dK and dV, dq writes dQ, no atomics, deterministic.
// Their arithmetic, kept here: the scores s = q . k * scale plus -0.7 *
// FLT_MAX on an invalid key (every query row is in the valid keys'
// segment), the probabilities P = exp(s - m) / l from the forward's
// statistics (here one fp32 logsumexp per row, lse = m + log l: P = exp(s -
// lse), taken as exp2(s * scale * log2 e - lse * log2 e), an invalid key's
// mask as -inf, whose exp2 is the TPU's 0), di = rowsum(o * dO) (plain torch
// in the wrapper, as JAX computes it outside the kernels), dS = P * (dO . v -
// di) * scale, and
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K.
// Every query row is computed, valid or not. A batch row with no valid key
// has, on the TPU, every score equal to the mask value, so P = 1 / lk_pad on
// every key of the key count padded to 512; the kernels take that row's P
// as 1 / lk_pad directly (its lse cannot carry it: mask + log(lk_pad) rounds
// to the mask value). Keys past Lk (the TPU's zero padding) add nothing to
// dQ and their dK / dV are dropped.
//
// Both kernels visit the 64-key tiles that the forward listed (its fp32
// list: the tiles that hold a valid key), which is exact while the batch row
// has a valid key: there P = exp(mask - lse) is 0 in fp32, so an unlisted
// tile adds nothing to dQ, and its own dK and dV are 0 (the wrapper zeroes
// them). A row with no valid key lists no tile and visits every tile.
//
// Design: every product on the tensor cores by the 3xTF32 split
// (attention_sm90.cuh: x = hi + lo, a . b = lo . hi' + hi . lo' + hi . hi'
// with wgmma m64nNk8 .tf32, about fp32's precision), each operand split once
// as it lands in shared memory. tf32 wgmma reads its shared-memory operands
// K-major only, so each tile is stored in the orientation its product
// reads: [row][d] where d is the sum's index, [d][row] (transposed) where the
// rows are; in a transposed tile the rows of each group of 8 are permuted
// (row 2 t at k-column t, 2 t + 1 at t + 4: key_col) so that a score
// accumulator's registers are, as they stand, the register A operand of the
// product that sums over those rows (attention_sm90_tf32.cuh's P V). Tiles
// are [64][64] fp32 (16 KB, hi and lo 32 KB) in wgmma's 128-byte swizzle.
//   dkv: one CTA per (listed 64-key tile, head, batch row): one consumer
//   warpgroup holds K and V (hi / lo, 64 KB, split by itself once) and
//   loops over every 64-query tile: S^T = K Q^T and dP^T = V dO^T
//   (m64n64k8, both operands in shared memory), P^T and dS^T on the
//   accumulators, then dV += P^T dO and dK += dS^T Q with P^T and dS^T as
//   the register A operand, against dO^T and Q^T: four chains (two sums,
//   two halves of the tile's 32 query rows), two in flight, each operand
//   split while the chain before it runs. Four producer warps load
//   each query tile's Q and dO once into registers and write two buffers:
//   A (Q and dO as they stand, with the tile's lse * log2 e and di), which
//   the consumers free once P^T and dS^T are formed, and B (Q^T and dO^T),
//   freed after dV and dK: the producers fill A while the consumers run dV
//   and dK, and B while they run S^T and dP^T. 192 KB of shared memory.
//   dq: one CTA per 128-query tile: two consumer warpgroups of 64 query
//   rows each hold Q and dO (hi / lo, 64 KB each) and loop over the listed
//   key tiles: S = Q K^T and dP = dO V^T, dS on the accumulators, then dQ
//   += dS K against K^T. The producers write buffer A (K and V, the tile's
//   key mask) and buffer B (K^T) the same way. 224 KB.
// Chain length: the tensor cores' fp32 accumulation, over a long chain of
// products, loses more than fp32 adds (K7's forward read 2.6e-5 against
// its plain version with its whole loop there): dV, dK (over 32768 query
// rows) and dQ (over the valid keys) are summed 32 rows or keys at a time
// (4 k-steps x 3 products) into a fresh accumulator, which is then added
// into fp32 registers; S and dP (over the head's 64 lanes) are one chain of
// 24, as in the forward.
//
// What bounds it on the H100: the gradient's five products, 10 B H Lq
// Nv D operations over the valid keys Nv; dkv recomputes S and dP (8 per
// B H Lq Nv D) and dq both again (6): at three tf32 products each, 24 and
// 18 B H Lq Nv D at 495 TFLOP/s (against 8 and 6 at 67 TFLOP/s of fp32
// FFMA). Under the tensor cores, shared memory: a m64n64k8 product with
// both operands there reads 4 KB for about 32 clocks of tensor work, near
// the SM's 128 bytes a clock, and the producers' split stores add to it;
// and the sums over rows, whose register A operand is split and fenced
// before each chain of 12 products.

#include "attention_sm90_tf32.cuh"

namespace {

using namespace gvf;
using namespace gvf::sm90;

constexpr int HD = 64;            // head width: the one form with a backward
constexpr int BT = 64;            // rows (keys or queries) of a tile
constexpr int TB = BT * HD * 4;   // one [64][64] fp32 tile in bytes
using SW = Sw<2 * HD>;            // rows of 64 fp32 (or of 64 columns)

struct BwdParams {
  const float* q;
  const float* k;
  const float* v;
  const unsigned char* valid;  // [B, Lk]
  const int* list;             // [B][1 + tiles]: count, listed 64-key tiles
  const float* lse;            // [B, H, Lq] the forward's row logsumexp
  const float* dout;           // [B, Lq, H, D] contiguous
  const float* di;             // [B, H, Lq] rowsum(o * dO)
  float* dq;                   // [B, Lq, H, D] contiguous
  float* dk;                   // [B, Lk, H, D] contiguous
  float* dv;                   // [B, Lk, H, D] contiguous
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;  // in floats
  int Lq, Lk, H, tiles, lk_pad;
  float scale, scale_log2;
};

__device__ __forceinline__ float pos_inf() {
  return __int_as_float(0x7f800000);
}

// 64 rows of 64 fp32 of one head into registers, for split_store: 128
// threads, a warp on 32 consecutive rows (a lane a row) and one 128-byte
// half of them (8 chunks of 4 floats); rows at or past n read as 0
struct Rows {
  float4 a[8];
};
__device__ __forceinline__ void load_rows(const float* src, long long sl,
                                          int n, int t128, Rows& x) {
  const int w = t128 >> 5, r = (w & 1) * 32 + (t128 & 31);
  const float* row = src + (long long)(r < n ? r : 0) * sl + (w >> 1) * 32;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    x.a[i] = r < n ? *reinterpret_cast<const float4*>(row + 4 * i)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
}

// split_tf32 of four values
__device__ __forceinline__ void split4(const float4& a, uint4& hi, uint4& lo) {
  split_tf32(a.x, hi.x, lo.x);
  split_tf32(a.y, hi.y, lo.y);
  split_tf32(a.z, hi.z, lo.z);
  split_tf32(a.w, hi.w, lo.w);
}

// The rows split into tf32 hi / lo: as they stand ([row][d], hi at dst, lo
// at dst + TB; a warp's 16-byte stores, 8 rows a 128-byte phase, are free
// of bank conflicts under the swizzle), or transposed ([d][row'] with row r
// at column (r & ~7) + key_col(r & 7); each 4-byte store fills one row's
// 32 banks)
template <bool T>
__device__ __forceinline__ void split_store(const Rows& x, unsigned char* dst,
                                            int t128) {
  const int w = t128 >> 5, r = (w & 1) * 32 + (t128 & 31);
  const int col = (r & ~7) + key_col(r & 7);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = (w >> 1) * 8 + i;  // the chunk: lanes 4 c .. 4 c + 3
    uint4 hi, lo;
    split4(x.a[i], hi, lo);
    if (!T) {
      const int o = SW::off(r, c, BT);
      *reinterpret_cast<uint4*>(dst + o) = hi;
      *reinterpret_cast<uint4*>(dst + TB + o) = lo;
    } else {
      const uint32_t h4[4] = {hi.x, hi.y, hi.z, hi.w};
      const uint32_t l4[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = SW::off(4 * c + e, col >> 2, BT) + (col & 3) * 4;
        *reinterpret_cast<uint32_t*>(dst + o) = h4[e];
        *reinterpret_cast<uint32_t*>(dst + TB + o) = l4[e];
      }
    }
  }
}

// acc (+)= A B^T over the 64 lanes of a head, both [64][64] K-major tiles
// (hi at a / b, lo TB after): 8 k-steps x 3 products
__device__ __forceinline__ void product_ss(float* acc, uint32_t a,
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    wgmma_tf32_ss<64>(acc, SW::kmajor(a + TB, kk, BT), SW::kmajor(b, kk, BT),
                      kk > 0);
    wgmma_tf32_ss<64>(acc, SW::kmajor(a, kk, BT), SW::kmajor(b + TB, kk, BT),
                      1);
    wgmma_tf32_ss<64>(acc, SW::kmajor(a, kk, BT), SW::kmajor(b, kk, BT), 1);
  }
}

// One chain of a product that sums over 32 rows (half `half` of a tile's
// 64): out += X Y, X from a score accumulator x (x[4 i + 2 hr + e]: row g +
// 8 hr, column 8 i + 2 quad + e) as the register A operand, Y a transposed
// [64][64] tile (hi at y, lo TB after) whose k-columns carry key_col's
// permutation; the chain's 12 products go to a fresh accumulator `part`,
// added into out in fp32. split_chain forms the operand, issue_chain
// issues the products as one commit group (no wait), settle_chain adds the
// accumulator once the group has completed.
struct Chain {
  uint32_t h[4][4], l[4][4];  // X's tf32 hi / lo, 4 k-steps
  float part[32];
};

__device__ __forceinline__ void split_chain(const float* x, int half,
                                            Chain& c) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = half * 4 + j;
    split_tf32(x[4 * i + 0], c.h[j][0], c.l[j][0]);
    split_tf32(x[4 * i + 2], c.h[j][1], c.l[j][1]);
    split_tf32(x[4 * i + 1], c.h[j][2], c.l[j][2]);
    split_tf32(x[4 * i + 3], c.h[j][3], c.l[j][3]);
  }
}

__device__ __forceinline__ void issue_chain(Chain& c, uint32_t y, int half) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kk = half * 4 + j;
    wgmma_tf32_rs<64>(c.part, c.l[j], SW::kmajor(y, kk, BT), j > 0);
    wgmma_tf32_rs<64>(c.part, c.h[j], SW::kmajor(y + TB, kk, BT), 1);
    wgmma_tf32_rs<64>(c.part, c.h[j], SW::kmajor(y, kk, BT), 1);
  }
  wgmma_commit();
}

__device__ __forceinline__ void settle_chain(float* out, Chain& c) {
  fence_regs<32>(c.part);
  fence_regs_u<16>(&c.h[0][0]);
  fence_regs_u<16>(&c.l[0][0]);
#pragma unroll
  for (int i = 0; i < 32; ++i) out[i] += c.part[i];
}

// out += X Y over half `half` of the tile, waiting for it
__device__ __forceinline__ void product_rs(float* out, const float* x,
                                           uint32_t y, int half) {
  Chain c;
  split_chain(x, half, c);
  issue_chain(c, y, half);
  wgmma_wait<0>();
  settle_chain(out, c);
}

// P from a score: exp2(s * scale log2 e + bias - lse log2 e) (bias 0, or
// -inf on an invalid key or one past Lk; lse log2 e +inf on a query row
// past Lq); in a batch row with no valid key 1 / lk_pad on every key below
// Lk and query row below Lq
__device__ __forceinline__ float prob(float s, float bias, float lq,
                                      bool uniform, float scale_log2,
                                      float inv_pad) {
  if (uniform) return bias == 0.f && lq != pos_inf() ? inv_pad : 0.f;
  return exp2f(fmaf(s, scale_log2, bias) - lq);
}

// dkv's shared memory, from a 1024-byte aligned base: K, V (hi / lo each);
// buffer A: Q, dO, then the query tile's lse * log2 e and di [2][64]; buffer
// B: Q^T, dO^T; the full / empty mbarriers of A and B
struct DkvSmem {
  static constexpr int K = 0, V = 2 * TB;
  static constexpr int Q = 4 * TB, DO = 6 * TB;
  static constexpr int QT = 8 * TB, DOT = 10 * TB;
  static constexpr int STATS = 12 * TB;
  static constexpr int BAR = STATS + 2 * BT * 4;
  static constexpr int BYTES = BAR + 4 * 8 + 1024;  // + alignment
};

// dq's: per consumer warpgroup Q, dO (hi / lo each); buffer A: K, V, the key
// tile's bias row [64]; buffer B: K^T; the mbarriers
struct DqSmem {
  static constexpr int NWG = 2;
  static constexpr int QW = 0;  // warpgroup w's Q at 4 TB w, dO 2 TB after
  static constexpr int K = NWG * 4 * TB, V = K + 2 * TB;
  static constexpr int KT = V + 2 * TB;
  static constexpr int BIAS = KT + 2 * TB;
  static constexpr int BAR = BIAS + BT * 4;
  static constexpr int BYTES = BAR + 4 * 8 + 1024;
};

enum { FULL_A = 0, EMPTY_A = 1, FULL_B = 2, EMPTY_B = 3 };

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

__device__ __forceinline__ void init_bars(uint64_t* bar, unsigned producers,
                                          unsigned consumers) {
  if (threadIdx.x == 0) {
    mbar_init(&bar[FULL_A], producers);
    mbar_init(&bar[EMPTY_A], consumers);
    mbar_init(&bar[FULL_B], producers);
    mbar_init(&bar[EMPTY_B], consumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

__global__ void __launch_bounds__(256, 1) flash_bwd_dkv_tf32_kernel(
    const BwdParams p) {
  using S = DkvSmem;
  extern __shared__ __align__(1024) unsigned char dkv_smem_raw[];
  unsigned char* smem = aligned_smem(dkv_smem_raw);
  float* sL = reinterpret_cast<float*>(smem + S::STATS);
  float* sD = sL + BT;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + S::BAR);

  const int tid = threadIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int* lst = p.list + (long long)b * (1 + p.tiles);
  const int listed = lst[0];
  const bool uniform = listed == 0;  // no valid key: every tile
  if ((int)blockIdx.x >= (uniform ? p.tiles : listed)) return;
  const int j0 = (uniform ? (int)blockIdx.x : lst[1 + blockIdx.x]) * BT;
  const int nq = (p.Lq + BT - 1) / BT;
  init_bars(bar, 128, 128);

  if (tid >= 128) {
    // ---- producer warps: per query tile, Q and dO into buffer A as they
    // stand (with lse * log2 e and di), then transposed into buffer B
    const int pt = tid - 128;
    const float* qb = p.q + b * p.q_sb + h * HD;
    const long long o_sl = (long long)p.H * HD;
    const float* ob = p.dout + (long long)b * p.Lq * o_sl + h * HD;
    const float* lse_b = p.lse + ((long long)b * p.H + h) * p.Lq;
    const float* di_b = p.di + ((long long)b * p.H + h) * p.Lq;
    Rows xq, xo;
    for (int t = 0; t < nq; ++t) {
      const int q0 = t * BT;
      load_rows(qb + (long long)q0 * p.q_sl, p.q_sl, p.Lq - q0, pt, xq);
      load_rows(ob + (long long)q0 * o_sl, o_sl, p.Lq - q0, pt, xo);
      float lq = pos_inf(), dd = 0.f;
      if (pt < BT && q0 + pt < p.Lq) {
        lq = lse_b[q0 + pt] * LOG2E;
        dd = di_b[q0 + pt];
      }
      if (t > 0) mbar_wait(&bar[EMPTY_A], (t - 1) & 1);
      split_store<false>(xq, smem + S::Q, pt);
      split_store<false>(xo, smem + S::DO, pt);
      if (pt < BT) {
        sL[pt] = lq;
        sD[pt] = dd;
      }
      fence_async();
      mbar_arrive(&bar[FULL_A]);
      if (t > 0) mbar_wait(&bar[EMPTY_B], (t - 1) & 1);
      split_store<true>(xq, smem + S::QT, pt);
      split_store<true>(xo, smem + S::DOT, pt);
      fence_async();
      mbar_arrive(&bar[FULL_B]);
    }
    return;
  }

  // ---- the consumer warpgroup: keys j0 .. j0 + 63
  const int warp = tid >> 5, lane = tid & 31, quad = lane & 3;
  {
    Rows x;
    load_rows(p.k + b * p.k_sb + (long long)j0 * p.k_sl + h * HD, p.k_sl,
              p.Lk - j0, tid, x);
    split_store<false>(x, smem + S::K, tid);
    load_rows(p.v + b * p.v_sb + (long long)j0 * p.v_sl + h * HD, p.v_sl,
              p.Lk - j0, tid, x);
    split_store<false>(x, smem + S::V, tid);
    fence_async();
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  }
  // the mask of this thread's two keys (rows g and g + 8 of its warp's 16)
  const unsigned char* vld = p.valid + (long long)b * p.Lk;
  float kb[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = j0 + warp * 16 + (lane >> 2) + 8 * hr;
    kb[hr] = key < p.Lk && (uniform || vld[key]) ? 0.f : neg_inf();
  }
  const float inv_pad = 1.f / (float)p.lk_pad;
  const uint32_t base = smem_u32(smem);
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  float sc[32], dp[32];

  for (int t = 0; t < nq; ++t) {
    mbar_wait(&bar[FULL_A], t & 1);
    fence_async();
    // S^T = K Q^T, then dP^T = V dO^T, in two commit groups
    wgmma_fence();
    product_ss(sc, base + S::K, base + S::Q);
    wgmma_commit();
    product_ss(dp, base + S::V, base + S::DO);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs<32>(sc);
    // P^T on the accumulator (sc[4 i + 2 hr + e]: key g + 8 hr, query 8 i
    // + 2 quad + e) while dP^T runs
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 l2 = *reinterpret_cast<const float2*>(sL + 8 * i + 2 * quad);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        sc[4 * i + 2 * hr] = prob(sc[4 * i + 2 * hr], kb[hr], l2.x, uniform,
                                  p.scale_log2, inv_pad);
        sc[4 * i + 2 * hr + 1] = prob(sc[4 * i + 2 * hr + 1], kb[hr], l2.y,
                                      uniform, p.scale_log2, inv_pad);
      }
    }
    wgmma_wait<0>();
    fence_regs<32>(dp);
    // dS^T = P^T (dP^T - di) scale
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 d2 = *reinterpret_cast<const float2*>(sD + 8 * i + 2 * quad);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float* d = dp + 4 * i + 2 * hr;
        const float* s = sc + 4 * i + 2 * hr;
        d[0] = s[0] * (d[0] - d2.x) * p.scale;
        d[1] = s[1] * (d[1] - d2.y) * p.scale;
      }
    }
    mbar_arrive(&bar[EMPTY_A]);
    mbar_wait(&bar[FULL_B], t & 1);
    fence_async();
    // dV += P^T dO, dK += dS^T Q, 32 query rows a chain: four chains, two
    // in flight, each operand split while the one before runs
    {
      Chain cv, ck;
      split_chain(sc, 0, cv);
      issue_chain(cv, base + S::DOT, 0);
      split_chain(dp, 0, ck);
      issue_chain(ck, base + S::QT, 0);
      wgmma_wait<1>();
      settle_chain(dv, cv);
      split_chain(sc, 1, cv);
      issue_chain(cv, base + S::DOT, 1);
      wgmma_wait<1>();
      settle_chain(dk, ck);
      split_chain(dp, 1, ck);
      issue_chain(ck, base + S::QT, 1);
      wgmma_wait<1>();
      settle_chain(dv, cv);
      wgmma_wait<0>();
      settle_chain(dk, ck);
    }
    mbar_arrive(&bar[EMPTY_B]);
  }

  // dk[4 i + 2 hr + e]: key (16 warp + g + 8 hr), lane 8 i + 2 quad + e
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = j0 + warp * 16 + (lane >> 2) + 8 * hr;
    if (key >= p.Lk) continue;
    const long long off = ((long long)b * p.Lk + key) * p.H * HD + h * HD +
                          2 * quad;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      *reinterpret_cast<float2*>(p.dk + off + 8 * i) =
          make_float2(dk[4 * i + 2 * hr], dk[4 * i + 2 * hr + 1]);
      *reinterpret_cast<float2*>(p.dv + off + 8 * i) =
          make_float2(dv[4 * i + 2 * hr], dv[4 * i + 2 * hr + 1]);
    }
  }
}

__global__ void __launch_bounds__(DqSmem::NWG * 128 + 128, 1)
    flash_bwd_dq_tf32_kernel(const BwdParams p) {
  using S = DqSmem;
  constexpr int NWG = S::NWG;
  extern __shared__ __align__(1024) unsigned char dq_smem_raw[];
  unsigned char* smem = aligned_smem(dq_smem_raw);
  float* sB = reinterpret_cast<float*>(smem + S::BIAS);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + S::BAR);

  const int tid = threadIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * (64 * NWG);
  const int* lst = p.list + (long long)b * (1 + p.tiles);
  const bool uniform = lst[0] == 0;  // no valid key: every tile
  const int visits = uniform ? p.tiles : lst[0];
  init_bars(bar, 128, NWG * 128);

  if (tid >= NWG * 128) {
    // ---- producer warps: per listed key tile, K and V into buffer A as
    // they stand (with the tile's bias row), then K transposed into B
    const int pt = tid - NWG * 128;
    const float* kb = p.k + b * p.k_sb + h * HD;
    const float* vb = p.v + b * p.v_sb + h * HD;
    const unsigned char* vld = p.valid + (long long)b * p.Lk;
    Rows xk, xv;
    for (int t = 0; t < visits; ++t) {
      const int j0 = (uniform ? t : lst[1 + t]) * BT;
      load_rows(kb + (long long)j0 * p.k_sl, p.k_sl, p.Lk - j0, pt, xk);
      load_rows(vb + (long long)j0 * p.v_sl, p.v_sl, p.Lk - j0, pt, xv);
      float bias = 0.f;
      if (pt < BT) {
        const int j = j0 + pt;
        bias = j < p.Lk && (uniform || vld[j]) ? 0.f : neg_inf();
      }
      if (t > 0) mbar_wait(&bar[EMPTY_A], (t - 1) & 1);
      split_store<false>(xk, smem + S::K, pt);
      split_store<false>(xv, smem + S::V, pt);
      if (pt < BT) sB[pt] = bias;
      fence_async();
      mbar_arrive(&bar[FULL_A]);
      if (t > 0) mbar_wait(&bar[EMPTY_B], (t - 1) & 1);
      split_store<true>(xk, smem + S::KT, pt);
      fence_async();
      mbar_arrive(&bar[FULL_B]);
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63
  const int wg = tid >> 7, tw = tid & 127, warp = tw >> 5, lane = tid & 31;
  const int quad = lane & 3;
  const int qw = q0 + wg * 64;
  const long long o_sl = (long long)p.H * HD;
  unsigned char* sQ = smem + S::QW + wg * 4 * TB;
  {
    Rows x;
    load_rows(p.q + b * p.q_sb + (long long)qw * p.q_sl + h * HD, p.q_sl,
              p.Lq - qw, tw, x);
    split_store<false>(x, sQ, tw);
    load_rows(p.dout + ((long long)b * p.Lq + qw) * o_sl + h * HD, o_sl,
              p.Lq - qw, tw, x);
    split_store<false>(x, sQ + 2 * TB, tw);
    fence_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  }
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
  const uint32_t qhi = smem_u32(sQ), base = smem_u32(smem);
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  float sc[32], dp[32];

  for (int t = 0; t < visits; ++t) {
    mbar_wait(&bar[FULL_A], t & 1);
    fence_async();
    // S = Q K^T, then dP = dO V^T, in two commit groups
    wgmma_fence();
    product_ss(sc, qhi, base + S::K);
    wgmma_commit();
    product_ss(dp, qhi + 2 * TB, base + S::V);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs<32>(sc);
    // P on the accumulator (sc[4 i + 2 hr + e]: row g + 8 hr, key 8 i + 2
    // quad + e) while dP runs
#pragma unroll
    for (int i = 0; i < 8; ++i) {
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
    fence_regs<32>(dp);
    mbar_arrive(&bar[EMPTY_A]);
    // dS = P (dP - di) scale
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * i + 2 * hr + e;
          dp[x] = sc[x] * (dp[x] - di[hr]) * p.scale;
        }
    mbar_wait(&bar[FULL_B], t & 1);
    fence_async();
    // dQ += dS K, 32 keys a chain
    product_rs(dq, dp, base + S::KT, 0);
    product_rs(dq, dp, base + S::KT, 1);
    mbar_arrive(&bar[EMPTY_B]);
  }

  // dq[4 i + 2 hr + e]: row (16 warp + g + 8 hr), lane 8 i + 2 quad + e
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = r0 + 8 * hr;
    if (qi >= p.Lq) continue;
    float* row = p.dq + ((long long)b * p.Lq + qi) * o_sl + h * HD + 2 * quad;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float2*>(row + 8 * i) =
          make_float2(dq[4 * i + 2 * hr], dq[4 * i + 2 * hr + 1]);
  }
}

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* valid, const void* list, const void* lse,
                      const void* dout, const void* di, int Lq, int Lk, int H,
                      long long q_sb, long long q_sl, long long k_sb,
                      long long k_sl, long long v_sb, long long v_sl,
                      float scale, int lk_pad) {
  BwdParams p;
  p.q = (const float*)q; p.k = (const float*)k; p.v = (const float*)v;
  p.valid = (const unsigned char*)valid; p.list = (const int*)list;
  p.lse = (const float*)lse; p.dout = (const float*)dout;
  p.di = (const float*)di;
  p.dq = p.dk = p.dv = nullptr;
  p.q_sb = q_sb; p.q_sl = q_sl; p.k_sb = k_sb; p.k_sl = k_sl;
  p.v_sb = v_sb; p.v_sl = v_sl;
  p.Lq = Lq; p.Lk = Lk; p.H = H; p.tiles = (int)cdiv(Lk, BT);
  p.lk_pad = lk_pad; p.scale = scale; p.scale_log2 = scale * LOG2E;
  return p;
}

bool bad_shape(int B, int Lq, int Lk, int H, int D, int lk_pad) {
  return D != HD || B < 1 || B > 65535 || Lq < 1 || Lk < 1 || H < 1 ||
         H > 65535 || lk_pad < Lk;
}

bool misaligned(const void* q, const void* k, const void* v, long long q_sb,
                long long q_sl, long long k_sb, long long k_sl,
                long long v_sb, long long v_sl) {
  return (uintptr_t)q % 16 || (uintptr_t)k % 16 || (uintptr_t)v % 16 ||
         q_sb % 4 || q_sl % 4 || k_sb % 4 || k_sl % 4 || v_sb % 4 ||
         v_sl % 4;
}

}  // namespace

extern "C" {

// fp32, heads of 64. q/k/v: element (b, i, h, d) at b * sb + i * sl + h * 64
// + d (rows 16-byte aligned); valid: bool [B, Lk]; list: the forward's
// fp32 tile list, int32 [B, 1 + ceil(Lk / 64)] (per batch row the count of
// 64-key tiles that hold a valid key, then their indices); lse: the
// forward's [B, H, Lq]; dout: [B, Lq, H, 64] contiguous; di: [B, H, Lq];
// dk, dv: [B, Lk, H, 64] contiguous out, zeroed by the caller (the unlisted
// tiles' gradients are 0 and not written).
int gvf_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* valid,
    const void* list, const void* lse, const void* dout, const void* di,
    void* dk, void* dv, int B, int Lq, int Lk, int H, int D, long long q_sb,
    long long q_sl, long long k_sb, long long k_sl, long long v_sb,
    long long v_sl, float scale, int lk_pad, void* stream) {
  if (bad_shape(B, Lq, Lk, H, D, lk_pad)) return (int)cudaErrorInvalidValue;
  if (misaligned(q, k, v, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl))
    return (int)cudaErrorMisalignedAddress;
  BwdParams p = make_params(q, k, v, valid, list, lse, dout, di, Lq, Lk, H,
                            q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale, lk_pad);
  p.dk = (float*)dk;
  p.dv = (float*)dv;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DkvSmem::BYTES);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_tf32_kernel<<<dim3(p.tiles, H, B), 256, DkvSmem::BYTES,
                              (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// the same inputs; dq: [B, Lq, H, 64] contiguous out
int gvf_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* valid,
    const void* list, const void* lse, const void* dout, const void* di,
    void* dq, int B, int Lq, int Lk, int H, int D, long long q_sb,
    long long q_sl, long long k_sb, long long k_sl, long long v_sb,
    long long v_sl, float scale, int lk_pad, void* stream) {
  if (bad_shape(B, Lq, Lk, H, D, lk_pad)) return (int)cudaErrorInvalidValue;
  if (misaligned(q, k, v, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl))
    return (int)cudaErrorMisalignedAddress;
  BwdParams p = make_params(q, k, v, valid, list, lse, dout, di, Lq, Lk, H,
                            q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale, lk_pad);
  p.dq = (float*)dq;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DqSmem::BYTES);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_tf32_kernel<<<dim3(cdiv(Lq, 64 * DqSmem::NWG), H, B),
                             DqSmem::NWG * 128 + 128, DqSmem::BYTES,
                             (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
