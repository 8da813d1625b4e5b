// K7's backward for Hopper (sm_90a): the gradient of flash_attention.cu's
// fp32 streaming attention over key validity, at heads of 32, 64 and 128:
// the static VAE's `full` attention, [2, 32768, 12, 64] fp32 as
// configs/vae.yml builds it (about 10-20 thousand valid voxel slots of
// 32768), and at 24 heads of 32 or 6 of 128 (main_vae
// --static_vae.num_heads=24 / 6). The bf16 forms are
// flash_attention_bwd_bf16.cu's.
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
// Both kernels walk the key tiles that the fp32 forward listed (the tiles
// that hold a valid key: 64 keys, 32 at heads of 128), in visits of 64 keys
// for dkv (at heads of 128 two listed tiles a CTA) and of the listed tile
// for dq (flash_attention_bwd.cuh). That is exact while the batch row has a
// valid key: there P = exp(mask - lse) is 0 in fp32, so an unlisted tile
// adds nothing to dQ, and its own dK and dV are 0 (the wrapper zeroes
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
// are fp32 in wgmma's 128-byte swizzle.
//   dkv: one CTA per (visit of 64 keys, head, batch row): consumer
//   warpgroups hold K and V (hi / lo, split once) and loop over the query
//   tiles of BQ rows: S^T = K Q^T and dP^T = V dO^T (m64nBQk8, both operands
//   in shared memory), P^T and dS^T on the accumulators, then dV += P^T dO
//   and dK += dS^T Q with P^T and dS^T as the register A operand, against
//   dO^T and Q^T. Four producer warps load each query tile's Q and dO once
//   into registers and write two buffers: A (Q and dO as they stand, with
//   the tile's lse * log2 e and di), which the consumers free once P^T and
//   dS^T are formed, and B (Q^T and dO^T), freed after dV and dK.
//     heads of 32 and 64: BQ = 64, one consumer warpgroup, A and B apart
//     (the producers fill A while the consumers run dV and dK, and B while
//     they run S^T and dP^T): four chains (two sums, two halves of the
//     tile's 32 query rows), two in flight, each operand split while the
//     chain before it runs; 96 / 192 KB of shared memory.
//     heads of 128: K and V hi / lo take 128 KB, so BQ = 32 and B is
//     written over A once the consumers free A (192 KB); two consumer
//     warpgroups, each with 64 of the head's 128 lanes of dK and dV (both
//     compute S^T and dP^T: the registers of one warpgroup with all 128
//     lanes would pass 255 a thread), one chain at a time.
//   dq: one CTA per 64 NWG query rows: NWG consumer warpgroups of 64 query
//   rows each hold Q and dO (hi / lo) and loop over the visits: S = Q K^T
//   and dP = dO V^T, dS on the accumulators, then dQ += dS K against K^T.
//   The producers write buffer A (K and V, the visit's key mask) and
//   buffer B (K^T) the same way. Heads of 32 and 64: NWG = 2 and 64-key
//   visits (112 / 224 KB); heads of 128: NWG = 1 (Q and dO hi / lo 128 KB)
//   and 32-key visits (224 KB).
// Chain length: the tensor cores' fp32 accumulation, over a long chain of
// products, loses more than fp32 adds (K7's forward read 2.6e-5 against
// its plain version with its whole loop there): dV, dK (over 32768 query
// rows) and dQ (over the valid keys) are summed 32 rows or keys at a time
// (4 k-steps x 3 products) into a fresh accumulator, which is then added
// into fp32 registers; S and dP (over the head's lanes) are one chain, as
// in the forward.
//
// What bounds it on the H100: the gradient's five products, 10 B H Lq
// Nv D operations over the valid keys Nv; dkv recomputes S and dP (8 per
// B H Lq Nv D) and dq both again (6): at three tf32 products each, 24 and
// 18 B H Lq Nv D at 495 TFLOP/s (against 8 and 6 at 67 TFLOP/s of fp32
// FFMA); the same at every head width (H D = 768 in the VAE). Under the
// tensor cores, shared memory: a m64n64k8 product with both operands there
// reads 4 KB for about 32 clocks of tensor work, near the SM's 128 bytes a
// clock, and the producers' split stores add to it; and the sums over rows,
// whose register A operand is split and fenced before each chain of 12
// products.

#include "flash_attention_bwd.cuh"

namespace {

using namespace gvf;
using namespace gvf::fbwd;

template <int HD>
struct F32Cfg {
  static constexpr int LT = HD == 128 ? 32 : 64;  // the fp32 forward's tile
  static constexpr int BT = 64;                   // dkv: keys a CTA
  static constexpr int BQ = HD == 128 ? 32 : 64;  // dkv: query tile
  static constexpr int NS = HD == 128 ? 2 : 1;    // dkv: consumer warpgroups
  static constexpr bool ALIAS = HD == 128;        // dkv: B written over A
  static constexpr int BKV = LT;                  // dq: keys a visit
  static constexpr int NWG = HD == 128 ? 1 : 2;   // dq: consumer warpgroups
};

// R rows of W fp32 (one head's) into registers, for split_store: 128
// threads, a warp on 32 consecutive rows (a lane a row) and RG / 4 of each
// row's 16-byte chunks
template <int R, int W>
struct Rows {
  static constexpr int RG = R / 32;     // groups of 32 rows (1 or 2)
  static constexpr int NC = W / 4 / (4 / RG);  // a thread's chunks
  float4 a[NC];
  __device__ static __forceinline__ int row(int t128) {
    return ((t128 >> 5) & (RG - 1)) * 32 + (t128 & 31);
  }
  // the thread's first chunk
  __device__ static __forceinline__ int chunk(int t128) {
    return ((t128 >> 5) >> (RG - 1)) * NC;
  }
};

// the thread's row of src (row r at src + r * sl); rows at or past n read
// as 0
template <int R, int W>
__device__ __forceinline__ void load_rows(const float* src, long long sl,
                                          int n, int t128, Rows<R, W>& x) {
  const int r = Rows<R, W>::row(t128);
  const float* row = src + (long long)(r < n ? r : 0) * sl +
                     4 * Rows<R, W>::chunk(t128);
#pragma unroll
  for (int i = 0; i < Rows<R, W>::NC; ++i)
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

// The rows split into tf32 hi / lo: as they stand ([row][d] in Sw<2 W>, hi
// at dst, lo a tile's bytes after; a warp's 16-byte stores, 8 rows a
// 128-byte phase, are free of bank conflicts under the swizzle), or
// transposed ([d][row'] in Sw<2 R> with row r at column (r & ~7) +
// key_col(r & 7); each 4-byte store fills one row's 32 banks)
template <bool T, int R, int W>
__device__ __forceinline__ void split_store(const Rows<R, W>& x,
                                            unsigned char* dst, int t128) {
  constexpr int TILE = R * W * 4;
  const int r = Rows<R, W>::row(t128);
  const int col = (r & ~7) + key_col(r & 7);
#pragma unroll
  for (int i = 0; i < Rows<R, W>::NC; ++i) {
    const int c = Rows<R, W>::chunk(t128) + i;  // lanes 4 c .. 4 c + 3
    uint4 hi, lo;
    split4(x.a[i], hi, lo);
    if (!T) {
      const int o = Sw<2 * W>::off(r, c, R);
      *reinterpret_cast<uint4*>(dst + o) = hi;
      *reinterpret_cast<uint4*>(dst + TILE + o) = lo;
    } else {
      const uint32_t h4[4] = {hi.x, hi.y, hi.z, hi.w};
      const uint32_t l4[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = Sw<2 * R>::off(4 * c + e, col >> 2, W) + (col & 3) * 4;
        *reinterpret_cast<uint32_t*>(dst + o) = h4[e];
        *reinterpret_cast<uint32_t*>(dst + TILE + o) = l4[e];
      }
    }
  }
}

// acc (+)= A B^T over the HD lanes of a head: A a [64][HD] and B an
// [N][HD] K-major tile (hi at a / b, lo a tile's bytes after): HD / 8
// k-steps x 3 products
template <int HD, int N>
__device__ __forceinline__ void product_ss(float* acc, uint32_t a,
                                           uint32_t b) {
  using S = Sw<2 * HD>;
  constexpr int TA = 64 * HD * 4, TB = N * HD * 4;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    wgmma_tf32_ss<N>(acc, S::kmajor(a + TA, kk, 64), S::kmajor(b, kk, N),
                     kk > 0);
    wgmma_tf32_ss<N>(acc, S::kmajor(a, kk, 64), S::kmajor(b + TB, kk, N), 1);
    wgmma_tf32_ss<N>(acc, S::kmajor(a, kk, 64), S::kmajor(b, kk, N), 1);
  }
}

// One chain of a product that sums over 32 rows (half `half` of a tile's
// K): out += X Y for NO output lanes, X from a score accumulator x (x[4 i +
// 2 hr + e]: row g + 8 hr, column 8 i + 2 quad + e) as the register A
// operand, Y NO rows (from y) of a transposed [RT][K] tile (hi; lo a
// tile's bytes after) whose k-columns carry key_col's permutation; the
// chain's 12 products go to a fresh accumulator `part`, added into out in
// fp32. split_chain forms the operand, issue_chain issues the products as
// one commit group (no wait), settle_chain adds the accumulator once the
// group has completed.
template <int NO>
struct Chain {
  uint32_t h[4][4], l[4][4];  // X's tf32 hi / lo, 4 k-steps
  float part[NO / 2];
};

template <int NO>
__device__ __forceinline__ void split_chain(const float* x, int half,
                                            Chain<NO>& c) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = half * 4 + j;
    split_tf32(x[4 * i + 0], c.h[j][0], c.l[j][0]);
    split_tf32(x[4 * i + 2], c.h[j][1], c.l[j][1]);
    split_tf32(x[4 * i + 1], c.h[j][2], c.l[j][2]);
    split_tf32(x[4 * i + 3], c.h[j][3], c.l[j][3]);
  }
}

template <int NO, int K, int RT>
__device__ __forceinline__ void issue_chain(Chain<NO>& c, uint32_t y,
                                            int half) {
  using S = Sw<2 * K>;
  constexpr int TILE = RT * K * 4;
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kk = half * 4 + j;
    wgmma_tf32_rs<NO>(c.part, c.l[j], S::kmajor(y, kk, RT), j > 0);
    wgmma_tf32_rs<NO>(c.part, c.h[j], S::kmajor(y + TILE, kk, RT), 1);
    wgmma_tf32_rs<NO>(c.part, c.h[j], S::kmajor(y, kk, RT), 1);
  }
  wgmma_commit();
}

template <int NO>
__device__ __forceinline__ void settle_chain(float* out, Chain<NO>& c) {
  fence_regs<NO / 2>(c.part);
  fence_regs_u<16>(&c.h[0][0]);
  fence_regs_u<16>(&c.l[0][0]);
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) out[i] += c.part[i];
}

// out += X Y over half `half` of the tile, waiting for it
template <int NO, int K, int RT>
__device__ __forceinline__ void product_rs(float* out, const float* x,
                                           uint32_t y, int half) {
  Chain<NO> c;
  split_chain(x, half, c);
  issue_chain<NO, K, RT>(c, y, half);
  wgmma_wait<0>();
  settle_chain(out, c);
}

// dkv's shared memory, from a 1024-byte aligned base: K, V (hi / lo each);
// buffer A: Q, dO, then the query tile's lse * log2 e and di [2][BQ];
// buffer B: Q^T, dO^T (at heads of 128 over Q and dO); the full / empty
// mbarriers of A and B
template <int HD>
struct DkvSmem {
  using C = F32Cfg<HD>;
  static constexpr int KB = C::BT * HD * 4;  // one K or V tile (hi or lo)
  static constexpr int QB = C::BQ * HD * 4;  // one Q, dO, Q^T or dO^T tile
  static constexpr int K = 0, V = 2 * KB;
  static constexpr int Q = 4 * KB, DO = Q + 2 * QB;
  static constexpr int QT = C::ALIAS ? Q : DO + 2 * QB, DOT = QT + 2 * QB;
  static constexpr int STATS = (C::ALIAS ? DO : DOT) + 2 * QB;
  static constexpr int BAR = STATS + 2 * C::BQ * 4;
  static constexpr int BYTES = BAR + 4 * 8 + 1024;  // + alignment
};

// dq's: per consumer warpgroup Q, dO (hi / lo each); buffer A: K, V, the
// visit's key mask; buffer B: K^T; the mbarriers
template <int HD>
struct DqSmem {
  using C = F32Cfg<HD>;
  static constexpr int QB = 64 * HD * 4;      // one Q or dO tile
  static constexpr int KB = C::BKV * HD * 4;  // one K, V or K^T tile
  static constexpr int QW = 0;  // warpgroup w's Q at 4 QB w, dO 2 QB after
  static constexpr int K = C::NWG * 4 * QB, V = K + 2 * KB;
  static constexpr int KT = V + 2 * KB;
  static constexpr int BIAS = KT + 2 * KB;
  static constexpr int BAR = BIAS + C::BKV * 4;
  static constexpr int BYTES = BAR + 4 * 8 + 1024;
};

enum { FULL_A = 0, EMPTY_A = 1, FULL_B = 2, EMPTY_B = 3 };

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

template <int HD>
__global__ void __launch_bounds__(F32Cfg<HD>::NS * 128 + 128, 1)
    flash_bwd_dkv_tf32_kernel(const BwdParams p) {
  using C = F32Cfg<HD>;
  using S = DkvSmem<HD>;
  constexpr int BT = C::BT, BQ = C::BQ, NS = C::NS, NO = HD / NS;
  constexpr bool PAIRS = C::LT < BT;  // two listed tiles a visit
  extern __shared__ __align__(1024) unsigned char dkv_smem_raw[];
  unsigned char* smem = aligned_smem(dkv_smem_raw);
  float* sL = reinterpret_cast<float*>(smem + S::STATS);
  float* sD = sL + BQ;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + S::BAR);

  const int tid = threadIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int* lst = p.list + (long long)b * (1 + p.tiles);
  const int listed = lst[0];
  const bool uniform = listed == 0;  // no valid key: every tile
  // the visit's keys: row r is key j0 + r; with two listed tiles a visit,
  // rows 32 t .. 32 t + 31 are key jt[t] + r (jt[t] the t-th tile's first
  // key less 32 t; none where the list has ended: 0 rows, nt[t])
  if ((int)blockIdx.x >= (PAIRS ? (uniform ? (p.Lk + BT - 1) / BT
                                           : (listed + 1) / 2)
                                 : (uniform ? p.tiles : listed)))
    return;
  const int j0 =
      PAIRS ? 0 : (uniform ? (int)blockIdx.x : lst[1 + blockIdx.x]) * BT;
  int jt[2] = {0, 0}, nt[2] = {0, 0};
  if constexpr (PAIRS) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int i = 2 * blockIdx.x + t;
      jt[t] = uniform ? (int)blockIdx.x * BT
                      : (i < listed ? lst[1 + i] * C::LT - 32 * t : 0);
      nt[t] = uniform || i < listed ? p.Lk - jt[t] : 0;
    }
  }
  const int nq = (p.Lq + BQ - 1) / BQ;
  init_bars(bar, 128, NS * 128);

  if (tid >= NS * 128) {
    // ---- producer warps: per query tile, Q and dO into buffer A as they
    // stand (with lse * log2 e and di), then transposed into buffer B
    const int pt = tid - NS * 128;
    const float* qb = (const float*)p.q + b * p.q_sb + h * HD;
    const long long o_sl = (long long)p.H * HD;
    const float* ob = (const float*)p.dout + (long long)b * p.Lq * o_sl +
                      h * HD;
    const float* lse_b = p.lse + ((long long)b * p.H + h) * p.Lq;
    const float* di_b = p.di + ((long long)b * p.H + h) * p.Lq;
    Rows<BQ, HD> xq, xo;
    for (int t = 0; t < nq; ++t) {
      const int q0 = t * BQ;
      load_rows(qb + (long long)q0 * p.q_sl, p.q_sl, p.Lq - q0, pt, xq);
      load_rows(ob + (long long)q0 * o_sl, o_sl, p.Lq - q0, pt, xo);
      float lq = pos_inf(), dd = 0.f;
      if (pt < BQ && q0 + pt < p.Lq) {
        lq = lse_b[q0 + pt] * LOG2E;
        dd = di_b[q0 + pt];
      }
      // A over B (heads of 128): once B of the tile before is free
      if (t > 0) mbar_wait(&bar[C::ALIAS ? EMPTY_B : EMPTY_A], (t - 1) & 1);
      split_store<false>(xq, smem + S::Q, pt);
      split_store<false>(xo, smem + S::DO, pt);
      if (pt < BQ) {
        sL[pt] = lq;
        sD[pt] = dd;
      }
      fence_async();
      mbar_arrive(&bar[FULL_A]);
      if (C::ALIAS)
        mbar_wait(&bar[EMPTY_A], t & 1);
      else if (t > 0)
        mbar_wait(&bar[EMPTY_B], (t - 1) & 1);
      split_store<true>(xq, smem + S::QT, pt);
      split_store<true>(xo, smem + S::DOT, pt);
      fence_async();
      mbar_arrive(&bar[FULL_B]);
    }
    return;
  }

  // ---- the consumer warpgroups: the visit's 64 keys; warpgroup wg writes
  // lanes NO wg .. NO wg + NO - 1 of their dK and dV
  const int wg = NS > 1 ? tid >> 7 : 0, tw = NS > 1 ? tid & 127 : tid;
  const int warp = tw >> 5, lane = tid & 31, quad = lane & 3;
  {
    // K and V split once (with two warpgroups, K by one and V by the other)
    int jr = j0, nr = p.Lk - j0;  // this thread's row's base and count
    if constexpr (PAIRS) {
      const int t = Rows<BT, HD>::row(tw) >> 5;
      jr = jt[t];
      nr = nt[t];
    }
    Rows<BT, HD> x;
    if (NS == 1 || wg == 0) {
      load_rows((const float*)p.k + b * p.k_sb + (long long)jr * p.k_sl +
                    h * HD,
                p.k_sl, nr, tw, x);
      split_store<false>(x, smem + S::K, tw);
    }
    if (NS == 1 || wg == 1) {
      load_rows((const float*)p.v + b * p.v_sb + (long long)jr * p.v_sl +
                    h * HD,
                p.v_sl, nr, tw, x);
      split_store<false>(x, smem + S::V, tw);
    }
    fence_async();
    asm volatile("bar.sync 1, %0;\n" ::"n"(NS * 128) : "memory");
  }
  // the keys of this thread's rows (g and g + 8 of its warp's 16), -1 past
  // a pair's list
  auto key_of = [&](int hr) {
    if constexpr (PAIRS) {
      const int r = warp * 16 + (lane >> 2) + 8 * hr;
      return nt[r >> 5] > 0 ? jt[r >> 5] + r : -1;
    } else {
      return j0 + warp * 16 + (lane >> 2) + 8 * hr;
    }
  };
  const unsigned char* vld = p.valid + (long long)b * p.Lk;
  float kb[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = key_of(hr);
    kb[hr] = (!PAIRS || key >= 0) && key < p.Lk && (uniform || vld[key])
                 ? 0.f
                 : neg_inf();
  }
  const float inv_pad = 1.f / (float)p.lk_pad;
  const uint32_t base = smem_u32(smem);
  // this warpgroup's rows of the transposed tiles (lanes NO wg ..)
  const int lanes = NS > 1 ? wg * NO * Sw<2 * BQ>::RB : 0;
  float dk[NO / 2], dv[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) dk[i] = dv[i] = 0.f;
  float sc[BQ / 2], dp[BQ / 2];

  for (int t = 0; t < nq; ++t) {
    mbar_wait(&bar[FULL_A], t & 1);
    fence_async();
    // S^T = K Q^T, then dP^T = V dO^T, in two commit groups
    wgmma_fence();
    product_ss<HD, BQ>(sc, base + S::K, base + S::Q);
    wgmma_commit();
    product_ss<HD, BQ>(dp, base + S::V, base + S::DO);
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
        sc[4 * i + 2 * hr] = prob(sc[4 * i + 2 * hr], kb[hr], l2.x, uniform,
                                  p.scale_log2, inv_pad);
        sc[4 * i + 2 * hr + 1] = prob(sc[4 * i + 2 * hr + 1], kb[hr], l2.y,
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
        const float* s = sc + 4 * i + 2 * hr;
        d[0] = s[0] * (d[0] - d2.x) * p.scale;
        d[1] = s[1] * (d[1] - d2.y) * p.scale;
      }
    }
    mbar_arrive(&bar[EMPTY_A]);
    mbar_wait(&bar[FULL_B], t & 1);
    fence_async();
    // dV += P^T dO, dK += dS^T Q, 32 query rows a chain
    if constexpr (NS == 1 && BQ == 64) {
      // four chains, two in flight, each operand split while the one
      // before runs
      Chain<NO> cv, ck;
      split_chain(sc, 0, cv);
      issue_chain<NO, BQ, HD>(cv, base + S::DOT + lanes, 0);
      split_chain(dp, 0, ck);
      issue_chain<NO, BQ, HD>(ck, base + S::QT + lanes, 0);
      wgmma_wait<1>();
      settle_chain(dv, cv);
      split_chain(sc, 1, cv);
      issue_chain<NO, BQ, HD>(cv, base + S::DOT + lanes, 1);
      wgmma_wait<1>();
      settle_chain(dk, ck);
      split_chain(dp, 1, ck);
      issue_chain<NO, BQ, HD>(ck, base + S::QT + lanes, 1);
      wgmma_wait<1>();
      settle_chain(dv, cv);
      wgmma_wait<0>();
      settle_chain(dk, ck);
    } else {
#pragma unroll
      for (int half = 0; half < BQ / 32; ++half) {
        product_rs<NO, BQ, HD>(dv, sc, base + S::DOT + lanes, half);
        product_rs<NO, BQ, HD>(dk, dp, base + S::QT + lanes, half);
      }
    }
    mbar_arrive(&bar[EMPTY_B]);
  }

  // dk[4 i + 2 hr + e]: key (16 warp + g + 8 hr), lane NO wg + 8 i + 2 quad
  // + e
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = key_of(hr);
    if ((PAIRS && key < 0) || key >= p.Lk) continue;
    const long long off = ((long long)b * p.Lk + key) * p.H * HD + h * HD +
                          wg * NO + 2 * quad;
#pragma unroll
    for (int i = 0; i < NO / 8; ++i) {
      *reinterpret_cast<float2*>((float*)p.dk + off + 8 * i) =
          make_float2(dk[4 * i + 2 * hr], dk[4 * i + 2 * hr + 1]);
      *reinterpret_cast<float2*>((float*)p.dv + off + 8 * i) =
          make_float2(dv[4 * i + 2 * hr], dv[4 * i + 2 * hr + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(F32Cfg<HD>::NWG * 128 + 128, 1)
    flash_bwd_dq_tf32_kernel(const BwdParams p) {
  using C = F32Cfg<HD>;
  using S = DqSmem<HD>;
  constexpr int NWG = C::NWG, BKV = C::BKV;
  extern __shared__ __align__(1024) unsigned char dq_smem_raw[];
  unsigned char* smem = aligned_smem(dq_smem_raw);
  float* sB = reinterpret_cast<float*>(smem + S::BIAS);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + S::BAR);

  const int tid = threadIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * (64 * NWG);
  const int* lst = p.list + (long long)b * (1 + p.tiles);
  const bool uniform = lst[0] == 0;  // no valid key: every tile
  const int visits = uniform ? p.tiles : lst[0];  // a listed tile a visit
  init_bars(bar, 128, NWG * 128);

  if (tid >= NWG * 128) {
    // ---- producer warps: per listed key tile, K and V into buffer A as
    // they stand (with the tile's bias row), then K transposed into B
    const int pt = tid - NWG * 128;
    const float* kb = (const float*)p.k + b * p.k_sb + h * HD;
    const float* vb = (const float*)p.v + b * p.v_sb + h * HD;
    const unsigned char* vld = p.valid + (long long)b * p.Lk;
    Rows<BKV, HD> xk, xv;
    for (int t = 0; t < visits; ++t) {
      const int j0 = (uniform ? t : lst[1 + t]) * BKV;
      load_rows(kb + (long long)j0 * p.k_sl, p.k_sl, p.Lk - j0, pt, xk);
      load_rows(vb + (long long)j0 * p.v_sl, p.v_sl, p.Lk - j0, pt, xv);
      float bias = 0.f;
      if (pt < BKV) {
        const int j = j0 + pt;
        bias = j < p.Lk && (uniform || vld[j]) ? 0.f : neg_inf();
      }
      if (t > 0) mbar_wait(&bar[EMPTY_A], (t - 1) & 1);
      split_store<false>(xk, smem + S::K, pt);
      split_store<false>(xv, smem + S::V, pt);
      if (pt < BKV) sB[pt] = bias;
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
  unsigned char* sQ = smem + S::QW + wg * 4 * S::QB;
  {
    Rows<64, HD> x;
    load_rows((const float*)p.q + b * p.q_sb + (long long)qw * p.q_sl +
                  h * HD,
              p.q_sl, p.Lq - qw, tw, x);
    split_store<false>(x, sQ, tw);
    load_rows((const float*)p.dout + ((long long)b * p.Lq + qw) * o_sl +
                  h * HD,
              o_sl, p.Lq - qw, tw, x);
    split_store<false>(x, sQ + 2 * S::QB, tw);
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
  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
  float sc[BKV / 2], dp[BKV / 2];

  for (int t = 0; t < visits; ++t) {
    mbar_wait(&bar[FULL_A], t & 1);
    fence_async();
    // S = Q K^T, then dP = dO V^T, in two commit groups
    wgmma_fence();
    product_ss<HD, BKV>(sc, qhi, base + S::K);
    wgmma_commit();
    product_ss<HD, BKV>(dp, qhi + 2 * S::QB, base + S::V);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs<BKV / 2>(sc);
    // P on the accumulator (sc[4 i + 2 hr + e]: row g + 8 hr, key 8 i + 2
    // quad + e) while dP runs
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i) {
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
    fence_regs<BKV / 2>(dp);
    mbar_arrive(&bar[EMPTY_A]);
    // dS = P (dP - di) scale
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i)
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
    product_rs<HD, BKV, HD>(dq, dp, base + S::KT, 0);
    if constexpr (BKV == 64) product_rs<HD, BKV, HD>(dq, dp, base + S::KT, 1);
    mbar_arrive(&bar[EMPTY_B]);
  }

  // dq[4 i + 2 hr + e]: row (16 warp + g + 8 hr), lane 8 i + 2 quad + e
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = r0 + 8 * hr;
    if (qi >= p.Lq) continue;
    float* row = (float*)p.dq + ((long long)b * p.Lq + qi) * o_sl + h * HD +
                 2 * quad;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<float2*>(row + 8 * i) =
          make_float2(dq[4 * i + 2 * hr], dq[4 * i + 2 * hr + 1]);
  }
}

template <int HD>
cudaError_t launch_dkv(const BwdParams& p, int B, cudaStream_t s) {
  using C = F32Cfg<HD>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tf32_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, DkvSmem<HD>::BYTES);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_tf32_kernel<HD><<<dim3(max_visits<C::LT, C::BT>(p.Lk), p.H,
                                       B),
                                  C::NS * 128 + 128, DkvSmem<HD>::BYTES, s>>>(
      p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const BwdParams& p, int B, cudaStream_t s) {
  using C = F32Cfg<HD>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tf32_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, DqSmem<HD>::BYTES);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_tf32_kernel<HD><<<dim3(cdiv(p.Lq, 64 * C::NWG), p.H, B),
                                 C::NWG * 128 + 128, DqSmem<HD>::BYTES, s>>>(
      p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// fp32, heads of D = 32, 64 or 128. q/k/v: element (b, i, h, d) at b * sb +
// i * sl + h * D + d (rows 16-byte aligned); valid: bool [B, Lk]; list: the
// fp32 forward's tile list, int32 [B, 1 + ceil(Lk / LT)] (LT = 32 at D =
// 128, else 64: per batch row the count of LT-key tiles that hold a valid
// key, then their indices); lse: the forward's [B, H, Lq]; dout: [B, Lq, H,
// D] contiguous; di: [B, H, Lq]; dk, dv: [B, Lk, H, D] contiguous out,
// zeroed by the caller (the unlisted tiles' gradients are 0 and not
// written).
int gvf_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* valid,
    const void* list, const void* lse, const void* dout, const void* di,
    void* dk, void* dv, int B, int Lq, int Lk, int H, int D, long long q_sb,
    long long q_sl, long long k_sb, long long k_sl, long long v_sb,
    long long v_sl, float scale, int lk_pad, void* stream) {
  if (bad_shape(B, Lq, Lk, H, D, lk_pad)) return (int)cudaErrorInvalidValue;
  if (misaligned(q, k, v, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, 4))
    return (int)cudaErrorMisalignedAddress;
  BwdParams p = make_params(q, k, v, valid, list, lse, dout, di, Lq, Lk, H,
                            q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale, lk_pad,
                            D == 128 ? 32 : 64);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 32) return (int)launch_dkv<32>(p, B, s);
  if (D == 64) return (int)launch_dkv<64>(p, B, s);
  return (int)launch_dkv<128>(p, B, s);
}

// the same inputs; dq: [B, Lq, H, D] contiguous out
int gvf_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* valid,
    const void* list, const void* lse, const void* dout, const void* di,
    void* dq, int B, int Lq, int Lk, int H, int D, long long q_sb,
    long long q_sl, long long k_sb, long long k_sl, long long v_sb,
    long long v_sl, float scale, int lk_pad, void* stream) {
  if (bad_shape(B, Lq, Lk, H, D, lk_pad)) return (int)cudaErrorInvalidValue;
  if (misaligned(q, k, v, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, 4))
    return (int)cudaErrorMisalignedAddress;
  BwdParams p = make_params(q, k, v, valid, list, lse, dout, di, Lq, Lk, H,
                            q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale, lk_pad,
                            D == 128 ? 32 : 64);
  p.dq = dq;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 32) return (int)launch_dq<32>(p, B, s);
  if (D == 64) return (int)launch_dq<64>(p, B, s);
  return (int)launch_dq<128>(p, B, s);
}

}  // extern "C"
