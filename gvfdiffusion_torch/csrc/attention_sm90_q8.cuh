// The int8-QK path of the Hopper attention core (sm_90a): K1's int8-QK
// forms (quant_qk) and K3's int8 form (quant: the DiT's two contexts against
// an int8 KV cache), both in fused_sublayer.cu.
//
// Replaces, on the card, the attention step of the Pallas TPU kernels
// gvfdiffusion_tpu/ops/fused_sublayer.py:344 fused_self_sublayer
// (_self_sublayer_kernel :170, quant_qk) and :839 fused_cross_sublayer
// (_cross_sublayer_kernel :589, quant), both through _packed_attention :75,
// its k_int8 and quant_qk branches (:120-136).
//
// What it computes, in the TPU kernels' arithmetic (the plain versions:
// ops/fused_sublayer.py _qk8_attention and cross_sublayer_q8_reference):
// q arrives quantized (q8_kernel: qi = round(q * 127 / qs), qs the max |q|
// of the query row's cell and head, floored at 1e-8), k quantized too (K1:
// one scale ks per cell and head, as q; K3: the cache's per-key, per-head
// bf16 scale ks_t). si = qi . ki, an int8 x int8 product accumulated in
// int32 (exact: |si| <= 127^2 D < 2^24, so its fp32 value is exact too);
// s = si * f - 30 with, per query row,
//   K1: f = qs * ks * scale * log2 e / 127^2 (one scalar),
//   K3: f = ks_j * (qs * scale * log2 e / 127) (per key j),
// each product rounded as the TPU kernel rounds it (no fused multiply-add);
// P = exp2(s), the fixed shift with no running maximum; keys past Lk get
// P = 0. The row sum comes from the fp32 P; P is rounded to bf16 for P V,
// V in bf16: K1's the fp32 projection rounded, K3's the int8 cache
// dequantized as bf16(v * vs) (vs the per-key, per-head bf16 scale).
//
// Design, on attention_sm90.cuh's core (its tiles, descriptors, barriers
// and the P V step): one CTA per (query tile of 64 NWG rows, head, batch
// row), NWG consumer warpgroups of 64 rows, then four producer warps.
//  - The producer fills a ring of 3 stages. Lane 0 of its first warp copies
//    the int8 K tile of BK keys by TMA (a 4-d map of [batch row, key, head,
//    lane] bytes; rows of 32, 64 or 128 bytes (heads of 128) in
//    wgmma's 32-, 64- or 128-byte swizzle,
//    Sw8<D>; rows past Lk zero-filled). All four warps write V as an
//    MN-major bf16 tile (Sw<D>, as the core's fp32 producer does), reading
//    fp32 rows (K1) or int8 rows with their scale (K3: the int8 tiles land
//    by TMA in a ring of their own, "staged", three tiles ahead, and the
//    scales are loaded a tile ahead), and the stage's two rows of per-key
//    values: the shift (-30, or -inf past Lk) and, for K3, ks_j.
//    The stage's "full" barrier completes on the TMA bytes and the 128
//    producer arrivals; the consumers release it through "empty". The
//    producer never waits on anything the consumers hold but "empty".
//  - Each consumer warpgroup copies its 64 int8 query rows into shared
//    memory once (Sw8<D>), then per tile: S = Qi Ki^T with
//    wgmma.mma_async m64n128k32 .s32.s8.s8 (both operands K-major in shared
//    memory, D / 32 k-steps), the scores converted and scaled on the
//    accumulator layout (each row's four lanes share its f), exp2 on the
//    SFU, P rounded to bf16 as the register A operand of O += P V
//    (m64nDk16, bf16), and the output normalised once and written through
//    the core's staging tile.
//
// What bounds each form on the H100 (datasheet peaks: int8 1,979 TOP/s,
// bf16 989 TFLOP/s, 3.35 TB/s): at the DiT's shapes K1's attention is 32
// frames x 16 heads x 512 rows x 512 keys x 32 lanes: 8.6 GOP of QK at the
// int8 rate (4.3 us) and 8.6 GFLOP of P V in bf16 (8.7 us); K3's is 32 x
// 16 x 512 x (1374 + 512) keys: 31.6 GOP of QK (16 us) and 31.6 GFLOP of
// P V (32 us). On paper K1's bytes bound it (int8 q and k, fp32 V, bf16
// out: 66 MB, 20 us at 3.35 TB/s), K3's P V (its 87 MB take 26 us). Under
// both sits the SFU:
// one exp2 a score, 0.13e9 scores for K1 (36 us at 16 a clock an SM) and
// 0.49e9 for K3 (0.13 ms), with each score's scaling around it, and for
// K3 the producer's conversion of V: in practice the softmax and the ring
// bound it (PERF.md, PR 10 and 11).

#pragma once

#include "attention_sm90.cuh"

namespace gvf {
namespace sm90 {

// S = A B^T over int8, both K-major in shared memory, 32 bytes of K a step:
// d[64] int32 per thread, the f32 accumulator's layout
__device__ __forceinline__ void wgmma_s8_128(int* d, uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void fence_regs_i(int* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x on the SFU with subnormal results kept (the plain version's exp2
// keeps them; the fixed shift can take a score that far down)
__device__ __forceinline__ float ex2_sub(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// An int8 tile of `rows` rows x D bytes (D = 32, 64 or 128) in wgmma's
// swizzled canonical layout, the one TMA writes: rows of RB = D bytes,
// 8-row atoms whose 16-byte chunks are XOR-permuted by the row (128-byte
// swizzle: by row mod 8, as Sw<64>'s bf16 rows; 64-byte swizzle: by row /
// 2 mod 4, as Sw<32>'s; 32-byte swizzle: by row / 4 mod 2). A k-step of
// wgmma's s8 shapes is 32 bytes: one at D = 32, two at 64, four at 128.
template <int D>
struct Sw8 {
  static_assert(D == 32 || D == 64 || D == 128,
                "int8 rows of 32, 64 or 128 bytes");
  static constexpr int RB = D;
  // 128B / 64B / 32B swizzle
  static constexpr uint64_t MODE = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  __device__ static __forceinline__ int off(int r, int c) {
    const int x = RB == 128 ? (r & 7)
                  : RB == 64 ? ((r >> 1) & 3) : ((r >> 2) & 1);
    return r * RB + ((c ^ x) << 4);
  }
  // K-major operand: SBO = one 8-row atom; k-step kk moves 32 bytes along
  // the row
  __device__ static __forceinline__ uint64_t kmajor(uint32_t base, int kk) {
    return make_desc(base + kk * 32, 16, 8 * RB, MODE);
  }
};

// The forms of the path (the template's MODE):
//   Q8_CACHE  K3's int8 cache: per-key k scales, int8 V dequantized;
//   Q8_SELF   K1's int8 QK: one k scale per (cell, head), fp32 V rows;
//   Q8_QK     K5's quant="qk": one k scale per (batch row, head), V rows of
//             type TV, a per-key logit bias and segments, the row sum of
//             the bf16-rounded P;
//   Q8_QKAV   K5's quant="qk+av": as Q8_QK with int8 P V in two passes over
//             the keys (below).
enum { Q8_CACHE = 0, Q8_SELF = 1, Q8_QK = 2, Q8_QKAV = 3 };

// Query row i of batch row z lies in the scale cell (z * Lq + i) / q_block,
// or with q_cells > 0 (K5: cells of q_block rows within each batch row) in
// z * q_cells + i / q_block; the cells' scales are [cells, H] fp32. Offsets
// in elements (bytes for the int8 tensors); rows within a batch row step by
// *_si / *_sj.
struct Q8AttnParams {
  const signed char* q;  // int8 q rows
  const float* qs;       // [cells, H] q scales
  const signed char* k;  // int8 k rows (read by TMA)
  const void* v;         // K1: fp32 rows; K3: int8 rows; K5: TV rows
  const float* ks;       // K1: [cells, H] k scales, celled as qs; K5: [B, H]
  const bf16* ks_t;      // K3: [B, H, Lk] per-key k scales
  const bf16* vs;        // K3: [B, Lk, H] per-key v scales
  bf16* o;
  long long q_s1, q_si, k_s1, k_sj, v_s1, v_sj, o_s1, o_si;
  int Lq, Lk, H, q_block;
  float scale;
  // K5 only: the fp32 [B, Lk] logit bias (bias_s1 apart) or null; segments
  // (seg > 0: row i sees key j only where i / seg == j / seg); the cells of
  // a batch row; Q8_QKAV's v scales [B, H]
  const float* bias = nullptr;
  long long bias_s1 = 0;
  int seg = 0, q_cells = 0;
  const float* vsc = nullptr;
};

constexpr int Q8_BK = 128, Q8_STAGES = 3, Q8_NPROD = 4;

// Shared memory, from a 1024-byte aligned base: Q [NWG * 64][D] int8, per
// stage K [BK][D] int8 and V [BK][D] bf16, the shift and k-scale rows
// [STAGES][BK] fp32, K3's int8 V tiles as TMA lands them [STAGES][BK][D],
// the output staging [NWG * 64][D + 8] bf16, the full / empty / staged
// mbarriers
template <int D, int NWG>
struct Q8Smem {
  static constexpr int BK = Q8_BK, STAGES = Q8_STAGES;
  static constexpr int Q = 0;
  static constexpr int K = Q + NWG * 64 * D;
  static constexpr int V = K + STAGES * BK * D;
  static constexpr int SHIFT = V + STAGES * BK * D * 2;
  static constexpr int KS = SHIFT + STAGES * BK * 4;
  static constexpr int STG = KS + STAGES * BK * 4;  // K3: int8 V as loaded
  static constexpr int O = STG + STAGES * BK * D;
  static constexpr int OLD = D + 8;  // staging row, in bf16
  static constexpr int BAR = O + NWG * 64 * OLD * 2;
  static constexpr int BYTES = BAR + 3 * STAGES * 8 + 1024;  // + alignment
};

template <int D, int NWG, int MODE, typename TV>
__global__ void __launch_bounds__(NWG * 128 + 32 * Q8_NPROD, 1)
    attn_sm90_q8_kernel(const Q8AttnParams p,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv) {
  constexpr int BK = Q8_BK, STAGES = Q8_STAGES, NPROD = Q8_NPROD;
  constexpr bool SELF = MODE == Q8_SELF, K5 = MODE >= Q8_QK;
  constexpr bool AV = MODE == Q8_QKAV;
  // V rows read by the producer (fp32 for K1, TV for K5); K3 stages int8
  constexpr bool VROWS = MODE != Q8_CACHE;
  // Q8_QKAV walks the keys twice: the row maximum, then P and P V
  constexpr int NPASS = AV ? 2 : 1;
  using L = Q8Smem<D, NWG>;
  using S8 = Sw8<D>;
  using S = Sw<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem + L::Q;
  unsigned char* sK = smem + L::K;
  unsigned char* sV = smem + L::V;
  float* sShift = reinterpret_cast<float*>(smem + L::SHIFT);
  float* sKs = reinterpret_cast<float*>(smem + L::KS);
  unsigned char* sStg = smem + L::STG;
  bf16* sO = reinterpret_cast<bf16*>(smem + L::O);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* staged = empty + STAGES;

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const long long z = blockIdx.z;
  const int q0 = blockIdx.x * (64 * NWG);
  // the key tiles first .. first + tiles - 1: every one, or with segments
  // the run that holds the keys of this CTA's rows' segments
  int tiles = (p.Lk + BK - 1) / BK, first = 0;
  if constexpr (K5) {
    if (p.seg > 0) {
      const int qend = min(q0 + 64 * NWG, p.Lq);
      const int klo = (q0 / p.seg) * p.seg;
      const int khi = min(p.Lk, ((qend - 1) / p.seg + 1) * p.seg);
      first = klo / BK;
      tiles = (khi - 1) / BK - first + 1;
    }
  }
  // the key tile of step t (Q8_QKAV's second pass walks them again)
  auto tile_key = [&](int t) { return (first + (AV ? t % tiles : t)) * BK; };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      // every producer thread arrives after its stores; lane 0 arrives once
      // more with the TMA transaction count
      mbar_init(&full[s], 32 * NPROD + 1);
      mbar_init(&empty[s], NWG * 128);
      mbar_init(&staged[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NWG * 128) {
    // ---- producer warps: the int8 K tile (TMA), V, the per-key rows
    static_assert(BK == 32 * NPROD, "one key of the per-key rows a thread");
    const int pt = tid - NWG * 128;
    // K3: the int8 V tiles land by TMA in a ring of their own, STAGES
    // tiles ahead of the conversion; each thread's CPT v scales (of its
    // 16-byte chunks) and its key's k scale are loaded a tile ahead, so
    // their latency overlaps this tile's work (V loaded by the threads
    // themselves held the ring back: 0.29 ms a context against 0.18 with
    // no V loads, H100 ablation)
    constexpr int CPT = VROWS ? 1 : BK * D / 16 / (32 * NPROD);
    float vsc[CPT], ksc = 0.f;
    auto fetch_scales = [&](int t) {
      const bf16* vsb = p.vs + z * p.Lk * p.H + h;
      const int j0 = t * BK;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int j = j0 + (pt + k * 32 * NPROD) / (D / 16);
        vsc[k] = j < p.Lk ? to_f(vsb[(long long)j * p.H]) : 0.f;
      }
      ksc = j0 + pt < p.Lk ? to_f(p.ks_t[(z * p.H + h) * p.Lk + j0 + pt])
                           : 0.f;
    };
    auto stage_v = [&](int t) {  // one thread
      const int s = t % STAGES;
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_u32(&staged[s])),
          "r"(BK * D)
          : "memory");
      tma_load_4d(smem_u32(sStg + s * BK * D), &tv, 0, h, t * BK, (int)z,
                  &staged[s]);
    };
    if constexpr (!VROWS) {
      if (pt == 0)
        for (int t = 0; t < STAGES && t < tiles; ++t) stage_v(t);
      fetch_scales(0);
    }
    // K5: the bias row's source and Q8_QKAV's v quantization, 127 / vm
    const float* bb = K5 && p.bias ? p.bias + z * p.bias_s1 : nullptr;
    const float v_rcp = AV ? __fdiv_rn(127.f, p.vsc[z * p.H + h]) : 0.f;
    for (int t = 0; t < NPASS * tiles; ++t) {
      const int s = t % STAGES;
      if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
      const int j0 = tile_key(t);
      if (pt == 0) {
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                smem_u32(&full[s])),
            "r"(BK * D)
            : "memory");
        tma_load_4d(smem_u32(sK + s * BK * D), &tk, 0, h, j0, (int)z,
                    &full[s]);
      }
      unsigned char* dv = sV + s * BK * D * 2;
      if constexpr (VROWS) {
        // fp32 (K1) or TV (K5) V rows: 8 lanes load a row's 8-value chunks,
        // round, store; Q8_QKAV quantizes them, vi = round(bf16(v) * 127 /
        // vm) (half to even), held exactly as bf16 integers, and loads V on
        // its second pass only
        const TV* vb = (const TV*)p.v + z * p.v_s1 + h * D;
        constexpr int CH = BK * D / 8;
        if (!AV || t >= tiles) {
#pragma unroll 4
          for (int idx = pt; idx < CH; idx += 32 * NPROD) {
            const int r = idx / (D / 8), c = idx % (D / 8);
            const int j = j0 + r;
            float b[8];
            if (j < p.Lk) {
              load8(vb + (long long)j * p.v_sj + c * 8, b);
            } else {
#pragma unroll
              for (int e = 0; e < 8; ++e) b[e] = 0.f;
            }
            if (AV) {
#pragma unroll
              for (int e = 0; e < 8; ++e)
                b[e] = (float)__float2int_rn(__fmul_rn(
                    __bfloat162float(__float2bfloat16(b[e])), v_rcp));
            }
            *reinterpret_cast<uint4*>(dv + S::off(r, c, BK)) = pack8(b);
          }
        }
      } else {
        // int8 V rows: 16 values a chunk, dequantized as bf16(v * vs)
        float vs_cur[CPT];
#pragma unroll
        for (int k = 0; k < CPT; ++k) vs_cur[k] = vsc[k];
        sKs[s * BK + pt] = ksc;
        if (t + 1 < tiles) fetch_scales(t + 1);
        mbar_wait(&staged[s], (t / STAGES) & 1);
        const unsigned char* stg = sStg + s * BK * D;
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          const int idx = pt + k * 32 * NPROD;
          const int r = idx / (D / 16), c = idx % (D / 16);
          const uint4 raw = *reinterpret_cast<const uint4*>(stg + r * D + c * 16);
          const signed char* vc = reinterpret_cast<const signed char*>(&raw);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float b[8];
#pragma unroll
            for (int e = 0; e < 8; ++e)
              b[e] = __fmul_rn((float)vc[8 * half + e], vs_cur[k]);
            *reinterpret_cast<uint4*>(dv + S::off(r, 2 * c + half, BK)) =
                pack8(b);
          }
        }
        // every producer thread has read the staged tile: refill it
        asm volatile("bar.sync 3, %0;\n" ::"n"(32 * NPROD) : "memory");
        if (pt == 0 && t + STAGES < tiles) stage_v(t + STAGES);
      }
      // the per-key shift: -30, or for K5 with a bias -(30 - bias log2 e),
      // the TPU kernel's bias row negated (-inf for a bias of -inf); -inf
      // past Lk
      if constexpr (K5) {
        float sh = neg_inf();
        if (j0 + pt < p.Lk)
          sh = bb ? -__fsub_rn(EXP2_SHIFT, __fmul_rn(bb[j0 + pt], LOG2E))
                  : -EXP2_SHIFT;
        sShift[s * BK + pt] = sh;
      } else {
        sShift[s * BK + pt] = j0 + pt < p.Lk ? -EXP2_SHIFT : neg_inf();
      }
      // releases V and the per-key rows (plain stores, made visible to
      // wgmma's reads)
      fence_async();
      mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63
  const int wg = tid >> 7, tw = tid & 127, warp = tw >> 5, lane = tid & 31;
  unsigned char* sQw = sQ + wg * 64 * D;
  {
    const signed char* qb = p.q + z * p.q_s1 + h * D;
#pragma unroll
    for (int idx = tw; idx < 64 * (D / 16); idx += 128) {
      const int r = idx / (D / 16), c = idx % (D / 16);
      const int qi = q0 + wg * 64 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (qi < p.Lq)
        val = *reinterpret_cast<const uint4*>(qb + (long long)qi * p.q_si +
                                              c * 16);
      *reinterpret_cast<uint4*>(sQw + S8::off(r, c)) = val;
    }
    fence_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  }

  // each thread's two rows (16 warp + lane / 4 + 8 hr): their score factor
  // f, rounded as the TPU kernel rounds it, and with segments the keys
  // [seg_lo, seg_hi) they see
  const int quad = lane & 3, r0 = lane >> 2;
  float f[2];
  int seg_lo[2] = {0, 0}, seg_hi[2] = {0, 0};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + wg * 64 + warp * 16 + r0 + 8 * hr;
    f[hr] = 0.f;
    if (K5 && p.seg > 0) {
      seg_lo[hr] = (qi / p.seg) * p.seg;
      seg_hi[hr] = seg_lo[hr] + p.seg;
    }
    if (qi < p.Lq) {
      const long long c =
          (K5 ? z * p.q_cells + qi / p.q_block
              : (z * p.Lq + qi) / p.q_block) * p.H + h;
      if (K5)  // (qm km / 127^2) scale log2 e
        f[hr] = __fmul_rn(
            __fmul_rn(__fdiv_rn(__fmul_rn(p.qs[c], p.ks[z * p.H + h]),
                                16129.f),
                      p.scale),
            LOG2E);
      else
        f[hr] = SELF ? __fdiv_rn(__fmul_rn(__fmul_rn(__fmul_rn(p.qs[c],
                                                               p.ks[c]),
                                                     p.scale),
                                           LOG2E),
                                 16129.f)
                     : __fdiv_rn(__fmul_rn(__fmul_rn(p.qs[c], p.scale),
                                           LOG2E),
                                 127.f);
    }
  }
  auto outside = [&](int j, int hr) {
    return K5 && p.seg > 0 && (j < seg_lo[hr] || j >= seg_hi[hr]);
  };

  const uint32_t q_base = smem_u32(sQw);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float l_run[2] = {0.f, 0.f}, m_row[2] = {neg_inf(), neg_inf()};
  int si[BK / 2];
  uint32_t pa[BK / 16][4];

  for (int t = 0; t < NPASS * tiles; ++t) {
    const int s = t % STAGES;
    const int j0 = tile_key(t);
    mbar_wait(&full[s], (t / STAGES) & 1);
    fence_async();  // the producer's plain stores of V
    // S = Qi Ki^T in int32
    const uint32_t k_base = smem_u32(sK + s * BK * D);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk)
      wgmma_s8_128(si, S8::kmajor(q_base, kk), S8::kmajor(k_base, kk),
                   kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs_i<BK / 2>(si);
    // the scores s = si * f (* the key's scale for K3) + shift on the
    // accumulator layout: si[4 i + 2 hr + e] is row r0 + 8 hr, key 8 i + 2
    // quad + e (K5: -inf outside the row's segment)
    const float* shift = sShift + s * BK;
    const float* kst = sKs + s * BK;
    auto score = [&](int i, int hr, int e, float b) {
      if (outside(j0 + 8 * i + 2 * quad + e, hr)) return neg_inf();
      return __fadd_rn(__fmul_rn((float)si[4 * i + 2 * hr + e], f[hr]), b);
    };
    if (AV && t < tiles) {
      // Q8_QKAV's first pass: the row maximum of s over every key
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        const float2 b =
            *reinterpret_cast<const float2*>(shift + 8 * i + 2 * quad);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          m_row[hr] = fmaxf(m_row[hr],
                            fmaxf(score(i, hr, 0, b.x), score(i, hr, 1, b.y)));
      }
      if (t == tiles - 1) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          m_row[hr] = fmaxf(m_row[hr],
                            __shfl_xor_sync(0xffffffffu, m_row[hr], 1));
          m_row[hr] = fmaxf(m_row[hr],
                            __shfl_xor_sync(0xffffffffu, m_row[hr], 2));
        }
      }
      mbar_arrive(&empty[s]);
      continue;
    }
    // P on the accumulator layout, straight to bf16 as the A operand of
    // P V (k-step kk covers key groups 2 kk and 2 kk + 1):
    //   K1, K3: P = exp2(s), the fp32 P summed;
    //   Q8_QK: P = exp2(s), the bf16-rounded P summed (the TPU kernel's
    //     ones column of V);
    //   Q8_QKAV: P = round(exp2(max(s - m, -126)) * 127) (half to even),
    //     an integer 0 .. 127, exact in bf16 and in the sums; a row whose
    //     keys are all masked (m = -inf) takes P = 0
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const float2 b = *reinterpret_cast<const float2*>(shift + 8 * i + 2 * quad);
      float2 kj = make_float2(1.f, 1.f);
      if (!SELF) kj = *reinterpret_cast<const float2*>(kst + 8 * i + 2 * quad);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float x0, x1;
        if constexpr (!K5) {
          const float c0 = SELF ? f[hr] : __fmul_rn(kj.x, f[hr]);
          const float c1 = SELF ? f[hr] : __fmul_rn(kj.y, f[hr]);
          x0 = ex2_sub(
              __fadd_rn(__fmul_rn((float)si[4 * i + 2 * hr], c0), b.x));
          x1 = ex2_sub(
              __fadd_rn(__fmul_rn((float)si[4 * i + 2 * hr + 1], c1), b.y));
          l_run[hr] += x0 + x1;
        } else if constexpr (AV) {
          x0 = score(i, hr, 0, b.x);
          x1 = score(i, hr, 1, b.y);
          const bool dead = m_row[hr] == neg_inf();
          x0 = dead ? 0.f : (float)__float2int_rn(__fmul_rn(
                                ex2_sub(fmaxf(__fsub_rn(x0, m_row[hr]),
                                              -126.f)),
                                127.f));
          x1 = dead ? 0.f : (float)__float2int_rn(__fmul_rn(
                                ex2_sub(fmaxf(__fsub_rn(x1, m_row[hr]),
                                              -126.f)),
                                127.f));
          l_run[hr] += x0 + x1;
        } else {
          x0 = ex2_sub(score(i, hr, 0, b.x));
          x1 = ex2_sub(score(i, hr, 1, b.y));
          l_run[hr] += __bfloat162float(__float2bfloat16(x0)) +
                       __bfloat162float(__float2bfloat16(x1));
        }
        pa[i / 2][2 * (i % 2) + hr] = pack_bf16(x0, x1);
      }
    }
    // O += P V
    const uint32_t v_base = smem_u32(sV + s * BK * D * 2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D>(o, pa[kk], S::mnmajor(v_base, kk, BK));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(o);
    fence_regs_u<BK / 4>(&pa[0][0]);
    mbar_arrive(&empty[s]);
  }

  // normalise by the row sum, stage the warp's 16 rows, write them with
  // 16-byte stores. K1, K3: O times den = 1 / l (0 for a row with l = 0);
  // Q8_QK: O / den, den = max(l, 1e-30); Q8_QKAV: (O / den) vm, den =
  // max(127 l, 1), O and 127 l the int32 sums of the TPU kernel held
  // exactly in fp32 (the ones column of 127)
  float den[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_run[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    den[hr] = AV   ? fmaxf(__fmul_rn(l, 127.f), 1.f)
              : K5 ? fmaxf(l, 1e-30f)
                   : (l > 0.f ? 1.f / l : 0.f);
  }
  const float vm = AV ? p.vsc[z * p.H + h] : 1.f;
  auto norm = [&](float a, int hr) {
    if (AV) return __fmul_rn(__fdiv_rn(a, den[hr]), vm);
    if (K5) return __fdiv_rn(a, den[hr]);
    return a * den[hr];
  };
  bf16* sOw = sO + (wg * 64 + warp * 16) * L::OLD;
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<uint32_t*>(sOw + (r0 + 8 * hr) * L::OLD + 8 * i +
                                   2 * quad) =
          pack_bf16(norm(o[4 * i + 2 * hr], hr),
                    norm(o[4 * i + 2 * hr + 1], hr));
  __syncwarp();
  constexpr int CPR = D * 2 / 16;  // 16-byte chunks a row
  bf16* ob = p.o + z * p.o_s1 + h * D;
  const int qw = q0 + wg * 64 + warp * 16;
#pragma unroll
  for (int it = 0; it < 16 * CPR / 32; ++it) {
    const int idx = it * 32 + lane;
    const int r = idx / CPR, c = idx % CPR;
    if (qw + r < p.Lq)
      *reinterpret_cast<uint4*>(ob + (long long)(qw + r) * p.o_si + c * 8) =
          *reinterpret_cast<const uint4*>(sOw + r * L::OLD + c * 8);
  }
}

// The TMA map of an int8 K or V operand: byte (d, head, key, batch) at d +
// head * D + key * row + batch * batch_stride from base; boxes of D bytes x
// 1 head x BK keys x 1 batch row, swizzled as Sw8<D> (K, wgmma's operand)
// or plain [BK][D] (V, the producer's input)
template <int D>
cudaError_t kv8_map(CUtensorMap* map, const void* base, int H, int Lk,
                    long long nb, long long row, long long batch_stride,
                    bool swizzle) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)Lk,
                              (cuuint64_t)nb};
  // a lone batch row may carry any batch stride; TMA wants a nonzero one
  const cuuint64_t strides[3] = {(cuuint64_t)D, (cuuint64_t)row,
                                 (cuuint64_t)(nb == 1 ? 16 : batch_stride)};
  const cuuint32_t box[4] = {(cuuint32_t)D, 1, (cuuint32_t)Q8_BK, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(base), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      !swizzle   ? CU_TENSOR_MAP_SWIZZLE_NONE
      : D == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : D == 64  ? CU_TENSOR_MAP_SWIZZLE_64B
                 : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// grid: (query tiles, heads, batch rows). 128-row query tiles when there is
// at least one for each of the 132 SMs, else 64; at D = 128 always 64 (two
// warpgroups' tiles pass the 227 KB of shared memory). q and k rows (and head
// offsets) 16-byte aligned; v rows too (fp32 for K1, int8 for K3, TV for
// K5); o rows 16-byte aligned.
template <int D, int MODE, typename TV = float>
cudaError_t launch_attn_sm90_q8(const Q8AttnParams& p, long long B,
                                cudaStream_t s) {
  constexpr bool K5 = MODE >= Q8_QK;
  if (B < 1 || B > 65535 || p.H < 1 || p.H > 65535 || p.Lq < 1 ||
      p.Lk < 1 || p.q_block < 1 || (B > 1 && p.k_s1 <= 0) ||
      (K5 && p.q_cells < 1) || (!K5 && (p.bias || p.seg)) ||
      (MODE == Q8_QKAV && !p.vsc) ||
      (p.seg && (p.seg < 0 || p.Lq != p.Lk || p.Lq % p.seg)))
    return cudaErrorInvalidValue;
  auto misaligned = [](const void* ptr, long long stride, int elem) {
    return ((uintptr_t)ptr % 16) != 0 || (stride * elem) % 16 != 0;
  };
  const int v_elem = MODE == Q8_CACHE ? 1 : MODE == Q8_SELF ? 4
                                                            : (int)sizeof(TV);
  if (misaligned(p.q, p.q_si, 1) || misaligned(p.q, p.q_s1, 1) ||
      misaligned(p.k, p.k_sj, 1) || misaligned(p.k, p.k_s1, 1) ||
      misaligned(p.v, p.v_sj, v_elem) || misaligned(p.v, p.v_s1, v_elem) ||
      misaligned(p.o, p.o_si, 2) || misaligned(p.o, p.o_s1, 2))
    return cudaErrorMisalignedAddress;
  CUtensorMap tk, tv;
  memset(&tk, 0, sizeof(tk));
  memset(&tv, 0, sizeof(tv));
  cudaError_t err = kv8_map<D>(&tk, p.k, p.H, p.Lk, B, p.k_sj, p.k_s1, true);
  if (err == cudaSuccess && MODE == Q8_CACHE)
    err = kv8_map<D>(&tv, p.v, p.H, p.Lk, B, p.v_sj, p.v_s1, false);
  if (err != cudaSuccess) return err;
  const long long tiles128 = (long long)cdiv(p.Lq, 128) * p.H * B;
#define GVF_LAUNCH_SM90_Q8(NWG)                                               \
  {                                                                           \
    constexpr int bytes = Q8Smem<D, NWG>::BYTES;                              \
    auto kern = attn_sm90_q8_kernel<D, NWG, MODE, TV>;                        \
    static bool opted = false; /* the shared-memory opt-in, once */          \
    if (!opted) {                                                             \
      err = cudaFuncSetAttribute(                                             \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);          \
      if (err != cudaSuccess) return err;                                     \
      opted = true;                                                           \
    }                                                                         \
    kern<<<dim3(cdiv(p.Lq, 64 * NWG), p.H, (unsigned)B),                      \
           NWG * 128 + 32 * Q8_NPROD, bytes, s>>>(p, tk, tv);                 \
  }
  if constexpr (D == 128) {
    GVF_LAUNCH_SM90_Q8(1)
  } else if (tiles128 >= 132) {
    GVF_LAUNCH_SM90_Q8(2)
  } else {
    GVF_LAUNCH_SM90_Q8(1)
  }
#undef GVF_LAUNCH_SM90_Q8
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace gvf
