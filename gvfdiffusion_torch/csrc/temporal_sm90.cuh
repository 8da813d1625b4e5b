// The attention over T of K2 (fused_sublayer.cu's temporal sublayer, the
// float and the int8-QK forms) and of K6 (temporal_attention.cu, the DiT's
// composed temporal attention, bf16 and fp32 io) for Hopper (sm_90a):
// softmax attention over the T frames of every (batch row, voxel, head),
// thousands of tiny problems a call.
//
// Replaces, on the card, the attention step of the Pallas TPU kernel
// gvfdiffusion_tpu/ops/fused_sublayer.py:526 fused_temporal_sublayer (body
// _temporal_sublayer_kernel :373, through _packed_attention :75), float and
// quant_qk, and the Pallas TPU kernel gvfdiffusion_tpu/ops/fused_attention.py
// :494 temporal_attention (body _temporal_kernel :427).
//
// What it computes: for each (b, n, h), O = softmax(Q K^T * D^-1/2) V over
// the frames t < T of voxel n, read straight from the rows of q, k and v
// (row (b, t, n) of [B, T, N, .], head h at columns h D .. h D + D - 1,
// each tensor on its own row stride) and written to o [B, T, N, H * D] at
// the same place.
//  - Float form (K2): q, k (RMS-normed by the projection's epilogue) and v
//    arrive in bf16; S in fp32, the online softmax with a true running
//    maximum (exp2 with D^-1/2 log2 e folded in), P rounded to bf16 for
//    P V, the row sum from the fp32 P, the output divided by it once.
//  - Int8 QK (K2): q and k int8 with one scale per (cell, head), a cell
//    being one batch row x nc voxels x all T frames (q8_kernel's); v the
//    fp32 projection rounded to bf16; S = qi ki^T in int32 on the tensor
//    cores, P = exp2(si * (qs ks D^-1/2 log2 e / 127^2) - 30) with the TPU
//    kernel's fixed shift (no maximum) and its scalar roundings; P V and
//    the row sum as the float form's, the sum floored at 1e-30.
//  - Shift forms (K6): q, k and v all bf16 (TForm::Shift) or all fp32
//    (TForm::ShiftF32), rounded to bf16 for the products; S in fp32, P =
//    exp2(S * (scale log2 e) - 30) with the TPU kernel's fixed shift (no
//    maximum, no rescale across key tiles), the row sum from the fp32 P, P
//    rounded to bf16 for P V, the output divided by the sum in the io
//    type. A row whose P all underflow gives 0/0, as the TPU kernel's.
//
// What bounds it on the H100: the bytes. At the DiT's [1, 32, 512, 512]
// with 16 heads of 32 (K2) there are 8192 problems of 32 x 32: q/k/v 50 MB
// in and 16 MB out (20 us at 3.35 TB/s) against 1.1 GFLOP of products (1 us
// at 989 TFLOP/s); K6's training shape [2, 24, 512, 16, 32] fp32 (or 8
// heads of 64) reads 151 MB and writes 50 MB (60 us) for 1.2 GFLOP.
// Hopper's attention core (attention_sm90.cuh) does not fit: its 64- or
// 128-row query tile would be an eighth full, and it pays a TMA
// descriptor, barrier set-up, prologue and epilogue per CTA, 8192 times.
//
// Design: one warp owns one problem at a time, with mma.sync (m16n8k16 bf16,
// or m16n8k32 s8 for the int8 scores) on fragments loaded by ldmatrix; a
// 32 x 32 S is 2 x 4 tiles, and P V takes P from the S accumulators as its
// A operand without a trip through shared memory. No barrier spans more
// than a warp, so a CTA (4 warps) pays no set-up beyond its launch, and a
// persistent grid (as many CTAs as fit on the card) walks the problems in
// the order of the rows: the warps of the card work at any moment on a
// contiguous run of voxels, all heads of each, so the rows they read share
// DRAM pages and L2 lines.
//  - The loads: cp.async, 16 bytes a lane, rows past T zero-filled. Each
//    warp double-buffers: the next item's rows are in flight while the
//    current one computes, and with 1-3 CTAs an SM 4-12 warps keep loads
//    outstanding.
//  - Items: a problem is cut into query blocks of 32 rows x key tiles of 32
//    keys, one item each (T <= 32: one item; the DiT's T = 32 or 24). A
//    longer T loops over key tiles (the running maximum, or the fixed
//    shift's plain sums), so every T runs here (T = 70, T = 1024 at N
//    where the voxel group falls to 1); key tiles are read again from L2
//    for each query block. Keys past T get P = 0 by an explicit test.
//  - Shared memory: per warp two stages of Q, K, V tiles of 32 rows. The
//    16-bit and int8 rows are padded by 16 bytes so that ldmatrix's 8 row
//    reads hit distinct banks. fp32 rows cannot go through ldmatrix (its
//    elements are 16-bit) nor be rounded by cp.async: the fp32 V rows (the
//    int8 form's and K6's) are padded by 4 floats, which makes the per-lane
//    reads of their B fragments conflict-free; K6's fp32 Q and K rows are
//    unpadded with their 16-byte chunks swizzled by the row's parity, and
//    each lane reads one float4 a (row, k-step) and rounds it to two bf16
//    pairs: its columns 4 tig .. 4 tig + 3 of the k-step stand for mma's k
//    indices 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9 on both operands, a
//    permutation of the sum over d. A quarter-warp's float4 reads (rows of
//    both parities) then hit distinct banks. That keeps a warp's two fp32
//    stages at 25 KB at heads of 32 (two CTAs an SM) and 49 KB at heads of
//    64 (one). The output goes back through the finished stage as 16-byte
//    stores (fp32 rows padded by 8 floats, conflict-free float2 writes).
//  - Heads of 128 (K6, and K2 in both forms; a head of another width
//    arrives zero-padded to 32, 64 or 128 by its wrapper): O's accumulators
//    take 128 registers a thread, twice those at 64, and Q's fragments held
//    across the key tiles would take 64 more (32 as int8). So at 128 the
//    warp reads Q's fragments from the stage at each k-step of S instead of
//    holding them, and loads Q's rows with every item (the same rows again
//    when T > 32); the int8 form takes its s8 products there as it does
//    below 128. The fp32 stages take 97 KB a warp there: a CTA holds 2
//    warps (4 elsewhere).

#pragma once

#include "attention_sm90.cuh"

namespace gvf {
namespace sm90 {

constexpr int TQB = 32;     // query rows of an item: two m16 tiles
constexpr int TKB = 32;     // keys of an item: four n8 tiles
constexpr int TWARPS = 4;   // warps a CTA

// K2's float and int8-QK forms; K6's bf16 and fp32 forms (fixed shift)
enum class TForm { Float, Q8, Shift, ShiftF32 };

// q, k, v: the rows of head 0 of row (b, t, n) = (b T + t) N + n start at
// q + row * q_rs (elements; k and v likewise); o [B, T, N, H * D], fp32 for
// TForm::ShiftF32, else bf16. qs, ks: the int8 form's scales [B * N / nc,
// H].
struct TemporalParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_rs, k_rs, v_rs;
  const float* qs = nullptr;
  const float* ks = nullptr;
  int B, T, N, H, nc = 1;
  float scale = 0.f;  // D^-1/2 (the int8 form's)
  float scale_log2;   // scale log2 e, rounded once
};

// Per-warp shared memory: two stages of Q [32][QRB], K [32][QRB] and
// V [32][VRB] (bytes a row); the output is staged at a stage's start as
// [32][ORB].
template <int D, TForm F>
struct TLayout {
  static constexpr bool Q8 = F == TForm::Q8, F32 = F == TForm::ShiftF32;
  // warps a CTA: 2 for fp32 heads of 128, whose stages take 97 KB a warp
  static constexpr int NW = F32 && D == 128 ? 2 : TWARPS;
  // Q's A fragments held across a query block's key tiles (at 128 they are
  // read from the stage at each k-step: O's accumulators fill the registers)
  static constexpr bool QHELD = D < 128;
  static constexpr int ES = Q8 ? 1 : F32 ? 4 : 2;  // bytes of a q / k element
  static constexpr int VS = Q8 || F32 ? 4 : 2;     // of a v element
  static constexpr int OS = F32 ? 4 : 2;           // of an o element
  static constexpr int QRB = F32 ? D * 4 : Q8 ? D + 16 : (D + 8) * 2;
  static constexpr int VRB = VS == 4 ? (D + 4) * 4 : (D + 8) * 2;
  static constexpr int ORB = (D + 8) * OS;
  static constexpr int Q = 0, K = TQB * QRB, V = K + TKB * QRB;
  static constexpr int STAGE = V + TKB * VRB;
  static constexpr int WARP = 2 * STAGE;
  static constexpr int BYTES = NW * WARP;
  // CTAs an SM: 228 KB of shared memory, 1 KB of it reserved a CTA
  static constexpr int CTAS = 233472 / (BYTES + 1024);
  static_assert(TQB * ORB <= STAGE, "the output tile fits a stage");
  static_assert(CTAS >= 1 && BYTES <= 232448, "a CTA fits an SM");
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 32 rows t0 .. t0 + 31 of CH 16-byte chunks each into dst (RB bytes a
// row): row t at src + t * step bytes; rows past T zero-filled. SW: chunk
// c of row r lands at c ^ 4 (r & 1) (K6's unpadded fp32 q / k tiles)
template <int CH, bool SW = false>
__device__ __forceinline__ void load_rows(uint32_t dst, int rb,
                                          const unsigned char* src,
                                          long long step, int t0, int T,
                                          int lane) {
#pragma unroll
  for (int u = 0; u < CH; ++u) {
    const int c = lane + 32 * u, r = c / CH, ch = c % CH, t = t0 + r;
    const int pc = SW ? ch ^ ((r & 1) << 2) : ch;
    const bool ok = t < T;
    cp_async16(dst + r * rb + pc * 16, src + (ok ? t * step : 0) + ch * 16,
               ok);
  }
}

// row r of an fp32 q / k tile (D floats, chunks swizzled as load_rows<.,
// true> lands them): its columns 16 ks + 4 tig .. 16 ks + 4 tig + 3
template <int D>
__device__ __forceinline__ float4 f32_quad(const unsigned char* tile, int r,
                                           int ks, int tig) {
  return *reinterpret_cast<const float4*>(
      tile + r * D * 4 + (((4 * ks + tig) ^ ((r & 1) << 2)) << 4));
}

template <int D, TForm F>
__global__ void
__launch_bounds__(TLayout<D, F>::NW * 32, TLayout<D, F>::CTAS)
    temporal_sm90_kernel(const TemporalParams p) {
  using L = TLayout<D, F>;
  constexpr bool Q8 = L::Q8, F32 = L::F32;
  constexpr bool SHIFT = F != TForm::Float;  // the fixed exp2 shift
  constexpr int ES = L::ES, VS = L::VS, OS = L::OS;
  constexpr int KS = Q8 ? D / 32 : D / 16;  // k-steps of S = Q K^T
  constexpr int DN = D / 8;                 // n8 tiles of O
  extern __shared__ __align__(128) unsigned char tsmem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tig = lane & 3;
  unsigned char* wsm = tsmem + warp * L::WARP;
  const uint32_t wbase = smem_u32(wsm);
  const int T = p.T, N = p.N, H = p.H, C = H * D;
  const long long G = (long long)p.B * N * H;
  const int nqb = (T + TQB - 1) / TQB, nkt = (T + TKB - 1) / TKB;
  const int per = nqb * nkt;
  const long long W = (long long)gridDim.x * L::NW;

  // the rows of problem g: row (b, t, n) = b T N + t N + n
  auto row0_of = [&](long long g, int& h) {
    h = (int)(g % H);
    const long long bn = g / H, n = bn % N, b = bn / N;
    return b * T * N + n;
  };
  auto issue = [&](long long g, int j, int st) {
    int h;
    const long long r0 = row0_of(g, h);
    const int qb = j / nkt, kt = j % nkt;
    const uint32_t sb = wbase + st * L::STAGE;
    const auto* qsrc = (const unsigned char*)p.q + (r0 * p.q_rs + h * D) * ES;
    const auto* ksrc = (const unsigned char*)p.k + (r0 * p.k_rs + h * D) * ES;
    const auto* vsrc = (const unsigned char*)p.v + (r0 * p.v_rs + h * D) * VS;
    if (kt == 0 || !L::QHELD)
      load_rows<D * ES / 16, F32>(sb + L::Q, L::QRB, qsrc, N * p.q_rs * ES,
                                  qb * TQB, T, lane);
    load_rows<D * ES / 16, F32>(sb + L::K, L::QRB, ksrc, N * p.k_rs * ES,
                                kt * TKB, T, lane);
    load_rows<D * VS / 16>(sb + L::V, L::VRB, vsrc, N * p.v_rs * VS,
                           kt * TKB, T, lane);
  };

  // the state of the current query block: Q's A fragments (qf[m16 tile]
  // [k-step]), O's accumulators (o[m16 tile][n8 tile], the layout of
  // mma's C: rows gq and gq + 8, columns 2 tig, 2 tig + 1), the running
  // maximum and the per-thread partial row sums of rows gq + 8 hr
  uint32_t qf[2][L::QHELD ? KS : 1][4];
  float o[2][DN][4];
  float m_run[2][2], l_run[2][2];
  float f8 = 0.f;  // the int8 form's score factor of the problem

  long long g = (long long)blockIdx.x * L::NW + warp;
  int j = 0, st = 0;
  if (g < G) issue(g, 0, 0);
  cp_async_commit();
  while (g < G) {
    long long ng = g;
    int nj = j + 1;
    if (nj == per) {
      nj = 0;
      ng = g + W;
    }
    __syncwarp();  // every lane is done with the stage the next item fills
    if (ng < G) issue(ng, nj, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();  // the current item's rows, every lane's, have landed

    const int qb = j / nkt, kt = j % nkt;
    const uint32_t sb = wbase + st * L::STAGE;
    const unsigned char* ssm = wsm + st * L::STAGE;
    if (kt == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int ks = 0; ks < (L::QHELD ? KS : 0); ++ks) {
          if constexpr (F32) {
            const float4 a = f32_quad<D>(ssm + L::Q, mt * 16 + gq, ks, tig);
            const float4 c =
                f32_quad<D>(ssm + L::Q, mt * 16 + gq + 8, ks, tig);
            qf[mt][ks][0] = pack_bf16(a.x, a.y);
            qf[mt][ks][1] = pack_bf16(c.x, c.y);
            qf[mt][ks][2] = pack_bf16(a.z, a.w);
            qf[mt][ks][3] = pack_bf16(c.z, c.w);
          } else {
            ldsm_x4(sb + L::Q + (mt * 16 + (lane & 15)) * L::QRB +
                        ks * 32 + (lane >> 4) * 16,
                    qf[mt][ks]);
          }
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int dn = 0; dn < DN; ++dn)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[mt][dn][e] = 0.f;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          m_run[mt][hr] = neg_inf();
          l_run[mt][hr] = 0.f;
        }
      }
      if (Q8) {
        // the scale cell of (b, n): b N / nc + n / nc = (b N + n) / nc
        const long long c = (g / H / p.nc) * H + g % H;
        f8 = __fdiv_rn(
            __fmul_rn(__fmul_rn(__fmul_rn(p.qs[c], p.ks[c]), p.scale), LOG2E),
            16129.f);
      }
    }

    // S = Q K^T: s[m16 tile][n8 tile] (int8 QK: si, in int32), keys
    // kt TKB + 8 nt + 2 tig + e
    float s[2][4][4] = {};
    int si[2][4][4] = {};
    if constexpr (L::QHELD) {
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t b[4];  // the B fragments of the n8 tiles 2 jp, 2 jp + 1
          if constexpr (F32) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const float4 x =
                  f32_quad<D>(ssm + L::K, (2 * jp + u) * 8 + gq, ks, tig);
              b[2 * u] = pack_bf16(x.x, x.y);
              b[2 * u + 1] = pack_bf16(x.z, x.w);
            }
          } else {
            ldsm_x4(sb + L::K +
                        (jp * 16 + (lane & 7) + (lane >> 4) * 8) * L::QRB +
                        ks * 32 + ((lane >> 3) & 1) * 16,
                    b);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if constexpr (Q8) {
              mma_s8(si[mt][2 * jp], qf[mt][ks], b[0], b[1]);
              mma_s8(si[mt][2 * jp + 1], qf[mt][ks], b[2], b[3]);
            } else {
              mma_bf16(s[mt][2 * jp], qf[mt][ks], b[0], b[1]);
              mma_bf16(s[mt][2 * jp + 1], qf[mt][ks], b[2], b[3]);
            }
          }
        }
    } else {
      // heads of 128: Q's fragments from the stage at each k-step
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if constexpr (F32) {
            const float4 x = f32_quad<D>(ssm + L::Q, mt * 16 + gq, ks, tig);
            const float4 c =
                f32_quad<D>(ssm + L::Q, mt * 16 + gq + 8, ks, tig);
            a[mt][0] = pack_bf16(x.x, x.y);
            a[mt][1] = pack_bf16(c.x, c.y);
            a[mt][2] = pack_bf16(x.z, x.w);
            a[mt][3] = pack_bf16(c.z, c.w);
          } else {
            ldsm_x4(sb + L::Q + (mt * 16 + (lane & 15)) * L::QRB + ks * 32 +
                        (lane >> 4) * 16,
                    a[mt]);
          }
        }
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t b[4];
          if constexpr (F32) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const float4 x =
                  f32_quad<D>(ssm + L::K, (2 * jp + u) * 8 + gq, ks, tig);
              b[2 * u] = pack_bf16(x.x, x.y);
              b[2 * u + 1] = pack_bf16(x.z, x.w);
            }
          } else {
            ldsm_x4(sb + L::K +
                        (jp * 16 + (lane & 7) + (lane >> 4) * 8) * L::QRB +
                        ks * 32 + ((lane >> 3) & 1) * 16,
                    b);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if constexpr (Q8) {
              mma_s8(si[mt][2 * jp], a[mt], b[0], b[1]);
              mma_s8(si[mt][2 * jp + 1], a[mt], b[2], b[3]);
            } else {
              mma_bf16(s[mt][2 * jp], a[mt], b[0], b[1]);
              mma_bf16(s[mt][2 * jp + 1], a[mt], b[2], b[3]);
            }
          }
        }
      }
    }
    if constexpr (SHIFT) {
      // P = exp2(x - 30), the fixed shift: no maximum, no rescale; x = si
      // f8 (int8 QK) or S (scale log2 e), each product rounded once
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kt * TKB + nt * 8 + 2 * tig + (e & 1);
            const float x = Q8 ? __fmul_rn((float)si[mt][nt][e], f8)
                               : __fmul_rn(s[mt][nt][e], p.scale_log2);
            s[mt][nt][e] = key < T ? exp2f(__fsub_rn(x, EXP2_SHIFT)) : 0.f;
          }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            l_run[mt][hr] += s[mt][nt][2 * hr] + s[mt][nt][2 * hr + 1];
    } else {
      // the online softmax, a row held by the 4 lanes of a quad; every key
      // tile holds a key < T, so the new maximum is finite
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float mx = neg_inf();
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = kt * TKB + nt * 8 + 2 * tig + e;
              float& v = s[mt][nt][2 * hr + e];
              v = key < T ? v * p.scale_log2 : neg_inf();
              mx = fmaxf(mx, v);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_run[mt][hr], mx);
          const float alpha = ex2(m_run[mt][hr] - m_new);
          m_run[mt][hr] = m_new;
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& v = s[mt][nt][2 * hr + e];
              v = ex2(v - m_new);
              sum += v;
            }
          l_run[mt][hr] = l_run[mt][hr] * alpha + sum;
#pragma unroll
          for (int dn = 0; dn < DN; ++dn) {
            o[mt][dn][2 * hr] *= alpha;
            o[mt][dn][2 * hr + 1] *= alpha;
          }
        }
    }

    // O += P V, P (bf16) from the S accumulators: k-step kk covers keys
    // 16 kk .. 16 kk + 15, the n8 tiles 2 kk and 2 kk + 1
#pragma unroll
    for (int kk = 0; kk < TKB / 16; ++kk) {
      uint32_t pa[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
      if constexpr (VS == 4) {
        // V^T fragments from the fp32 rows: b0 keys 16 kk + 2 tig (+1),
        // b1 those + 8, column 8 dn + gq
        const float* vs = reinterpret_cast<const float*>(ssm + L::V);
        constexpr int VF = L::VRB / 4;
#pragma unroll
        for (int dn = 0; dn < DN; ++dn) {
          const float* c = vs + (16 * kk + 2 * tig) * VF + 8 * dn + gq;
          const uint32_t b0 = pack_bf16(c[0], c[VF]);
          const uint32_t b1 = pack_bf16(c[8 * VF], c[9 * VF]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16(o[mt][dn], pa[mt], b0, b1);
        }
      } else {
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t b[4];
          ldsm_x4_t(sb + L::V + (16 * kk + (lane & 15)) * L::VRB +
                        (16 * dp + (lane >> 4) * 8) * 2,
                    b);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(o[mt][2 * dp], pa[mt], b[0], b[1]);
            mma_bf16(o[mt][2 * dp + 1], pa[mt], b[2], b[3]);
          }
        }
      }
    }

    if (kt == nkt - 1) {
      // the query block is done: O / l through the stage (its Q, K and V
      // are consumed) to 16-byte stores of rows < T
      __syncwarp();
      unsigned char* ob = wsm + st * L::STAGE;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float l = l_run[mt][hr];
          l += __shfl_xor_sync(0xffffffffu, l, 1);
          l += __shfl_xor_sync(0xffffffffu, l, 2);
          const float inv = Q8 ? 1.f / fmaxf(l, 1e-30f) : 1.f / l;
          const int r = mt * 16 + gq + 8 * hr;
#pragma unroll
          for (int dn = 0; dn < DN; ++dn) {
            unsigned char* dst = ob + r * L::ORB + (8 * dn + 2 * tig) * OS;
            const float x = o[mt][dn][2 * hr] * inv;
            const float y = o[mt][dn][2 * hr + 1] * inv;
            if constexpr (F32)
              *reinterpret_cast<float2*>(dst) = make_float2(x, y);
            else
              *reinterpret_cast<uint32_t*>(dst) = pack_bf16(x, y);
          }
        }
      __syncwarp();
      int h;
      const long long r0 = row0_of(g, h);
      constexpr int CH = D * OS / 16;
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const int c = lane + 32 * u, r = c / CH, ch = c % CH;
        const int t = qb * TQB + r;
        if (t < T)
          *reinterpret_cast<uint4*>(
              static_cast<unsigned char*>(p.o) +
              ((r0 + (long long)t * N) * C + h * D) * OS + ch * 16) =
              *reinterpret_cast<const uint4*>(ob + r * L::ORB + ch * 16);
      }
    }
    g = ng;
    j = nj;
    st ^= 1;
  }
  cp_async_wait<0>();
}

// heads of 32, 64 or 128; q/k/v rows and their bases 16-byte aligned
template <int D, TForm F>
cudaError_t launch_temporal(const TemporalParams& p, cudaStream_t s) {
  using L = TLayout<D, F>;
  if (p.B < 1 || p.T < 1 || p.N < 1 || p.H < 1 || p.nc < 1 || p.N % p.nc)
    return cudaErrorInvalidValue;
  auto kern = temporal_sm90_kernel<D, F>;
  static int resident = 0;  // CTAs the card holds at once: set once
  if (!resident) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kern, L::NW * 32, L::BYTES);
    if (err != cudaSuccess) return err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long problems = (long long)p.B * p.N * p.H;
  const long long ctas = (problems + L::NW - 1) / L::NW;
  kern<<<(unsigned)(ctas < resident ? ctas : resident), L::NW * 32,
         L::BYTES, s>>>(p);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace gvf
