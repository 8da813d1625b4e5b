// The Hopper projection GEMM of the DiT block's chains (fused_sublayer.cu:
// the qkv and gated out projections of K1 and K2, float and int8-QK; the
// q and out projections of K3, bf16 and int8, two contexts and one; K4's
// fc1 and gated fc2):
// out[M, N] = A[M, K] W[N, K]^T + bias, then + res (RESID) or, GATED,
// res + gate[row / rpm] * (acc + bias), or (GELU) gelu_tanh(acc + bias);
// A and W bf16, fp32 accumulation, the epilogue's sums in fp32 in the plain
// versions' order (acc + bias, then the activation or the residual), out
// fp32 or bf16. The float qkv projection of K1 and K2 (QKD) RMS-norms q
// and k per head in fp32 in the epilogue and writes bf16, the operands
// their attention kernels read.
//
// Replaces, on the card, the projections inside the Pallas TPU kernels
// gvfdiffusion_tpu/ops/fused_sublayer.py:344 fused_self_sublayer
// (_self_sublayer_kernel :170: the qkv projection and the gated output),
// :526 fused_temporal_sublayer (_temporal_sublayer_kernel :373: the same
// two), :839 fused_cross_sublayer (_cross_sublayer_kernel :589: q and out)
// and :983 fused_mlp_sublayer (_mlp_sublayer_kernel :881: fc1 with its
// gelu, fc2 with the gated residual).
//
// Design: one CTA per 128 x 128 output tile, two CTAs an SM (3 stages,
// 97 KB of shared memory each, at most 113 registers a thread), so that one
// CTA's epilogue overlaps the other's loads (4 stages at one CTA an SM were
// 10-25% slower at the DiT's shapes, H100 ablation); one producer warp
// keeps the ring of (A, W) tiles of 64 K-columns in flight with TMA
// (128-byte swizzle, zero fill past M, N and K); two consumer warpgroups,
// 64 rows each, accumulate with wgmma.mma_async m64n128k16 from shared
// memory and release a stage once its products have landed; the epilogue
// adds bias, residual and gate straight from the accumulator registers. The
// gated epilogue reads the modulation row of each output row (row / rpm,
// rpm = rows per modulation row: a frame's rows x mod_repeat for K1), so a
// 128-row tile that straddles frames takes each row's own gate.
//
// What bounds it on the H100: at the DiT's K3 shape each projection is
// [16384, 512] x [512, 512]^T, 8.6 GFLOP (8.7 us at 989 TFLOP/s) against
// 34-50 MB of traffic (its fp32 q or residual stream: 10-15 us at 3.35
// TB/s), so the bytes bound it; the qkv projection of K1 and K2 [16384,
// 512] x [1536, 512]^T does 26 GFLOP (26 us) and writes 50 MB of bf16
// q/k/v (15 us; the int8-QK forms 100 MB of fp32, 30 us); K4's fc1 [16384,
// 512] x [2048, 512]^T and fc2 [16384, 2048] x [512, 2048]^T do 34 GFLOP
// each (35 us) against 84 MB (fc1: 67 MB of bf16 hidden out) and 101 MB
// (fc2: the hidden in, the residual in and out), 25-30 us; at
// the SLat torso's [32768, 1024] x [1024, 1024]^T the operations (69
// GFLOP, 70 us) and the bytes (~270 MB, 80 us) come close.

#pragma once

#include "attention_sm90.cuh"

namespace gvf {
namespace sm90 {

constexpr int GM = 128, GN = 128, GK = 64, GSTAGES = 3;

struct GemmSmem {
  static constexpr int A = 0;                           // [GM][GK] bf16
  static constexpr int B = A + GSTAGES * GM * GK * 2;   // [GN][GK] bf16
  static constexpr int BAR = B + GSTAGES * GN * GK * 2;
  static constexpr int BYTES = BAR + 2 * GSTAGES * 8 + 1024;  // + alignment
};

// the MLP's activation: gelu with the tanh approximation, in fp32
__device__ __forceinline__ float gelu_tanh(float v) {
  return 0.5f * v *
         (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
}

// The epilogue's extra operands: GATED's gate rows (row r reads gate row
// r / rpm), QKD's RMS-norm gammas of the q columns [0, cq) and the k
// columns [cq, 2 cq) (null: no norm), as the qkv projection of K1 and K2
// lays them out
struct GemmEpi {
  const bf16* gate = nullptr;
  long long rpm = 1;
  const bf16* qg = nullptr;
  const bf16* kg = nullptr;
  int cq = 0;
};

template <bool RESID, typename TRes, typename TOut, bool GATED, int QKD,
          bool GELU>
__global__ void __launch_bounds__(288, 2)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tw,
                     const bf16* __restrict__ bias,
                     const TRes* __restrict__ res, TOut* __restrict__ out,
                     const GemmEpi epi, long long M, int N, int K) {
  using S = Sw<64>;
  extern __shared__ __align__(1024) unsigned char gsmem_raw[];
  unsigned char* smem =
      gsmem_raw + ((1024 - (smem_u32(gsmem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + GemmSmem::BAR);
  uint64_t* empty = full + GSTAGES;
  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.y * GM;
  const int n0 = blockIdx.x * GN;
  const int ktiles = (K + GK - 1) / GK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warp: lane 0 issues the TMA copies
    if ((tid & 31) == 0) {
      for (int t = 0; t < ktiles; ++t) {
        const int s = t % GSTAGES;
        if (t >= GSTAGES) mbar_wait(&empty[s], ((t / GSTAGES) - 1) & 1);
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                smem_u32(&full[s])),
            "r"((GM + GN) * GK * 2)
            : "memory");
        tma_load_2d(smem_u32(smem + GemmSmem::A + s * GM * GK * 2), &ta,
                    t * GK, (int)m0, &full[s]);
        tma_load_2d(smem_u32(smem + GemmSmem::B + s * GN * GK * 2), &tw,
                    t * GK, n0, &full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: rows m0 + 64 wg .. + 63
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  float acc[GN / 2];
#pragma unroll
  for (int i = 0; i < GN / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < ktiles; ++t) {
    const int s = t % GSTAGES;
    mbar_wait(&full[s], (t / GSTAGES) & 1);
    const uint32_t a = smem_u32(smem + GemmSmem::A + s * GM * GK * 2) +
                       wg * 64 * S::RB;
    const uint32_t b = smem_u32(smem + GemmSmem::B + s * GN * GK * 2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GK / 16; ++kk)
      wgmma_ss<GN>(acc, S::kmajor(a, kk, 64), S::kmajor(b, kk, GN), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<GN / 2>(acc);
    mbar_arrive(&empty[s]);
  }

  // epilogue: acc[4 i + 2 hr + e] is row 16 warp + lane / 4 + 8 hr of the
  // warpgroup's 64, column 8 i + 2 (lane % 4) + e
  const int quad = lane & 3;
  if constexpr (QKD > 0) {
    // K1's qkv: acc + bias, each q or k head (QKD columns: QKD / 8 column
    // groups of the row's quad) RMS-normed in fp32, everything rounded to
    // bf16. A head never straddles the q / k / v boundaries (multiples of
    // cq, itself a multiple of QKD), so a head's gamma is uniform across
    // the warp, and so are the shuffles.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const long long gm = m0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * hr;
      float v[GN / 4];
#pragma unroll
      for (int i = 0; i < GN / 8; ++i) {
        const int gn = n0 + 8 * i + 2 * quad;
        const bool in = gn < N;
        v[2 * i] = acc[4 * i + 2 * hr] + (in ? to_f(bias[gn]) : 0.f);
        v[2 * i + 1] = acc[4 * i + 2 * hr + 1] + (in ? to_f(bias[gn + 1]) : 0.f);
      }
#pragma unroll
      for (int hd = 0; hd < GN / QKD; ++hd) {
        const int col0 = n0 + hd * QKD, part = col0 / epi.cq;
        const bf16* g = part == 0 ? epi.qg : part == 1 ? epi.kg : nullptr;
        if (!g || col0 >= N) continue;
        constexpr int NI = QKD / 8;
        float ss = 0.f;
#pragma unroll
        for (int i = 0; i < NI; ++i)
          ss += v[2 * (hd * NI + i)] * v[2 * (hd * NI + i)] +
                v[2 * (hd * NI + i) + 1] * v[2 * (hd * NI + i) + 1];
        ss += __shfl_xor_sync(0xffffffffu, ss, 1);
        ss += __shfl_xor_sync(0xffffffffu, ss, 2);
        const float f = rsqrtf(ss + 1e-12f);
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int j = hd * NI + i;
          const int gc = n0 + 8 * j + 2 * quad - part * epi.cq;
          v[2 * j] = v[2 * j] * f * to_f(g[gc]);
          v[2 * j + 1] = v[2 * j + 1] * f * to_f(g[gc + 1]);
        }
      }
      if (gm >= M) continue;
#pragma unroll
      for (int i = 0; i < GN / 8; ++i) {
        const int gn = n0 + 8 * i + 2 * quad;
        if (gn < N)
          *reinterpret_cast<uint32_t*>(out + gm * N + gn) =
              pack_bf16(v[2 * i], v[2 * i + 1]);
      }
    }
    return;
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const long long gm = m0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * hr;
    if (gm >= M) continue;
    const bf16* grow = GATED ? epi.gate + (gm / epi.rpm) * N : nullptr;
#pragma unroll
    for (int i = 0; i < GN / 8; ++i) {
      const int gn = n0 + 8 * i + 2 * quad;
      if (gn >= N) continue;  // N is even: both columns or neither
      const long long o = gm * N + gn;
      float v0 = acc[4 * i + 2 * hr] + to_f(bias[gn]);
      float v1 = acc[4 * i + 2 * hr + 1] + to_f(bias[gn + 1]);
      if (GELU) {
        v0 = gelu_tanh(v0);
        v1 = gelu_tanh(v1);
      } else if (GATED) {
        v0 = to_f(res[o]) + v0 * to_f(grow[gn]);
        v1 = to_f(res[o + 1]) + v1 * to_f(grow[gn + 1]);
      } else if (RESID) {
        v0 = to_f(res[o]) + v0;
        v1 = to_f(res[o + 1]) + v1;
      }
      if constexpr (sizeof(TOut) == 4)
        *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
      else
        *reinterpret_cast<uint32_t*>(out + o) = pack_bf16(v0, v1);
    }
  }
}

// The TMA map of a row-major bf16 matrix [rows, cols]: boxes of 64 columns
// x 128 rows, 128-byte swizzle
inline cudaError_t matrix_map(CUtensorMap* map, const void* base,
                              long long rows, int cols) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)GK, (cuuint32_t)GM};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(base), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// out[M, N] = A[M, K] W[N, K]^T + bias (+ res [M, N]; GATED: res + gate
// [M / rpm, N] * (...); QKD: the self sublayers' qkv, q and k normed per
// head of QKD columns, bf16 out; GELU: gelu_tanh(...), bf16 out); A, W
// 16-byte aligned, K and N multiples of 8
template <bool RESID, typename TRes, typename TOut, bool GATED = false,
          int QKD = 0, bool GELU = false>
cudaError_t launch_gemm_sm90(const void* A, const void* W, const void* bias,
                             const TRes* res, TOut* out, long long M, int N,
                             int K, cudaStream_t s, GemmEpi epi = {}) {
  static_assert(QKD == 0 || (sizeof(TOut) == 2 && !RESID && !GATED),
                "the qkv epilogue writes bf16 and adds no residual");
  static_assert(!GELU || (sizeof(TOut) == 2 && !RESID && !GATED && !QKD),
                "the GELU epilogue writes bf16 and adds no residual");
  if (M < 1 || N < 1 || K < 1 || N % 8 || K % 8 || (uintptr_t)A % 16 ||
      (uintptr_t)W % 16 || cdiv(M, GM) > 65535 || epi.rpm < 1 ||
      (GATED && (!epi.gate || !RESID)) ||
      (QKD > 0 && (epi.cq < QKD || epi.cq % QKD)))
    return cudaErrorInvalidValue;
  CUtensorMap ta, tw;
  cudaError_t err = matrix_map(&ta, A, M, K);
  if (err == cudaSuccess) err = matrix_map(&tw, W, N, K);
  if (err != cudaSuccess) return err;
  auto kern = gemm_sm90_kernel<RESID, TRes, TOut, GATED, QKD, GELU>;
  static bool opted = false;  // the shared-memory opt-in, once
  if (!opted) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, GemmSmem::BYTES);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  kern<<<dim3(cdiv(N, GN), cdiv(M, GM)), 288, GemmSmem::BYTES, s>>>(
      ta, tw, (const bf16*)bias, res, out, epi, M, N, K);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The fp32 GEMM of K3's single context at compute_dtype=float32 (its q and
// out projections): out[M, N] = A[M, K] W[N, K]^T + bias (+ res), every
// operand and sum fp32, the products by the 3xTF32 split on the tensor cores
// (attention_sm90.cuh: lo.hi' + hi.lo' + hi.hi', about fp32's precision;
// no TF32 rounding of the result). The operands come split: A and W as
// their hi and lo halves, each an fp32 matrix of tf32 values (the chain's
// LayerNorm and attention write A so, split_tf32_kernel splits W).
//
// Design: gemm_sm90_kernel's, over fp32 tiles: one CTA per 128 x 128
// output tile, one CTA an SM; one producer warp keeps a ring of 3 stages
// of 32-column K tiles of A hi / lo and W hi / lo in flight with TMA
// (128-byte swizzle: rows of 32 fp32 in Sw<64>'s bytes, zero fill past M,
// N and K), 64 KB a stage; two consumer warpgroups of 64 rows issue, per 8
// columns of K, three m64n128k8 tf32 products, a K tile's 12 into a fresh
// accumulator that is then added into the fp32 sum in registers (the
// tensor cores' accumulation over a long chain loses more than fp32 adds:
// attention_sm90_tf32.cuh); the epilogue adds the fp32 bias and residual
// from the registers in the plain version's order (acc + bias, then the
// residual).
//
// What bounds it on the H100: at the torso's [32768, 1024] x [1024, 1024]^T
// the three tf32 products, 206 GFLOP at 495 TFLOP/s (0.42 ms), against 0.4
// GB of traffic (A's halves read, out written: 0.12 ms); in fp32 FFMA the
// same product is 69 GFLOP at 67 TFLOP/s (1.03 ms).

constexpr int TK = 32, TSTAGES = 3;

struct GemmTf32Smem {
  static constexpr int TILE = GM * TK * 4;  // A hi, A lo, W hi, W lo
  static constexpr int STAGE = 4 * TILE;
  static constexpr int BAR = TSTAGES * STAGE;
  static constexpr int BYTES = BAR + 2 * TSTAGES * 8 + 1024;  // + alignment
};

template <bool RESID>
__global__ void __launch_bounds__(288, 1)
    gemm_tf32_kernel(const __grid_constant__ CUtensorMap tah,
                     const __grid_constant__ CUtensorMap tal,
                     const __grid_constant__ CUtensorMap twh,
                     const __grid_constant__ CUtensorMap twl,
                     const float* __restrict__ bias,
                     const float* __restrict__ res, float* __restrict__ out,
                     long long M, int N, int K) {
  using S = Sw<64>;  // 128-byte rows: 32 fp32
  using L = GemmTf32Smem;
  extern __shared__ __align__(1024) unsigned char tsmem_raw[];
  unsigned char* smem =
      tsmem_raw + ((1024 - (smem_u32(tsmem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + TSTAGES;
  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.y * GM;
  const int n0 = blockIdx.x * GN;
  const int ktiles = (K + TK - 1) / TK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < TSTAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warp: lane 0 issues the TMA copies
    if ((tid & 31) == 0) {
      for (int t = 0; t < ktiles; ++t) {
        const int s = t % TSTAGES;
        if (t >= TSTAGES) mbar_wait(&empty[s], ((t / TSTAGES) - 1) & 1);
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                smem_u32(&full[s])),
            "r"(L::STAGE)
            : "memory");
        const uint32_t st = smem_u32(smem + s * L::STAGE);
        tma_load_2d(st, &tah, t * TK, (int)m0, &full[s]);
        tma_load_2d(st + L::TILE, &tal, t * TK, (int)m0, &full[s]);
        tma_load_2d(st + 2 * L::TILE, &twh, t * TK, n0, &full[s]);
        tma_load_2d(st + 3 * L::TILE, &twl, t * TK, n0, &full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: rows m0 + 64 wg .. + 63; each K tile's
  // products go to a fresh accumulator, added into acc in fp32
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  float acc[GN / 2], part[GN / 2];
#pragma unroll
  for (int i = 0; i < GN / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < ktiles; ++t) {
    const int s = t % TSTAGES;
    mbar_wait(&full[s], (t / TSTAGES) & 1);
    const uint32_t st = smem_u32(smem + s * L::STAGE);
    const uint32_t ahi = st + wg * 64 * S::RB, alo = ahi + L::TILE;
    const uint32_t whi = st + 2 * L::TILE, wlo = st + 3 * L::TILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 8; ++kk) {
      wgmma_tf32_ss<GN>(part, S::kmajor(alo, kk, 64), S::kmajor(whi, kk, GN),
                        kk > 0);
      wgmma_tf32_ss<GN>(part, S::kmajor(ahi, kk, 64), S::kmajor(wlo, kk, GN),
                        1);
      wgmma_tf32_ss<GN>(part, S::kmajor(ahi, kk, 64), S::kmajor(whi, kk, GN),
                        1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<GN / 2>(part);
    mbar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < GN / 2; ++i) acc[i] += part[i];
  }

  // epilogue: acc[4 i + 2 hr + e] is row 16 warp + lane / 4 + 8 hr of the
  // warpgroup's 64, column 8 i + 2 (lane % 4) + e
  const int quad = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const long long gm = m0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * hr;
    if (gm >= M) continue;
#pragma unroll
    for (int i = 0; i < GN / 8; ++i) {
      const int gn = n0 + 8 * i + 2 * quad;
      if (gn >= N) continue;  // N is even: both columns or neither
      const long long o = gm * N + gn;
      float v0 = acc[4 * i + 2 * hr] + bias[gn];
      float v1 = acc[4 * i + 2 * hr + 1] + bias[gn + 1];
      if (RESID) {
        v0 += res[o];
        v1 += res[o + 1];
      }
      *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
    }
  }
}

// hi[i] = tf32(x[i]), lo[i] = tf32(x[i] - hi[i]): the split of an fp32
// operand (K3's weights), n a multiple of 4, 16-byte aligned
__global__ void __launch_bounds__(256)
split_tf32_kernel(const float4* __restrict__ x, uint4* __restrict__ hi,
                  uint4* __restrict__ lo, long long n4) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n4;
       i += (long long)gridDim.x * 256) {
    const float4 v = x[i];
    uint4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    hi[i] = h;
    lo[i] = l;
  }
}

inline cudaError_t split_tf32_launch(const float* x, float* hi, float* lo,
                                     long long n, cudaStream_t s) {
  if (n % 4 || (uintptr_t)x % 16 || (uintptr_t)hi % 16 || (uintptr_t)lo % 16)
    return cudaErrorInvalidValue;
  const long long n4 = n / 4;
  const unsigned blocks = (unsigned)(n4 < 132 * 8 * 256 ? cdiv(n4, 256)
                                                          : 132 * 8);
  split_tf32_kernel<<<blocks, 256, 0, s>>>(
      (const float4*)x, (uint4*)hi, (uint4*)lo, n4);
  return cudaGetLastError();
}

// The TMA map of a row-major fp32 matrix [rows, cols]: boxes of 32 columns
// x 128 rows, 128-byte swizzle
inline cudaError_t matrix_map_f32(CUtensorMap* map, const void* base,
                                  long long rows, int cols) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)TK, (cuuint32_t)GM};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                         const_cast<void*>(base), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// out[M, N] = A[M, K] W[N, K]^T + bias (+ res [M, N]), all fp32, A and W
// given split (a_hi + a_lo, w_hi + w_lo); every matrix 16-byte aligned, K a
// multiple of 4, N even
template <bool RESID>
cudaError_t launch_gemm_tf32(const float* a_hi, const float* a_lo,
                             const float* w_hi, const float* w_lo,
                             const float* bias, const float* res, float* out,
                             long long M, int N, int K, cudaStream_t s) {
  if (M < 1 || N < 1 || K < 1 || N % 2 || K % 4 || cdiv(M, GM) > 65535)
    return cudaErrorInvalidValue;
  if ((uintptr_t)a_hi % 16 || (uintptr_t)a_lo % 16 || (uintptr_t)w_hi % 16 ||
      (uintptr_t)w_lo % 16)
    return cudaErrorMisalignedAddress;
  CUtensorMap tah, tal, twh, twl;
  cudaError_t err = matrix_map_f32(&tah, a_hi, M, K);
  if (err == cudaSuccess) err = matrix_map_f32(&tal, a_lo, M, K);
  if (err == cudaSuccess) err = matrix_map_f32(&twh, w_hi, N, K);
  if (err == cudaSuccess) err = matrix_map_f32(&twl, w_lo, N, K);
  if (err != cudaSuccess) return err;
  auto kern = gemm_tf32_kernel<RESID>;
  static bool opted = false;  // the shared-memory opt-in, once
  if (!opted) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               GemmTf32Smem::BYTES);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  kern<<<dim3(cdiv(N, GN), cdiv(M, GM)), 288, GemmTf32Smem::BYTES, s>>>(
      tah, tal, twh, twl, bias, res, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace gvf
