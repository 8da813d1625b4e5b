// Fused DiT sublayers for Hopper (sm_90a): the four kernels of the DiT block.
//
// Replaces the Pallas TPU kernels of gvfdiffusion_tpu/ops/fused_sublayer.py:
//   gvf_self_sublayer      <- _self_sublayer_kernel     (fused_self_sublayer)
//   gvf_temporal_sublayer  <- _temporal_sublayer_kernel (fused_temporal_sublayer)
//   gvf_cross_sublayer     <- _cross_sublayer_kernel    (fused_cross_sublayer,
//                                                        two contexts: the DiT)
//   gvf_cross_sublayer1    <- _cross_sublayer_kernel    (one context: the SLat
//                                                        flow torso, heads of 64)
//   gvf_mlp_sublayer       <- _mlp_sublayer_kernel      (fused_mlp_sublayer)
//
// Each entry point launches a short fixed chain of the kernels below on the
// caller's stream and allocates nothing: the Python wrapper hands in every
// output and scratch buffer.
//
//   ln_kernel      LayerNorm (fp32 statistics, eps 1e-6) + adaLN modulate
//                  (row i reads modulation row i / rows_per_mod) or affine LN,
//                  rounded to bf16 — the GEMM operand, as in the reference.
//   gemm_kernel    bf16 x bf16 -> fp32 on tensor cores (WMMA 16x16x16), with
//                  fused epilogues: +bias, +bias -> gelu_tanh,
//                  x + gate * (acc + bias), x + (acc + bias).
//   attn_kernel    (attention.cuh) softmax attention for one (query tile,
//                  head, row block):
//                  per-head RMS norm of q/k in the prologue, online softmax
//                  with a true running maximum, fp32 accumulation, masking of
//                  keys past Lk, and strided addressing so the temporal
//                  sublayer attends over T straight in [B, T, N, C].
//
// What bounds it on the H100: at the DiT's shapes the projections are
// tensor-core work (~2 TFLOP per 12-block forward at B*T = 32) and the
// attention ~1 TFLOP, yet the attention kernel holds about three quarters of
// the denoise's device time (profiled on an H100 80GB HBM3 at a 700 W
// limit) and the GEMMs most of the rest; which of its score, online-softmax
// (CUDA cores, per key) and PV steps bounds it is not measured yet. This first
// version keeps every intermediate (q/k/v, attention output, MLP hidden) in
// device memory between the kernels of a chain and uses no wgmma, TMA or
// cp.async pipelining: it is written to be right first.
// The TPU kernel's lane-packing of 32-wide heads onto 128-lane tiles has no
// counterpart here; a 32-wide head maps straight onto 16x16 tensor-core tiles.
// The single-context entry runs the same chain at the SLat torso's shape
// (L = 4096, C = 1024, 16 heads of 64, Lk = 1374): 40.2 GFLOP against
// 27 MB of traffic, so the tensor cores bound it too. The TPU's lq_block /
// kv_buffers sized its VMEM residency and have no counterpart here.

#include "attention.cuh"

namespace {

using namespace gvf;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// LayerNorm + modulate / affine prologue: one warp per row.

enum { NORM_MOD = 0, NORM_AFFINE = 1 };

// MODE == NORM_MOD:    out = LN(x) * (1 + p1[m]) + p0[m], m = row / rows_per_mod
//                      (p0 = shift, p1 = scale, both [rows / rows_per_mod, C])
// MODE == NORM_AFFINE: out = LN(x) * p0 + p1 (p0 = weight, p1 = bias, [C])
template <typename TIn, int MODE>
__global__ void __launch_bounds__(256)
ln_kernel(const TIn* __restrict__ x, const bf16* __restrict__ p0,
          const bf16* __restrict__ p1, bf16* __restrict__ out, long long rows,
          int C, long long rows_per_mod) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;  // uniform across the warp
  const TIn* xr = x + row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f(xr[c]);
  const float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f(xr[c]) - mu;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / C + 1e-6f);
  bf16* orow = out + row * C;
  if (MODE == NORM_MOD) {
    const long long m = row / rows_per_mod;
    const bf16* sh = p0 + m * C;
    const bf16* sc = p1 + m * C;
    for (int c = lane; c < C; c += 32) {
      const float h = (to_f(xr[c]) - mu) * rstd;
      orow[c] = __float2bfloat16(h * (1.f + to_f(sc[c])) + to_f(sh[c]));
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      const float h = (to_f(xr[c]) - mu) * rstd;
      orow[c] = __float2bfloat16(h * to_f(p0[c]) + to_f(p1[c]));
    }
  }
}

// ---------------------------------------------------------------------------
// Tiled GEMM: out[M, N] = epi(A[M, K] @ W[N, K]^T). W is an nn.Linear weight
// ([out, in], K contiguous). 128x128x32 block tile, 8 warps of 32x64.

enum { EPI_BIAS = 0, EPI_GELU = 1, EPI_GATED = 2, EPI_RESID = 3 };

constexpr int GBM = 128, GBN = 128, GBK = 32, GLD = GBK + 8;

__device__ __forceinline__ float gelu_tanh(float v) {
  return 0.5f * v *
         (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
}

template <int EPI, typename TRes, typename TOut>
__global__ void __launch_bounds__(256)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
            const bf16* __restrict__ bias, const TRes* __restrict__ res,
            const bf16* __restrict__ gate, TOut* __restrict__ out, long long M,
            int N, int K, long long rows_per_mod) {
  __shared__ __align__(128) bf16 sA[GBM * GLD];
  __shared__ __align__(128) bf16 sB[GBN * GLD];
  __shared__ __align__(128) float sE[8][16 * 16];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const long long m0 = (long long)blockIdx.y * GBM;
  const int n0 = blockIdx.x * GBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += GBK) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int idx = tid + it * 256;  // 512 chunks of 8 bf16 per operand
      const int r = idx >> 2, kc = (idx & 3) * 8;
      const int gk = k0 + kc;
      uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = va;
      const long long gm = m0 + r;
      const int gn = n0 + r;
      if (gm < M && gk < K)
        va = *reinterpret_cast<const uint4*>(A + gm * K + gk);
      if (gn < N && gk < K)
        vb = *reinterpret_cast<const uint4*>(W + (long long)gn * K + gk);
      *reinterpret_cast<uint4*>(sA + r * GLD + kc) = va;
      *reinterpret_cast<uint4*>(sB + r * GLD + kc) = vb;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], sA + (wm * 32 + i * 16) * GLD + kk, GLD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], sB + (wn * 64 + j * 16) * GLD + kk, GLD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* e = sE[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(e, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int el = lane * 8 + t;
        const long long gm = m0 + wm * 32 + i * 16 + (el >> 4);
        const int gn = n0 + wn * 64 + j * 16 + (el & 15);
        if (gm < M && gn < N) {
          float v = e[el] + to_f(bias[gn]);
          const long long o = gm * N + gn;
          if (EPI == EPI_GELU) v = gelu_tanh(v);
          if (EPI == EPI_GATED)
            v = to_f(res[o]) + v * to_f(gate[(gm / rows_per_mod) * N + gn]);
          if (EPI == EPI_RESID) v = to_f(res[o]) + v;
          out[o] = from_f<TOut>(v);
        }
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// launch helpers

template <typename TIn, int MODE>
cudaError_t launch_ln(const TIn* x, const void* p0, const void* p1, void* out,
                      long long rows, int C, long long rows_per_mod,
                      cudaStream_t s) {
  ln_kernel<TIn, MODE><<<cdiv(rows, 8), 256, 0, s>>>(
      x, (const bf16*)p0, (const bf16*)p1, (bf16*)out, rows, C, rows_per_mod);
  return cudaGetLastError();
}

template <int EPI, typename TRes, typename TOut>
cudaError_t launch_gemm(const void* A, const void* W, const void* bias,
                        const TRes* res, const void* gate, TOut* out,
                        long long M, int N, int K, long long rows_per_mod,
                        cudaStream_t s) {
  dim3 grid(cdiv(N, GBN), cdiv(M, GBM));
  gemm_kernel<EPI, TRes, TOut><<<grid, 256, 0, s>>>(
      (const bf16*)A, (const bf16*)W, (const bf16*)bias, res,
      (const bf16*)gate, out, M, N, K, rows_per_mod);
  return cudaGetLastError();
}

// the DiT's head width
template <typename TQ, typename TKV>
cudaError_t launch_attn32(const AttnParams& p, int H, long long nb1, int D,
                          cudaStream_t s) {
  if (D != 32) return cudaErrorInvalidValue;
  return launch_attn<32, TQ, TKV>(p, H, nb1, s);
}

// the SLat torso's head width
template <typename TQ, typename TKV>
cudaError_t launch_attn64(const AttnParams& p, int H, long long nb1, int D,
                          cudaStream_t s) {
  if (D != 64) return cudaErrorInvalidValue;
  return launch_attn<64, TQ, TKV>(p, H, nb1, s);
}

#define GVF_CHECK(call)                  \
  do {                                   \
    cudaError_t err_ = (call);           \
    if (err_ != cudaSuccess) return err_; \
  } while (0)

}  // namespace

extern "C" {

const char* gvf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K1. x, y [B, L, C]; sh/sc/gate [B / mod_repeat, C]; wqkv [3C, C];
// wo [C, C]; qg/kg [C], the q/k RMS-norm gammas. Scratch: h [B*L, C] bf16,
// qkv [B*L, 3C] fp32, attn [B*L, C] bf16.
int gvf_self_sublayer(const void* x, const void* sh, const void* sc,
                      const void* gate, const void* wqkv, const void* bqkv,
                      const void* qg, const void* kg, const void* wo,
                      const void* bo, void* y, void* h, void* qkv, void* attn,
                      int B, int L, int C, int H, int mod_repeat,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long R = (long long)B * L, rpm = (long long)L * mod_repeat;
  const int D = C / H;
  GVF_CHECK((launch_ln<bf16, NORM_MOD>((const bf16*)x, sh, sc, h, R, C, rpm, s)));
  GVF_CHECK((launch_gemm<EPI_BIAS, float, float>(h, wqkv, bqkv, nullptr, nullptr,
                                                 (float*)qkv, R, 3 * C, C, 1, s)));
  AttnParams p;
  const float* q = (const float*)qkv;
  p.q = q; p.k = q + C; p.v = q + 2 * C; p.o = (bf16*)attn;
  p.q_s1 = p.k_s1 = (long long)L * 3 * C; p.q_s2 = p.k_s2 = 0;
  p.q_si = p.k_sj = 3 * C;
  p.o_s1 = (long long)L * C; p.o_s2 = 0; p.o_si = C;
  p.nb2 = 1; p.Lq = p.Lk = L;
  p.qg = (const bf16*)qg;
  p.kg = (const bf16*)kg;
  p.scale = (float)(1.0 / sqrt((double)D));
  GVF_CHECK((launch_attn32<float, float>(p, H, B, D, s)));
  GVF_CHECK((launch_gemm<EPI_GATED, bf16, bf16>(attn, wo, bo, (const bf16*)x, gate,
                                                (bf16*)y, R, C, C, rpm, s)));
  return 0;
}

// K2. x, y [B, T, N, C]; sh/sc/gate [B, C]; attention over T for each (b, n),
// read and written in place in the [B, T, N, C] layout.
int gvf_temporal_sublayer(const void* x, const void* sh, const void* sc,
                          const void* gate, const void* wqkv, const void* bqkv,
                          const void* qg, const void* kg, const void* wo,
                          const void* bo, void* y, void* h, void* qkv,
                          void* attn, int B, int T, int N, int C, int H,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long R = (long long)B * T * N, rpm = (long long)T * N;
  const int D = C / H;
  GVF_CHECK((launch_ln<bf16, NORM_MOD>((const bf16*)x, sh, sc, h, R, C, rpm, s)));
  GVF_CHECK((launch_gemm<EPI_BIAS, float, float>(h, wqkv, bqkv, nullptr, nullptr,
                                                 (float*)qkv, R, 3 * C, C, 1, s)));
  AttnParams p;
  const float* q = (const float*)qkv;
  p.q = q; p.k = q + C; p.v = q + 2 * C; p.o = (bf16*)attn;
  p.q_s1 = p.k_s1 = (long long)T * N * 3 * C; p.q_s2 = p.k_s2 = 3 * C;
  p.q_si = p.k_sj = (long long)N * 3 * C;
  p.o_s1 = (long long)T * N * C; p.o_s2 = C; p.o_si = (long long)N * C;
  p.nb2 = N; p.Lq = p.Lk = T;
  p.qg = (const bf16*)qg;
  p.kg = (const bf16*)kg;
  p.scale = (float)(1.0 / sqrt((double)D));
  GVF_CHECK((launch_attn32<float, float>(p, H, B, D, s)));
  GVF_CHECK((launch_gemm<EPI_GATED, bf16, bf16>(attn, wo, bo, (const bf16*)x, gate,
                                                (bf16*)y, R, C, C, rpm, s)));
  return 0;
}

// K3. x, y [B, L, C]; per context i (image, then static): affine LN
// (ns, nb [C]), wq [C, C], bq, wo [C, C], bo, and the cached k, v
// [B, Lk_i, C]; no RMS norm. Scratch: h bf16, q fp32, attn bf16, mid fp32
// (the fp32 residual between the two contexts), each [B*L, C].
int gvf_cross_sublayer(const void* x,
                       const void* ns1, const void* nb1, const void* wq1,
                       const void* bq1, const void* wo1, const void* bo1,
                       const void* k1, const void* v1, int lk1,
                       const void* ns2, const void* nb2, const void* wq2,
                       const void* bq2, const void* wo2, const void* bo2,
                       const void* k2, const void* v2, int lk2,
                       void* y, void* h, void* q, void* attn, void* mid, int B,
                       int L, int C, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long R = (long long)B * L;
  const int D = C / H;
  auto attend = [&](const void* k, const void* v, int lk) -> cudaError_t {
    AttnParams p;
    p.q = q; p.k = k; p.v = v; p.o = (bf16*)attn;
    p.q_s1 = (long long)L * C; p.q_s2 = 0; p.q_si = C;
    p.k_s1 = (long long)lk * C; p.k_s2 = 0; p.k_sj = C;
    p.o_s1 = (long long)L * C; p.o_s2 = 0; p.o_si = C;
    p.nb2 = 1; p.Lq = L; p.Lk = lk;
    p.qg = nullptr; p.kg = nullptr;
    p.scale = (float)(1.0 / sqrt((double)D));
    return launch_attn32<float, bf16>(p, H, B, D, s);
  };
  GVF_CHECK((launch_ln<bf16, NORM_AFFINE>((const bf16*)x, ns1, nb1, h, R, C, 1, s)));
  GVF_CHECK((launch_gemm<EPI_BIAS, float, float>(h, wq1, bq1, nullptr, nullptr,
                                                 (float*)q, R, C, C, 1, s)));
  GVF_CHECK(attend(k1, v1, lk1));
  GVF_CHECK((launch_gemm<EPI_RESID, bf16, float>(attn, wo1, bo1, (const bf16*)x,
                                                 nullptr, (float*)mid, R, C, C, 1, s)));
  GVF_CHECK((launch_ln<float, NORM_AFFINE>((const float*)mid, ns2, nb2, h, R, C, 1, s)));
  GVF_CHECK((launch_gemm<EPI_BIAS, float, float>(h, wq2, bq2, nullptr, nullptr,
                                                 (float*)q, R, C, C, 1, s)));
  GVF_CHECK(attend(k2, v2, lk2));
  GVF_CHECK((launch_gemm<EPI_RESID, float, bf16>(attn, wo2, bo2, (const float*)mid,
                                                 nullptr, (bf16*)y, R, C, C, 1, s)));
  return 0;
}

// K3, one context (the SLat torso's image cross-attention). x, y [B, L, C],
// both bf16 or, with x_f32, both fp32 (the SLat torso's residual stream is
// fp32, as in the JAX package); affine LN (ns, nb [C]), wq [C, C], bq,
// wo [C, C], bo; the cached k, v rows with heads of 64, element (b, j, c)
// at b * kv_sb + j * kv_sl + c (the k/v halves of one [B, Lk, 2C]
// projection go in place); no RMS norm; the residual un-gated. Scratch:
// h bf16, q fp32, attn bf16, each [B*L, C].
int gvf_cross_sublayer1(const void* x, const void* ns, const void* nb,
                        const void* wq, const void* bq, const void* wo,
                        const void* bo, const void* k, const void* v, int lk,
                        long long kv_sb, long long kv_sl, void* y, void* h,
                        void* q, void* attn, int B, int L, int C, int H,
                        int x_f32, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long R = (long long)B * L;
  const int D = C / H;
  if (x_f32)
    GVF_CHECK((launch_ln<float, NORM_AFFINE>((const float*)x, ns, nb, h, R, C, 1, s)));
  else
    GVF_CHECK((launch_ln<bf16, NORM_AFFINE>((const bf16*)x, ns, nb, h, R, C, 1, s)));
  GVF_CHECK((launch_gemm<EPI_BIAS, float, float>(h, wq, bq, nullptr, nullptr,
                                                 (float*)q, R, C, C, 1, s)));
  AttnParams p;
  p.q = q; p.k = k; p.v = v; p.o = (bf16*)attn;
  p.q_s1 = (long long)L * C; p.q_s2 = 0; p.q_si = C;
  p.k_s1 = kv_sb; p.k_s2 = 0; p.k_sj = kv_sl;
  p.o_s1 = (long long)L * C; p.o_s2 = 0; p.o_si = C;
  p.nb2 = 1; p.Lq = L; p.Lk = lk;
  p.qg = nullptr; p.kg = nullptr;
  p.scale = (float)(1.0 / sqrt((double)D));
  GVF_CHECK((launch_attn64<float, bf16>(p, H, B, D, s)));
  if (x_f32)
    GVF_CHECK((launch_gemm<EPI_RESID, float, float>(attn, wo, bo, (const float*)x,
                                                    nullptr, (float*)y, R, C, C, 1, s)));
  else
    GVF_CHECK((launch_gemm<EPI_RESID, bf16, bf16>(attn, wo, bo, (const bf16*)x,
                                                  nullptr, (bf16*)y, R, C, C, 1, s)));
  return 0;
}

// K4. x, y [B, L, C]; sh/sc/gate [B / mod_repeat, C]; w1 [M, C]; w2 [C, M].
// Scratch: h [B*L, C] bf16, hid [B*L, M] bf16.
int gvf_mlp_sublayer(const void* x, const void* sh, const void* sc,
                     const void* gate, const void* w1, const void* b1,
                     const void* w2, const void* b2, void* y, void* h,
                     void* hid, int B, int L, int C, int M, int mod_repeat,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long R = (long long)B * L, rpm = (long long)L * mod_repeat;
  GVF_CHECK((launch_ln<bf16, NORM_MOD>((const bf16*)x, sh, sc, h, R, C, rpm, s)));
  GVF_CHECK((launch_gemm<EPI_GELU, float, bf16>(h, w1, b1, nullptr, nullptr,
                                                (bf16*)hid, R, M, C, 1, s)));
  GVF_CHECK((launch_gemm<EPI_GATED, bf16, bf16>(hid, w2, b2, (const bf16*)x, gate,
                                                (bf16*)y, R, C, M, rpm, s)));
  return 0;
}

}  // extern "C"
