// Fused DiT sublayers for Hopper (sm_90a): the four kernels of the DiT block.
//
// Replaces the Pallas TPU kernels of gvfdiffusion_tpu/ops/fused_sublayer.py:
//   gvf_self_sublayer      <- _self_sublayer_kernel     (fused_self_sublayer)
//   gvf_temporal_sublayer  <- _temporal_sublayer_kernel (fused_temporal_sublayer)
//   gvf_cross_sublayer     <- _cross_sublayer_kernel    (fused_cross_sublayer,
//                                                        two contexts: the DiT)
//   gvf_cross_sublayer1    <- _cross_sublayer_kernel    (one context: the SLat
//                                                        flow torso)
//   gvf_mlp_sublayer       <- _mlp_sublayer_kernel      (fused_mlp_sublayer)
//   gvf_cross_sublayer_q8  <- _cross_sublayer_kernel    (quant=True: the DiT's
//                                                        two contexts against an
//                                                        int8 KV cache)
//   gvf_cross_sublayer1_q8 <- _cross_sublayer_kernel    (quant=True, one
//                                                        context)
//   gvf_self_sublayer_q8   <- _self_sublayer_kernel     (quant_qk=True)
//   gvf_temporal_sublayer_q8 <- _temporal_sublayer_kernel (quant_qk=True)
//
// Each entry point launches a short fixed chain of the kernels below on the
// caller's stream and allocates nothing: the Python wrapper hands in every
// output and scratch buffer.
//
//   ln_kernel      LayerNorm (fp32 statistics, eps 1e-6) + adaLN modulate
//                  (row i reads modulation row i / rows_per_mod) or affine LN,
//                  rounded to bf16 — the GEMM operand, as in the reference.
//   gemm_sm90_kernel (gemm_sm90.cuh; every projection of K1-K4, every
//                  form) wgmma over a TMA ring, with the epilogues +bias,
//                  x + (acc + bias), x + gate * (acc + bias), gelu_tanh(acc
//                  + bias) (K4's fc1) and the float qkv epilogue of K1 and
//                  K2 (q/k RMS norms, bf16 out).
//   attn_sm90_kernel (attention_sm90.cuh; K1's float forms, K3's bf16
//                  forms) the Hopper attention core: wgmma, K/V by TMA
//                  into a ring of swizzled tiles, the online softmax in
//                  registers; K3's q RMS norm in its prologue.
//   attn_sm90_q8_kernel (attention_sm90_q8.cuh; K1's int8-QK forms, K3's
//                  int8 form) the core's int8-QK path: s8 wgmma for the
//                  scores, int8 K by TMA, V converted by the producer.
//   temporal_sm90_kernel (temporal_sm90.cuh; K2, float and int8 QK; K6's
//                  bf16 and fp32 forms from temporal_attention.cu) the
//                  attention over T for many (voxel, head) problems a CTA:
//                  one warp a problem, mma.sync on ldmatrix fragments,
//                  cp.async double-buffered, a persistent grid.
//   q8_kernel      the int8 forms' quantization of q (and k), below.
//
// Head widths: every D that divides 128, the JAX dispatch rules'
// `_LANES % D == 0` (1, 2, 4, 8, 16, 32, 64 and 128), over C a multiple of 8.
// The attention cores and q8_kernel are instantiated at the card widths
// W = 32, 64 and 128: a head of 32 or more runs at its own width, a
// narrower one at 32 (sublayer_width). Such a head arrives zero-padded by
// the Python wrapper in the projections' weights: wqkv's and wq's output
// columns, their biases and the q/k gammas per head, wo's input rows. So
// every buffer that holds heads (the qkv projection, q, the int8 q and k,
// the attention output, K3's caches) is Cp = H W wide, while x, y, h and
// mid stay C wide, and the scale is the true width's, D^-1/2. The zero
// lanes change no RMS norm (the norm divides by no D, and their gammas are
// zero), no score, maximum, row sum or int8 max-abs scale, and the zero
// rows of wo drop the attention's zero lanes: the function is the one at
// width D. Padding in the weights, rather than copying a native
// projection's output into padded buffers, keeps each chain the launches it
// has at 32 with no pad kernel; it costs the head-holding projections W / D
// times their work and bytes (2x at heads of 16, 32x at heads of 1). The
// q/k RMS norm is the JAX kernels' `rms` flag: K1/K2 norm q and k when their gammas are given, K3 norms q
// alone (its cached k was normed when the cache was built), and a null
// gamma means no norm.
//
// What bounds it on the H100: at the DiT's shapes ([1, 32, 512, 512], MLP
// 2048) every chain is a handful of GEMMs bound by the tensor cores or by
// their bytes, and an attention: K1's is 16x heavier than K2's (512 keys
// against T = 32 frames), K4 has none. Each chain passes its
// intermediates through device memory: the modulated LN output (16 MB),
// the qkv projection (50 MB in bf16, 100 MB in fp32 for the int8-QK forms),
// the attention output (16 MB) and K4's hidden (67 MB of bf16, 20 us each
// way at 3.35 TB/s). Fusing K4's two GEMMs would keep a [128, 2048] hidden
// tile of 512 KB on chip, more than an SM's 227 KB of shared memory.
// The TPU kernel's lane-packing of narrow heads onto 128-lane tiles has no
// counterpart here; a 32- or 64-wide head maps straight onto the tensor
// cores' tiles, and K2's 16 voxels x T frames packed into one masked
// [16 T, 16 T] tile become 16 problems of T x T.
// The single-context entry runs the same chain at the SLat torso's shape
// (L = 4096, C = 1024, 16 heads of 64, Lk = 1374): 40.2 GFLOP against
// 27 MB of traffic, so the tensor cores bound it too. The TPU's lq_block /
// kv_buffers sized its VMEM residency and have no counterpart here.
//
// The single-context entry also has an fp32 form (gvf_cross_sublayer1_f32,
// JAX's compute_dtype=float32: TRELLIS as the registry builds it), in which
// no operand is rounded to bf16: the q and out projections are
// gemm_sm90.cuh's fp32 GEMM and the attention attention_sm90_tf32.cuh's
// path of the core, their products by the 3xTF32 split on the tensor cores
// (three tf32 products into short fp32 accumulations, about fp32's
// precision); the affine LN (ln_affine_f32_kernel) and the attention write
// their fp32 results split into the halves the GEMMs read, and
// split_tf32_kernel splits the two weights once a call. Bound at the
// torso's 32768 slots: 3.2e11 fp32 operations, 4.8 ms at the datasheet's 67
// TFLOP/s of fp32 FFMA; as three tf32 products 9.7e11 at 495 TFLOP/s, 2.0
// ms.
//
// The int8 entries keep the TPU kernels' int8 arithmetic (_packed_attention's
// k_int8 and quant_qk branches). q8_kernel quantizes fp32 rows per (cell,
// head) with s = max |q| over the cell's rows and the head's lanes (floored
// at 1e-8), qi = round(q * (127 / s)), where a cell is one TPU grid
// instance: for K3, all L rows of a batch row or the q_block rows the JAX DiT
// grids at the 3-way CFG batch; for K1, one frame; for K2, one batch row x
// 16 voxels x all T frames. Given a gamma it first RMS-normalizes the rows
// in place (the TPU kernel quantizes the normalized fp32 values): q and k
// for K1/K2, q alone for K3. The attention (attn_sm90_q8_kernel for K1 and
// K3, s8 wgmma; temporal_sm90_kernel for K2, mma.sync m16n8k32 s8) takes
// the scores int8 x int8 -> int32 on the tensor cores and P =
// exp2(s - 30) with the fixed shift (no running maximum): for K3 s = si *
// (ks_j * (qs * scale * log2 e / 127)) with a per-key k scale and V
// dequantized to bf16 as bf16(v * vs); for K1/K2 s = si * (qs * ks * scale *
// log2 e / 127^2) with one scalar per (cell, head) and V the fp32 projection
// rounded to bf16. P is rounded to bf16 for P V and the output divided by the
// fp32 row sum. K3's int8 form reads half the cache's bytes of the float
// form; all QK products run at the int8 rate (1,979 TOP/s on the
// datasheet).

#include "attention_sm90_q8.cuh"
#include "attention_sm90_tf32.cuh"
#include "gemm_sm90.cuh"
#include "temporal_sm90.cuh"

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
// The fp32 form's affine LayerNorm (one warp per row, two-pass statistics in
// fp32, eps 1e-6), its fp32 result written split into tf32 halves, hi and
// lo: the A operand of the 3xTF32 q projection.

__global__ void __launch_bounds__(256)
ln_affine_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ hi,
                     float* __restrict__ lo, long long rows, int C) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;  // uniform across the warp
  const float* xr = x + row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += xr[c];
  const float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = xr[c] - mu;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / C + 1e-6f);
  for (int c = lane; c < C; c += 32) {
    uint32_t h, l;
    sm90::split_tf32((xr[c] - mu) * rstd * w[c] + bias[c], h, l);
    hi[row * C + c] = __uint_as_float(h);
    lo[row * C + c] = __uint_as_float(l);
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

// K1-K3's card width for C channels in H heads: the width W the kernels
// run a head of D = C / H at (D from 32 up, 32 below), or 0 for a width
// no dispatch rule admits (D not dividing 128)
inline int sublayer_width(int C, int H) {
  if (H < 1 || C % H) return 0;
  const int D = C / H;
  if (D > 128 || 128 % D) return 0;
  return D < 32 ? 32 : D;
}

// K3's attention (fp32 q, bf16 cache, bf16 out, running maximum) on the
// Hopper core of attention_sm90.cuh at the card width of heads of D,
// with the scale of D
cudaError_t launch_cross_attn(AttnParams p, int H, long long nb1, int D,
                              cudaStream_t s) {
  p.scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  const int W = sublayer_width(D * H, H);
  if (W == 32) return sm90::launch_attn_sm90<32, float, bf16, bf16, false>(p, H, nb1, s);
  if (W == 64) return sm90::launch_attn_sm90<64, float, bf16, bf16, false>(p, H, nb1, s);
  if (W == 128) return sm90::launch_attn_sm90<128, float, bf16, bf16, false>(p, H, nb1, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The int8 forms: K3's int8 cache and K1/K2's int8 QK (at the card widths).

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One block per (cell, head, tensor): qs = max(max |q|, 1e-8) over the
// cell's rows and the head's D lanes, qi = round(q * (127 / qs)) (half to
// even). q is fp32 with a row stride (read in place from the [rows, 3C]
// qkv buffer of the self sublayers); with a gamma it is first RMS-normalized
// per (row, head), q * rsqrt(sum q^2 + 1e-12) * gamma, as the TPU kernel
// does before it quantizes (both passes below norm the row the same way, so
// nothing is written back). Cell c covers the rows
//   (c / cells2) * s1 + (c % cells2) * s2 + t * s_outer + i,
//   t < n_outer, i < n_inner:
// one frame of L rows (K1), 16 voxels x T frames of [B, T, N] (K2), or
// q_block consecutive rows (K3's int8 form). grid.z picks the tensor: q, or
// k with its own gamma, output and scales.
struct QuantParams {
  const float* src[2];     // fp32 rows, src_stride apart
  const bf16* gamma[2];    // [C] gamma * sqrt(D), or null: no RMS norm
  signed char* dst[2];     // int8 rows, dst_stride apart
  float* scale[2];         // [cells, H]
  long long src_stride, dst_stride, s1, s2, s_outer;
  int cells2, n_outer, n_inner, H;
};

// D / 4 lanes hold a row's head lanes, 4 each (16-byte loads), so a warp
// step covers 128 / D rows (one at D = 128, whose row spans the warp); U
// steps' loads are in flight at once. The
// bytes bound it: the cell's fp32 rows read twice (the second time mostly
// from L2), its int8 rows written once.
template <int D>
__global__ void __launch_bounds__(256) q8_kernel(QuantParams p) {
  constexpr int LPR = D / 4, RPW = 32 / LPR, U = 4, STEP = 8 * RPW;
  __shared__ float red[8];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / LPR, c4 = (lane % LPR) * 4;
  const int cell = blockIdx.x, h = blockIdx.y, z = blockIdx.z;
  const long long base = (long long)(cell / p.cells2) * p.s1 +
                         (long long)(cell % p.cells2) * p.s2;
  const int rows = p.n_outer * p.n_inner;
  const float* src = (z ? p.src[1] : p.src[0]) + h * D + c4;
  const bf16* gamma = z ? p.gamma[1] : p.gamma[0];
  float g[4] = {1.f, 1.f, 1.f, 1.f};
  if (gamma) {
#pragma unroll
    for (int e = 0; e < 4; ++e) g[e] = to_f(gamma[h * D + c4 + e]);
  }
  auto row_of = [&](int r) {
    return base + (long long)(r / p.n_inner) * p.s_outer + r % p.n_inner;
  };
  // rows r0 + u STEP + sub, u < U: loaded together, then RMS-normed (the
  // row's LPR lanes reduce by shuffles; every lane of the warp takes part)
  auto load = [&](int r0, float (&v)[U][4]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * STEP + sub;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows)
        a = *reinterpret_cast<const float4*>(src + row_of(r) * p.src_stride);
      v[u][0] = a.x; v[u][1] = a.y; v[u][2] = a.z; v[u][3] = a.w;
    }
    if (gamma) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float ss = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) ss += __fmul_rn(v[u][e], v[u][e]);
#pragma unroll
        for (int o = 1; o < LPR; o <<= 1)
          ss += __shfl_xor_sync(0xffffffffu, ss, o);
        const float f = rsqrtf(ss + 1e-12f);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[u][e] = __fmul_rn(__fmul_rn(v[u][e], f), g[e]);
      }
    }
  };
  float mx = 0.f;
  for (int r0 = warp * RPW; r0 < rows; r0 += STEP * U) {
    float v[U][4];
    load(r0, v);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx = fmaxf(mx, fabsf(v[u][e]));
  }
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  if (warp == 0) {
    float v = lane < 8 ? red[lane] : 0.f;
    v = warp_max(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float s = fmaxf(red[0], 1e-8f);
  const float rcp = __fdiv_rn(127.f, s);
  signed char* dst = (z ? p.dst[1] : p.dst[0]) + h * D + c4;
  for (int r0 = warp * RPW; r0 < rows; r0 += STEP * U) {
    float v[U][4];
    load(r0, v);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * STEP + sub;
      if (r >= rows) continue;
      char4 q;
      q.x = (signed char)__float2int_rn(__fmul_rn(v[u][0], rcp));
      q.y = (signed char)__float2int_rn(__fmul_rn(v[u][1], rcp));
      q.z = (signed char)__float2int_rn(__fmul_rn(v[u][2], rcp));
      q.w = (signed char)__float2int_rn(__fmul_rn(v[u][3], rcp));
      *reinterpret_cast<char4*>(dst + row_of(r) * p.dst_stride) = q;
    }
  }
  if (threadIdx.x == 0)
    (z ? p.scale[1] : p.scale[0])[(long long)cell * p.H + h] = s;
}

cudaError_t launch_q8(const QuantParams& p, int cells, int tensors, int D,
                      cudaStream_t s) {
  const dim3 grid((unsigned)cells, p.H, tensors);
  if (D == 32)
    q8_kernel<32><<<grid, 256, 0, s>>>(p);
  else if (D == 64)
    q8_kernel<64><<<grid, 256, 0, s>>>(p);
  else if (D == 128)
    q8_kernel<128><<<grid, 256, 0, s>>>(p);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

#define GVF_CHECK(call)                  \
  do {                                   \
    cudaError_t err_ = (call);           \
    if (err_ != cudaSuccess) return err_; \
  } while (0)

// q and k of an fp32 [rows, 3C] qkv projection (RMS-normalized first, in
// place, when qg / kg are given, as the TPU kernels quantize the normed
// fp32 values) quantized per (cell of `qp`, head) by q8_kernel: qi, ki int8
// [rows, C], qs, ks fp32 [cells, H]. K1's and K2's int8 QK; C is the
// heads' card width Cp here, C / H a card width.
cudaError_t quantize_qk(float* qkv, const void* qg, const void* kg, void* qi,
                        void* ki, void* qs, void* ks, int C, int H,
                        QuantParams qp, int cells, cudaStream_t s) {
  qp.src[0] = qkv; qp.src[1] = qkv + C;
  qp.gamma[0] = (const bf16*)qg; qp.gamma[1] = (const bf16*)kg;
  qp.dst[0] = (signed char*)qi; qp.dst[1] = (signed char*)ki;
  qp.scale[0] = (float*)qs; qp.scale[1] = (float*)ks;
  qp.src_stride = 3 * C; qp.dst_stride = C; qp.H = H;
  return launch_q8(qp, cells, 2, C / H, s);
}

// The gated out projection of K1, K2 and K4 (fc2) on the Hopper GEMM:
// y = x + gate[row / rpm] * (a w^T + b), a [R, K], w [C, K].
cudaError_t gated_out(const void* x, const void* gate, const void* w,
                      const void* b, const void* a, void* y, long long R,
                      int C, int K, long long rpm, cudaStream_t s) {
  sm90::GemmEpi epi;
  epi.gate = (const bf16*)gate;
  epi.rpm = rpm;
  return sm90::launch_gemm_sm90<true, bf16, bf16, true>(
      a, w, b, (const bf16*)x, (bf16*)y, R, C, K, s, epi);
}

// The float qkv projection of K1 and K2: h [R, C] x wqkv [3 Cp, C]^T ->
// [R, 3 Cp] bf16, q and k RMS-normed per head of W (the card width, Cp =
// H W) in fp32 in the epilogue (null gammas: no norm).
cudaError_t self_qkv(const void* h, const void* wqkv, const void* bqkv,
                     const void* qg, const void* kg, void* qkv, long long R,
                     int C, int Cp, int W, cudaStream_t s) {
  sm90::GemmEpi epi;
  epi.qg = (const bf16*)qg;
  epi.kg = (const bf16*)kg;
  epi.cq = Cp;
  if (W == 32)
    return sm90::launch_gemm_sm90<false, float, bf16, false, 32>(
        h, wqkv, bqkv, nullptr, (bf16*)qkv, R, 3 * Cp, C, s, epi);
  if (W == 64)
    return sm90::launch_gemm_sm90<false, float, bf16, false, 64>(
        h, wqkv, bqkv, nullptr, (bf16*)qkv, R, 3 * Cp, C, s, epi);
  return sm90::launch_gemm_sm90<false, float, bf16, false, 128>(
      h, wqkv, bqkv, nullptr, (bf16*)qkv, R, 3 * Cp, C, s, epi);
}

// K1's float attention at the card width W (bf16 q, k, v and out)
cudaError_t self_attn(const AttnParams& p, int H, long long B, int W,
                      cudaStream_t s) {
  if (W == 32) return sm90::launch_attn_sm90<32, bf16, bf16, bf16, false>(p, H, B, s);
  if (W == 64) return sm90::launch_attn_sm90<64, bf16, bf16, bf16, false>(p, H, B, s);
  return sm90::launch_attn_sm90<128, bf16, bf16, bf16, false>(p, H, B, s);
}

// K3's int8 attention step for one context: q (fp32 [B*L, Cp], RMS-normed
// in place first with qg, or not) quantized per (cell of q_block rows,
// head) by q8_kernel into qi / qs, then the core's int8-QK path against the
// int8 cache k, v [B, lk, Cp] with its scales ks [B, H, lk] and vs [B, lk,
// H], into attn [B*L, Cp] bf16 (Cp = H W: heads of D = C / H at their card
// width W, the scale D^-1/2).
cudaError_t cross_attend_q8(void* q, void* qi, void* qs, void* attn,
                            const void* k, const void* v, const void* ks,
                            const void* vs, int lk, const void* qg, int B,
                            int L, int C, int H, int q_block,
                            cudaStream_t s) {
  const long long R = (long long)B * L;
  const int D = C / H, W = sublayer_width(C, H), Cp = H * W;
  QuantParams qp = {};
  qp.src[0] = (float*)q; qp.dst[0] = (signed char*)qi; qp.scale[0] = (float*)qs;
  qp.gamma[0] = (const bf16*)qg;
  qp.src_stride = qp.dst_stride = Cp;
  qp.s1 = q_block; qp.s_outer = 1;
  qp.cells2 = 1; qp.n_outer = q_block; qp.n_inner = 1; qp.H = H;
  cudaError_t err = launch_q8(qp, (int)(R / q_block), 1, W, s);
  if (err != cudaSuccess) return err;
  sm90::Q8AttnParams p = {};
  p.q = (const signed char*)qi; p.qs = (const float*)qs;
  p.k = (const signed char*)k; p.v = v;
  p.ks_t = (const bf16*)ks; p.vs = (const bf16*)vs; p.o = (bf16*)attn;
  p.q_s1 = p.o_s1 = (long long)L * Cp; p.q_si = p.o_si = Cp;
  p.k_s1 = p.v_s1 = (long long)lk * Cp; p.k_sj = p.v_sj = Cp;
  p.Lq = L; p.Lk = lk; p.H = H; p.q_block = q_block;
  p.scale = (float)(1.0 / sqrt((double)D));
  if (W == 32) return sm90::launch_attn_sm90_q8<32, sm90::Q8_CACHE>(p, B, s);
  if (W == 64) return sm90::launch_attn_sm90_q8<64, sm90::Q8_CACHE>(p, B, s);
  return sm90::launch_attn_sm90_q8<128, sm90::Q8_CACHE>(p, B, s);
}

// K2's attention over T (temporal_sm90.cuh) for heads of D = C / H at
// their card width W (Cp = H W), into o [B, T, N, Cp] bf16: the float form
// (qi null) on the bf16 qkv [B*T*N, 3 Cp] (q and k normed), or the int8-QK
// form on int8 qi, ki [B*T*N, Cp] with their scales qs, ks [B * N / nc, H]
// and v at column 2 Cp of the fp32 qkv
cudaError_t temporal_core(const void* qkv, const void* qi, const void* ki,
                          const void* qs, const void* ks, void* o, int B,
                          int T, int N, int C, int H, int nc,
                          cudaStream_t s) {
  const int W = sublayer_width(C, H);
  if (!W || C % 8) return cudaErrorInvalidValue;
  const int D = C / H, Cp = H * W;
  sm90::TemporalParams p;
  p.o = o;
  p.B = B; p.T = T; p.N = N; p.H = H; p.nc = nc;
  p.scale = (float)(1.0 / sqrt((double)D));
  p.scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  if (qi) {
    p.q = qi; p.k = ki; p.v = (const float*)qkv + 2 * Cp;
    p.q_rs = p.k_rs = Cp; p.v_rs = 3 * Cp;
    p.qs = (const float*)qs; p.ks = (const float*)ks;
    if (W == 32) return sm90::launch_temporal<32, sm90::TForm::Q8>(p, s);
    if (W == 64) return sm90::launch_temporal<64, sm90::TForm::Q8>(p, s);
    return sm90::launch_temporal<128, sm90::TForm::Q8>(p, s);
  }
  const bf16* q = (const bf16*)qkv;
  p.q = q; p.k = q + Cp; p.v = q + 2 * Cp;
  p.q_rs = p.k_rs = p.v_rs = 3 * Cp;
  if (W == 32) return sm90::launch_temporal<32, sm90::TForm::Float>(p, s);
  if (W == 64) return sm90::launch_temporal<64, sm90::TForm::Float>(p, s);
  return sm90::launch_temporal<128, sm90::TForm::Float>(p, s);
}

}  // namespace

extern "C" {

const char* gvf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K1. x, y [B, L, C]; sh/sc/gate [B / mod_repeat, C]; heads of D = C / H
// dividing 128, run at their card width W (Cp = H W; sublayer_width, the
// weights of a head below 32 zero-padded by the caller); wqkv [3 Cp, C];
// wo [C, Cp]; qg/kg [Cp], the q/k RMS-norm gammas, or both null
// (rms=False). Scratch: h [B*L, C] bf16, qkv [B*L, 3 Cp] bf16, attn
// [B*L, Cp] bf16. The qkv projection's epilogue norms q and k in fp32 and
// rounds q, k and v to bf16; the attention is the Hopper core's (K/V by
// TMA, the online softmax with a running maximum) with the scale D^-1/2;
// the out projection's epilogue adds the gated residual.
int gvf_self_sublayer(const void* x, const void* sh, const void* sc,
                      const void* gate, const void* wqkv, const void* bqkv,
                      const void* qg, const void* kg, const void* wo,
                      const void* bo, void* y, void* h, void* qkv, void* attn,
                      int B, int L, int C, int H, int mod_repeat,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long R = (long long)B * L, rpm = (long long)L * mod_repeat;
  const int W = sublayer_width(C, H);
  if (!W || C % 8) return (int)cudaErrorInvalidValue;
  const int D = C / H, Cp = H * W;
  GVF_CHECK((launch_ln<bf16, NORM_MOD>((const bf16*)x, sh, sc, h, R, C, rpm, s)));
  GVF_CHECK(self_qkv(h, wqkv, bqkv, qg, kg, qkv, R, C, Cp, W, s));
  AttnParams p;
  const bf16* q = (const bf16*)qkv;
  p.q = q; p.k = q + Cp; p.v = q + 2 * Cp; p.o = (bf16*)attn;
  p.q_s1 = p.k_s1 = (long long)L * 3 * Cp; p.q_s2 = p.k_s2 = 0;
  p.q_si = p.k_sj = 3 * Cp;
  p.o_s1 = (long long)L * Cp; p.o_s2 = 0; p.o_si = Cp;
  p.nb2 = 1; p.Lq = p.Lk = L;
  p.qg = nullptr; p.kg = nullptr;  // normed in the projection's epilogue
  p.scale = (float)(1.0 / sqrt((double)D));
  p.scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  GVF_CHECK(self_attn(p, H, B, W, s));
  GVF_CHECK(gated_out(x, gate, wo, bo, attn, y, R, C, Cp, rpm, s));
  return 0;
}

// K2. x, y [B, T, N, C]; sh/sc/gate [B, C]; heads, wqkv, wo and qg/kg as
// K1's. Scratch: h [B*T*N, C] bf16, qkv [B*T*N, 3 Cp] bf16, attn
// [B*T*N, Cp] bf16. The qkv projection is K1's (q and k normed in its epilogue, bf16
// out); the attention over T for each (b, n, h) is temporal_sm90.cuh's,
// read and written in place in the [B, T, N, .] rows; the out projection
// is K1's gated one with one modulation row a batch row (rpm = T N).
int gvf_temporal_sublayer(const void* x, const void* sh, const void* sc,
                          const void* gate, const void* wqkv, const void* bqkv,
                          const void* qg, const void* kg, const void* wo,
                          const void* bo, void* y, void* h, void* qkv,
                          void* attn, int B, int T, int N, int C, int H,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long R = (long long)B * T * N, rpm = (long long)T * N;
  const int W = sublayer_width(C, H);
  if (!W || C % 8) return (int)cudaErrorInvalidValue;
  const int Cp = H * W;
  GVF_CHECK((launch_ln<bf16, NORM_MOD>((const bf16*)x, sh, sc, h, R, C, rpm, s)));
  GVF_CHECK(self_qkv(h, wqkv, bqkv, qg, kg, qkv, R, C, Cp, W, s));
  GVF_CHECK(temporal_core(qkv, nullptr, nullptr, nullptr, nullptr, attn, B,
                          T, N, C, H, 1, s));
  GVF_CHECK(gated_out(x, gate, wo, bo, attn, y, R, C, Cp, rpm, s));
  return 0;
}

// K1 quant_qk: as gvf_self_sublayer, with q and k (normed first when qg /
// kg are given) quantized per (frame, head) by q8_kernel and the attention
// on the core's int8-QK path (attention_sm90_q8.cuh), V read from the fp32
// qkv [B*L, 3 Cp] fp32. Extra scratch: qi, ki int8 [B*L, Cp], qs, ks fp32
// [B, H].
int gvf_self_sublayer_q8(const void* x, const void* sh, const void* sc,
                         const void* gate, const void* wqkv, const void* bqkv,
                         const void* qg, const void* kg, const void* wo,
                         const void* bo, void* y, void* h, void* qkv, void* qi,
                         void* ki, void* qs, void* ks, void* attn, int B, int L,
                         int C, int H, int mod_repeat, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long R = (long long)B * L, rpm = (long long)L * mod_repeat;
  const int W = sublayer_width(C, H);
  if (!W || C % 8 || B > 65535) return (int)cudaErrorInvalidValue;
  const int D = C / H, Cp = H * W;
  GVF_CHECK((launch_ln<bf16, NORM_MOD>((const bf16*)x, sh, sc, h, R, C, rpm, s)));
  GVF_CHECK((sm90::launch_gemm_sm90<false, float, float>(
      h, wqkv, bqkv, nullptr, (float*)qkv, R, 3 * Cp, C, s)));
  QuantParams qp = {};
  qp.s1 = L; qp.s_outer = 1; qp.cells2 = 1; qp.n_outer = L; qp.n_inner = 1;
  GVF_CHECK(quantize_qk((float*)qkv, qg, kg, qi, ki, qs, ks, Cp, H, qp, B, s));
  sm90::Q8AttnParams p = {};
  p.q = (const signed char*)qi; p.qs = (const float*)qs;
  p.k = (const signed char*)ki; p.ks = (const float*)ks;
  p.v = (const float*)qkv + 2 * Cp; p.o = (bf16*)attn;
  p.q_s1 = p.k_s1 = p.o_s1 = (long long)L * Cp;
  p.q_si = p.k_sj = p.o_si = Cp;
  p.v_s1 = (long long)L * 3 * Cp; p.v_sj = 3 * Cp;
  p.Lq = p.Lk = L; p.H = H; p.q_block = L;
  p.scale = (float)(1.0 / sqrt((double)D));
  if (W == 32)
    GVF_CHECK((sm90::launch_attn_sm90_q8<32, sm90::Q8_SELF>(p, B, s)));
  else if (W == 64)
    GVF_CHECK((sm90::launch_attn_sm90_q8<64, sm90::Q8_SELF>(p, B, s)));
  else
    GVF_CHECK((sm90::launch_attn_sm90_q8<128, sm90::Q8_SELF>(p, B, s)));
  GVF_CHECK(gated_out(x, gate, wo, bo, attn, y, R, C, Cp, rpm, s));
  return 0;
}

// K2 quant_qk: as gvf_temporal_sublayer; a cell is one batch row x `nc`
// voxels x all T frames (the TPU grid instance), while attention couples
// only the T rows of one voxel: the fp32 qkv projection, q8_kernel, then
// temporal_sm90.cuh's int8-QK path with V read from the fp32 qkv [B*T*N,
// 3 Cp]. Extra scratch: qi, ki int8 [B*T*N, Cp], qs, ks fp32 [B * N / nc,
// H].
int gvf_temporal_sublayer_q8(const void* x, const void* sh, const void* sc,
                             const void* gate, const void* wqkv,
                             const void* bqkv, const void* qg, const void* kg,
                             const void* wo, const void* bo, void* y, void* h,
                             void* qkv, void* qi, void* ki, void* qs, void* ks,
                             void* attn, int B, int T, int N, int C, int H,
                             int nc, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long R = (long long)B * T * N, rpm = (long long)T * N;
  const int W = sublayer_width(C, H);
  if (nc < 1 || N % nc || !W || C % 8) return (int)cudaErrorInvalidValue;
  const int Cp = H * W;
  GVF_CHECK((launch_ln<bf16, NORM_MOD>((const bf16*)x, sh, sc, h, R, C, rpm, s)));
  GVF_CHECK((sm90::launch_gemm_sm90<false, float, float>(
      h, wqkv, bqkv, nullptr, (float*)qkv, R, 3 * Cp, C, s)));
  QuantParams qp = {};
  qp.s1 = (long long)T * N; qp.s2 = nc; qp.s_outer = N;
  qp.cells2 = N / nc; qp.n_outer = T; qp.n_inner = nc;
  GVF_CHECK(quantize_qk((float*)qkv, qg, kg, qi, ki, qs, ks, Cp, H, qp,
                        B * (N / nc), s));
  GVF_CHECK(temporal_core(qkv, qi, ki, qs, ks, attn, B, T, N, C, H, nc, s));
  GVF_CHECK(gated_out(x, gate, wo, bo, attn, y, R, C, Cp, rpm, s));
  return 0;
}

// K2's attention step alone, for the card tests (temporal_core's
// arguments: C and H give the heads' width, the buffers are at its card
// width; qi null: the float form).
int gvf_temporal_attention_sm90(const void* qkv, const void* qi,
                                const void* ki, const void* qs,
                                const void* ks, void* o, int B, int T, int N,
                                int C, int H, int nc, void* stream) {
  return (int)temporal_core(qkv, qi, ki, qs, ks, o, B, T, N, C, H, nc,
                            (cudaStream_t)stream);
}

// K3. x, y [B, L, C]; heads as K1's (Cp = H W); per context i (image,
// then static): affine LN (ns, nb [C]), wq [Cp, C], bq [Cp], qg [Cp] the q
// RMS-norm gamma or null (no norm; the cached k carries its own), wo
// [C, Cp], bo [C], and the cached k, v [B, Lk_i, Cp]. Scratch: h bf16 and
// mid fp32 (the fp32 residual between the two contexts), each [B*L, C]; q
// fp32 and attn bf16, each [B*L, Cp].
int gvf_cross_sublayer(const void* x,
                       const void* ns1, const void* nb1, const void* wq1,
                       const void* bq1, const void* qg1, const void* wo1,
                       const void* bo1, const void* k1, const void* v1, int lk1,
                       const void* ns2, const void* nb2, const void* wq2,
                       const void* bq2, const void* qg2, const void* wo2,
                       const void* bo2, const void* k2, const void* v2, int lk2,
                       void* y, void* h, void* q, void* attn, void* mid, int B,
                       int L, int C, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long R = (long long)B * L;
  const int W = sublayer_width(C, H);
  if (!W || C % 8) return (int)cudaErrorInvalidValue;
  const int D = C / H, Cp = H * W;
  auto attend = [&](const void* k, const void* v, int lk,
                    const void* qg) -> cudaError_t {
    AttnParams p;
    p.q = q; p.k = k; p.v = v; p.o = (bf16*)attn;
    p.q_s1 = (long long)L * Cp; p.q_s2 = 0; p.q_si = Cp;
    p.k_s1 = (long long)lk * Cp; p.k_s2 = 0; p.k_sj = Cp;
    p.o_s1 = (long long)L * Cp; p.o_s2 = 0; p.o_si = Cp;
    p.nb2 = 1; p.Lq = L; p.Lk = lk;
    p.qg = (const bf16*)qg; p.kg = nullptr;
    return launch_cross_attn(p, H, B, D, s);
  };
  GVF_CHECK((launch_ln<bf16, NORM_AFFINE>((const bf16*)x, ns1, nb1, h, R, C, 1, s)));
  GVF_CHECK((sm90::launch_gemm_sm90<false, float, float>(
      h, wq1, bq1, nullptr, (float*)q, R, Cp, C, s)));
  GVF_CHECK(attend(k1, v1, lk1, qg1));
  GVF_CHECK((sm90::launch_gemm_sm90<true, bf16, float>(
      attn, wo1, bo1, (const bf16*)x, (float*)mid, R, C, Cp, s)));
  GVF_CHECK((launch_ln<float, NORM_AFFINE>((const float*)mid, ns2, nb2, h, R, C, 1, s)));
  GVF_CHECK((sm90::launch_gemm_sm90<false, float, float>(
      h, wq2, bq2, nullptr, (float*)q, R, Cp, C, s)));
  GVF_CHECK(attend(k2, v2, lk2, qg2));
  GVF_CHECK((sm90::launch_gemm_sm90<true, float, bf16>(
      attn, wo2, bo2, (const float*)mid, (bf16*)y, R, C, Cp, s)));
  return 0;
}

// K3, one context (the SLat torso's image cross-attention). x, y [B, L, C],
// both bf16 or, with x_f32, both fp32 (the SLat torso's residual stream is
// fp32, as in the JAX package); heads as K1's (Cp = H W); affine LN (ns,
// nb [C]), wq [Cp, C], bq [Cp], wo [C, Cp], bo [C]; the cached k, v rows
// of Cp channels, element (b, j, c) at b * kv_sb + j * kv_sl + c (the k/v
// halves of one [B, Lk, 2C] projection go in place); qg [Cp] bf16, the q
// RMS-norm gamma (rms=True, normed in the attention core's prologue), or
// null; the residual un-gated. Scratch: h bf16 [B*L, C], q fp32 and attn
// bf16 [B*L, Cp].
int gvf_cross_sublayer1(const void* x, const void* ns, const void* nb,
                        const void* wq, const void* bq, const void* qg,
                        const void* wo, const void* bo, const void* k,
                        const void* v, int lk, long long kv_sb,
                        long long kv_sl, void* y, void* h, void* q,
                        void* attn, int B, int L, int C, int H, int x_f32,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long R = (long long)B * L;
  const int W = sublayer_width(C, H);
  if (!W || C % 8) return (int)cudaErrorInvalidValue;
  const int D = C / H, Cp = H * W;
  if (x_f32)
    GVF_CHECK((launch_ln<float, NORM_AFFINE>((const float*)x, ns, nb, h, R, C, 1, s)));
  else
    GVF_CHECK((launch_ln<bf16, NORM_AFFINE>((const bf16*)x, ns, nb, h, R, C, 1, s)));
  GVF_CHECK((sm90::launch_gemm_sm90<false, float, float>(
      h, wq, bq, nullptr, (float*)q, R, Cp, C, s)));
  AttnParams p;
  p.q = q; p.k = k; p.v = v; p.o = (bf16*)attn;
  p.q_s1 = (long long)L * Cp; p.q_s2 = 0; p.q_si = Cp;
  p.k_s1 = kv_sb; p.k_s2 = 0; p.k_sj = kv_sl;
  p.o_s1 = (long long)L * Cp; p.o_s2 = 0; p.o_si = Cp;
  p.nb2 = 1; p.Lq = L; p.Lk = lk;
  p.qg = (const bf16*)qg; p.kg = nullptr;
  GVF_CHECK(launch_cross_attn(p, H, B, D, s));
  if (x_f32)
    GVF_CHECK((sm90::launch_gemm_sm90<true, float, float>(
        attn, wo, bo, (const float*)x, (float*)y, R, C, Cp, s)));
  else
    GVF_CHECK((sm90::launch_gemm_sm90<true, bf16, bf16>(
        attn, wo, bo, (const bf16*)x, (bf16*)y, R, C, Cp, s)));
  return 0;
}

// K3, one context, fp32 (compute_dtype=float32): as gvf_cross_sublayer1 with
// every tensor fp32 (x, y, ns, nb, wq [Cp, C] as [out, in], bq, qg [Cp]
// the q RMS-norm gamma or null, wo [C, Cp], bo, and k, v, rows 16-byte
// aligned), no operand rounded to bf16, the products by the 3xTF32 split,
// q normed in fp32 in the attention's prologue; heads as K1's (Cp = H W).
// Scratch, fp32: h [2, B*L, C] and attn [2, B*L, Cp] (the split halves of
// the LN output and of the attention output), q [B*L, Cp], wsplit
// [4, Cp * C] (wq's halves, then wo's).
int gvf_cross_sublayer1_f32(const void* x, const void* ns, const void* nb,
                            const void* wq, const void* bq, const void* qg,
                            const void* wo, const void* bo, const void* k,
                            const void* v,
                            int lk, long long kv_sb, long long kv_sl, void* y,
                            void* h, void* q, void* attn, void* wsplit, int B,
                            int L, int C, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int W = sublayer_width(C, H);
  if (!W || C % 8 || B > 65535) return (int)cudaErrorInvalidValue;
  const int D = C / H, Cp = H * W;
  const long long R = (long long)B * L, RC = R * C, RCp = R * Cp,
                  CC = (long long)Cp * C;
  float* hs = (float*)h;
  float* as = (float*)attn;
  float* ws = (float*)wsplit;
  GVF_CHECK(sm90::split_tf32_launch((const float*)wq, ws, ws + CC, CC, s));
  GVF_CHECK(sm90::split_tf32_launch((const float*)wo, ws + 2 * CC,
                                    ws + 3 * CC, CC, s));
  ln_affine_f32_kernel<<<cdiv(R, 8), 256, 0, s>>>(
      (const float*)x, (const float*)ns, (const float*)nb, hs, hs + RC, R, C);
  GVF_CHECK(cudaGetLastError());
  GVF_CHECK(sm90::launch_gemm_tf32<false>(hs, hs + RC, ws, ws + CC,
                                          (const float*)bq, nullptr,
                                          (float*)q, R, Cp, C, s));
  AttnParams p;
  p.q = q; p.k = k; p.v = v; p.o = as; p.o_lo = as + RCp;
  p.q_s1 = (long long)L * Cp; p.q_s2 = 0; p.q_si = Cp;
  p.k_s1 = kv_sb; p.k_s2 = 0; p.k_sj = kv_sl;
  p.o_s1 = (long long)L * Cp; p.o_s2 = 0; p.o_si = Cp;
  p.nb2 = 1; p.Lq = L; p.Lk = lk;
  p.qg = nullptr; p.kg = nullptr; p.qg_f32 = (const float*)qg;
  p.scale = (float)(1.0 / sqrt((double)D));
  p.scale_log2 = p.scale * LOG2E;
  if (W == 32)
    GVF_CHECK(sm90::launch_attn_tf32<32>(p, H, B, s));
  else if (W == 64)
    GVF_CHECK(sm90::launch_attn_tf32<64>(p, H, B, s));
  else
    GVF_CHECK(sm90::launch_attn_tf32<128>(p, H, B, s));
  GVF_CHECK(sm90::launch_gemm_tf32<true>(as, as + RCp, ws + 2 * CC,
                                         ws + 3 * CC, (const float*)bo,
                                         (const float*)x, (float*)y, R, C, Cp,
                                         s));
  return 0;
}

// K3, int8 form (quant=True). As gvf_cross_sublayer (heads, weights and
// gammas as its), with per context the int8 cache: k, v [B, Lk_i, Cp]
// int8, ks_t [B, H, Lk_i] and vs [B, Lk_i, H] bf16 scales; q
// RMS-normalized with qg (or not, null) and then quantized per (cell of
// q_block rows, head) by q8_kernel, the attention on the core's int8-QK
// path (attention_sm90_q8.cuh), the projections on the Hopper GEMM as the
// float form's. Scratch: h bf16 and mid fp32, each [B*L, C]; q fp32, qi
// int8 and attn bf16, each [B*L, Cp]; qs fp32 [B*L / q_block, H].
int gvf_cross_sublayer_q8(const void* x,
                          const void* ns1, const void* nb1, const void* wq1,
                          const void* bq1, const void* qg1, const void* wo1,
                          const void* bo1, const void* k1, const void* v1,
                          const void* ks1, const void* vs1, int lk1,
                          const void* ns2, const void* nb2, const void* wq2,
                          const void* bq2, const void* qg2, const void* wo2,
                          const void* bo2, const void* k2, const void* v2,
                          const void* ks2, const void* vs2, int lk2,
                          void* y, void* h, void* q, void* qi, void* qs,
                          void* attn, void* mid, int B, int L, int C, int H,
                          int q_block, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long R = (long long)B * L;
  const int W = sublayer_width(C, H);
  if (!W || C % 8 || q_block < 1 || L % q_block || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int Cp = H * W;
  auto attend = [&](const void* k, const void* v, const void* ks,
                    const void* vs, int lk, const void* qg) -> cudaError_t {
    return cross_attend_q8(q, qi, qs, attn, k, v, ks, vs, lk, qg, B, L, C, H,
                           q_block, s);
  };
  GVF_CHECK((launch_ln<bf16, NORM_AFFINE>((const bf16*)x, ns1, nb1, h, R, C, 1, s)));
  GVF_CHECK((sm90::launch_gemm_sm90<false, float, float>(
      h, wq1, bq1, nullptr, (float*)q, R, Cp, C, s)));
  GVF_CHECK(attend(k1, v1, ks1, vs1, lk1, qg1));
  GVF_CHECK((sm90::launch_gemm_sm90<true, bf16, float>(
      attn, wo1, bo1, (const bf16*)x, (float*)mid, R, C, Cp, s)));
  GVF_CHECK((launch_ln<float, NORM_AFFINE>((const float*)mid, ns2, nb2, h, R, C, 1, s)));
  GVF_CHECK((sm90::launch_gemm_sm90<false, float, float>(
      h, wq2, bq2, nullptr, (float*)q, R, Cp, C, s)));
  GVF_CHECK(attend(k2, v2, ks2, vs2, lk2, qg2));
  GVF_CHECK((sm90::launch_gemm_sm90<true, float, bf16>(
      attn, wo2, bo2, (const float*)mid, (bf16*)y, R, C, Cp, s)));
  return 0;
}

// K3, one context, int8 cache (quant=True with p2 = None): x, y [B, L, C],
// both bf16 or, with x_f32, both fp32; affine LN (ns, nb [C] bf16), wq, bq,
// qg (or null), wo, bo and the heads as gvf_cross_sublayer1's; the int8
// cache k, v [B, lk, Cp] with ks [B, H, lk] and vs [B, lk, H] bf16 scales;
// q quantized per (cell of q_block rows, head) as the two-context form's.
// Scratch: h bf16 [B*L, C]; q fp32, qi int8 and attn bf16, each
// [B*L, Cp]; qs fp32 [B*L / q_block, H].
int gvf_cross_sublayer1_q8(const void* x, const void* ns, const void* nb,
                           const void* wq, const void* bq, const void* qg,
                           const void* wo, const void* bo, const void* k,
                           const void* v, const void* ks, const void* vs,
                           int lk, void* y, void* h, void* q, void* qi,
                           void* qs, void* attn, int B, int L, int C, int H,
                           int q_block, int x_f32, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long R = (long long)B * L;
  const int W = sublayer_width(C, H);
  if (!W || C % 8 || q_block < 1 || L % q_block || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int Cp = H * W;
  if (x_f32)
    GVF_CHECK((launch_ln<float, NORM_AFFINE>((const float*)x, ns, nb, h, R, C, 1, s)));
  else
    GVF_CHECK((launch_ln<bf16, NORM_AFFINE>((const bf16*)x, ns, nb, h, R, C, 1, s)));
  GVF_CHECK((sm90::launch_gemm_sm90<false, float, float>(
      h, wq, bq, nullptr, (float*)q, R, Cp, C, s)));
  GVF_CHECK(cross_attend_q8(q, qi, qs, attn, k, v, ks, vs, lk, qg, B, L, C,
                            H, q_block, s));
  if (x_f32)
    GVF_CHECK((sm90::launch_gemm_sm90<true, float, float>(
        attn, wo, bo, (const float*)x, (float*)y, R, C, Cp, s)));
  else
    GVF_CHECK((sm90::launch_gemm_sm90<true, bf16, bf16>(
        attn, wo, bo, (const bf16*)x, (bf16*)y, R, C, Cp, s)));
  return 0;
}

// K4. x, y [B, L, C]; sh/sc/gate [B / mod_repeat, C]; w1 [M, C]; w2 [C, M].
// Scratch: h [B*L, C] bf16, hid [B*L, M] bf16. fc1 on the Hopper GEMM with
// the GELU epilogue (bf16 hidden), fc2 with the gated residual.
int gvf_mlp_sublayer(const void* x, const void* sh, const void* sc,
                     const void* gate, const void* w1, const void* b1,
                     const void* w2, const void* b2, void* y, void* h,
                     void* hid, int B, int L, int C, int M, int mod_repeat,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long R = (long long)B * L, rpm = (long long)L * mod_repeat;
  GVF_CHECK((launch_ln<bf16, NORM_MOD>((const bf16*)x, sh, sc, h, R, C, rpm, s)));
  GVF_CHECK((sm90::launch_gemm_sm90<false, float, bf16, false, 0, true>(
      h, w1, b1, nullptr, (bf16*)hid, R, M, C, s)));
  GVF_CHECK(gated_out(x, gate, w2, b2, hid, y, R, C, M, rpm, s));
  return 0;
}

}  // extern "C"
