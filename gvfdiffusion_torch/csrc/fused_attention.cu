// K5: softmax attention for Hopper (sm_90a), in the forms its callers run:
// at heads of 64 (bf16), DINOv2's and the sparse-structure flow's self-
// attention, the sparse-structure flow's cross-attention to the image tokens
// (Lq != Lk), and the SLat flow torso's full sparse self-attention, whose key
// validity is a per-key logit bias (-inf on the padding slots); at heads of
// 32 (fp32 in and out), the DiT's composed training path: spatial self-
// attention [48, 512, 16, 32] and the image [48, 512] x [48, 1374] and
// static [48, 512] x [48, 512] cross-attentions; at heads of 128 (fp32),
// the DiT's 4-head configuration.
//
// Replaces the Pallas TPU kernel of gvfdiffusion_tpu/ops/fused_attention.py
// `fused_attention` (bodies `_attn_kernel_dense` / `_attn_kernel`) for heads
// of 32, 64 and 128 (the wrapper zero-pads a head of any other width up to
// 128 to the next of them, which changes neither the scores nor the row
// sums: ops/fused_attention.py), bf16 or fp32 q/k/v and output (the output
// in q's type, as the TPU kernel's), bf16 products with fp32 accumulation,
// an optional fp32 kv_bias, and segment_size (block-diagonal attention over
// packed segments: the core visits only the key tiles of a query tile's
// segments and masks the rest inside them). The backward pass is plain torch (the
// TPU kernel's custom_vjp is XLA einsums, not a kernel).
//
// gvf_attention_q8 is the TPU kernel's int8 body (`_attn_kernel`,
// quant="qk" and "qk+av") in bf16: a pre-pass (quant_kernel below) takes
// the max-abs scales over the TPU kernel's cells, q per (batch row, head,
// block of _lq_block rows), k (and for qk+av v) per (batch row, head) over
// all keys, each floored at 1e-6, and writes int8 q and k; then
// attention_sm90_q8.cuh's int8-QK path (Q8_QK / Q8_QKAV): s8 wgmma for
// the scores, s = si (qm km / 127^2) scale log2 e - (30 - bias log2 e),
// the fixed shift at every head width as the TPU kernel (no running
// maximum: logits beyond about +-90 under- or overflow there as in JAX), P
// rounded to bf16 with the row sum of the rounded P (qk), or (qk+av) two
// passes over the keys, the row maximum m and then P = round(exp2(max(s -
// m, -126)) 127) in 0 .. 127 against V quantized per (batch row, head), the
// products of these integers exact in the tensor cores' fp32 sums. Bound:
// the tensor cores and the SFU's exp2 at DINOv2's shape, the bytes at the
// DiT's.
//
// q is read in place from its own [B, Lq, H, D] rows and k/v from theirs
// (for self-attention the q/k/v views of one [B, L, 3, H, D] qkv
// projection, for cross-attention the k/v views of a [B, Lk, 2, H, D] kv
// projection), each with its batch and row strides (no copies); the output
// is written as [B, Lq, H * D], the layout the output projection reads.
// Every form runs attention_sm90.cuh's core (wgmma, a producer filling a
// ring of 128-key K/V tiles by TMA, or from fp32 with conversion, the
// softmax in registers): P
// rounded to bf16 before P V and the row sum taken from the fp32 P, as the
// TPU kernel's dense branch does, and the ragged key tail masked (Lk = 1374
// = 10 * 128 + 94 at 518^2). Heads of 64 take an online softmax with a true
// running maximum (the TPU kernel's fixed exp2 shift of 30 holds only while
// every scaled logit stays within about +-90, which nothing guarantees for
// a ViT's un-normed q.k; heads of 128 likewise); heads of 32 take the TPU
// kernel's fixed shift (`fixed`), so that the DiT's training path rounds P
// where the reference does. The bias row travels with its K/V tile; a row
// whose keys are all masked gives 0, as the TPU kernel's clamped
// denominator does.
//
// What bounds it on the H100: the tensor cores at DINOv2's [32, 1374, 16,
// 64] (0.247 TFLOP against 360 MB) and the SLat torso's [1, 4096, 16, 64];
// the bytes at the sparse-structure flow's [1, 512, 16, 64] and at every
// fp32 form of the DiT (self: 25.8 GFLOP against 201 MB, 0.060 ms at 3.35
// TB/s). attention_sm90.cuh says what its design does about each.

#include "attention_sm90_q8.cuh"

using namespace gvf;

namespace {

template <int D, typename T, bool FIXED>
cudaError_t launch(const AttnParams& p, int H, int B, cudaStream_t s) {
  return p.seg ? sm90::launch_attn_sm90<D, T, T, T, FIXED, true>(p, H, B, s)
               : sm90::launch_attn_sm90<D, T, T, T, FIXED>(p, H, B, s);
}

// The int8 forms' pre-pass, one block per (cell, head, batch row): over
// the cell's rows [c rows, min(c rows + rows, L)) of head h of x (bf16,
// element (b, i, h, d) at b sb + i sl + h D + d), m = max(max |x|, 1e-6)
// into scale[(b cells + c) H + h]; with dst, xi = round(x 127 / m) (half
// to even: __float2int_rn, as jnp.round) into dst [B, L, H D] int8. The
// TPU kernel pads the rows to its blocks with zeros, which change no
// maximum. D / 8 lanes hold a row, 8 values each (16-byte loads); bound by
// the bytes (x read twice, the second time mostly from L2).
template <int D>
__global__ void __launch_bounds__(256)
    quant_kernel(const bf16* __restrict__ x, long long sb, long long sl,
                 signed char* __restrict__ dst, float* __restrict__ scale,
                 int L, int H, int rows, int cells) {
  constexpr int LPR = D / 8, RPB = 256 / LPR;
  __shared__ float red[8];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = tid / LPR, c8 = (tid % LPR) * 8;
  const int i0 = c * rows, i1 = min(i0 + rows, L);
  const bf16* xb = x + b * sb + h * D + c8;
  float mx = 0.f;
  for (int i = i0 + sub; i < i1; i += RPB) {
    float v[8];
    sm90::load8(xb + (long long)i * sl, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) mx = fmaxf(mx, fabsf(v[e]));
  }
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  if (warp == 0) {
    float v = lane < 8 ? red[lane] : 0.f;
    for (int off = 4; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float m = fmaxf(red[0], 1e-6f);
  if (tid == 0) scale[((long long)b * cells + c) * H + h] = m;
  if (!dst) return;
  const float rcp = __fdiv_rn(127.f, m);
  signed char* db = dst + (long long)b * L * H * D + h * D + c8;
  for (int i = i0 + sub; i < i1; i += RPB) {
    float v[8];
    sm90::load8(xb + (long long)i * sl, v);
    char4 a, bb;
    a.x = (signed char)__float2int_rn(__fmul_rn(v[0], rcp));
    a.y = (signed char)__float2int_rn(__fmul_rn(v[1], rcp));
    a.z = (signed char)__float2int_rn(__fmul_rn(v[2], rcp));
    a.w = (signed char)__float2int_rn(__fmul_rn(v[3], rcp));
    bb.x = (signed char)__float2int_rn(__fmul_rn(v[4], rcp));
    bb.y = (signed char)__float2int_rn(__fmul_rn(v[5], rcp));
    bb.z = (signed char)__float2int_rn(__fmul_rn(v[6], rcp));
    bb.w = (signed char)__float2int_rn(__fmul_rn(v[7], rcp));
    char4* out = reinterpret_cast<char4*>(db + (long long)i * H * D);
    out[0] = a;
    out[1] = bb;
  }
}

cudaError_t launch_quant(const void* x, long long sb, long long sl,
                         void* dst, void* scale, int B, int L, int H, int D,
                         int rows, int cells, cudaStream_t s) {
  if (((uintptr_t)x % 16) || (sl * 2) % 16 || (B > 1 && (sb * 2) % 16))
    return cudaErrorMisalignedAddress;
  const dim3 grid((unsigned)cells, (unsigned)H, (unsigned)B);
  if (D == 32)
    quant_kernel<32><<<grid, 256, 0, s>>>((const bf16*)x, sb, sl,
                                          (signed char*)dst, (float*)scale,
                                          L, H, rows, cells);
  else if (D == 64)
    quant_kernel<64><<<grid, 256, 0, s>>>((const bf16*)x, sb, sl,
                                          (signed char*)dst, (float*)scale,
                                          L, H, rows, cells);
  else
    quant_kernel<128><<<grid, 256, 0, s>>>((const bf16*)x, sb, sl,
                                           (signed char*)dst, (float*)scale,
                                           L, H, rows, cells);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: element (b, i, h, d) at b * q_sb + i * q_sl + h * D + d;
// k, v: element (b, j, h, d) at b * kv_sb + j * kv_sl + h * D + d;
// q, k, v and o all bf16, or all fp32 (io_f32), 16-byte aligned with row
// and batch strides a multiple of 16 bytes; D = 32, 64 or 128 (a head of
// another width arrives zero-padded to one of these, with the scale of its
// own width); bias: fp32 [B, Lk] contiguous, or null; o: [B, Lq, H * D]
// contiguous. fixed: the fixed exp2 shift, which heads of 32 take, or
// (heads of 64 and 128) the running maximum; either way the exponent is S *
// scale_log2 (= scale * log2(e)) plus the bias times log2(e). seg:
// segment_size, or 0 (Lq == Lk, a multiple of seg).
int gvf_attention(const void* q, const void* k, const void* v,
                  const void* bias, void* o, int B, int Lq, int Lk, int H,
                  int D, long long q_sb, long long q_sl, long long kv_sb,
                  long long kv_sl, float scale, float scale_log2, int io_f32,
                  int fixed, int seg, void* stream) {
  if ((D != 32 && D != 64 && D != 128) || (fixed != 0) != (D == 32) ||
      B < 1 || B > 65535 || Lq < 1 || Lk < 1 || H < 1 || H > 65535 ||
      seg < 0)
    return (int)cudaErrorInvalidValue;
  AttnParams p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_s1 = q_sb; p.q_s2 = 0; p.q_si = q_sl;
  p.k_s1 = kv_sb; p.k_s2 = 0; p.k_sj = kv_sl;
  p.o_s1 = (long long)Lq * H * D; p.o_s2 = 0; p.o_si = (long long)H * D;
  p.nb2 = 1; p.Lq = Lq; p.Lk = Lk;
  p.qg = nullptr; p.kg = nullptr;
  p.bias = (const float*)bias; p.bias_s1 = Lk;
  p.scale = scale;
  p.scale_log2 = scale_log2;
  p.seg = seg;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 32)
    return (int)(io_f32 ? launch<32, float, true>(p, H, B, s)
                        : launch<32, bf16, true>(p, H, B, s));
  if (D == 64)
    return (int)(io_f32 ? launch<64, float, false>(p, H, B, s)
                        : launch<64, bf16, false>(p, H, B, s));
  return (int)(io_f32 ? launch<128, float, false>(p, H, B, s)
                      : launch<128, bf16, false>(p, H, B, s));
}

// K5's int8 forms, bf16 q/k/v and o on gvf_attention's strides; bias as
// gvf_attention's; seg: segment_size (0: none; Lq == Lk a multiple of it);
// q_block: the rows of a q scale cell (the TPU kernel's _lq_block); av: 0
// for quant="qk", 1 for "qk+av". Scratch: qi [B, Lq, H * D] and ki [B, Lk,
// H * D] int8, qs [B, cdiv(Lq, q_block), H], ks and vs [B, H] fp32.
int gvf_attention_q8(const void* q, const void* k, const void* v,
                     const void* bias, void* o, void* qi, void* ki, void* qs,
                     void* ks, void* vs, int B, int Lq, int Lk, int H, int D,
                     long long q_sb, long long q_sl, long long kv_sb,
                     long long kv_sl, int q_block, int seg, int av,
                     float scale, void* stream) {
  if ((D != 32 && D != 64 && D != 128) || B < 1 || B > 65535 || Lq < 1 ||
      Lk < 1 || H < 1 || H > 65535 || q_block < 1 || (H * D) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int q_cells = (int)cdiv(Lq, q_block);
  cudaError_t err = launch_quant(q, q_sb, q_sl, qi, qs, B, Lq, H, D, q_block,
                                 q_cells, s);
  if (err == cudaSuccess)
    err = launch_quant(k, kv_sb, kv_sl, ki, ks, B, Lk, H, D, Lk, 1, s);
  if (err == cudaSuccess && av)
    err = launch_quant(v, kv_sb, kv_sl, nullptr, vs, B, Lk, H, D, Lk, 1, s);
  if (err != cudaSuccess) return (int)err;
  sm90::Q8AttnParams p = {};
  p.q = (const signed char*)qi; p.qs = (const float*)qs;
  p.k = (const signed char*)ki; p.ks = (const float*)ks;
  p.v = v; p.o = (bf16*)o;
  p.q_s1 = p.o_s1 = (long long)Lq * H * D; p.q_si = p.o_si = (long long)H * D;
  p.k_s1 = (long long)Lk * H * D; p.k_sj = (long long)H * D;
  p.v_s1 = kv_sb; p.v_sj = kv_sl;
  p.Lq = Lq; p.Lk = Lk; p.H = H; p.q_block = q_block; p.q_cells = q_cells;
  p.scale = scale;
  p.bias = (const float*)bias; p.bias_s1 = Lk;
  p.seg = seg;
  p.vsc = av ? (const float*)vs : nullptr;
  using namespace sm90;
  if (D == 32)
    err = av ? launch_attn_sm90_q8<32, Q8_QKAV, bf16>(p, B, s)
             : launch_attn_sm90_q8<32, Q8_QK, bf16>(p, B, s);
  else if (D == 64)
    err = av ? launch_attn_sm90_q8<64, Q8_QKAV, bf16>(p, B, s)
             : launch_attn_sm90_q8<64, Q8_QK, bf16>(p, B, s);
  else
    err = av ? launch_attn_sm90_q8<128, Q8_QKAV, bf16>(p, B, s)
             : launch_attn_sm90_q8<128, Q8_QK, bf16>(p, B, s);
  return (int)err;
}

}  // extern "C"
