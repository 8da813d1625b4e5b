// K5: softmax attention for Hopper (sm_90a), in the forms its callers run:
// at heads of 64 (bf16), DINOv2's and the sparse-structure flow's self-
// attention, the sparse-structure flow's cross-attention to the image tokens
// (Lq != Lk), and the SLat flow torso's full sparse self-attention, whose key
// validity is a per-key logit bias (-inf on the padding slots); at heads of
// 32 (fp32 in and out), the DiT's composed training path: spatial self-
// attention [48, 512, 16, 32] and the image [48, 512] x [48, 1374] and
// static [48, 512] x [48, 512] cross-attentions.
//
// Replaces the Pallas TPU kernel of gvfdiffusion_tpu/ops/fused_attention.py
// `fused_attention` (bodies `_attn_kernel_dense` / `_attn_kernel`) for heads
// of 32 and 64, bf16 or fp32 q/k/v and output (the output in q's type, as the
// TPU kernel's), bf16 products with fp32 accumulation, an optional fp32
// kv_bias; no segments, no int8. The backward pass is plain torch (the TPU
// kernel's custom_vjp is XLA einsums, not a kernel).
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
// a ViT's un-normed q.k); heads of 32 take the TPU kernel's fixed shift
// (`fixed`), so that the DiT's training path rounds P where the reference
// does. The bias row travels with its K/V tile; a row whose keys are all
// masked gives 0, as the TPU kernel's clamped denominator does.
//
// What bounds it on the H100: the tensor cores at DINOv2's [32, 1374, 16,
// 64] (0.247 TFLOP against 360 MB) and the SLat torso's [1, 4096, 16, 64];
// the bytes at the sparse-structure flow's [1, 512, 16, 64] and at every
// fp32 form of the DiT (self: 25.8 GFLOP against 201 MB, 0.060 ms at 3.35
// TB/s). attention_sm90.cuh says what its design does about each.

#include "attention_sm90.cuh"

using namespace gvf;

namespace {

template <int D, typename T, bool FIXED>
cudaError_t launch(const AttnParams& p, int H, int B, cudaStream_t s) {
  return sm90::launch_attn_sm90<D, T, T, T, FIXED>(p, H, B, s);
}

}  // namespace

extern "C" {

// q: element (b, i, h, d) at b * q_sb + i * q_sl + h * D + d;
// k, v: element (b, j, h, d) at b * kv_sb + j * kv_sl + h * D + d;
// q, k, v and o all bf16, or all fp32 (io_f32), 16-byte aligned with row
// and batch strides a multiple of 16 bytes; D = 32 or 64;
// bias: fp32 [B, Lk] contiguous, or null; o: [B, Lq, H * D] contiguous.
// fixed: the fixed exp2 shift, which heads of 32 take, or (heads of 64) the
// running maximum; either way the exponent is S * scale_log2 (= scale *
// log2(e)) plus the bias times log2(e).
int gvf_attention(const void* q, const void* k, const void* v,
                  const void* bias, void* o, int B, int Lq, int Lk, int H,
                  int D, long long q_sb, long long q_sl, long long kv_sb,
                  long long kv_sl, float scale, float scale_log2, int io_f32,
                  int fixed, void* stream) {
  if ((D != 32 && D != 64) || (fixed != 0) != (D == 32) || B < 1 ||
      B > 65535 || Lq < 1 || Lk < 1 || H < 1 || H > 65535)
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
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 32)
    return (int)(io_f32 ? launch<32, float, true>(p, H, B, s)
                        : launch<32, bf16, true>(p, H, B, s));
  return (int)(io_f32 ? launch<64, float, false>(p, H, B, s)
                      : launch<64, bf16, false>(p, H, B, s));
}

}  // extern "C"
