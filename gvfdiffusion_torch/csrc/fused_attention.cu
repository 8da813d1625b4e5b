// K5: softmax attention for Hopper (sm_90a), in the forms its callers run:
// DINOv2's and the sparse-structure flow's self-attention, the sparse-
// structure flow's cross-attention to the image tokens (Lq != Lk), and the
// SLat flow torso's full sparse self-attention, whose key validity is a
// per-key logit bias (-inf on the padding slots).
//
// Replaces the Pallas TPU kernel of gvfdiffusion_tpu/ops/fused_attention.py
// `fused_attention` (bodies `_attn_kernel_dense` / `_attn_kernel`) for heads
// of 64, bf16 q/k/v and output, fp32 accumulation, an optional fp32 kv_bias;
// no segments, no int8.
//
// q is read in place from its own [B, Lq, H, D] rows and k/v from theirs
// (for self-attention the q/k/v views of one [B, L, 3, H, D] qkv
// projection, for cross-attention the k/v views of a [B, Lk, 2, H, D] kv
// projection), each with its batch and row strides (no copies); the output
// is written as [B, Lq, H * D], the layout the output projection reads. The
// body is attn_kernel of attention.cuh at D = 64: one CTA per (64-query
// tile, head, batch row), 64-key tiles in shared memory, WMMA bf16 products
// with fp32 accumulation, an online softmax with a true running maximum (the
// TPU kernel's fixed exp2 shift of 30 holds only while every scaled logit
// stays within about +-90, which nothing guarantees for a ViT's un-normed
// q.k), P rounded to bf16 before P V and the row sum taken from the fp32 P,
// as the TPU kernel's dense branch does, and the ragged key tail masked
// (Lk = 1374 = 21 * 64 + 30 at 518^2). The bias row is read per key by the
// softmax step (the 48 KB of static shared memory are taken); a row whose
// keys are all masked gives 0, as the TPU kernel's clamped denominator does.
//
// What bounds it on the H100: the tensor cores at every caller's shape
// (DINOv2 [32, 1374, 16, 64]: 0.247 TFLOP against 360 MB; the SLat torso
// [1, 4096, 16, 64]: 68.7 GFLOP against 33.6 MB), except the sparse-
// structure self-attention [1, 512, 16, 64], where the bytes do. This first
// version is far from either bound: it runs WMMA through shared-memory round
// trips for S and for P V, does the softmax on CUDA cores one row half per
// thread, and uses no wgmma, TMA or cp.async pipelining. It is written to be
// right first.

#include "attention.cuh"

using namespace gvf;

extern "C" {

// q: bf16, element (b, i, h, d) at b * q_sb + i * q_sl + h * D + d;
// k, v: bf16, element (b, j, h, d) at b * kv_sb + j * kv_sl + h * D + d;
// bias: fp32 [B, Lk] contiguous, or null; o: bf16 [B, Lq, H * D] contiguous.
int gvf_attention(const void* q, const void* k, const void* v,
                  const void* bias, void* o, int B, int Lq, int Lk, int H,
                  int D, long long q_sb, long long q_sl, long long kv_sb,
                  long long kv_sl, float scale, void* stream) {
  if (D != 64 || B < 1 || B > 65535 || Lq < 1 || Lk < 1 || H < 1 || H > 65535)
    return (int)cudaErrorInvalidValue;
  AttnParams p;
  p.q = q; p.k = k; p.v = v; p.o = (bf16*)o;
  p.q_s1 = q_sb; p.q_s2 = 0; p.q_si = q_sl;
  p.k_s1 = kv_sb; p.k_s2 = 0; p.k_sj = kv_sl;
  p.o_s1 = (long long)Lq * H * D; p.o_s2 = 0; p.o_si = (long long)H * D;
  p.nb2 = 1; p.Lq = Lq; p.Lk = Lk;
  p.qg = nullptr; p.kg = nullptr;
  p.bias = (const float*)bias; p.bias_s1 = Lk;
  p.scale = scale;
  return (int)launch_attn<64, bf16, bf16>(p, H, B, (cudaStream_t)stream);
}

}  // extern "C"
