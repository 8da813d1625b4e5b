// K5: softmax self-attention for Hopper (sm_90a), DINOv2's configuration.
//
// Replaces the Pallas TPU kernel of gvfdiffusion_tpu/ops/fused_attention.py
// `fused_attention` (bodies `_attn_kernel_dense` / `_attn_kernel`) for
// Lq = Lk, heads of 64, bf16 q/k/v and output, fp32 accumulation, no
// per-key bias, no segments, no int8.
//
// q, k and v are read in place, with strides, from the [B, L, 3, H, D]
// output of the qkv projection (no copies), and the output is written as
// [B, L, H * D], the layout the output projection reads. The body is
// attn_kernel of attention.cuh at D = 64: one CTA per (64-query tile, head,
// batch row), 64-key tiles in shared memory, WMMA bf16 products with fp32
// accumulation, an online softmax with a true running maximum (the TPU
// kernel's fixed exp2 shift of 30 holds only while every scaled logit stays
// within about +-90, which nothing guarantees for a ViT's un-normed q.k),
// P rounded to bf16 before P V and the row sum taken from the fp32 P, as
// the TPU kernel's dense branch does, and the ragged key tail masked
// (L = 1374 = 21 * 64 + 30 at 518^2).
//
// What bounds it on the H100: at [32, 1374, 16, 64] one call is 0.247 TFLOP
// of tensor-core work against 360 MB of q/k/v/o traffic, so the tensor
// cores bound it (0.25 ms at the datasheet's 989 TFLOP/s, against 0.11 ms
// for the bytes at 3.35 TB/s). This first version is far from that bound:
// it runs WMMA through shared-memory round trips for S and for P V, does
// the softmax on CUDA cores one row half per thread, and uses no wgmma, TMA
// or cp.async pipelining. It is written to be right first.

#include "attention.cuh"

using namespace gvf;

extern "C" {

// q, k, v: bf16, element (b, l, h, d) at b * s_b + l * s_l + h * D + d, with
// k and v sharing (kv_sb, kv_sl); o: bf16 [B, L, H * D] contiguous.
int gvf_attention(const void* q, const void* k, const void* v, void* o, int B,
                  int L, int H, int D, long long q_sb, long long q_sl,
                  long long kv_sb, long long kv_sl, float scale, void* stream) {
  if (D != 64 || B < 1 || B > 65535 || L < 1) return (int)cudaErrorInvalidValue;
  AttnParams p;
  p.q = q; p.k = k; p.v = v; p.o = (bf16*)o;
  p.q_s1 = q_sb; p.q_s2 = 0; p.q_si = q_sl;
  p.k_s1 = kv_sb; p.k_s2 = 0; p.k_sj = kv_sl;
  p.o_s1 = (long long)L * H * D; p.o_s2 = 0; p.o_si = (long long)H * D;
  p.nb2 = 1; p.Lq = p.Lk = L;
  p.qg = nullptr; p.kg = nullptr;
  p.scale = scale;
  return (int)launch_attn<64, bf16, bf16>(p, H, B, (cudaStream_t)stream);
}

}  // extern "C"
