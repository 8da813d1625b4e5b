// K6: attention over T for each (b, n, h) in the native [B, T, N, H, D]
// layout, for Hopper (sm_90a): the DiT's composed temporal branch,
// [2, 24, 512, 16, 32] (or [2, 24, 512, 8, 64] for the DiT's 8-head
// configuration, [2, 24, 512, 4, 128] for its 4-head one) in fp32 on the
// training path. Heads of 32, 64 and 128; the wrapper
// (ops/fused_attention.py) zero-pads a head of any other width up to 128
// to the next of them, which changes neither S nor the row sums.
//
// Replaces the Pallas TPU kernel of gvfdiffusion_tpu/ops/fused_attention.py
// `temporal_attention` (body `_temporal_kernel`), with its rounding points:
// q/k/v rounded to bf16, S in fp32, P = exp2(S * scale * log2(e) - 30) in
// fp32 (a fixed shift, no maximum), the row sum of the fp32 P, P rounded to
// bf16 for P V with fp32 accumulation, the output divided by the row sum and
// written in q's type (bf16 or fp32). The backward pass is plain torch (the
// TPU kernel's custom_vjp is XLA einsums).
//
// The TPU kernel packs 16 voxels of [T, C] into one [16 T, 16 T] masked
// matmul to fill the 128x128 MXU; nothing here needs that. The work is K2's
// attention over T, thousands of problems of T <= 32 frames: it runs
// temporal_sm90.cuh's kernel in its fixed-shift forms (TForm::Shift for
// bf16 io, TForm::ShiftF32 for fp32 io; a warp a (b, n, h), mma.sync bf16
// on the tensor cores, cp.async double-buffered, a persistent grid), where
// the header says what bounds it and how its fp32 tiles are laid out.

#include "temporal_sm90.cuh"

extern "C" {

// q, k, v: [B, T, N, H, D] with heads contiguous in a row and (b, t, n)
// rows rs elements apart (rs = H * D for a contiguous tensor, 3 * H * D for
// a view of a [B, T, N, 3, H, D] qkv projection), each base and row 16-byte
// aligned; o contiguous. All bf16, or all fp32 (io_f32). D = 32, 64 or
// 128.
// scale_log2 = scale * log2(e).
int gvf_temporal_attention(const void* q, const void* k, const void* v,
                           void* o, int B, int T, int N, int H, int D,
                           long long q_rs, long long k_rs, long long v_rs,
                           float scale_log2, int io_f32, void* stream) {
  using namespace gvf::sm90;
  if (D != 32 && D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  TemporalParams p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_rs = q_rs; p.k_rs = k_rs; p.v_rs = v_rs;
  p.B = B; p.T = T; p.N = N; p.H = H;
  p.scale_log2 = scale_log2;
  cudaStream_t s = (cudaStream_t)stream;
  if (io_f32)
    return (int)(D == 32   ? launch_temporal<32, TForm::ShiftF32>(p, s)
                 : D == 64 ? launch_temporal<64, TForm::ShiftF32>(p, s)
                           : launch_temporal<128, TForm::ShiftF32>(p, s));
  return (int)(D == 32   ? launch_temporal<32, TForm::Shift>(p, s)
               : D == 64 ? launch_temporal<64, TForm::Shift>(p, s)
                         : launch_temporal<128, TForm::Shift>(p, s));
}

}  // extern "C"
