// K6: attention over T for each (b, n, h) in the native [B, T, N, H, D]
// layout, for Hopper (sm_90a): the DiT's composed temporal branch,
// [2, 24, 512, 16, 32] (or [2, 24, 512, 8, 64] for the DiT's 8-head
// configuration) in fp32 on the training path.
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
// matmul to fill the 128x128 MXU; nothing here needs that. One warp owns one
// (b, n, h): the k/v rows of that head are staged in shared memory 32 keys
// at a time (lane l loads elements l, l + 32, ... of a row: 128-byte
// coalesced reads in fp32), and each lane owns one query row, whose q it
// holds in registers (read through shared memory, so the loads stay
// coalesced) with its fp32 output accumulator: 2 D registers a lane, 128 at
// D = 64, where a block holds 2 warps instead of 4 to keep the static shared
// memory under 48 KB. Query rows past 32 (T > 32) take further passes; keys
// past T are skipped. The output rows go back through shared memory as
// coalesced writes.
//
// What bounds it on the H100: the bytes. At [2, 24, 512, 16, 32] fp32 it
// reads q, k, v and writes o once, 201 MB (0.060 ms at 3.35 TB/s), against
// 1.2 GFLOP of scores and P V, which CUDA cores at fp32 rates finish in a
// fraction of that time; a [T, T] tile of 24 x 24 is far below one tensor-
// core fragment's worth of work per head. It is written to be right first.

#include "attention.cuh"

namespace {

using namespace gvf;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

constexpr int TR = 32;  // query rows per pass, keys per staged chunk

// q, k, v: row (b, t, n) starts at ((b * T + t) * N + n) * rs, head h at
// h * TD within it; o contiguous [B, T, N, H, TD]. TW warps per block, one
// (b, n, h) each.
template <typename T, int TD, int TW>
__global__ void __launch_bounds__(TW * 32)
temporal_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o, long long G,
                int Tn, int N, int H, long long q_rs, long long k_rs,
                long long v_rs, float scale_log2) {
  __shared__ float sQ[TW][TR][TD + 1];  // q rows in, o rows out
  __shared__ bf16 sK[TW][TR][TD];
  __shared__ bf16 sV[TW][TR][TD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * TW + warp;
  if (g >= G) return;  // the whole warp: nothing below syncs the block
  const int h = (int)(g % H);
  const long long bn = g / H;
  const long long n = bn % N, b = bn / N;
  const long long row0 = b * Tn * N + n;  // row index of (b, t = 0, n)
  const T* qb = q + row0 * q_rs + h * TD;
  const T* kb = k + row0 * k_rs + h * TD;
  const T* vb = v + row0 * v_rs + h * TD;
  T* ob = o + row0 * (long long)H * TD + h * TD;
  const long long qt = (long long)N * q_rs, kt = (long long)N * k_rs,
                  vt = (long long)N * v_rs, ot = (long long)N * H * TD;
  float(*sq)[TD + 1] = sQ[warp];
  bf16(*sk)[TD] = sK[warp];
  bf16(*sv)[TD] = sV[warp];

  for (int i0 = 0; i0 < Tn; i0 += TR) {
    // this pass's query rows, lane l reading elements l, l + 32, ...
    for (int r = 0; r < TR; ++r) {
      const int t = i0 + r;
#pragma unroll
      for (int e = 0; e < TD / 32; ++e)
        sq[r][lane + 32 * e] =
            t < Tn ? round_bf16(to_f(qb[t * qt + lane + 32 * e])) : 0.f;
    }
    __syncwarp();
    float qr[TD], acc[TD];
#pragma unroll
    for (int d = 0; d < TD; ++d) {
      qr[d] = sq[lane][d];
      acc[d] = 0.f;
    }
    float l = 0.f;
    for (int j0 = 0; j0 < Tn; j0 += TR) {
      __syncwarp();  // the previous chunk is no longer read
      const int nk = min(TR, Tn - j0);
      for (int r = 0; r < nk; ++r) {
        const int t = j0 + r;
#pragma unroll
        for (int e = 0; e < TD / 32; ++e) {
          const int d = lane + 32 * e;
          sk[r][d] = __float2bfloat16(to_f(kb[t * kt + d]));
          sv[r][d] = __float2bfloat16(to_f(vb[t * vt + d]));
        }
      }
      __syncwarp();
      for (int j = 0; j < nk; ++j) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < TD; ++d) s = fmaf(qr[d], __bfloat162float(sk[j][d]), s);
        const float pj = exp2f(s * scale_log2 - EXP2_SHIFT);
        l += pj;
        const float pb = round_bf16(pj);
#pragma unroll
        for (int d = 0; d < TD; ++d)
          acc[d] = fmaf(pb, __bfloat162float(sv[j][d]), acc[d]);
      }
    }
    __syncwarp();  // every lane has read its q row
#pragma unroll
    for (int d = 0; d < TD; ++d) sq[lane][d] = acc[d] / l;
    __syncwarp();
    for (int r = 0; r < TR && i0 + r < Tn; ++r) {
#pragma unroll
      for (int e = 0; e < TD / 32; ++e)
        ob[(i0 + r) * ot + lane + 32 * e] = from_f<T>(sq[r][lane + 32 * e]);
    }
    __syncwarp();  // before the next pass overwrites sq
  }
}

template <typename T, int TD, int TW>
cudaError_t launch_temporal(const void* q, const void* k, const void* v,
                            void* o, long long G, int Tn, int N, int H,
                            long long q_rs, long long k_rs, long long v_rs,
                            float scale_log2, cudaStream_t s) {
  const long long blocks = (G + TW - 1) / TW;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  temporal_kernel<T, TD, TW><<<(unsigned)blocks, TW * 32, 0, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, G, Tn, N, H, q_rs, k_rs,
      v_rs, scale_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v: [B, T, N, H, D] with heads contiguous in a row and (b, t, n)
// rows rs elements apart (rs = H * D for a contiguous tensor, 3 * H * D for
// a view of a [B, T, N, 3, H, D] qkv projection); o contiguous. All bf16,
// or all fp32 (io_f32). D = 32 or 64. scale_log2 = scale * log2(e).
int gvf_temporal_attention(const void* q, const void* k, const void* v,
                           void* o, int B, int T, int N, int H, int D,
                           long long q_rs, long long k_rs, long long v_rs,
                           float scale_log2, int io_f32, void* stream) {
  if ((D != 32 && D != 64) || B < 1 || T < 1 || N < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const long long G = (long long)B * N * H;
  cudaStream_t s = (cudaStream_t)stream;
  // 4 warps a block at D = 32, 2 at D = 64 (static shared memory < 48 KB)
  const auto launch =
      D == 32 ? (io_f32 ? &launch_temporal<float, 32, 4> : &launch_temporal<bf16, 32, 4>)
              : (io_f32 ? &launch_temporal<float, 64, 2> : &launch_temporal<bf16, 64, 2>);
  return (int)launch(q, k, v, o, G, T, N, H, q_rs, k_rs, v_rs, scale_log2, s);
}

}  // extern "C"
