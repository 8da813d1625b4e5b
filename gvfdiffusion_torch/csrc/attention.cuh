// Shared definitions of the port's attention kernels for Hopper (sm_90a):
// the element conversions, AttnParams (the row-block addressing, gammas,
// bias and key validity that attention_sm90.cuh's core, its int8-QK and
// tf32 paths and K7 read), and the TPU kernels' fixed exp2 shift.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gvf {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

inline unsigned cdiv(long long a, long long b) { return (unsigned)((a + b - 1) / b); }

// Row block z splits as (z / nb2, z % nb2) with strides s1 / s2, rows within
// a block step by si (queries) or sj (keys / values). Offsets in elements;
// head h starts h * D elements into a row.
struct AttnParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;  // TO
  long long q_s1, q_s2, q_si;
  long long k_s1, k_s2, k_sj;  // and v's, unless v_sj is set
  long long o_s1, o_s2, o_si;
  int nb2, Lq, Lk;
  const bf16* qg;  // [C] gamma * sqrt(D), or null: no RMS norm on q
  const bf16* kg;  // likewise for k (attention_sm90.cuh takes none)
  const float* bias = nullptr;  // [row block z1][Lk] logit bias, or null
  long long bias_s1 = 0;
  float scale;
  float scale_log2 = 0.f;  // scale * log2(e), rounded once
  // the Hopper core only (attention_sm90.cuh, attention_sm90_tf32.cuh; K7):
  // v on strides of its own (v_sj = 0: k's), the key validity bytes of row
  // block z1 at valid + z1 * valid_s1 (0 masks the key), and the key tiles
  // to visit, at tiles + z1 * tiles_s1: their count, then their indices in
  // ascending order (null: every tile)
  long long v_s1 = 0, v_sj = 0;
  const unsigned char* valid = nullptr;
  long long valid_s1 = 0;
  const int* tiles = nullptr;
  long long tiles_s1 = 0;
  // the [z1][H][Lq] row logsumexp out (attention_sm90_tf32.cuh, and
  // attention_sm90.cuh's LSE instantiation), or null; attention_sm90_tf32.cuh
  // only: o_lo: null, or o is written split, tf32(o) there and tf32(o -
  // tf32(o)) at o_lo (the operand of K3's 3xTF32 out projection)
  float* lse = nullptr;
  void* o_lo = nullptr;
  // attention_sm90.cuh only (K5's segment_size): seg > 0 makes the
  // attention block-diagonal, query row i seeing key j only where i / seg
  // == j / seg (Lq == Lk); a CTA visits only the key tiles of its rows'
  // segments. attention_sm90_tf32.cuh only (K3's single context in fp32 with
  // rms): qg_f32 [C], the fp32 q RMS-norm gamma, or null
  int seg = 0;
  const float* qg_f32 = nullptr;
};

constexpr float LOG2E = 1.4426950408889634f;
constexpr float EXP2_SHIFT = 30.f;  // the TPU kernels' fixed exp2 shift

}  // namespace gvf
