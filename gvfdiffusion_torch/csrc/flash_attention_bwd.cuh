// What K7's two backward kernels share, in fp32 (flash_attention_bwd.cu,
// 3xTF32) and bf16 (flash_attention_bwd_bf16.cu): their parameters and
// checks, P from a score and the forward's logsumexp, and the grid of a
// walk over the forward's list of key tiles.
//
// The list. The forward (flash_attention.cu) lists, per batch row, the key
// tiles of its own size LT that hold a valid key: 128 keys in bf16 at heads
// of 32 and 64, 64 at 128; 64 in fp32, 32 at 128. A backward kernel visits
// U keys at a time (wgmma's M is 64, so dkv's CTA holds 64 keys; dq takes U
// keys a step): where LT >= U each listed tile is LT / U visits of U
// consecutive keys (a visit whose keys are all invalid adds exactly
// nothing: P = 0 there), and where LT < U a visit takes U / LT listed tiles,
// wherever they lie. A batch row with no listed tile (no valid key) visits
// every U-key tile: there P = 1 / lk_pad on every key below Lk.

#pragma once

#include "attention_sm90_tf32.cuh"

namespace gvf {
namespace fbwd {

using namespace gvf::sm90;

struct BwdParams {
  const void* q;               // q / k / v in the kernel's dtype, on strides
  const void* k;
  const void* v;
  const unsigned char* valid;  // [B, Lk]
  const int* list;             // [B][1 + tiles]: count, listed tiles
  const float* lse;            // [B, H, Lq] the forward's row logsumexp
  const void* dout;            // [B, Lq, H, D] contiguous
  const float* di;             // [B, H, Lq] rowsum(o * dO), fp32
  void* dq;                    // [B, Lq, H, D] contiguous
  void* dk;                    // [B, Lk, H, D] contiguous
  void* dv;                    // [B, Lk, H, D] contiguous
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;  // in elements
  int Lq, Lk, H, tiles, lk_pad;  // tiles: the list's LT-key tiles
  float scale, scale_log2;
};

__device__ __forceinline__ float pos_inf() {
  return __int_as_float(0x7f800000);
}

// P from a score: exp2(s * scale log2 e + bias - lse log2 e) (bias 0, or
// -inf on an invalid key or one past Lk; lse log2 e +inf on a query row
// past Lq); in a batch row with no valid key 1 / lk_pad on every key below
// Lk and query row below Lq
__device__ __forceinline__ float prob(float s, float bias, float lq,
                                      bool uniform, float scale_log2,
                                      float inv_pad) {
  if (uniform) return bias == 0.f && lq != pos_inf() ? inv_pad : 0.f;
  return exp2f(fmaf(s, scale_log2, bias) - lq);
}

// the most visits any batch row can have: the grid of a kernel with a CTA
// per visit
template <int LT, int U>
inline unsigned max_visits(int Lk) {
  const unsigned listed = cdiv(Lk, LT);
  const unsigned n = LT >= U ? listed * (LT / U) : cdiv(listed, U / LT);
  const unsigned all = cdiv(Lk, U);
  return n > all ? n : all;
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

inline BwdParams make_params(const void* q, const void* k, const void* v,
                             const void* valid, const void* list,
                             const void* lse, const void* dout,
                             const void* di, int Lq, int Lk, int H,
                             long long q_sb, long long q_sl, long long k_sb,
                             long long k_sl, long long v_sb, long long v_sl,
                             float scale, int lk_pad, int list_tile) {
  BwdParams p;
  p.q = q; p.k = k; p.v = v;
  p.valid = (const unsigned char*)valid; p.list = (const int*)list;
  p.lse = (const float*)lse; p.dout = dout; p.di = (const float*)di;
  p.dq = p.dk = p.dv = nullptr;
  p.q_sb = q_sb; p.q_sl = q_sl; p.k_sb = k_sb; p.k_sl = k_sl;
  p.v_sb = v_sb; p.v_sl = v_sl;
  p.Lq = Lq; p.Lk = Lk; p.H = H; p.tiles = (int)cdiv(Lk, list_tile);
  p.lk_pad = lk_pad; p.scale = scale; p.scale_log2 = scale * LOG2E;
  return p;
}

inline bool bad_shape(int B, int Lq, int Lk, int H, int D, int lk_pad) {
  return (D != 32 && D != 64 && D != 128) || B < 1 || B > 65535 || Lq < 1 ||
         Lk < 1 || H < 1 || H > 65535 || lk_pad < Lk;
}

// q / k / v rows and batch strides on 16 bytes (per16: elements in 16 bytes)
inline bool misaligned(const void* q, const void* k, const void* v,
                       long long q_sb, long long q_sl, long long k_sb,
                       long long k_sl, long long v_sb, long long v_sl,
                       int per16) {
  return (uintptr_t)q % 16 || (uintptr_t)k % 16 || (uintptr_t)v % 16 ||
         q_sb % per16 || q_sl % per16 || k_sb % per16 || k_sl % per16 ||
         v_sb % per16 || v_sl % per16;
}

}  // namespace fbwd
}  // namespace gvf
