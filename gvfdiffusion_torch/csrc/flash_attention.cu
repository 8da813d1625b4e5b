// K7: streaming flash attention over key validity for Hopper (sm_90a), the
// full sparse self-attention of the SLat flow's uncompacted torso: q/k/v
// [1, 32768, 16, 64] with a few thousand valid slots, in bf16 (the shipped
// bf16 models) or fp32 (TRELLIS as the registry builds it); heads of 32, 64
// or 128 in either dtype (the same torso at 32 or 8 heads).
//
// Replaces the stock Pallas TPU flash attention that
// gvfdiffusion_tpu/sparse/attention.py:57 `_flash_full_attention` calls
// with the key validity as segment ids (every query in segment 1). Its
// arithmetic, kept here: scores q . k in fp32 from the inputs' values, times
// the scale, plus -0.7 * FLT_MAX on an invalid key (not -inf); an online
// softmax over key blocks with the row sum from the fp32 P and P rounded
// to the inputs' dtype for P V (bf16; in fp32 nothing is rounded); every
// query row computed, valid or not. A batch row with no valid key gives, on
// the TPU, the mean of V over the key count padded to 512 (every score
// equals the mask value, so P is 1 on every padded key, and the padding's V
// is 0): here the same, sum(V) / lk_pad.
//
// The kernels skip every 64-key tile that holds no valid key. That is exact:
// such a tile adds exp(-0.7 * FLT_MAX - m) = 0 to a row that has a valid key,
// and a tile with a valid key sets every row's running maximum to a real
// score before any rounding matters. It is also what makes the torso
// affordable: its valid slots are a prefix (the downsample packs parents in
// code order), so ~3700 valid keys of 32768 visit 58 of 512 tiles. A first
// kernel counts the valid keys of each (batch row, tile) once per call; the
// attention kernel reads those counts to skip tiles and to find a batch row
// with none. In fp32 it can also write each row's logsumexp, the residual
// of the backward kernels (flash_attention_bwd.cu).
//
// What bounds it on the H100: 4 * Lq * n_valid * H * D operations (0.50
// TFLOP at 3700 valid keys) against ~13 MB (bf16) or ~26 MB (fp32) of
// traffic: in bf16 the tensor cores (0.50 ms at the datasheet's 989
// TFLOP/s), in fp32 the CUDA cores (7.4 ms at 67 TFLOP/s). These first
// versions are far from those bounds. bf16: one CTA (4 warps) per (64-query
// tile, head, batch row), K/V tiles staged through shared memory with
// 16-byte loads, WMMA 16x16x16 bf16 products whose S and P V results
// round-trip through shared memory, the softmax on CUDA cores, no wgmma,
// TMA or cp.async pipelining. fp32: attention.cuh's attn_f32_kernel, fp32
// FFMA on the CUDA cores (no TF32, which would round the operands). Both
// are written to be right first.

#include "attention.cuh"

namespace {

using namespace gvf;

constexpr int FQ = 64, FK = 64;

// counts[b * tiles + t] = valid keys in key tile t of batch row b
__global__ void __launch_bounds__(FK)
tile_count_kernel(const unsigned char* __restrict__ valid, int* __restrict__ counts,
                  int Lk, int tiles) {
  const int t = blockIdx.x, b = blockIdx.y;
  const int j = t * FK + threadIdx.x;
  const int ok = j < Lk && valid[(long long)b * Lk + j];
  const int n = __syncthreads_count(ok);
  if (threadIdx.x == 0) counts[(long long)b * tiles + t] = n;
}

struct FlashParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const unsigned char* valid;  // [B, Lk]
  const int* counts;           // [B, tiles]
  bf16* o;                     // [B, Lq, H, D] contiguous
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;
  int Lq, Lk, H, tiles, lk_pad;
  float scale;
};

// 64 rows of D bf16 from src rows strided by `sl` elements into dst
// [64][D]; rows past n are zero
template <int D>
__device__ __forceinline__ void load_tile(const bf16* src, long long sl, int n,
                                          bf16* dst) {
#pragma unroll
  for (int it = 0; it < D / 16; ++it) {
    const int idx = threadIdx.x + it * 128;  // 8 D chunks of 8 bf16
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) val = *reinterpret_cast<const uint4*>(src + r * sl + c);
    *reinterpret_cast<uint4*>(dst + r * D + c) = val;
  }
}

// per warp: S [16][64] fp32, then the P V tile [16][D]
template <int D>
__host__ __device__ constexpr int flash_s_floats() { return 16 * (D > FK ? D : FK); }

// Dynamic shared memory: Q, K, V [64][D] bf16, per warp S / P V fp32 and P
// [16][64] bf16: 48 KB at D = 64, 30 KB at 32, 88 KB at 128.
template <int D>
__host__ __device__ constexpr int flash_smem_bytes() {
  return 3 * 64 * D * 2 + 4 * flash_s_floats<D>() * 4 + 4 * 16 * FK * 2;
}

template <int D>
__global__ void __launch_bounds__(128) flash_kernel(FlashParams p) {
  extern __shared__ __align__(128) unsigned char flash_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(flash_smem);
  bf16* sK = sQ + FQ * D;
  bf16* sV = sK + FK * D;
  float* sS = reinterpret_cast<float*>(sV + FK * D);
  bf16* sP = reinterpret_cast<bf16*>(sS + 4 * flash_s_floats<D>());

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * FQ;
  const int* cnt = p.counts + (long long)b * p.tiles;
  const unsigned char* vb = p.valid + (long long)b * p.Lk;

  // a batch row with no valid key takes every key, each with P = 1
  int any = 0;
  for (int t = tid; t < p.tiles; t += 128) any |= cnt[t];
  const bool uniform = !__syncthreads_or(any);

  load_tile<D>(p.q + b * p.q_sb + (long long)q0 * p.q_sl + h * D, p.q_sl,
               p.Lq - q0, sQ);

  // lanes (2r, 2r+1) of a warp own query row r of its 16, 32 keys each
  const int r = lane >> 1, half = lane & 1;
  float m_run = neg_inf(), l_run = 0.f;
  float o_acc[D / 2];
#pragma unroll
  for (int d = 0; d < D / 2; ++d) o_acc[d] = 0.f;
  float* sSw = sS + warp * flash_s_floats<D>();
  bf16* sPw = sP + warp * 16 * FK;

  for (int t = 0; t < p.tiles; ++t) {
    if (!uniform && cnt[t] == 0) continue;  // uniform across the CTA
    const int j0 = t * FK;
    __syncthreads();  // the previous tile's K/V are no longer read
    load_tile<D>(p.k + b * p.k_sb + (long long)j0 * p.k_sl + h * D, p.k_sl,
                 p.Lk - j0, sK);
    load_tile<D>(p.v + b * p.v_sb + (long long)j0 * p.v_sl + h * D, p.v_sl,
                 p.Lk - j0, sV);
    __syncthreads();

    // S = Q K^T for this warp's 16 query rows
#pragma unroll
    for (int j = 0; j < FK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sQ + warp * 16 * D + kk, D);
        wmma::load_matrix_sync(fb, sK + j * 16 * D + kk, D);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sSw + j * 16, acc, FK, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax: s = q.k * scale (+ the mask value on an invalid key);
    // keys past Lk get P = 0
    float sv[32];
    float mx = neg_inf();
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int j = j0 + half * 32 + c;
      float s = neg_inf();
      if (j < p.Lk) {
        if (uniform) {
          s = 0.f;
        } else {
          s = sSw[r * FK + half * 32 + c] * p.scale;
          if (!vb[j]) s += F32_MASK_VALUE;
        }
      }
      sv[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    // every visited tile holds a key below Lk, so m_new is finite
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      sv[c] = expf(sv[c] - m_new);
      psum += sv[c];
    }
    m_run = m_new;
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_run = l_run * alpha + psum;
#pragma unroll
    for (int c = 0; c < 32; ++c)
      sPw[r * FK + half * 32 + c] = __float2bfloat16(sv[c]);
    __syncwarp();

    // P V into the (now free) score area as [16, D]
#pragma unroll
    for (int dj = 0; dj < D / 16; ++dj) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < FK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sPw + kk, FK);
        wmma::load_matrix_sync(fb, sV + kk * D + dj * 16, D);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sSw + dj * 16, acc, D, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int d = 0; d < D / 2; ++d)
      o_acc[d] = o_acc[d] * alpha + sSw[r * D + half * (D / 2) + d];
    __syncwarp();
  }

  const int qi = q0 + warp * 16 + r;
  if (qi < p.Lq) {
    const float inv = 1.f / (uniform ? (float)p.lk_pad : l_run);
    bf16* orow = p.o + ((long long)b * p.Lq + qi) * p.H * D + h * D +
                 half * (D / 2);
#pragma unroll
    for (int d = 0; d < D / 2; ++d) orow[d] = __float2bfloat16(o_acc[d] * inv);
  }
}

template <int D>
cudaError_t launch_flash(const FlashParams& p, int B, cudaStream_t s) {
  const int bytes = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  flash_kernel<D><<<dim3(cdiv(p.Lq, FQ), p.H, B), 128, bytes, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: element (b, i, h, d) at b * q_sb + i * q_sl + h * D + d, likewise k
// and v with their own strides; all bf16 (f32 = 0) or all fp32 (f32 = 1),
// rows 16-byte aligned; D = 32, 64 or 128; valid: bool [B, Lk]; counts:
// int32 scratch [B, ceil(Lk / 64)]; o: [B, Lq, H, D] contiguous, in the
// inputs' dtype; lse: null, or (fp32 only) the [B, H, Lq] fp32 row
// logsumexp that the backward (flash_attention_bwd.cu) reads; lk_pad: Lk
// padded to the TPU kernel's 512.
int gvf_flash_attention(const void* q, const void* k, const void* v,
                        const void* valid, void* counts, void* o, void* lse,
                        int B,
                        int Lq, int Lk, int H, int D, long long q_sb,
                        long long q_sl, long long k_sb, long long k_sl,
                        long long v_sb, long long v_sl, float scale,
                        int lk_pad, int f32, void* stream) {
  if ((D != 32 && D != 64 && D != 128) || B < 1 || B > 65535 || Lq < 1 ||
      Lk < 1 || H < 1 || H > 65535 || lk_pad < Lk || (lse && !f32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (int)cdiv(Lk, FK);
  tile_count_kernel<<<dim3(tiles, B), FK, 0, s>>>(
      (const unsigned char*)valid, (int*)counts, Lk, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (f32) {
    F32AttnParams p;
    p.q = (const float*)q; p.k = (const float*)k; p.v = (const float*)v;
    p.o = (float*)o;
    p.q_sb = q_sb; p.q_sl = q_sl; p.k_sb = k_sb; p.k_sl = k_sl;
    p.v_sb = v_sb; p.v_sl = v_sl;
    p.o_sb = (long long)Lq * H * D; p.o_sl = (long long)H * D;
    p.valid = (const unsigned char*)valid; p.counts = (const int*)counts;
    p.lse = (float*)lse;
    p.Lq = Lq; p.Lk = Lk; p.tiles = tiles; p.lk_pad = lk_pad;
    p.scale = scale;
    return (int)launch_attn_f32(p, H, B, D, s);
  }
  FlashParams p;
  p.q = (const bf16*)q; p.k = (const bf16*)k; p.v = (const bf16*)v;
  p.valid = (const unsigned char*)valid; p.counts = (const int*)counts;
  p.o = (bf16*)o;
  p.q_sb = q_sb; p.q_sl = q_sl; p.k_sb = k_sb; p.k_sl = k_sl;
  p.v_sb = v_sb; p.v_sl = v_sl;
  p.Lq = Lq; p.Lk = Lk; p.H = H; p.tiles = tiles; p.lk_pad = lk_pad;
  p.scale = scale;
  if (D == 32) return (int)launch_flash<32>(p, B, s);
  if (D == 64) return (int)launch_flash<64>(p, B, s);
  return (int)launch_flash<128>(p, B, s);
}

}  // extern "C"
