// K7's backward for Hopper (sm_90a): the gradient of flash_attention.cu's
// fp32 streaming attention over key validity, at heads of 64, which the
// static VAE's `full` attention mode trains through ([2, 32768, 12, 64]
// fp32, about 10-20 thousand valid voxel slots of 32768).
//
// Replaces the stock Pallas TPU flash attention's two backward kernels that
// gvfdiffusion_tpu/sparse/attention.py:57 `_flash_full_attention`
// differentiates through (jax/experimental/pallas/ops/tpu/flash_attention.py:
// `_flash_attention_bwd_dkv` -> `_flash_attention_dkv_kernel`, and
// `_flash_attention_bwd_dq` -> `_flash_attention_dq_kernel`). Their
// arithmetic, kept here: the scores s = q . k * scale plus -0.7 * FLT_MAX on
// an invalid key (every query row is in the valid keys' segment), the
// probabilities P = exp(s - m) / l from the forward's statistics (here one
// fp32 logsumexp per row, lse = m + log l: P = exp(s - lse)), di = rowsum(o
// * dO) (plain torch in the wrapper, as JAX computes it outside the
// kernels), dS = P * (dO . v - di) * scale, and
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K.
// A batch row with no valid key has, on the TPU, every score equal to the
// mask value, so P = 1 / lk_pad on every key of the key count padded to 512;
// the kernels take that row's P as 1 / lk_pad directly (its lse cannot
// carry it: mask + log(lk_pad) rounds to the mask value). Keys past Lk (the
// TPU's zero padding) add nothing to dQ and their dK / dV are dropped, so
// the kernels stop at Lk.
//
// Both kernels skip a 64-key tile with no valid key (the forward's per-tile
// counts), which is exact while the batch row has a valid key: there P =
// exp(mask - lse) is 0 in fp32, so such a tile adds nothing to dQ, and its
// own dK and dV are 0. A row with no valid key skips nothing.
//
// dkv: one CTA (128 threads) per (64-key tile, head, batch row); the K and V
// tiles stay in shared memory while the CTA loops over every 64-query tile,
// recomputing S^T and dP^T (thread (ty, tx) owns keys 8 ty .. 8 ty + 7 and
// queries tx + 16 j), writing P^T and dS^T to shared memory and
// accumulating dV and dK in registers (keys 8 ty + i, lanes tx * 4 ..
// tx * 4 + 3); written once at the end, no atomics. dq: one CTA per
// (64-query tile, head, batch row); Q and dO stay, the loop visits the key
// tiles, dS goes through shared memory into a register dQ. Rows sit in
// shared memory padded to D + 4 floats (16-byte reads of neighbouring rows
// fall in other banks).
//
// What bounds it on the H100: fp32 operations on the CUDA cores (67 TFLOP/s
// on the datasheet, no TF32, which would round the operands to ~1e-3): the
// gradient needs 10 * B * H * Lq * n_valid * D operations (S, dP, dV, dK,
// dQ); these kernels do 14 (dkv recomputes S and dP, dq both again) with
// fp32 FFMA and 16-byte shared loads. A first version, written to be right:
// no tensor cores, no cp.async pipelining, every query tile visited by
// every active key tile.

#include "attention.cuh"

namespace {

using namespace gvf;

constexpr int BT = 64;  // rows (queries or keys) of a tile

struct BwdParams {
  const float* q;
  const float* k;
  const float* v;
  const unsigned char* valid;  // [B, Lk]
  const int* counts;           // [B, tiles] valid keys per 64-key tile
  const float* lse;            // [B, H, Lq] the forward's row logsumexp
  const float* dout;           // [B, Lq, H, D] contiguous
  const float* di;             // [B, H, Lq] rowsum(o * dO)
  float* dq;                   // [B, Lq, H, D] contiguous
  float* dk;                   // [B, Lk, H, D] contiguous
  float* dv;                   // [B, Lk, H, D] contiguous
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;  // in floats
  int Lq, Lk, H, tiles, lk_pad;
  float scale;
};

// 64 rows of D floats, strided by sl, into [64][D + 4]; rows past n are 0
template <int D>
__device__ __forceinline__ void load_rows(const float* src, long long sl,
                                          int n, float* dst, int tid) {
  constexpr int LD = D + 4, CH = D / 4;
  for (int idx = tid; idx < BT * CH; idx += 128) {
    const int r = idx / CH, c = (idx % CH) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n) val = *reinterpret_cast<const float4*>(src + r * sl + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

// s[i][j] = a[8 ty + i] . b[tx + 16 j], rows of [64][D + 4] shared memory
template <int D>
__device__ __forceinline__ void dots(const float* a, const float* b, int ty,
                                     int tx, float (&s)[8][4]) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 bv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 av =
          *reinterpret_cast<const float4*>(a + (ty * 8 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        x = fmaf(av.x, bv[j].x, x);
        x = fmaf(av.y, bv[j].y, x);
        x = fmaf(av.z, bv[j].z, x);
        s[i][j] = fmaf(av.w, bv[j].w, x);
      }
    }
  }
}

// acc[i][u] += sum_c m[8 ty + i][c] * r[c][tx * D/16 + u] over c < 64;
// m is [64][68], r [64][D + 4]
template <int D>
__device__ __forceinline__ void accum(const float* m, const float* r, int ty,
                                      int tx, float (&acc)[8][D / 16]) {
  constexpr int LD = D + 4, LP = BT + 4, DT = D / 16;
#pragma unroll 2
  for (int kk = 0; kk < BT; kk += 4) {
    float4 mv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      mv[i] = *reinterpret_cast<const float4*>(m + (ty * 8 + i) * LP + kk);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float rv[DT];
      lds_f32<DT>(r + (kk + e) * LD + tx * DT, rv);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float w = e == 0 ? mv[i].x : e == 1 ? mv[i].y
                      : e == 2 ? mv[i].z : mv[i].w;
#pragma unroll
        for (int u = 0; u < DT; ++u) acc[i][u] = fmaf(w, rv[u], acc[i][u]);
      }
    }
  }
}

// whether batch row b has no valid key (uniform across the CTA)
__device__ __forceinline__ bool no_valid_key(const int* cnt, int tiles) {
  int any = 0;
  for (int t = threadIdx.x; t < tiles; t += 128) any |= cnt[t];
  return !__syncthreads_or(any);
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (4 * BT * (D + 4) + 2 * BT * (BT + 4) + 2 * BT) * (int)sizeof(float);
}

template <int D>
constexpr int dq_smem_bytes() {
  return (4 * BT * (D + 4) + BT * (BT + 4)) * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dkv_kernel(BwdParams p) {
  extern __shared__ __align__(16) float bwd_smem[];
  constexpr int LD = D + 4, LP = BT + 4, DT = D / 16;
  float* sK = bwd_smem;
  float* sV = sK + BT * LD;
  float* sQ = sV + BT * LD;
  float* sO = sQ + BT * LD;   // dO
  float* sP = sO + BT * LD;   // P^T [key][query]
  float* sS = sP + BT * LP;   // dS^T [key][query]
  float* sL = sS + BT * LP;   // lse of the query tile
  float* sD = sL + BT;        // di of the query tile
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int j0 = t * BT;
  const int* cnt = p.counts + (long long)b * p.tiles;
  const unsigned char* vld = p.valid + (long long)b * p.Lk;
  const bool uniform = no_valid_key(cnt, p.tiles);

  float dk[8][DT], dv[8][DT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < DT; ++u) dk[i][u] = dv[i][u] = 0.f;

  if (uniform || cnt[t] != 0) {  // uniform across the CTA
    load_rows<D>(p.k + b * p.k_sb + (long long)j0 * p.k_sl + h * D, p.k_sl,
                 p.Lk - j0, sK, tid);
    load_rows<D>(p.v + b * p.v_sb + (long long)j0 * p.v_sl + h * D, p.v_sl,
                 p.Lk - j0, sV, tid);
    // per key of this thread: below Lk, and the mask term of an invalid key
    bool kin[8];
    float kadd[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int key = j0 + ty * 8 + i;
      kin[i] = key < p.Lk;
      kadd[i] = kin[i] && !uniform && !vld[key] ? F32_MASK_VALUE : 0.f;
    }
    const float inv_pad = 1.f / (float)p.lk_pad;
    const float* lse_b = p.lse + ((long long)b * p.H + h) * p.Lq;
    const float* di_b = p.di + ((long long)b * p.H + h) * p.Lq;
    const long long o_sl = (long long)p.H * D;
    for (int q0 = 0; q0 < p.Lq; q0 += BT) {
      __syncthreads();  // the previous query tile is no longer read
      load_rows<D>(p.q + b * p.q_sb + (long long)q0 * p.q_sl + h * D, p.q_sl,
                   p.Lq - q0, sQ, tid);
      load_rows<D>(p.dout + ((long long)b * p.Lq + q0) * o_sl + h * D, o_sl,
                   p.Lq - q0, sO, tid);
      if (tid < BT) {
        const int qi = q0 + tid;
        sL[tid] = qi < p.Lq ? lse_b[qi] : 0.f;
        sD[tid] = qi < p.Lq ? di_b[qi] : 0.f;
      }
      __syncthreads();

      float s[8][4], dp[8][4];
      dots<D>(sK, sQ, ty, tx, s);   // k_(8 ty + i) . q_(tx + 16 j)
      dots<D>(sV, sO, ty, tx, dp);  // v_(8 ty + i) . dO_(tx + 16 j)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qj = tx + 16 * j;
          float pij = 0.f;
          if (kin[i] && q0 + qj < p.Lq)
            pij = uniform ? inv_pad
                          : expf(s[i][j] * p.scale + kadd[i] - sL[qj]);
          sP[(ty * 8 + i) * LP + qj] = pij;
          sS[(ty * 8 + i) * LP + qj] = pij * (dp[i][j] - sD[qj]) * p.scale;
        }
      }
      __syncwarp();  // a key's row is written and read by one half warp
      accum<D>(sP, sO, ty, tx, dv);  // dV += P^T dO
      accum<D>(sS, sQ, ty, tx, dk);  // dK += dS^T Q
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = j0 + ty * 8 + i;
    if (key < p.Lk) {
      const long long off = ((long long)b * p.Lk + key) * p.H * D + h * D +
                            tx * DT;
#pragma unroll
      for (int u = 0; u < DT; ++u) {
        p.dk[off + u] = dk[i][u];
        p.dv[off + u] = dv[i][u];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dq_kernel(BwdParams p) {
  extern __shared__ __align__(16) float bwd_smem[];
  constexpr int LD = D + 4, LP = BT + 4, DT = D / 16;
  float* sQ = bwd_smem;
  float* sO = sQ + BT * LD;  // dO
  float* sK = sO + BT * LD;
  float* sV = sK + BT * LD;
  float* sS = sV + BT * LD;  // dS [query][key]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BT;
  const int* cnt = p.counts + (long long)b * p.tiles;
  const unsigned char* vld = p.valid + (long long)b * p.Lk;
  const bool uniform = no_valid_key(cnt, p.tiles);
  const long long o_sl = (long long)p.H * D;

  load_rows<D>(p.q + b * p.q_sb + (long long)q0 * p.q_sl + h * D, p.q_sl,
               p.Lq - q0, sQ, tid);
  load_rows<D>(p.dout + ((long long)b * p.Lq + q0) * o_sl + h * D, o_sl,
               p.Lq - q0, sO, tid);
  float lse_r[8], di_r[8], dq[8][DT];
  const float* lse_b = p.lse + ((long long)b * p.H + h) * p.Lq;
  const float* di_b = p.di + ((long long)b * p.H + h) * p.Lq;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qi = q0 + ty * 8 + i;
    lse_r[i] = qi < p.Lq ? lse_b[qi] : 0.f;
    di_r[i] = qi < p.Lq ? di_b[qi] : 0.f;
#pragma unroll
    for (int u = 0; u < DT; ++u) dq[i][u] = 0.f;
  }
  const float inv_pad = 1.f / (float)p.lk_pad;

  for (int t = 0; t < p.tiles; ++t) {
    if (!uniform && cnt[t] == 0) continue;  // uniform across the CTA
    const int j0 = t * BT;
    __syncthreads();  // the previous key tile and dS are no longer read
    load_rows<D>(p.k + b * p.k_sb + (long long)j0 * p.k_sl + h * D, p.k_sl,
                 p.Lk - j0, sK, tid);
    load_rows<D>(p.v + b * p.v_sb + (long long)j0 * p.v_sl + h * D, p.v_sl,
                 p.Lk - j0, sV, tid);
    __syncthreads();

    float s[8][4], dp[8][4];
    dots<D>(sQ, sK, ty, tx, s);   // q_(8 ty + i) . k_(tx + 16 j)
    dots<D>(sO, sV, ty, tx, dp);  // dO_(8 ty + i) . v_(tx + 16 j)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = j0 + tx + 16 * j;
      const bool kin = key < p.Lk;
      const float kadd = kin && !uniform && !vld[key] ? F32_MASK_VALUE : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float ds = 0.f;
        if (kin) {
          const float pij = uniform ? inv_pad
                                    : expf(s[i][j] * p.scale + kadd - lse_r[i]);
          ds = pij * (dp[i][j] - di_r[i]) * p.scale;
        }
        sS[(ty * 8 + i) * LP + tx + 16 * j] = ds;
      }
    }
    __syncwarp();  // a query's row is written and read by one half warp
    accum<D>(sS, sK, ty, tx, dq);  // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qi = q0 + ty * 8 + i;
    if (qi < p.Lq) {
      float* row = p.dq + ((long long)b * p.Lq + qi) * o_sl + h * D + tx * DT;
#pragma unroll
      for (int u = 0; u < DT; ++u) row[u] = dq[i][u];
    }
  }
}

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* valid, const void* counts, const void* lse,
                      const void* dout, const void* di, int Lq, int Lk, int H,
                      long long q_sb, long long q_sl, long long k_sb,
                      long long k_sl, long long v_sb, long long v_sl,
                      float scale, int lk_pad) {
  BwdParams p;
  p.q = (const float*)q; p.k = (const float*)k; p.v = (const float*)v;
  p.valid = (const unsigned char*)valid; p.counts = (const int*)counts;
  p.lse = (const float*)lse; p.dout = (const float*)dout;
  p.di = (const float*)di;
  p.dq = p.dk = p.dv = nullptr;
  p.q_sb = q_sb; p.q_sl = q_sl; p.k_sb = k_sb; p.k_sl = k_sl;
  p.v_sb = v_sb; p.v_sl = v_sl;
  p.Lq = Lq; p.Lk = Lk; p.H = H; p.tiles = (int)cdiv(Lk, BT);
  p.lk_pad = lk_pad; p.scale = scale;
  return p;
}

bool bad_shape(int B, int Lq, int Lk, int H, int D, int lk_pad) {
  return D != 64 || B < 1 || B > 65535 || Lq < 1 || Lk < 1 || H < 1 ||
         H > 65535 || lk_pad < Lk;
}

}  // namespace

extern "C" {

// fp32, heads of 64. q/k/v: element (b, i, h, d) at b * sb + i * sl + h * 64
// + d (rows 16-byte aligned); valid: bool [B, Lk]; counts: the forward's
// int32 [B, ceil(Lk / 64)]; lse: the forward's [B, H, Lq]; dout: [B, Lq, H,
// 64] contiguous; di: [B, H, Lq]; dk, dv: [B, Lk, H, 64] contiguous out.
int gvf_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* valid,
    const void* counts, const void* lse, const void* dout, const void* di,
    void* dk, void* dv, int B, int Lq, int Lk, int H, int D, long long q_sb,
    long long q_sl, long long k_sb, long long k_sl, long long v_sb,
    long long v_sl, float scale, int lk_pad, void* stream) {
  if (bad_shape(B, Lq, Lk, H, D, lk_pad)) return (int)cudaErrorInvalidValue;
  BwdParams p = make_params(q, k, v, valid, counts, lse, dout, di, Lq, Lk, H,
                            q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale, lk_pad);
  p.dk = (float*)dk;
  p.dv = (float*)dv;
  constexpr int bytes = dkv_smem_bytes<64>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<64><<<dim3(p.tiles, H, B), 128, bytes,
                             (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// the same inputs; dq: [B, Lq, H, 64] contiguous out
int gvf_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* valid,
    const void* counts, const void* lse, const void* dout, const void* di,
    void* dq, int B, int Lq, int Lk, int H, int D, long long q_sb,
    long long q_sl, long long k_sb, long long k_sl, long long v_sb,
    long long v_sl, float scale, int lk_pad, void* stream) {
  if (bad_shape(B, Lq, Lk, H, D, lk_pad)) return (int)cudaErrorInvalidValue;
  BwdParams p = make_params(q, k, v, valid, counts, lse, dout, di, Lq, Lk, H,
                            q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale, lk_pad);
  p.dq = (float*)dq;
  constexpr int bytes = dq_smem_bytes<64>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<64><<<dim3(cdiv(Lq, BT), H, B), 128, bytes,
                            (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
