// K7 at heads wider than 128 lanes for Hopper (sm_90a): the forward (with or
// without its logsumexp residual) and the two backward kernels, dkv and dq,
// in bf16 and fp32, at any head width D that is a multiple of 64 from 192 to
// 1024 (the wrapper zero-pads a head of another multiple of 8 above 128 to
// the next of them: ops/_widths.py `flash_card_width`). The static VAE's
// full attention at its 768 channels in 4, 3, 2 or 1 heads (main_vae
// --static_vae.num_heads=4 ... 1: D = 192 ... 768; encode_latent with such
// a VAE).
//
// Replaces, above 128 lanes, the stock Pallas TPU flash attention that
// gvfdiffusion_tpu/sparse/attention.py:57 `_flash_full_attention` calls
// with the key validity as segment ids (its rule, :114, sends any multiple
// of 8 there), and its two backward kernels (jax/experimental/pallas/ops/
// tpu/flash_attention.py: `_flash_attention_dkv_kernel` :796,
// `_flash_attention_dq_kernel` :1146). Their arithmetic, as the kernels of
// heads up to 128 keep it (flash_attention.cu, flash_attention_bwd.cu,
// flash_attention_bwd_bf16.cu): scores q . k in fp32 from the inputs'
// values, times the scale; an invalid key masked (the TPU's additive
// -0.7 * FLT_MAX, whose exp is 0 in a row with a valid key: -inf here);
// every query row computed; the online softmax with a true running maximum,
// the row sum from the fp32 P, P rounded to the inputs' dtype for P V; a
// batch row with no valid key gives sum(V) / lk_pad on every query row
// (lk_pad: Lk padded to the TPU kernel's 512) and the logsumexp
// log(lk_pad), and its backward takes P = 1 / lk_pad on every key below Lk.
// The backward: P = exp(s - lse) from the forward's residual, dP = dO V^T,
// dS = P (dP - di) scale with di = rowsum(o dO) in fp32 (the wrapper's, as
// JAX computes it outside the kernels), dV = P^T dO, dK = dS^T Q, dQ = dS K;
// in bf16 P and dS rounded to bf16 before the products that take them and
// each gradient rounded once; no atomics, deterministic.
//
// Every kernel walks the list of the 64-key tiles that hold a valid key
// (flash_tiles.cuh's tile_list_kernel, built by the forward, its format:
// per batch row the count, then the indices); an unlisted tile adds exactly
// nothing (P = 0), so its dK and dV stay the wrapper's zeros. A batch row
// with no listed tile visits every tile.
//
// Design: the simple one. At D = 768 a 64-row Q tile in bf16 is 96 KB and a
// 64 x 768 fp32 accumulator is 192 KB, past a CTA's shared memory and one
// warpgroup's registers, so the output columns are split over the grid: a
// CTA owns one 64-lane chunk c of the output (O, or dK and dV, or dQ) of a
// tile of 64 rows (query rows, or in dkv the keys of one visit). It forms
// the full-width scores S = sum over chunks of Q_dc K_dc^T (and in the
// backward dP = dO V^T) by streaming 64-lane chunks of both operands through
// a 2-stage cp.async ring in shared memory, then accumulates only its own
// chunk of the output from its own chunk of V (dO and Q, K). So S (and dP)
// is recomputed D / 64 times, once by each chunk's CTA; every CTA of a row
// tile forms S in the same order, so their row maxima and sums agree bit for
// bit, and chunk 0 alone writes the logsumexp. 4 warps a CTA, each 16 rows;
// the products on the tensor cores by mma.sync from shared memory (rows
// padded to 144 / 272 bytes: no bank conflict), the score accumulator as it
// stands the A operand of the product that sums over its columns:
//   bf16: m16n8k16 bf16 -> fp32;
//   fp32: m16n8k8 tf32 by the 3xTF32 split (x = hi + lo, a.b = lo.hi' +
//   hi.lo' + hi.hi'), in chains of 32 lanes or keys summed in fp32 (the
//   tensor cores' accumulation over a long chain loses more than fp32 adds;
//   attention_sm90_tf32.cuh), about fp32's precision.
//
// What bounds it on the H100: the products over the valid keys Nv, per head
// 4 Lq Nv D operations forward, 8 dkv and 6 dq, at the dense bf16 rate (989
// TFLOP/s) in bf16 and three tf32 products each at 495 in fp32; at the static
// VAE's 768 channels and two shells (15721 + 12219 valid keys) the forward
// 2.84 ms in bf16, 17.0 in fp32. The recomputation multiplies the score
// products: forward (D / 64 + 1) / 2 times the bound's operations, dkv and dq
// (D / 64 + 1) / 2 and (2 D / 64 + 1) / 3 (at D = 768: 6.5, 6.5 and 8.3);
// with mma.sync in place of wgmma and every operand chunk read from L2 once
// per CTA, these kernels sit far above the bound. Making them fast (wgmma,
// TMA, S formed once per row tile) is later work.

#include "attention.cuh"
#include "flash_tiles.cuh"

namespace {

using namespace gvf;

constexpr int WL = 64;     // lanes of a chunk
constexpr int WR = 64;     // rows of a tile: query rows, or keys of a visit
constexpr int WT = 128;    // threads: 4 warps of 16 rows
constexpr int WIDE_MAX = 1024;

// a [WR][WL] tile in shared memory, rows padded (144 bytes in bf16, 272 in
// fp32) so that the fragment loads below hit 32 banks
template <typename T>
struct Tile {
  static constexpr int P = sizeof(T) == 2 ? 72 : 68;  // the pitch, elements
  static constexpr int BYTES = WR * P * (int)sizeof(T);
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* s, const void* g, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(s)),
               "l"(g), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [0, rows) of the tile from g (row r at g + r * sl, WL lanes), the
// others zero
template <typename T>
__device__ __forceinline__ void load_tile(T* s, const T* g, long long sl,
                                          int rows) {
  constexpr int PER = 16 / sizeof(T);  // elements in 16 bytes
  constexpr int ROW = WL / PER;        // 16-byte pieces a row
#pragma unroll
  for (int p = threadIdx.x; p < WR * ROW; p += WT) {
    const int r = p / ROW, e = (p % ROW) * PER;
    const bool ok = r < rows;
    cp_async16(s + r * Tile<T>::P + e, ok ? g + r * sl + e : g, ok);
  }
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3},"
      " {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3},"
      " {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 in one register, lo at the lower k index
__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  return pack(__float2bfloat16(lo), __float2bfloat16(hi));
}

// x = hi + lo, each a tf32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// lo.hi' + hi.lo' + hi.hi' into c
__device__ __forceinline__ void mma3(float* c, const uint32_t* ah,
                                     const uint32_t* al, const uint32_t* bh,
                                     const uint32_t* bl) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// A warp's two products on [16][64] accumulators (8 n-tiles of m16n8: a
// thread holds rows g and g + 8, columns 8 j + 2 t and + 1):
//   rows_by_rows: acc += A B^T, A the warp's 16 rows of a tile, B a tile's
//   64 rows, summed over the tile's WL lanes;
//   regs_by_tile: acc += X B, X a [16][64] accumulator (over B's rows), B a
//   tile [64 rows][WL lanes].
template <typename T>
struct Mma;

template <>
struct Mma<bf16> {
  static constexpr int P = Tile<bf16>::P;

  __device__ static void rows_by_rows(float (*acc)[4], const bf16* a,
                                      const bf16* b, int g, int t) {
#pragma unroll
    for (int kk = 0; kk < WL / 16; ++kk) {
      const bf16* ap = a + g * P + 16 * kk + 2 * t;
      const uint32_t af[4] = {lds32(ap), lds32(ap + 8 * P), lds32(ap + 8),
                              lds32(ap + 8 * P + 8)};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* bp = b + (8 * j + g) * P + 16 * kk + 2 * t;
        mma_bf16(acc[j], af, lds32(bp), lds32(bp + 8));
      }
    }
  }

  // X rounded to bf16 (the stock kernels' casts of P and dS)
  __device__ static void regs_by_tile(float (*acc)[4], const float (*x)[4],
                                      const bf16* b, int g, int t) {
#pragma unroll
    for (int kk = 0; kk < WR / 16; ++kk) {
      const uint32_t af[4] = {
          pack_f(x[2 * kk][0], x[2 * kk][1]),
          pack_f(x[2 * kk][2], x[2 * kk][3]),
          pack_f(x[2 * kk + 1][0], x[2 * kk + 1][1]),
          pack_f(x[2 * kk + 1][2], x[2 * kk + 1][3])};
      const bf16* bp = b + (16 * kk + 2 * t) * P + g;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const bf16* c = bp + 8 * n;
        mma_bf16(acc[n], af, pack(c[0], c[P]), pack(c[8 * P], c[9 * P]));
      }
    }
  }
};

template <>
struct Mma<float> {
  static constexpr int P = Tile<float>::P;

  __device__ static void rows_by_rows(float (*acc)[4], const float* a,
                                      const float* b, int g, int t) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float part[8][4] = {};
#pragma unroll
      for (int kk = 4 * half; kk < 4 * half + 4; ++kk) {
        const float* ap = a + g * P + 8 * kk + t;
        uint32_t ah[4], al[4];
        split(ap[0], ah[0], al[0]);
        split(ap[8 * P], ah[1], al[1]);
        split(ap[4], ah[2], al[2]);
        split(ap[8 * P + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float* bp = b + (8 * j + g) * P + 8 * kk + t;
          uint32_t bh[2], bl[2];
          split(bp[0], bh[0], bl[0]);
          split(bp[4], bh[1], bl[1]);
          mma3(part[j], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
    }
  }

  // k-slot t of a k8 step is X's column 2 t, slot t + 4 column 2 t + 1:
  // the accumulator's registers are the A operand as they stand, and B's
  // rows are read in the same order
  __device__ static void regs_by_tile(float (*acc)[4], const float (*x)[4],
                                      const float* b, int g, int t) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float part[8][4] = {};
#pragma unroll
      for (int j = 4 * half; j < 4 * half + 4; ++j) {
        uint32_t ah[4], al[4];
        split(x[j][0], ah[0], al[0]);
        split(x[j][2], ah[1], al[1]);
        split(x[j][1], ah[2], al[2]);
        split(x[j][3], ah[3], al[3]);
        const float* bp = b + (8 * j + 2 * t) * P + g;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          uint32_t bh[2], bl[2];
          split(bp[8 * n], bh[0], bl[0]);
          split(bp[P + 8 * n], bh[1], bl[1]);
          mma3(part[n], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
    }
  }
};

__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// a warp's [16][64] accumulator into rows r0 + g, r0 + g + 8 (below rows)
// of out (row stride rs), columns from col
template <typename T>
__device__ __forceinline__ void store_acc(T* out, long long rs, int r0,
                                          int rows, int col,
                                          const float (*acc)[4], float s0,
                                          float s1, int g, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= rows) continue;
    T* p = out + r * rs + col + 2 * t;
    const float s = half ? s1 : s0;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      store2(p + 8 * n, acc[n][2 * half] * s, acc[n][2 * half + 1] * s);
  }
}

// One call's operands. q / k / v: element (b, i, h, d) at b * sb + i * sl +
// h * D + d; o, dO, dq [B, Lq, H, D] and dk, dv [B, Lk, H, D] contiguous;
// the list [B][list_s1]; lse, di [B, H, Lq] fp32
struct WideArgs {
  const void* q;
  const void* k;
  const void* v;
  const unsigned char* valid;
  int* list;
  long long list_s1;
  void* o;
  float* lse;
  const void* dout;
  const float* di;
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;
  int B, Lq, Lk, H, D, lk_pad;
  float scale, scale_log2;
};

// the row's listed tiles (its count; 0: none, every tile visited) and the
// first key of visit vi
__device__ __forceinline__ int first_key(const int* lst, bool uniform,
                                         int vi) {
  return (uniform ? vi : lst[1 + vi]) * WR;
}

// The forward. CTA (query tile qt and chunk c, head, batch row); per visit
// of a listed key tile, NC items of (Q_dc, K_dc) in the ring, the last
// with the chunk's V_c and the keys' mask; then the softmax and O_c += P
// V_c.
template <typename T>
__global__ void __launch_bounds__(WT)
wide_fwd_kernel(const WideArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = Tile<T>::P, TB = Tile<T>::BYTES;
  T* ring = reinterpret_cast<T*>(smem);  // [2 stages][Q, K]
  T* vt = reinterpret_cast<T*>(smem + 4 * TB);
  float* bias = reinterpret_cast<float*>(smem + 5 * TB);  // [WR] 0 or -inf
  const int nc = a.D / WL, qt = blockIdx.x / nc, c = blockIdx.x % nc;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int* lst = a.list + b * a.list_s1;
  const bool uniform = lst[0] == 0;
  const int visits = uniform ? (a.Lk + WR - 1) / WR : lst[0];
  const int q0 = qt * WR, qrows = min(WR, a.Lq - q0);
  const T* q = (const T*)a.q + b * a.q_sb + (long long)h * a.D + q0 * a.q_sl;
  const T* k = (const T*)a.k + b * a.k_sb + (long long)h * a.D;
  const T* v = (const T*)a.v + b * a.v_sb + (long long)h * a.D + c * WL;
  const unsigned char* vld = a.valid + (long long)b * a.Lk;

  auto load_item = [&](int it) {
    const int vi = it / nc, dc = it % nc, key0 = first_key(lst, uniform, vi);
    T* st = ring + (it & 1) * 2 * (TB / (int)sizeof(T));
    load_tile(st, q + dc * WL, a.q_sl, qrows);
    load_tile(st + TB / sizeof(T), k + key0 * a.k_sl + dc * WL, a.k_sl,
              a.Lk - key0);
    if (dc == nc - 1) {
      load_tile(vt, v + key0 * a.v_sl, a.v_sl, a.Lk - key0);
      if (tid < WR) {
        const int key = key0 + tid;
        bias[tid] = key < a.Lk && (uniform || vld[key]) ? 0.f : neg_inf();
      }
    }
    cp_async_commit();
  };

  float o[8][4], s[8][4];
  zero(o);
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
  const int items = visits * nc;
  load_item(0);
  for (int it = 0; it < items; ++it) {
    const int dc = it % nc;
    if (it + 1 < items) {
      load_item(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* st = ring + (it & 1) * 2 * (TB / (int)sizeof(T));
    if (dc == 0) zero(s);
    Mma<T>::rows_by_rows(s, st + 16 * w * P, st + TB / sizeof(T), g, t);
    if (dc == nc - 1) {
      if (uniform) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = bias[8 * j + 2 * t + (e & 1)] == 0.f ? 1.f : 0.f;
      } else {
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = fmaf(s[j][e], a.scale_log2,
                           bias[8 * j + 2 * t + (e & 1)]);
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
        float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = group_max(mx[r]);
          alpha[r] = exp2f(m[r] - mx[r]);
          m[r] = mx[r];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = exp2f(s[j][e] - m[e >> 1]);
            sum[e >> 1] += s[j][e];
            o[j][e] *= alpha[e >> 1];
          }
        l[0] = l[0] * alpha[0] + sum[0];
        l[1] = l[1] * alpha[1] + sum[1];
      }
      Mma<T>::regs_by_tile(o, s, vt, g, t);
    }
    __syncthreads();
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = uniform ? (float)a.lk_pad : group_sum(l[r]);
    inv[r] = 1.f / l[r];
  }
  const long long rs = (long long)a.H * a.D;
  T* out = (T*)a.o + (long long)b * a.Lq * rs + (long long)h * a.D + c * WL;
  store_acc(out, rs, q0 + 16 * w, a.Lq, 0, o, inv[0], inv[1], g, t);
  if (a.lse && c == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + 16 * w + g + 8 * r;
      if (i < a.Lq)
        a.lse[((long long)b * a.H + h) * a.Lq + i] =
            uniform ? logf((float)a.lk_pad)
                    : (m[r] + log2f(l[r])) * 0.6931471805599453f;
    }
  }
}

// dkv. CTA (visit vi of 64 keys and chunk c, head, batch row): per query
// tile, 2 NC items, (K_dc, Q_dc) into S^T and (V_dc, dO_dc) into dP^T, the
// last with the tile's Q_c and dO_c and its lse log2 e and di; then P^T and
// dS^T on the accumulators, dV_c += P^T dO_c and dK_c += dS^T Q_c.
template <typename T>
__global__ void __launch_bounds__(WT)
wide_dkv_kernel(const WideArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = Tile<T>::P, TB = Tile<T>::BYTES, TE = TB / sizeof(T);
  T* ring = reinterpret_cast<T*>(smem);  // [2 stages][A, B]
  T* qc = reinterpret_cast<T*>(smem + 4 * TB);
  T* doc = reinterpret_cast<T*>(smem + 5 * TB);
  float* lse2 = reinterpret_cast<float*>(smem + 6 * TB);  // [WR]
  float* dis = lse2 + WR;                                   // [WR]
  const int nc = a.D / WL, vi = blockIdx.x / nc, c = blockIdx.x % nc;
  const int h = blockIdx.y, b = blockIdx.z;
  const int* lst = a.list + b * a.list_s1;
  const bool uniform = lst[0] == 0;
  if (vi >= (uniform ? (a.Lk + WR - 1) / WR : lst[0])) return;
  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int key0 = first_key(lst, uniform, vi);
  const long long hd = (long long)h * a.D, rs = (long long)a.H * a.D;
  const T* k = (const T*)a.k + b * a.k_sb + hd + key0 * a.k_sl;
  const T* v = (const T*)a.v + b * a.v_sb + hd + key0 * a.v_sl;
  const T* q = (const T*)a.q + b * a.q_sb + hd;
  const T* dout = (const T*)a.dout + (long long)b * a.Lq * rs + hd;
  const float* lse = a.lse + ((long long)b * a.H + h) * a.Lq;
  const float* di = a.di + ((long long)b * a.H + h) * a.Lq;
  const unsigned char* vld = a.valid + (long long)b * a.Lk;
  // this thread's two keys (rows g and g + 8 of the warp's 16)
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 16 * w + g + 8 * r;
    key_ok[r] = key < a.Lk && (uniform || vld[key]);
  }

  auto load_item = [&](int it) {
    const int qt = it / (2 * nc), dc = (it >> 1) % nc, half = it & 1;
    const int q0 = qt * WR, qrows = min(WR, a.Lq - q0);
    T* st = ring + (it & 1) * 2 * TE;
    if (half == 0) {
      load_tile(st, k + dc * WL, a.k_sl, a.Lk - key0);
      load_tile(st + TE, q + q0 * a.q_sl + dc * WL, a.q_sl, qrows);
    } else {
      load_tile(st, v + dc * WL, a.v_sl, a.Lk - key0);
      load_tile(st + TE, dout + q0 * rs + dc * WL, rs, qrows);
    }
    if (half == 1 && dc == nc - 1) {
      load_tile(qc, q + q0 * a.q_sl + c * WL, a.q_sl, qrows);
      load_tile(doc, dout + q0 * rs + c * WL, rs, qrows);
      if (tid < WR) {
        const int i = q0 + tid;
        lse2[tid] = i < a.Lq ? lse[i] * LOG2E : -neg_inf();
        dis[tid] = i < a.Lq ? di[i] : 0.f;
      }
    }
    cp_async_commit();
  };

  float dk[8][4], dv[8][4], st_[8][4], dp[8][4];
  zero(dk);
  zero(dv);
  const float inv_pad = 1.f / (float)a.lk_pad;
  const int items = ((a.Lq + WR - 1) / WR) * 2 * nc;
  load_item(0);
  for (int it = 0; it < items; ++it) {
    const int dc = (it >> 1) % nc, half = it & 1;
    if (it + 1 < items) {
      load_item(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* st = ring + (it & 1) * 2 * TE;
    if (half == 0) {
      if (dc == 0) zero(st_);
      Mma<T>::rows_by_rows(st_, st + 16 * w * P, st + TE, g, t);
    } else {
      if (dc == 0) zero(dp);
      Mma<T>::rows_by_rows(dp, st + 16 * w * P, st + TE, g, t);
    }
    if (half == 1 && dc == nc - 1) {
      const int q0 = it / (2 * nc) * WR;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          float p;
          if (uniform)
            p = key_ok[e >> 1] && q0 + col < a.Lq ? inv_pad : 0.f;
          else
            p = key_ok[e >> 1]
                    ? exp2f(fmaf(st_[j][e], a.scale_log2, -lse2[col]))
                    : 0.f;
          st_[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dis[col]) * a.scale;
        }
      Mma<T>::regs_by_tile(dv, st_, doc, g, t);
      Mma<T>::regs_by_tile(dk, dp, qc, g, t);
    }
    __syncthreads();
  }
  const long long off = (long long)b * a.Lk * rs + hd + c * WL;
  store_acc((T*)a.dk + off, rs, key0 + 16 * w, a.Lk, 0, dk, 1.f, 1.f, g, t);
  store_acc((T*)a.dv + off, rs, key0 + 16 * w, a.Lk, 0, dv, 1.f, 1.f, g, t);
}

// dq. CTA (query tile qt and chunk c, head, batch row): per visit, 2 NC
// items, (Q_dc, K_dc) into S and (dO_dc, V_dc) into dP, the last with the
// visit's K_c and key mask; then P and dS, dQ_c += dS K_c.
template <typename T>
__global__ void __launch_bounds__(WT)
wide_dq_kernel(const WideArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = Tile<T>::P, TB = Tile<T>::BYTES, TE = TB / sizeof(T);
  T* ring = reinterpret_cast<T*>(smem);  // [2 stages][A, B]
  T* kc = reinterpret_cast<T*>(smem + 4 * TB);
  float* bias = reinterpret_cast<float*>(smem + 5 * TB);  // [WR]
  const int nc = a.D / WL, qt = blockIdx.x / nc, c = blockIdx.x % nc;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int* lst = a.list + b * a.list_s1;
  const bool uniform = lst[0] == 0;
  const int visits = uniform ? (a.Lk + WR - 1) / WR : lst[0];
  const int q0 = qt * WR, qrows = min(WR, a.Lq - q0);
  const long long hd = (long long)h * a.D, rs = (long long)a.H * a.D;
  const T* q = (const T*)a.q + b * a.q_sb + hd + q0 * a.q_sl;
  const T* dout = (const T*)a.dout + ((long long)b * a.Lq + q0) * rs + hd;
  const T* k = (const T*)a.k + b * a.k_sb + hd;
  const T* v = (const T*)a.v + b * a.v_sb + hd;
  const unsigned char* vld = a.valid + (long long)b * a.Lk;
  // this thread's two query rows: lse log2 e (+inf past Lq) and di
  float lse2[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + 16 * w + g + 8 * r;
    const long long at = ((long long)b * a.H + h) * a.Lq + i;
    lse2[r] = i < a.Lq ? a.lse[at] * LOG2E : -neg_inf();
    di[r] = i < a.Lq ? a.di[at] : 0.f;
  }

  auto load_item = [&](int it) {
    const int vi = it / (2 * nc), dc = (it >> 1) % nc, half = it & 1;
    const int key0 = first_key(lst, uniform, vi);
    T* st = ring + (it & 1) * 2 * TE;
    if (half == 0) {
      load_tile(st, q + dc * WL, a.q_sl, qrows);
      load_tile(st + TE, k + key0 * a.k_sl + dc * WL, a.k_sl, a.Lk - key0);
    } else {
      load_tile(st, dout + dc * WL, rs, qrows);
      load_tile(st + TE, v + key0 * a.v_sl + dc * WL, a.v_sl, a.Lk - key0);
    }
    if (half == 1 && dc == nc - 1) {
      load_tile(kc, k + key0 * a.k_sl + c * WL, a.k_sl, a.Lk - key0);
      if (tid < WR) {
        const int key = key0 + tid;
        bias[tid] = key < a.Lk && (uniform || vld[key]) ? 0.f : neg_inf();
      }
    }
    cp_async_commit();
  };

  float dq[8][4], s[8][4], dp[8][4];
  zero(dq);
  const float inv_pad = 1.f / (float)a.lk_pad;
  const int items = visits * 2 * nc;
  load_item(0);
  for (int it = 0; it < items; ++it) {
    const int dc = (it >> 1) % nc, half = it & 1;
    if (it + 1 < items) {
      load_item(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* st = ring + (it & 1) * 2 * TE;
    if (half == 0) {
      if (dc == 0) zero(s);
      Mma<T>::rows_by_rows(s, st + 16 * w * P, st + TE, g, t);
    } else {
      if (dc == 0) zero(dp);
      Mma<T>::rows_by_rows(dp, st + 16 * w * P, st + TE, g, t);
    }
    if (half == 1 && dc == nc - 1) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float bk = bias[8 * j + 2 * t + (e & 1)];
          const int r = e >> 1;
          const float p =
              uniform ? (bk == 0.f ? inv_pad : 0.f)
                      : exp2f(fmaf(s[j][e], a.scale_log2, bk) - lse2[r]);
          dp[j][e] = p * (dp[j][e] - di[r]) * a.scale;
        }
      Mma<T>::regs_by_tile(dq, dp, kc, g, t);
    }
    __syncthreads();
  }
  T* out = (T*)a.dq + (long long)b * a.Lq * rs + hd + c * WL;
  store_acc(out, rs, q0 + 16 * w, a.Lq, 0, dq, 1.f, 1.f, g, t);
}

template <typename T>
inline int smem_bytes(int tiles) {
  return tiles * Tile<T>::BYTES + 2 * WR * 4;
}

// one kernel at its grid, with its dynamic shared memory (tiles of it)
template <typename T, typename K>
cudaError_t run(K kernel, int tiles, unsigned grid_x, const WideArgs& a,
                cudaStream_t s) {
  const int bytes = smem_bytes<T>(tiles);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(grid_x, a.H, a.B), WT, bytes, s>>>(a);
  return cudaGetLastError();
}

// the checks every entry makes; per16: elements in 16 bytes
bool bad_args(const WideArgs& a, int per16) {
  return a.D % WL != 0 || a.D <= 128 || a.D > WIDE_MAX || a.B < 1 ||
         a.B > 65535 || a.Lq < 1 || a.Lk < 1 || a.H < 1 || a.H > 65535 ||
         a.lk_pad < a.Lk || cdiv(a.Lk, WR) > 48 * 1024 ||
         (uintptr_t)a.q % 16 || (uintptr_t)a.k % 16 || (uintptr_t)a.v % 16 ||
         a.q_sb % per16 || a.q_sl % per16 || a.k_sb % per16 ||
         a.k_sl % per16 || a.v_sb % per16 || a.v_sl % per16;
}

WideArgs make_args(const void* q, const void* k, const void* v,
                   const void* valid, const void* list, int B, int Lq,
                   int Lk, int H, int D, long long q_sb, long long q_sl,
                   long long k_sb, long long k_sl, long long v_sb,
                   long long v_sl, float scale, int lk_pad) {
  WideArgs a = {};
  a.q = q; a.k = k; a.v = v;
  a.valid = (const unsigned char*)valid;
  a.list = (int*)list;
  a.list_s1 = 1 + cdiv(Lk, WR);
  a.q_sb = q_sb; a.q_sl = q_sl; a.k_sb = k_sb; a.k_sl = k_sl;
  a.v_sb = v_sb; a.v_sl = v_sl;
  a.B = B; a.Lq = Lq; a.Lk = Lk; a.H = H; a.D = D; a.lk_pad = lk_pad;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  return a;
}

template <typename T>
cudaError_t launch_fwd(const WideArgs& a, cudaStream_t s) {
  tile_list_kernel<WR><<<a.B, 1024, cdiv(a.Lk, WR), s>>>(a.valid, a.list,
                                                         a.Lk, a.list_s1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return run<T>(wide_fwd_kernel<T>, 5, cdiv(a.Lq, WR) * (a.D / WL), a, s);
}

}  // namespace

extern "C" {

// The forward. As flash_attention.cu's gvf_flash_attention (the same
// arguments), at D a multiple of 64 from 192 to 1024: q/k/v all bf16 (f32
// = 0) or all fp32 (f32 = 1), rows and batch strides 16-byte aligned;
// scratch: int32, the tile list [B, 1 + ceil(Lk / 64)] (the backward walks
// it); o [B, Lq, H, D] contiguous; lse: null or [B, H, Lq] fp32.
int gvf_flash_attention_wide(const void* q, const void* k, const void* v,
                             const void* valid, void* scratch, void* o,
                             void* lse, int B, int Lq, int Lk, int H, int D,
                             long long q_sb, long long q_sl, long long k_sb,
                             long long k_sl, long long v_sb, long long v_sl,
                             float scale, int lk_pad, int f32, void* stream) {
  WideArgs a = make_args(q, k, v, valid, scratch, B, Lq, Lk, H, D, q_sb, q_sl,
                         k_sb, k_sl, v_sb, v_sl, scale, lk_pad);
  a.o = o;
  a.lse = (float*)lse;
  if (bad_args(a, f32 ? 4 : 8)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(f32 ? launch_fwd<float>(a, s) : launch_fwd<bf16>(a, s));
}

// The backward, as flash_attention_bwd.cu's entries (the same arguments):
// list and lse the wide forward's, dout [B, Lq, H, D] contiguous, di [B, H,
// Lq] fp32; dkv writes the listed tiles' dk and dv [B, Lk, H, D] (zeroed by
// the caller), dq every row of dq [B, Lq, H, D]. fp32 here, bf16 in the
// _bf16 entries.
#define GVF_WIDE_BWD(SUFFIX, T)                                                \
  int gvf_flash_attention_wide_bwd_dkv##SUFFIX(                                \
      const void* q, const void* k, const void* v, const void* valid,          \
      const void* list, const void* lse, const void* dout, const void* di,     \
      void* dk, void* dv, int B, int Lq, int Lk, int H, int D, long long q_sb, \
      long long q_sl, long long k_sb, long long k_sl, long long v_sb,          \
      long long v_sl, float scale, int lk_pad, void* stream) {                 \
    WideArgs a = make_args(q, k, v, valid, list, B, Lq, Lk, H, D, q_sb, q_sl,  \
                           k_sb, k_sl, v_sb, v_sl, scale, lk_pad);             \
    a.lse = (float*)lse; a.dout = dout; a.di = (const float*)di;               \
    a.dk = dk; a.dv = dv;                                                      \
    if (bad_args(a, 16 / (int)sizeof(T))) return (int)cudaErrorInvalidValue;  \
    return (int)run<T>(wide_dkv_kernel<T>, 6, cdiv(Lk, WR) * (D / WL), a,      \
                       (cudaStream_t)stream);                                  \
  }                                                                            \
  int gvf_flash_attention_wide_bwd_dq##SUFFIX(                                 \
      const void* q, const void* k, const void* v, const void* valid,          \
      const void* list, const void* lse, const void* dout, const void* di,     \
      void* dq, int B, int Lq, int Lk, int H, int D, long long q_sb,           \
      long long q_sl, long long k_sb, long long k_sl, long long v_sb,          \
      long long v_sl, float scale, int lk_pad, void* stream) {                 \
    WideArgs a = make_args(q, k, v, valid, list, B, Lq, Lk, H, D, q_sb, q_sl,  \
                           k_sb, k_sl, v_sb, v_sl, scale, lk_pad);             \
    a.lse = (float*)lse; a.dout = dout; a.di = (const float*)di; a.dq = dq;    \
    if (bad_args(a, 16 / (int)sizeof(T))) return (int)cudaErrorInvalidValue;  \
    return (int)run<T>(wide_dq_kernel<T>, 5, cdiv(Lq, WR) * (D / WL), a,       \
                       (cudaStream_t)stream);                                  \
  }

GVF_WIDE_BWD(, float)
GVF_WIDE_BWD(_bf16, bf16)
#undef GVF_WIDE_BWD

}  // extern "C"
