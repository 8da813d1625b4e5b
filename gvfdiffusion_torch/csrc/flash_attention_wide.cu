// K7 at heads wider than 128 lanes for Hopper (sm_90a): the forward (with or
// without its logsumexp residual) and the two backward kernels, dkv and dq,
// in bf16 and fp32, at every head width D that is a multiple of 64 above
// 128 and that ops/_widths.py `wide_split` splits over a cluster (the
// wrapper zero-pads a head of another multiple of 8 above 128 to the next
// such width: `flash_card_width`; there is no cap on D). The static VAE's
// full attention at its 768 channels in 4, 3, 2 or 1 heads (main_vae
// --static_vae.num_heads=4 ... 1: D = 192 ... 768; encode_latent with such
// a VAE), and at any other channel count (--static_vae.model_channels=1152
// --static_vae.num_heads=1: D = 1152).
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
// The design: a cluster of CTAs along D, the scores formed once per tile
// pair, in all three kernels. The head's lanes are split over n CTAs of CL
// lanes each (192 where it divides D, else 128, else 64: ops/_widths.py
// `wide_split`; 1 CTA at 192, 4 at 768, 6 at 1152, 13 at 832, above 8 a
// non-portable cluster, at most CLUSTER_MAX = 16, so one cluster covers up
// to 3072 lanes; a head whose split would take more than 16 CTAs is padded
// to a multiple of 192: 1088 runs at 1152). Above 3072 lanes the grid
// holds P passes of a cluster of n CTAs of 64 lanes (D = P n 64, n <= 16):
// CTA r of pass p owns the output lanes of chunk r + p n, and sums into the
// partial scores its share of the lanes, the P chunks r + j n (j = 0 ..
// P - 1, in that order in every pass); a chunk other than its own is read
// into three or four more tiles before its product, without overlap (no
// model of the repo runs such a head). So each pass forms the scores once.
//
// The forward: a cluster per (128 query rows, pass, head, batch row), 8
// warps a CTA, warpgroup m owning query rows [64 m, 64 m + 64) of them. Q_c
// of both 64-row tiles stays in shared memory; K_c and V_c of each listed
// visit stream through a 2-stage cp.async ring (1 stage in fp32 at 192
// lanes: 227 KB), the visit's key mask read a visit ahead. For each tile
// pair each warpgroup forms the partial S = Q_c K_c^T over the CTA's CL
// lanes (bf16: wgmma m64n64k16, both tiles in shared memory; fp32: mma.sync
// m16n8k8 by the 3xTF32 split, 16 rows a warp, chains of 32 lanes summed
// in fp32). After a cluster barrier CTA r sums the r-th share of the two
// [64][64] tiles over the n partials, read from every CTA's shared memory
// in rank order (distributed shared memory, fp32 adds), and stores the
// sums to every CTA at the same place, so that each holds the same bits.
// After a second barrier each warp runs the online softmax on its 16 rows
// of the summed S (a true running maximum, the row sum from the fp32 P, P
// rounded to the inputs' dtype for P V): every CTA keeps the same
// statistics, and rank 0 alone writes the logsumexp. Each CTA accumulates
// only its own lanes, O_c += P V_c (bf16: wgmma m64nCLk16, P as the
// register A operand, V_c MN-major; fp32: mma.sync 3xTF32 in chains of 32
// keys). At n = 1 (D = 192) the scores stay in registers and no barrier is
// crossed. A batch row with no valid key forms no scores: P is 1 on every
// key below Lk.
//
// The backward: the n CTAs of one tile of 64 rows (dkv: the keys of a
// visit; dq: query rows) form a cluster; all share the tile and its list of
// visits, so a cluster whose visit is past its row's count leaves whole,
// before any barrier. For each tile pair (query tile, key visit) each CTA
// forms the partial S and dP over its own CL lanes only into shared memory:
// warps 0-3 S, warps 4-7 dP (bf16: one warpgroup's wgmma m64n64k16 each,
// both tiles in shared memory; fp32: mma.sync m16n8k8 by the 3xTF32 split,
// 16 rows a warp, chains of 32 lanes summed in fp32). After a cluster
// barrier, CTA r sums the r-th share of the [64][64] tiles over the n
// partials in rank order, as the forward does, forms P = exp2(s scale
// log2 e - lse log2 e) and dS = P (dP - di) scale there, and stores them
// into the same place in every CTA (a reduce-scatter, then an all-gather by
// stores). After a second barrier each CTA accumulates only its own lanes
// of the output: dkv dV_c += P^T dO_c (warps 0-3) and dK_c += dS^T Q_c
// (warps 4-7), dq dQ_c += dS K_c; in bf16 one warpgroup's wgmma m64nCLk16
// each (dq's by warpgroup 0), P^T or dS^T rounded to bf16 pairs as the
// register A operand and the tile MN-major; in fp32 mma.sync, 16 rows a
// warp (dq: and half the lanes), 3xTF32 in chains of 32 rows of B. Each
// lane of Q, K, V and dO is read once a tile pair, by the CTA that owns it:
// K_c and V_c (dkv) or Q_c and dO_c (dq) stay in shared memory, the others
// stream through a 2-stage cp.async ring (1 stage in fp32 at 192 lanes:
// 227 KB), the tile's lse and di (dkv) or key mask (dq) read a tile ahead.
// bf16 tiles sit in wgmma's 128-byte swizzle; fp32 tiles without padding,
// their 16-byte chunks permuted by the row (`at`), so that both fragment
// walks hit 32 banks. At n = 1 (D = 192) the barriers are the CTA's. No
// atomics: every output element has one owner.
//
// What bounds it on the H100: the products over the valid keys Nv, per head
// 4 Lq Nv D operations forward, 8 dkv and 6 dq, at the dense bf16 rate (989
// TFLOP/s) in bf16 and three tf32 products each at 495 in fp32; at the static
// VAE's 768 channels and two shells (15721 + 12219 valid keys) the forward
// 2.84 ms in bf16, 17.0 in fp32, dkv 5.69 / 34.09 and dq 4.27 / 25.57. Every
// kernel does the bound's products and no more, 1x (above 3072 lanes the
// score products P times): S once per tile pair forward, 4 Lq Nv D
// operations a head (S, P V), S and dP once in the backward, 8 in dkv (S,
// dP, dV, dK) and 6 in dq (S, dP, dQ). What keeps them above the bound:
// one CTA of 8 warps an SM (two where the shared memory allows), whose
// tensor cores wait through the two cluster barriers and the sum of each
// tile pair; in fp32 mma.sync and the 3xTF32 split of every operand as it
// is read (tf32 wgmma reads both operands K-major only: the products that
// sum over a tile's rows would need transposed copies, past 227 KB at 192
// lanes).

#include "attention_sm90.cuh"
#include "flash_tiles.cuh"

namespace gvf {
namespace sm90 {

// O, dV and dK over 192 lanes (the wide kernels in bf16): m64n192k16
template <>
__device__ __forceinline__ void wgmma_rs<192>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95},"
      " {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

}  // namespace sm90
}  // namespace gvf

namespace {

using namespace gvf;

constexpr int WL = 64;           // D's unit: the lanes of a chunk
constexpr int WR = 64;           // rows of a tile: query rows, or keys of a visit
constexpr int BT = 256;          // threads of a CTA: 8 warps, 2 warpgroups
constexpr int PE = WR * WR;      // elements of a [64][64] fp32 score tile
constexpr int CLUSTER_MAX = 16;  // the card's largest cluster (above 8:
                                 // non-portable, asked for at the launch)

constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

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

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3},"
      " {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

// One call's operands. q / k / v: element (b, i, h, d) at b * sb + i * sl +
// h * D + d; o, dO, dq [B, Lq, H, D] and dk, dv [B, Lk, H, D] contiguous;
// the list [B][list_s1]; lse, di [B, H, Lq] fp32; cluster: the CTAs of a
// cluster (n), D / (n lanes) the passes
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
  int B, Lq, Lk, H, D, lk_pad, cluster;
  float scale, scale_log2;
};

// the row's listed tiles (its count; 0: none, every tile visited) and the
// first key of visit vi
__device__ __forceinline__ int first_key(const int* lst, bool uniform,
                                         int vi) {
  return (uniform ? vi : lst[1 + vi]) * WR;
}

// fp32: element (r, c) of a row-major tile of W columns sits at r W + (c ^
// swz(r)), a row's 16-byte chunks permuted by the row, so that the warps'
// fragment reads (rows g at columns t, and rows t, t + 4 at columns g) hit
// 32 banks. bf16: wgmma's 128-byte swizzle in 64-lane regions
// (sm90::Sw<W>), 1024-byte aligned.
__device__ __forceinline__ int swz(int r) {
  return ((r & 3) << 3) | (r & 4);
}

template <int W>
__device__ __forceinline__ int at(int r, int c) {
  return r * W + (c ^ swz(r));
}

template <typename T, int W>
__device__ __forceinline__ int tile_at(int r, int c) {
  if constexpr (sizeof(T) == 2)
    return sm90::Sw<W>::off(r, c >> 3, WR) / 2 + (c & 7);
  else
    return at<W>(r, c);
}

// rows [0, rows) of a [64][W] tile from g (row r at g + r * sl), the
// others zero; by the CTA's BT threads, 16 bytes each
template <typename T, int W>
__device__ __forceinline__ void load_rows(T* s, const T* g, long long sl,
                                          int rows, int tid) {
  constexpr int PER = 16 / sizeof(T), ROW = W / PER;
#pragma unroll 4
  for (int p = tid; p < WR * ROW; p += BT) {
    const int r = p / ROW, e = (p % ROW) * PER;
    const bool ok = r < rows;
    cp_async16(s + tile_at<T, W>(r, e), ok ? g + r * sl + e : g, ok);
  }
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// A warp's two products (a thread holds rows g and g + 8 of the warp's 16,
// columns 8 j + 2 t and + 1 of n-tile j):
//   rows_by_rows: acc[8][4] += A B^T over the W lanes of two [64][W]
//   tiles, A the warp's 16 rows from ar0 of tile a, B the 64 rows of b;
//   regs_by_tile: acc[NT][4] += X B, X the warp's 16 rows from xr0 of a
//   [64][64] fp32 score tile (P or dS), B columns n0 .. n0 + 8 NT of a
//   [64][W] tile whose rows are the sum's.
template <typename T>
struct Bk;

// bf16: one warpgroup's wgmma (warps 0-3 or 4-7; a warp's accumulator
// rows are its 16 of the warpgroup's 64, the fragment layout of mma.sync's
// m16n8): rows_by_rows m64n64k16 with both tiles K-major in shared memory;
// regs_by_tile m64nWk16 with X rounded to bf16 pairs as the register A
// operand (the stock kernels' casts of P and dS) and the tile MN-major,
// every lane of it (n0 = 0, 8 NT = W).
template <>
struct Bk<bf16> {
  template <int W>
  __device__ static void rows_by_rows(float (*acc)[4], const bf16* a, int,
                                      const bf16* b, int) {
    using S = sm90::Sw<W>;
    const uint32_t ab = sm90::smem_u32(a), bb = sm90::smem_u32(b);
    float* d = &acc[0][0];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk)
      sm90::wgmma_ss<64>(d, S::kmajor(ab, kk, WR), S::kmajor(bb, kk, WR), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs<32>(d);
  }

  template <int W, int NT>
  __device__ static void regs_by_tile(float (*acc)[4], const float* x,
                                      int xr0, const bf16* b, int n0,
                                      int lane) {
    static_assert(8 * NT == W, "every lane of the tile");
    const int g = lane >> 2, t = lane & 3;
    uint32_t af[WR / 16][4];
#pragma unroll
    for (int kk = 0; kk < WR / 16; ++kk) {
      const int c = 16 * kk + 2 * t;
      const float2 x0 = ld2(x + at<WR>(xr0 + g, c));
      const float2 x1 = ld2(x + at<WR>(xr0 + g + 8, c));
      const float2 x2 = ld2(x + at<WR>(xr0 + g, c + 8));
      const float2 x3 = ld2(x + at<WR>(xr0 + g + 8, c + 8));
      af[kk][0] = pack_f(x0.x, x0.y);
      af[kk][1] = pack_f(x1.x, x1.y);
      af[kk][2] = pack_f(x2.x, x2.y);
      af[kk][3] = pack_f(x3.x, x3.y);
    }
    by_tile<W, NT>(acc, af, b);
  }

  // the same with X the warp's own [16][64] accumulator (the forward's P):
  // its m16n8 layout is the A operand's k16 one, so no shared memory
  template <int W, int NT>
  __device__ static void acc_by_tile(float (*acc)[4], const float (*x)[4],
                                     const bf16* b) {
    uint32_t af[WR / 16][4];
#pragma unroll
    for (int kk = 0; kk < WR / 16; ++kk) {
      af[kk][0] = pack_f(x[2 * kk][0], x[2 * kk][1]);
      af[kk][1] = pack_f(x[2 * kk][2], x[2 * kk][3]);
      af[kk][2] = pack_f(x[2 * kk + 1][0], x[2 * kk + 1][1]);
      af[kk][3] = pack_f(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    }
    by_tile<W, NT>(acc, af, b);
  }

  template <int W, int NT>
  __device__ static void by_tile(float (*acc)[4], uint32_t (*af)[4],
                                 const bf16* b) {
    using S = sm90::Sw<W>;
    const uint32_t bb = sm90::smem_u32(b);
    float* d = &acc[0][0];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WR / 16; ++kk)
      sm90::wgmma_rs<W>(d, af[kk], S::mnmajor(bb, kk, WR));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs<4 * NT>(d);
    sm90::fence_regs_u<4 * WR / 16>(&af[0][0]);
  }
};

// fp32: every product by the 3xTF32 split, in chains of 32 lanes (or rows
// of B) summed in fp32
template <>
struct Bk<float> {
  template <int W>
  __device__ static void rows_by_rows(float (*acc)[4], const float* a,
                                      int ar0, const float* b, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
    for (int ch = 0; ch < W / 32; ++ch) {
      float part[8][4] = {};
#pragma unroll
      for (int kk = 4 * ch; kk < 4 * ch + 4; ++kk) {
        const int c = 8 * kk + t;
        uint32_t ah[4], al[4];
        split(a[at<W>(ar0 + g, c)], ah[0], al[0]);
        split(a[at<W>(ar0 + g + 8, c)], ah[1], al[1]);
        split(a[at<W>(ar0 + g, c + 4)], ah[2], al[2]);
        split(a[at<W>(ar0 + g + 8, c + 4)], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t bh[2], bl[2];
          split(b[at<W>(8 * j + g, c)], bh[0], bl[0]);
          split(b[at<W>(8 * j + g, c + 4)], bh[1], bl[1]);
          mma3(part[j], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
    }
  }

  template <int W, int NT>
  __device__ static void regs_by_tile(float (*acc)[4], const float* x,
                                      int xr0, const float* b, int n0,
                                      int lane) {
    constexpr int NB = NT % 8 == 0 ? 8 : 4;  // n-tiles a pass
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nb = 0; nb < NT / NB; ++nb)
#pragma unroll 1
      for (int ch = 0; ch < 2; ++ch) {
        float part[NB][4] = {};
#pragma unroll
        for (int kk = 4 * ch; kk < 4 * ch + 4; ++kk) {
          const int c = 8 * kk + t;
          uint32_t ah[4], al[4];
          split(x[at<WR>(xr0 + g, c)], ah[0], al[0]);
          split(x[at<WR>(xr0 + g + 8, c)], ah[1], al[1]);
          split(x[at<WR>(xr0 + g, c + 4)], ah[2], al[2]);
          split(x[at<WR>(xr0 + g + 8, c + 4)], ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            const int col = n0 + 8 * (nb * NB + j) + g;
            uint32_t bh[2], bl[2];
            split(b[at<W>(c, col)], bh[0], bl[0]);
            split(b[at<W>(c + 4, col)], bh[1], bl[1]);
            mma3(part[j], ah, al, bh, bl);
          }
        }
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nb * NB + j][e] += part[j][e];
      }
  }
};

// a warp's [16][64] accumulator into rows r0 + g, r0 + g + 8 of a score tile
__device__ __forceinline__ void store_scores(float* x, int r0,
                                             const float (*acc)[4], int g,
                                             int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;
    *reinterpret_cast<float2*>(x + at<WR>(r0 + g, c)) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(x + at<WR>(r0 + g + 8, c)) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// the same rows of a score tile back into a warp's accumulator
__device__ __forceinline__ void load_scores(float (*acc)[4], const float* x,
                                            int r0, int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 a = ld2(x + at<WR>(r0 + g, c));
    const float2 b = ld2(x + at<WR>(r0 + g + 8, c));
    acc[j][0] = a.x;
    acc[j][1] = a.y;
    acc[j][2] = b.x;
    acc[j][3] = b.y;
  }
}

// a warp's [16][8 NT] accumulator into rows r0 + g, r0 + g + 8 (below rows)
// of out (row stride rs)
template <int NT, typename T>
__device__ __forceinline__ void store_out(T* out, long long rs, int r0,
                                          int rows, const float (*acc)[4],
                                          int g, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= rows) continue;
    T* p = out + r * rs + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      store2(p + 8 * n, acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// the shared-memory address addr of this CTA at the same place in CTA
// `rank` of the cluster
__device__ __forceinline__ unsigned peer(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float4 ld_peer(unsigned addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_peer(unsigned addr, const float* v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

// every thread of the cluster: what any wrote before, to its own shared
// memory or a peer's, is seen by all after
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ float pos_inf() { return -neg_inf(); }

// The forward's sum of the cluster's partial scores: the two [64][64] fp32
// tiles at part_s in every CTA, this CTA's 1 / n share of their 16-byte
// chunks (by rank) read from every CTA in rank order (four reads in flight)
// and added in fp32, the sums stored back to every CTA at the same place.
// So each CTA ends with the same bits.
__device__ __forceinline__ void reduce_sum(unsigned part_s, int n, int rank,
                                           int tid) {
  constexpr int CH = 2 * PE / 4;
  const int lo = rank * CH / n, hi = (rank + 1) * CH / n;
  for (int i = lo + tid; i < hi; i += BT) {
    const unsigned off = part_s + (unsigned)i * 16u;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j0 = 0; j0 < n; j0 += 4) {
      float4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j0 + u < n) x[u] = ld_peer(peer(off, j0 + u));
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j0 + u < n) {
          s[0] += x[u].x;
          s[1] += x[u].y;
          s[2] += x[u].z;
          s[3] += x[u].w;
        }
    }
    for (int j = 0; j < n; ++j) st_peer(peer(off, j), s);
  }
}

// ---- the forward --------------------------------------------------------------

// The forward's shared memory at CL lanes: Q_c of the cluster's two 64-row
// query tiles (resident), STAGES stages of K_c and V_c, the two [64][64]
// fp32 score tiles (a warpgroup's partial S, then the cluster's sum; in
// fp32 then its P), the visits' key mask [2][64] by parity; in bf16 from
// a 1024-byte aligned base. With passes (64 lanes a CTA) three more tiles
// from XOFF: Q_j of both query tiles and K_j of another chunk of the
// CTA's share. fp32 at 192 lanes keeps one stage: two would pass 227 KB.
template <typename T, int CL>
struct Fw {
  static constexpr int STAGES = sizeof(T) == 4 && CL == 192 ? 1 : 2;
  static constexpr int TE = WR * CL;
  static constexpr int PART = (2 + 2 * STAGES) * TE * (int)sizeof(T);
  static constexpr int ALIGN = sizeof(T) == 2 ? 1024 : 0;
  static constexpr int END = PART + 2 * PE * 4 + 2 * WR * 4;
  static constexpr int BYTES = END + ALIGN;
  static constexpr int XOFF = round_up(END, 1024);
  static constexpr int XBYTES = XOFF + 3 * TE * (int)sizeof(T) + ALIGN;
  static constexpr int MIN_BLOCKS = BYTES <= 100 * 1024 ? 2 : 1;
};

// A cluster of n CTAs per (128 query rows, pass, head, batch row), CTA c
// (its rank) owning lanes [(c + pass n) CL, + CL): Q_c of both 64-row
// tiles resident, per visit of a listed key tile K_c and V_c through the
// ring. Warpgroup m forms the partial S = Q_c K_c^T of rows [64 m, 64 m +
// 64) over the CTA's lanes (and, with passes, the other chunks of its
// share); the cluster sums them (reduce_sum); each warp runs the online
// softmax on its 16 rows and accumulates O_c += P V_c.
template <typename T, int CL, bool PASSES>
__global__ void __launch_bounds__(BT, (Fw<T, CL>::MIN_BLOCKS))
wide_fwd_kernel(const WideArgs a) {
  using L = Fw<T, CL>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  if constexpr (L::ALIGN > 0)
    smem += (L::ALIGN - (smem_addr(smem_raw) & (L::ALIGN - 1))) &
            (L::ALIGN - 1);
  T* qs = reinterpret_cast<T*>(smem);  // [2][Q_c]
  T* ring = qs + 2 * L::TE;            // [STAGES][K_c, V_c]
  float* part = reinterpret_cast<float*>(smem + L::PART);  // [2][64][64]
  float* kbias = part + 2 * PE;  // [2][64]: 0 on a key that counts, or -inf
  T* xt = reinterpret_cast<T*>(smem + L::XOFF);  // passes: [2][Q_j], K_j
  const int n = a.cluster, c = cluster_rank();
  const int passes = PASSES ? a.D / (n * CL) : 1;
  const int cl = blockIdx.x / n;
  const int qt = PASSES ? cl / passes : cl, pass = PASSES ? cl % passes : 0;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wr = 16 * (w & 3), m = w >> 2;
  const int* lst = a.list + b * a.list_s1;
  const bool uniform = lst[0] == 0;
  const int visits = uniform ? (a.Lk + WR - 1) / WR : lst[0];
  const int q0 = qt * 2 * WR;
  const long long hd = (long long)h * a.D + (long long)(c + pass * n) * CL;
  const long long step = (long long)n * CL;  // to the share's next chunk
  const T* q = (const T*)a.q + b * a.q_sb + hd + q0 * a.q_sl;
  const T* k = (const T*)a.k + b * a.k_sb + hd;
  const T* v = (const T*)a.v + b * a.v_sb + hd;
  const unsigned char* vld = a.valid + (long long)b * a.Lk;
  // both query tiles' rows of the chunk d0 lanes from the CTA's own
  auto load_queries = [&](T* dst, long long d0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      load_rows<T, CL>(dst + i * L::TE, q + d0 + i * WR * a.q_sl, a.q_sl,
                       a.Lq - q0 - i * WR, tid);
  };
  load_queries(qs, 0);
  auto load_keys = [&](int vi) {
    T* st = ring + (vi % L::STAGES) * 2 * L::TE;
    const int key0 = first_key(lst, uniform, vi);
    if (!uniform)  // a row with no valid key forms no scores
      load_rows<T, CL>(st, k + key0 * a.k_sl, a.k_sl, a.Lk - key0, tid);
    load_rows<T, CL>(st + L::TE, v + key0 * a.v_sl, a.v_sl, a.Lk - key0,
                     tid);
    cp_async_commit();
  };
  load_keys(0);
  // the mask of key tid of visit vi
  auto key_bias = [&](int vi) {
    const int key = first_key(lst, uniform, vi) + tid;
    return key < a.Lk && (uniform || vld[key]) ? 0.f : neg_inf();
  };
  if (tid < WR) kbias[tid] = key_bias(0);

  const unsigned part_s = smem_addr(part);
  float* mine = part + m * PE;  // the warpgroup's score tile
  float acc[CL / 8][4];         // O_c: the warp's 16 rows, the CTA's lanes
#pragma unroll
  for (int j = 0; j < CL / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float mrow[2] = {neg_inf(), neg_inf()}, lrow[2] = {0.f, 0.f};
  for (int vi = 0; vi < visits; ++vi) {
    if (L::STAGES == 1 && vi > 0) {
      __syncthreads();  // the last visit's products are done with the stage
      load_keys(vi);
    }
    cp_async_wait<0>();
    if constexpr (sizeof(T) == 2) sm90::fence_async();  // for wgmma's reads
    __syncthreads();
    const T* st = ring + (vi % L::STAGES) * 2 * L::TE;
    const bool more = vi + 1 < visits;
    float next_bias = 0.f;
    if (more) {
      if (L::STAGES == 2) load_keys(vi + 1);
      if (tid < WR) next_bias = key_bias(vi + 1);
    }
    const float* kb = kbias + (vi & 1) * WR;
    float s[8][4];
    if (uniform) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = kb[8 * j + 2 * t + (e & 1)] == 0.f ? 1.f : 0.f;
    } else {
      zero(s);
      if constexpr (!PASSES) {
        Bk<T>::template rows_by_rows<CL>(s, qs + m * L::TE, wr, st, lane);
      } else {
        for (int j = 0; j < passes; ++j) {
          if (j == pass) {
            Bk<T>::template rows_by_rows<CL>(s, qs + m * L::TE, wr, st,
                                             lane);
            continue;
          }
          // another chunk of the share: its Q_j and K_j, read here
          const long long dj = (j - pass) * step;
          const int key0 = first_key(lst, uniform, vi);
          __syncthreads();  // the last chunk's products are done with xt
          load_queries(xt, dj);
          load_rows<T, CL>(xt + 2 * L::TE, k + dj + key0 * a.k_sl, a.k_sl,
                           a.Lk - key0, tid);
          cp_async_commit();
          cp_async_wait<0>();
          if constexpr (sizeof(T) == 2) sm90::fence_async();
          __syncthreads();
          Bk<T>::template rows_by_rows<CL>(s, xt + m * L::TE, wr,
                                           xt + 2 * L::TE, lane);
        }
      }
      if (n > 1) {
        store_scores(mine, wr, s, g, t);
        cluster_sync();  // every CTA's partial S is in place
        reduce_sum(part_s, n, c, tid);
        cluster_sync();  // the sums are in every CTA
        load_scores(s, mine, wr, g, t);
      }
      // the online softmax in the log2 domain, on the summed S
      float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = fmaf(s[j][e], a.scale_log2, kb[8 * j + 2 * t + (e & 1)]);
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = group_max(mx[r]);
        alpha[r] = exp2f(mrow[r] - mx[r]);
        mrow[r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(s[j][e] - mrow[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int j = 0; j < CL / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
      lrow[0] = lrow[0] * alpha[0] + sum[0];
      lrow[1] = lrow[1] * alpha[1] + sum[1];
    }
    // O_c += P V_c: in bf16 P from the registers, in fp32 through the
    // warp's own rows of its warpgroup's tile
    if constexpr (sizeof(T) == 2) {
      Bk<T>::template acc_by_tile<CL, CL / 8>(acc, s, st + L::TE);
    } else {
      store_scores(mine, wr, s, g, t);
      __syncwarp();
      Bk<T>::template regs_by_tile<CL, CL / 8>(acc, mine, wr, st + L::TE, 0,
                                               lane);
    }
    if (more && tid < WR) kbias[((vi + 1) & 1) * WR + tid] = next_bias;
  }
  // no CTA reads a peer's shared memory past the last cluster barrier
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lrow[r] = uniform ? (float)a.lk_pad : group_sum(lrow[r]);
    inv[r] = 1.f / lrow[r];
  }
#pragma unroll
  for (int j = 0; j < CL / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= inv[e >> 1];
  const long long rs = (long long)a.H * a.D;
  const int r0 = q0 + m * WR + wr;
  store_out<CL / 8>((T*)a.o + (long long)b * a.Lq * rs + hd, rs, r0, a.Lq,
                    acc, g, t);
  if (a.lse && c == 0 && pass == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r0 + g + 8 * r;
      if (i < a.Lq)
        a.lse[((long long)b * a.H + h) * a.Lq + i] =
            uniform ? logf((float)a.lk_pad)
                    : (mrow[r] + log2f(lrow[r])) * 0.6931471805599453f;
    }
  }
}

// ---- the backward -------------------------------------------------------------

// A backward CTA's shared memory at CL lanes: two resident [64][CL] tiles
// (K_c and V_c in dkv, Q_c and dO_c in dq), STAGES stages of two streamed
// ones (Q_c and dO_c of a query tile, or K_c and V_c of a visit), the two
// fp32 score tiles [64][64] (S and dP, then P and dS), then 5 x 64 floats
// of row and column statistics; in bf16 from a 1024-byte aligned base
// (wgmma's swizzle atoms). With passes (64 lanes a CTA) four more tiles
// from XOFF: another chunk of the share's K_j, V_j, Q_j and dO_j (dkv) or
// Q_j, dO_j, K_j and V_j (dq). fp32 at 192 lanes keeps one stage: two
// would pass 227 KB.
template <typename T, int CL>
struct Bw {
  static constexpr int STAGES = sizeof(T) == 4 && CL == 192 ? 1 : 2;
  static constexpr int TE = WR * CL;
  static constexpr int PART = (2 + 2 * STAGES) * TE * (int)sizeof(T);
  static constexpr int ALIGN = sizeof(T) == 2 ? 1024 : 0;
  static constexpr int END = PART + 2 * PE * 4 + 5 * WR * 4;
  static constexpr int BYTES = END + ALIGN;
  static constexpr int XOFF = round_up(END, 1024);
  static constexpr int XBYTES = XOFF + 4 * TE * (int)sizeof(T) + ALIGN;
  static constexpr int MIN_BLOCKS = BYTES <= 100 * 1024 ? 2 : 1;
};

// the barrier between the phases of a tile pair: the cluster's, or the
// CTA's (which costs less) where one CTA holds the whole head (n = 1: D =
// 192)
__device__ __forceinline__ void pair_sync(int n) {
  if (n == 1)
    __syncthreads();
  else
    cluster_sync();
}

// The scores of one tile pair summed over the cluster: this CTA's slice of
// the [64][64] tiles (a 1 / n share of their 16-byte chunks, by rank), the
// n partial S and dP read from every CTA in rank order and added in fp32,
// then `finish` (r: the tile's row, c0: the first of its 4 columns, s and
// dp the sums) writes P and dS and returns true, or dS alone and false;
// they are stored to every CTA at the same place. So each CTA ends with
// the same bits.
template <typename F>
__device__ __forceinline__ void reduce_scores(unsigned part_s, int n, int rank,
                                              int tid, F finish) {
  const int lo = rank * (PE / 4) / n, hi = (rank + 1) * (PE / 4) / n;
  for (int i = lo + tid; i < hi; i += BT) {
    const int r = i >> 4, e0 = (i & 15) * 4;
    const unsigned off = part_s + (unsigned)(r * WR + e0) * 4u;
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < n; ++j) {
      const unsigned pa = peer(off, j);
      const float4 x = ld_peer(pa), y = ld_peer(pa + PE * 4);
      s[0] += x.x; s[1] += x.y; s[2] += x.z; s[3] += x.w;
      dp[0] += y.x; dp[1] += y.y; dp[2] += y.z; dp[3] += y.w;
    }
    float p[4], ds[4];
    const bool with_p = finish(r, e0 ^ swz(r), s, dp, p, ds);
    for (int j = 0; j < n; ++j) {
      const unsigned pa = peer(off, j);
      if (with_p) st_peer(pa, p);
      st_peer(pa + PE * 4, ds);
    }
  }
}

// dkv. A cluster of n CTAs per (visit vi of 64 keys, pass, head, batch
// row), CTA c (its rank) owning lanes [(c + pass n) CL, + CL): K_c and V_c
// resident; per query tile Q_c and dO_c through the ring, the tile's lse
// log2 e and di read a tile ahead. Warps 0-3 form the partial S^T = K_c
// Q_c^T over the CTA's lanes, warps 4-7 dP^T = V_c dO_c^T (16 keys a
// warp; with passes, over every chunk of the share); the cluster sums them
// (reduce_scores) into P^T and dS^T; then warps 0-3 accumulate dV_c += P^T
// dO_c and warps 4-7 dK_c += dS^T Q_c.
template <typename T, int CL, bool PASSES>
__global__ void __launch_bounds__(BT, (Bw<T, CL>::MIN_BLOCKS))
wide_dkv_kernel(const WideArgs a) {
  using L = Bw<T, CL>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  if constexpr (L::ALIGN > 0)
    smem += (L::ALIGN - (smem_addr(smem_raw) & (L::ALIGN - 1))) &
            (L::ALIGN - 1);
  T* kt = reinterpret_cast<T*>(smem);
  T* vt = kt + L::TE;
  T* ring = vt + L::TE;  // [STAGES][Q_c, dO_c]
  float* part = reinterpret_cast<float*>(smem + L::PART);  // S^T, dP^T
  float* kok = part + 2 * PE;  // [64]: 1 on a key that counts, else 0
  float* qst = kok + WR;       // [2][lse log2 e [64], di [64]] by parity
  T* xt = reinterpret_cast<T*>(smem + L::XOFF);  // passes: K_j V_j Q_j dO_j
  const int n = PASSES ? a.cluster : a.D / CL, c = cluster_rank();
  const int passes = PASSES ? a.D / (n * CL) : 1;
  const int cl = blockIdx.x / n;
  const int vi = PASSES ? cl / passes : cl, pass = PASSES ? cl % passes : 0;
  const int h = blockIdx.y, b = blockIdx.z;
  const int* lst = a.list + b * a.list_s1;
  const bool uniform = lst[0] == 0;
  // the cluster's CTAs share the visit: they leave here together, before
  // any cluster barrier
  if (vi >= (uniform ? (a.Lk + WR - 1) / WR : lst[0])) return;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wr = 16 * (w & 3), mat = w >> 2;
  const int key0 = first_key(lst, uniform, vi);
  const long long hd = (long long)h * a.D + (long long)(c + pass * n) * CL;
  const long long rs = (long long)a.H * a.D, step = (long long)n * CL;
  const T* q = (const T*)a.q + b * a.q_sb + hd;
  const T* dout = (const T*)a.dout + (long long)b * a.Lq * rs + hd;
  const T* kc = (const T*)a.k + b * a.k_sb + hd + key0 * a.k_sl;
  const T* vc = (const T*)a.v + b * a.v_sb + hd + key0 * a.v_sl;
  const float* lse = a.lse + ((long long)b * a.H + h) * a.Lq;
  const float* di = a.di + ((long long)b * a.H + h) * a.Lq;
  load_rows<T, CL>(kt, kc, a.k_sl, a.Lk - key0, tid);
  load_rows<T, CL>(vt, vc, a.v_sl, a.Lk - key0, tid);
  auto load_queries = [&](int qt) {
    T* st = ring + (qt % L::STAGES) * 2 * L::TE;
    const int q0 = qt * WR;
    load_rows<T, CL>(st, q + q0 * a.q_sl, a.q_sl, a.Lq - q0, tid);
    load_rows<T, CL>(st + L::TE, dout + q0 * rs, rs, a.Lq - q0, tid);
    cp_async_commit();
  };
  load_queries(0);
  // query row qt WR + tid's lse log2 e (+inf past Lq) and di (0 past Lq)
  auto query_stats = [&](int qt, float& l2, float& d) {
    const int i = qt * WR + tid;
    l2 = i < a.Lq ? lse[i] * LOG2E : pos_inf();
    d = i < a.Lq ? di[i] : 0.f;
  };
  if (tid < WR) {
    const int key = key0 + tid;
    kok[tid] =
        key < a.Lk && (uniform || a.valid[(long long)b * a.Lk + key]) ? 1.f
                                                                      : 0.f;
    query_stats(0, qst[tid], qst[WR + tid]);
  }

  const float inv_pad = 1.f / (float)a.lk_pad;
  const unsigned part_s = smem_addr(part);
  float acc[CL / 8][4];  // dV_c (warps 0-3) or dK_c (4-7): 16 keys a warp
#pragma unroll
  for (int j = 0; j < CL / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int nq = (a.Lq + WR - 1) / WR;
  for (int qt = 0; qt < nq; ++qt) {
    if (L::STAGES == 1 && qt > 0) {
      __syncthreads();  // the last tile's products are done with the stage
      load_queries(qt);
    }
    cp_async_wait<0>();
    if constexpr (sizeof(T) == 2) sm90::fence_async();  // for wgmma's reads
    __syncthreads();
    const T* st = ring + (qt % L::STAGES) * 2 * L::TE;
    {
      float s[8][4];
      zero(s);
      if constexpr (!PASSES) {
        Bk<T>::template rows_by_rows<CL>(s, mat ? vt : kt, wr,
                                         mat ? st + L::TE : st, lane);
      } else {
        for (int j = 0; j < passes; ++j) {
          if (j == pass) {
            Bk<T>::template rows_by_rows<CL>(s, mat ? vt : kt, wr,
                                             mat ? st + L::TE : st, lane);
            continue;
          }
          // another chunk of the share: its K_j, V_j, Q_j, dO_j
          const long long dj = (j - pass) * step;
          const int q0 = qt * WR;
          __syncthreads();  // the last chunk's products are done with xt
          load_rows<T, CL>(xt, kc + dj, a.k_sl, a.Lk - key0, tid);
          load_rows<T, CL>(xt + L::TE, vc + dj, a.v_sl, a.Lk - key0, tid);
          load_rows<T, CL>(xt + 2 * L::TE, q + dj + q0 * a.q_sl, a.q_sl,
                           a.Lq - q0, tid);
          load_rows<T, CL>(xt + 3 * L::TE, dout + dj + q0 * rs, rs,
                           a.Lq - q0, tid);
          cp_async_commit();
          cp_async_wait<0>();
          if constexpr (sizeof(T) == 2) sm90::fence_async();
          __syncthreads();
          Bk<T>::template rows_by_rows<CL>(s, xt + mat * L::TE, wr,
                                           xt + (2 + mat) * L::TE, lane);
        }
      }
      store_scores(part + mat * PE, wr, s, g, t);
    }
    pair_sync(n);  // every CTA's partial S^T and dP^T are in place
    const bool more = qt + 1 < nq;
    float next_l2 = 0.f, next_d = 0.f;
    if (more) {
      if (L::STAGES == 2) load_queries(qt + 1);
      if (tid < WR) query_stats(qt + 1, next_l2, next_d);
    }
    const float* qs = qst + (qt & 1) * 2 * WR;
    reduce_scores(part_s, n, c, tid,
                  [&](int r, int c0, const float* s, const float* dp,
                      float* p, float* ds) {
                    const bool ok = kok[r] != 0.f;
                    const float4 l4 = *reinterpret_cast<const float4*>(qs + c0);
                    const float4 d4 =
                        *reinterpret_cast<const float4*>(qs + WR + c0);
                    const float l2[4] = {l4.x, l4.y, l4.z, l4.w};
                    const float d[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                      float pe;
                      if (uniform)
                        pe = ok && l2[e] != pos_inf() ? inv_pad : 0.f;
                      else
                        pe = ok ? exp2f(fmaf(s[e], a.scale_log2, -l2[e]))
                                : 0.f;
                      p[e] = pe;
                      ds[e] = pe * (dp[e] - d[e]) * a.scale;
                    }
                    return true;
                  });
    pair_sync(n);  // P^T and dS^T are in every CTA
    Bk<T>::template regs_by_tile<CL, CL / 8>(acc, part + mat * PE, wr,
                                             mat ? st : st + L::TE, 0, lane);
    if (more && tid < WR) {
      float* ns = qst + ((qt + 1) & 1) * 2 * WR;
      ns[tid] = next_l2;
      ns[WR + tid] = next_d;
    }
  }
  // no CTA reads a peer's shared memory past the last cluster barrier
  T* out = (T*)(mat ? a.dk : a.dv) + (long long)b * a.Lk * rs + hd;
  store_out<CL / 8>(out, rs, key0 + wr, a.Lk, acc, g, t);
}

// dq. A cluster of n CTAs per (query tile of 64 rows, pass, head, batch
// row), CTA c owning lanes [(c + pass n) CL, + CL): Q_c and dO_c resident;
// per visit K_c and V_c through the ring, the visit's key mask read a visit
// ahead. Warps 0-3 form the partial S = Q_c K_c^T, warps 4-7 dP = dO_c
// V_c^T (with passes, over every chunk of the share); the cluster sums them
// into dS; then dQ_c += dS K_c (bf16: warps 0-3's wgmma over every lane;
// fp32: every warp, 16 rows and half the lanes).
template <typename T, int CL, bool PASSES>
__global__ void __launch_bounds__(BT, (Bw<T, CL>::MIN_BLOCKS))
wide_dq_kernel(const WideArgs a) {
  using L = Bw<T, CL>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  if constexpr (L::ALIGN > 0)
    smem += (L::ALIGN - (smem_addr(smem_raw) & (L::ALIGN - 1))) &
            (L::ALIGN - 1);
  T* qt_ = reinterpret_cast<T*>(smem);
  T* ot = qt_ + L::TE;
  T* ring = ot + L::TE;  // [STAGES][K_c, V_c]
  float* part = reinterpret_cast<float*>(smem + L::PART);  // S, dP
  float* rst = part + 2 * PE;  // the rows' lse log2 e [64], di [64]
  float* kbias = rst + 2 * WR;  // [2][64]: 0 on a key that counts, or -inf
  T* xt = reinterpret_cast<T*>(smem + L::XOFF);  // passes: Q_j dO_j K_j V_j
  const int n = PASSES ? a.cluster : a.D / CL, c = cluster_rank();
  const int passes = PASSES ? a.D / (n * CL) : 1;
  const int cl = blockIdx.x / n;
  const int qt = PASSES ? cl / passes : cl, pass = PASSES ? cl % passes : 0;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wr = 16 * (w & 3), mat = w >> 2;
  const int* lst = a.list + b * a.list_s1;
  const bool uniform = lst[0] == 0;
  const int visits = uniform ? (a.Lk + WR - 1) / WR : lst[0];
  const int q0 = qt * WR;
  const long long hd = (long long)h * a.D + (long long)(c + pass * n) * CL;
  const long long rs = (long long)a.H * a.D, step = (long long)n * CL;
  const T* qc = (const T*)a.q + b * a.q_sb + hd + q0 * a.q_sl;
  const T* oc = (const T*)a.dout + ((long long)b * a.Lq + q0) * rs + hd;
  const T* k = (const T*)a.k + b * a.k_sb + hd;
  const T* v = (const T*)a.v + b * a.v_sb + hd;
  const unsigned char* vld = a.valid + (long long)b * a.Lk;
  load_rows<T, CL>(qt_, qc, a.q_sl, a.Lq - q0, tid);
  load_rows<T, CL>(ot, oc, rs, a.Lq - q0, tid);
  auto load_keys = [&](int vi) {
    T* st = ring + (vi % L::STAGES) * 2 * L::TE;
    const int key0 = first_key(lst, uniform, vi);
    load_rows<T, CL>(st, k + key0 * a.k_sl, a.k_sl, a.Lk - key0, tid);
    load_rows<T, CL>(st + L::TE, v + key0 * a.v_sl, a.v_sl, a.Lk - key0, tid);
    cp_async_commit();
  };
  load_keys(0);
  // the mask of key tid of visit vi
  auto key_bias = [&](int vi) {
    const int key = first_key(lst, uniform, vi) + tid;
    return key < a.Lk && (uniform || vld[key]) ? 0.f : neg_inf();
  };
  if (tid < WR) {
    const int i = q0 + tid;
    const long long at = ((long long)b * a.H + h) * a.Lq + i;
    rst[tid] = i < a.Lq ? a.lse[at] * LOG2E : pos_inf();
    rst[WR + tid] = i < a.Lq ? a.di[at] : 0.f;
    kbias[tid] = key_bias(0);
  }

  const float inv_pad = 1.f / (float)a.lk_pad;
  const unsigned part_s = smem_addr(part);
  // dQ_c's n-tiles a warp: bf16, warpgroup 0's wgmma over every lane (16
  // rows a warp); fp32, 16 rows and half the lanes a warp
  constexpr int NQ = sizeof(T) == 2 ? CL / 8 : CL / 16;
  float acc[NQ][4];
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int vi = 0; vi < visits; ++vi) {
    if (L::STAGES == 1 && vi > 0) {
      __syncthreads();  // the last visit's products are done with the stage
      load_keys(vi);
    }
    cp_async_wait<0>();
    if constexpr (sizeof(T) == 2) sm90::fence_async();  // for wgmma's reads
    __syncthreads();
    const T* st = ring + (vi % L::STAGES) * 2 * L::TE;
    {
      float s[8][4];
      zero(s);
      if constexpr (!PASSES) {
        Bk<T>::template rows_by_rows<CL>(s, mat ? ot : qt_, wr,
                                         mat ? st + L::TE : st, lane);
      } else {
        for (int j = 0; j < passes; ++j) {
          if (j == pass) {
            Bk<T>::template rows_by_rows<CL>(s, mat ? ot : qt_, wr,
                                             mat ? st + L::TE : st, lane);
            continue;
          }
          // another chunk of the share: its Q_j, dO_j, K_j, V_j
          const long long dj = (j - pass) * step;
          const int key0 = first_key(lst, uniform, vi);
          __syncthreads();  // the last chunk's products are done with xt
          load_rows<T, CL>(xt, qc + dj, a.q_sl, a.Lq - q0, tid);
          load_rows<T, CL>(xt + L::TE, oc + dj, rs, a.Lq - q0, tid);
          load_rows<T, CL>(xt + 2 * L::TE, k + dj + key0 * a.k_sl, a.k_sl,
                           a.Lk - key0, tid);
          load_rows<T, CL>(xt + 3 * L::TE, v + dj + key0 * a.v_sl, a.v_sl,
                           a.Lk - key0, tid);
          cp_async_commit();
          cp_async_wait<0>();
          if constexpr (sizeof(T) == 2) sm90::fence_async();
          __syncthreads();
          Bk<T>::template rows_by_rows<CL>(s, xt + mat * L::TE, wr,
                                           xt + (2 + mat) * L::TE, lane);
        }
      }
      store_scores(part + mat * PE, wr, s, g, t);
    }
    pair_sync(n);  // every CTA's partial S and dP are in place
    const bool more = vi + 1 < visits;
    float next_bias = 0.f;
    if (more) {
      if (L::STAGES == 2) load_keys(vi + 1);
      if (tid < WR) next_bias = key_bias(vi + 1);
    }
    const float* kb = kbias + (vi & 1) * WR;
    reduce_scores(part_s, n, c, tid,
                  [&](int r, int c0, const float* s, const float* dp,
                      float* p, float* ds) {
                    const float l2 = rst[r], d = rst[WR + r];
                    const float4 b4 = *reinterpret_cast<const float4*>(kb + c0);
                    const float bk[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                      const float pe =
                          uniform ? (bk[e] == 0.f ? inv_pad : 0.f)
                                  : exp2f(fmaf(s[e], a.scale_log2, bk[e]) - l2);
                      ds[e] = pe * (dp[e] - d) * a.scale;
                    }
                    return false;
                  });
    pair_sync(n);  // dS is in every CTA
    if (sizeof(T) == 4 || mat == 0)
      Bk<T>::template regs_by_tile<CL, NQ>(acc, part + PE, wr, st,
                                           mat * (CL / 2), lane);
    if (more && tid < WR) kbias[((vi + 1) & 1) * WR + tid] = next_bias;
  }
  T* out = (T*)a.dq + (long long)b * a.Lq * rs + hd + mat * (CL / 2);
  if (sizeof(T) == 4 || mat == 0)
    store_out<NQ>(out, rs, q0 + wr, a.Lq, acc, g, t);
}

// the checks every entry makes; per16: elements in 16 bytes
bool bad_args(const WideArgs& a, int per16) {
  return a.D % WL != 0 || a.D <= 128 || a.B < 1 || a.B > 65535 || a.Lq < 1 ||
         a.Lk < 1 || a.H < 1 || a.H > 65535 || a.lk_pad < a.Lk ||
         cdiv(a.Lk, WR) > 48 * 1024 || (uintptr_t)a.q % 16 ||
         (uintptr_t)a.k % 16 || (uintptr_t)a.v % 16 || a.q_sb % per16 ||
         a.q_sl % per16 || a.k_sb % per16 || a.k_sl % per16 ||
         a.v_sb % per16 || a.v_sl % per16;
}

// the split every kernel takes (ops/_widths.py `wide_split`): 64, 128 or
// 192 lanes a CTA and 1 to CLUSTER_MAX CTAs a cluster, their product
// dividing D; more than one pass at 64 lanes only (the extra tiles' room)
bool bad_split(const WideArgs& a, int lanes) {
  if ((lanes != 64 && lanes != 128 && lanes != 192) || a.cluster < 1 ||
      a.cluster > CLUSTER_MAX)
    return true;
  const int span = lanes * a.cluster;
  return a.D % span != 0 || (a.D / span > 1 && lanes != 64);
}

WideArgs make_args(const void* q, const void* k, const void* v,
                   const void* valid, const void* list, int B, int Lq,
                   int Lk, int H, int D, long long q_sb, long long q_sl,
                   long long k_sb, long long k_sl, long long v_sb,
                   long long v_sl, float scale, int lk_pad, int ctas) {
  WideArgs a = {};
  a.q = q; a.k = k; a.v = v;
  a.valid = (const unsigned char*)valid;
  a.list = (int*)list;
  a.list_s1 = 1 + cdiv(Lk, WR);
  a.q_sb = q_sb; a.q_sl = q_sl; a.k_sb = k_sb; a.k_sl = k_sl;
  a.v_sb = v_sb; a.v_sl = v_sl;
  a.B = B; a.Lq = Lq; a.Lk = Lk; a.H = H; a.D = D; a.lk_pad = lk_pad;
  a.cluster = ctas;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  return a;
}

// One kernel over grid_x CTAs along x (a cluster of a.cluster of them per
// tile of rows and pass) by heads and batch rows, with `bytes` of dynamic
// shared memory, launched with the cluster's dimension. A launch the card
// refuses (a cluster it cannot place) returns its error.
cudaError_t run_cluster(void (*kernel)(WideArgs), int bytes, unsigned grid_x,
                        const WideArgs& a, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && a.cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, a.H, a.B);
  cfg.blockDim = dim3(BT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the forward at CL lanes a CTA: clusters per 128 query rows and pass
// (passes at 64 lanes only: bad_split)
template <typename T, int CL>
cudaError_t run_fwd(const WideArgs& a, cudaStream_t s) {
  using L = Fw<T, CL>;
  const int passes = a.D / (a.cluster * CL);
  const unsigned grid_x = cdiv(a.Lq, 2 * WR) * passes * a.cluster;
  if constexpr (CL == 64)
    if (passes > 1)
      return run_cluster(wide_fwd_kernel<T, CL, true>, L::XBYTES, grid_x, a,
                         s);
  return run_cluster(wide_fwd_kernel<T, CL, false>, L::BYTES, grid_x, a, s);
}

template <typename T>
cudaError_t launch_fwd(const WideArgs& a, int lanes, cudaStream_t s) {
  tile_list_kernel<WR><<<a.B, 1024, cdiv(a.Lk, WR), s>>>(a.valid, a.list,
                                                         a.Lk, a.list_s1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (lanes) {
    case 64: return run_fwd<T, 64>(a, s);
    case 128: return run_fwd<T, 128>(a, s);
    case 192: return run_fwd<T, 192>(a, s);
  }
  return cudaErrorInvalidValue;
}

// one backward kernel at CL lanes a CTA: clusters per tile of 64 rows (keys
// of a visit in dkv, query rows in dq) and pass
template <typename T, int CL>
cudaError_t run_bwd(bool dkv, const WideArgs& a, cudaStream_t s) {
  using L = Bw<T, CL>;
  const int passes = a.D / (a.cluster * CL);
  const unsigned grid_x = cdiv(dkv ? a.Lk : a.Lq, WR) * passes * a.cluster;
  if constexpr (CL == 64)
    if (passes > 1) {
      void (*kernel)(WideArgs) =
          dkv ? wide_dkv_kernel<T, CL, true> : wide_dq_kernel<T, CL, true>;
      return run_cluster(kernel, L::XBYTES, grid_x, a, s);
    }
  void (*kernel)(WideArgs) =
      dkv ? wide_dkv_kernel<T, CL, false> : wide_dq_kernel<T, CL, false>;
  return run_cluster(kernel, L::BYTES, grid_x, a, s);
}

template <typename T>
cudaError_t launch_bwd(bool dkv, const WideArgs& a, int lanes,
                       cudaStream_t s) {
  switch (lanes) {
    case 64: return run_bwd<T, 64>(dkv, a, s);
    case 128: return run_bwd<T, 128>(dkv, a, s);
    case 192: return run_bwd<T, 192>(dkv, a, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The forward. As flash_attention.cu's gvf_flash_attention (the same
// arguments), at D a multiple of 64 above 128, with the split last (lanes a
// CTA and CTAs a cluster: ops/_widths.py `wide_split`): q/k/v all bf16 (f32
// = 0) or all fp32 (f32 = 1), rows and batch strides 16-byte aligned;
// scratch: int32, the tile list [B, 1 + ceil(Lk / 64)] (the backward walks
// it); o [B, Lq, H, D] contiguous; lse: null or [B, H, Lq] fp32.
int gvf_flash_attention_wide(const void* q, const void* k, const void* v,
                             const void* valid, void* scratch, void* o,
                             void* lse, int B, int Lq, int Lk, int H, int D,
                             long long q_sb, long long q_sl, long long k_sb,
                             long long k_sl, long long v_sb, long long v_sl,
                             float scale, int lk_pad, int f32, int lanes,
                             int ctas, void* stream) {
  WideArgs a = make_args(q, k, v, valid, scratch, B, Lq, Lk, H, D, q_sb, q_sl,
                         k_sb, k_sl, v_sb, v_sl, scale, lk_pad, ctas);
  a.o = o;
  a.lse = (float*)lse;
  if (bad_args(a, f32 ? 4 : 8) || bad_split(a, lanes))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(f32 ? launch_fwd<float>(a, lanes, s)
                   : launch_fwd<bf16>(a, lanes, s));
}

// The backward, as flash_attention_bwd.cu's entries (the same arguments)
// and the forward's split, lanes and ctas: list and lse the wide forward's,
// dout [B, Lq, H, D] contiguous, di [B, H, Lq] fp32; dkv writes the listed
// tiles' dk and dv [B, Lk, H, D] (zeroed by the caller), dq every row of dq
// [B, Lq, H, D]. fp32 here, bf16 in the _bf16 entries.
#define GVF_WIDE_BWD(SUFFIX, T)                                                \
  int gvf_flash_attention_wide_bwd_dkv##SUFFIX(                                \
      const void* q, const void* k, const void* v, const void* valid,          \
      const void* list, const void* lse, const void* dout, const void* di,     \
      void* dk, void* dv, int B, int Lq, int Lk, int H, int D, long long q_sb, \
      long long q_sl, long long k_sb, long long k_sl, long long v_sb,          \
      long long v_sl, float scale, int lk_pad, int lanes, int ctas,            \
      void* stream) {                                                          \
    WideArgs a = make_args(q, k, v, valid, list, B, Lq, Lk, H, D, q_sb, q_sl,  \
                           k_sb, k_sl, v_sb, v_sl, scale, lk_pad, ctas);       \
    a.lse = (float*)lse; a.dout = dout; a.di = (const float*)di;               \
    a.dk = dk; a.dv = dv;                                                      \
    if (bad_args(a, 16 / (int)sizeof(T)) || bad_split(a, lanes))              \
      return (int)cudaErrorInvalidValue;                                       \
    return (int)launch_bwd<T>(true, a, lanes, (cudaStream_t)stream);          \
  }                                                                            \
  int gvf_flash_attention_wide_bwd_dq##SUFFIX(                                 \
      const void* q, const void* k, const void* v, const void* valid,          \
      const void* list, const void* lse, const void* dout, const void* di,     \
      void* dq, int B, int Lq, int Lk, int H, int D, long long q_sb,           \
      long long q_sl, long long k_sb, long long k_sl, long long v_sb,          \
      long long v_sl, float scale, int lk_pad, int lanes, int ctas,            \
      void* stream) {                                                          \
    WideArgs a = make_args(q, k, v, valid, list, B, Lq, Lk, H, D, q_sb, q_sl,  \
                           k_sb, k_sl, v_sb, v_sl, scale, lk_pad, ctas);       \
    a.lse = (float*)lse; a.dout = dout; a.di = (const float*)di; a.dq = dq;    \
    if (bad_args(a, 16 / (int)sizeof(T)) || bad_split(a, lanes))              \
      return (int)cudaErrorInvalidValue;                                       \
    return (int)launch_bwd<T>(false, a, lanes, (cudaStream_t)stream);         \
  }

GVF_WIDE_BWD(, float)
GVF_WIDE_BWD(_bf16, bf16)
#undef GVF_WIDE_BWD

}  // extern "C"
