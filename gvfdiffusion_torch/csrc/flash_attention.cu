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
// softmax over key blocks with a true running maximum, the row sum from the
// fp32 P and P rounded to the inputs' dtype for P V (bf16; in fp32 nothing
// is rounded); every query row computed, valid or not. A batch row with no
// valid key gives, on the TPU, the mean of V over the key count padded to
// 512 (every score equals the mask value, so P is 1 on every padded key,
// and the padding's V is 0): here the same, sum(V) / lk_pad.
//
// Every form skips the key tiles that hold no valid key. That is exact: such
// a tile adds exp(-0.7 * FLT_MAX - m) = 0 to a row that has a valid key, and
// a tile with a valid key sets every row's running maximum to a real score
// before any rounding matters. It is also what makes the torso affordable:
// its valid slots are a prefix (the downsample packs parents in code order),
// so ~3700 valid keys of 32768 visit 29 of 256 128-key tiles.
//
// Both dtypes run the Hopper attention core over a list of tiles.
// tile_list_kernel builds, per batch row on the device, the indices of the
// core's key tiles that hold a valid key, with their count; the core's
// producer and consumers loop over that list, and the producer writes each
// key's mask into the tile's bias row from the validity bytes (the mask
// value times log2 e is -inf in fp32). A batch row with no valid key visits
// no tile; the core writes 0 there and empty_rows_kernel then writes sum(V)
// / lk_pad on its every query row (and log(lk_pad) as its logsumexp).
//   bf16: attention_sm90.cuh's core (wgmma, a 3-stage TMA ring of K/V
//   tiles, the softmax in registers, 128 query rows a CTA; 128-key tiles,
//   64 at heads of 128).
//   fp32: attention_sm90_tf32.cuh's path of the core, the products by the
//   3xTF32 split on the tensor cores (64-key tiles, 32 at heads of 128).
// Either can also write each row's logsumexp (the bf16 core as its own
// instantiation, LSE), the residual of the backward kernels
// (flash_attention_bwd.cu in fp32, flash_attention_bwd_bf16.cu in bf16),
// which walk the same list of tiles.
//
// What bounds it on the H100: 4 * Lq * n_valid * H * D operations (0.50
// TFLOP at 3700 valid keys; every query row counts) against ~13 MB (bf16)
// or ~26 MB (fp32) of traffic: in bf16 the tensor cores (0.50 ms at the
// datasheet's 989 TFLOP/s; the visited tiles' masked keys add ~3%), under
// them the SFU's exp2 per visited score, as in every form of the core; in
// fp32 the same work in fp32 (7.4 ms at the 67 TFLOP/s of fp32 FFMA), done
// as three tf32 products on the tensor cores (4.5 ms of them at 495
// TFLOP/s).

#include "attention_sm90_tf32.cuh"
#include "flash_tiles.cuh"

namespace {

using namespace gvf;

// A batch row with no valid key (list count 0): every query row of head h
// gets sum(V) / lk_pad, the sum in fp32 over the real keys, and with lse
// the logsumexp log(lk_pad) (the backward takes P = 1 / lk_pad there
// itself). 256 threads: 256 / D key groups of D lanes each.
template <int D, typename T>
__global__ void __launch_bounds__(256)
empty_rows_kernel(const T* __restrict__ v, long long v_sb, long long v_sl,
                  const int* __restrict__ list, long long list_s1,
                  T* __restrict__ o, float* __restrict__ lse, int Lq, int Lk,
                  int H, int lk_pad) {
  constexpr int G = 256 / D;
  const int h = blockIdx.x, b = blockIdx.y;
  if (list[(long long)b * list_s1] != 0) return;
  __shared__ float part[256];
  const int d = threadIdx.x % D, g = threadIdx.x / D;
  const T* vb = v + b * v_sb + h * D + d;
  float sum = 0.f;
  for (int j = g; j < Lk; j += G) sum += to_f(vb[(long long)j * v_sl]);
  part[threadIdx.x] = sum;
  __syncthreads();
  float mean = 0.f;
#pragma unroll
  for (int i = 0; i < G; ++i) mean += part[i * D + d];
  const T m = from_f<T>(mean * (1.f / (float)lk_pad));
  T* ob = o + (long long)b * Lq * H * D + h * D + d;
  for (int i = g; i < Lq; i += G) ob[(long long)i * H * D] = m;
  if (lse)
    for (int i = threadIdx.x; i < Lq; i += 256)
      lse[((long long)b * H + h) * Lq + i] = logf((float)lk_pad);
}

// One call's operands: q/k/v on their strides, the validity bytes, the
// tile lists (scratch), o, the logsumexp (fp32, or null)
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const unsigned char* valid;
  int* list;
  void* o;
  float* lse;
  int B, Lq, Lk, H, lk_pad;
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;
  float scale;
};

// K7 at heads of D in T: bf16 on the core (attention_sm90.cuh), fp32 on its
// 3xTF32 path (attention_sm90_tf32.cuh), each over its own key tiles
template <int D, typename T>
cudaError_t launch_flash(const FlashArgs& a, cudaStream_t s) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int BK = F32 ? sm90::Tf32Cfg<D>::BK : sm90::Cfg<D, bf16>::BK;
  const int tiles = (int)cdiv(a.Lk, BK);
  if (tiles > 48 * 1024) return cudaErrorInvalidValue;  // the flags' bytes
  const long long list_s1 = 1 + tiles;
  tile_list_kernel<BK><<<a.B, 1024, tiles, s>>>(a.valid, a.list, a.Lk,
                                                list_s1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  AttnParams p;
  p.q = a.q; p.k = a.k; p.v = a.v; p.o = a.o;
  p.q_s1 = a.q_sb; p.q_s2 = 0; p.q_si = a.q_sl;
  p.k_s1 = a.k_sb; p.k_s2 = 0; p.k_sj = a.k_sl;
  p.v_s1 = a.v_sb; p.v_sj = a.v_sl;
  p.o_s1 = (long long)a.Lq * a.H * D; p.o_s2 = 0; p.o_si = (long long)a.H * D;
  p.nb2 = 1; p.Lq = a.Lq; p.Lk = a.Lk;
  p.qg = nullptr; p.kg = nullptr;
  p.valid = a.valid; p.valid_s1 = a.Lk;
  p.tiles = a.list; p.tiles_s1 = list_s1;
  p.lse = a.lse;
  p.scale = a.scale;
  p.scale_log2 = a.scale * LOG2E;
  if constexpr (F32)
    err = sm90::launch_attn_tf32<D>(p, a.H, a.B, s);
  else if (a.lse)
    err = sm90::launch_attn_sm90<D, bf16, bf16, bf16, false, false, true>(
        p, a.H, a.B, s);
  else
    err = sm90::launch_attn_sm90<D, bf16, bf16, bf16, false>(p, a.H, a.B, s);
  if (err != cudaSuccess) return err;
  empty_rows_kernel<D, T><<<dim3(a.H, a.B), 256, 0, s>>>(
      (const T*)a.v, a.v_sb, a.v_sl, a.list, list_s1, (T*)a.o, a.lse, a.Lq,
      a.Lk, a.H, a.lk_pad);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: element (b, i, h, d) at b * q_sb + i * q_sl + h * D + d, likewise k
// and v with their own strides; all bf16 (f32 = 0) or all fp32 (f32 = 1),
// rows and batch strides 16-byte aligned; D = 32, 64 or 128; valid: bool
// [B, Lk]; scratch: int32, the tile lists [B, 1 + ceil(Lk / BK)] (bf16: BK
// = 64 at D = 128, else 128; fp32: 32 at D = 128, else 64; the backward
// walks the same list); o: [B, Lq, H, D] contiguous, in the inputs' dtype;
// lse: null, or the [B, H, Lq] fp32 row logsumexp that the backward
// (flash_attention_bwd.cu, flash_attention_bwd_bf16.cu) reads; lk_pad: Lk
// padded to the TPU kernel's 512.
int gvf_flash_attention(const void* q, const void* k, const void* v,
                        const void* valid, void* scratch, void* o, void* lse,
                        int B,
                        int Lq, int Lk, int H, int D, long long q_sb,
                        long long q_sl, long long k_sb, long long k_sl,
                        long long v_sb, long long v_sl, float scale,
                        int lk_pad, int f32, void* stream) {
  if ((D != 32 && D != 64 && D != 128) || B < 1 || B > 65535 || Lq < 1 ||
      Lk < 1 || H < 1 || H > 65535 || lk_pad < Lk)
    return (int)cudaErrorInvalidValue;
  FlashArgs a;
  a.q = q; a.k = k; a.v = v; a.valid = (const unsigned char*)valid;
  a.list = (int*)scratch;
  a.o = o; a.lse = (float*)lse;
  a.B = B; a.Lq = Lq; a.Lk = Lk; a.H = H; a.lk_pad = lk_pad;
  a.q_sb = q_sb; a.q_sl = q_sl; a.k_sb = k_sb; a.k_sl = k_sl;
  a.v_sb = v_sb; a.v_sl = v_sl;
  a.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
#define GVF_FLASH(DV)                                       \
  return (int)(f32 ? launch_flash<DV, float>(a, s)          \
                   : launch_flash<DV, bf16>(a, s));
  if (D == 32) GVF_FLASH(32)
  if (D == 64) GVF_FLASH(64)
  GVF_FLASH(128)
#undef GVF_FLASH
}

}  // extern "C"
