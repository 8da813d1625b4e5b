// The list of key tiles that K7's kernels visit: per batch row, the tiles
// of BK keys that hold a valid key. flash_attention.cu builds it for the
// forward at heads up to 128 (its core's key tile), flash_attention_wide.cu
// at wider heads (64-key tiles); each backward walks its forward's list.
//
// In an anonymous namespace, as in each source that includes it: every
// translation unit keeps its own copy of the kernel.

#pragma once

namespace {

// One CTA per batch row b: list[b * list_s1] = the number n of BK-key tiles
// that hold a valid key, list[b * list_s1 + 1 ..] their indices ascending.
// A warp tests a tile (BK / 32 bytes a lane, coalesced) into a flag in
// shared memory ([tiles] bytes, dynamic); then chunks of 1024 flags are
// compacted in order by warp ballots and a scan of the 32 warp counts.
template <int BK>
__global__ void __launch_bounds__(1024)
tile_list_kernel(const unsigned char* __restrict__ valid,
                 int* __restrict__ list, int Lk, long long list_s1) {
  extern __shared__ unsigned char flag[];
  __shared__ int warp_n[32];
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned char* vb = valid + (long long)b * Lk;
  const int tiles = (Lk + BK - 1) / BK;
  for (int t = warp; t < tiles; t += 32) {
    int any = 0;
#pragma unroll
    for (int e = 0; e < BK / 32; ++e) {
      const int j = t * BK + e * 32 + lane;
      any |= j < Lk && vb[j];
    }
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) flag[t] = (unsigned char)any;
  }
  __syncthreads();
  int* out = list + (long long)b * list_s1;
  int base = 0;
  for (int t0 = 0; t0 < tiles; t0 += 1024) {
    const int t = t0 + tid;
    const bool f = t < tiles && flag[t];
    const unsigned m = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_n[warp] = __popc(m);
    __syncthreads();
    int before = base, total = 0;
#pragma unroll
    for (int w = 0; w < 32; ++w) {
      if (w < warp) before += warp_n[w];
      total += warp_n[w];
    }
    if (f) out[1 + before + __popc(m & ((1u << lane) - 1u))] = t;
    base += total;
    __syncthreads();  // warp_n is rewritten by the next chunk
  }
  if (tid == 0) out[0] = base;
}

}  // namespace
