// The Hopper attention core (sm_90a) under K5 (fused_attention.cu), the
// bf16 forms of K3 (fused_sublayer.cu: two contexts, and the single context
// at heads of 32, 64 and 128) and K1's float forms (fused_sublayer.cu's
// self sublayer). attention_sm90_q8.cuh builds the int8-QK path of K1 and
// K3's int8 form on its ring, barriers and tiles.
//
// Replaces, on the card, the attention of these Pallas TPU kernels:
//   gvfdiffusion_tpu/ops/fused_attention.py:370 fused_attention, bodies
//     _attn_kernel_dense :108 and _attn_kernel :154 (K5);
//   gvfdiffusion_tpu/ops/fused_sublayer.py:839 fused_cross_sublayer, body
//     _cross_sublayer_kernel :589 (K3's attention step);
//   gvfdiffusion_tpu/ops/fused_sublayer.py:344 fused_self_sublayer, body
//     _self_sublayer_kernel :170 (K1's attention step, float).
// K2 runs temporal_sm90.cuh instead: its T x T problems are too small.
//
// What it computes: O = softmax(Q K^T * scale + bias) V per (query row,
// head, row block), q read as bf16 or fp32 on its own strides (optionally
// RMS-normed per head in fp32 with gamma qg, then rounded to bf16), k and v
// as bf16 or fp32 on theirs and rounded to bf16 (K1's k arrives normed:
// gemm_sm90.cuh's qkv epilogue norms q and k), the products in bf16 with
// fp32 accumulation, P rounded to bf16 for P V and the row sum taken from
// the fp32 P, the output normalised once and written as bf16 or fp32. The
// softmax is online with a true running maximum, or (FIXED) the TPU
// kernels' fixed shift P = exp2(S * scale * log2 e - 30 + bias * log2 e)
// with no maximum and no rescale. Keys past Lk are masked; an optional fp32
// per-key logit bias (-inf masks the key) is added; a row with no visible
// key gives exactly 0, never NaN (the maximum is taken as 0 while it is
// -inf, so exp2(-inf - -inf) is never formed). With segments (K5's
// segment_size s, Lq == Lk a multiple of s) query row i sees only the keys
// of its segment, i / s == j / s: a CTA visits the run of key tiles that
// holds its rows' segments (two tiles at most at the DiT's packed temporal
// shape, s = 32 against 128-key tiles) and sets S to -inf on the keys of
// another segment inside them, so that P is exactly 0 there; a segment
// need not line up with a tile (at s = 32 a 128-key tile holds four).
//
// Design (the hopper-kernels guide, section 1): one CTA per (query tile of
// 64 * NWG rows, head, batch row); NWG consumer warpgroups of 64 query rows
// each, then the producer warps.
//  - The producer fills a ring of 3 stages of K/V tiles of BK keys, each
//    with its bias row (log2 e folded in, -inf past Lk) in shared memory.
//    Where k/v are bf16 (every form but the DiT's fp32 training path), one
//    lane issues TMA copies (cp.async.bulk.tensor, a 4-d map of [batch row,
//    key, head, lane] built per launch), which complete the stage's "full"
//    mbarrier by their byte count, rows past Lk zero-filled; the fp32 forms
//    take four producer warps that load, round to bf16 and store. Consumer
//    threads arrive on the stage's "empty" mbarrier once their products have
//    read it, and the producer refills it; it runs up to 3 tiles ahead.
//  - Each consumer warpgroup loads its 64 query rows once (the RMS norm and
//    the rounding there), then per tile: S = Q K^T with wgmma.mma_async
//    m64nBKk16 (both operands in shared memory); the softmax in registers
//    on the accumulator layout (each row is held by the 4 lanes of a quad:
//    the maximum by two shuffles, the row sums kept per thread and reduced
//    once at the end, exp2 on the SFU with the scale folded in); P rounded
//    to bf16 in registers and fed as wgmma's register A operand for O += P V
//    (m64nDk16, V read from shared memory as an MN-major B, the transposed
//    form); O is rescaled in registers and written once, normalised,
//    through a per-warp staging tile with 16-byte stores.
//  - Shared-memory tiles take wgmma's swizzled canonical layout, the one
//    TMA writes: rows of 128 bytes (heads of 64; two 64-lane regions at 128)
//    or 64 bytes (heads of 32) whose 16-byte chunks are XOR-permuted by the
//    row within 8-row atoms (Sw<D>), so TMA's writes, the fp32 producer's
//    and the Q prologue's 16-byte stores and wgmma's reads are free of bank
//    conflicts. The same tile serves K as a K-major B and V as an MN-major
//    B.
//  - Query tile: 128 rows (NWG = 2, one CTA an SM) when the grid has at
//    least one tile per SM of the 132, else 64 (NWG = 1: the
//    sparse-structure flow's [1, 512, 16, 64] has 64 tiles of 128). Key
//    tile: BK = 128 at heads of 32 and 64, 64 at heads of 128 (registers:
//    S 32 + O 64 a thread).
//
// What bounds it on the H100: the tensor cores (989 TFLOP/s dense bf16) at
// DINOv2's [32, 1374, 16, 64] (0.247 TFLOP: 0.25 ms), the SLat torso's
// [1, 4096, 16, 64] and K3's single context at [1, 32768, 1024] x 1374
// (0.185 TFLOP); the bytes at the DiT's fp32 training forms and the
// sparse-structure flow's [1, 512, 16, 64]. Under the tensor cores sits the
// SFU: one exp2 per score at 16 a clock an SM, 0.26 ms for DINOv2's 0.97e9
// scores, the same order as the products, and a warpgroup's softmax and its
// two products run one after another; the other warpgroup's work fills the
// gap (a software pipeline inside the warpgroup and an explicit ping-pong
// between the two were measured and gained nothing here). The fp32 forms
// are bound by their producer's loads and conversion.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <string.h>

#include "attention.cuh"

namespace gvf {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor: start address, LBO and SBO (bytes, stored
// in 16-byte units) and the swizzle mode (1: 128-byte, 2: 64-byte)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// orders this thread's view of shared memory written by plain stores (the
// generic proxy) before its wgmma reads (the async proxy); TMA's writes
// need none
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins the accumulator registers after a wait so that no read of them moves
// above it (and no write below the products that use them)
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// the same for the register A operand of an asynchronous product: its
// registers stay untouched until the wait
template <int N>
__device__ __forceinline__ void fence_regs_u(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// S = A B^T, both K-major in shared memory: d[N / 2] per thread
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d);
// O += A B, A from registers (4 x bf16x2), B MN-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// The 3xTF32 path (attention_sm90_tf32.cuh, gemm_sm90.cuh's fp32 GEMM): x
// = hi + lo with hi = tf32(x) rounded to nearest (ties away) and lo =
// tf32(x - hi); a product a.b is taken as lo.hi' + hi.lo' + hi.hi' (lo.lo'
// dropped) at the tensor cores' tf32 rate. The tensor cores' fp32
// accumulation loses more than an fp32 add over a long chain of
// products, so the callers keep each chain short and add its result into
// an fp32 sum of their own.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// S = A B^T in tf32, both K-major in shared memory: d[N / 2] per thread
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float* d, uint64_t da,
                                              uint64_t db, int scale_d);
// D = A B (+ D with scale_d) in tf32, A from registers (4 values: rows g
// and g + 8 of the warp's 16, k-columns t and t + 4, g = lane / 4, t =
// lane % 4), B K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float* d, const uint32_t* a,
                                              uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32_ss<32>(float* d, uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<64>(float* d, uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<128>(float* d, uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<32>(float* d, const uint32_t* a,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float* d, const uint32_t* a,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<128>(float* d, const uint32_t* a,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}


// 2^x on the SFU (denormal results flush to 0; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 8 consecutive values as floats (16 bytes of bf16, 32 of fp32)
__device__ __forceinline__ void load8(const bf16* src, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* src, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                    pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// The softmax of one tile on the S accumulator: sc[4 i + 2 hr + e] is row
// (16 warp + lane / 4 + 8 hr), key 8 i + 2 quad + e of the tile, and the 4
// lanes of a quad hold one row. bias_t: the tile's bias row, log2 e folded
// in, -inf past Lk (FIXED: 30 subtracted too). Writes P, rounded to bf16,
// as the register A operand of P V (k-step kk covers keys 16 kk .. 16 kk +
// 15: accumulator groups 2 kk and 2 kk + 1), adds the fp32 P to the
// per-thread row sums and, with a running maximum, returns in alpha the
// rescale of O and l (l already rescaled here).
template <int BK, bool FIXED>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             const float* bias_t,
                                             float scale_log2, int quad,
                                             float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&alpha)[2],
                                             uint32_t (&pa)[BK / 16][4]) {
  if (FIXED) {
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const float2 b =
          *reinterpret_cast<const float2*>(bias_t + 8 * i + 2 * quad);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float& x0 = sc[4 * i + 2 * hr];
        float& x1 = sc[4 * i + 2 * hr + 1];
        x0 = ex2(fmaf(x0, scale_log2, b.x));
        x1 = ex2(fmaf(x1, scale_log2, b.y));
        l_run[hr] += x0 + x1;
      }
    }
    alpha[0] = alpha[1] = 1.f;
  } else {
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const float2 b =
          *reinterpret_cast<const float2*>(bias_t + 8 * i + 2 * quad);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float& x0 = sc[4 * i + 2 * hr];
        float& x1 = sc[4 * i + 2 * hr + 1];
        x0 = fmaf(x0, scale_log2, b.x);
        x1 = fmaf(x1, scale_log2, b.y);
        mx[hr] = fmaxf(mx[hr], fmaxf(x0, x1));
      }
    }
    float m_use[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m_run[hr], mx[hr]);
      // while every key so far is masked the maximum is -inf: take 0, so
      // that P = exp2(-inf) = 0 and alpha = 0 (O and l are still 0)
      m_use[hr] = m_new == neg_inf() ? 0.f : m_new;
      alpha[hr] = ex2(m_run[hr] - m_use[hr]);
      m_run[hr] = m_new;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float& x0 = sc[4 * i + 2 * hr];
        float& x1 = sc[4 * i + 2 * hr + 1];
        x0 = ex2(x0 - m_use[hr]);
        x1 = ex2(x1 - m_use[hr]);
        ls[hr] += x0 + x1;
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l_run[hr] = l_run[hr] * alpha[hr] + ls[hr];
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// A tile of `rows` rows x D bf16 in shared memory, in the canonical
// layout of wgmma's swizzled modes (and of TMA's swizzled writes): rows of
// RB = min(2 D, 128) bytes, 1024-byte (RB 128) or 512-byte (RB 64) atoms of
// 8 rows whose 16-byte chunks are XOR-permuted by the row; D = 128 is two
// regions of 64 columns, one after the other.
template <int D>
struct Sw {
  static constexpr int RB = D * 2 >= 128 ? 128 : D * 2;
  static constexpr int CPR = RB / 16;  // 16-byte chunks a region row
  static constexpr uint64_t MODE = RB == 128 ? 1 : 2;
  // byte offset of chunk c (8 elements, c < D / 8) of row r
  __device__ static __forceinline__ int off(int r, int c, int rows) {
    const int x = RB == 128 ? (r & 7) : ((r >> 1) & 3);
    return (c / CPR) * rows * RB + r * RB + (((c % CPR) ^ x) << 4);
  }
  // K-major operand (Q as A, K as B): SBO = one 8-row atom; k-step kk
  // (16 columns, 32 bytes) moves along the row, then to the next region
  __device__ static __forceinline__ uint64_t kmajor(uint32_t base, int kk,
                                                    int rows) {
    const int b = (kk * 32) / RB * rows * RB + (kk * 32) % RB;
    return make_desc(base + b, 16, 8 * RB, MODE);
  }
  // MN-major operand (V as B of P V): along N (head lanes) regions LBO =
  // rows * RB apart, along K (keys) 8-row atoms SBO = 8 RB apart; k-step kk
  // covers keys 16 kk .. 16 kk + 15
  __device__ static __forceinline__ uint64_t mnmajor(uint32_t base, int kk,
                                                     int rows) {
    return make_desc(base + kk * 16 * RB, rows * RB, 8 * RB, MODE);
  }
};

// BK keys per tile; NPROD producer warps: one issues the TMA copies of bf16
// K/V, four load and convert fp32 K/V
template <int D, typename TKV>
struct Cfg {
  static constexpr int BK = D == 128 ? 64 : 128;
  static constexpr int NPROD = sizeof(TKV) == 2 ? 1 : 4;
  static constexpr int STAGES = 3;
};

// Shared memory, from a 1024-byte aligned base: Q [NWG][64 rows], per stage
// K and V [BK rows] (Sw<D> tiles), the bias rows [STAGES][BK] fp32, the
// output staging [NWG * 64][D + 8] TO (padded: the accumulator's 4- or
// 8-byte writes fall in distinct banks), then the full / empty mbarriers.
template <int D, int NWG, typename TO>
struct Smem {
  static constexpr int BK = Cfg<D, bf16>::BK, STAGES = Cfg<D, bf16>::STAGES;
  static constexpr int Q = 0;
  static constexpr int K = Q + NWG * 64 * D * 2;
  static constexpr int V = K + STAGES * BK * D * 2;
  static constexpr int BIAS = V + STAGES * BK * D * 2;
  static constexpr int O = BIAS + STAGES * BK * 4;
  static constexpr int OLD = D + 8;  // staging row, in TO elements
  static constexpr int BAR = O + NWG * 64 * OLD * (int)sizeof(TO);
  static constexpr int BYTES = BAR + 2 * STAGES * 8 + 1024;  // + alignment
};

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

template <int D, int NWG, typename TQ, typename TKV, typename TO, bool FIXED,
          bool SEG, bool LSE = false>
__global__ void __launch_bounds__(NWG * 128 + 32 * Cfg<D, TKV>::NPROD, 1)
    attn_sm90_kernel(const AttnParams p, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv) {
  constexpr int BK = Cfg<D, TKV>::BK, NPROD = Cfg<D, TKV>::NPROD;
  constexpr int STAGES = Cfg<D, TKV>::STAGES;
  using L = Smem<D, NWG, TO>;
  using S = Sw<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem + L::Q;
  unsigned char* sK = smem + L::K;
  unsigned char* sV = smem + L::V;
  float* sB = reinterpret_cast<float*>(smem + L::BIAS);
  TO* sO = reinterpret_cast<TO*>(smem + L::O);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const long long z1 = blockIdx.z / p.nb2, z2 = blockIdx.z % p.nb2;
  const int q0 = blockIdx.x * (64 * NWG);
  // the key tiles: every one, (K7) the row block's list, or (K5's
  // segment_size) the run of tiles first .. first + tiles - 1 that holds
  // the keys of the segments of this CTA's query rows
  const int* tl = p.tiles ? p.tiles + z1 * p.tiles_s1 : nullptr;
  int tiles = tl ? tl[0] : (p.Lk + BK - 1) / BK, first = 0;
  if constexpr (SEG) {
    const int qend = min(q0 + 64 * NWG, p.Lq);
    const int klo = (q0 / p.seg) * p.seg;
    const int khi = min(p.Lk, ((qend - 1) / p.seg + 1) * p.seg);
    first = klo / BK;
    tiles = (khi - 1) / BK - first + 1;
  }

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      // every producer lane arrives after its bias entries; with TMA, lane
      // 0 arrives once more with the transaction count
      mbar_init(&full[s], 32 * NPROD + (sizeof(TKV) == 2 ? 1 : 0));
      mbar_init(&empty[s], NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NWG * 128) {
    // ---- producer warps: K/V tiles and the bias row into the ring
    const int lane = tid & 31, pw = (tid >> 5) - NWG * 4;
    const int pt = tid - NWG * 128;
    const float* bb = p.bias ? p.bias + z1 * p.bias_s1 : nullptr;
    const unsigned char* vl = p.valid ? p.valid + z1 * p.valid_s1 : nullptr;
    for (int t = 0; t < tiles; ++t) {
      const int s = t % STAGES;
      if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
      const int j0 = (tl ? tl[1 + t] : first + t) * BK;
      const uint32_t dk = smem_u32(sK + s * BK * D * 2);
      const uint32_t dv = smem_u32(sV + s * BK * D * 2);
      if constexpr (sizeof(TKV) == 2) {
        // TMA: one box of RB / 2 head lanes x BK keys per region, rows past
        // Lk zero-filled; the copies complete the barrier's transaction
        // count, the expect_tx arrival is lane 0's
        if (lane == 0) {
          asm volatile(
              "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                  smem_u32(&full[s])),
              "r"(2 * BK * D * 2)
              : "memory");
#pragma unroll
          for (int g = 0; g < D * 2 / S::RB; ++g) {
            tma_load_4d(dk + g * BK * S::RB, &tk, g * (S::RB / 2), h, j0,
                        (int)z1, &full[s]);
            tma_load_4d(dv + g * BK * S::RB, &tv, g * (S::RB / 2), h, j0,
                        (int)z1, &full[s]);
          }
        }
      } else {
        // fp32: 8 lanes load the 8-value chunks of one row (contiguous in
        // global memory), round them and store them swizzled (distinct
        // banks)
        const TKV* kb = (const TKV*)p.k + z1 * p.k_s1 + z2 * p.k_s2 + h * D;
        const TKV* vb = (const TKV*)p.v + z1 * p.v_s1 + z2 * p.k_s2 + h * D;
        constexpr int CH = BK * D / 8;
#pragma unroll 4
        for (int idx = pw * 32 + lane; idx < CH; idx += 32 * NPROD) {
          const int r = idx / (D / 8), c = idx % (D / 8);
          const int j = j0 + r;
          float a[8], b[8];
          if (j < p.Lk) {
            load8(kb + (long long)j * p.k_sj + c * 8, a);
            load8(vb + (long long)j * p.v_sj + c * 8, b);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) a[e] = b[e] = 0.f;
          }
          const int o = S::off(r, c, BK);
          *reinterpret_cast<uint4*>(sK + s * BK * D * 2 + o) = pack8(a);
          *reinterpret_cast<uint4*>(sV + s * BK * D * 2 + o) = pack8(b);
        }
      }
      for (int i = pt; i < BK; i += 32 * NPROD) {
        const int j = j0 + i;
        float b = neg_inf();
        // an invalid key (K7) takes the TPU kernel's mask value -0.7 FLT_MAX,
        // which times log2 e is -inf in fp32: exact, since every visited tile
        // holds a valid key, so a row's maximum is a real score
        if (j < p.Lk) b = bb ? bb[j] * LOG2E : (vl && !vl[j]) ? neg_inf() : 0.f;
        if (FIXED) b -= EXP2_SHIFT;
        sB[s * BK + i] = b;
      }
      // releases the bias row (and the fp32 tiles' plain stores)
      mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63
  const int wg = tid >> 7, tw = tid & 127, warp = tw >> 5, lane = tid & 31;
  unsigned char* sQw = sQ + wg * 64 * D * 2;
  {
    // two threads per row, D / 2 values each: load, RMS norm, round
    const int r = tw >> 1, hf = tw & 1;
    const int qi = q0 + wg * 64 + r;
    const TQ* src = (const TQ*)p.q + z1 * p.q_s1 + z2 * p.q_s2 + h * D +
                    (long long)(qi < p.Lq ? qi : 0) * p.q_si + hf * (D / 2);
    float v[D / 2];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      if (qi < p.Lq) {
        load8(src + c * 8, v + c * 8);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[c * 8 + e] = 0.f;
      }
    }
    if (p.qg) {
      float ss = 0.f;
#pragma unroll
      for (int d = 0; d < D / 2; ++d) ss += v[d] * v[d];
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      const float f = rsqrtf(ss + 1e-12f);
      const bf16* g = p.qg + h * D + hf * (D / 2);
#pragma unroll
      for (int d = 0; d < D / 2; ++d) v[d] = v[d] * f * to_f(g[d]);
    }
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      *reinterpret_cast<uint4*>(sQw + S::off(r, hf * (D / 16) + c, 64)) =
          pack8(v + c * 8);
    fence_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  }

  const uint32_t q_base = smem_u32(sQw);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {neg_inf(), neg_inf()}, l_run[2] = {0.f, 0.f};
  float sc[BK / 2], alpha[2];
  uint32_t pa[BK / 16][4];
  const int quad = lane & 3;
  // with segments: the keys [seg_lo, seg_hi) of each of the thread's two
  // rows (16 warp + lane / 4 + 8 hr)
  int seg_lo[2] = {0, 0}, seg_hi[2] = {0, 0};
  if constexpr (SEG) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qi = q0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * hr;
      seg_lo[hr] = (qi / p.seg) * p.seg;
      seg_hi[hr] = seg_lo[hr] + p.seg;
    }
  }

  for (int t = 0; t < tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    if constexpr (sizeof(TKV) == 4) fence_async();  // the fp32 producer's stores
    // S = Q K^T
    const uint32_t k_base = smem_u32(sK + s * BK * D * 2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BK>(sc, S::kmajor(q_base, kk, 64), S::kmajor(k_base, kk, BK),
                   kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BK / 2>(sc);
    if constexpr (SEG) {
      // a key outside the row's segment: S = -inf, so that its exponent
      // (S times the positive scale plus the bias) is -inf and P exactly 0,
      // where the TPU kernel masks (after the scale and the bias, before
      // exp2)
      const int j0 = (first + t) * BK;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + 8 * i + 2 * quad + e;
            if (j < seg_lo[hr] || j >= seg_hi[hr])
              sc[4 * i + 2 * hr + e] = neg_inf();
          }
    }
    softmax_tile<BK, FIXED>(sc, sB + s * BK, p.scale_log2, quad, m_run,
                            l_run, alpha, pa);
    if (!FIXED) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
      }
    }
    // O += P V
    const uint32_t v_base = smem_u32(sV + s * BK * D * 2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D>(o, pa[kk], S::mnmajor(v_base, kk, BK));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(o);
    fence_regs_u<BK / 4>(&pa[0][0]);
    mbar_arrive(&empty[s]);
  }

  // normalise (a row with no visible key has l = 0 and gives 0), stage the
  // warp's 16 rows in shared memory, write them with 16-byte stores; with
  // LSE the quad's lane 0 writes the row's natural logsumexp m ln 2 + ln l
  // (K7's bf16 residual, which its backward reads)
  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_run[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[hr] = l > 0.f ? 1.f / l : 0.f;
    if constexpr (LSE) {
      const int qi = q0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * hr;
      if (quad == 0 && qi < p.Lq)
        p.lse[(z1 * gridDim.y + h) * p.Lq + qi] =
            m_run[hr] * 0.69314718055994531f + logf(l);
    }
  }
  TO* sOw = sO + (wg * 64 + warp * 16) * L::OLD;
  const int r0 = lane >> 2;
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      TO* dst = sOw + (r0 + 8 * hr) * L::OLD + 8 * i + 2 * quad;
      const float a = o[4 * i + 2 * hr] * inv[hr];
      const float b = o[4 * i + 2 * hr + 1] * inv[hr];
      if constexpr (sizeof(TO) == 2)
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
      else
        *reinterpret_cast<float2*>(dst) = make_float2(a, b);
    }
  __syncwarp();
  constexpr int CPR = D * (int)sizeof(TO) / 16;  // 16-byte chunks a row
  TO* ob = (TO*)p.o + z1 * p.o_s1 + z2 * p.o_s2 + h * D;
  const int qw = q0 + wg * 64 + warp * 16;
#pragma unroll
  for (int it = 0; it < 16 * CPR / 32; ++it) {
    const int idx = it * 32 + lane;
    const int r = idx / CPR, c = idx % CPR;
    if (qw + r < p.Lq)
      *reinterpret_cast<uint4*>(ob + (long long)(qw + r) * p.o_si +
                                c * (16 / (int)sizeof(TO))) =
          *reinterpret_cast<const uint4*>(sOw + r * L::OLD +
                                          c * (16 / (int)sizeof(TO)));
  }
}

// cuTensorMapEncodeTiled, a driver API function, through the runtime's
// entry-point query (the library links no libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = (EncodeTiledFn)f;
  }
  return fn;
}

// The TMA map of a bf16 K or V operand: element (d, head, key, batch) at
// d + head * D + key * row + batch * batch_stride elements from base; boxes
// of RB / 2 lanes x 1 head x BK keys x 1 batch row, swizzled as Sw<D>
template <int D>
cudaError_t kv_map(CUtensorMap* map, const void* base, int H, int Lk,
                   long long nb, long long row, long long batch_stride) {
  using S = Sw<D>;
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)Lk,
                              (cuuint64_t)nb};
  // a lone batch row may carry any batch stride; TMA wants a nonzero one
  const cuuint64_t strides[3] = {
      (cuuint64_t)D * 2, (cuuint64_t)row * 2,
      (cuuint64_t)(nb == 1 ? 8 : batch_stride) * 2};
  const cuuint32_t box[4] = {(cuuint32_t)(S::RB / 2), 1,
                             (cuuint32_t)Cfg<D, bf16>::BK, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      S::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// grid: (query tiles, heads, row blocks). 128-row query tiles when there
// is at least one for each of the 132 SMs, else 64. q, k, v and o must be
// 16-byte aligned, with row strides (and head offsets) a multiple of 16
// bytes; one row block level (nb2 = 1). SEG: the segments' instantiation
// (p.seg > 0), kept apart so that the forms without segments carry none of
// their code; LSE likewise: the [z1][H][Lq] row logsumexp written to p.lse
// (K7's bf16 forward with its residual).
template <int D, typename TQ, typename TKV, typename TO, bool FIXED,
          bool SEG = false, bool LSE = false>
cudaError_t launch_attn_sm90(const AttnParams& pa, int H, long long nb1,
                             cudaStream_t s) {
  AttnParams p = pa;
  if (!p.v_sj) {
    p.v_s1 = p.k_s1;
    p.v_sj = p.k_sj;
  }
  // no k RMS norm here (kg): K1 norms k in its projection's epilogue
  if (nb1 < 1 || nb1 > 65535 || p.nb2 != 1 || H < 1 || H > 65535 ||
      p.Lq < 1 || p.Lk < 1 || (nb1 > 1 && (p.k_s1 <= 0 || p.v_s1 <= 0)) ||
      p.kg || p.qg_f32 ||
      (SEG != (p.seg != 0)) || (LSE && (!p.lse || FIXED)) ||
      (SEG && (p.seg < 0 || p.tiles || p.Lq != p.Lk || p.Lq % p.seg)))
    return cudaErrorInvalidValue;
  auto misaligned = [](const void* ptr, long long stride, int elem) {
    return ((uintptr_t)ptr % 16) != 0 || (stride * elem) % 16 != 0;
  };
  if (misaligned(p.q, p.q_si, sizeof(TQ)) ||
      misaligned(p.q, p.q_s1, sizeof(TQ)) ||
      misaligned(p.k, p.k_sj, sizeof(TKV)) ||
      misaligned(p.k, p.k_s1, sizeof(TKV)) ||
      misaligned(p.v, p.v_sj, sizeof(TKV)) ||
      misaligned(p.v, p.v_s1, sizeof(TKV)) ||
      misaligned(p.o, p.o_si, sizeof(TO)) ||
      misaligned(p.o, p.o_s1, sizeof(TO)))
    return cudaErrorMisalignedAddress;
  CUtensorMap tk, tv;
  memset(&tk, 0, sizeof(tk));
  memset(&tv, 0, sizeof(tv));
  if constexpr (sizeof(TKV) == 2) {
    cudaError_t e = kv_map<D>(&tk, p.k, H, p.Lk, nb1, p.k_sj, p.k_s1);
    if (e == cudaSuccess) e = kv_map<D>(&tv, p.v, H, p.Lk, nb1, p.v_sj, p.v_s1);
    if (e != cudaSuccess) return e;
  }
  const long long tiles128 = (long long)cdiv(p.Lq, 128) * H * nb1;
  cudaError_t err;
#define GVF_LAUNCH_SM90(NWG)                                                  \
  {                                                                           \
    constexpr int bytes = Smem<D, NWG, TO>::BYTES;                            \
    auto kern = attn_sm90_kernel<D, NWG, TQ, TKV, TO, FIXED, SEG, LSE>;       \
    static bool opted = false; /* the shared-memory opt-in, once */          \
    if (!opted) {                                                             \
      err = cudaFuncSetAttribute(                                             \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);          \
      if (err != cudaSuccess) return err;                                     \
      opted = true;                                                           \
    }                                                                         \
    kern<<<dim3(cdiv(p.Lq, 64 * NWG), H, (unsigned)nb1),                      \
           NWG * 128 + 32 * Cfg<D, TKV>::NPROD, bytes, s>>>(p, tk, tv);       \
  }
  if (tiles128 >= 132) {
    GVF_LAUNCH_SM90(2)
  } else {
    GVF_LAUNCH_SM90(1)
  }
#undef GVF_LAUNCH_SM90
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace gvf
