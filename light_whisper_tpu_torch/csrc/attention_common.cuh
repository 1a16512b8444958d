// Shared-memory and tensor-core helpers of the port's kernels for Hopper (sm_90a): cp.async
// copies, ldmatrix, mma.sync m16n8k16 with bf16 operands and an f32 accumulator, the reductions
// over the four threads that hold one accumulator row (attention), and the streaming loads and
// Q8_0 dequantisation into mma B fragments (q8_gemv.cuh, q8_matmul.cu, fused_ffn.cu).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros (the ragged key edge)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared (cached at all levels)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// mbarriers in shared memory: a producer / consumer ring without block barriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// the arrival fires once every cp.async this thread issued before it has landed (the barrier's
// count includes it: .noinc)
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// waits until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// d += a (16x16, row) * b (16x8, col); bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even, lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Chunk range [lo, hi) of split r of S over n chunks.
__host__ __device__ __forceinline__ void split_range(int n, int S, int r, int& lo, int& hi) {
  lo = (int)((long long)r * n / S);
  hi = (int)((long long)(r + 1) * n / S);
}

// The 4 int8 quants of one word as exact floats: each byte through the 2^23 exponent trick
// (biased by 128: 2^23 + 128 = 8388736).
__device__ __forceinline__ void quants4(uint32_t word, float (&f)[4]) {
  const uint32_t u = word ^ 0x80808080u;
#pragma unroll
  for (int b = 0; b < 4; ++b) f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + b)) - 8388736.0f;
}

// 8 int8 quants (two words) times one scale -> 4 bf16 pairs, bf16(q * s) rounded to nearest even
// (q * s is exact in f32).
__device__ __forceinline__ void dequant8(const uint2& qv, float sc, uint32_t (&w)[4]) {
  const uint32_t words[2] = {qv.x, qv.y};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float f[4];
    quants4(words[j], f);
    w[2 * j] = pack_bf16(f[0] * sc, f[1] * sc);
    w[2 * j + 1] = pack_bf16(f[2] * sc, f[3] * sc);
  }
}

// 16 int8 quants times one scale -> 8 bf16 pairs.
__device__ __forceinline__ void dequant16(const int4& qv, float sc, uint32_t (&w)[8]) {
  uint32_t lo[4], hi[4];
  dequant8(make_uint2((uint32_t)qv.x, (uint32_t)qv.y), sc, lo);
  dequant8(make_uint2((uint32_t)qv.z, (uint32_t)qv.w), sc, hi);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[j] = lo[j];
    w[4 + j] = hi[j];
  }
}

// 16 int8 quants -> 8 bf16 pairs with no scale: bf16(q) is exact (|q| <= 128 needs 8 bits).
__device__ __forceinline__ void cvt16(const int4& qv, uint32_t (&w)[8]) {
  const uint32_t words[4] = {(uint32_t)qv.x, (uint32_t)qv.y, (uint32_t)qv.z, (uint32_t)qv.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float f[4];
    quants4(words[j], f);
    w[2 * j] = pack_bf16(f[0], f[1]);
    w[2 * j + 1] = pack_bf16(f[2], f[3]);
  }
}

// 16 int8 quants times 16 scales (bf16 pairs, the lower k in the low half) -> 8 bf16 pairs,
// bf16(q * s) rounded as dequant16 rounds.
__device__ __forceinline__ void dequant16_scales(const int4& qv, const uint32_t (&sc)[8], uint32_t (&w)[8]) {
  const uint32_t words[4] = {(uint32_t)qv.x, (uint32_t)qv.y, (uint32_t)qv.z, (uint32_t)qv.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float f[4];
    quants4(words[j], f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lo = __uint_as_float(sc[2 * j + h] << 16), hi = __uint_as_float(sc[2 * j + h] & 0xffff0000u);
      w[2 * j + h] = pack_bf16(f[2 * h] * lo, f[2 * h + 1] * hi);
    }
  }
}

__device__ __forceinline__ int4 ldg_stream(const int8_t* p) {
  int4 v;
  // volatile: issued where written (before the prologue), not sunk to its first use
  asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

}  // namespace
