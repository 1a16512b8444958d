// Q8_0 probes for Hopper (sm_90a): what bounds the decode GEMV that ships, and what the
// k-permuted layout would cost it.
//
// Replaces the Pallas TPU kernels of the reference's probe scripts:
//   scripts/exp_q8_compute_bound.py:_run_variant      -> lwt_q8_probe (variants noscale, load);
//                                                        its "full" variant is the shipped
//                                                        lwt_q8_matmul, "permexact" the entry below
//   scripts/exp_q8_kperm_probe.py:_q8_matmul_perm_2d  -> lwt_q8_matmul_perm
//   scripts/exp_q8_kperm_probe.py:_q8_matmul_stacked_perm_2d
//                                                     -> the same entry at a layer offset
// The TPU probes' "subexpand" and "repeatcost" measured the TPU kernel's expand matmul (the
// one-hot product that builds per-k scales). The CUDA kernel has no such product: it multiplies
// a per-32 scale in registers. So subexpand is the shipped kernel itself (bit-identical by
// construction), and repeatcost (the permuted scale pattern's cost on natural weights) is what
// the perm variant measures exactly.
//
// This file has no kernel of its own: every variant is an instantiation of the shipped GEMV's
// body (q8_gemv.cuh, q8_gemv_kernel<V>, the one lwt_q8_matmul runs at T <= 8), with its grid,
// its 4-way K split, its x staging, its two-batch register pipeline and its warp-order sum.
// Only the per-chunk term differs, so at T <= 8 the differences between variants isolate one
// cost each:
//   load:    full's loads of x, quants and scales, no dequant, no mma -> the schedule's load
//            ceiling; y[t, i] = sum_kb q[t, kb*block_k + i] for i < min(N, block_k), else 0
//   noscale: w = bf16(q), no scale multiply (the scales are still loaded) -> full - noscale is
//            what the scale multiply costs; y = x . q^T
//   perm:    the k-permuted layout at block_k, x permuted alike; 16 scales a lane where the
//            natural layout needs one -> perm - full is what they cost. Exact: the same bf16
//            products as the natural layout, summed in another order.
// Rows past 8 take further grid rows of 8. Above 8 rows the shipped product is the tile kernel,
// so the variants' differences mean nothing there.
// What bounds them on the H100: bytes, as the shipped GEMV (2 T flops a weight byte).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "q8_gemv.cuh"

namespace {

template <int V>
int launch_probe(const void* x, const void* q, const void* s, void* y, int T, int N, int K, int block_k, float zero,
                 void* stream_ptr) {
  if (T <= 0 || N <= 0 || K <= 0 || K % kBlock != 0 || block_k <= 0 || block_k % kBlock != 0 || K % block_k != 0)
    return (int)cudaErrorInvalidValue;
  // perm's scale windows are read 16 bytes at a time
  if (V == kPerm && (block_k / kBlock) % 16 == 0 && reinterpret_cast<uintptr_t>(s) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  GemvArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
             static_cast<const __nv_bfloat16*>(s), nullptr, nullptr, static_cast<float*>(y), T, N, K, 0.f,
             block_k, zero};
  return (int)launch_gemv<V>(a, static_cast<cudaStream_t>(stream_ptr), num_sms());
}

}  // namespace

// variant 0: noscale, 1: load (zero must be 0.0f). Returns a cudaError_t (0 on success).
// q and s point at the layer's [N, K] / [N, K/32] block; block_k is load's touch block.
extern "C" int lwt_q8_probe(int variant, const void* x, const void* q, const void* s, void* y, int T, int N, int K,
                            int block_k, float zero, void* stream_ptr) {
  if (variant == 0) return launch_probe<kNoScale>(x, q, s, y, T, N, K, block_k, zero, stream_ptr);
  if (variant == 1) return launch_probe<kLoad>(x, q, s, y, T, N, K, block_k, zero, stream_ptr);
  return (int)cudaErrorInvalidValue;
}

// y[T, N] = xp . deq_perm(qp, s)^T over the k-permuted layout at block_k (xp permuted alike).
extern "C" int lwt_q8_matmul_perm(const void* x, const void* q, const void* s, void* y, int T, int N, int K,
                                  int block_k, void* stream_ptr) {
  return launch_probe<kPerm>(x, q, s, y, T, N, K, block_k, 0.f, stream_ptr);
}
