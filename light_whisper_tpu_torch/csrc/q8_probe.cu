// Q8_0 probe kernels for Hopper (sm_90a): what bounds the decode GEMV, and the k-permuted layout.
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
// the perm kernel below measures exactly.
//
// Every kernel here keeps the block schedule of the shipped GEMV (csrc/q8_matmul.cu, T <= 8):
// 256 threads, a warp an output row, each lane 16 quants a 16-byte load, x staged in shared
// memory, a shuffle reduction. Rows of x past 8 take further grid rows of 8.
//   noscale: w = float(q), no scale: y = x . q^T. What the dequant's scale multiply costs.
//   load:    reads every quant and scale byte, folds them into an integer that is multiplied
//            by a zero passed at run time (so the compiler cannot drop the loads), and writes
//            y[t, i] = sum_kb q[t, kb*block_k + i] for i < min(N, block_k), else 0: the TPU
//            body's touch of T rows of its block, at one block of all N rows. Its time is the
//            load ceiling of this schedule.
//   perm:    weights whose k-axis is permuted within every block_k block (permuted column
//            a*nb + b holds original column b*32 + a, nb = block_k / 32), activations permuted
//            alike; the scale of permuted column j is s[kb*nb + j % nb]. Exact: the same
//            products as the natural layout, summed in another order. A lane's 16 quants now
//            need 16 scales where the natural layout needs one.
// What bounds all three on the H100: bytes, as the shipped GEMV (2 flops a weight byte a row).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Variant { kNoScale = 0, kLoad = 1, kPerm = 2 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int T, int V>
__global__ void __launch_bounds__(kThreads) q8_probe_kernel(
    const __nv_bfloat16* __restrict__ x,  // [rows_total, K] (not read by load)
    const int8_t* __restrict__ q,         // [N, K]
    const __nv_bfloat16* __restrict__ s,  // [N, K/32]
    float* __restrict__ y,                // [rows_total, N]
    int rows_total, int N, int K, int block_k, float zero) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [T, K], rows past the end zero

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.y * T;
  const int rows = rows_total - row0 < T ? rows_total - row0 : T;

  if (V != kLoad) {
    const int per_row = K / 8;  // 16-byte vectors a row
    const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)row0 * K);
    uint4* dst = reinterpret_cast<uint4*>(xs);
    for (int i = tid; i < T * per_row; i += kThreads) {
      dst[i] = i / per_row < rows ? src[i] : make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
  }

  const int kb = K / kBlock;
  const int chunks = K / 16;
  const int nb = block_k / kBlock;
  for (int n = blockIdx.x * kWarps + warp; n < N; n += gridDim.x * kWarps) {
    const int8_t* qrow = q + (size_t)n * K;
    const __nv_bfloat16* srow = s + (size_t)n * kb;
    float acc[T];
#pragma unroll
    for (int t = 0; t < T; ++t) acc[t] = 0.f;
    unsigned int junk = 0u;

    for (int c = lane; c < chunks; c += 32) {
      const int4 qv = *reinterpret_cast<const int4*>(qrow + c * 16);
      if (V == kLoad) {
        junk += (unsigned int)qv.x + (unsigned int)qv.y + (unsigned int)qv.z + (unsigned int)qv.w;
        junk += (unsigned int)__bfloat16_as_ushort(srow[c >> 1]);
        continue;
      }
      const int8_t* qb = reinterpret_cast<const int8_t*>(&qv);
      float w[16];
      if (V == kNoScale) {
#pragma unroll
        for (int i = 0; i < 16; ++i) w[i] = (float)qb[i];
      } else {
        const int p0 = c * 16;  // first (permuted) column of the chunk; a chunk never crosses a block
        const int blk = p0 / block_k;
        const int j0 = p0 - blk * block_k;
        const __nv_bfloat16* sblk = srow + blk * nb;
#pragma unroll
        for (int i = 0; i < 16; ++i) w[i] = bf16_round((float)qb[i] * __bfloat162float(sblk[(j0 + i) % nb]));
      }
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const uint4* xp = reinterpret_cast<const uint4*>(xs + t * K + c * 16);
        uint4 xa = xp[0];
        uint4 xb = xp[1];
        const __nv_bfloat162* xa2 = reinterpret_cast<const __nv_bfloat162*>(&xa);
        const __nv_bfloat162* xb2 = reinterpret_cast<const __nv_bfloat162*>(&xb);
        float a = acc[t];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float2 f = __bfloat1622float2(xa2[i]);
          a = fmaf(w[2 * i], f.x, a);
          a = fmaf(w[2 * i + 1], f.y, a);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float2 f = __bfloat1622float2(xb2[i]);
          a = fmaf(w[8 + 2 * i], f.x, a);
          a = fmaf(w[8 + 2 * i + 1], f.y, a);
        }
        acc[t] = a;
      }
    }

    if (V == kLoad) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) junk += __shfl_xor_sync(0xffffffffu, junk, off);
      if (lane < rows) {
        const int t = row0 + lane;
        const int m = N < block_k ? N : block_k;
        float v = 0.f;
        if (n < m && t < N) {
          for (int k0 = 0; k0 < K; k0 += block_k) v += (float)q[(size_t)t * K + k0 + n];
        }
        y[(size_t)t * N + n] = v + (float)junk * zero;
      }
      continue;
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float v = acc[t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && t < rows) y[(size_t)(row0 + t) * N + n] = v;
    }
  }
}

template <int T, int V>
cudaError_t launch(const void* x, const void* q, const void* s, void* y, int rows_total, int N, int K, int block_k,
                   float zero, cudaStream_t stream) {
  static const int num_sms = [] {
    int device = 0;
    int count = 132;
    if (cudaGetDevice(&device) == cudaSuccess) cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    return count;
  }();
  auto kernel = q8_probe_kernel<T, V>;
  const size_t smem = V == kLoad ? 0 : (size_t)T * K * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {  // no static shared memory here: the dynamic part is all of it
    int device = 0;
    int optin = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    if (smem > (size_t)optin) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int blocks = (N + kWarps - 1) / kWarps;
  if (blocks > num_sms * 8) blocks = num_sms * 8;
  dim3 grid(blocks, (rows_total + T - 1) / T);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
                                           static_cast<const __nv_bfloat16*>(s), static_cast<float*>(y), rows_total,
                                           N, K, block_k, zero);
  return cudaGetLastError();
}

template <int V>
int dispatch(const void* x, const void* q, const void* s, void* y, int T, int N, int K, int block_k, float zero,
             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (T <= 0 || N <= 0 || K <= 0 || K % kBlock != 0 || block_k <= 0 || block_k % kBlock != 0 || K % block_k != 0)
    return (int)cudaErrorInvalidValue;
  switch (T < 8 ? T : 8) {
    case 1: return (int)launch<1, V>(x, q, s, y, T, N, K, block_k, zero, stream);
    case 2: return (int)launch<2, V>(x, q, s, y, T, N, K, block_k, zero, stream);
    case 3: return (int)launch<3, V>(x, q, s, y, T, N, K, block_k, zero, stream);
    case 4: return (int)launch<4, V>(x, q, s, y, T, N, K, block_k, zero, stream);
    case 5: return (int)launch<5, V>(x, q, s, y, T, N, K, block_k, zero, stream);
    case 6: return (int)launch<6, V>(x, q, s, y, T, N, K, block_k, zero, stream);
    case 7: return (int)launch<7, V>(x, q, s, y, T, N, K, block_k, zero, stream);
    default: return (int)launch<8, V>(x, q, s, y, T, N, K, block_k, zero, stream);
  }
}

}  // namespace

// variant 0: noscale, 1: load (zero must be 0.0f). Returns a cudaError_t (0 on success).
// q and s point at the layer's [N, K] / [N, K/32] block; block_k is load's touch block.
extern "C" int lwt_q8_probe(int variant, const void* x, const void* q, const void* s, void* y, int T, int N, int K,
                            int block_k, float zero, void* stream_ptr) {
  if (variant == kNoScale) return dispatch<kNoScale>(x, q, s, y, T, N, K, block_k, zero, stream_ptr);
  if (variant == kLoad) return dispatch<kLoad>(x, q, s, y, T, N, K, block_k, zero, stream_ptr);
  return (int)cudaErrorInvalidValue;
}

// y[T, N] = xp . deq_perm(qp, s)^T over the k-permuted layout at block_k (xp permuted alike).
extern "C" int lwt_q8_matmul_perm(const void* x, const void* q, const void* s, void* y, int T, int N, int K,
                                  int block_k, void* stream_ptr) {
  return dispatch<kPerm>(x, q, s, y, T, N, K, block_k, 0.f, stream_ptr);
}
