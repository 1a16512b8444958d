// Q8_0 dequant-matmul for Hopper (sm_90a): y[T, N] = x[T, K] . deq(q[N, K], s[N, K/32])^T
//
// Replaces the Pallas TPU kernels of light_whisper_tpu/ops/q8_matmul.py:
//   _q8_matmul_2d               (body _kernel)                -> the 2D form
//   _q8_matmul_stacked_2d       (body _kernel_stacked)        -> the same entry at a layer offset
//   _q8_matmul_stacked_fused_2d (body _kernel_stacked_fused)  -> the same entry with the
//                                                                rms-norm prologue / residual epilogue
// The caller passes q and s already offset to the layer (q[idx] is a zero-copy view), so one
// entry point serves all three forms. Scales are read as s[n, k/32] directly: the transposed
// s_t and the one-hot expansion matmul of the TPU kernel were Mosaic layout workarounds.
//
// Numerics (shared with the plain PyTorch version in ops/q8_matmul.py):
//   w   = bf16(float(q) * float(s))            dequantised weight, rounded to bf16 (RNE)
//   acc = sum_k float(x_bf16) * float(w)       bf16 products are exact in f32, f32 accumulation
//   norm prologue:  x = bf16(float(x) * rsqrt(mean(x^2) + eps) * norm_w)
//   residual epilogue: y = float(bf16(float(res_bf16) + float(bf16(acc))))
//   output f32.
//
// What bounds it on the H100: decode (T <= 8) is a weight stream. One 0.6B decode step reads
// ~0.6 GB of int8 quants plus 1/16 of that in bf16 scales and does 2 FLOPs per weight byte per
// row, far below the ~295 FLOP/byte the card needs before compute matters; at 3.35 TB/s the
// floor is ~0.2 ms per step. Prefill and the encoder (T = 64..~200) do T times more work per
// weight byte and sit near the ridge.
//
// What the simple design does about it:
//   T <= 8: weight-streaming GEMV. Each warp owns one output row at a time, each lane loads
//           16 int8 quants with one 16-byte load (a warp reads 512 contiguous bytes), dequantises
//           in registers and keeps T f32 partial sums; a warp shuffle reduces them. x (normalised
//           when the prologue is on) is staged once per block in shared memory as bf16. The grid
//           strides over rows with enough blocks to cover the 132 SMs several times.
//   T > 8:  shared-memory tiled kernel. A 64x64 output tile per block, K in steps of one Q8
//           block (32); the int8 tile is dequantised into shared memory as bf16 and multiplied
//           with WMMA bf16 16x16x16 fragments accumulating in f32. No pipelining yet: wgmma, TMA
//           and a persistent schedule are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 32;  // Q8_0 block length along K

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------------------
// T <= 8: GEMV
// ---------------------------------------------------------------------------

constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;

template <int T>
__global__ void __launch_bounds__(kGemvThreads) q8_gemv_kernel(
    const __nv_bfloat16* __restrict__ x,         // [T, K]
    const int8_t* __restrict__ q,                // [N, K]
    const __nv_bfloat16* __restrict__ s,         // [N, K/32]
    const float* __restrict__ norm_w,            // [K] or null
    const __nv_bfloat16* __restrict__ residual,  // [T, N] or null
    float* __restrict__ y,                       // [T, N]
    int N, int K, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [T, K]
  __shared__ float red[kGemvWarps][T];
  __shared__ float row_scale[T];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (norm_w != nullptr) {
    float ss[T];
#pragma unroll
    for (int t = 0; t < T; ++t) ss[t] = 0.f;
    for (int k = tid; k < K; k += kGemvThreads) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        float v = __bfloat162float(x[t * K + k]);
        ss[t] = fmaf(v, v, ss[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float v = ss[t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][t] = v;
    }
    __syncthreads();
    if (tid < T) {
      float total = 0.f;
      for (int w = 0; w < kGemvWarps; ++w) total += red[w][tid];
      row_scale[tid] = 1.0f / sqrtf(total / (float)K + eps);
    }
    __syncthreads();
    for (int i = tid; i < T * K; i += kGemvThreads) {
      const int t = i / K;
      const int k = i - t * K;
      float v = __bfloat162float(x[i]) * row_scale[t];
      xs[i] = __float2bfloat16_rn(v * norm_w[k]);
    }
  } else {
    const uint4* src = reinterpret_cast<const uint4*>(x);
    uint4* dst = reinterpret_cast<uint4*>(xs);
    const int n16 = T * K / 8;  // 8 bf16 per 16 bytes; K % 32 == 0
    for (int i = tid; i < n16; i += kGemvThreads) dst[i] = src[i];
  }
  __syncthreads();

  const int kb = K / kBlock;
  const int chunks = K / 16;
  for (int n = blockIdx.x * kGemvWarps + warp; n < N; n += gridDim.x * kGemvWarps) {
    const int8_t* qrow = q + (size_t)n * K;
    const __nv_bfloat16* srow = s + (size_t)n * kb;
    float acc[T];
#pragma unroll
    for (int t = 0; t < T; ++t) acc[t] = 0.f;

    for (int c = lane; c < chunks; c += 32) {
      const int4 qv = *reinterpret_cast<const int4*>(qrow + c * 16);
      const float sc = __bfloat162float(srow[c >> 1]);
      const int8_t* qb = reinterpret_cast<const int8_t*>(&qv);
      float w[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) w[i] = bf16_round((float)qb[i] * sc);
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
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float v = acc[t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[t] = v;
    }
    if (lane == 0) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        float v = acc[t];
        if (residual != nullptr) {
          v = bf16_round(__bfloat162float(residual[(size_t)t * N + n]) + bf16_round(v));
        }
        y[(size_t)t * N + n] = v;
      }
    }
  }
}

template <int T>
cudaError_t launch_gemv(const void* x, const void* q, const void* s, const void* norm_w,
                        const void* residual, void* y, int N, int K, float eps,
                        cudaStream_t stream, int num_sms) {
  const size_t smem = (size_t)T * K * sizeof(__nv_bfloat16);
  // the static red/row_scale arrays count against the same 48 KB default
  const size_t static_smem = sizeof(float) * (kGemvWarps + 1) * T;
  if (smem + static_smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        q8_gemv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int blocks = (N + kGemvWarps - 1) / kGemvWarps;
  const int cap = num_sms * 8;
  if (blocks > cap) blocks = cap;
  q8_gemv_kernel<T><<<blocks, kGemvThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const __nv_bfloat16*>(s), static_cast<const float*>(norm_w),
      static_cast<const __nv_bfloat16*>(residual), static_cast<float*>(y), N, K, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// T > 8: tiled WMMA kernel
// ---------------------------------------------------------------------------

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kPad = 8;  // keeps WMMA leading dims a multiple of 8 and rows 16-byte aligned
constexpr int kMmaThreads = 128;

__global__ void __launch_bounds__(kMmaThreads) q8_mma_kernel(
    const __nv_bfloat16* __restrict__ x,  // [T, K]
    const int8_t* __restrict__ q,         // [N, K]
    const __nv_bfloat16* __restrict__ s,  // [N, K/32]
    float* __restrict__ y,                // [T, N]
    int T, int N, int K) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[kBM][kBK + kPad];
  __shared__ __align__(32) __nv_bfloat16 Bs[kBN][kBK + kPad];
  __shared__ __align__(32) float Cs[kBM][kBN + 4];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // 0..1: 32-row half of the tile
  const int wn = warp & 1;   // 0..1: 32-column half of the tile
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int kb = K / kBlock;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A tile: 64 rows x 32 bf16 = 256 16-byte vectors, two per thread.
    for (int i = tid; i < kBM * kBK / 8; i += kMmaThreads) {
      const int r = i >> 2;
      const int c = (i & 3) * 8;
      const int gm = m0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gm < T) v = *reinterpret_cast<const uint4*>(x + (size_t)gm * K + k0 + c);
      *reinterpret_cast<uint4*>(&As[r][c]) = v;
    }
    // B tile: 64 rows x 32 int8 = one Q8 block per row; each thread dequantises 16 quants.
    {
      const int r = tid >> 1;
      const int c = (tid & 1) * 16;
      const int gn = n0 + r;
      uint32_t packed[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) packed[i] = 0u;
      if (gn < N) {
        const int4 qv = *reinterpret_cast<const int4*>(q + (size_t)gn * K + k0 + c);
        const float sc = __bfloat162float(s[(size_t)gn * kb + k0 / kBlock]);
        const int8_t* qb = reinterpret_cast<const int8_t*>(&qv);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          // .x (lower address) holds element 2i, .y element 2i+1
          __nv_bfloat162 h = __floats2bfloat162_rn((float)qb[2 * i] * sc, (float)qb[2 * i + 1] * sc);
          packed[i] = *reinterpret_cast<uint32_t*>(&h);
        }
      }
      uint4* dst = reinterpret_cast<uint4*>(&Bs[r][c]);
      dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[wm * 32 + i * 16][kk], kBK + kPad);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[wn * 32 + j * 16][kk], kBK + kPad);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm * 32 + i * 16][wn * 32 + j * 16], acc[i][j], kBN + 4,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < kBM * kBN; i += kMmaThreads) {
    const int r = i / kBN;
    const int c = i - r * kBN;
    const int gm = m0 + r;
    const int gn = n0 + c;
    if (gm < T && gn < N) y[(size_t)gm * N + gn] = Cs[r][c];
  }
}

}  // namespace

// Returns a cudaError_t (0 on success). q and s point at the layer's [N, K] / [N, K/32] block.
// norm_w (f32 [K]) and residual (bf16 [T, N]) are optional (null) and taken only at T <= 8.
extern "C" int lwt_q8_matmul(const void* x, const void* q, const void* s, const void* norm_w,
                             const void* residual, void* y, int T, int N, int K, float eps,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (T <= 0 || N <= 0 || K <= 0 || K % kBlock != 0) return (int)cudaErrorInvalidValue;
  if (T > 8) {
    if (norm_w != nullptr || residual != nullptr) return (int)cudaErrorInvalidValue;
    dim3 grid((N + kBN - 1) / kBN, (T + kBM - 1) / kBM);
    q8_mma_kernel<<<grid, kMmaThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
        static_cast<const __nv_bfloat16*>(s), static_cast<float*>(y), T, N, K);
    return (int)cudaGetLastError();
  }
  static const int num_sms = [] {
    int device = 0;
    int count = 132;
    if (cudaGetDevice(&device) == cudaSuccess) {
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    }
    return count;
  }();
  switch (T) {
    case 1: return (int)launch_gemv<1>(x, q, s, norm_w, residual, y, N, K, eps, stream, num_sms);
    case 2: return (int)launch_gemv<2>(x, q, s, norm_w, residual, y, N, K, eps, stream, num_sms);
    case 3: return (int)launch_gemv<3>(x, q, s, norm_w, residual, y, N, K, eps, stream, num_sms);
    case 4: return (int)launch_gemv<4>(x, q, s, norm_w, residual, y, N, K, eps, stream, num_sms);
    case 5: return (int)launch_gemv<5>(x, q, s, norm_w, residual, y, N, K, eps, stream, num_sms);
    case 6: return (int)launch_gemv<6>(x, q, s, norm_w, residual, y, N, K, eps, stream, num_sms);
    case 7: return (int)launch_gemv<7>(x, q, s, norm_w, residual, y, N, K, eps, stream, num_sms);
    default: return (int)launch_gemv<8>(x, q, s, norm_w, residual, y, N, K, eps, stream, num_sms);
  }
}
