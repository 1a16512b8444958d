// Fused decode FFN for Hopper (sm_90a): y[T, D] = x + W_down(silu(W_gate h) * W_up h),
// h = rms_norm(x, norm_w), over stacked Q8_0 weights, T <= 8 rows.
//
// Replaces the Pallas TPU kernels of light_whisper_tpu/ops/fused_ffn.py:
//   fused_ffn_step    (body _kernel)        -> lwt_fused_ffn_step
//   fused_gateup_silu (body _kernel_gateup) -> lwt_fused_gateup_silu: the first stage of the
//                                              same template, without the norm prologue
// The caller passes the layer's gate/up quants [2F, D] (gate rows [0, F), up rows [F, 2F)),
// scales [2F, D/32], down quants [D, F] and scales [D, F/32] already offset to the layer.
//
// Numerics (shared with the plain PyTorch version in ops/fused_ffn.py):
//   h     = bf16(float(x) * rsqrt(mean(x^2) + eps) * norm_w)
//   w     = bf16(float(q) * float(s))                    as the Q8 kernels dequantise
//   g, u  = sum_k float(h) * float(w)                    f32 accumulation
//   inner = bf16(g * sigmoid(g) * u)
//   y     = float(x) + p_0 + p_1 + ...                   p_j = inner[:, 32j:32j+32] . w_down[:, 32j:32j+32]^T,
//                                                        added in j order, in f32
// That is the TPU kernel's order (o = x + partial_0, o += partial_j) at a tile of 32 columns.
//
// What bounds it on the H100: bytes. At Qwen3-ASR 0.6B widths (D = 1024, F = 3072) one call
// reads 9.44 MB of int8 quants and 0.59 MB of bf16 scales and does 2 flops a weight byte a
// row: about 3 us at 3.35 TB/s, at T = 1 and T = 8 alike.
//
// What the simple design does about it:
//   - one launch, two stages, a grid barrier between them. The grid spreads the weight stream
//     over every SM in both stages, instead of tying the block count to the F tiles;
//   - prologue: each block stages x with 16-byte loads and normalises it in shared memory (the
//     rms-norm recomputed a block, as the TPU kernel does a program), and asks L2 for the down
//     rows it will contract in stage 2, so that their DRAM reads overlap stage 1;
//   - stage 1 (the GEMV body of csrc/q8_matmul.cu): a warp owns one column f, reads gate row f
//     and up row F + f with 16-byte loads, dequantises with the per-32 scales in registers,
//     reduces with shuffles, and writes inner[:, f] to global memory (6 KB at T = 1,
//     L2-resident);
//   - the barrier: every block arrives on a counter (thread 0, after the block barrier and a
//     __threadfence()); the last one resets it and advances a generation word that the others
//     wait on. A cooperative launch guarantees that every block is resident, so the wait cannot
//     deadlock;
//   - stage 2: output rows are dealt out across all blocks (d = blockIdx.x + k * gridDim.x);
//     a block stages inner [T, F] in shared memory, a warp owns one row d, each lane contracts
//     its 32-column Q8 blocks j of down row d into p_j, and lane t adds the row's p_j to
//     float(x[t, d]) in j order through shared memory. Each output is summed by one thread in a
//     fixed order: the reduction across tiles is deterministic and uses no float atomics.
// One FFN half costs one launch (the decoder's default half costs six). At 0.6B widths the grid
// is min(F / 8, resident blocks) = 384 blocks of 256 threads (a warp a column in stage 1; 3 or
// more blocks fit an SM), and each takes 2-3 of the 1024 rows in stage 2. The partials are 32
// inner columns wide (one Q8 block of down_q), the plain version's block_f.
// fused_gateup_silu is stage 1 alone (no norm, no barrier), an ordinary launch.
// wgmma does not apply (T <= 8 rows); overlapping the two stages and a CUDA graph around the
// decode step are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kBlock = 32;  // Q8_0 block length
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// acc[t] += sum_i w_i * xs[t, 16c + i] over one 16-byte chunk of quants with scale sc;
// xs is bf16 [T, stride] in shared memory.
template <int T>
__device__ __forceinline__ void dot16(const int4 qv, float sc, const __nv_bfloat16* xs, int stride, int c,
                                      float (&acc)[T]) {
  const int8_t* qb = reinterpret_cast<const int8_t*>(&qv);
  float w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = bf16_round((float)qb[i] * sc);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const uint4* xp = reinterpret_cast<const uint4*>(xs + t * stride + c * 16);
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

template <int T>
__device__ __forceinline__ void warp_sum(float (&v)[T]) {
#pragma unroll
  for (int t = 0; t < T; ++t) {
    float a = v[t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    v[t] = a;
  }
}

// Dynamic shared memory: x / h [T, D], then inner [T, F], in one 16-byte aligned buffer; the full
// kernel adds the stage-2 partials after it.
template <int T>
__host__ __device__ __forceinline__ size_t stage_bytes(int D, int F) {
  const size_t n = (size_t)T * (D > F ? D : F) * sizeof(__nv_bfloat16);
  return (n + 15) / 16 * 16;
}

template <int T>
__host__ __device__ __forceinline__ size_t full_smem_bytes(int D, int F) {
  return stage_bytes<T>(D, F) + sizeof(float) * kWarps * T * (F / kBlock + 1);
}

// kFull: the whole FFN half (norm prologue, stage 1, barrier, stage 2).
// Otherwise stage 1 alone on an already normalised h.
template <int T, bool kFull>
__global__ void __launch_bounds__(kThreads) fused_ffn_kernel(
    const __nv_bfloat16* __restrict__ x,     // [T, D]: the FFN input (kFull) or h
    const float* __restrict__ norm_w,        // [D] (kFull)
    const int8_t* __restrict__ gu_q,         // [2F, D]
    const __nv_bfloat16* __restrict__ gu_s,  // [2F, D/32]
    const int8_t* __restrict__ dn_q,         // [D, F] (kFull)
    const __nv_bfloat16* __restrict__ dn_s,  // [D, F/32] (kFull)
    __nv_bfloat16* __restrict__ inner,       // [T, F]
    float* __restrict__ y,                   // [T, D] (kFull)
    unsigned int* __restrict__ barrier,      // [2]: arrivals, generation (kFull)
    int D, int F, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // h [T, D], then inner [T, F]
  float* partials = reinterpret_cast<float*>(smem_raw + stage_bytes<T>(D, F));  // kFull: [kWarps, T, F/32 + 1]
  __shared__ float red[kWarps][T];
  __shared__ float row_scale[T];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gwarp = blockIdx.x * kWarps + warp;
  const int nwarps = gridDim.x * kWarps;

  // -- h in shared memory: x staged with 16-byte loads, then normalised in place ----------
  {
    const uint4* src = reinterpret_cast<const uint4*>(x);
    uint4* dst = reinterpret_cast<uint4*>(xs);
    for (int i = tid; i < T * D / 8; i += kThreads) dst[i] = src[i];
  }
  if (kFull) {
    // the down rows this block contracts in stage 2 (d = blockIdx.x + k * gridDim.x), into L2
    // while stage 1 runs: 128-byte lines of quants, then of scales
    const int my_rows = D > (int)blockIdx.x ? (D - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
    const int q_lines = (F + 127) / 128;
    const int s_lines = (F / kBlock * 2 + 127) / 128;
    for (int i = tid; i < my_rows * (q_lines + s_lines); i += kThreads) {
      const int r = i / (q_lines + s_lines);
      const int l = i - r * (q_lines + s_lines);
      const size_t d = blockIdx.x + (size_t)r * gridDim.x;
      const char* line = l < q_lines ? reinterpret_cast<const char*>(dn_q + d * F) + l * 128
                                     : reinterpret_cast<const char*>(dn_s + d * (F / kBlock)) + (l - q_lines) * 128;
      asm volatile("prefetch.global.L2 [%0];" ::"l"(line));
    }
    __syncthreads();
    float ss[T];
#pragma unroll
    for (int t = 0; t < T; ++t) ss[t] = 0.f;
    for (int k = tid; k < D; k += kThreads) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        float v = __bfloat162float(xs[t * D + k]);
        ss[t] = fmaf(v, v, ss[t]);
      }
    }
    warp_sum<T>(ss);
    if (lane == 0) {
#pragma unroll
      for (int t = 0; t < T; ++t) red[warp][t] = ss[t];
    }
    __syncthreads();
    if (tid < T) {
      float total = 0.f;
      for (int w = 0; w < kWarps; ++w) total += red[w][tid];
      row_scale[tid] = 1.0f / sqrtf(total / (float)D + eps);
    }
    __syncthreads();
    for (int k = tid; k < D; k += kThreads) {
      const float w = norm_w[k];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float v = __bfloat162float(xs[t * D + k]) * row_scale[t];
        xs[t * D + k] = __float2bfloat16_rn(v * w);
      }
    }
  }
  __syncthreads();

  // -- stage 1: inner[:, f] = bf16(silu(gate_f . h) * (up_f . h)), a warp a column -------
  {
    const int kb = D / kBlock;
    const int chunks = D / 16;
    for (int f = gwarp; f < F; f += nwarps) {
      const int8_t* qg = gu_q + (size_t)f * D;
      const int8_t* qu = gu_q + (size_t)(F + f) * D;
      const __nv_bfloat16* sg = gu_s + (size_t)f * kb;
      const __nv_bfloat16* su = gu_s + (size_t)(F + f) * kb;
      float g[T], u[T];
#pragma unroll
      for (int t = 0; t < T; ++t) g[t] = u[t] = 0.f;
      for (int c = lane; c < chunks; c += 32) {
        const int4 a = *reinterpret_cast<const int4*>(qg + c * 16);
        const int4 b = *reinterpret_cast<const int4*>(qu + c * 16);
        dot16<T>(a, __bfloat162float(sg[c >> 1]), xs, D, c, g);
        dot16<T>(b, __bfloat162float(su[c >> 1]), xs, D, c, u);
      }
      warp_sum<T>(g);
      warp_sum<T>(u);
#pragma unroll
      for (int t = 0; t < T; ++t) {
        if (lane == t) {
          const float gt = g[t];
          inner[(size_t)t * F + f] = __float2bfloat16_rn(gt * (1.0f / (1.0f + expf(-gt))) * u[t]);
        }
      }
    }
  }
  if (!kFull) return;

  // -- grid barrier: every column of inner is written --------------------------------
  // (the block's writes are ordered by the block barrier, then published by thread 0's fence)
  __syncthreads();
  if (tid == 0) {
    volatile unsigned int* gen = barrier + 1;
    const unsigned int my_gen = *gen;
    __threadfence();
    if (atomicAdd(barrier, 1u) == gridDim.x - 1) {
      atomicExch(barrier, 0u);
      __threadfence();
      atomicAdd(barrier + 1, 1u);
    } else {
      while (*gen == my_gen) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();

  // -- stage 2: y[:, d] = x[:, d] + sum_j p_j, a warp an output row ---------------------
  // Rows are dealt out across the blocks (d = blockIdx.x + k * gridDim.x), so every SM takes
  // its share. A lane forms the partials p_j of its Q8 blocks j; they go through shared memory
  // and lane t adds them to x[t, d] in j order.
  if ((int)blockIdx.x >= D) return;  // no row for this block
  {
    const uint4* src = reinterpret_cast<const uint4*>(inner);
    uint4* dst = reinterpret_cast<uint4*>(xs);
    for (int i = tid; i < T * F / 8; i += kThreads) dst[i] = __ldcg(src + i);  // from L2
  }
  __syncthreads();
  const int nb = F / kBlock;
  float* part = partials + (size_t)warp * T * (nb + 1);  // [T, nb + 1]: the pad spreads lanes over banks
  for (int d = blockIdx.x + warp * gridDim.x; d < D; d += kWarps * gridDim.x) {
    const int8_t* qrow = dn_q + (size_t)d * F;
    const __nv_bfloat16* srow = dn_s + (size_t)d * nb;
#pragma unroll 4
    for (int j = lane; j < nb; j += 32) {
      const int4 a = *reinterpret_cast<const int4*>(qrow + j * kBlock);
      const int4 b = *reinterpret_cast<const int4*>(qrow + j * kBlock + 16);
      const float sc = __bfloat162float(srow[j]);
      float p[T];
#pragma unroll
      for (int t = 0; t < T; ++t) p[t] = 0.f;
      dot16<T>(a, sc, xs, F, 2 * j, p);
      dot16<T>(b, sc, xs, F, 2 * j + 1, p);
#pragma unroll
      for (int t = 0; t < T; ++t) part[t * (nb + 1) + j] = p[t];
    }
    __syncwarp();
    if (lane < T) {
      float o = __bfloat162float(x[(size_t)lane * D + d]);
      for (int j = 0; j < nb; ++j) o += part[lane * (nb + 1) + j];
      y[(size_t)lane * D + d] = o;
    }
    __syncwarp();
  }
}

int num_sms() {
  static const int count = [] {
    int device = 0;
    int n = 132;
    if (cudaGetDevice(&device) == cudaSuccess) cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    return n;
  }();
  return count;
}

// Shared memory (static + dynamic, checked against the opt-in limit: the static arrays count
// too) and, for the cooperative launch, the blocks an SM holds at that size.
template <int T, bool kFull>
cudaError_t configure(size_t smem, int* per_sm) {
  static std::mutex mu;
  static size_t done_smem = 0;
  static int done_per_sm = 0;
  std::lock_guard<std::mutex> lock(mu);
  if (done_smem == smem) {
    *per_sm = done_per_sm;
    return cudaSuccess;
  }
  auto kernel = fused_ffn_kernel<T, kFull>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int device = 0;
  int optin = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) != cudaSuccess)
    return err;
  if (attr.sharedSizeBytes + smem > (size_t)optin) return cudaErrorInvalidValue;
  if (attr.sharedSizeBytes + smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (n < 1) return cudaErrorInvalidConfiguration;
  done_smem = smem;
  done_per_sm = n;
  *per_sm = n;
  return cudaSuccess;
}

template <int T>
cudaError_t launch_full(const void* x, const void* norm_w, const void* gu_q, const void* gu_s, const void* dn_q,
                        const void* dn_s, void* inner, void* y, void* barrier, int D, int F, float eps,
                        cudaStream_t stream) {
  const size_t smem = full_smem_bytes<T>(D, F);
  int per_sm = 0;
  cudaError_t err = configure<T, true>(smem, &per_sm);
  if (err != cudaSuccess) return err;
  int blocks = (F + kWarps - 1) / kWarps;  // a warp a column in stage 1
  if (blocks > per_sm * num_sms()) blocks = per_sm * num_sms();
  const __nv_bfloat16* xa = static_cast<const __nv_bfloat16*>(x);
  const float* nw = static_cast<const float*>(norm_w);
  const int8_t* gq = static_cast<const int8_t*>(gu_q);
  const __nv_bfloat16* gs = static_cast<const __nv_bfloat16*>(gu_s);
  const int8_t* dq = static_cast<const int8_t*>(dn_q);
  const __nv_bfloat16* ds = static_cast<const __nv_bfloat16*>(dn_s);
  __nv_bfloat16* in = static_cast<__nv_bfloat16*>(inner);
  float* ya = static_cast<float*>(y);
  unsigned int* bar = static_cast<unsigned int*>(barrier);
  void* args[] = {&xa, &nw, &gq, &gs, &dq, &ds, &in, &ya, &bar, &D, &F, &eps};
  return cudaLaunchCooperativeKernel((const void*)fused_ffn_kernel<T, true>, dim3(blocks), dim3(kThreads), args,
                                     smem, stream);
}

template <int T>
cudaError_t launch_gateup(const void* h, const void* gu_q, const void* gu_s, void* inner, int D, int F,
                          cudaStream_t stream) {
  const size_t smem = (size_t)T * D * sizeof(__nv_bfloat16);
  int per_sm = 0;
  cudaError_t err = configure<T, false>(smem, &per_sm);
  if (err != cudaSuccess) return err;
  int blocks = (F + kWarps - 1) / kWarps;
  if (blocks > num_sms() * 8) blocks = num_sms() * 8;
  fused_ffn_kernel<T, false><<<blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(h), nullptr, static_cast<const int8_t*>(gu_q),
      static_cast<const __nv_bfloat16*>(gu_s), nullptr, nullptr, static_cast<__nv_bfloat16*>(inner), nullptr,
      nullptr, D, F, 0.f);
  return cudaGetLastError();
}

bool shape_ok(int T, int D, int F) {
  return T >= 1 && T <= 8 && D > 0 && F > 0 && D % kBlock == 0 && F % kBlock == 0;
}

}  // namespace

// Returns a cudaError_t (0 on success). inner (bf16 [T, F]) is scratch; barrier (uint32 [2])
// must be zero before the first launch and is left so; launches sharing it are serialised by
// their stream.
extern "C" int lwt_fused_ffn_step(const void* x, const void* norm_w, const void* gu_q, const void* gu_s,
                                  const void* dn_q, const void* dn_s, void* inner, void* y, void* barrier, int T,
                                  int D, int F, float eps, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(T, D, F)) return (int)cudaErrorInvalidValue;
  switch (T) {
#define LWT_CASE(n) \
  case n: return (int)launch_full<n>(x, norm_w, gu_q, gu_s, dn_q, dn_s, inner, y, barrier, D, F, eps, stream);
    LWT_CASE(1) LWT_CASE(2) LWT_CASE(3) LWT_CASE(4) LWT_CASE(5) LWT_CASE(6) LWT_CASE(7) LWT_CASE(8)
#undef LWT_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// inner[T, F] = bf16(silu(gate . h) * (up . h)) for an already normalised bf16 h [T, D].
extern "C" int lwt_fused_gateup_silu(const void* h, const void* gu_q, const void* gu_s, void* inner, int T, int D,
                                     int F, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(T, D, F)) return (int)cudaErrorInvalidValue;
  switch (T) {
#define LWT_CASE(n) \
  case n: return (int)launch_gateup<n>(h, gu_q, gu_s, inner, D, F, stream);
    LWT_CASE(1) LWT_CASE(2) LWT_CASE(3) LWT_CASE(4) LWT_CASE(5) LWT_CASE(6) LWT_CASE(7) LWT_CASE(8)
#undef LWT_CASE
  }
  return (int)cudaErrorInvalidValue;
}
