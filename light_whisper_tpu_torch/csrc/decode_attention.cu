// Layer-indexed GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel light_whisper_tpu/ops/decode_attention.py:
//   decode_attention_pallas_stacked (body _kernel_stacked -> _kernel)
// out[t, h, :] = softmax_j(q[t, h] . k[layer, h / G, j] * hd^-1/2, j <= start + t) . v[layer, h / G, j]
//
// Numerics (shared with the plain PyTorch version in ops/decode_attention.py):
//   logits f32 from bf16 q and k, times hd^-1/2; keys past a row's position are masked
//   (the TPU kernel writes -1e30 there; exp(-1e30 - m) is exactly 0 in f32, so reading only
//   the live keys j <= start + t is exact); softmax in f32, normalised, p cast to bf16;
//   p . v with bf16 operands accumulated in f32; output f32 [T, Hq, hd].
//
// What bounds it on the H100: bytes. Each (KV head, query row group) reads the live K and V rows
// of its head, 2 * (pos + 1) * hd * 2 bytes; the arithmetic is 4 FLOPs per cached element per
// query row, far below the card's ridge. At decode (T = 1) the whole step reads a few MB of
// cache against ~0.6 GB of weights, so this kernel is a small share of a step.
//
// What the simple design does about it:
//   - one block of eight warps per (KV head, query row): at T = 1 that is 8 x 2 = 16 blocks,
//     at T = 64 it is 1024; the warps of a block split the row's live keys between them, and
//     rows of one KV head share K/V through L1/L2;
//   - only the live keys of each row are read;
//   - two passes over the live keys to keep the reference's rounding: pass 1 computes the max
//     and the softmax denominator (online per lane, then merged across the warp and the block);
//     pass 2 recomputes each logit the same way (one lane per key), forms
//     p = bf16(exp(s - m) / l), and each lane accumulates p . v for its hd / 32 dims over the
//     warp's 32-key tile; the eight partial outputs are summed through shared memory.
//     Splitting a long cache over several blocks (flash-decoding) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInit = -1e30f;

template <int HD>
__device__ __forceinline__ float dot_row(const float* __restrict__ qs,
                                         const __nv_bfloat16* __restrict__ krow) {
  const uint4* kp = reinterpret_cast<const uint4*>(krow);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    uint4 kv = kp[i];
    const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __bfloat1622float2(k2[j]);
      acc = fmaf(qs[i * 8 + 2 * j], f.x, acc);
      acc = fmaf(qs[i * 8 + 2 * j + 1], f.y, acc);
    }
  }
  return acc;
}

template <int HD>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const __nv_bfloat16* __restrict__ q,  // [T, Hq, HD]
    const __nv_bfloat16* __restrict__ k,  // [Hkv, C, HD] (layer already applied)
    const __nv_bfloat16* __restrict__ v,  // [Hkv, C, HD]
    float* __restrict__ out,              // [T, Hq, HD]
    int T, int Hq, int Hkv, int C, int start, float scale) {
  constexpr int kPerLane = HD / 32;
  __shared__ __align__(16) float qs[HD];
  __shared__ float red_m[kWarps];
  __shared__ float red_l[kWarps];
  __shared__ float partial[kWarps][HD];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int G = Hq / Hkv;
  const int kvh = blockIdx.x;
  const int row = blockIdx.y;  // row = g * T + t
  const int g = row / T;
  const int t = row - g * T;
  const int h = kvh * G + g;
  const int nlive = start + t + 1;

  const __nv_bfloat16* qrow = q + ((size_t)t * Hq + h) * HD;
  for (int d = threadIdx.x; d < HD; d += kThreads) qs[d] = __bfloat162float(qrow[d]);
  __syncthreads();

  const __nv_bfloat16* kh = k + (size_t)kvh * C * HD;
  const __nv_bfloat16* vh = v + (size_t)kvh * C * HD;

  // Pass 1: max and denominator. Warp w owns the 32-key tiles w, w + 8, ...
  float m = kNegInit;
  float l = 0.f;
  for (int base = warp * 32; base < nlive; base += kWarps * 32) {
    const int j = base + lane;
    if (j < nlive) {
      const float sj = dot_row<HD>(qs, kh + (size_t)j * HD) * scale;
      const float m_new = fmaxf(m, sj);
      l = l * expf(m - m_new) + expf(sj - m_new);
      m = m_new;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float m_new = fmaxf(m, m_o);
    l = l * expf(m - m_new) + l_o * expf(m_o - m_new);
    m = m_new;
  }
  if (lane == 0) {
    red_m[warp] = m;
    red_l[warp] = l;
  }
  __syncthreads();
  m = red_m[0];
  l = red_l[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    const float m_new = fmaxf(m, red_m[w]);
    l = l * expf(m - m_new) + red_l[w] * expf(red_m[w] - m_new);
    m = m_new;
  }

  // Pass 2: p = bf16(exp(s - m) / l), partial out = sum over this warp's keys of p_j v_j.
  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.f;
  for (int base = warp * 32; base < nlive; base += kWarps * 32) {
    const int j = base + lane;
    float p = 0.f;
    if (j < nlive) {
      const float sj = dot_row<HD>(qs, kh + (size_t)j * HD) * scale;
      p = __bfloat162float(__float2bfloat16_rn(expf(sj - m) / l));
    }
    const int count = min(32, nlive - base);
#pragma unroll 8
    for (int jj = 0; jj < 32; ++jj) {
      const float pj = __shfl_sync(0xffffffffu, p, jj);
      if (jj < count) {
        const __nv_bfloat16* vrow = vh + (size_t)(base + jj) * HD + lane * kPerLane;
#pragma unroll
        for (int i = 0; i < kPerLane; i += 2) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vrow + i));
          acc[i] = fmaf(pj, f.x, acc[i]);
          acc[i + 1] = fmaf(pj, f.y, acc[i + 1]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) partial[warp][lane * kPerLane + i] = acc[i];
  __syncthreads();
  float* orow = out + ((size_t)t * Hq + h) * HD;
  for (int d = threadIdx.x; d < HD; d += kThreads) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += partial[w][d];
    orow[d] = total;
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int T, int Hq, int Hkv,
                   int C, int start, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  dim3 grid(Hkv, G * T);
  decode_attention_kernel<HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out), T, Hq, Hkv, C, start,
      scale);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success). k and v point at the layer's [Hkv, C, hd] block.
// Query row t sits at absolute position start + t and sees keys 0..start + t.
extern "C" int lwt_decode_attention(const void* q, const void* k, const void* v, void* out, int T,
                                    int Hq, int Hkv, int C, int hd, int start, float scale,
                                    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (T <= 0 || Hkv <= 0 || Hq % Hkv != 0 || start < 0 || start + T > C) {
    return (int)cudaErrorInvalidValue;
  }
  switch (hd) {
    case 64: return (int)launch<64>(q, k, v, out, T, Hq, Hkv, C, start, scale, stream);
    case 128: return (int)launch<128>(q, k, v, out, T, Hq, Hkv, C, start, scale, stream);
    case 256: return (int)launch<256>(q, k, v, out, T, Hq, Hkv, C, start, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
