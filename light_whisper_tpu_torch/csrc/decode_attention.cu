// GQA decode attention over the head-major KV cache for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of light_whisper_tpu/ops/decode_attention.py:
//   decode_attention_pallas          (_kernel):          cache [Hkv, C, hd]
//   decode_attention_pallas_stacked  (_kernel_stacked):  cache [L, Hkv, C, hd] at a layer
//   decode_attention_pallas_batched  (_kernel_batched):  caches [B, L, Hkv, C, hd] at a layer,
//                                                         stream b bounded by pos[b]
// out[row, h, :] = softmax_j(q[row, h] . k[h / G, j] * hd^-1/2, j <= bound(row)) . v[h / G, j]
//
// The first two share the entry lwt_decode_attention (the caller passes the layer's [Hkv, C, hd]
// block: q[layer] is a view in torch, so the stacked form is the unstacked one at an offset);
// query row t sits at position start + t. The batched form is lwt_decode_attention_batched:
// one query row per stream, bounded by pos[b], read from device memory where the TPU kernel
// used scalar prefetch, with each stream's cache at ((b * L + layer) * Hkv + kvh) * C * hd.
// All three run the same row body (attend_row).
//
// Numerics (shared with the plain PyTorch versions in ops/decode_attention.py):
//   logits f32 from bf16 q and k, times hd^-1/2; keys past a row's bound are masked
//   (the TPU kernels write -1e30 there; exp(-1e30 - m) is exactly 0 in f32, so reading only
//   the live keys is exact, and whatever a cache holds past the bound is never read);
//   softmax in f32, normalised, p cast to bf16; p . v with bf16 operands accumulated in f32;
//   output f32.
//
// What bounds it on the H100: bytes. Each (KV head, query row) reads the live K and V rows
// of its head, 2 * nlive * hd * 2 bytes; the arithmetic is 4 FLOPs per cached element per
// query row, far below the card's ridge. At decode the whole step reads a few MB of cache per
// stream against ~0.6 GB of weights shared by the batch, so this kernel is a small share of a
// step.
//
// What the simple design does about it:
//   - one block of eight warps per (stream, KV head, query row): at T = 1 that is 8 x 2 = 16
//     blocks, at T = 64 it is 1024, batched at B = 8 it is 8 x 8 x 2 = 128; the warps of a
//     block split the row's live keys between them, and rows of one KV head share K/V through
//     L1/L2;
//   - only the live keys of each row are read;
//   - two passes over the live keys to keep the reference's rounding: pass 1 computes the max
//     and the softmax denominator (online per lane, then merged across the warp and the block);
//     pass 2 recomputes each logit the same way (one lane per key), forms
//     p = bf16(exp(s - m) / l), and each lane accumulates p . v for its hd / 32 dims over the
//     warp's 32-key tile; the eight partial outputs are summed through shared memory.
//     Splitting a long cache over several blocks (flash-decoding) is later work.
// The TPU batched kernel padded each program's G query rows to a sublane tile of 8 (_ROW_PAD);
// that is a TPU layout rule and has no counterpart here.

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

// One block: query row qrow [HD] against keys/values 0..nlive-1 of one KV head (kh, vh:
// [C, HD]), result to orow [HD].
template <int HD>
__device__ __forceinline__ void attend_row(const __nv_bfloat16* __restrict__ qrow,
                                           const __nv_bfloat16* __restrict__ kh,
                                           const __nv_bfloat16* __restrict__ vh,
                                           float* __restrict__ orow, int nlive, float scale) {
  constexpr int kPerLane = HD / 32;
  __shared__ __align__(16) float qs[HD];
  __shared__ float red_m[kWarps];
  __shared__ float red_l[kWarps];
  __shared__ float partial[kWarps][HD];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int d = threadIdx.x; d < HD; d += kThreads) qs[d] = __bfloat162float(qrow[d]);
  __syncthreads();

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
  for (int d = threadIdx.x; d < HD; d += kThreads) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += partial[w][d];
    orow[d] = total;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const __nv_bfloat16* __restrict__ q,  // [T, Hq, HD]
    const __nv_bfloat16* __restrict__ k,  // [Hkv, C, HD] (layer already applied)
    const __nv_bfloat16* __restrict__ v,  // [Hkv, C, HD]
    float* __restrict__ out,              // [T, Hq, HD]
    int T, int Hq, int Hkv, int C, int start, float scale) {
  const int G = Hq / Hkv;
  const int kvh = blockIdx.x;
  const int row = blockIdx.y;  // row = g * T + t
  const int g = row / T;
  const int t = row - g * T;
  const int h = kvh * G + g;
  const size_t head = (size_t)kvh * C * HD;
  attend_row<HD>(q + ((size_t)t * Hq + h) * HD, k + head, v + head, out + ((size_t)t * Hq + h) * HD,
                 start + t + 1, scale);
}

template <int HD>
__global__ void __launch_bounds__(kThreads) decode_attention_batched_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, Hq, HD]
    const __nv_bfloat16* __restrict__ k,  // [B, L, Hkv, C, HD]
    const __nv_bfloat16* __restrict__ v,  // [B, L, Hkv, C, HD]
    const int* __restrict__ pos,          // [B]: stream b's query sits at pos[b]
    float* __restrict__ out,              // [B, Hq, HD]
    int Hq, int Hkv, int C, int L, int layer, float scale) {
  const int G = Hq / Hkv;
  const int kvh = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int h = kvh * G + g;
  // the wrapper bounds the host mirror of pos; a device position outside the
  // cache means the two disagree, and the launch fails rather than read another prefix
  const int p = pos[b];
  if (p < 0 || p >= C) __trap();
  const int nlive = p + 1;
  const size_t head = (((size_t)b * L + layer) * Hkv + kvh) * C * HD;
  attend_row<HD>(q + ((size_t)b * Hq + h) * HD, k + head, v + head, out + ((size_t)b * Hq + h) * HD,
                 nlive, scale);
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

template <int HD>
cudaError_t launch_batched(const void* q, const void* k, const void* v, const void* pos, void* out,
                           int B, int Hq, int Hkv, int C, int L, int layer, float scale,
                           cudaStream_t stream) {
  dim3 grid(Hkv, Hq / Hkv, B);
  decode_attention_batched_kernel<HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(pos), static_cast<float*>(out),
      Hq, Hkv, C, L, layer, scale);
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

// Returns a cudaError_t (0 on success). k_all and v_all are the whole [B, L, Hkv, C, hd]
// caches; pos is a device int32 [B]. Stream b's one query row sees its keys 0..pos[b] of
// layer `layer`.
extern "C" int lwt_decode_attention_batched(const void* q, const void* k_all, const void* v_all,
                                            const void* pos, void* out, int B, int Hq, int Hkv,
                                            int C, int L, int hd, int layer, float scale,
                                            void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hq % Hkv != 0 || C <= 0 || layer < 0 || layer >= L) {
    return (int)cudaErrorInvalidValue;
  }
  switch (hd) {
    case 64: return (int)launch_batched<64>(q, k_all, v_all, pos, out, B, Hq, Hkv, C, L, layer, scale, stream);
    case 128: return (int)launch_batched<128>(q, k_all, v_all, pos, out, B, Hq, Hkv, C, L, layer, scale, stream);
    case 256: return (int)launch_batched<256>(q, k_all, v_all, pos, out, B, Hq, Hkv, C, L, layer, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
