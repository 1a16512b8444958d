// Causal prefill attention against a long KV cache, with an online softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel light_whisper_tpu/ops/flash_prefill.py:_flash_rows (the
// pallas_call of flash_prefill_attention). For each KV head and each of its G * T query rows
// (query head kvh * G + g at time t, absolute position start + t):
//   s_j = (q . k_j) * hd^-1/2 in f32, keys past the row's position at -1e30;
//   running max m and denominator l in f32; l sums the f32 p_j = exp(s_j - m), while p . v
//   uses p rounded to bf16 (bf16 operands, f32 accumulation);
//   out = acc / l in f32, and a row with l == 0 gives exactly 0.
//
// What bounds it on the H100: operations. A prefill of T rows over a cache of C >= 8192 slots
// does 4 * Hq * hd * T^2 / 2 flops of causal attention (6.4e10 a layer at 0.6B, T = 3,968)
// against ~64 MB of q, live K/V and f32 output: far above the card's ridge of ~295 flops a byte,
// so the bf16 tensor cores set the floor (~65 us a layer at 989 TFLOP/s).
//
// What the simple design does about it:
//   - one block of four warps per (KV head, tile of 64 flattened query rows), one 16-row strip
//     a warp; the block walks the keys in tiles of 64. q . k and p . v run on the tensor cores
//     (mma.sync m16n8k16, bf16 operands, f32 accumulation), with the operands fed from shared
//     memory by ldmatrix. The logits, p, the running max and denominator and the accumulator
//     stay in registers: the accumulator layout of q . k is the operand layout of p . v, and a
//     thread holds two whole rows' worth of its four-thread group, so the per-row online
//     softmax is f32 arithmetic plus two shuffles;
//   - the next K/V tile is copied with cp.async while the current one is computed (two stages);
//   - rows are flattened time-major (row = t * G + g), so a tile holds 64 / G consecutive
//     positions and the block stops at the last key its last row can see. This is exact: a
//     fully masked key tile leaves m, l and acc unchanged (alpha = 1, p = 0). The TPU kernel
//     walks all C / 512 key blocks; here the causal half is skipped, and the cache past the
//     prompt is never read;
//   - the kernel masks its own ragged edge (rows past G * T are zero queries that see no key;
//     keys past the tile's last visible one are zero-filled), where the TPU wrapper padded rows
//     with position -1.
// Splitting a long cache over several blocks (few query tiles, as at T = 512 over 32k slots),
// wgmma, TMA and warp specialisation are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

constexpr int kHD = 128;           // head dim (Qwen3-ASR)
constexpr int kRows = 64;          // query rows a block
constexpr int kKeys = 64;          // keys a tile
constexpr int kWarps = kRows / 16; // one 16-row strip a warp
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kHD + 8;       // bf16 row stride in shared memory: ldmatrix without bank conflicts
constexpr int kChunks = kHD / 8;   // 16-byte chunks a row
constexpr float kNegInf = -1e30f;

constexpr size_t kTileBytes = sizeof(__nv_bfloat16) * kKeys * kLd;  // one K or V tile (= the Q tile)
constexpr size_t kSmemBytes = kTileBytes * 5;                       // Q, and K and V in two stages

__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(
    const __nv_bfloat16* __restrict__ q,  // [T, Hq, kHD]
    const __nv_bfloat16* __restrict__ k,  // [Hkv, C, kHD]
    const __nv_bfloat16* __restrict__ v,  // [Hkv, C, kHD]
    float* __restrict__ out,              // [T, Hq, kHD]
    int T, int Hq, int Hkv, int C, int start, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + kTileBytes);      // [2][kKeys][kLd]
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + 3 * kTileBytes);  // [2][kKeys][kLd]

  const int G = Hq / Hkv;
  const int rows = G * T;
  const int kvh = blockIdx.y;
  const int row0 = blockIdx.x * kRows;  // tile row r is flattened row row0 + r = t * G + g
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int quad_row = lane >> 2;  // this thread's rows in the strip: quad_row and quad_row + 8
  const int quad_col = lane & 3;   // and its column pair 2 * quad_col within each 8-wide tile
  const __nv_bfloat16* kh = k + (size_t)kvh * C * kHD;
  const __nv_bfloat16* vh = v + (size_t)kvh * C * kHD;
  // keys 0..nkeys-1 are visible to some row of the tile: the last row has the largest position
  const int nkeys = start + (min(row0 + kRows, rows) - 1) / G + 1;
  const int ntiles = (nkeys + kKeys - 1) / kKeys;

  auto load_tile = [&](int stage, int kb) {
    __nv_bfloat16* kd = Ks + stage * kKeys * kLd;
    __nv_bfloat16* vd = Vs + stage * kKeys * kLd;
    for (int e = threadIdx.x; e < kKeys * kChunks; e += kThreads) {
      const int j = e / kChunks, c = e - j * kChunks;
      const bool live = kb + j < nkeys;
      const size_t off = live ? (size_t)(kb + j) * kHD + c * 8 : 0;
      cp_async16(kd + j * kLd + c * 8, kh + off, live ? 16 : 0);
      cp_async16(vd + j * kLd + c * 8, vh + off, live ? 16 : 0);
    }
    cp_async_commit();
  };

  load_tile(0, 0);
  for (int e = threadIdx.x; e < kRows * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e - r * kChunks;
    const int fr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (fr < rows) {
      const int t = fr / G, g = fr - t * G;
      val = reinterpret_cast<const uint4*>(q + ((size_t)t * Hq + kvh * G + g) * kHD)[c];
    }
    *reinterpret_cast<uint4*>(Qs + r * kLd + c * 8) = val;
  }
  __syncthreads();

  // this warp's q strip as mma A operands, one per 16-wide step of the head dim
  uint32_t qa[kHD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kHD / 16; ++kk) {
    ldmatrix_x4(qa[kk], Qs + (warp * 16 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);
  }

  const int r_lo = row0 + warp * 16 + quad_row;  // flattened rows of this thread
  const int r_hi = r_lo + 8;
  const int pos_lo = r_lo < rows ? start + r_lo / G : -1;  // -1: past the ragged edge, sees no key
  const int pos_hi = r_hi < rows ? start + r_hi / G : -1;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;  // l: this thread's share of the row sum
  float acc[kHD / 8][4];
#pragma unroll
  for (int n = 0; n < kHD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int kb = it * kKeys;
    if (it + 1 < ntiles) {
      load_tile((it + 1) & 1, kb + kKeys);  // the stage the previous tile used: every warp is past it
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + (it & 1) * kKeys * kLd;
    const __nv_bfloat16* Vt = Vs + (it & 1) * kKeys * kLd;

    // s = q . k: 16 rows x 64 keys, eight 8-key accumulator tiles
    float s[kKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHD / 16; ++kk) {
#pragma unroll
      for (int jj = 0; jj < kKeys / 16; ++jj) {
        uint32_t b[4];  // key tiles 2jj and 2jj + 1, head dims kk * 16 .. + 15
        ldmatrix_x4(b, Kt + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jj], qa[kk], b[0], b[1]);
        mma_bf16(s[2 * jj + 1], qa[kk], b[2], b[3]);
      }
    }

    // online softmax of the two rows (a four-thread group holds a row's 64 keys)
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kb + j * 8 + quad_col * 2 + e;
        s[j][e] = key <= pos_lo ? s[j][e] * scale : kNegInf;
        s[j][2 + e] = key <= pos_hi ? s[j][2 + e] * scale : kNegInf;
        mx_lo = fmaxf(mx_lo, s[j][e]);
        mx_hi = fmaxf(mx_hi, s[j][2 + e]);
      }
    }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    const float alpha_lo = expf(m_lo - mn_lo);
    const float alpha_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kb + j * 8 + quad_col * 2 + e;
        s[j][e] = key <= pos_lo ? expf(s[j][e] - m_lo) : 0.f;
        s[j][2 + e] = key <= pos_hi ? expf(s[j][2 + e] - m_hi) : 0.f;
        ps_lo += s[j][e];
        ps_hi += s[j][2 + e];
      }
    }
    l_lo = l_lo * alpha_lo + ps_lo;
    l_hi = l_hi * alpha_hi + ps_hi;
#pragma unroll
    for (int n = 0; n < kHD / 8; ++n) {
      acc[n][0] *= alpha_lo;
      acc[n][1] *= alpha_lo;
      acc[n][2] *= alpha_hi;
      acc[n][3] *= alpha_hi;
    }

    // acc += bf16(p) . v: the accumulator tiles of s are the A operand of p . v
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nn = 0; nn < kHD / 16; ++nn) {
        uint32_t b[4];  // keys kk * 16 .. + 15, head-dim tiles 2nn and 2nn + 1
        ldmatrix_x4_trans(b, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + nn * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * nn], pa, b[0], b[1]);
        mma_bf16(acc[2 * nn + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is loaded again
  }

  // out = acc / l; a row that saw no key (l == 0) gives exactly 0
  const float lt_lo = quad_sum(l_lo);
  const float lt_hi = quad_sum(l_hi);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int fr = half ? r_hi : r_lo;
    if (fr >= rows) continue;
    const float l = half ? lt_hi : lt_lo;
    const int t = fr / G, g = fr - t * G;
    float* orow = out + ((size_t)t * Hq + kvh * G + g) * kHD;
#pragma unroll
    for (int n = 0; n < kHD / 8; ++n) {
      const float a0 = acc[n][2 * half], a1 = acc[n][2 * half + 1];
      *reinterpret_cast<float2*>(orow + n * 8 + quad_col * 2) =
          l > 0.f ? make_float2(a0 / l, a1 / l) : make_float2(0.f, 0.f);
    }
  }
}

}  // namespace

// Returns a cudaError_t (0 on success). q [T, Hq, hd] bf16; k and v the layer's [Hkv, C, hd]
// bf16 block; out [T, Hq, hd] f32. Query row t sits at absolute position start + t and sees
// keys 0..start + t. Only hd = 128 is built.
extern "C" int lwt_flash_prefill(const void* q, const void* k, const void* v, void* out, int T, int Hq,
                                 int Hkv, int C, int hd, int start, float scale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (T <= 0 || Hkv <= 0 || Hq % Hkv != 0 || start < 0 || (long long)start + T > C || hd != kHD) {
    return (int)cudaErrorInvalidValue;
  }
  // the opt-in limit bounds static and dynamic shared memory together
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, flash_prefill_kernel);
  if (err != cudaSuccess) return (int)err;
  int device = 0, optin = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (attr.sharedSizeBytes + kSmemBytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(flash_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int G = Hq / Hkv;
  dim3 grid((G * T + kRows - 1) / kRows, Hkv);
  flash_prefill_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out), T, Hq, Hkv, C, start, scale);
  return (int)cudaGetLastError();
}
