// The Q8_0 decode GEMV for Hopper (sm_90a), T <= 8 rows: one body for the shipped product and
// for the probes that measure it.
//
// q8_matmul.cu instantiates kFull: lwt_q8_matmul at T <= 8 (the TPU kernels _q8_matmul_2d,
// _q8_matmul_stacked_2d and _q8_matmul_stacked_fused_2d of light_whisper_tpu/ops/q8_matmul.py).
// q8_probe.cu instantiates the probe variants (the reference's scripts/exp_q8_compute_bound.py
// _run_variant and scripts/exp_q8_kperm_probe.py _q8_matmul_perm_2d /
// _q8_matmul_stacked_perm_2d), so every variant runs the schedule that ships and a change to
// the GEMV carries the probes with it.
//
// The schedule (every variant): 128 threads, a CTA of 4 warps owns 8 weight rows at a time
// (mma's n = 8) and splits K over its warps (S = 4, every T; split_range over 64-wide chunks).
// x (the T rows, zero-padded to 16) is staged in shared memory by cp.async with 16 bytes of
// row padding, and is the mma's A; B is the 8 rows dequantised in registers. Lane (g, c) of a
// chunk takes weight row n0 + g and k = 64 ch + 16c .. +15 (one 16-byte load), which the
// mma.sync m16n8k16 k map pairs with the same 16 columns of x. Each warp issues its first
// quants and scales right behind x's copies and keeps two batches of 4 chunks in registers,
// one in flight while the other is used; CTAs stride over row groups; after a group's last
// batch the warps' partials are summed in warp order through shared memory. T = 1 runs the
// same instructions as T = 8 with zero rows, so each output sums in one order for every T.
// Grid: num_sms x 4 CTAs (x 2 with kFull's norm prologue), capped at the row groups. The probe
// variants take any T: rows go in groups of 8 along the grid's y axis (kFull is launched at
// T <= 8 only).
//
// The variants differ in the per-chunk term only:
//   kFull:    w = bf16(float(q) * float(s)), one scale a chunk; with the optional rms-norm
//             prologue and residual epilogue.
//   kNoScale: w = bf16(float(q)), exact (|q| <= 128); the scale is loaded as kFull loads it and
//             folded into a junk word, not multiplied.
//   kLoad:    kFull's loads of x, quants and scales, in its order and batches, folded into a
//             junk word; no dequant and no mma. Output y[t, i] = sum_kb q[t, kb*block_k + i] for
//             i < min(N, block_k), else 0 (the TPU body's touch of its block), written in the
//             group epilogue from the T rows of q: T*K more bytes, read once.
//   kPerm:    weights and x permuted within every block_k block of K (permuted column a*nb + b
//             holds original column b*32 + a, nb = block_k / 32): lane c's 16 quants need the
//             16 scales s[n, blk*nb + (j0 + i) % nb]. With nb a multiple of 16 they are 16
//             contiguous bf16 (32-byte aligned: K/32 is a multiple of nb), two 16-byte loads;
//             else one load each. Held in both register batches (8 words a chunk) they spilled,
//             so the batch asks for the window in L1 (prefetch.global.L1) where kFull loads its
//             scale, and the dequant reads it from there as bf16 pairs.
// Junk words are multiplied by the run-time `zero` (0.0f) and added to the output, so that no
// load can be dropped.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

constexpr int kBlock = 32;  // Q8_0 block length along K
constexpr int kChunk = 64;  // K a chunk: two Q8 blocks, four mma k-steps

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

enum GemvVariant { kFull = 0, kNoScale = 1, kLoad = 2, kPerm = 3 };

constexpr int kGemvWarps = 4;  // = the K splits of every T <= 8 call
constexpr int kGemvThreads = kGemvWarps * 32;
constexpr int kGemvRows = 8;   // weight rows a group (mma's n)
constexpr int kGemvBatch = 4;  // chunks a lane holds in registers a batch
constexpr int kGemvCtasPerSm = 4;
constexpr int kMaxRows = 8;
constexpr int kNormVecs = 3;  // norm_w vectors a thread prefetches: K <= 3 * 8 * threads (3072)

struct GemvBatch {
  int4 q[kGemvBatch];
  float s[kGemvBatch];  // kPerm: unused (its scales are read at the dequant)
};

struct GemvArgs {
  const __nv_bfloat16* x;         // [T, K]
  const int8_t* q;                // [N, K]
  const __nv_bfloat16* s;         // [N, K/32]
  const float* norm_w;            // [K] or null
  const __nv_bfloat16* residual;  // [T, N] or null
  float* y;                       // [T, N]
  int T, N, K;
  float eps;
  int block_k;  // kLoad's touch block, kPerm's permutation block
  float zero;   // 0.0f: the junk words' weight
};

// kPerm: the scale of permuted column k of row n, s[n, blk*nb + (k mod block_k) mod nb]. With nb
// a multiple of 16 and k a multiple of 16 it starts the window of columns k .. k + 15.
__device__ __forceinline__ const __nv_bfloat16* perm_scale(const GemvArgs& a, int n, int k) {
  const int nb = a.block_k / kBlock;
  const int blk = k / a.block_k;
  return a.s + (size_t)n * (a.K / kBlock) + blk * nb + (k - blk * a.block_k) % nb;
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// kPerm: the scales of permuted columns k .. k + 15 of row n, as bf16 pairs
__device__ __forceinline__ void perm_scales(uint32_t (&w)[8], const GemvArgs& a, int n, int k) {
  if ((a.block_k / kBlock) % 16 == 0) {  // uniform: one contiguous, 32-byte aligned window
    const uint4* p = reinterpret_cast<const uint4*>(perm_scale(a, n, k));
    const uint4 lo = __ldg(p), hi = __ldg(p + 1);
    w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
    w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      w[i] = (uint32_t)__bfloat16_as_ushort(*perm_scale(a, n, k + 2 * i)) |
             ((uint32_t)__bfloat16_as_ushort(*perm_scale(a, n, k + 2 * i + 1)) << 16);
    }
  }
}

// Lane (g, c)'s quants of weight row n = n0 + g for chunks ch0 .. ch0 + kGemvBatch - 1 (those
// below ce): k = 64 ch + 16c .. +15, and the scale of their Q8 block. kPerm holds no scales in
// registers (16 a chunk, in both batches, spilled): it asks for their window in L1 here, where
// the others load their scale, and reads it at the dequant.
template <int V>
__device__ __forceinline__ void gemv_load(GemvBatch& b, const GemvArgs& a, int n, int c, int ch0, int ce) {
  const int kb = a.K / kBlock;
#pragma unroll
  for (int u = 0; u < kGemvBatch; ++u) {
    const int ch = ch0 + u;
    const int k = ch * kChunk + 16 * c;
    if (n < a.N && ch < ce && k < a.K) {
      b.q[u] = ldg_stream(a.q + (size_t)n * a.K + k);
      if constexpr (V == kPerm) {
        prefetch_l1(perm_scale(a, n, k));
      } else {
        b.s[u] = __bfloat162float(a.s[(size_t)n * kb + (k >> 5)]);
      }
    } else {
      b.q[u] = make_int4(0, 0, 0, 0);
      b.s[u] = 0.f;
    }
  }
}

template <int V>
__device__ __forceinline__ void gemv_compute(const GemvBatch& b, float (&acc)[4], uint32_t& junk, const GemvArgs& a,
                                             int n, const __nv_bfloat16* xs, int xs_stride, int T, int g, int c,
                                             int ch0, int ce) {
#pragma unroll
  for (int u = 0; u < kGemvBatch; ++u) {
    const int ch = ch0 + u;
    if (ch < ce) {  // warp-uniform
      if constexpr (V == kLoad) {
        junk += (uint32_t)b.q[u].x + (uint32_t)b.q[u].y + (uint32_t)b.q[u].z + (uint32_t)b.q[u].w +
                __float_as_uint(b.s[u]);
      } else {
        uint32_t w[8];
        if constexpr (V == kFull) {
          dequant16(b.q[u], b.s[u], w);
        } else if constexpr (V == kNoScale) {
          cvt16(b.q[u], w);
          junk += __float_as_uint(b.s[u]);
        } else {
          const int k = ch * kChunk + 16 * c;
          uint32_t sc[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
          if (n < a.N && k < a.K) perm_scales(sc, a, n, k);
          dequant16_scales(b.q[u], sc, w);
        }
        uint32_t xa[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
        if (g < T) {
          const uint4* p = reinterpret_cast<const uint4*>(xs + (size_t)g * xs_stride + ch * kChunk + 16 * c);
          const uint4 lo = p[0], hi = p[1];
          xa[0] = lo.x; xa[1] = lo.y; xa[2] = lo.z; xa[3] = lo.w;
          xa[4] = hi.x; xa[5] = hi.y; xa[6] = hi.z; xa[7] = hi.w;
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint32_t af[4] = {xa[2 * t], 0u, xa[2 * t + 1], 0u};  // rows 8..15 of A are zero
          mma_bf16(acc, af, w[2 * t], w[2 * t + 1]);
        }
      }
    }
  }
}

// kLoad's output at (row t of q, column n): the TPU body's touch of its block
__device__ __forceinline__ float load_touch(const GemvArgs& a, int t, int n) {
  float v = 0.f;
  if (n < a.block_k) {
    for (int k0 = 0; k0 < a.K; k0 += a.block_k) v += (float)a.q[(size_t)t * a.K + k0 + n];
  }
  return v;
}

template <int V>
__global__ void __launch_bounds__(kGemvThreads, kGemvCtasPerSm) q8_gemv_kernel(GemvArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [T, xs_stride]
  __shared__ __align__(16) float red[2][kGemvWarps][kGemvRows][kGemvRows];
  __shared__ float nred[kGemvWarps][kMaxRows];

  int row0 = 0;  // the probe variants' first row of x, y (and kLoad's q) in this CTA's group of 8
  if constexpr (V != kFull) {
    row0 = (int)blockIdx.y * kMaxRows;
    a.x += (size_t)row0 * a.K;
    a.y += (size_t)row0 * a.N;
    a.T = min(a.T - row0, kMaxRows);
  }
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int T = a.T, N = a.N, K = a.K;
  const int nch = (K + kChunk - 1) / kChunk;
  const int kpad = nch * kChunk;
  const int xs_stride = kpad + 8;  // 16 bytes of padding: conflict-free 16-byte reads of 8 rows
  int cb, ce;
  split_range(nch, kGemvWarps, warp, cb, ce);
  const int nb = ((nch + kGemvWarps - 1) / kGemvWarps + kGemvBatch - 1) / kGemvBatch;  // batches a group
  const int ngroups = (N + kGemvRows - 1) / kGemvRows;
  const int mine = ngroups > (int)blockIdx.x ? (ngroups - (int)blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int nsteps = mine * nb;

  // x (and norm_w) into shared memory with cp.async: one round trip
  const int per_row = kpad / 8;  // 16-byte vectors a staged row
  for (int i = tid; i < T * per_row; i += kGemvThreads) {
    const int t = i / per_row;
    const int k = (i - t * per_row) * 8;
    __nv_bfloat16* dst = xs + t * xs_stride + k;
    if (k < K) {
      cp_async16(dst, a.x + (size_t)t * K + k, 16);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_async_commit();
  // the weight stream starts right behind the small x copies (L2-resident after the first CTA),
  // so the prologue below runs while the weights are in flight
  GemvBatch b0, b1;  // two batches: one in flight while the other is used
  auto step_at = [&](int st, int& n0, int& ch0) {
    const int gi = st / nb;
    n0 = ((int)blockIdx.x + gi * (int)gridDim.x) * kGemvRows;
    ch0 = cb + (st - gi * nb) * kGemvBatch;
  };
  auto load_step = [&](GemvBatch& b, int st) {
    if (st < nsteps) {
      int n0, ch0;
      step_at(st, n0, ch0);
      gemv_load<V>(b, a, n0 + g, c, ch0, ce);
    }
  };
  load_step(b0, 0);
  if constexpr (V == kFull) {
    // norm_w of this thread's first kNormVecs 8-wide vectors k = 8 (tid + j * threads), loaded
    // while x lands and the sums of squares run
    float4 nwr[kNormVecs][2];
    if (a.norm_w != nullptr) {
#pragma unroll
      for (int j = 0; j < kNormVecs; ++j) {
        const int k = 8 * (tid + j * kGemvThreads);
        if (k < K) {
          nwr[j][0] = __ldg(reinterpret_cast<const float4*>(a.norm_w + k));
          nwr[j][1] = __ldg(reinterpret_cast<const float4*>(a.norm_w + k) + 1);
        }
      }
    }

    cp_async_wait<0>();
    __syncthreads();

    if (a.norm_w != nullptr) {
      // each row's sum of squares: 8 values a thread and vector, vectors strided over the threads,
      // then the warps' sums in warp order (the same order for every T)
      float ss[kMaxRows];
#pragma unroll
      for (int t = 0; t < kMaxRows; ++t) ss[t] = 0.f;
      for (int k = tid * 8; k < K; k += kGemvThreads * 8) {
#pragma unroll
        for (int t = 0; t < kMaxRows; ++t) {
          if (t < T) {
            const uint4 v = *reinterpret_cast<const uint4*>(xs + t * xs_stride + k);
            const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 f = __bfloat1622float2(h[j]);
              ss[t] = fmaf(f.x, f.x, ss[t]);
              ss[t] = fmaf(f.y, f.y, ss[t]);
            }
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kMaxRows; ++t) {
        if (t < T) {  // uniform: rows past T skip their shuffles
          float v = ss[t];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
          if (lane == 0) nred[warp][t] = v;
        }
      }
      __syncthreads();
      float rs[kMaxRows];  // every thread sums the warps' partials in warp order: the same scale
#pragma unroll
      for (int t = 0; t < kMaxRows; ++t) {
        if (t < T) {
          float total = 0.f;
          for (int w = 0; w < kGemvWarps; ++w) total += nred[w][t];
          rs[t] = 1.0f / sqrtf(total / (float)K + a.eps);
        }
      }
      // normalise in place: vector k of every row, with its norm_w in registers
      for (int j = 0, k = tid * 8; k < K; ++j, k += kGemvThreads * 8) {
        float wk[8];
        float4 w0, w1;
        if (j < kNormVecs) {
#pragma unroll
          for (int jj = 0; jj < kNormVecs; ++jj) {  // static indexing of the prefetched vectors
            if (jj == j) {
              w0 = nwr[jj][0];
              w1 = nwr[jj][1];
            }
          }
        } else {
          w0 = __ldg(reinterpret_cast<const float4*>(a.norm_w + k));
          w1 = __ldg(reinterpret_cast<const float4*>(a.norm_w + k) + 1);
        }
        wk[0] = w0.x; wk[1] = w0.y; wk[2] = w0.z; wk[3] = w0.w;
        wk[4] = w1.x; wk[5] = w1.y; wk[6] = w1.z; wk[7] = w1.w;
#pragma unroll
        for (int t = 0; t < kMaxRows; ++t) {
          if (t < T) {
            uint4* p = reinterpret_cast<uint4*>(xs + t * xs_stride + k);
            uint4 v = *p;
            __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(h[e]);
              h[e] = __floats2bfloat162_rn(f.x * rs[t] * wk[2 * e], f.y * rs[t] * wk[2 * e + 1]);
            }
            *p = v;
          }
        }
      }
      __syncthreads();
    }
  } else {
    cp_async_wait<0>();
    __syncthreads();
  }

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  uint32_t junk = 0u;  // kNoScale and kLoad: every loaded word they do not multiply
  int buf = 0;
  // after a group's last batch: the warps' partials summed in warp order, then the epilogue
  auto finish = [&](int st) {
    if ((st + 1) % nb != 0) return;
    int n0, ch0;
    step_at(st, n0, ch0);
    if constexpr (V == kNoScale || V == kLoad) acc[0] += (float)junk * a.zero;
    *reinterpret_cast<float2*>(&red[buf][warp][g][2 * c]) = make_float2(acc[0], acc[1]);
    acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
    __syncthreads();
    if (tid < kGemvRows * kGemvRows) {
      const int t = tid >> 3;
      const int n = n0 + (tid & 7);
      if (t < T && n < N) {
        float v = red[buf][0][t][tid & 7];
#pragma unroll
        for (int w = 1; w < kGemvWarps; ++w) v += red[buf][w][t][tid & 7];
        if constexpr (V == kFull) {
          if (a.residual != nullptr) v = bf16_round(__bfloat162float(a.residual[(size_t)t * N + n]) + bf16_round(v));
        }
        if constexpr (V == kLoad) v = load_touch(a, row0 + t, n) + v;
        a.y[(size_t)t * N + n] = v;
      }
    }
    buf ^= 1;  // the next group writes the other buffer; this one is read before the next barrier
  };

  auto run_step = [&](const GemvBatch& b, int st) {
    int n0, ch0;
    step_at(st, n0, ch0);
    gemv_compute<V>(b, acc, junk, a, n0 + g, xs, xs_stride, T, g, c, ch0, ce);
    finish(st);
  };
  for (int st = 0; st < nsteps; st += 2) {
    load_step(b1, st + 1);
    run_step(b0, st);
    if (st + 1 >= nsteps) break;
    load_step(b0, st + 2);
    run_step(b1, st + 1);
  }
}

size_t gemv_smem_bytes(int T, int K) {
  const int kpad = (K + kChunk - 1) / kChunk * kChunk;
  return (size_t)T * (kpad + 8) * sizeof(__nv_bfloat16);
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

template <int V>
cudaError_t launch_gemv(const GemvArgs& a, cudaStream_t stream, int num_sms) {
  const int rows = a.T < kMaxRows ? a.T : kMaxRows;  // a CTA's rows (kFull: T <= 8)
  const size_t smem = gemv_smem_bytes(rows, a.K);
  // the static arrays count against the same limit as the dynamic buffer
  const size_t static_smem = sizeof(float) * (2 * kGemvWarps * kGemvRows * kGemvRows + kGemvWarps * kMaxRows);
  if (smem + static_smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(q8_gemv_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int ngroups = (a.N + kGemvRows - 1) / kGemvRows;
  // with the norm prologue every CTA stages and normalises x again: fewer CTAs, more row groups
  // each (measured on the decode shapes; the sum order does not depend on the grid)
  int blocks = num_sms * (a.norm_w != nullptr ? kGemvCtasPerSm / 2 : kGemvCtasPerSm);
  if (blocks > ngroups) blocks = ngroups;
  const dim3 grid(blocks, (a.T + kMaxRows - 1) / kMaxRows);
  q8_gemv_kernel<V><<<grid, kGemvThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
