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
//                                                        added in j order, in f32, by one thread
// That is the TPU kernel's order (o = x + partial_0, o += partial_j) at a tile of 32 columns.
//
// What bounds it on the H100: bytes. At Qwen3-ASR 0.6B widths (D = 1024, F = 3072) one call
// reads 9.44 MB of int8 quants and 0.59 MB of bf16 scales and does 2 flops a weight byte a
// row: about 3 us at 3.35 TB/s, at T = 1 and T = 8 alike (1.7B widths, D = 2048, F = 6144:
// 4x the bytes, about 12 us).
//
// The design: one cooperative launch of one CTA an SM (12 warps), two stages, a grid barrier.
//   - prologue: x staged into shared memory with cp.async and normalised in place (the rms-norm
//     recomputed a CTA, as the TPU kernel does a program); each warp's first gate/up quants are
//     already in flight behind the x copies. Once x has landed, each
//     CTA starts cp.async copies of the down rows it will contract in stage 2 (groups of 8 rows
//     d = 8 * (blockIdx.x + i * gridDim.x) + r) into its own shared memory: at 0.6B one group
//     (24 KB of quants, 1.5 KB of scales), at 1.7B two (~101 KB). So the whole weight set is in
//     flight during stage 1, stage 2 reads no global weight byte, and stage 2's DRAM time hides
//     behind stage 1's (the copies go after x, which every CTA waits on, not before it);
//   - stage 1 on the tensor cores, with q8_matmul.cu's GEMV k map: a CTA holds three slots of
//     four warps; a slot owns a group of 8 columns f (8 gate rows and the matching 8 up rows,
//     mma's n) and splits D over its warps; A = h (the T rows zero-padded to 16), B = the weight
//     rows dequantised in registers, a lane taking 16 contiguous quants in one 16-byte load. T = 1
//     runs T = 8's instructions. The four warps' partials are summed in warp order, then
//     bf16(silu(g) * u) goes to global memory, group-major ([F/8][T rounded up to even][8]), so
//     that every 32-byte sector is written whole by one CTA. Each lane keeps two batches of four
//     chunks of gate and up in registers, one in flight while the other is used;
//   - the grid barrier: thread 0 of every CTA (after the block barrier and a __threadfence())
//     takes a ticket from an arrival count that grows across launches and waits until the count
//     reaches the end of its launch's tickets, which the last arrival makes it: no release step.
//     The cooperative launch guarantees every CTA is resident. 132 arrivals, not 384;
//   - stage 2 on the tensor cores: for each of its down groups and each 32-column Q8 block j, a
//     warp forms p_j = inner[:, 32j:32j+32] . w^T with two mma steps from a fresh accumulator (a
//     lane takes 8 contiguous quants of its row from shared memory and its 16-byte fragment of
//     inner straight from L2, all of a chunk's fragments in flight together, the next chunk's
//     during this one); the p_j go to shared memory, and one thread an output adds them to
//     float(x[t, d]) in j order. Deterministic: no float atomics, every sum in a fixed order, the
//     same for every T, so row t of a T = 8 call equals the T = 1 call on that row bitwise.
// fused_gateup_silu is stage 1 alone (no norm, no down copies, no barrier; inner row-major [T, F]),
// an ordinary launch. The kernel takes F a multiple of 64 (the scale rows of the down weights are
// copied 4 bytes at a time) and a CTA's down rows within shared memory (1.7B widths at T = 8 use
// 159 KB of the 227).
// What holds it above its bound (PERF.md): at these sizes a call is a chain of latencies (x, the
// norm, the first weight bytes, the barrier, inner from L2), not the weight stream. Capturing the
// decode step in a CUDA graph is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

#include "attention_common.cuh"

namespace {

constexpr int kBlock = 32;                    // Q8_0 block length
constexpr int kChunk = 64;                    // stage 1: D a chunk (two Q8 blocks, four mma k-steps)
constexpr int kSlots = 3;                     // stage 1: column groups a CTA works on at once
constexpr int kSlotWarps = 4;                 // warps a slot = stage 1's splits of D
constexpr int kWarps = kSlots * kSlotWarps;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 8;                      // columns (weight rows) a group: mma's n
constexpr int kBatch = 4;                     // chunks a lane holds in registers a batch
constexpr int kMaxRows = 8;
constexpr int kUnits = 8;                     // stage 2: (block, row group) units a warp a chunk
// shared memory region C: stage 1's warp partials [2][kSlots][kSlotWarps][gate, up][8][8], then
// stage 2's block partials of a chunk [blocks][T][rows]: kWarps * kUnits units of 8 rows and T <= 8
constexpr size_t kRegionC = sizeof(float) * kWarps * kUnits * kCols * kMaxRows;
static_assert(sizeof(float) * 2 * kSlots * kSlotWarps * 2 * kCols * kCols <= kRegionC, "warp partials fit");

struct Args {
  const __nv_bfloat16* x;     // [T, D]: the FFN input (full) or h
  const float* norm_w;        // [D] (full)
  const int8_t* gu_q;         // [2F, D]
  const __nv_bfloat16* gu_s;  // [2F, D/32]
  const int8_t* dn_q;         // [D, F] (full)
  const __nv_bfloat16* dn_s;  // [D, F/32] (full)
  __nv_bfloat16* inner;       // [T, F]
  float* y;                   // [T, D] (full)
  unsigned int* barrier;      // [1]: the grid barrier's arrival count (full)
  int D, F;
  int groups;                 // down row groups a CTA holds at most (full)
  float eps;
};

__host__ __device__ __forceinline__ int chunks_of(int D) { return (D + kChunk - 1) / kChunk; }
__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Region A: h [T][64 * chunks + 8] bf16.
template <int T>
__host__ __device__ __forceinline__ size_t region_a(int D) {
  return align16((size_t)T * (chunks_of(D) * kChunk + 8) * 2);
}

// Region B (full): the CTA's down quants [8 * groups][F + 32] int8, then scales [8 * groups][F/32].
__host__ __device__ __forceinline__ size_t region_b(int F, int groups) {
  const size_t rows = (size_t)groups * kCols;
  return align16(rows * (F + 32) + rows * (F / kBlock) * 2);
}

struct Batch {
  int4 g[kBatch], u[kBatch];
  float sg[kBatch], su[kBatch];
};

// Lane (g, c)'s quants of gate row f and up row F + f for chunks ch0 .. ch0 + kBatch - 1 (those
// below ce): k = 64 ch + 16c .. +15, and the scales of their Q8 blocks.
__device__ __forceinline__ void load_batch(Batch& b, const Args& a, int f, int c, int ch0, int ce) {
  const int kb = a.D / kBlock;
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int ch = ch0 + u;
    const int k = ch * kChunk + 16 * c;
    if (ch < ce && k < a.D) {
      b.g[u] = ldg_stream(a.gu_q + (size_t)f * a.D + k);
      b.u[u] = ldg_stream(a.gu_q + (size_t)(a.F + f) * a.D + k);
      b.sg[u] = __bfloat162float(a.gu_s[(size_t)f * kb + (k >> 5)]);
      b.su[u] = __bfloat162float(a.gu_s[(size_t)(a.F + f) * kb + (k >> 5)]);
    } else {
      b.g[u] = b.u[u] = make_int4(0, 0, 0, 0);
      b.sg[u] = b.su[u] = 0.f;
    }
  }
}

template <int T>
__device__ __forceinline__ void compute_batch(const Batch& b, float (&ag)[4], float (&au)[4],
                                              const __nv_bfloat16* hs, int hstride, int g, int c, int ch0, int ce) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int ch = ch0 + u;
    if (ch < ce) {  // warp-uniform
      uint32_t wg[8], wu[8];
      dequant16(b.g[u], b.sg[u], wg);
      dequant16(b.u[u], b.su[u], wu);
      uint32_t xa[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
      if (g < T) {
        const uint4* p = reinterpret_cast<const uint4*>(hs + (size_t)g * hstride + ch * kChunk + 16 * c);
        const uint4 lo = p[0], hi = p[1];
        xa[0] = lo.x; xa[1] = lo.y; xa[2] = lo.z; xa[3] = lo.w;
        xa[4] = hi.x; xa[5] = hi.y; xa[6] = hi.z; xa[7] = hi.w;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const uint32_t af[4] = {xa[2 * t], 0u, xa[2 * t + 1], 0u};  // rows 8..15 of A are zero
        mma_bf16(ag, af, wg[2 * t], wg[2 * t + 1]);
        mma_bf16(au, af, wu[2 * t], wu[2 * t + 1]);
      }
    }
  }
}

__device__ __forceinline__ void slot_barrier(int slot) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + slot), "r"(kSlotWarps * 32));
}

// kFull: the whole FFN half (down copies, norm prologue, stage 1, barrier, stage 2).
// Otherwise stage 1 alone on an already normalised h.
template <int T, bool kFull>
__global__ void __launch_bounds__(kThreads, 1) fused_ffn_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float nred[kWarps][kMaxRows];
  const int D = a.D, F = a.F;
  const int nch = chunks_of(D);
  const int hstride = nch * kChunk + 8;  // 16 bytes of padding: conflict-free 16-byte reads of 8 rows
  const int qstride = F + 32;            // 8-byte reads of 8 rows at an odd multiple of 32 bytes apart
  const int nb = F / kBlock;
  const int R = a.groups * kCols;
  float* red = reinterpret_cast<float*>(smem_raw);
  float* part = red;
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem_raw + kRegionC);
  int8_t* dq = reinterpret_cast<int8_t*>(smem_raw + kRegionC + region_a<T>(D));
  __nv_bfloat16* ds = reinterpret_cast<__nv_bfloat16*>(dq + (size_t)R * qstride);

  // the full kernel keeps inner group-major, [F / 8][T rounded up to even][8]: a group's columns
  // fill whole 32-byte sectors, so no sector is written piecewise by two SMs (a partly written
  // sector that L2 no longer holds is read back from DRAM)
  constexpr int kInnerRows = T + (T & 1);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int ngd = D / kCols;  // down row groups
  const int my_groups = kFull && ngd > (int)blockIdx.x ? (ngd - (int)blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  auto down_row = [&](int row) { return ((int)blockIdx.x + (row / kCols) * (int)gridDim.x) * kCols + row % kCols; };

  // -- x into shared memory ----------------------------------------------------------------
  {
    const int per_row = nch * kChunk / 8;  // 16-byte vectors a staged row
    for (int i = tid; i < T * per_row; i += kThreads) {
      const int t = i / per_row;
      const int k = (i - t * per_row) * 8;
      __nv_bfloat16* dst = hs + t * hstride + k;
      if (k < D) {
        cp_async16(dst, a.x + (size_t)t * D + k, 16);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  }

  // -- stage 1's schedule; its first batch goes out before the prologue -------------------
  const int slot = warp / kSlotWarps;
  const int sw = warp - slot * kSlotWarps;
  int cb, ce;
  split_range(nch, kSlotWarps, sw, cb, ce);
  const int nbat = ((nch + kSlotWarps - 1) / kSlotWarps + kBatch - 1) / kBatch;  // batches a group
  const int ngroups = F / kCols;
  const int nslots = gridDim.x * kSlots;
  const int gslot = blockIdx.x * kSlots + slot;
  const int mine = ngroups > gslot ? (ngroups - gslot + nslots - 1) / nslots : 0;
  const int nsteps = mine * nbat;
  auto step_at = [&](int st, int& f0, int& ch0) {
    const int gi = st / nbat;
    f0 = (gslot + gi * nslots) * kCols;
    ch0 = cb + (st - gi * nbat) * kBatch;
  };
  Batch b0, b1;
  auto load_step = [&](Batch& b, int st) {
    if (st < nsteps) {
      int f0, ch0;
      step_at(st, f0, ch0);
      load_batch(b, a, f0 + g, c, ch0, ce);
    }
  };
  load_step(b0, 0);

  cp_async_wait<0>();  // x has landed
  __syncthreads();
  if (kFull) {
    // this CTA's down rows: behind x, which every CTA waits on, and ahead of stage 1's compute
    const int qv = F / 16;  // 16-byte pieces of a quant row
    for (int i = tid; i < my_groups * kCols * qv; i += kThreads) {
      const int row = i / qv, p = i - row * qv;
      cp_async16(dq + (size_t)row * qstride + p * 16, a.dn_q + (size_t)down_row(row) * F + p * 16, 16);
    }
    const int sv = nb / 2;  // 4-byte pieces of a scale row
    for (int i = tid; i < my_groups * kCols * sv; i += kThreads) {
      const int row = i / sv, p = i - row * sv;
      cp_async4(ds + (size_t)row * nb + p * 2, a.dn_s + (size_t)down_row(row) * nb + p * 2);
    }
    cp_async_commit();
  }

  if (kFull) {
    // each row's sum of squares: 8 values a thread and vector, vectors strided over the threads,
    // then the warps' sums in warp order (the same order for every T)
    float ss[kMaxRows];
#pragma unroll
    for (int t = 0; t < kMaxRows; ++t) ss[t] = 0.f;
    for (int k = tid * 8; k < D; k += kThreads * 8) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const uint4 v = *reinterpret_cast<const uint4*>(hs + t * hstride + k);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h2[j]);
          ss[t] = fmaf(f.x, f.x, ss[t]);
          ss[t] = fmaf(f.y, f.y, ss[t]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float v = ss[t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) nred[warp][t] = v;
    }
    __syncthreads();
    float rs[kMaxRows];  // every thread sums the warps' partials in warp order: the same scale
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float total = 0.f;
      for (int w = 0; w < kWarps; ++w) total += nred[w][t];
      rs[t] = 1.0f / sqrtf(total / (float)D + a.eps);
    }
    for (int k = tid * 8; k < D; k += kThreads * 8) {
      const float4 w0 = __ldg(reinterpret_cast<const float4*>(a.norm_w + k));
      const float4 w1 = __ldg(reinterpret_cast<const float4*>(a.norm_w + k) + 1);
      const float wk[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int t = 0; t < T; ++t) {
        uint4* p = reinterpret_cast<uint4*>(hs + t * hstride + k);
        uint4 v = *p;
        __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          h2[e] = __floats2bfloat162_rn(f.x * rs[t] * wk[2 * e], f.y * rs[t] * wk[2 * e + 1]);
        }
        *p = v;
      }
    }
    __syncthreads();
  }

  // -- stage 1: inner[:, f0 .. f0 + 7] = bf16(silu(gate . h) * (up . h)), a slot a group ---
  {
    float ag[4] = {0.f, 0.f, 0.f, 0.f}, au[4] = {0.f, 0.f, 0.f, 0.f};
    int buf = 0;
    auto finish = [&](int st) {
      if ((st + 1) % nbat != 0) return;
      int f0, ch0;
      step_at(st, f0, ch0);
      float* r = red + ((buf * kSlots + slot) * kSlotWarps) * 2 * kCols * kCols;  // [kSlotWarps][2][8][8]
      *reinterpret_cast<float2*>(r + (sw * 2 + 0) * kCols * kCols + g * kCols + 2 * c) = make_float2(ag[0], ag[1]);
      *reinterpret_cast<float2*>(r + (sw * 2 + 1) * kCols * kCols + g * kCols + 2 * c) = make_float2(au[0], au[1]);
      ag[0] = ag[1] = ag[2] = ag[3] = 0.f;
      au[0] = au[1] = au[2] = au[3] = 0.f;
      slot_barrier(slot);
      const int ts = tid - slot * kSlotWarps * 32;
      if (ts < kCols * kCols) {
        const int t = ts / kCols, n = ts % kCols;
        if (t < T) {
          float gs = r[t * kCols + n], us = r[kCols * kCols + t * kCols + n];
#pragma unroll
          for (int w = 1; w < kSlotWarps; ++w) {
            gs += r[(w * 2) * kCols * kCols + t * kCols + n];
            us += r[(w * 2 + 1) * kCols * kCols + t * kCols + n];
          }
          const __nv_bfloat16 v = __float2bfloat16_rn(gs * (1.0f / (1.0f + expf(-gs))) * us);
          if (kFull) {
            a.inner[((size_t)(f0 / kCols) * kInnerRows + t) * kCols + n] = v;
          } else {
            a.inner[(size_t)t * F + f0 + n] = v;
          }
        } else if (kFull && t < kInnerRows) {
          a.inner[((size_t)(f0 / kCols) * kInnerRows + t) * kCols + n] = __float2bfloat16_rn(0.f);
        }
      }
      buf ^= 1;  // the next group writes the other buffer; this one is read before its barrier
    };
    auto run_step = [&](const Batch& b, int st) {
      int f0, ch0;
      step_at(st, f0, ch0);
      compute_batch<T>(b, ag, au, hs, hstride, g, c, ch0, ce);
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
  if (!kFull) return;

  // -- grid barrier: every column of inner is written --------------------------------
  // (the CTA's writes are ordered by the block barrier, then published by thread 0's fence)
  __syncthreads();
  if (tid == 0) {
    // the arrivals count up across launches: this launch's are tickets E * grid .. E * grid +
    // grid - 1, and every CTA waits for the count to reach (E + 1) * grid, which the last arrival
    // makes it (no release step; the wrapper zeroes the count before it could wrap)
    __threadfence();
    const unsigned int ticket = atomicAdd(a.barrier, 1u);
    const unsigned int target = (ticket / gridDim.x + 1) * gridDim.x;
    volatile unsigned int* count = a.barrier;
    while (*count < target) {
    }
    __threadfence();
  }
  __syncthreads();
  if (my_groups == 0) return;  // no down row for this CTA

  // -- stage 2: y[t, d] = x[t, d] + sum_j p_j over this CTA's down rows -------------------
  // Units (block j, row group gi) in chunks of kWarps * kUnits, kUnits a warp: each lane loads its
  // units' inner fragments straight from L2 (ld.cg: coherent after the fence), all in flight
  // together, and contracts them with the down rows resident in shared memory. The partials of
  // a chunk's blocks go through shared memory to one thread an output, which adds them in j order.
  cp_async_wait<0>();  // the down rows (this thread's copies; the block barrier below publishes all)
  __syncthreads();
  const int rows = my_groups * kCols;
  const bool summer = tid < T * rows;  // one thread an output (t, d)
  const int st_t = summer ? tid / rows : 0;
  const int st_r = summer ? tid - st_t * rows : 0;
  const int st_d = down_row(st_r);
  float o = summer ? __bfloat162float(a.x[(size_t)st_t * D + st_d]) : 0.f;
  const int jc = kWarps * kUnits / my_groups;  // blocks a chunk
  // this lane's inner fragments of the chunk at j0 (zero past the chunk's units or rows)
  auto load_inner = [&](uint4 (&xv)[kUnits], int j0) {
    const int n = min(jc, nb - j0) * my_groups;
#pragma unroll
    for (int i = 0; i < kUnits; ++i) {
      const int u = warp + i * kWarps;
      xv[i] = make_uint4(0u, 0u, 0u, 0u);
      if (u < n && g < T) {
        const int j = j0 + u / my_groups;
        xv[i] = __ldcg(reinterpret_cast<const uint4*>(a.inner + ((size_t)(j * 4 + c) * kInnerRows + g) * kCols));
      }
    }
  };
  uint4 xv[kUnits], xn[kUnits];
  load_inner(xv, 0);
  for (int j0 = 0; j0 < nb; j0 += jc) {
    const int jn = min(jc, nb - j0);
    const int n = jn * my_groups;
    if (j0 + jc < nb) load_inner(xn, j0 + jc);  // the next chunk's, in flight during this one
#pragma unroll
    for (int i = 0; i < kUnits; ++i) {
      const int u = warp + i * kWarps;
      if (u < n) {  // warp-uniform
        const int jj = u / my_groups, gi = u - jj * my_groups;
        const int j = j0 + jj;
        const int row = gi * kCols + g;
        uint32_t w[4];
        dequant8(*reinterpret_cast<const uint2*>(dq + (size_t)row * qstride + j * kBlock + 8 * c),
                 __bfloat162float(ds[(size_t)row * nb + j]), w);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        const uint32_t a0[4] = {xv[i].x, 0u, xv[i].y, 0u};  // k = 8c .. 8c + 3 of the block
        const uint32_t a1[4] = {xv[i].z, 0u, xv[i].w, 0u};  // k = 8c + 4 .. 8c + 7
        mma_bf16(acc, a0, w[0], w[1]);
        mma_bf16(acc, a1, w[2], w[3]);
        if (g < T) {
          *reinterpret_cast<float2*>(part + ((size_t)jj * T + g) * rows + gi * kCols + 2 * c) =
              make_float2(acc[0], acc[1]);
        }
      }
    }
    __syncthreads();
    if (summer) {
#pragma unroll 8
      for (int jj = 0; jj < jn; ++jj) o += part[((size_t)jj * T + st_t) * rows + st_r];  // in j order
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kUnits; ++i) xv[i] = xn[i];
  }
  if (summer) a.y[(size_t)st_t * D + st_d] = o;
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
// too) and, for the cooperative launch, that one CTA fits an SM at that size.
template <int T, bool kFull>
cudaError_t configure(size_t smem) {
  static std::mutex mu;
  static size_t done_smem = 0;
  std::lock_guard<std::mutex> lock(mu);
  if (done_smem == smem) return cudaSuccess;
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
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (n < 1) return cudaErrorInvalidConfiguration;
  done_smem = smem;
  return cudaSuccess;
}

template <int T>
cudaError_t launch_full(Args a, cudaStream_t stream) {
  const int blocks = num_sms();  // one CTA an SM
  a.groups = (a.D / kCols + blocks - 1) / blocks;
  if (T * a.groups * kCols > kThreads) return cudaErrorInvalidValue;  // one thread an output of stage 2
  const size_t smem = kRegionC + region_a<T>(a.D) + region_b(a.F, a.groups);
  cudaError_t err = configure<T, true>(smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel((const void*)fused_ffn_kernel<T, true>, dim3(blocks), dim3(kThreads), args,
                                     smem, stream);
}

template <int T>
cudaError_t launch_gateup(Args a, cudaStream_t stream) {
  a.groups = 0;
  const size_t smem = kRegionC + region_a<T>(a.D);
  cudaError_t err = configure<T, false>(smem);
  if (err != cudaSuccess) return err;
  fused_ffn_kernel<T, false><<<num_sms(), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool shape_ok(int T, int D, int F) {
  return T >= 1 && T <= kMaxRows && D > 0 && F > 0 && D % kBlock == 0 && F % kBlock == 0;
}

}  // namespace

// Returns a cudaError_t (0 on success). inner (bf16, 2 * ((T + 1) / 2) * F values) is scratch;
// barrier (uint32 [1]) counts grid-barrier arrivals and grows by the grid (the SM count) each
// launch, so the caller zeroes it before the first launch and again before it could
// pass 2^31; launches sharing it are serialised by their stream. F must be a multiple of 64.
extern "C" int lwt_fused_ffn_step(const void* x, const void* norm_w, const void* gu_q, const void* gu_s,
                                  const void* dn_q, const void* dn_s, void* inner, void* y, void* barrier, int T,
                                  int D, int F, float eps, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(T, D, F) || F % (2 * kBlock) != 0) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(norm_w),
               static_cast<const int8_t*>(gu_q), static_cast<const __nv_bfloat16*>(gu_s),
               static_cast<const int8_t*>(dn_q), static_cast<const __nv_bfloat16*>(dn_s),
               static_cast<__nv_bfloat16*>(inner), static_cast<float*>(y), static_cast<unsigned int*>(barrier),
               D, F, 0, eps};
  switch (T) {
#define LWT_CASE(n) \
  case n: return (int)launch_full<n>(a, stream);
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
  const Args a{static_cast<const __nv_bfloat16*>(h), nullptr, static_cast<const int8_t*>(gu_q),
               static_cast<const __nv_bfloat16*>(gu_s), nullptr, nullptr, static_cast<__nv_bfloat16*>(inner),
               nullptr, nullptr, D, F, 0, 0.f};
  switch (T) {
#define LWT_CASE(n) \
  case n: return (int)launch_gateup<n>(a, stream);
    LWT_CASE(1) LWT_CASE(2) LWT_CASE(3) LWT_CASE(4) LWT_CASE(5) LWT_CASE(6) LWT_CASE(7) LWT_CASE(8)
#undef LWT_CASE
  }
  return (int)cudaErrorInvalidValue;
}
