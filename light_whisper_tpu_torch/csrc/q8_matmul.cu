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
// Numerics (shared with the plain PyTorch versions in ops/q8_matmul.py):
//   w   = bf16(float(q) * float(s))            dequantised weight, rounded to bf16 (RNE)
//   acc = sum_k float(x_bf16) * float(w)       bf16 products on the tensor cores, f32 accumulation
//   norm prologue:  x = bf16(float(x) * rsqrt(mean(x^2) + eps) * norm_w)
//   residual epilogue: y = float(bf16(float(res_bf16) + float(bf16(acc))))
//   output f32.
// K runs in chunks of 64 (two Q8 blocks). A call's chunks are cut into S contiguous splits
// (split r takes chunks [r*nk/S, (r+1)*nk/S)); each split's partial runs through the chunks in
// order, and the partials are summed in rank order, with no float atomics. S is a function of
// (N, K) alone, never of T: the batched prefill sends B*T rows through the same kernels that a
// single stream sends T rows through, and each output row must come out bitwise the same.
// ops/q8_matmul.q8_matmul_split_plain is this schedule in torch.
//
// What bounds it on the H100: decode (T <= 8) is a weight stream: one 0.6B decode step reads
// ~0.6 GB of int8 quants plus 1/16 of that in bf16 scales at 2*T FLOPs a weight byte, far below
// the ~295 FLOP/byte ridge. Prefill and the encoder (T = 64..6,656) do T times more work a
// weight byte: at a few thousand rows they are bound by the tensor cores.
//
// The mma.sync m16n8k16 k order used by both kernels. The instruction gives lane (g = lane/4,
// c = lane%4) the k pairs {2c, 2c+1} and {2c+8, 2c+9} of each 16-deep step, in A and in B. Here
// both operands are fed so that lane c's four steps of a 64-wide chunk take the chunk's
// k = 16c .. 16c+15 in order (step t: 16c+4t+{0,1} and 16c+4t+{2,3}). A and B follow the same
// map, so each product pairs the right x with the right weight; a lane reads 16 contiguous
// quants (one 16-byte load) and 16 contiguous bf16 of x (two 16-byte loads) a chunk.
//
//   T <= 8: q8_gemv_kernel<kFull>, whose body is in q8_gemv.cuh (the probes of q8_probe.cu
//           instantiate the same body). A CTA of 4 warps owns 8 weight rows at a time (mma's
//           n = 8) and splits K over its warps (S = 4, every T). A = x (the T rows, zero-padded
//           to 16), B = the 8 rows dequantised in registers. T = 1 runs the same instructions
//           as T = 8 with zero rows, so each output sums in one order for every T. Each warp
//           issues its first quants and scales right behind the x prologue's copies and keeps
//           two batches of 4 chunks (64 bytes a lane each) in registers, one in flight while
//           the other is used; CTAs stride over row groups.
//   T > 8:  q8_tile_kernel. A 64x128 output tile per CTA (4 warps of 64x32), K in chunks of
//           64 streamed by cp.async through a ring of 4 stages of x, quants and scales; the
//           quants are dequantised to bf16 in registers right before the mma. With S > 1 the
//           S CTAs of a tile form a thread-block cluster; each writes its f32 partial tile to
//           its shared memory and rank r sums its 1/S of the rows over all ranks in rank order
//           through distributed shared memory. With S = 1 y is stored from the accumulators.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

#include "q8_gemv.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// T > 8: pipelined tile kernel, K split over a cluster
// ---------------------------------------------------------------------------

constexpr int kTileM = 64;
constexpr int kStages = 4;
constexpr int kXStride = kChunk + 8;  // bf16 a row of the x tile: 144 bytes, conflict-free 16-byte reads
constexpr int kQStride = kChunk;      // int8 a row of the quant tile
constexpr int kMaxSplits = 8;         // portable cluster size
constexpr int kFillCtas = 96;         // CTAs of one row tile up to which the split doubles
constexpr int kMinSplitChunks = 4;    // at least 256 of K a split
constexpr int kTileWidth = 128;       // columns a tile of the shipped kernel (the sweep also runs 64 and 256)

// A tile of 64 rows by BN = 32 * W columns: W warps, each all 64 rows by 32 columns.
template <int W>
struct Tile {
  static constexpr int kN = 32 * W;
  static constexpr int kThreads = 32 * W;
  static constexpr int kPartStride = kN + 8;
  struct Stage {
    __nv_bfloat16 x[kTileM][kXStride];
    int8_t q[kN][kQStride];
    float sc[kN][2];
  };
  static constexpr size_t kSmem = sizeof(Stage) * kStages;
  static_assert(sizeof(float) * kTileM * kPartStride <= kSmem, "the partial tile reuses the ring");
  static_assert(kStages == 4, "the scales are stored two steps after their load, one before their use");
};

// The tile kernel's split count: a function of (N, K) only. It doubles while one row tile's CTAs
// stay within kFillCtas and every split keeps kMinSplitChunks chunks (exp_q8_split_sweep: at
// 64-192 rows the narrow outputs want 8 splits and the wide ones 2-4; at thousands of rows every
// split costs time, so the wide outputs, whose row tile already fills the card, stop at 2).
int tile_splits(int N, int K) {
  const int ntiles = (N + kTileWidth - 1) / kTileWidth;
  const int nch = (K + kChunk - 1) / kChunk;
  int s = 1;
  while (s < kMaxSplits && ntiles * 2 * s <= kFillCtas && nch / (2 * s) >= kMinSplitChunks) s *= 2;
  return s;
}

struct TileArgs {
  const __nv_bfloat16* x;  // [T, K]
  const int8_t* q;         // [N, K]
  const __nv_bfloat16* s;  // [N, K/32]
  float* y;                // [T, N]
  int T, N, K, splits;
};

// Each dequantised weight feeds four 16-row mma tiles, and each 16-byte read of x four 8-column ones.
// Three CTAs an SM at width 128 (<= 168 registers): the chunk loop is latency-bound at two.
template <int W>
__global__ void __launch_bounds__(Tile<W>::kThreads, W == 4 ? 3 : W < 8 ? 8 / W : 1) q8_tile_kernel(TileArgs a) {
  using Stage = typename Tile<W>::Stage;
  constexpr int kN = Tile<W>::kN;
  constexpr int kThreads = Tile<W>::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage* ring = reinterpret_cast<Stage*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wn = tid >> 5;  // the warp's 32 columns
  const int g = lane >> 2;
  const int c = lane & 3;
  const int T = a.T, N = a.N, K = a.K, S = a.splits;
  const int rank = (int)blockIdx.x % S;
  const int n0 = ((int)blockIdx.x / S) * kN;
  const int m0 = (int)blockIdx.y * kTileM;
  const int kb = K / kBlock;
  const int nch = (K + kChunk - 1) / kChunk;
  int kbeg, kend;
  split_range(nch, S, rank, kbeg, kend);
  const int nt = kend - kbeg;

  // this thread's scales of each chunk: row tid of the tile, both Q8 blocks
  auto scale_of = [&](int ch, int blk) -> float {
    const int n = n0 + tid;
    const int b = ch * 2 + blk;
    return (n < N && b < kb) ? __bfloat162float(a.s[(size_t)n * kb + b]) : 0.f;
  };
  auto issue = [&](int ch, Stage& st) {
    const int k0 = ch * kChunk;
#pragma unroll
    for (int i = 0; i < (kTileM * kChunk / 8) / kThreads; ++i) {  // x: 8 vectors of 16 bytes a row
      const int idx = tid + i * kThreads;
      const int r = idx >> 3;
      const int k = k0 + (idx & 7) * 8;
      const bool ok = m0 + r < T && k < K;
      cp_async16(&st.x[r][(idx & 7) * 8], ok ? a.x + (size_t)(m0 + r) * K + k : a.x, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < (kN * kChunk / 16) / kThreads; ++i) {  // quants: 4 vectors a row
      const int idx = tid + i * kThreads;
      const int r = idx >> 2;
      const int k = k0 + (idx & 3) * 16;
      const bool ok = n0 + r < N && k < K;
      cp_async16(&st.q[r][(idx & 3) * 16], ok ? a.q + (size_t)(n0 + r) * K + k : a.q, ok ? 16 : 0);
    }
  };

  // prologue: the first kStages - 1 chunks in flight, their scales stored directly
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < nt) {
      issue(kbeg + p, ring[p]);
      ring[p].sc[tid][0] = scale_of(kbeg + p, 0);
      ring[p].sc[tid][1] = scale_of(kbeg + p, 1);
    }
    cp_async_commit();
  }
  // the scales of chunk i + kStages - 1 are loaded at step i and stored at step i + 2 (two
  // chunks of compute hide the load); old holds step i - 1's, young step i's
  float old0 = 0.f, old1 = 0.f, young0 = 0.f, young1 = 0.f;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  for (int i = 0; i < nt; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk i have landed
    __syncthreads();               // everyone's have; everyone is done with chunk i - 1's stage
    if (i >= 2 && i + kStages - 3 < nt) {  // chunk i + 1, loaded at step i - 2
      ring[(i + kStages - 3) % kStages].sc[tid][0] = old0;
      ring[(i + kStages - 3) % kStages].sc[tid][1] = old1;
    }
    old0 = young0;
    old1 = young1;
    if (i + kStages - 1 < nt) {
      issue(kbeg + i + kStages - 1, ring[(i + kStages - 1) % kStages]);
      young0 = scale_of(kbeg + i + kStages - 1, 0);
      young1 = scale_of(kbeg + i + kStages - 1, 1);
    }
    cp_async_commit();

    const Stage& st = ring[i % kStages];
    uint32_t w[4][8];  // [8-column tile][k 16c .. 16c+15 as bf16 pairs]
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int r = wn * 32 + nj * 8 + g;
      dequant16(*reinterpret_cast<const int4*>(&st.q[r][16 * c]), st.sc[r][c >> 1], w[nj]);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      uint32_t xa[2][8];  // rows g and g + 8 of the 16-row tile, k 16c .. 16c+15 as bf16 pairs
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4* p = reinterpret_cast<const uint4*>(&st.x[mi * 16 + h * 8 + g][16 * c]);
        const uint4 lo = p[0], hi = p[1];
        xa[h][0] = lo.x; xa[h][1] = lo.y; xa[h][2] = lo.z; xa[h][3] = lo.w;
        xa[h][4] = hi.x; xa[h][5] = hi.y; xa[h][6] = hi.z; xa[h][7] = hi.w;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const uint32_t af[4] = {xa[0][2 * t], xa[1][2 * t], xa[0][2 * t + 1], xa[1][2 * t + 1]};
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma_bf16(acc[mi][nj], af, w[nj][2 * t], w[nj][2 * t + 1]);
      }
    }
  }

  if (S == 1) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + mi * 16 + h * 8 + g;
          const int n = n0 + wn * 32 + nj * 8 + 2 * c;
          if (m < T) {
            float* dst = a.y + (size_t)m * N + n;
            if (n + 1 < N && (N & 1) == 0) {
              *reinterpret_cast<float2*>(dst) = make_float2(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
            } else {
              if (n < N) dst[0] = acc[mi][nj][2 * h];
              if (n + 1 < N) dst[1] = acc[mi][nj][2 * h + 1];
            }
          }
        }
    return;
  }

  // S > 1: partial tiles through distributed shared memory, summed in rank order
  constexpr int kPart = Tile<W>::kPartStride;
  cg::cluster_group cluster = cg::this_cluster();
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the partial tile now
  float* part = reinterpret_cast<float*>(smem_raw);  // [kTileM][kPart]
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mi * 16 + h * 8 + g;
        *reinterpret_cast<float2*>(&part[r * kPart + wn * 32 + nj * 8 + 2 * c]) =
            make_float2(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
      }
  cluster.sync();  // every rank's partial is written
  int r0, r1;
  split_range(kTileM, S, rank, r0, r1);  // this rank's rows of the tile
  for (int idx = tid; idx < (r1 - r0) * (kN / 4); idx += kThreads) {
    const int r = r0 + idx / (kN / 4);
    const int col = (idx % (kN / 4)) * 4;
    float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, 0) + r * kPart + col);
    for (int p = 1; p < S; ++p) {
      const float4 u = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, p) + r * kPart + col);
      v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
    }
    const int m = m0 + r;
    if (m < T) {
      const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n0 + col + e < N) a.y[(size_t)m * N + n0 + col + e] = vals[e];
    }
  }
  cluster.sync();  // partners are done reading this CTA's shared memory
}

// The (width, cluster size) pairs the card was found to hold at least one cluster of
// (cudaOccupancyMaxActiveClusters), so that a launch asks once.
std::mutex g_fit_lock;
bool g_fits[3][kMaxSplits + 1] = {};  // [width 64, 128, 256][cluster size]
int g_fit_device = -1;

// With `resident` set, nothing is launched: *resident gets how many clusters of the call's
// split the card holds at once.
template <int W>
cudaError_t launch_tile(const TileArgs& a, cudaStream_t stream, int* resident) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(q8_tile_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile<W>::kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((a.N + Tile<W>::kN - 1) / Tile<W>::kN) * a.splits, (a.T + kTileM - 1) / kTileM, 1);
  cfg.blockDim = dim3(Tile<W>::kThreads);
  cfg.dynamicSmemBytes = Tile<W>::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (resident != nullptr) return cudaOccupancyMaxActiveClusters(resident, q8_tile_kernel<W>, &cfg);
  {
    std::lock_guard<std::mutex> hold(g_fit_lock);
    if (g_fit_device != device) {
      for (auto& row : g_fits)
        for (bool& f : row) f = false;
      g_fit_device = device;
    }
    constexpr int kw = W == 2 ? 0 : W == 4 ? 1 : 2;
    if (!g_fits[kw][a.splits]) {
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, q8_tile_kernel<W>, &cfg);
      if (err != cudaSuccess) return err;
      if (clusters < 1) return cudaErrorLaunchOutOfResources;  // refused, never shrunk
      g_fits[kw][a.splits] = true;
    }
  }
  err = cudaLaunchKernelEx(&cfg, q8_tile_kernel<W>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int q8_matmul_splits(const void* x, const void* q, const void* s, const void* norm_w, const void* residual, void* y,
                     int T, int N, int K, float eps, int splits, int width, void* stream_ptr, int* resident) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (T <= 0 || N <= 0 || K <= 0 || K % kBlock != 0) return (int)cudaErrorInvalidValue;
  if (T > kMaxRows || resident != nullptr) {
    if (norm_w != nullptr || residual != nullptr) return (int)cudaErrorInvalidValue;
    if (splits < 1 || splits > kMaxSplits || (splits & (splits - 1)) != 0) return (int)cudaErrorInvalidValue;
    TileArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
               static_cast<const __nv_bfloat16*>(s), static_cast<float*>(y), T, N, K, splits};
    if (width == 64) return (int)launch_tile<2>(a, stream, resident);
    if (width == 128) return (int)launch_tile<4>(a, stream, resident);
    if (width == 256) return (int)launch_tile<8>(a, stream, resident);
    return (int)cudaErrorInvalidValue;
  }
  GemvArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
             static_cast<const __nv_bfloat16*>(s), static_cast<const float*>(norm_w),
             static_cast<const __nv_bfloat16*>(residual), static_cast<float*>(y), T, N, K, eps, 0, 0.f};
  return (int)launch_gemv<kFull>(a, stream, num_sms());
}

}  // namespace

// Returns a cudaError_t (0 on success). q and s point at the layer's [N, K] / [N, K/32] block.
// norm_w (f32 [K]) and residual (bf16 [T, N]) are optional (null) and taken only at T <= 8.
extern "C" int lwt_q8_matmul(const void* x, const void* q, const void* s, const void* norm_w,
                             const void* residual, void* y, int T, int N, int K, float eps,
                             void* stream_ptr) {
  return q8_matmul_splits(x, q, s, norm_w, residual, y, T, N, K, eps, tile_splits(N, K), kTileWidth,
                          stream_ptr, nullptr);
}

// Launches nothing. *splits and *width get the tile kernel's split count (its cluster size) for
// (N, K) and its tile width, *clusters how many such clusters the card holds at once.
extern "C" int lwt_q8_tile_plan(int N, int K, int* splits, int* width, int* clusters) {
  if (N <= 0 || K <= 0 || K % kBlock != 0) return (int)cudaErrorInvalidValue;
  *splits = tile_splits(N, K);
  *width = kTileWidth;
  return q8_matmul_splits(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, kTileM + 1, N, K, 0.f, *splits,
                          *width, nullptr, clusters);
}

// The tile kernel (T > 8) at a given split count (1, 2, 4 or 8) and width (64, 128 or 256): the sweep
// behind tile_splits and kTileWidth.
extern "C" int lwt_q8_matmul_tile(const void* x, const void* q, const void* s, void* y, int T, int N, int K,
                                  int splits, int width, void* stream_ptr) {
  if (T <= kMaxRows) return (int)cudaErrorInvalidValue;
  return q8_matmul_splits(x, q, s, nullptr, nullptr, y, T, N, K, 0.f, splits, width, stream_ptr, nullptr);
}
