// Causal prefill attention against a long KV cache, with an online softmax, for Hopper (sm_90a),
// the visible keys of a row tile split over a thread-block cluster when the row tiles alone do
// not fill the card.
//
// Replaces the Pallas TPU kernel light_whisper_tpu/ops/flash_prefill.py:_flash_rows (the
// pallas_call of flash_prefill_attention). For each KV head and each of its G * T query rows
// (query head kvh * G + g at time t, absolute position start + t):
//   s_j = (q . k_j) * hd^-1/2 in f32, keys past the row's position excluded;
//   running max m and denominator l in f32; l sums the f32 p_j = exp(s_j - m), while p . v
//   uses p rounded to bf16 (bf16 operands, f32 accumulation);
//   out = acc / l in f32, and a row with l == 0 gives exactly 0.
// The logits are kept in log2 units: one multiply by hd^-1/2 * log2(e) and ex2.approx, so that
// 2^(s2 - m2) = exp(s - m) up to the unit's ~2 ulp.
//
// What bounds it on the H100: operations. A prefill of T rows over a cache of C >= 8192 slots
// does 4 * Hq * hd * T^2 / 2 flops of causal attention (6.4e10 a layer at 0.6B, T = 3,968)
// against ~64 MB of q, live K/V and f32 output: far above the card's ridge of ~295 flops a byte,
// so the bf16 tensor cores set the floor (~65 us a layer at 989 TFLOP/s). With few rows over a
// long cache (T = 512 at the end of 32k) the work is as large but spread over few row tiles:
// there the floor is only reached if every SM has keys to walk.
//
// The design:
//   - a CTA owns (KV head, tile of 128 flattened query rows): eight consumer warps, one 16-row
//     strip each, and one producer warp. Rows are flattened time-major (row = t * G + g), so a
//     tile holds 128 / G consecutive positions and every K/V byte it reads serves all of its rows.
//     Tiles are launched heaviest (latest positions) first;
//   - the tile's visible keys [0, nkeys) are cut into S contiguous shares, one a CTA of a cluster
//     of S (prefill_splits: a function of T, Hq, Hkv and the capacity only, never of start, so a
//     launch stays valid as positions move; at most 4, since at one CTA an SM the card holds only
//     15 clusters of 8 and a 16-tile launch would run in two waves). Each CTA runs the online
//     softmax over its share; then the (m, l, acc) partials are merged in rank order through
//     distributed shared memory: every CTA gathers all S (m, l) of each row, weighs rank r by
//     2^(m_r - M), and rank r sums its 1/S of the tile's outputs over ranks 0..S-1 in rank order.
//     No float atomics, no global scratch, one launch. A share with no key reports m = -1e30,
//     l = 0 (weight 0);
//   - the producer warp streams 64-key K/V tiles through a ring of four stages with cp.async and
//     signals each stage's mbarrier when its copies land (cp.async.mbarrier.arrive); each
//     consumer warp waits on that barrier and, done with the tile, arrives on the stage's "empty"
//     barrier, which the producer waits on before refilling it. No block barrier a tile: the
//     warps drift apart, so one warp's softmax overlaps another's tensor-core work;
//   - q . k and p . v run on the tensor cores (mma.sync m16n8k16, bf16 operands, f32
//     accumulation) fed by ldmatrix (q from its shared-memory tile, K and V from the ring); the
//     logits, p, the running max and denominator and the accumulator stay in registers (the
//     accumulator layout of q . k is the operand layout of p . v); 2^x on the special-function
//     unit (ex2.approx) with hd^-1/2 * log2(e) folded into one multiply;
//   - masking only where it can bite: a tile is masked for a warp only if it reaches past the
//     position of the warp's first row or past the share's end; a warp skips the math of a tile
//     whose every key lies past its last row. Keys past the share's end are zero-filled, never
//     read from the cache, and rows past G * T are zero queries that see no key and are not
//     written;
//   - the attribute queries (shared-memory opt-in, resident clusters) run once a (device, cluster
//     size), not once a call.
// A cluster size the card cannot hold is an error, not a fallback.
//
// Why mma.sync and not wgmma: mma.sync with the softmax in registers is the design that
// decode_attention.cu already holds against its reference. What bounds it now is the rate of the
// loop itself (each warp reads all of K and V from shared memory for 16 rows, on the legacy
// tensor-core path); 32 rows a warp needs every register and spills, so wgmma fed by TMA is the
// next step (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

#include "attention_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kHD = 128;             // head dim (Qwen3-ASR)
constexpr int kRows = 128;           // query rows a CTA
constexpr int kKeys = 64;            // keys a tile
constexpr int kWarps = kRows / 16;   // consumer warps: one 16-row strip each
constexpr int kConsumerThreads = kWarps * 32;
constexpr int kThreads = kConsumerThreads + 32;  // and one producer warp
constexpr int kStages = 4;           // K/V ring
constexpr int kLd = kHD + 8;         // bf16 row stride in shared memory: ldmatrix without bank conflicts
constexpr int kChunks = kHD / 8;     // 16-byte chunks a row
constexpr int kMaxSplits = 4;        // cluster size (8 holds only 15 clusters at one CTA an SM)
constexpr int kFillCtas = 132;       // CTAs up to which the split doubles (the H100's SM count)
constexpr int kMinSplitKeys = 512;   // cache slots a split covers at least
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

constexpr size_t kQBytes = sizeof(__nv_bfloat16) * kRows * kLd;     // Q tile (then the merge's statistics)
constexpr size_t kTileBytes = sizeof(__nv_bfloat16) * kKeys * kLd;  // one K or V tile
constexpr size_t kRingBytes = 2 * kStages * kTileBytes;
constexpr size_t kSmemBytes = kQBytes + kRingBytes + 2 * kStages * sizeof(uint64_t);  // + full / empty mbarriers
static_assert(sizeof(float) * kRows * kHD <= kRingBytes, "partial output must fit the ring");
static_assert(sizeof(float) * kRows * (2 + 3 * kMaxSplits + 1) <= kQBytes, "merge statistics must fit the Q tile");

// 2^x by the special-function unit (ex2.approx.ftz: ~2 ulp, results below 2^-126 flushed to 0,
// which p of such a size is to the f32 sums); exp2f adds range handling that the logits do not need
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a barrier of the consumer warps alone (named barrier 1; the producer never waits on it)
__device__ __forceinline__ void consumer_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

struct Args {
  const __nv_bfloat16* q;  // [T, Hq, kHD]
  const __nv_bfloat16* k;  // [Hkv, C, kHD]
  const __nv_bfloat16* v;  // [Hkv, C, kHD]
  float* out;              // [T, Hq, kHD]
  int T, Hq, Hkv, C, start, splits;
  float scale2;            // hd^-1/2 * log2(e)
};

__global__ void __launch_bounds__(kThreads, 1) flash_prefill_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  auto Ks = [&](int stage) { return reinterpret_cast<__nv_bfloat16*>(smem + kQBytes + 2 * stage * kTileBytes); };
  auto Vs = [&](int stage) { return reinterpret_cast<__nv_bfloat16*>(smem + kQBytes + (2 * stage + 1) * kTileBytes); };

  const int S = a.splits;
  const int rank = (int)blockIdx.x;  // = the rank in the cluster of (S, 1, 1)
  const int G = a.Hq / a.Hkv;
  const int rows = G * a.T;
  const int ntr = (rows + kRows - 1) / kRows;
  const int kvh = (int)blockIdx.y % a.Hkv;
  const int row0 = (ntr - 1 - (int)blockIdx.y / a.Hkv) * kRows;  // the latest row tiles first
  const int nrows = min(kRows, rows - row0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int quad_row = lane >> 2;  // this thread's rows in the strip: quad_row and quad_row + 8
  const int quad_col = lane & 3;   // and its column pair 2 * quad_col within each 8-wide tile
  const __nv_bfloat16* kh = a.k + (size_t)kvh * a.C * kHD;
  const __nv_bfloat16* vh = a.v + (size_t)kvh * a.C * kHD;
  // keys 0..nkeys-1 are visible to some row of the tile (its last row sees the most), cut into
  // S shares; this CTA walks [k0, k1)
  const int nkeys = a.start + (row0 + nrows - 1) / G + 1;
  const int share = (nkeys + S - 1) / S;
  const int k0 = min(rank * share, nkeys);
  const int k1 = min(k0 + share, nkeys);
  const int ntiles = (k1 - k0 + kKeys - 1) / kKeys;

  // the ring's mbarriers: full[s] completes when the producer's copies into stage s have landed,
  // empty[s] when every consumer warp is done with it
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kQBytes + kRingBytes);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 32);
      mbar_init(&empty[st], kWarps);
    }
  }
  __syncthreads();

  const int r_lo = warp * 16 + quad_row;  // tile rows of this thread (consumers)
  const int r_hi = r_lo + 8;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;  // m in log2 units; l: this thread's share
  float acc[kHD / 8][4];
  if (warp == kWarps) {
    // -- the producer warp: K/V tiles into the ring, kStages ahead of the slowest consumer --
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % kStages;
      if (it >= kStages) mbar_wait(&empty[st], (it / kStages - 1) & 1);
      const int kb = k0 + it * kKeys;
      __nv_bfloat16* kd = Ks(st);
      __nv_bfloat16* vd = Vs(st);
      for (int e = lane; e < kKeys * kChunks; e += 32) {
        const int j = e / kChunks, c = e - j * kChunks;
        const bool live = kb + j < k1;  // keys past the share are zero-filled, never read
        const size_t off = live ? (size_t)(kb + j) * kHD + c * 8 : 0;
        cp_async16(kd + j * kLd + c * 8, kh + off, live ? 16 : 0);
        cp_async16(vd + j * kLd + c * 8, vh + off, live ? 16 : 0);
      }
      mbar_arrive_on_copies(&full[st]);
    }
  } else {
  // -- the consumer warps --------------------------------------------------------------
  for (int e = threadIdx.x; e < kRows * kChunks; e += kConsumerThreads) {
    const int r = e / kChunks, c = e - r * kChunks;
    const int fr = row0 + r;
    const bool live = r < nrows;
    const __nv_bfloat16* src = a.q;
    if (live) {
      const int t = fr / G, g = fr - t * G;
      src = a.q + ((size_t)t * a.Hq + kvh * G + g) * kHD + c * 8;
    }
    cp_async16(Qs + r * kLd + c * 8, src, live ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  consumer_barrier();


  const int pos_lo = r_lo < nrows ? a.start + (row0 + r_lo) / G : -1;  // -1: past the ragged edge, sees no key
  const int pos_hi = r_hi < nrows ? a.start + (row0 + r_hi) / G : -1;
  const bool active = warp * 16 < nrows;
  // the positions of the warp's first and last rows (first: -1 if a row of the strip is past the edge)
  const int wfirst = warp * 16 + 15 < nrows ? a.start + (row0 + warp * 16) / G : -1;
  const int wlast = active ? a.start + (row0 + min(warp * 16 + 15, nrows - 1)) / G : -1;
#pragma unroll
  for (int n = 0; n < kHD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int st = it % kStages;
    mbar_wait(&full[st], (it / kStages) & 1);  // also keeps this warp in step with the ring's rounds
    const int kb = k0 + it * kKeys;
    // warp-uniform: a tile whose every key lies past the strip's rows is skipped
    if (active && kb <= wlast) {
    const __nv_bfloat16* Kt = Ks(st);
    const __nv_bfloat16* Vt = Vs(st);

    // s = q . k: 16 rows x 64 keys, eight 8-key accumulator tiles
    float s[kKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHD / 16; ++kk) {
      uint32_t qk[4];
      ldmatrix_x4(qk, Qs + (warp * 16 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jj = 0; jj < kKeys / 16; ++jj) {
        uint32_t b[4];  // key tiles 2jj and 2jj + 1, head dims kk * 16 .. + 15
        ldmatrix_x4(b, Kt + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jj], qk, b[0], b[1]);
        mma_bf16(s[2 * jj + 1], qk, b[2], b[3]);
      }
    }

    // online softmax of the two rows (a four-thread group holds a row's 64 keys); only a tile
    // that reaches past the strip's first position or past the share is masked
    const bool masked = kb + kKeys - 1 > wfirst || kb + kKeys > k1;
    float mx_lo = kNegInf, mx_hi = kNegInf;
    if (masked) {
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kb + j * 8 + quad_col * 2 + e;
          s[j][e] = key <= pos_lo && key < k1 ? s[j][e] * a.scale2 : kNegInf;
          s[j][2 + e] = key <= pos_hi && key < k1 ? s[j][2 + e] * a.scale2 : kNegInf;
          mx_lo = fmaxf(mx_lo, s[j][e]);
          mx_hi = fmaxf(mx_hi, s[j][2 + e]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= a.scale2;
        mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
      }
    }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    const float alpha_lo = ex2(m_lo - mn_lo);
    const float alpha_hi = ex2(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // a masked key has s = -1e30: exp2(-1e30 - m) is 0, except where m is still -1e30
        s[j][e] = masked && s[j][e] == kNegInf ? 0.f : ex2(s[j][e] - m_lo);
        s[j][2 + e] = masked && s[j][2 + e] == kNegInf ? 0.f : ex2(s[j][2 + e] - m_hi);
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
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);

  if (S == 1) {
    // out = acc / l; a row that saw no key (l == 0) gives exactly 0
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r_hi : r_lo;
      if (r >= nrows) continue;
      const float l = half ? l_hi : l_lo;
      const int fr = row0 + r;
      const int t = fr / G, g = fr - t * G;
      float* orow = a.out + ((size_t)t * a.Hq + kvh * G + g) * kHD;
#pragma unroll
      for (int n = 0; n < kHD / 8; ++n) {
        const float a0 = acc[n][2 * half], a1 = acc[n][2 * half + 1];
        *reinterpret_cast<float2*>(orow + n * 8 + quad_col * 2) =
            l > 0.f ? make_float2(a0 / l, a1 / l) : make_float2(0.f, 0.f);
      }
    }
  }
  }  // consumers
  if (S == 1) return;

  // -- merge of the S shares through distributed shared memory -------------------------
  cg::cluster_group cluster = cg::this_cluster();
  float* part = reinterpret_cast<float*>(smem + kQBytes);  // [kRows][kHD] unnormalised acc
  float* stat = reinterpret_cast<float*>(smem);            // [kRows][2] local (m, l)
  float* all = stat + 2 * kRows;                           // [S][kRows][2] every rank's
  float* wts = all + 2 * kMaxSplits * kRows;               // [S][kRows] exp2(m_r - M)
  float* lsum = wts + kMaxSplits * kRows;                  // [kRows] merged denominator
  __syncthreads();  // every consumer is done with the ring and with the Q tile
  if (warp < kWarps) {
#pragma unroll
    for (int n = 0; n < kHD / 8; ++n) {
      *reinterpret_cast<float2*>(part + r_lo * kHD + n * 8 + quad_col * 2) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(part + r_hi * kHD + n * 8 + quad_col * 2) = make_float2(acc[n][2], acc[n][3]);
    }
    if (quad_col == 0) {
      stat[2 * r_lo] = m_lo;
      stat[2 * r_lo + 1] = l_lo;
      stat[2 * r_hi] = m_hi;
      stat[2 * r_hi + 1] = l_hi;
    }
  }
  cluster.sync();  // every rank's partials are written
  for (int e = threadIdx.x; e < S * kRows; e += kThreads) {
    reinterpret_cast<float2*>(all)[e] = reinterpret_cast<const float2*>(cluster.map_shared_rank(stat, e / kRows))[e % kRows];
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    float M = all[2 * r];
    for (int q = 1; q < S; ++q) M = fmaxf(M, all[(q * kRows + r) * 2]);
    float L = 0.f;
    for (int q = 0; q < S; ++q) {
      const float w = ex2(all[(q * kRows + r) * 2] - M);
      wts[q * kRows + r] = w;
      L += all[(q * kRows + r) * 2 + 1] * w;
    }
    lsum[r] = L;
  }
  __syncthreads();
  // rank `rank` sums its 1/S of the tile's outputs over ranks 0..S-1 in rank order
  const int chunk = (nrows * kHD / 4 + S - 1) / S;
  const int v1 = min(nrows * kHD / 4, (rank + 1) * chunk);
  for (int i = rank * chunk + (int)threadIdx.x; i < v1; i += kThreads) {
    float4 x[kMaxSplits];
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q) {
      if (q < S) x[q] = reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q))[i];
    }
    const int r = i / (kHD / 4), col = (i - r * (kHD / 4)) * 4;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q) {
      if (q < S) {
        const float w = wts[q * kRows + r];
        o.x += x[q].x * w;
        o.y += x[q].y * w;
        o.z += x[q].z * w;
        o.w += x[q].w * w;
      }
    }
    const float L = lsum[r];
    o = L > 0.f ? make_float4(o.x / L, o.y / L, o.z / L, o.w / L) : make_float4(0.f, 0.f, 0.f, 0.f);
    const int fr = row0 + r;
    const int t = fr / G, g = fr - t * G;
    *reinterpret_cast<float4*>(a.out + ((size_t)t * a.Hq + kvh * G + g) * kHD + col) = o;
  }
  cluster.sync();  // every rank is done reading this CTA's shared memory
}

// The split count: a function of the static shapes only (ops/flash_prefill.prefill_splits). It
// doubles while the launch's CTAs stay within kFillCtas and every split keeps kMinSplitKeys of the
// capacity.
int prefill_splits(int T, int Hq, int Hkv, int C) {
  const int tiles = Hkv * ((Hq / Hkv * T + kRows - 1) / kRows);
  int s = 1;
  while (s < kMaxSplits && tiles * 2 * s <= kFillCtas && C / (2 * s) >= kMinSplitKeys) s *= 2;
  return s;
}

// The (device, cluster size) pairs whose attributes are set and whose one cluster the card was
// found to hold, so that a launch asks once.
std::mutex g_lock;
int g_ready[16][kMaxSplits + 1];  // [device][splits]: 0 unknown, else resident clusters

cudaLaunchConfig_t make_config(const Args& P, cudaLaunchAttribute* attr, cudaStream_t stream) {
  const int ntr = (P.Hq / P.Hkv * P.T + kRows - 1) / kRows;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P.splits, P.Hkv * ntr);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Sets the kernel's attributes once a device and finds how many clusters of P.splits CTAs the
// card holds at once (an error if none).
cudaError_t configure(const Args& P, int* resident) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 16) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(g_lock);
  int& known = g_ready[device][P.splits];
  if (known > 0) {
    *resident = known;
    return cudaSuccess;
  }
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, flash_prefill_kernel);
  if (err != cudaSuccess) return err;
  if (attr.sharedSizeBytes + kSmemBytes > (size_t)optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(flash_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute la[1];
  cudaLaunchConfig_t cfg = make_config(P, la, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, flash_prefill_kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  known = clusters;
  *resident = clusters;
  return cudaSuccess;
}

bool shape_ok(int T, int Hq, int Hkv, int C, int hd, int start) {
  return T > 0 && Hkv > 0 && Hq % Hkv == 0 && start >= 0 && (long long)start + T <= C && hd == kHD;
}

}  // namespace

// Returns a cudaError_t (0 on success). q [T, Hq, hd] bf16; k and v the layer's [Hkv, C, hd]
// bf16 block; out [T, Hq, hd] f32. Query row t sits at absolute position start + t and sees
// keys 0..start + t. Only hd = 128 is built.
extern "C" int lwt_flash_prefill(const void* q, const void* k, const void* v, void* out, int T, int Hq,
                                 int Hkv, int C, int hd, int start, float scale, void* stream_ptr) {
  if (!shape_ok(T, Hq, Hkv, C, hd, start)) return (int)cudaErrorInvalidValue;
  const Args P{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out),
               T, Hq, Hkv, C, start, prefill_splits(T, Hq, Hkv, C), scale * kLog2e};
  int resident = 0;
  cudaError_t err = configure(P, &resident);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute la[1];
  cudaLaunchConfig_t cfg = make_config(P, la, static_cast<cudaStream_t>(stream_ptr));
  err = cudaLaunchKernelEx(&cfg, flash_prefill_kernel, P);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Returns a cudaError_t (0 on success); launches nothing. *splits gets the kernel's split count
// for these shapes and *clusters how many clusters of that many CTAs the card holds at once.
extern "C" int lwt_flash_prefill_plan(int T, int Hq, int Hkv, int C, int hd, int* splits, int* clusters) {
  if (!shape_ok(T, Hq, Hkv, C, hd, 0)) return (int)cudaErrorInvalidValue;
  const Args P{nullptr, nullptr, nullptr, nullptr, T, Hq, Hkv, C, 0, prefill_splits(T, Hq, Hkv, C), 1.f};
  *splits = P.splits;
  return (int)configure(P, clusters);
}
