// GQA decode attention over the head-major KV cache for Hopper (sm_90a), with the live keys of
// each KV head split over a thread-block cluster.
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
// Both entries launch the same two kernels; a stacked call is a batched one of one stream whose
// row t is bounded by start + t.
//
// Numerics (shared with the plain PyTorch versions in ops/decode_attention.py):
//   logits f32 from bf16 q and k, times hd^-1/2; keys past a row's bound are masked
//   (the TPU kernels write -1e30 there; exp(-1e30 - m) is exactly 0 in f32, so reading only
//   the live keys is exact, and whatever a cache holds past the bound is never read);
//   softmax in f32 with the row's global max m and denominator l, p = bf16(exp(s - m) / l);
//   p . v with bf16 operands accumulated in f32; output f32.
//
// What bounds it on the H100: bytes. A KV head's live K and V, 2 * nlive * hd * 2 bytes, serve
// all G * T query rows of the head; the arithmetic is 4 FLOPs per cached element per query row,
// far below the card's ridge (~295 FLOPs a byte) at T <= 64. At T = 1 the whole call reads a few
// MB (C = 8192: one layer's live K/V ~ 8 MB at most), so what decides its time is how many SMs
// read at once and how many round trips to memory each makes.
//
// What the design does about it:
//   - a work unit is (stream, KV head, tile of up to 64 query rows flattened time-major,
//     row = t * G + g); all rows of a unit share every K/V byte it reads. Units of at most 4
//     rows (decode: G rows at T = 1, G rows a stream batched) run on CUDA cores, K and then V
//     streaming through a ring of 64-key shared-memory tiles copied by cp.async several tiles
//     ahead. Larger units (T up to 64) run q . k and p . v on the tensor cores (mma.sync
//     m16n8k16 from ldmatrix, as flash_prefill.cu) with K/V tiles of 64 keys in two stages;
//   - the unit's live keys [0, nkeys) are split evenly over a cluster of S CTAs, so a long
//     cache is read by S SMs at once. S comes from the cache capacity only
//     (ops/decode_attention.split_count), so a stream's result is the same to the bit alone or
//     batched. The split needs the row's global statistics before p is rounded (a
//     flash-decoding split would round an unnormalised p per split, which the reference does
//     not), so the CTAs exchange them inside the launch through distributed shared memory:
//       pass 1: each CTA computes its rows' local (max, denominator) over its keys;
//       cluster barrier; each CTA gathers all S partners' statistics (the remote loads in
//       flight together) and merges them in rank order;
//       pass 2: each CTA forms p = bf16(exp(s - m) / l) and accumulates p . v in f32 into its
//       shared memory. The CUDA-core kernel keeps the logits of its whole share in shared
//       memory (ceil(C / S) x rows floats), computes each exp and division once a key and
//       row, and reads only V; the tensor-core kernel recomputes q . k from K tiles that come
//       back from L2;
//       cluster barrier; rank r sums its 1/S share of the unit's outputs over partners
//       0..S-1 in rank order and writes it; a last barrier keeps every CTA's shared memory
//       alive until its partners have read it.
//     Deterministic: no float atomics, no global scratch, one launch. A CTA whose share is
//     empty (fewer live keys than S) contributes max -1e30 and denominator 0, which the merge
//     weighs by exp(-1e30 - m) = 0, and joins every barrier;
//   - the CUDA-core kernel stays within 128 registers, so two CTAs fit an SM and all clusters
//     of 16 of a T = 1 launch are resident at once;
//   - only the live keys of a unit are read, and keys past a row's bound are masked to p = 0;
//   - a cluster size or shared memory the card cannot hold (cudaOccupancyMaxActiveClusters of
//     0, or more than the opt-in limit) is refused with an error, not rerouted.
// The TPU batched kernel padded each program's G query rows to a sublane tile of 8 (_ROW_PAD);
// that is a TPU layout rule and has no counterpart here.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include <mutex>

#include "attention_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTileRows = 64;   // rows a unit, and keys a tensor-core tile
constexpr int kSmallRows = 4;   // units up to this many rows run on CUDA cores
constexpr int kSmallWarps = 8;
constexpr int kMmaWarps = kTileRows / 16;  // one 16-row strip a warp
constexpr int kMaxSplits = 16;
constexpr float kNegInit = -1e30f;

struct Problem {
  const __nv_bfloat16* q;  // [B, T, Hq, hd]
  const __nv_bfloat16* k;  // [B, L, Hkv, C, hd] (stacked form: B = L = 1, layer 0)
  const __nv_bfloat16* v;
  const int* pos;          // batched: [B] device positions; null: row t sits at start + t
  float* out;              // [B, T, Hq, hd]
  int T, Hq, Hkv, C, L, layer, start;
  float scale;
};

// One CTA's view of its unit and of its share [k0, k1) of the unit's live keys.
struct Unit {
  const __nv_bfloat16* kh;
  const __nv_bfloat16* vh;
  int b, kvh, G, row0, rows, k0, k1, bound;  // bound: the stream's position (batched) or -1
};

template <int HD>
__device__ __forceinline__ Unit make_unit(const Problem& P, int splits, int rank) {
  Unit u;
  u.G = P.Hq / P.Hkv;
  const int all_rows = u.G * P.T;
  const int ntiles = (all_rows + kTileRows - 1) / kTileRows;
  u.kvh = blockIdx.y / ntiles;
  u.row0 = (blockIdx.y - u.kvh * ntiles) * kTileRows;
  u.rows = min(kTileRows, all_rows - u.row0);
  u.b = blockIdx.z;
  int nkeys;
  if (P.pos != nullptr) {
    // the wrapper bounds the host mirror of pos; a device position outside the
    // cache means the two disagree, and the launch fails rather than read another prefix
    u.bound = P.pos[u.b];
    if (u.bound < 0 || u.bound >= P.C) __trap();
    nkeys = u.bound + 1;
  } else {
    u.bound = -1;
    nkeys = P.start + (u.row0 + u.rows - 1) / u.G + 1;  // the tile's last row sees the most keys
  }
  const size_t head = (((size_t)u.b * P.L + P.layer) * P.Hkv + u.kvh) * P.C * HD;
  u.kh = P.k + head;
  u.vh = P.v + head;
  const int share = (nkeys + splits - 1) / splits;
  u.k0 = min(rank * share, nkeys);
  u.k1 = min(u.k0 + share, nkeys);
  return u;
}

// flattened row fr = t * G + g of the unit: its position and its q / out offsets
__device__ __forceinline__ int row_pos(const Problem& P, const Unit& u, int fr) {
  return u.bound >= 0 ? u.bound : P.start + fr / u.G;
}

template <int HD>
__device__ __forceinline__ size_t row_offset(const Problem& P, const Unit& u, int fr) {
  const int t = fr / u.G, g = fr - t * u.G;
  return (((size_t)u.b * P.T + t) * P.Hq + u.kvh * u.G + g) * HD;
}

// (m, l) <- the merge of (m, l) and (mo, lo): max and denominator over both key sets
__device__ __forceinline__ void merge_stats(float& m, float& l, float mo, float lo) {
  const float mn = fmaxf(m, mo);
  l = l * expf(m - mn) + lo * expf(mo - mn);
  m = mn;
}

// Global (m, l) of the unit's NR rows: every partner's local statistics ([NR][2] at `stat` in
// each CTA) are gathered into `all` ([S][NR][2]) with all loads in flight at once, then thread r
// merges row r's in rank order into `gstat` ([NR][2]). NT threads call it.
template <int NR, int NT>
__device__ __forceinline__ void merge_ranks(cg::cluster_group& cluster, float* stat, float* all, float* gstat,
                                            int splits) {
  constexpr int kPerThread = (kMaxSplits * NR + NT - 1) / NT;
  const int n = splits * NR;
  float2 x[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int e = threadIdx.x + i * NT;
    if (e < n) x[i] = reinterpret_cast<const float2*>(cluster.map_shared_rank(stat, e / NR))[e % NR];
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int e = threadIdx.x + i * NT;
    if (e < n) reinterpret_cast<float2*>(all)[e] = x[i];
  }
  __syncthreads();
  if (threadIdx.x < NR) {
    const int r = threadIdx.x;
    float m = all[2 * r], l = all[2 * r + 1];
    for (int rank = 1; rank < splits; ++rank) merge_stats(m, l, all[(rank * NR + r) * 2], all[(rank * NR + r) * 2 + 1]);
    gstat[2 * r] = m;
    gstat[2 * r + 1] = l;
  }
  __syncthreads();
}

// Rank `rank` sums its 1/S share of the unit's rows x HD partial outputs ([64 or R][HD] f32 at
// `part` in each CTA) over partners 0..S-1 in rank order and writes it to out. A thread's S
// remote loads are in flight together.
template <int HD>
__device__ __forceinline__ void reduce_out(cg::cluster_group& cluster, const Problem& P, const Unit& u,
                                           float* part, int rank, int splits, int nthreads) {
  const int nvec = u.rows * HD / 4;
  const int chunk = (nvec + splits - 1) / splits;
  const int v1 = min(nvec, (rank + 1) * chunk);
  for (int i = rank * chunk + (int)threadIdx.x; i < v1; i += nthreads) {
    float4 x[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < splits) x[r] = reinterpret_cast<const float4*>(cluster.map_shared_rank(part, r))[i];
    }
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < splits) {
        acc.x += x[r].x;
        acc.y += x[r].y;
        acc.z += x[r].z;
        acc.w += x[r].w;
      }
    }
    const int row = i / (HD / 4), col = (i - row * (HD / 4)) * 4;
    *reinterpret_cast<float4*>(P.out + row_offset<HD>(P, u, u.row0 + row) + col) = acc;
  }
}

// ---------------------------------------------------------------------------------------------
// Units of at most R <= 4 rows: CUDA cores, in four phases over the CTA's share of keys.
//   1. q . k: K streams through a ring of 64-key tiles in shared memory, copied by cp.async
//      several tiles ahead; a key row is read by LPK lanes (16 bytes a lane at a time, a 128-byte
//      run a lane group) and dotted with every row's q fragment; the logits go to shared memory.
//   2. each thread takes every 256th key of the share and folds its logits into a running
//      (max, denominator) a row; the threads' statistics merge in a fixed order.
//   3. after the cluster's merge, each thread turns its keys' logits into p = bf16(exp(s - m) / l)
//      in place, so each exp and division happens once, not once a lane of a group.
//   4. p . v: V streams through the same ring (its first tiles are in flight across phases 2-3).
// At most 128 registers a thread, so that two CTAs fit an SM: a cluster of 16 then needs 8 SMs
// of one GPC, and all of a T = 1 launch's clusters are resident at once.

template <int HD, int R>
struct Small {
  static constexpr int kLanesPerKey = HD >= 256 ? 16 : 8;
  static constexpr int kChunksPerLane = HD / 8 / kLanesPerKey;  // 16-byte chunks of a row a lane
  static constexpr int kKeysPerStep = 32 / kLanesPerKey;         // keys a warp step
  static constexpr int kTileKeys = 64;
  static constexpr int kStages = 512 / HD;                       // 64 KB of ring
  static constexpr int kSteps = kTileKeys / (kSmallWarps * kKeysPerStep);  // a warp's steps a tile
  static constexpr int kThreads = kSmallWarps * 32;
  static constexpr size_t kRingBytes = (size_t)kStages * kTileKeys * HD * 2;
  static_assert(kSteps >= 1 && kStages >= 2, "tile shape");
  static_assert(sizeof(float) * kSmallWarps * R * HD <= kRingBytes, "partials must fit the ring");
  // shared memory: the ring (then the warps' partial outputs, slot 0 then the CTA's), local
  // (m, l) a row, the warps' (m, l) a row (then the global ones), every partner's (m, l) a
  // row, then the logits (then p) of the share (`share` keys x R, sized at launch)
  static constexpr size_t kFixedBytes = kRingBytes + sizeof(float) * (2 * R + kSmallWarps * 2 * R + kMaxSplits * 2 * R);
  static size_t smem_bytes(int share) { return kFixedBytes + sizeof(float) * (size_t)share * R; }
};

__device__ __forceinline__ void unpack8(const uint4& x, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <int HD, int R>
__global__ void __launch_bounds__(Small<HD, R>::kThreads, 2) attention_small_kernel(Problem P, int splits) {
  using S = Small<HD, R>;
  constexpr int LPK = S::kLanesPerKey, CPL = S::kChunksPerLane, KPS = S::kKeysPerStep;
  constexpr int KT = S::kTileKeys, NS = S::kStages, NT = S::kThreads;
  constexpr int kChunks = KT * HD / 8;  // 16-byte chunks a tile
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);     // [NS][KT][HD]
  float* wpart = reinterpret_cast<float*>(smem);                   // [warps][R][HD], after phase 4
  float* stat = reinterpret_cast<float*>(smem + S::kRingBytes);    // [R][2]
  float* wstat = stat + 2 * R;                                     // [warps][R][2]
  float* all = wstat + kSmallWarps * 2 * R;                        // [S][R][2]
  float* lg = all + kMaxSplits * 2 * R;                            // [share][R]: s, then p, of k0, k0 + 1, ..

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const Unit u = make_unit<HD>(P, splits, rank);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int li = lane % LPK;  // this lane's chunks of a row: li, li + LPK, ..
  const int kg = lane / LPK;  // this lane's key in a warp step
  const int ntiles = (u.k1 - u.k0 + KT - 1) / KT;

  // tile t of K or V (rows k0 + t * KT ..) into stage t % NS; keys past k1 are zero-filled
  auto load_tile = [&](const __nv_bfloat16* src, int t) {
    if (t < ntiles) {
      __nv_bfloat16* dst = ring + (size_t)(t % NS) * KT * HD;
      const int kb = u.k0 + t * KT;
      for (int e = threadIdx.x; e < kChunks; e += NT) {
        const bool live = kb + e / (HD / 8) < u.k1;
        cp_async16(dst + e * 8, src + (live ? (size_t)kb * HD + e * 8 : 0), live ? 16 : 0);
      }
    }
    cp_async_commit();  // an empty group past the last tile keeps the wait counts uniform
  };

  for (int t = 0; t < NS - 1; ++t) load_tile(u.kh, t);

  float qf[R][CPL * 8];
  int qpos[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool real = r < u.rows;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (real) x = *reinterpret_cast<const uint4*>(P.q + row_offset<HD>(P, u, u.row0 + r) + (li + c * LPK) * 8);
      unpack8(x, qf[r] + c * 8);
    }
    qpos[r] = real ? row_pos(P, u, u.row0 + r) : -1;  // -1: padding, sees no key
  }

  // 1. the logits of every key of the share
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<NS - 2>();
    __syncthreads();                // tile t has landed, and every warp is past tile t - 1
    load_tile(u.kh, t + NS - 1);    // into the stage tile t - 1 used
    const __nv_bfloat16* tile = ring + (size_t)(t % NS) * KT * HD;
    float s[S::kSteps][R];
#pragma unroll
    for (int i = 0; i < S::kSteps; ++i) {
      const int jt = (warp * S::kSteps + i) * KPS + kg;  // key within the tile
#pragma unroll
      for (int r = 0; r < R; ++r) s[i][r] = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        float kf[8];
        unpack8(*reinterpret_cast<const uint4*>(tile + jt * HD + (li + c * LPK) * 8), kf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int e = 0; e < 8; ++e) s[i][r] = fmaf(qf[r][c * 8 + e], kf[e], s[i][r]);
        }
      }
    }
#pragma unroll
    for (int off = LPK / 2; off > 0; off >>= 1) {  // the sum over the key's lane group
#pragma unroll
      for (int i = 0; i < S::kSteps; ++i) {
#pragma unroll
        for (int r = 0; r < R; ++r) s[i][r] += __shfl_xor_sync(0xffffffffu, s[i][r], off);
      }
    }
    if (li == 0) {
#pragma unroll
      for (int i = 0; i < S::kSteps; ++i) {
        const int j = u.k0 + t * KT + (warp * S::kSteps + i) * KPS + kg;
        if (j < u.k1) {
#pragma unroll
          for (int r = 0; r < R; ++r) lg[(j - u.k0) * R + r] = s[i][r] * P.scale;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is past the K tiles, and every logit is written
  for (int t = 0; t < NS - 1; ++t) load_tile(u.vh, t);  // phase 4's first V tiles, in flight meanwhile

  // 2. each row's local max and denominator: thread x folds keys k0 + x, k0 + x + 256, ..
  float m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInit;
    l[r] = 0.f;
  }
  for (int j = u.k0 + threadIdx.x; j < u.k1; j += NT) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (j <= qpos[r]) merge_stats(m[r], l[r], lg[(j - u.k0) * R + r], 1.f);
    }
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      merge_stats(m[r], l[r], __shfl_xor_sync(0xffffffffu, m[r], off), __shfl_xor_sync(0xffffffffu, l[r], off));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      wstat[(warp * R + r) * 2] = m[r];
      wstat[(warp * R + r) * 2 + 1] = l[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    float mm = wstat[2 * r], ll = wstat[2 * r + 1];
    for (int w = 1; w < kSmallWarps; ++w) merge_stats(mm, ll, wstat[(w * R + r) * 2], wstat[(w * R + r) * 2 + 1]);
    stat[2 * r] = mm;
    stat[2 * r + 1] = ll;
  }
  cluster.sync();  // every partner's local statistics are written
  merge_ranks<R, NT>(cluster, stat, all, wstat, splits);  // the warps' slots are free again

  // 3. p = bf16(exp(s - m) / l) in place of each logit; 0 past a row's bound
  for (int j = u.k0 + threadIdx.x; j < u.k1; j += NT) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float* x = lg + (j - u.k0) * R + r;
      *x = j <= qpos[r] ? __bfloat162float(__float2bfloat16_rn(expf(*x - wstat[2 * r]) / wstat[2 * r + 1])) : 0.f;
    }
  }

  // 4. partial out = sum over the share of p_j v_j (the loop's first barrier orders phase 3)
  float acc[R][CPL * 8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int e = 0; e < CPL * 8; ++e) acc[r][e] = 0.f;
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    load_tile(u.vh, t + NS - 1);
    const __nv_bfloat16* tile = ring + (size_t)(t % NS) * KT * HD;
#pragma unroll
    for (int i = 0; i < S::kSteps; ++i) {
      const int jt = (warp * S::kSteps + i) * KPS + kg;
      const int j = u.k0 + t * KT + jt;
      if (j < u.k1) {
        float p[R];
#pragma unroll
        for (int r = 0; r < R; ++r) p[r] = lg[(j - u.k0) * R + r];
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          float vf[8];
          unpack8(*reinterpret_cast<const uint4*>(tile + jt * HD + (li + c * LPK) * 8), vf);
#pragma unroll
          for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[r][c * 8 + e] = fmaf(p[r], vf[e], acc[r][c * 8 + e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {  // the warp's key slots
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int e = 0; e < CPL * 8; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is past the ring: it holds the partial outputs now
  if (kg == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        float4* dst = reinterpret_cast<float4*>(wpart + (warp * R + r) * HD + (li + c * LPK) * 8);
        dst[0] = make_float4(acc[r][c * 8], acc[r][c * 8 + 1], acc[r][c * 8 + 2], acc[r][c * 8 + 3]);
        dst[1] = make_float4(acc[r][c * 8 + 4], acc[r][c * 8 + 5], acc[r][c * 8 + 6], acc[r][c * 8 + 7]);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * HD; i += NT) {  // the warps in order, into slot 0
    float total = wpart[i];
    for (int w = 1; w < kSmallWarps; ++w) total += wpart[w * R * HD + i];
    wpart[i] = total;
  }
  cluster.sync();  // every partner's partial output is written
  reduce_out<HD>(cluster, P, u, wpart, rank, splits, NT);
  cluster.sync();  // partners are done reading this CTA's shared memory
}

// ---------------------------------------------------------------------------------------------
// Units of more than 4 rows: tensor cores, K/V tiles of 64 keys through shared memory (a strip
// of 16 rows without a real one skips its products).

template <int HD>
struct Mma {
  static constexpr int kLd = HD + 8;  // bf16 row stride in shared memory: ldmatrix without bank conflicts
  static constexpr int kChunks = HD / 8;
  static constexpr int kThreads = kMmaWarps * 32;
  static constexpr size_t kTileBytes = sizeof(__nv_bfloat16) * kTileRows * kLd;
  // Q, K and V in two stages (the partial output [64][HD] f32 reuses the K/V stages after the
  // key loops), local and global (m, l) a row
  static constexpr size_t kSmemBytes = kTileBytes * 5 + sizeof(float) * kTileRows * 4;
  static_assert(sizeof(float) * kTileRows * HD <= kTileBytes * 4, "partial output must fit the K/V stages");
  static_assert(sizeof(float) * kMaxSplits * kTileRows * 2 <= kTileBytes, "partners' statistics must fit a stage");
};

// s = q . k for this warp's 16 rows and the tile's 64 keys (eight 8-key accumulator tiles)
template <int HD>
__device__ __forceinline__ void mma_logits(float (&s)[8][4], const __nv_bfloat16* Qs, const __nv_bfloat16* Kt,
                                           int warp, int lane) {
  constexpr int kLd = Mma<HD>::kLd;
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t qa[4];
    ldmatrix_x4(qa, Qs + (warp * 16 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t b[4];  // key tiles 2jj and 2jj + 1, head dims kk * 16 .. + 15
      ldmatrix_x4(b, Kt + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * jj], qa, b[0], b[1]);
      mma_bf16(s[2 * jj + 1], qa, b[2], b[3]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(Mma<HD>::kThreads) attention_mma_kernel(Problem P, int splits) {
  using M = Mma<HD>;
  constexpr int kLd = M::kLd, kChunks = M::kChunks, kThreads = M::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + M::kTileBytes);      // [2][64][kLd]
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + 3 * M::kTileBytes);  // [2][64][kLd]
  float* part = reinterpret_cast<float*>(smem + M::kTileBytes);                    // [64][HD], after the loops
  float* stat = reinterpret_cast<float*>(smem + 5 * M::kTileBytes);                // [64][2] local
  float* gstat = stat + 2 * kTileRows;                                             // [64][2] global
  // every partner's (m, l) a row, [S][64][2]: K stage 1 is free while it is used
  float* all = reinterpret_cast<float*>(smem + 2 * M::kTileBytes);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const Unit u = make_unit<HD>(P, splits, rank);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad_row = lane >> 2;  // this thread's rows in the strip: quad_row and quad_row + 8
  const int quad_col = lane & 3;   // and its column pair 2 * quad_col within each 8-wide tile
  const bool active = warp * 16 < u.rows;  // a strip with a real row computes
  const int ntiles = (u.k1 - u.k0 + kTileRows - 1) / kTileRows;

  auto load_tile = [&](int stage, int kb, bool with_v) {
    __nv_bfloat16* kd = Ks + stage * kTileRows * kLd;
    __nv_bfloat16* vd = Vs + stage * kTileRows * kLd;
    for (int e = threadIdx.x; e < kTileRows * kChunks; e += kThreads) {
      const int j = e / kChunks, c = e - j * kChunks;
      const bool live = kb + j < u.k1;
      const size_t off = live ? (size_t)(kb + j) * HD + c * 8 : 0;
      cp_async16(kd + j * kLd + c * 8, u.kh + off, live ? 16 : 0);
      if (with_v) cp_async16(vd + j * kLd + c * 8, u.vh + off, live ? 16 : 0);
    }
    cp_async_commit();
  };

  if (ntiles > 0) load_tile(0, u.k0, false);
  for (int e = threadIdx.x; e < kTileRows * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e - r * kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < u.rows) val = reinterpret_cast<const uint4*>(P.q + row_offset<HD>(P, u, u.row0 + r))[c];
    *reinterpret_cast<uint4*>(Qs + r * kLd + c * 8) = val;
  }
  __syncthreads();

  const int r_lo = warp * 16 + quad_row, r_hi = r_lo + 8;  // tile rows of this thread
  const int pos_lo = r_lo < u.rows ? row_pos(P, u, u.row0 + r_lo) : -1;  // -1: padding, sees no key
  const int pos_hi = r_hi < u.rows ? row_pos(P, u, u.row0 + r_hi) : -1;

  // pass 1: local max and denominator (l: this thread's share of the row sum)
  float m_lo = kNegInit, m_hi = kNegInit, l_lo = 0.f, l_hi = 0.f;
  for (int it = 0; it < ntiles; ++it) {
    const int kb = u.k0 + it * kTileRows;
    if (it + 1 < ntiles) {
      load_tile((it + 1) & 1, kb + kTileRows, false);  // the stage the previous tile used
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      float s[8][4];
      mma_logits<HD>(s, Qs, Ks + (it & 1) * kTileRows * kLd, warp, lane);
      float mx_lo = kNegInit, mx_hi = kNegInit;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kb + j * 8 + quad_col * 2 + e;
          s[j][e] *= P.scale;
          s[j][2 + e] *= P.scale;
          if (key < u.k1 && key <= pos_lo) mx_lo = fmaxf(mx_lo, s[j][e]);
          if (key < u.k1 && key <= pos_hi) mx_hi = fmaxf(mx_hi, s[j][2 + e]);
        }
      }
      const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
      const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
      float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kb + j * 8 + quad_col * 2 + e;
          ps_lo += (key < u.k1 && key <= pos_lo) ? expf(s[j][e] - mn_lo) : 0.f;
          ps_hi += (key < u.k1 && key <= pos_hi) ? expf(s[j][2 + e] - mn_hi) : 0.f;
        }
      }
      l_lo = l_lo * expf(m_lo - mn_lo) + ps_lo;
      l_hi = l_hi * expf(m_hi - mn_hi) + ps_hi;
      m_lo = mn_lo;
      m_hi = mn_hi;
    }
    __syncthreads();  // every warp is done with this stage before it is loaded again
  }
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  if (quad_col == 0) {
    stat[2 * r_lo] = m_lo;
    stat[2 * r_lo + 1] = l_lo;
    stat[2 * r_hi] = m_hi;
    stat[2 * r_hi + 1] = l_hi;
  }
  if (ntiles > 0) load_tile(0, u.k0, true);  // pass 2's first K/V tile, in flight across the barrier
  cluster.sync();  // every partner's local statistics are written
  merge_ranks<kTileRows, kThreads>(cluster, stat, all, gstat, splits);
  const float gm_lo = gstat[2 * r_lo], gl_lo = gstat[2 * r_lo + 1];
  const float gm_hi = gstat[2 * r_hi], gl_hi = gstat[2 * r_hi + 1];

  // pass 2: acc += bf16(exp(s - m) / l) . v
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int it = 0; it < ntiles; ++it) {
    const int kb = u.k0 + it * kTileRows;
    if (it + 1 < ntiles) {
      load_tile((it + 1) & 1, kb + kTileRows, true);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      float s[8][4];
      mma_logits<HD>(s, Qs, Ks + (it & 1) * kTileRows * kLd, warp, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kb + j * 8 + quad_col * 2 + e;
          s[j][e] = (key < u.k1 && key <= pos_lo) ? expf(s[j][e] * P.scale - gm_lo) / gl_lo : 0.f;
          s[j][2 + e] = (key < u.k1 && key <= pos_hi) ? expf(s[j][2 + e] * P.scale - gm_hi) / gl_hi : 0.f;
        }
      }
      const __nv_bfloat16* Vt = Vs + (it & 1) * kTileRows * kLd;
#pragma unroll
      for (int kk = 0; kk < kTileRows / 16; ++kk) {
        // the accumulator tiles of s are the A operand of p . v; pack_bf16 rounds p
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int nn = 0; nn < HD / 16; ++nn) {
          uint32_t b[4];  // keys kk * 16 .. + 15, head-dim tiles 2nn and 2nn + 1
          ldmatrix_x4_trans(b, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + nn * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * nn], pa, b[0], b[1]);
          mma_bf16(acc[2 * nn + 1], pa, b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }
  // the K/V stages are free (every warp is past the last tile): partial output [64][HD]
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    *reinterpret_cast<float2*>(part + r_lo * HD + n * 8 + quad_col * 2) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(part + r_hi * HD + n * 8 + quad_col * 2) = make_float2(acc[n][2], acc[n][3]);
  }
  cluster.sync();  // every partner's partial output is written
  reduce_out<HD>(cluster, P, u, part, rank, splits, kThreads);
  cluster.sync();  // partners are done reading this CTA's shared memory
}

// ---------------------------------------------------------------------------------------------
// Launch: grid (S, Hkv * row tiles, B), clusters of (S, 1, 1).

// The (kernel, device, cluster size, shared memory) whose one cluster the card was found to hold
// (cudaOccupancyMaxActiveClusters), so that a launch asks once.
struct ClusterFit {
  const void* kernel;
  int device, splits;
  size_t smem;
};
std::mutex g_fit_lock;
ClusterFit g_fits[64];
int g_nfits = 0;

// With `resident` set, nothing is launched: *resident gets how many such clusters the card
// holds at once.
template <typename Kernel>
cudaError_t launch_cluster(Kernel kernel, const Problem& P, int splits, int threads, size_t smem, int ntiles,
                           int B, cudaStream_t stream, int* resident) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (splits > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, P.Hkv * ntiles, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (resident != nullptr) return cudaOccupancyMaxActiveClusters(resident, kernel, &cfg);
  {
    std::lock_guard<std::mutex> hold(g_fit_lock);
    const void* key = reinterpret_cast<const void*>(kernel);
    int i = 0;
    while (i < g_nfits && !(g_fits[i].kernel == key && g_fits[i].device == device && g_fits[i].splits == splits &&
                            g_fits[i].smem == smem)) {
      ++i;
    }
    if (i == g_nfits) {
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (err != cudaSuccess) return err;
      if (clusters < 1) return cudaErrorLaunchOutOfResources;
      if (g_nfits < 64) g_fits[g_nfits++] = ClusterFit{key, device, splits, smem};
    }
  }
  err = cudaLaunchKernelEx(&cfg, kernel, P, splits);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_rows(const Problem& P, int B, int splits, cudaStream_t stream, int* resident) {
  const int rows = (P.Hq / P.Hkv) * P.T;
  const int ntiles = (rows + kTileRows - 1) / kTileRows;
  if (rows > kSmallRows) {
    return launch_cluster(attention_mma_kernel<HD>, P, splits, Mma<HD>::kThreads, Mma<HD>::kSmemBytes, ntiles, B,
                          stream, resident);
  }
  const int share = (P.C + splits - 1) / splits;  // the most keys a CTA's share can hold
#define LWT_SMALL(R_)                                                                                  \
  return launch_cluster(attention_small_kernel<HD, R_>, P, splits, Small<HD, R_>::kThreads,            \
                        Small<HD, R_>::smem_bytes(share), ntiles, B, stream, resident)
  if (rows <= 1) LWT_SMALL(1);
  if (rows <= 2) LWT_SMALL(2);
  LWT_SMALL(4);
#undef LWT_SMALL
}

cudaError_t dispatch(const Problem& P, int hd, int B, int splits, cudaStream_t stream, int* resident = nullptr) {
  switch (hd) {
    case 64: return launch_rows<64>(P, B, splits, stream, resident);
    case 128: return launch_rows<128>(P, B, splits, stream, resident);
    case 256: return launch_rows<256>(P, B, splits, stream, resident);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t (0 on success). k and v point at the layer's [Hkv, C, hd] block.
// Query row t sits at absolute position start + t and sees keys 0..start + t. `splits` CTAs
// (a cluster, 1..16) share each unit's live keys.
extern "C" int lwt_decode_attention(const void* q, const void* k, const void* v, void* out, int T,
                                    int Hq, int Hkv, int C, int hd, int start, int splits, float scale,
                                    void* stream_ptr) {
  if (T <= 0 || Hkv <= 0 || Hq % Hkv != 0 || start < 0 || (long long)start + T > C || splits < 1 ||
      splits > kMaxSplits) {
    return (int)cudaErrorInvalidValue;
  }
  const Problem P{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                  static_cast<const __nv_bfloat16*>(v), nullptr, static_cast<float*>(out),
                  T, Hq, Hkv, C, 1, 0, start, scale};
  return (int)dispatch(P, hd, 1, splits, static_cast<cudaStream_t>(stream_ptr));
}

// Returns a cudaError_t (0 on success). k_all and v_all are the whole [B, L, Hkv, C, hd]
// caches; pos is a device int32 [B]. Stream b's one query row sees its keys 0..pos[b] of
// layer `layer`, shared by `splits` CTAs (a cluster, 1..16).
extern "C" int lwt_decode_attention_batched(const void* q, const void* k_all, const void* v_all,
                                            const void* pos, void* out, int B, int Hq, int Hkv,
                                            int C, int L, int hd, int layer, int splits, float scale,
                                            void* stream_ptr) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hq % Hkv != 0 || C <= 0 || layer < 0 || layer >= L ||
      splits < 1 || splits > kMaxSplits) {
    return (int)cudaErrorInvalidValue;
  }
  const Problem P{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_all),
                  static_cast<const __nv_bfloat16*>(v_all), static_cast<const int*>(pos),
                  static_cast<float*>(out), 1, Hq, Hkv, C, L, layer, 0, scale};
  return (int)dispatch(P, hd, B, splits, static_cast<cudaStream_t>(stream_ptr));
}

// Returns a cudaError_t (0 on success); launches nothing. *clusters gets how many clusters of
// `splits` CTAs of the kernel that T query rows of Hq / Hkv heads over a cache of C slots take
// the card holds at once.
extern "C" int lwt_decode_attention_clusters(int T, int Hq, int Hkv, int C, int hd, int splits, int* clusters) {
  if (T <= 0 || Hkv <= 0 || Hq % Hkv != 0 || C <= 0 || splits < 1 || splits > kMaxSplits) {
    return (int)cudaErrorInvalidValue;
  }
  const Problem P{nullptr, nullptr, nullptr, nullptr, nullptr, T, Hq, Hkv, C, 1, 0, 0, 1.f};
  return (int)dispatch(P, hd, 1, splits, nullptr, clusters);
}
