// Flash decode for Hopper (sm_90a): single-token attention over ragged
// per-slot KV caches — the serving engine's attention, one call per layer
// per engine step.
//
// Replaces the TPU kernel `flash_decode_bhrd` / `_decode_kernel` in
// src/repro/kernels/flash_decode.py. It computes what that kernel
// computes, not with its block structure:
//
//   q (B, 1, H, hd), k (B, C, Hkv, hd), v (B, C, Hkv, vd), valid (B,) int32
//   out[b, 0, h, :] = softmax_j(scale * q[b,0,h] . k[b,j,h/rep])_{j<valid[b]}
//                     @ v[b, j, h/rep, :]          (rep = H / Hkv)
//   out = 0 exactly where valid[b] == 0; valid above C is clamped to C.
//
// As in the plain version, q * scale is rounded to q's dtype, scores and
// sums are f32, the probability (not only the logit) of a dead key is
// zero, the probabilities are rounded to v's dtype before the PV product
// while the denominator adds the unrounded ones, and the output has v's
// dtype.
//
// What bounds it: device memory. Each call reads the live prefix of the
// cache, valid[b] * Hkv * (hd + vd) elements per slot, once; it does
// about 2 * rep flops per element read, far below the ~295 flops per byte
// at which an H100 stops being memory bound. So the design is about
// bytes: read each live K/V byte once, for all rep query heads of its kv
// head, keep enough of them in flight on every SM, and read no dead row.
// Two variants, which the wrapper's plan picks by dtype and shape:
//
//   * tma_mma (bf16 q and cache, hd and vd multiples of 16 up to 128,
//     rep <= 16: every decoding config in bf16). The work is the list of
//     live (slot, chunk, kv head) items: a chunk is `chunk` cache rows (a
//     multiple of the 64-key tile), and slot b has ceil(valid[b] / chunk)
//     live chunks. The host fixes chunk and the grid (one block per SM at
//     most) from C, B and the SM count and never reads valid: every block
//     reads valid[0..B) itself, forms the list, and walks it with stride
//     gridDim.x, so the live work is spread over the SMs whatever the
//     lengths, and a dead chunk is never read, written or counted.
//     One producer thread keeps TMA loads of 64-key K and V tiles, with
//     the item's q rows, in a ring of 4-8 stages with full/empty
//     mbarriers (4-D tensor maps (d, heads, C, B), 64-column boxes,
//     128-byte swizzle; rows past C read as zeros inside the slot; the
//     cache is loaded evict-first, since each byte is read once), running
//     ahead across items; the tile loop has no __syncthreads. Two groups
//     of four consumer warps take turns on the tiles, a warp 16 keys of
//     each: the rep query heads of the kv head, padded to 16 rows, stay in
//     registers as mma.sync m16n8k16 A fragments for the item; K^T comes
//     by ldmatrix from the swizzled tile, V by ldmatrix.trans; the online
//     softmax runs in registers (row max over the quad), and P, rounded
//     to bf16, is the A fragment of P.V straight from the S accumulators.
//     mma.sync and not wgmma: wgmma's 64-row M would be >= 87% padding at
//     every decoding rep, and the tensor cores are not what bounds the
//     kernel. Rows at or past valid in a slot's last tile get probability
//     0 and their V elements are zeroed in the fragment, so NaN or Inf
//     there adds nothing (0 * NaN is NaN). The eight warps' partial sums
//     are merged in shared memory into one partial per item.
//     One call is one kernel. A slot with one live chunk writes its
//     output from that merge; otherwise the item's partial goes to the
//     workspace, and after its last item each block counts its items into
//     an atomic count per (slot, kv head): the block that completes a
//     count merges that group's partials in chunk order (the bits do not
//     depend on which block came last) and resets the count. No consumer
//     waits on device memory inside the item loop: with a deep ring in
//     flight on every SM, one round trip (a q load, a fence before a
//     count) queues behind megabytes of loads, several microseconds. Each
//     item carries a fixed cost (its merge, one more partial for the
//     final merge), so chunks are long: a quarter of the cache, unless
//     that leaves SMs without an item. The workspace and the counts are
//     the caller's, kept between calls, so two calls on two streams at
//     once are not supported.
//   * fma (f32 q or cache, and any shape tma_mma does not take): the
//     first design. Split-K over the cache axis by capacity: one block
//     per (chunk, kv head group of 8, slot), CUDA-core FMA on 16-byte
//     loads (the score pass one key per thread, the PV pass 16 bytes of
//     columns per thread over a strided subset of the rows), chunks past
//     valid read nothing, and a second kernel combines the chunks.
//
// Plain C interface, loaded with ctypes by repro_torch/kernels/build.py;
// launches on the caller's stream and returns cudaGetLastError().
// cuTensorMapEncodeTiled is reached through the runtime's driver entry
// point, so nothing links libcuda. Every mbarrier wait is bounded: a wait
// that fails ~2^26 times traps, so a protocol bug surfaces as a CUDA
// error at the next synchronize and not as a hung card.

#include <atomic>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// variant codes of the C interface (= the wrapper's _VARIANTS)
enum Variant { kFma = 0, kTmaMma = 1 };

// ---------------------------------------------------------------------------
// fma: the first design (CUDA-core FMA, split-K by capacity)
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;   // threads per block of the split pass
constexpr int kTile = kThreads; // keys per tile: one key per thread
constexpr int kMaxRep = 8;      // query heads of one kv head per block
constexpr int kBatch = 8;      // 16-byte loads a thread issues before using them
constexpr float kNegInf = -1e30f;  // = repro_torch.kernels.common.NEG_INF

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as .to(bfloat16)
}

// x rounded to T and widened back
template <typename T> __device__ __forceinline__ float round_as(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// 16-byte read-only load, and its V elements of T widened to f32
__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T, int V>
__device__ __forceinline__ void widen(const uint4& raw, float (&out)[V]) {
  static_assert(V * sizeof(T) == 16, "16-byte vectors");
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_f32<T>(e[i]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ inline int q_stride(int hd) { return (hd + 3) & ~3; }

// dynamic shared memory of the split pass, in floats
__host__ __device__ inline int split_smem_floats(int hd, int vd, int vec) {
  const int nrg = kThreads / (vd / vec);   // row groups of the PV pass
  return kMaxRep * q_stride(hd)            // scaled q rows
         + kMaxRep * kTile                 // scores, then probabilities
         + 3 * kMaxRep                     // running max, sum, rescale
         + nrg * kMaxRep * vd;             // PV partials per row group
}

// Split pass. Grid (nsplit, Hkv * ngroups, B); block kThreads.
// Block (split, kv head * ngroups + group, b) covers cache rows
// [split*chunk, min((split+1)*chunk, valid[b])) for query heads
// kv*rep + group*kMaxRep + [0, nr), and writes their unnormalised
// accumulators and (running max, sum) to the workspace.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, const int* __restrict__ valid_len,
                    float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                    int H, int Hkv, int C, int hd, int vd, int chunk,
                    int nsplit, float scale) {
  constexpr int V = 16 / sizeof(TKV);  // elements per 16-byte vector
  extern __shared__ __align__(16) float smem[];

  const int rep = H / Hkv;
  const int ngroups = (rep + kMaxRep - 1) / kMaxRep;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y / ngroups;
  const int r0 = (blockIdx.y % ngroups) * kMaxRep;
  const int nr = min(kMaxRep, rep - r0);
  const int h0 = kvh * rep + r0;  // first query head of this block
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  const int hdp = q_stride(hd);
  float* q_s = smem;                    // [kMaxRep][hdp]
  float* s_s = q_s + kMaxRep * hdp;     // [kMaxRep][kTile]
  float* m_s = s_s + kMaxRep * kTile;   // [kMaxRep]
  float* l_s = m_s + kMaxRep;           // [kMaxRep]
  float* a_s = l_s + kMaxRep;           // [kMaxRep]
  float* red = a_s + kMaxRep;           // [nrg][kMaxRep][vd]

  // q * scale, rounded to q's dtype as the plain version's `q * scale`
  for (int i = tid; i < kMaxRep * hdp; i += kThreads) {
    const int r = i / hdp, d = i % hdp;
    float x = 0.f;
    if (r < nr && d < hd)
      x = round_as<TQ>(to_f32<TQ>(q[((long)b * H + h0 + r) * hd + d]) * scale);
    q_s[i] = x;
  }
  if (tid < kMaxRep) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    a_s[tid] = 1.f;
  }
  __syncthreads();

  const int valid = max(0, min(valid_len[b], C));
  const int c0 = split * chunk;
  const int c1 = min(c0 + chunk, valid);  // live rows of this split
  const long krow = (long)Hkv * hd;       // element stride between cache rows
  const long vrow = (long)Hkv * vd;
  const TKV* kb = k + (long)b * C * krow + (long)kvh * hd;
  const TKV* vb = v + (long)b * C * vrow + (long)kvh * vd;

  // PV mapping: thread = (row group g, column vector cg)
  const int ncg = vd / V;
  const int nrg = kThreads / ncg;
  const int cg = tid % ncg, g = tid / ncg;
  float acc[kMaxRep][V];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[r][e] = 0.f;

  for (int t0 = c0; t0 < c1; t0 += kTile) {
    const int n = min(kTile, c1 - t0);

    // 1. scores: thread tid owns key t0 + tid
    float s[kMaxRep];
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) s[r] = 0.f;
    if (tid < n) {
      const TKV* kr = kb + (long)(t0 + tid) * krow;
      for (int d0 = 0; d0 < hd; d0 += kBatch * V) {
        uint4 raw[kBatch];  // a batch of loads in flight before any math
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (d0 + u * V < hd) raw[u] = ldg16(kr + d0 + u * V);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int d = d0 + u * V;
          if (d < hd) {
            float kf[V];
            widen<TKV, V>(raw[u], kf);
#pragma unroll
            for (int r = 0; r < kMaxRep; ++r) {
              if (r < nr) {
#pragma unroll
                for (int e = 0; e < V; e += 4) {
                  const float4 qv =
                      *reinterpret_cast<const float4*>(q_s + r * hdp + d + e);
                  s[r] += qv.x * kf[e] + qv.y * kf[e + 1] + qv.z * kf[e + 2] +
                          qv.w * kf[e + 3];
                }
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) s_s[r * kTile + tid] = tid < n ? s[r] : kNegInf;
    __syncthreads();

    // 2. online softmax, one warp per query head: the probability of a
    //    dead key is zero (not only its logit NEG_INF)
    for (int r = warp; r < nr; r += kThreads / 32) {
      float* sr = s_s + r * kTile;
      float x[kTile / 32];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < kTile / 32; ++i) {
        x[i] = sr[lane + 32 * i];
        mx = fmaxf(mx, x[i]);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kTile / 32; ++i) {
        const int j = lane + 32 * i;
        const float p = j < n ? expf(x[i] - m_new) : 0.f;
        sum += p;
        sr[j] = round_as<TKV>(p);  // probabilities in v's dtype
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * alpha + p @ v over this tile
    if (g < nrg) {
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        const float al = a_s[r];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[r][e] *= al;
      }
      const TKV* vc = vb + cg * V;
      for (int j0 = g; j0 < n; j0 += kBatch * nrg) {
        uint4 raw[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int j = j0 + u * nrg;
          if (j < n) raw[u] = ldg16(vc + (long)(t0 + j) * vrow);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int j = j0 + u * nrg;
          if (j < n) {
            float vf[V];
            widen<TKV, V>(raw[u], vf);
#pragma unroll
            for (int r = 0; r < kMaxRep; ++r) {
              if (r < nr) {
                const float p = s_s[r * kTile + j];
#pragma unroll
                for (int e = 0; e < V; ++e) acc[r][e] += p * vf[e];
              }
            }
          }
        }
      }
    }
    __syncthreads();  // s_s is rewritten by the next tile's scores
  }

  // reduce the row groups' partial accumulators (fixed order) and write
  if (g < nrg) {
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r)
      if (r < nr)
#pragma unroll
        for (int e = 0; e < V; ++e) red[(g * kMaxRep + r) * vd + cg * V + e] = acc[r][e];
  }
  __syncthreads();
  const long ws_row = (long)b * H + h0;  // (b, h0) row of the workspace
  for (int i = tid; i < nr * vd; i += kThreads) {
    const int r = i / vd, col = i % vd;
    float o = 0.f;
    for (int gg = 0; gg < nrg; ++gg) o += red[(gg * kMaxRep + r) * vd + col];
    ws_acc[((ws_row + r) * nsplit + split) * vd + col] = o;
  }
  if (tid < nr) {
    float* ml = ws_ml + ((ws_row + tid) * nsplit + split) * 2;
    ml[0] = m_s[tid];
    ml[1] = l_s[tid];
  }
}

// Combine pass. Grid (B * H); block kThreads. Merges the splits' partial
// softmax sums of one (b, h) row; a row with no live key gives zeros.
template <typename TO>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ ws_acc,
                      const float* __restrict__ ws_ml, TO* __restrict__ out,
                      int vd, int nsplit) {
  const long bh = blockIdx.x;
  const float* ml = ws_ml + bh * nsplit * 2;
  float m = kNegInf;
  for (int s = 0; s < nsplit; ++s)
    if (ml[2 * s + 1] > 0.f) m = fmaxf(m, ml[2 * s]);
  float l = 0.f;
  for (int s = 0; s < nsplit; ++s)
    if (ml[2 * s + 1] > 0.f) l += ml[2 * s + 1] * expf(ml[2 * s] - m);
  for (int col = threadIdx.x; col < vd; col += blockDim.x) {
    float o = 0.f;
    for (int s = 0; s < nsplit; ++s)
      if (ml[2 * s + 1] > 0.f)
        o += ws_acc[(bh * nsplit + s) * vd + col] * expf(ml[2 * s] - m);
    out[bh * vd + col] = from_f32<TO>(l > 0.f ? o / fmaxf(l, 1e-30f) : 0.f);
  }
}

// ---------------------------------------------------------------------------
// tma_mma: bf16 q and cache; TMA ring, mma.sync, live chunks spread on the
// device
// ---------------------------------------------------------------------------

namespace mm {
using bf16 = __nv_bfloat16;
constexpr int TILE = 64;                    // keys per ring stage
constexpr int GROUP = 4;                    // warps of a consumer group: 16 keys of a tile each
constexpr int WARPS = 2 * GROUP;            // two groups take turns on the tiles
constexpr int THREADS = 32 * (WARPS + 1);   // + the producer warp
constexpr int BOX = TILE * 128;             // one 64-key x 64-column box (8 KB)
constexpr int QBOX = 16 * 128;              // 16 query heads x 64 columns (2 KB)
constexpr int MAX_STAGES = 8;

// ring bytes of one stage: the K boxes, the V boxes, then the q boxes of
// the tile's item
__host__ __device__ inline int stage_bytes(int hdp, int vdp) {
  return (hdp + vdp) / 64 * BOX + hdp / 64 * QBOX;
}
// rows of the warps' partials that the merge keeps: a thread holds query
// rows g and g + 8 of the m16 tile, and rows past rep are padding
__host__ __device__ inline int merge_rows(int rep) { return rep <= 8 ? 8 : 16; }
constexpr int MO_PAD = 8;       // floats after each row of a warp's partial O
constexpr int FAC = WARPS + 2;  // floats of merge factors per query head
// dynamic shared memory: 1 KB of alignment slack, the ring, the warps'
// partial sums (O rows padded against bank conflicts, then m and l), the
// merge factors of 16 query heads, full and empty barriers, the slots'
// clamped lengths, the exclusive prefix of their live chunks and the
// length of the block's list of groups to merge
__host__ __device__ inline int smem_bytes(int hdp, int vdp, int rep, int stages, int B) {
  return 1024 + stages * stage_bytes(hdp, vdp) +
         WARPS * merge_rows(rep) * (vdp + MO_PAD + 2) * 4 + 16 * FAC * 4 + 2 * stages * 8 +
         (2 * B + 2) * 4;
}
}  // namespace mm

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// waits until the phase of `bar` with this parity has completed; traps
// after ~2^26 failed tries instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// L2 policy of the cache's TMA loads: evict first (each byte is read once
// per call), so that the stream does not push the chunks' partials out of
// L2 before the merge reads them back (the value CUTLASS's
// CacheHintSm90::EVICT_FIRST encodes)
constexpr uint64_t kEvictFirst = 0x12F0000000000000ull;
constexpr uint64_t kEvictNormal = 0x1000000000000000ull;

// one 4-D TMA box (coordinates: column, head, row, slot) into shared
// memory with L2 policy `hint`; the bytes land on `bar`'s transaction count
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int head, int row, int slot,
                                            uint64_t hint) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(slot),
      "l"(hint)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// four 8x8 b16 matrices from shared memory, one per 8 lanes' row
// addresses; `trans` gives each thread the transposed elements
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a (16x16, row) * b (16x8, col); fragment layouts of the PTX ISA:
// a: {r g, c 2t..}, {r g+8, c 2t..}, {r g, c 2t+8..}, {r g+8, c 2t+8..}
// b: {k 2t.., n g}, {k 2t+8.., n g};  d: {r g, c 2t, 2t+1}, {r g+8, ...}
// with g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// address of 16-byte chunk `chunk` of row `row` in a 128-byte-swizzled
// box at `box` (1 KB aligned): chunk k of row r sits at chunk k ^ (r % 8)
__device__ __forceinline__ uint32_t swz(uint32_t box, int row, int chunk) {
  return box + row * 128 + ((chunk ^ (row & 7)) << 4);
}

// keeps the low (high) bf16 half of `x` only if key `key` (`key` + 1) is
// below `n`
__device__ __forceinline__ uint32_t keep_keys(uint32_t x, int key, int n) {
  return x & ((key < n ? 0x0000FFFFu : 0u) | (key + 1 < n ? 0xFFFF0000u : 0u));
}

// One work item: kv head `kvh` of slot `b` over cache rows [c0, c1), chunk
// `c` of the slot. Item `it` of the live list is (j, kvh) with j = it /
// Hkv the j-th live (slot, chunk) pair in slot order; prefix[b] counts
// the live chunks of the slots before b (= live_chunks in the wrapper).
struct Item {
  int b, kvh, c, c0, c1;
};
__device__ __forceinline__ Item item_at(int it, const int* prefix, const int* vlen, int B,
                                        int Hkv, int chunk) {
  Item x;
  x.kvh = it % Hkv;
  const int j = it / Hkv;
  int lo = 0, hi = B - 1;  // the last slot whose prefix is <= j has a chunk j
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (prefix[mid] <= j) lo = mid; else hi = mid - 1;
  }
  x.b = lo;
  x.c = j - prefix[lo];
  x.c0 = x.c * chunk;
  x.c1 = min(x.c0 + chunk, vlen[lo]);
  return x;
}

// Merges, for each of the `groups` (slot, kv head) items listed in
// `mine`, the partials of its slot's n live chunks (workspace rows (b * H
// + h) * nchunk + c) in chunk order and writes the group's rep output
// rows; run by the consumer warps together, a thread per 4 columns of a
// row (a warp's loads of one chunk are 512 contiguous bytes). Each thread
// issues the loads of 16 chunks (their max and sum, and its 4 columns)
// before it uses any of them, and folds them into a running max, sum and
// output: a group of up to 16 chunks costs one round trip to memory. The
// partials were written by other blocks: they are read from L2 (ld.cg),
// never from a stale L1.
__device__ __forceinline__ void combine_groups(const float* ws_acc, const float* ws_ml,
                                               mm::bf16* out, const int* mine, int groups,
                                               const int* prefix, const int* vlen, int B, int H,
                                               int Hkv, int vd, int chunk, int nchunk, int tid) {
  using namespace mm;
  const int rep = H / Hkv, nc = vd / 4;   // nc: 4-column groups of a row
  for (int i = tid; i < groups * rep * nc; i += 32 * WARPS) {
    const int pr = i / nc, col = 4 * (i % nc);
    const Item x = item_at(mine[pr / rep], prefix, vlen, B, Hkv, chunk);
    const int n = prefix[x.b + 1] - prefix[x.b];
    const long row = (long)x.b * H + x.kvh * rep + pr % rep;
    const float2* ml = reinterpret_cast<const float2*>(ws_ml) + row * nchunk;
    const float4* acc = reinterpret_cast<const float4*>(ws_acc + row * nchunk * vd + col);
    float mx = -CUDART_INF_F, sum = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = 0; c0 < n; c0 += 16) {
      float2 v[16];
      float4 a[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const bool live = c0 + u < n;
        v[u] = live ? __ldcg(ml + c0 + u) : make_float2(-CUDART_INF_F, 0.f);
        a[u] = live ? __ldcg(acc + (long)(c0 + u) * nc) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float bm = mx;
#pragma unroll
      for (int u = 0; u < 16; ++u) bm = fmaxf(bm, v[u].x);
      const float s0 = __expf(mx - bm);   // 0 while mx = -inf
      sum *= s0;
      o.x *= s0;
      o.y *= s0;
      o.z *= s0;
      o.w *= s0;
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const float e = __expf(v[u].x - bm);   // 0 past n
        sum += v[u].y * e;
        o.x += a[u].x * e;
        o.y += a[u].y * e;
        o.z += a[u].z * e;
        o.w += a[u].w * e;
      }
      mx = bm;
    }
    const float inv = 1.f / sum;
    *reinterpret_cast<uint2*>(out + row * vd + col) =
        make_uint2(pack_bf16(o.x * inv, o.y * inv), pack_bf16(o.z * inv, o.w * inv));
  }
}

// Grid: at most one block per SM (the ring takes most of its shared
// memory); block mm::THREADS: warps 0-7 consume (group 0 = warps 0-3 takes
// the block's even tiles, group 1 the odd ones), lane 0 of warp 8 loads.
// Per live item, the eight warps' partials are merged in shared memory;
// a slot with one live chunk writes its output rows from there, else the
// item's unnormalised accumulator and (max, sum) per query head go to the
// workspace rows (b * H + h) * nchunk + c. No consumer waits on device
// memory inside the item loop: q arrives by TMA with every tile, and
// partials are stored without a fence. After its last item the block
// fences once and counts each of its items into an atomic count per
// (slot, kv head); the block that brings a count to the slot's live
// chunks merges that group's partials into the output and resets the
// count to 0 for the next call. Slots with valid == 0 get zeros from
// block b % grid.
template <int HD, int VD>
__global__ void __launch_bounds__(mm::THREADS, 1)
decode_mma_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ valid_len,
                  mm::bf16* __restrict__ out, float* __restrict__ ws_acc,
                  float* __restrict__ ws_ml, int* __restrict__ counters, int B, int H, int Hkv,
                  int C, int vd, int chunk, int nchunk, int stages, float scale) {
  using namespace mm;
  constexpr int NBK = HD / 64, NBV = VD / 64;  // 64-column boxes of a K / V row
  constexpr int KV_BYTES = (NBK + NBV) * BOX;
  constexpr int STAGE = KV_BYTES + NBK * QBOX;
  constexpr int KT = HD / 16;                  // k-steps of q.K^T
  constexpr int NT = VD / 8;                   // 8-column tiles of the output
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023) & ~1023u;
  unsigned char* ring_ptr = smem_raw + (ring - smem_addr(smem_raw));
  const int rep = H / Hkv, mr = merge_rows(rep);
  constexpr int MO = VD + MO_PAD;                                    // row stride of mo
  float* mo = reinterpret_cast<float*>(ring_ptr + stages * STAGE);  // [WARPS][mr][MO]
  float* mml = mo + WARPS * mr * MO;                                 // [WARPS][mr][2]
  float* fac = mml + WARPS * mr * 2;                                 // [16][FAC]
  const uint32_t full0 = smem_addr(fac + 16 * FAC), empty0 = full0 + 8 * stages;
  int* vlen = reinterpret_cast<int*>(fac + 16 * FAC + 4 * stages);   // [B]
  int* prefix = vlen + B;                                                  // [B + 1]
  int* n_mine = prefix + B + 1;      // groups this block merges, listed in mo
  int* mine = reinterpret_cast<int*>(mo);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the live list: clamped lengths and the exclusive prefix of live chunks
  if (warp == 0) {
    int carry = 0;
    for (int b0 = 0; b0 < B; b0 += 32) {
      const int b = b0 + lane;
      const int v = b < B ? max(0, min(valid_len[b], C)) : 0;
      const int n = (v + chunk - 1) / chunk;
      int x = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (b < B) {
        vlen[b] = v;
        prefix[b] = carry + x - n;
      }
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) {
      prefix[B] = carry;
      *n_mine = 0;
    }
  } else if (tid == 32 * WARPS) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);         // the producer's expect_tx
      mbar_init(empty0 + 8 * s, GROUP);    // one arrival per warp of the tile's group
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int items = prefix[B] * Hkv;

  if (warp == WARPS) {  // producer: one thread walks the consumers' sequence of tiles
    if (lane != 0) return;
    int g = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const Item x = item_at(it, prefix, vlen, B, Hkv, chunk);
      for (int r0 = x.c0; r0 < x.c1; r0 += TILE, ++g) {
        const int s = g % stages;
        if (g >= stages) mbar_wait(empty0 + 8 * s, (g / stages - 1) & 1);
        const uint32_t bar = full0 + 8 * s, st = ring + s * STAGE;
        mbar_expect_tx(bar, STAGE);
#pragma unroll
        for (int i = 0; i < NBK; ++i)
          tma_load_4d(st + i * BOX, &tm_k, bar, 64 * i, x.kvh, r0, x.b, kEvictFirst);
#pragma unroll
        for (int i = 0; i < NBV; ++i)
          tma_load_4d(st + (NBK + i) * BOX, &tm_v, bar, 64 * i, x.kvh, r0, x.b, kEvictFirst);
        // the item's q rows, heads kvh * rep .. + 15 of slot b, with every
        // tile: each group reads them with the first tile it takes
#pragma unroll
        for (int i = 0; i < NBK; ++i)
            tma_load_4d(st + KV_BYTES + i * QBOX, &tm_q, bar, 64 * i, x.kvh * rep, 0, x.b,
                        kEvictNormal);
      }
    }
    return;
  }

  // slots with no live key: exact zeros
  for (int b = blockIdx.x; b < B; b += gridDim.x)
    if (vlen[b] == 0)
      for (int i = tid; i < H * vd; i += 32 * WARPS) out[(long)b * H * vd + i] = __float2bfloat16(0.f);

  const int g4 = lane / 4, t4 = lane % 4;
  // group cg takes the block's tiles g with g % 2 == cg; warp kw of the
  // group takes keys 16 kw .. 16 kw + 15 of each
  const int cg = warp / GROUP, kw = warp % GROUP;
  // ldmatrix row of this lane: in the q tile (A fragments), and in its
  // warp's 16 keys for K (plain) and V (transposed) fragments
  const int qrow = lane % 16, qchunk = lane / 16;
  const int krow = 16 * kw + lane % 8 + (lane / 16) * 8, kchunk = (lane / 8) % 2;
  const int vrow = 16 * kw + lane % 8 + ((lane / 8) % 2) * 8, vchunk = lane / 16;
  int g = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const Item x = item_at(it, prefix, vlen, B, Hkv, chunk);
    const int h0 = x.kvh * rep;
    uint32_t qf[KT][4];
    float o[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

    bool first = true;   // the next tile this group takes is its first of the item
    for (int r0 = x.c0; r0 < x.c1; r0 += TILE, ++g) {
      if ((g & 1) != cg) continue;
      const int s = g % stages;
      mbar_wait(full0 + 8 * s, (g / stages) & 1);
      const uint32_t ks = ring + s * STAGE, vs = ks + NBK * BOX;
      if (first) {
        first = false;
        // q * scale of the kv head's rep query heads, rounded to bf16, as
        // A fragments for the item (rows past rep are other heads: zero)
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          ldsm_x4(qf[kt], swz(ks + KV_BYTES + (kt / 4) * QBOX, qrow, (kt % 4) * 2 + qchunk));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const __nv_bfloat162 qq = *reinterpret_cast<const __nv_bfloat162*>(&qf[kt][e]);
            qf[kt][e] = g4 + (e & 1) * 8 < rep
                            ? pack_bf16(__bfloat162float(qq.x) * scale,
                                        __bfloat162float(qq.y) * scale)
                            : 0u;
          }
        }
      }
      const int nl = min(16, x.c1 - r0 - 16 * kw);   // live keys of this warp's 16
      if (nl > 0) {
        // every fragment is loaded before the products use it, and even
        // and odd k-steps sum into separate accumulators: two short
        // dependency chains instead of one long one
        uint32_t kf[KT][4];
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
          ldsm_x4(kf[kt], swz(ks + (kt / 4) * BOX, krow, (kt % 4) * 2 + kchunk));
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float sc2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kt = 0; kt < KT; kt += 2) {
          mma_bf16(sc[0], qf[kt], kf[kt][0], kf[kt][1]);
          mma_bf16(sc[1], qf[kt], kf[kt][2], kf[kt][3]);
          mma_bf16(sc2[0], qf[kt + 1], kf[kt + 1][0], kf[kt + 1][1]);
          mma_bf16(sc2[1], qf[kt + 1], kf[kt + 1][2], kf[kt + 1][3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] += sc2[j][e];
        if (nl < 16) {   // dead keys: probability exactly 0, whatever K held
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (8 * j + 2 * t4 + (e & 1) >= nl) sc[j][e] = -CUDART_INF_F;
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = fmaxf(fmaxf(sc[0][2 * r], sc[0][2 * r + 1]),
                           fmaxf(sc[1][2 * r], sc[1][2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[r], mx);
          alpha[r] = __expf(m[r] - m_new);   // 0 while m = -inf
          m[r] = m_new;
          l[r] *= alpha[r];
        }
        uint32_t pf[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p0 = __expf(sc[j][0] - m[0]), p1 = __expf(sc[j][1] - m[0]);
          const float p2 = __expf(sc[j][2] - m[1]), p3 = __expf(sc[j][3] - m[1]);
          l[0] += p0 + p1;   // the sum adds the unrounded probabilities
          l[1] += p2 + p3;
          pf[2 * j] = pack_bf16(p0, p1);
          pf[2 * j + 1] = pack_bf16(p2, p3);
        }
        uint32_t vf[NT / 2][4];
#pragma unroll
        for (int np = 0; np < NT / 2; ++np)
          ldsm_x4_trans(vf[np], swz(vs + (np / 4) * BOX, vrow, (np % 4) * 2 + vchunk));
        if (alpha[0] != 1.f || alpha[1] != 1.f) {   // the running max moved
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            o[nt][0] *= alpha[0];
            o[nt][1] *= alpha[0];
            o[nt][2] *= alpha[1];
            o[nt][3] *= alpha[1];
          }
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          if (nl < 16) {   // dead rows of V add nothing, even NaN or Inf
            vf[np][0] = keep_keys(vf[np][0], 2 * t4, nl);
            vf[np][1] = keep_keys(vf[np][1], 2 * t4 + 8, nl);
            vf[np][2] = keep_keys(vf[np][2], 2 * t4, nl);
            vf[np][3] = keep_keys(vf[np][3], 2 * t4 + 8, nl);
          }
          mma_bf16(o[2 * np], pf, vf[np][0], vf[np][1]);
          mma_bf16(o[2 * np + 1], pf, vf[np][2], vf[np][3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    // merge the eight warps' partials of this item in shared memory
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = g4 + 8 * r;
      if (row < mr) {
        float* dst = mo + (warp * mr + row) * MO + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          *reinterpret_cast<float2*>(dst + 8 * nt) = make_float2(o[nt][2 * r], o[nt][2 * r + 1]);
        if (t4 == 0) {
          mml[(warp * mr + row) * 2] = m[r];
          mml[(warp * mr + row) * 2 + 1] = l[r];
        }
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * WARPS) : "memory");
    if (tid < rep) {   // per query head: the max, each warp's weight, the sum
      float mx = -CUDART_INF_F, sum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        if (mml[(w * mr + tid) * 2 + 1] > 0.f) mx = fmaxf(mx, mml[(w * mr + tid) * 2]);
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float lw = mml[(w * mr + tid) * 2 + 1];
        const float e = lw > 0.f ? __expf(mml[(w * mr + tid) * 2] - mx) : 0.f;
        fac[tid * FAC + w] = e;
        sum += lw * e;
      }
      fac[tid * FAC + WARPS] = mx;
      fac[tid * FAC + WARPS + 1] = sum;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * WARPS) : "memory");
    const int n = prefix[x.b + 1] - prefix[x.b];               // live chunks of the slot
    const long ws_row = ((long)x.b * H + h0) * nchunk + x.c;   // (b, h0, c); + r * nchunk
    const int nc = vd / 4;                                     // 4-column groups of a row
    for (int i = tid; i < rep * nc; i += 32 * WARPS) {
      const int r = i / nc, col = 4 * (i % nc);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float e = fac[r * FAC + w];
        const float4 a = *reinterpret_cast<const float4*>(mo + (w * mr + r) * MO + col);
        acc.x += a.x * e;
        acc.y += a.y * e;
        acc.z += a.z * e;
        acc.w += a.w * e;
      }
      if (n == 1) {   // the slot's only chunk: its output rows
        const float inv = 1.f / fac[r * FAC + WARPS + 1];
        *reinterpret_cast<uint2*>(out + ((long)x.b * H + h0 + r) * vd + col) =
            make_uint2(pack_bf16(acc.x * inv, acc.y * inv), pack_bf16(acc.z * inv, acc.w * inv));
        continue;
      }
      *reinterpret_cast<float4*>(ws_acc + (ws_row + (long)r * nchunk) * vd + col) = acc;
      if (col == 0)
        *reinterpret_cast<float2*>(ws_ml + (ws_row + (long)r * nchunk) * 2) =
            make_float2(fac[r * FAC + WARPS], fac[r * FAC + WARPS + 1]);
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * WARPS) : "memory");   // the merge buffer is reused
  }

  // count this block's items in, 128 at a time; merge the groups whose
  // last chunk this block counted
  __threadfence();   // this thread's partials are visible before any count moves
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * WARPS) : "memory");
  for (int first = blockIdx.x; first < items; first += 32 * WARPS * gridDim.x) {
    const int it = first + tid * gridDim.x;
    if (it < items) {
      const Item x = item_at(it, prefix, vlen, B, Hkv, chunk);
      const int n = prefix[x.b + 1] - prefix[x.b];
      int* count = counters + x.b * Hkv + x.kvh;
      if (n > 1 && atomicAdd(count, 1) == n - 1) {
        *count = 0;   // every chunk is in: ready for the next call
        mine[atomicAdd(n_mine, 1)] = it;
      }
    }
    __threadfence();   // the partials of the other blocks, read below
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * WARPS) : "memory");
    if (*n_mine > 0)
      combine_groups(ws_acc, ws_ml, out, mine, *n_mine, prefix, vlen, B, H, Hkv, vd, chunk,
                     nchunk, tid);
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * WARPS) : "memory");
    if (tid == 0) *n_mine = 0;
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * WARPS) : "memory");
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename TQ, typename TKV>
cudaError_t launch_fma(const void* q, const void* k, const void* v, const int* valid_len,
                       void* out, float* ws_acc, float* ws_ml, int B, int H, int Hkv, int C,
                       int hd, int vd, int chunk, int nsplit, float scale, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(TKV);
  const int rep = H / Hkv;
  const int ngroups = (rep + kMaxRep - 1) / kMaxRep;
  const size_t smem = sizeof(float) * split_smem_floats(hd, vd, V);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<TQ, TKV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(nsplit, Hkv * ngroups, B);
  decode_split_kernel<TQ, TKV><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), valid_len, ws_acc, ws_ml, H, Hkv, C, hd, vd,
      chunk, nsplit, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<TKV><<<B * H, kThreads, 0, stream>>>(
      ws_acc, ws_ml, static_cast<TKV*>(out), vd, nsplit);
  return cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// TMA map of a contiguous bf16 tensor (B, C, heads, d): dims (d, heads,
// C, B), boxes of 64 columns x `heads_box` heads x `rows_box` rows of one
// slot, 128-byte swizzled; boxes past C, the heads or d read as zeros, so
// a cache tile never reaches the next slot's rows
bool bf16_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int d, int heads, int C,
              int B, int heads_box, int rows_box) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)C, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)C * heads * d * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)heads_box, (cuuint32_t)rows_box, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// lets `kernel` take `bytes` of dynamic shared memory on the current
// device; bit d of `done` (one mask per kernel) records device d, so the
// attribute is set once per device and not at every launch
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (bytes <= 48 * 1024 || (done.load() & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int HD, int VD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const int* valid_len,
                       void* out, float* ws_acc, float* ws_ml, int* counters, int B, int H,
                       int Hkv, int C, int hd, int vd, int chunk, int nchunk, int grid,
                       int stages, float scale, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  CUtensorMap m_q, m_k, m_v;   // q (B, 1, H, hd): 16 heads a box
  if (!bf16_map(encode, &m_q, q, hd, H, 1, B, 16, 1) ||
      !bf16_map(encode, &m_k, k, hd, Hkv, C, B, 1, mm::TILE) ||
      !bf16_map(encode, &m_v, v, vd, Hkv, C, B, 1, mm::TILE))
    return cudaErrorInvalidValue;
  auto kernel = decode_mma_kernel<HD, VD>;
  static std::atomic<unsigned long long> done{0};
  const int smem = mm::smem_bytes(HD, VD, H / Hkv, stages, B);
  cudaError_t err = allow_smem(kernel, 227 * 1024, done);   // the most a block may take
  if (err != cudaSuccess) return err;
  kernel<<<grid, mm::THREADS, smem, stream>>>(m_q, m_k, m_v, valid_len,
                                               static_cast<mm::bf16*>(out), ws_acc, ws_ml,
                                               counters, B, H, Hkv, C, vd, chunk, nchunk, stages,
                                               scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block of `variant` (0 fma, 1 tma_mma) needs:
// fma at head dims hd, vd and cache dtype kv_bf16; tma_mma at hd, vd
// (padded to 64 or 128), rep query heads per kv head, `stages` ring
// stages and B slots. -1 for an unknown variant.
int flash_decode_smem_bytes(int variant, int hd, int vd, int kv_bf16, int rep, int stages,
                            int B) {
  if (variant == kFma) return (int)sizeof(float) * split_smem_floats(hd, vd, kv_bf16 ? 8 : 4);
  if (variant == kTmaMma)
    return mm::smem_bytes(hd <= 64 ? 64 : 128, vd <= 64 ? 64 : 128, rep, stages, B);
  return -1;
}

// q: (B,1,H,hd), k: (B,C,Hkv,hd), v: (B,C,Hkv,vd), all contiguous, k/v
// rows 16-byte aligned; valid_len: (B,) int32; out: (B,1,H,vd) in v's
// dtype. q_bf16 / kv_bf16 select bf16 (1) or f32 (0).
// variant 0 (fma): ws_acc (B,H,nsplit,vd) f32, ws_ml (B,H,nsplit,2) f32,
//   grid (nsplit, Hkv * ceil(rep / 8), B) with nsplit = nchunk chunks of
//   `chunk` rows, then the combine kernel; `counters`, `grid` and
//   `stages` unused.
// variant 1 (tma_mma; bf16 q and cache, hd and vd multiples of 16 up to
//   128, rep <= 16, chunk a multiple of 64, 4 <= stages <= 8): one
//   kernel of `grid` blocks; ws_acc (B,H,nchunk,vd) f32 and ws_ml
//   (B,H,nchunk,2) f32 with nchunk = ceil(C / chunk), any contents,
//   ws_acc 16-byte aligned;
//   counters (B * Hkv) int32, zero before the call and zero after it (the
//   kernel resets each count it uses). Two calls may not share the
//   workspace or the counters at one time (on two streams).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments the
// variant does not take.
int flash_decode_launch(int variant, const void* q, const void* k, const void* v,
                        const int* valid_len, void* out, float* ws_acc, float* ws_ml,
                        int* counters, int B, int H, int Hkv, int C, int hd, int vd, int chunk,
                        int nchunk, int grid, int stages, float scale, int q_bf16, int kv_bf16,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (B < 1 || C < 1 || Hkv < 1 || H % Hkv || chunk < 1 || nchunk * chunk < C)
    return cudaErrorInvalidValue;
  if (variant == kTmaMma) {
    if (!q_bf16 || !kv_bf16 || hd % 16 || vd % 16 || hd > 128 || vd > 128 || H / Hkv > 16 ||
        chunk % mm::TILE || stages < 4 || stages > mm::MAX_STAGES || B > 4096 || grid < 1)
      return cudaErrorInvalidValue;
#define FD_MMA(HDP, VDP)                                                                  \
  return launch_mma<HDP, VDP>(q, k, v, valid_len, out, ws_acc, ws_ml, counters, B, H, Hkv, C, \
                              hd, vd, chunk, nchunk, grid, stages, scale, st);
    if (hd <= 64) {
      if (vd <= 64) FD_MMA(64, 64)
      FD_MMA(64, 128)
    }
    if (vd <= 64) FD_MMA(128, 64)
    FD_MMA(128, 128)
#undef FD_MMA
  }
  if (variant != kFma) return cudaErrorInvalidValue;
  if (q_bf16 && kv_bf16)
    return launch_fma<bf16, bf16>(q, k, v, valid_len, out, ws_acc, ws_ml, B, H, Hkv, C, hd, vd,
                                  chunk, nchunk, scale, st);
  if (!q_bf16 && kv_bf16)
    return launch_fma<float, bf16>(q, k, v, valid_len, out, ws_acc, ws_ml, B, H, Hkv, C, hd, vd,
                                   chunk, nchunk, scale, st);
  if (q_bf16 && !kv_bf16)
    return launch_fma<bf16, float>(q, k, v, valid_len, out, ws_acc, ws_ml, B, H, Hkv, C, hd, vd,
                                   chunk, nchunk, scale, st);
  return launch_fma<float, float>(q, k, v, valid_len, out, ws_acc, ws_ml, B, H, Hkv, C, hd, vd,
                                  chunk, nchunk, scale, st);
}

}  // extern "C"
