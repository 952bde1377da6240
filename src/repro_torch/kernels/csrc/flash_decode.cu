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
//   out = 0 exactly where valid[b] == 0.
//
// What bounds it: device memory. Each call reads the live prefix of the
// cache, valid[b] * Hkv * (hd + vd) elements per slot, once; it does
// about 2 * rep flops per element read, far below the ~295 flops per byte
// at which an H100 stops being memory bound. So the design is about
// bytes and about keeping enough of them in flight:
//
//   * Query head h = kv * rep + r reads kv head `kv` in place. One block
//     serves up to kMaxRep query heads of one kv head, so each K/V byte
//     is read once for all of them (never repeated per query head).
//   * Split-K over the cache axis: at the serving shape there are only
//     B * Hkv = 32 (slot, kv head) pairs for 132 SMs, so the cache axis is
//     cut into chunks, one block each, and a second, small kernel combines
//     the chunks' partial softmax sums. Chunks at or past valid[b] read
//     nothing.
//   * Every K and V load is a 16-byte vector, issued kBatch at a time
//     before any of them is used. In the score pass each thread owns one
//     key's row; in the PV pass each thread owns 16 bytes of columns and
//     walks a strided subset of the tile's rows. A block of 128 threads
//     so keeps up to 16 KB of loads in flight.
//   * q, k and v are read each in its own dtype (f32 or bf16; the serving
//     CLI runs f32 q against a bf16 cache). Sums are f32. As in the plain
//     version, q * scale is rounded to q's dtype and the probabilities are
//     rounded to v's dtype before the PV product; the probability (not
//     only the logit) of a dead key is zero. The output has v's dtype.
//
// Plain C interface, loaded with ctypes by repro_torch/kernels/build.py;
// launches on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* valid_len, void* out, float* ws_acc,
                   float* ws_ml, int B, int H, int Hkv, int C, int hd,
                   int vd, int chunk, int nsplit, float scale,
                   cudaStream_t stream) {
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

}  // namespace

extern "C" {

// Shared memory (bytes) the split pass needs at this shape; the wrapper
// refuses shapes above the card's per-block limit.
int flash_decode_smem_bytes(int hd, int vd, int kv_bf16) {
  return (int)sizeof(float) * split_smem_floats(hd, vd, kv_bf16 ? 8 : 4);
}

// q: (B,1,H,hd), k: (B,C,Hkv,hd), v: (B,C,Hkv,vd), all contiguous, k/v
// rows 16-byte aligned; valid_len: (B,) int32; out: (B,1,H,vd) in v's
// dtype; ws_acc: (B,H,nsplit,vd) f32; ws_ml: (B,H,nsplit,2) f32.
// q_bf16 / kv_bf16 select bf16 (1) or f32 (0). Returns cudaGetLastError().
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const int* valid_len, void* out, float* ws_acc,
                        float* ws_ml, int B, int H, int Hkv, int C, int hd,
                        int vd, int chunk, int nsplit, float scale, int q_bf16,
                        int kv_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (q_bf16 && kv_bf16)
    return launch<bf16, bf16>(q, k, v, valid_len, out, ws_acc, ws_ml, B, H,
                              Hkv, C, hd, vd, chunk, nsplit, scale, st);
  if (!q_bf16 && kv_bf16)
    return launch<float, bf16>(q, k, v, valid_len, out, ws_acc, ws_ml, B, H,
                               Hkv, C, hd, vd, chunk, nsplit, scale, st);
  if (q_bf16 && !kv_bf16)
    return launch<bf16, float>(q, k, v, valid_len, out, ws_acc, ws_ml, B, H,
                               Hkv, C, hd, vd, chunk, nsplit, scale, st);
  return launch<float, float>(q, k, v, valid_len, out, ws_acc, ws_ml, B, H,
                              Hkv, C, hd, vd, chunk, nsplit, scale, st);
}

}  // extern "C"
