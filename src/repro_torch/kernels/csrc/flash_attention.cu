// Flash attention forward for Hopper (sm_90a): causal / sliding-window /
// full softmax attention over whole sequences (training and prefill).
//
// Replaces the TPU kernel `flash_attention_bhsd` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py, and computes what it computes:
//
//   q (B, S, H, D), k, v (B, S, Hkv, D)           (the model's layout)
//   out[b, i, h] = softmax_j(scale * q[b,i,h] . k[b,j,h/rep])_{j live} @ v[b,j,h/rep]
//   live: j < S, and j <= i if causal, and j > i - window with a window;
//   scores, max, row sum and accumulator in f32; the PV product takes the
//   probabilities rounded to bf16, the row sum adds them unrounded
//   (flash_attention.py:115-117); denominator max(l, 1e-30); output in
//   q's dtype.
//
// What bounds it at the training paths' shapes (bf16, causal, B 4, S
// 1024): at llama2-7b-proxy's H 32, D 128, bytes, barely: q, k, v and out
// are 134 MB (40 us at 3.35 TB/s) against 34.4 GFLOP of causal QK^T and
// PV (35 us at 989 TFLOP/s). At granite-moe-1b-a400m's H 16/8, D 64,
// operations: 8.6 GFLOP (8.7 us) on 25 MB (7.5 us). So the kernel has to
// read each K/V byte few times and keep the tensor cores fed. Three
// variants, which the wrapper's plan picks by dtype and head dim:
//
//   * wgmma (bf16, D 64 or 128: every attention config at full width).
//     One block per (128-row q tile, head, batch), two warpgroups of 64 q
//     rows and no producer warp, so that each thread may hold 255
//     registers (see the kernel). TMA loads the q tile once and 128-key K
//     and V tiles into a ring of 3 (D 128) or 4 (D 64) stages with a full
//     and an empty mbarrier each; one thread of each warpgroup issues them.
//     Per kv tile, S = Q.K^T is wgmma m64n128k16 with both operands from
//     shared memory (K-major: K's rows are the B operand's columns); the
//     softmax runs in registers on S's accumulator fragment (row max over
//     the 4 threads of a row, exp2 with scale * log2(e) folded into one
//     FMA, the row sum kept per thread and reduced once at the end); the
//     probabilities, rounded to bf16 pairs, are the A operand of O += P.V
//     straight from registers (a 16-column slice of an m64nN accumulator
//     is one k16 A fragment), V (keys, D) is an MN-major B operand through
//     the transpose bit. A warpgroup issues tile i's Q.K^T with tile i-1's
//     P.V and runs tile i's softmax while P.V runs, taking turns with the
//     other warpgroup on the tensor cores (FA3's intra-warpgroup overlap
//     and ping-pong). The causal / window / ragged-S
//     mask runs only on tiles that cross the diagonal, the window's edge or
//     S. All tiles are 128-byte swizzled boxes 64 elements wide, addressed
//     by 4-D tensor maps (D, H, S, B) built from the tensors' strides, so
//     GQA reads kv head h / (H / Hkv) in place and TMA zero-fills rows past
//     S. The epilogue writes the normalised bf16 rows into the warpgroup's
//     own q rows in shared memory and TMA-stores them (rows past S are
//     clipped).
//   * mma_sync (bf16, any other D <= 256; also the same-run yardstick of
//     the first design): one block per (64-row q tile, head, batch), 4
//     warps of 16 rows, mma.sync m16n8k16 with ldmatrix fragments, 64-key
//     K/V tiles double-buffered by cp.async.
//   * fma_f32 (f32): CUDA-core FMA throughout (no TF32), one key per lane
//     for the scores and D/32 output columns per lane for PV.
//
// In every variant the block loops over the kv tiles itself and carries
// the running max, sum and accumulator in registers (the TPU kernel
// carries them in scratch across its sequential kv grid axis); causal
// skipping is the loop's upper bound, the window its lower bound; the
// longest causal q tiles are scheduled first, and q tiles of one head (of
// one group of 16 heads for wgmma) run at one time, so that they share
// K/V in L2. Every mbarrier wait is bounded:
// a wait that fails ~2^26 times traps, so a protocol bug surfaces as a
// CUDA error at the next synchronize and not as a hung card.
//
// Plain C interface, loaded with ctypes by repro_torch/kernels/build.py;
// launches on the caller's stream and returns cudaGetLastError().
// cuTensorMapEncodeTiled is reached through the runtime's driver entry
// point, so nothing links libcuda.

#include <atomic>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;      // mma_sync and fma_f32: 4 warps
constexpr float kNegInf = -1e30f;  // = repro_torch.kernels.common.NEG_INF

// variant codes of the C interface (= the wrapper's _VARIANTS)
enum Variant { kFmaF32 = 0, kMmaSync = 1, kWgmma = 2 };

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

// is key `col` live for query row `row`
__device__ __forceinline__ bool live_key(int row, int col, int S, int causal,
                                         int window) {
  return col < S && (!causal || col <= row) && (window <= 0 || col > row - window);
}

// 16-byte global -> shared copy; zero-fills the destination when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D padded up to the kernels' instantiated head widths
__host__ __device__ inline int padded_dim(int hd) {
  return hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
}

// ---------------------------------------------------------------------------
// mma_sync: bf16 on mma.sync m16n8k16 (any D <= 256)
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;   // query rows per block (16 per warp)
constexpr int kBKV = 64;  // keys per tile

__host__ __device__ inline int bf16_smem_bytes(int dp) {
  return 2 * 2 * kBKV * (dp + 8) * 2;   // {K, V} x 2 buffers
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// four 8x8 b16 matrices from shared memory, one per 8 lanes' row
// addresses; `trans` gives each thread the transposed elements
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a (16x16, row) * b (16x8, col); fragment layouts of the PTX ISA:
// a: {r g, c 2t..}, {r g+8, c 2t..}, {r g, c 2t+8..}, {r g+8, c 2t+8..}
// b: {k 2t.., n g}, {k 2t+8.., n g};  d: {r g, c 2t, 2t+1}, {r g+8, ...}
// with g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out, int S,
                  int H, int Hkv, int hd, long long qsb, long long qss,
                  long long qsh, long long ksb, long long kss, long long ksh,
                  long long vsb, long long vss, long long vsh, int causal,
                  int window, float scale) {
  constexpr int LD = DP + 8;      // shared row stride: conflict-free fragments
  constexpr int KT = DP / 16;     // k-steps of QK^T
  constexpr int NT = DP / 8;      // 8-wide output column tiles
  constexpr int ST = kBKV / 8;    // 8-wide score column tiles
  constexpr int VPR = DP / 8;     // 16-byte vectors per shared row
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [2][kBKV][LD]
  bf16* v_s = k_s + 2 * kBKV * LD;            // [2][kBKV][LD]

  const int nqt = (S + kBQ - 1) / kBQ;
  const int q0 = (nqt - 1 - (int)blockIdx.x) * kBQ;  // longest rows first
  const int h = blockIdx.y, bb = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rw = q0 + warp * 16;             // this warp's first row
  const int row_a = rw + g, row_b = rw + g + 8;

  const bf16* qb = q + bb * qsb + h * qsh;
  const bf16* kb = k + bb * ksb + kvh * ksh;
  const bf16* vb = v + bb * vsb + kvh * vsh;

  // this warp's q rows as A fragments, for the whole kv loop
  uint32_t qf[KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = (e & 1) ? row_b : row_a;
      const int col = kt * 16 + 2 * t4 + ((e & 2) ? 8 : 0);
      qf[kt][e] = (row < S && col < hd)
                      ? *reinterpret_cast<const uint32_t*>(qb + row * qss + col)
                      : 0u;
    }

  // kv tiles that may hold a live key for rows [q0, q0 + kBQ)
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kv_hi = causal ? min(S, q0 + kBQ) : S;
  const int t_lo = kv_lo / kBKV, t_hi = (kv_hi + kBKV - 1) / kBKV;

  auto load_tile = [&](int tile, int buf) {
    const int k0 = tile * kBKV;
    bf16* ks = k_s + buf * kBKV * LD;
    bf16* vs = v_s + buf * kBKV * LD;
    for (int i = tid; i < kBKV * VPR; i += kThreads) {
      const int row = i / VPR, c = (i % VPR) * 8;
      const bool ok = k0 + row < S && c < hd;
      cp_async16(ks + row * LD + c, ok ? kb + (k0 + row) * kss + c : kb, ok);
      cp_async16(vs + row * LD + c, ok ? vb + (k0 + row) * vss + c : vb, ok);
    }
  };

  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  load_tile(t_lo, 0);
  cp_async_commit();
  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int buf = (tile - t_lo) & 1;
    if (tile + 1 < t_hi) load_tile(tile + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();              // this tile's copies have landed
    __syncthreads();
    const int k0 = tile * kBKV;
    const bool live = (!causal || k0 <= rw + 15) &&
                      (window <= 0 || k0 + kBKV - 1 > rw - window);
    if (live) {
      const bf16* ks = k_s + buf * kBKV * LD;
      const bf16* vs = v_s + buf * kBKV * LD;
      float sc[ST][4];
#pragma unroll
      for (int nt = 0; nt < ST; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
      // K rows are the B operand's columns: plain ldmatrix, two 8-key
      // tiles (k 0-7 and 8-15 of each) per x4
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
#pragma unroll
        for (int np = 0; np < ST / 2; ++np) {
          uint32_t kf[4];
          ldsm_x4(kf, ks + (np * 16 + lane % 8 + (lane / 16) * 8) * LD + kt * 16 +
                          ((lane / 8) % 2) * 8);
          mma_bf16(sc[2 * np], qf[kt], kf[0], kf[1]);
          mma_bf16(sc[2 * np + 1], qf[kt], kf[2], kf[3]);
        }

      // scale, mask, running max (rows g and g+8 of the warp)
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < ST; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? row_a : row_b;
          const int col = k0 + nt * 8 + 2 * t4 + (e & 1);
          const float x = live_key(row, col, S, causal, window) ? sc[nt][e] * scale
                                                                : kNegInf;
          sc[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
        const float m_new = fmaxf(m[j], mx[j]);
        alpha[j] = expf(m[j] - m_new);
        m[j] = m_new;
      }
      // probabilities: the row sum adds them in f32, the PV product takes
      // them rounded to bf16 and laid out as its A operand (as the TPU
      // kernel: flash_attention.py:115-117)
      uint32_t pf[kBKV / 16][4];
#pragma unroll
      for (int nt = 0; nt < ST; ++nt) {
        const float p0 = expf(sc[nt][0] - m[0]), p1 = expf(sc[nt][1] - m[0]);
        const float p2 = expf(sc[nt][2] - m[1]), p3 = expf(sc[nt][3] - m[1]);
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        pf[nt / 2][(nt & 1) * 2] = pack_f32(p0, p1);
        pf[nt / 2][(nt & 1) * 2 + 1] = pack_f32(p2, p3);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        rs[j] += __shfl_xor_sync(0xffffffffu, rs[j], 1);
        rs[j] += __shfl_xor_sync(0xffffffffu, rs[j], 2);
        l[j] = l[j] * alpha[j] + rs[j];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        o[nt][0] *= alpha[0];
        o[nt][1] *= alpha[0];
        o[nt][2] *= alpha[1];
        o[nt][3] *= alpha[1];
      }
      // o += p @ v; V rows (keys) are the B operand's k: transposed
      // ldmatrix, two 8-wide column tiles per x4
#pragma unroll
      for (int j = 0; j < kBKV / 16; ++j)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t vf[4];
          ldsm_x4_trans(vf, vs + (j * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                                np * 16 + (lane / 16) * 8);
          mma_bf16(o[2 * np], pf[j], vf[0], vf[1]);
          mma_bf16(o[2 * np + 1], pf[j], vf[2], vf[3]);
        }
    }
    __syncthreads();                 // the buffer is refilled next iteration
  }
  cp_async_wait<0>();

  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = nt * 8 + 2 * t4;
    if (col >= hd) continue;
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(out + (((long long)bb * S + row_a) * H + h) * hd + col) =
          pack_f32(o[nt][0] / den[0], o[nt][1] / den[0]);
    if (row_b < S)
      *reinterpret_cast<uint32_t*>(out + (((long long)bb * S + row_b) * H + h) * hd + col) =
          pack_f32(o[nt][2] / den[1], o[nt][3] / den[1]);
  }
}

// ---------------------------------------------------------------------------
// fma_f32: f32 on CUDA-core FMA
// ---------------------------------------------------------------------------

constexpr int kFQ = 32;   // query rows per block (8 per warp)
constexpr int kFKV = 32;  // keys per tile (one per lane)

__host__ __device__ inline int f32_smem_bytes(int dp) {
  return ((kFQ + 2 * kFKV) * (dp + 4) + kFQ * kFKV) * 4;
}

// rows x DP floats of a (rows, D) strided matrix into shared memory with
// row stride LD, zeros past S and past hd
template <int DP>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long stride, int r0,
                                              int rows, int S, int hd,
                                              int tid) {
  constexpr int LD = DP + 4, VPR = DP / 4;
  for (int i = tid; i < rows * VPR; i += kThreads) {
    const int row = i / VPR, c = (i % VPR) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < S && c < hd)
      x = __ldg(reinterpret_cast<const float4*>(src + (r0 + row) * stride + c));
    *reinterpret_cast<float4*>(dst + row * LD + c) = x;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int S,
                 int H, int Hkv, int hd, long long qsb, long long qss,
                 long long qsh, long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh, int causal,
                 int window, float scale) {
  constexpr int LD = DP + 4;       // float4 rows, conflict-free per quarter warp
  constexpr int DC = DP / 32;      // output columns per lane
  constexpr int RW = kFQ / 4;      // rows per warp
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [kFQ][LD]
  float* k_s = q_s + kFQ * LD;                  // [kFKV][LD]
  float* v_s = k_s + kFKV * LD;                 // [kFKV][LD]
  float* p_s = v_s + kFKV * LD;                 // [kFQ][kFKV]

  const int nqt = (S + kFQ - 1) / kFQ;
  const int q0 = (nqt - 1 - (int)blockIdx.x) * kFQ;
  const int h = blockIdx.y, bb = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rw = q0 + warp * RW;

  const float* qb = q + bb * qsb + h * qsh;
  const float* kb = k + bb * ksb + kvh * ksh;
  const float* vb = v + bb * vsb + kvh * vsh;
  load_rows_f32<DP>(q_s, qb, qss, q0, kFQ, S, hd, tid);

  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kv_hi = causal ? min(S, q0 + kFQ) : S;
  const int t_lo = kv_lo / kFKV, t_hi = (kv_hi + kFKV - 1) / kFKV;

  float o[RW][DC], m[RW], l[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[i][c] = 0.f;
  }

  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int k0 = tile * kFKV;
    __syncthreads();                 // the previous tile is consumed
    load_rows_f32<DP>(k_s, kb, kss, k0, kFKV, S, hd, tid);
    load_rows_f32<DP>(v_s, vb, vss, k0, kFKV, S, hd, tid);
    __syncthreads();
    const bool live = (!causal || k0 <= rw + RW - 1) &&
                      (window <= 0 || k0 + kFKV - 1 > rw - window);
    if (!live) continue;

    float s[RW];                     // lane = key k0 + lane
#pragma unroll
    for (int i = 0; i < RW; ++i) s[i] = 0.f;
    for (int d = 0; d < DP; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(k_s + lane * LD + d);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + (warp * RW + i) * LD + d);
        s[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float x = live_key(rw + i, k0 + lane, S, causal, window) ? s[i] * scale
                                                                    : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(x));
      const float p = expf(x - m_new);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
      p_s[(warp * RW + i) * kFKV + lane] = p;
#pragma unroll
      for (int c = 0; c < DC; ++c) o[i][c] *= alpha;
    }
    __syncwarp();
    for (int j = 0; j < kFKV; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = v_s[j * LD + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float p = p_s[(warp * RW + i) * kFKV + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) o[i][c] = fmaf(p, vv[c], o[i][c]);
      }
    }
    __syncwarp();                    // p_s is rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int row = rw + i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = lane + 32 * c;
      if (col < hd) out[(((long long)bb * S + row) * H + h) * hd + col] = o[i][c] / den;
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma: bf16, D 64 or 128; a TMA ring, two warpgroups
// ---------------------------------------------------------------------------

namespace wg {
constexpr int BQ = 128, BKV = 128, THREADS = 256;
constexpr int GROUP = 16;          // (batch, head) pairs whose q tiles run together
constexpr int BOX_Q = 64 * 128;    // one 64-row box of q / out: 64 columns, 128 bytes a row
constexpr int BOX_KV = BKV * 128;  // one 128-key box of K or V
// the q tile (also the output's staging), the ring of K/V tiles, the
// barriers (q full, then full and empty per stage) and slack to align to
// 1 KB
__host__ __device__ constexpr int smem_bytes(int d, int stages) {
  return 2 * (d / 64) * BOX_Q + stages * 2 * (d / 64) * BOX_KV + 8 * (1 + 2 * stages) + 1024;
}
}  // namespace wg

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

// one 4-D TMA box (coordinates: column, head, row, batch) into shared
// memory; the bytes land on `bar`'s transaction count
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}
// one 4-D TMA box from shared memory to global memory (writes past the
// tensor's edge are dropped); tma_store_drain waits until the copies have
// read shared memory
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int col,
                                             int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// 2^x (ex2.approx: 2 ulp; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns (accumulators, A fragments) across it
template <int R> __device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R> __device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// S (64 x 128 f32, 64 a thread) = or += Q (64 x 16) * K^T (16 x 128):
// both operands from shared memory, K-major (tnspA = tnspB = 0); `acc` = 0
// overwrites d (the first depth step of a tile)
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// O (64 x 128 f32, 64 a thread) += P (64 x 16 bf16 from registers, in
// each warp's 16 rows the m16n8k16 A fragment) * V (16 x 128, MN-major from
// shared memory, so tnspB = 1)
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 64 f32, 32 a thread) += P (64 x 16 bf16 from registers, in
// each warp's 16 rows the m16n8k16 A fragment) * V (16 x 64, MN-major from
// shared memory, so tnspB = 1)
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The kv tile's mask (only on a tile that crosses the diagonal, the
// window's edge or S) and the online softmax on the S accumulator
// fragment, in place: m is the running max of the unscaled scores, l this
// thread's share of the row sum; on return s holds the probabilities
// 2^(s * scale * log2 e - max) in f32, l and m cover this tile, and
// `alpha` rescales what the earlier tiles left in the output
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool edge, int row, int k0,
                                             int col2, int S, int causal, int window,
                                             float sl2e) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!live_key(row + (e & 2) * 4, k0 + 8 * j + col2 + (e & 1), S, causal, window))
          s[4 * j + e] = -CUDART_INF_F;
  }
  float mx[2] = {m[0], m[1]}, ms[2];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    ms[r] = mx[r] == -CUDART_INF_F ? 0.f : mx[r] * sl2e;   // no live key yet: p = 0
    alpha[r] = ex2(fmaf(m[r], sl2e, -ms[r]));              // 0 while m = -inf
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], sl2e, -ms[e / 2]));
      l[e / 2] += s[4 * j + e];   // the row sum adds the unrounded values
    }
}

// The probabilities rounded to bf16 as the A operand of P.V:
// p[4kk..4kk+3] is the m16n8k16 A fragment of keys 16kk..16kk+15 (a
// 16-column slice of the S fragment)
__device__ __forceinline__ void pack_p(const float (&s)[64], uint32_t (&p)[32]) {
#pragma unroll
  for (int j = 0; j < 32; ++j) p[j] = pack_f32(s[2 * j], s[2 * j + 1]);
}

// One block per (128-row q tile, head, batch), two warpgroups of 64 rows
// and no producer warp: 256 threads leave each 255 registers, which S, P
// and O of a 128-key tile at D 128 need (a third, producer warpgroup caps
// every thread at 168 registers whatever setmaxnreg asks, since ptxas
// allocates against the launch bound). Thread 0 of warpgroup 0 issues the
// TMA loads of the q tile and of the first STAGES K/V tiles; thread 0 of
// warpgroup 1 refills each stage with the tile STAGES further on once both
// warpgroups have released it. Blocks take their (q tile, head, batch)
// from their linear index in the order set out below.
//
// Per stage of the ring: K's boxes, then V's (D / 64 boxes of 128 keys x
// 64 columns each). The q tile: box b (columns 64b..) holds 128 rows,
// consumer c's 64 at q_s + (2b + c) * BOX_Q; the epilogue stages each
// warpgroup's output rows there. Fragment layout of an m64nN accumulator:
// thread `lane` of warp w holds, for each 8-column slice j, columns 8j + 2
// (lane % 4) + {0, 1} of rows 16w + lane / 4 (elements 4j, 4j + 1) and 16w
// + lane / 4 + 8 (4j + 2, 4j + 3).
//
// Schedule (FA3's): a warpgroup issues tile i's Q.K^T together with tile
// i-1's P.V, waits for Q.K^T alone and runs tile i's softmax while P.V
// runs on the tensor cores; the two warpgroups take turns to issue their
// products (named barriers 1 and 2), so that one's softmax runs while the
// other's products do. Taking the same turns, both warpgroups compute
// every tile of the block, masked where it holds no live key for them.
template <int D, int STAGES>
__global__ void __launch_bounds__(wg::THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_o, int S, int H, int Hkv,
                   int causal, int window, float sl2e) {
  using namespace wg;
  constexpr int NB = D / 64;              // 64-column boxes per row
  constexpr int Q_BYTES = 2 * NB * BOX_Q;
  constexpr int KV_BYTES = NB * BOX_KV;   // K or V of one stage
  constexpr int STAGE = 2 * KV_BYTES;
  constexpr int R = D / 2;                // O accumulators per thread
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles need 1024-byte aligned bases
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = q_s + Q_BYTES;
  const uint32_t q_full = ring + STAGES * STAGE, full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * STAGES;

  // The card starts blocks in the order of their linear index. That order
  // walks the (batch, head) pairs in groups of GROUP and, within a group,
  // the q tiles longest first across the group's heads: the last blocks
  // to start are short ones, and a group's K/V stays in L2 while its q
  // tiles run.
  const int nqt = (S + BQ - 1) / BQ, nbh = H * gridDim.z;
  const int lin = blockIdx.x + nqt * (blockIdx.y + H * blockIdx.z);
  const int g0 = lin / (GROUP * nqt) * GROUP, gsize = min(GROUP, nbh - g0);
  const int pos = lin - g0 * nqt, bh = g0 + pos % gsize;
  const int q0 = (nqt - 1 - pos / gsize) * BQ;   // longest rows first
  const int h = bh % H, bb = bh / H, kvh = h / (H / Hkv);
  // kv tiles that may hold a live key for rows [q0, q0 + BQ)
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kv_hi = causal ? min(S, q0 + BQ) : S;
  const int t_lo = kv_lo / BKV, n = (kv_hi + BKV - 1) / BKV - t_lo;
  // K/V tile i into its stage; the bytes land on the stage's full barrier
  auto load_kv = [&](int i) {
    const uint32_t bar = full0 + 8 * (i % STAGES), k_s = ring + (i % STAGES) * STAGE;
    mbar_expect_tx(bar, STAGE);
    for (int b = 0; b < NB; ++b) {
      tma_load_4d(k_s + b * BOX_KV, &tm_k, bar, 64 * b, kvh, (t_lo + i) * BKV, bb);
      tma_load_4d(k_s + KV_BYTES + b * BOX_KV, &tm_v, bar, 64 * b, kvh, (t_lo + i) * BKV, bb);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full0 + 8 * i, 1);    // the loading thread's expect_tx
      mbar_init(empty0 + 8 * i, 2);   // one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_full, Q_BYTES);
    for (int c = 0; c < 2; ++c)
      for (int b = 0; b < NB; ++b)
        tma_load_4d(q_s + (2 * b + c) * BOX_Q, &tm_q, q_full, 64 * b, h, q0 + 64 * c, bb);
    for (int i = 0; i < min(n, STAGES); ++i) load_kv(i);
  }
  __syncthreads();

  const int c = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = q0 + 64 * c;                 // this warpgroup's first row
  const int row = r0 + 16 * warp + lane / 4;  // and this thread's rows: row, row + 8
  const int col2 = 2 * (lane % 4);
  const uint32_t q_c = q_s + c * BOX_Q;       // box b at q_c + 2b * BOX_Q
  auto stage = [&](int i) { return ring + (i % STAGES) * STAGE; };
  auto wait_full = [&](int i) { mbar_wait(full0 + 8 * (i % STAGES), (i / STAGES) & 1); };
  // every filled stage is released once per warpgroup; warpgroup 1 then
  // refills it with tile i + STAGES when warpgroup 0 has released it too
  auto release = [&](int i) {
    if (tid == 0) {
      mbar_arrive(empty0 + 8 * (i % STAGES));
      if (c == 1 && i + STAGES < n) {
        mbar_wait(empty0 + 8 * (i % STAGES), (i / STAGES) & 1);
        load_kv(i + STAGES);
      }
    }
  };
  // does tile i hold a key that some row masks (the diagonal, the
  // window's edge, S)?
  auto edge = [&](int i) {
    const int k0 = (t_lo + i) * BKV;
    return k0 + BKV > S || (causal && k0 + BKV - 1 > r0) ||
           (window > 0 && k0 <= r0 + 63 - window);
  };
  // S = Q K^T: A is this warpgroup's 64 q rows, B's columns are K's rows;
  // both K-major, 16 deep = 32 bytes along the swizzled row
  auto issue_qk = [&](float (&s)[64], int i) {
    const uint32_t k_s = stage(i);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_qk(s, sw128_desc(q_c + (kk / 4) * 2 * BOX_Q + (kk % 4) * 32, 16, 1024),
               sw128_desc(k_s + (kk / 4) * BOX_KV + (kk % 4) * 32, 16, 1024), kk > 0);
  };
  // O += P V: V (keys, D) is MN-major; 16 keys = 16 rows of 128 bytes,
  // the two 64-column boxes (D 128) BOX_KV apart, 8-row groups 1 KB apart
  auto issue_pv = [&](float (&o)[R], uint32_t (&p)[32], int i) {
    const uint32_t v_s = stage(i) + KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_pv(o, p + 4 * kk, sw128_desc(v_s + kk * 2048, BOX_KV, 1024));
  };

  float o[R];
#pragma unroll
  for (int e = 0; e < R; ++e) o[e] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t p[32];
  mbar_wait(q_full, 0);
  {
    float s[64];
    wait_full(0);
    wgmma_fence();
    issue_qk(s, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(s, m, l, alpha, edge(0), row, t_lo * BKV, col2, S, causal, window, sl2e);
    pack_p(s, p);
  }
  if (c == 1 && n > 1)   // warpgroup 0 takes the first turn
    asm volatile("bar.arrive 1, 256;\n" ::: "memory");
  for (int i = 1; i < n; ++i) {
    float s[64];
    wait_full(i);
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
    wgmma_fence();
    issue_qk(s, i);
    wgmma_commit();
    issue_pv(o, p, i - 1);
    wgmma_commit();
    // the other warpgroup's turn (its last turn is this one's last but one)
    if (c == 0 || i + 1 < n) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - c) : "memory");
    wgmma_wait<1>();   // Q.K^T done; P.V still running
    fence_regs(s);
    softmax_tile(s, m, l, alpha, edge(i), row, (t_lo + i) * BKV, col2, S, causal, window, sl2e);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    release(i - 1);
    // what P.V reads is redefined only once it has retired
#pragma unroll
    for (int e = 0; e < D / 8; ++e) {
      o[4 * e] *= alpha[0];
      o[4 * e + 1] *= alpha[0];
      o[4 * e + 2] *= alpha[1];
      o[4 * e + 3] *= alpha[1];
    }
    pack_p(s, p);
  }
  wgmma_fence();
  issue_pv(o, p, n - 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(p);
  release(n - 1);

  // the 4 threads of a row hold shares of its sum
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);   // multiplied below: one division a row
  }
  // the normalised bf16 rows into this warpgroup's own q rows (no wgmma
  // reads them any more), 128-byte swizzled as the output's map expects:
  // 16-byte chunk k of row r sits at chunk k ^ (r % 8)
  const int rl = 16 * warp + lane / 4;
#pragma unroll
  for (int e = 0; e < D / 8; ++e)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = rl + 8 * hh;
      st_shared_u32(q_c + (e / 8) * 2 * BOX_Q + r * 128 + (((e % 8) ^ (r % 8)) * 16) + 2 * col2,
                    pack_f32(o[4 * e + 2 * hh] * l[hh], o[4 * e + 2 * hh + 1] * l[hh]));
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to TMA
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + c) : "memory");     // this warpgroup only
  if (tid == 0 && r0 < S) {
#pragma unroll
    for (int b = 0; b < NB; ++b) tma_store_4d(&tm_o, q_c + 2 * b * BOX_Q, 64 * b, h, r0, bb);
    tma_store_drain();
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

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

// TMA map of a bf16 (batch, seq, heads, d) tensor read through element
// strides st = {batch, seq, head} (the last dim contiguous): dims (d,
// heads, seq, batch), boxes of 64 columns x `rows` rows of one head of one
// batch, 128-byte swizzled; reads past seq give zeros, writes past it are
// dropped
bool bf16_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int d, int heads, int seq,
              int batch, const long long* st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int STAGES>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int S,
                         int H, int Hkv, const long long* st, int causal, int window,
                         float scale, int grid_x, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const long long ost[3] = {(long long)S * H * D, (long long)H * D, D};   // out: contiguous
  CUtensorMap m_q, m_k, m_v, m_o;
  if (!bf16_map(encode, &m_q, q, D, H, S, B, st, 64) ||
      !bf16_map(encode, &m_k, k, D, Hkv, S, B, st + 3, wg::BKV) ||
      !bf16_map(encode, &m_v, v, D, Hkv, S, B, st + 6, wg::BKV) ||
      !bf16_map(encode, &m_o, out, D, H, S, B, ost, 64))
    return cudaErrorInvalidValue;
  auto kernel = flash_wgmma_kernel<D, STAGES>;
  static std::atomic<unsigned long long> done{0};
  const int smem = wg::smem_bytes(D, STAGES);
  const cudaError_t err = allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(grid_x, H, B), wg::THREADS, smem, stream>>>(
      m_q, m_k, m_v, m_o, S, H, Hkv, causal, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <typename T, typename Kernel>
cudaError_t launch_one(Kernel kernel, int smem, int grid_x, const void* q, const void* k,
                       const void* v, void* out, int B, int S, int H, int Hkv, int hd,
                       const long long* st, int causal, int window, float scale,
                       cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(grid_x, H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, Hkv, hd, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block of `variant` (0 fma_f32, 1 mma_sync,
// 2 wgmma) needs at head dim hd with `stages` K/V stages (wgmma only; the
// others have a fixed ring); -1 for an unknown variant.
int flash_attention_smem_bytes(int variant, int hd, int stages) {
  const int dp = padded_dim(hd);
  switch (variant) {
    case kFmaF32: return f32_smem_bytes(dp);
    case kMmaSync: return bf16_smem_bytes(dp);
    case kWgmma: return wg::smem_bytes(hd, stages);
  }
  return -1;
}

// q (B,S,H,hd), k and v (B,S,Hkv,hd), read through element strides
// strides[9] = {q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h} (the last dim
// is contiguous; starts and strides whole 16-byte vectors); out (B,S,H,hd)
// contiguous, in the inputs' one dtype. H % Hkv == 0; window <= 0: no
// window. `variant`: 0 fma_f32 (f32, hd <= 256), 1 mma_sync (bf16, hd <=
// 256), 2 wgmma (bf16, scale > 0, hd 128 with 3 stages or hd 64 with 4).
// The grid is (grid_x, H, B)
// with grid_x the q tiles: ceil(S / 32, 64 or 128) by variant. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments no variant
// takes.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, int B, int S,
                           int H, int Hkv, int hd, const long long* strides, int causal,
                           int window, float scale, int variant, int stages, int grid_x,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || hd < 1 || hd > 256 || Hkv < 1 || H % Hkv) return cudaErrorInvalidValue;
  const int dp = padded_dim(hd);
  if (variant == kWgmma) {
    if (grid_x != (S + wg::BQ - 1) / wg::BQ || !(scale > 0.f)) return cudaErrorInvalidValue;
    if (hd == 128 && stages == 3)
      return launch_wgmma<128, 3>(q, k, v, out, B, S, H, Hkv, strides, causal, window, scale,
                                  grid_x, st);
    if (hd == 64 && stages == 4)
      return launch_wgmma<64, 4>(q, k, v, out, B, S, H, Hkv, strides, causal, window, scale,
                                 grid_x, st);
  } else if (variant == kMmaSync) {
    if (grid_x != (S + kBQ - 1) / kBQ) return cudaErrorInvalidValue;
    const int smem = bf16_smem_bytes(dp);
#define FA_BF16(D)                                                                         \
  case D:                                                                                  \
    return launch_one<bf16>(flash_bf16_kernel<D>, smem, grid_x, q, k, v, out, B, S, H, Hkv, \
                            hd, strides, causal, window, scale, st);
    switch (dp) { FA_BF16(32) FA_BF16(64) FA_BF16(128) FA_BF16(256) }
#undef FA_BF16
  } else if (variant == kFmaF32) {
    if (grid_x != (S + kFQ - 1) / kFQ) return cudaErrorInvalidValue;
    const int smem = f32_smem_bytes(dp);
#define FA_F32(D)                                                                           \
  case D:                                                                                   \
    return launch_one<float>(flash_f32_kernel<D>, smem, grid_x, q, k, v, out, B, S, H, Hkv, \
                             hd, strides, causal, window, scale, st);
    switch (dp) { FA_F32(32) FA_F32(64) FA_F32(128) FA_F32(256) }
#undef FA_F32
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
