// Flash attention forward for Hopper (sm_90a): causal / sliding-window /
// full softmax attention over whole sequences (training and prefill).
//
// Replaces the TPU kernel `flash_attention_bhsd` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py, and computes what it computes:
//
//   q (B, S, H, D), k, v (B, S, Hkv, D)           (the model's layout)
//   out[b, i, h] = softmax_j(scale * q[b,i,h] . k[b,j,h/rep])_{j live} @ v[b,j,h/rep]
//   live: j < S, and j <= i if causal, and j > i - window with a window;
//   all sums in f32, denominator max(l, 1e-30), output in q's dtype.
//
// What bounds it at the training path's shape (B=4, S=1024, H=Hkv=32,
// D=128, causal, bf16): bytes, barely. q, k, v and out are 134 MB (40 us
// at 3.35 TB/s); the causal half of QK^T and PV is about 34 GFLOP (35 us
// at 989 TFLOP/s). So the kernel has to read each K/V byte few times and
// keep the tensor cores busy enough not to become the limit:
//
//   * One block per (q tile of 64 rows, head, batch); 4 warps, 16 rows
//     each. Blocks run in no order, so the block loops over the kv tiles
//     itself and carries the running max, sum and output accumulator in
//     registers (the TPU kernel carries them in scratch across its
//     sequential kv grid axis). Causal skipping is the loop's upper bound,
//     the window its lower bound; a warp also skips tiles that are dead
//     for all of its rows. The longest causal q tiles are scheduled first.
//   * K/V tiles of 64 keys are double-buffered in shared memory with
//     cp.async (16-byte copies, zero-filled past S and past D), so the
//     next tile's loads overlap this tile's math.
//   * The model layout is read through strides: no swapaxes copy and no
//     K/V repeat for GQA; head h reads kv head h / (H / Hkv) in place.
//   * bf16: QK^T on the tensor cores (mma.sync m16n8k16, bf16 inputs, f32
//     accumulators, K and V fragments by ldmatrix), exact against the f32
//     reference up to summation order since q and k already are bf16.
//     Softmax in f32 in registers. The
//     probabilities are rounded to bf16 for the PV product on the tensor
//     cores (the only rounding the f32 reference does not have; the chip
//     check's limit accounts for it); the row sum adds the rounded values.
//   * f32: CUDA-core FMA throughout (no TF32), one key per lane for the
//     scores and D/32 output columns per lane for PV.
//
// Supported: D <= 256 with rows of whole 16-byte vectors. wgmma, TMA and
// warp specialisation are later work.
//
// Plain C interface, loaded with ctypes by repro_torch/kernels/build.py;
// launches on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;      // 4 warps
constexpr float kNegInf = -1e30f;  // = repro_torch.kernels.common.NEG_INF

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
// bf16: tensor cores (mma.sync m16n8k16)
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

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
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
      // probabilities, rounded to bf16 and laid out as the PV A operand
      uint32_t pf[kBKV / 16][4];
#pragma unroll
      for (int nt = 0; nt < ST; ++nt) {
        const bf16 p0 = __float2bfloat16(expf(sc[nt][0] - m[0]));
        const bf16 p1 = __float2bfloat16(expf(sc[nt][1] - m[0]));
        const bf16 p2 = __float2bfloat16(expf(sc[nt][2] - m[1]));
        const bf16 p3 = __float2bfloat16(expf(sc[nt][3] - m[1]));
        rs[0] += __bfloat162float(p0) + __bfloat162float(p1);
        rs[1] += __bfloat162float(p2) + __bfloat162float(p3);
        pf[nt / 2][(nt & 1) * 2] = pack_bf16(p0, p1);
        pf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
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
// f32: CUDA-core FMA
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

template <typename T, typename Kernel>
cudaError_t launch_one(Kernel kernel, int smem, int rows, const void* q,
                       const void* k, const void* v, void* out, int B, int S,
                       int H, int Hkv, int hd, const long long* st,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + rows - 1) / rows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, Hkv, hd, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, window,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block needs at head dim hd; the wrapper
// refuses shapes above the card's per-block limit.
int flash_attention_smem_bytes(int hd, int is_bf16) {
  const int dp = padded_dim(hd);
  return is_bf16 ? bf16_smem_bytes(dp) : f32_smem_bytes(dp);
}

// q (B,S,H,hd), k and v (B,S,Hkv,hd), read through element strides
// strides[9] = {q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h} (the last dim
// is contiguous); out (B,S,H,hd) contiguous, in the inputs' one dtype
// (is_bf16 = 1: bfloat16, 0: float32). hd <= 256, rows and strides whole
// 16-byte vectors, H % Hkv == 0. window <= 0: no window.
// Returns cudaGetLastError().
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int S, int H, int Hkv, int hd,
                           const long long* strides, int causal, int window,
                           float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd < 1 || hd > 256 || Hkv < 1 || H % Hkv) return cudaErrorInvalidValue;
  const int dp = padded_dim(hd);
  if (is_bf16) {
    const int smem = bf16_smem_bytes(dp);
#define FA_BF16(D)                                                            \
  case D:                                                                     \
    return launch_one<bf16>(flash_bf16_kernel<D>, smem, kBQ, q, k, v, out, B, \
                            S, H, Hkv, hd, strides, causal, window, scale, st);
    switch (dp) { FA_BF16(32) FA_BF16(64) FA_BF16(128) FA_BF16(256) }
#undef FA_BF16
  } else {
    const int smem = f32_smem_bytes(dp);
#define FA_F32(D)                                                             \
  case D:                                                                     \
    return launch_one<float>(flash_f32_kernel<D>, smem, kFQ, q, k, v, out, B, \
                             S, H, Hkv, hd, strides, causal, window, scale, st);
    switch (dp) { FA_F32(32) FA_F32(64) FA_F32(128) FA_F32(256) }
#undef FA_F32
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
