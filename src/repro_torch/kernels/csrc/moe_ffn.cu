// Batched expert SwiGLU FFN for Hopper (sm_90a):
//
//   out[e] = (silu(buf[e] @ Wg[e]) * (buf[e] @ Wu[e])) @ Wd[e]
//   buf (E,C,d), Wg/Wu (E,d,ff), Wd (E,ff,d), out (E,C,d)
//
// Replaces the TPU kernel `moe_expert_ffn_ecd` / `_moe_ffn_kernel` in
// src/repro/kernels/moe_ffn.py: per expert, gate and up accumulate in
// f32, the SwiGLU is taken in f32, the down product accumulates in f32
// and the result is rounded to buf's dtype once. Rows of buf that are all
// zero (empty capacity slots, empty experts) give exact zeros:
// silu(0) * 0 = 0, and a zero row of the hidden gives a zero output row.
//
// What bounds it: operations. At the MoE training path's shape (E = 32,
// C = 1280, d = 1024, ff = 512, bf16) the three products are
// 3 * 2 * E * C * d * ff = 128.8 GFLOP on 268 MB of operands, ~480 flops
// per byte, above the ~295 at which an H100 stops being memory bound.
//
// Design: two passes (option (c) of the port's design note, PERF.md).
// On the TPU the (block_c, d) f32 output accumulator stays in VMEM while
// the kernel loops over ff blocks. At d = 1024 that accumulator is 256 KB
// for 64 rows: more than a block's registers and more than an SM's
// shared memory. So here:
//
//   pass 1: hidden = silu(buf @ Wg) * (buf @ Wu), one block per
//           128 x 64 tile of (C, ff) per expert; the block's B tile holds
//           64 columns of Wg beside the same 64 columns of Wu, so each
//           thread holds gate and up of the same elements in registers
//           and takes the SwiGLU there. The hidden is stored in buf's
//           dtype: the tensor cores take bf16, so the down product would
//           round it to bf16 anyway.
//   pass 2: out = hidden @ Wd, one block per 128 x 128 tile of (C, d).
//
// The hidden (E,C,ff) makes one round trip through device memory:
// 2 * E * C * ff * sizeof(dtype) = 84 MB at the path shape in bf16,
// ~25 us at 3.35 TB/s against the 130 us the operations take at peak.
// Keeping it on chip (block_c 32 with the whole d-wide accumulator spread
// over the block) or recomputing gate/up per d tile are later work.
//
//   * bf16 runs on the tensor cores (mma.sync m16n8k16, bf16 inputs, f32
//     accumulators, fragments by ldmatrix), 8 warps per block, each 32 x 64
//     of the block's tile (pass 1: 32 x 32 of gate and the same 32 x 32
//     of up). f32 runs on CUDA-core FMA, not TF32, which would miss the
//     f32 plain version's tolerance.
//   * A ring of three K tiles in shared memory, filled by cp.async
//     16-byte copies (synchronous element copies where a row is not
//     whole 16-byte vectors).
//   * Ragged C, d and ff are masked inside the kernel: loads past an edge
//     read zeros, stores past an edge are dropped. No host-side pad.
//   * The expert is blockIdx.z; every expert runs all of its C rows
//     (skipping rows past an expert's fill is later work, as are wgmma
//     and TMA).
//
// Plain C interface, loaded with ctypes by repro_torch/kernels/build.py;
// launches both passes on the caller's stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

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

// A ROWS x COLS tile of a row-major matrix (row stride ld) into shared
// memory (row stride ldd), zeros past rows_left / cols_left. VEC:
// asynchronous 16-byte copies (the caller guarantees whole 16-byte rows
// and base); else synchronous element copies.
template <typename T, int ROWS, int COLS, bool VEC>
__device__ __forceinline__ void load_tile(T* dst, int ldd, const T* src,
                                          long ld, int rows_left,
                                          int cols_left, int tid) {
  if constexpr (VEC) {
    constexpr int G = 16 / (int)sizeof(T), GPR = COLS / G;
    static_assert(COLS % G == 0, "tile width is whole vectors");
    for (int g = tid; g < ROWS * GPR; g += kThreads) {
      const int row = g / GPR, col = (g % GPR) * G;
      const bool ok = row < rows_left && col < cols_left;
      cp_async16(dst + row * ldd + col, ok ? src + (long)row * ld + col : src, ok);
    }
  } else {
    for (int i = tid; i < ROWS * COLS; i += kThreads) {
      const int row = i / COLS, col = i % COLS;
      dst[row * ldd + col] =
          (row < rows_left && col < cols_left) ? src[(long)row * ld + col] : zero<T>();
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

namespace tc {
constexpr int BM = 128, BN = 128, BK = 64, PAD = 8, STAGES = 3;
constexpr int LDA = BK + PAD, LDB = BN + PAD;
constexpr int STAGE = BM * LDA + BK * LDB;          // bf16 elements
constexpr int SMEM = STAGES * STAGE * 2;            // bytes
}  // namespace tc

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices from shared memory, one per 8 lanes' row
// addresses; `trans` gives each thread the transposed elements
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 inputs, f32 accumulators. With
// g = lane / 4, t = lane % 4, d holds (row g, cols 2t, 2t+1) and
// (row g+8, cols 2t, 2t+1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [row0, row0+16), cols [k0, k0+16) of a row-major tile
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* t, int ld,
                                       int row0, int k0, int lane) {
  ldsm_x4(r, t + (row0 + lane % 16) * ld + k0 + (lane / 16) * 8);
}

// B fragments of two 8-wide column tiles [n0, n0+16) over rows [k0, k0+16)
// of a row-major (k, n) tile: r[0], r[1] for cols n0.., r[2], r[3] for n0+8..
__device__ __forceinline__ void load_b2(uint32_t (&r)[4], const bf16* t, int ld,
                                        int k0, int n0, int lane) {
  ldsm_x4_trans(r, t + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * ld + n0 + (lane / 16) * 8);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// One expert's (M x K) @ (K x N) per blockIdx.z, bf16 in, f32 accumulate.
// SWIGLU: out (M x N) = silu(a @ b0) * (a @ b1), the block covering 64
// output columns (its B tile: 64 columns of b0 beside the same 64 of b1).
// Else: out = a @ b0, the block covering 128 output columns.
// Strides sa, sb, so step the three operands from one expert to the next.
template <bool SWIGLU, bool VEC>
__global__ void __launch_bounds__(kThreads)
ffn_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b0,
                const bf16* __restrict__ b1, bf16* __restrict__ out, int M,
                int N, int K, long sa, long sb, long so) {
  using namespace tc;
  constexpr int WIDTH = SWIGLU ? BN / 2 : BN;       // output columns per block
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);

  const long ex = blockIdx.z;
  a += ex * sa;
  b0 += ex * sb;
  if constexpr (SWIGLU) b1 += ex * sb;
  out += ex * so;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = warp / 2, wn = warp % 2;           // 4 x 2 warps of 32 x 64
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * WIDTH;

  // the warp's 32 rows as 2 x 8 (16 x 8) tiles: plain, columns
  // wn*64 + [0, 64) of the B tile; SWIGLU, tiles 0..3 are gate columns
  // wn*32 + [0, 32) and tiles 4..7 the up columns 64 + wn*32 + [0, 32)
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (K + BK - 1) / BK;
  auto load_stage = [&](int kt, int st) {
    const int k0 = kt * BK;
    bf16* base = ring + st * STAGE;
    load_tile<bf16, BM, BK, VEC>(base, LDA, a + (long)m0 * K + k0, K, M - m0, K - k0, tid);
    if constexpr (SWIGLU) {
      load_tile<bf16, BK, WIDTH, VEC>(base + BM * LDA, LDB, b0 + (long)k0 * N + n0, N,
                                      K - k0, N - n0, tid);
      load_tile<bf16, BK, WIDTH, VEC>(base + BM * LDA + WIDTH, LDB, b1 + (long)k0 * N + n0,
                                      N, K - k0, N - n0, tid);
    } else {
      load_tile<bf16, BK, BN, VEC>(base + BM * LDA, LDB, b0 + (long)k0 * N + n0, N, K - k0,
                                   N - n0, tid);
    }
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();    // tile kt has landed
    __syncthreads();                // and every warp is done with tile kt-1
    if (kt + STAGES - 1 < nk) load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const bf16* a_s = ring + (kt % STAGES) * STAGE;
    const bf16* b_s = a_s + BM * LDA;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4], bf[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) load_a(af[i], a_s, LDA, wm * 32 + i * 16, kk, lane);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int col = SWIGLU ? (p / 2) * 64 + wn * 32 + (p % 2) * 16 : wn * 64 + p * 16;
        load_b2(bf, b_s, LDB, kk, col, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * p], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * p + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const bool pairs = (N % 2) == 0;  // two outputs per 4-byte store
  constexpr int NT = SWIGLU ? 4 : 8;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int gn = n0 + (SWIGLU ? wn * 32 : wn * 64) + j * 8 + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + wm * 32 + i * 16 + g + 8 * h;
        if (gm >= M) continue;
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if constexpr (SWIGLU) {
          v0 = silu(v0) * acc[i][j + 4][2 * h];
          v1 = silu(v1) * acc[i][j + 4][2 * h + 1];
        }
        bf16* o = out + (long)gm * N + gn;
        if (pairs && gn + 1 < N) {
          *reinterpret_cast<uint32_t*>(o) = pack_bf16(v0, v1);
        } else {
          if (gn < N) o[0] = __float2bfloat16(v0);
          if (gn + 1 < N) o[1] = __float2bfloat16(v1);
        }
      }
    }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA (no TF32)
// ---------------------------------------------------------------------------

namespace fp {
constexpr int BM = 64, BN = 64, BK = 16, PAD = 4, STAGES = 3;
constexpr int LDA = BK + PAD, LDB = BN + PAD;
constexpr int STAGE = BM * LDA + BK * LDB;          // f32 elements
constexpr int SMEM = STAGES * STAGE * 4;            // bytes
}  // namespace fp

// 16 x 16 threads; thread (tx, ty) owns rows ty + 16i (i < 4) and B-tile
// columns tx + 16j (j < 4). SWIGLU: the block covers 32 output columns;
// B-tile columns [0, 32) are gate, [32, 64) the same columns of up, so
// j < 2 are the thread's gate columns and j + 2 their up columns.
template <bool SWIGLU, bool VEC>
__global__ void __launch_bounds__(kThreads)
ffn_f32_kernel(const float* __restrict__ a, const float* __restrict__ b0,
               const float* __restrict__ b1, float* __restrict__ out, int M,
               int N, int K, long sa, long sb, long so) {
  using namespace fp;
  constexpr int WIDTH = SWIGLU ? BN / 2 : BN;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);

  const long ex = blockIdx.z;
  a += ex * sa;
  b0 += ex * sb;
  if constexpr (SWIGLU) b1 += ex * sb;
  out += ex * so;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * WIDTH;
  float acc[4][4] = {};

  const int nk = (K + BK - 1) / BK;
  auto load_stage = [&](int kt, int st) {
    const int k0 = kt * BK;
    float* base = ring + st * STAGE;
    load_tile<float, BM, BK, VEC>(base, LDA, a + (long)m0 * K + k0, K, M - m0, K - k0, tid);
    if constexpr (SWIGLU) {
      load_tile<float, BK, WIDTH, VEC>(base + BM * LDA, LDB, b0 + (long)k0 * N + n0, N,
                                       K - k0, N - n0, tid);
      load_tile<float, BK, WIDTH, VEC>(base + BM * LDA + WIDTH, LDB, b1 + (long)k0 * N + n0,
                                       N, K - k0, N - n0, tid);
    } else {
      load_tile<float, BK, BN, VEC>(base + BM * LDA, LDB, b0 + (long)k0 * N + n0, N, K - k0,
                                    N - n0, tid);
    }
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk) load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const float* a_s = ring + (kt % STAGES) * STAGE;
    const float* b_s = a_s + BM * LDA;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float ar[4], bc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ar[i] = a_s[(ty + 16 * i) * LDA + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bc[j] = b_s[k * LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], bc[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  constexpr int NT = SWIGLU ? 2 : 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      if constexpr (SWIGLU)
        out[(long)gm * N + gn] = silu(acc[i][j]) * acc[i][j + 2];
      else
        out[(long)gm * N + gn] = acc[i][j];
    }
  }
}

// one pass: grid (column tiles, row tiles, experts)
template <typename T, bool SWIGLU, bool VEC>
cudaError_t launch_pass(const T* a, const T* b0, const T* b1, T* out, int E, int M,
                        int N, int K, cudaStream_t stream) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int BM = BF ? tc::BM : fp::BM;
  constexpr int WIDTH = (BF ? tc::BN : fp::BN) / (SWIGLU ? 2 : 1);
  const int smem = BF ? tc::SMEM : fp::SMEM;
  const dim3 grid((N + WIDTH - 1) / WIDTH, (M + BM - 1) / BM, E);
  const long sa = (long)M * K, sb = (long)K * N, so = (long)M * N;
  if constexpr (BF) {
    auto kernel = ffn_bf16_kernel<SWIGLU, VEC>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(a, b0, b1, out, M, N, K, sa, sb, so);
  } else {
    auto kernel = ffn_f32_kernel<SWIGLU, VEC>;
    kernel<<<grid, kThreads, smem, stream>>>(a, b0, b1, out, M, N, K, sa, sb, so);
  }
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch(const void* buf, const void* wg, const void* wu, const void* wd,
                   void* hidden, void* out, int E, int C, int d, int ff,
                   cudaStream_t stream) {
  const T* x = static_cast<const T*>(buf);
  T* h = static_cast<T*>(hidden);
  cudaError_t err = launch_pass<T, true, VEC>(x, static_cast<const T*>(wg),
                                              static_cast<const T*>(wu), h, E, C, ff, d,
                                              stream);
  if (err != cudaSuccess) return err;
  return launch_pass<T, false, VEC>(h, static_cast<const T*>(wd), nullptr,
                                    static_cast<T*>(out), E, C, d, ff, stream);
}

}  // namespace

extern "C" {

// buf (E,C,d), wg/wu (E,d,ff), wd (E,ff,d), hidden (E,C,ff) scratch,
// out (E,C,d): contiguous, one dtype (is_bf16 = 1: bfloat16, 0: float32).
// `vec` = 1 when d and ff are whole 16-byte vectors and every base
// address is 16-byte aligned (16-byte copies), else element copies.
// Returns cudaGetLastError().
int moe_ffn_launch(const void* buf, const void* wg, const void* wu, const void* wd,
                   void* hidden, void* out, int E, int C, int d, int ff, int is_bf16,
                   int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E < 1 || C < 1 || d < 1 || ff < 1 || E > 65535) return cudaErrorInvalidValue;
  if (is_bf16)
    return vec ? launch<bf16, true>(buf, wg, wu, wd, hidden, out, E, C, d, ff, st)
               : launch<bf16, false>(buf, wg, wu, wd, hidden, out, E, C, d, ff, st);
  return vec ? launch<float, true>(buf, wg, wu, wd, hidden, out, E, C, d, ff, st)
             : launch<float, false>(buf, wg, wu, wd, hidden, out, E, C, d, ff, st);
}

}  // extern "C"
