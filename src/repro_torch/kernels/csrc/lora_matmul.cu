// Fused frozen-weight + LoRA matmul for Hopper (sm_90a):
//
//   out = x @ W + s * ((x @ A) @ B)      x (M,K), W (K,N), A (K,r), B (r,N)
//
// Replaces the TPU kernel `lora_matmul` / `_lora_kernel` in
// src/repro/kernels/lora_matmul.py, and computes what its body computes:
// f32 accumulators for x@W and x@A over the whole K loop, x@A rounded to
// B's dtype once at the end, then the rank product in f32 and
// `acc + s * lora` rounded to x's dtype. s = alpha / r arrives by value.
//
// What bounds it: operations. At the training path's shape (M = 4096
// tokens, K = N = 4096, r = 32, bf16) it does 2*M*N*K + 2*M*r*(K+N)
// = 139.5 GFLOP on 100 MB of operands, ~1,400 flops per byte, far above
// the ~295 at which an H100 stops being memory bound. So the design is
// about feeding the tensor cores and reading x once for both products:
//
//   * One block per 128 x 128 output tile (bf16; 64 x 64 for f32). The
//     block walks K in steps of 64 (16 for f32) and, from the same x tile
//     in shared memory, accumulates both x@W and x@A (128 x r).
//     x@W is computed here, not by a library GEMM plus an epilogue: that
//     is the point of the TPU kernel, x is read once for both products.
//   * bf16 runs on the tensor cores (mma.sync m16n8k16, bf16 inputs, f32
//     accumulators, fragments by ldmatrix): 8 warps, each 32 x 64 of x@W
//     and 16 x r of x@A; x@A goes through shared memory, rounded to bf16,
//     to the rank product of every warp that needs its rows.
//     r (1..64) is padded with zeros in shared memory to the next multiple
//     of 16, the MMA width. f32 runs on CUDA-core FMA, not TF32, which
//     would miss the f32 plain version's tolerance.
//   * A ring of three K tiles in shared memory, filled by cp.async
//     16-byte copies, so two tiles are in flight while the math works on
//     the third (synchronous element copies where a row of x, W or A is
//     not whole 16-byte vectors).
//   * Ragged M, N, K and any r are masked inside the kernel: loads past an
//     edge read zeros, stores past an edge are dropped. No host-side pad.
//
// wgmma, TMA and a persistent schedule are later work.
//
// Plain C interface, loaded with ctypes by repro_torch/kernels/build.py;
// launches on the caller's stream and returns cudaGetLastError().

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
constexpr int LDX = BK + PAD, LDW = BN + PAD, LDB = BN + PAD;
}  // namespace tc

// bf16 elements of one pipeline stage: x tile, W tile, A tile
__host__ __device__ constexpr int tc_stage_elems(int rt) {
  return tc::BM * tc::LDX + tc::BK * tc::LDW + tc::BK * (16 * rt + tc::PAD);
}

// shared memory (bytes) of the bf16 kernel: the K-loop ring, which the
// epilogue's buffers (x@A and the B tile) reuse
__host__ __device__ constexpr int tc_smem_bytes(int rt) {
  return tc::STAGES * tc_stage_elems(rt) * 2;
}

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

template <int RT, bool VEC>
__global__ void __launch_bounds__(kThreads)
lora_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const bf16* __restrict__ a, const bf16* __restrict__ b,
                 bf16* __restrict__ out, int M, int N, int K, int r,
                 float s) {
  using namespace tc;
  constexpr int RP = 16 * RT;       // rank padded to the MMA width
  constexpr int LDA = RP + PAD, LDXA = RP + PAD;
  constexpr int STAGE = tc_stage_elems(RT);
  static_assert(BM * LDXA + RP * LDB <= STAGES * STAGE, "epilogue fits the ring");

  extern __shared__ __align__(128) unsigned char smem[];
  // K loop: a ring of STAGES (x tile, W tile, A tile)
  bf16* ring = reinterpret_cast<bf16*>(smem);
  // epilogue (aliases the ring): x@A in B's dtype, then the B tile
  bf16* xa_s = reinterpret_cast<bf16*>(smem);
  bf16* b_s = xa_s + BM * LDXA;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = warp / 2, wn = warp % 2;  // 4 x 2 warps of 32 x 64
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // x@W: the warp's 32 x 64 as 2 x 8 (16 x 8) tiles; x@A: its rows
  // wm*32 + wn*16 + [0, 16), from the x fragment af[wn] of the main product
  float acc[2][8][4], xa[2 * RT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < 2 * RT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) xa[j][e] = 0.f;

  const int nk = (K + BK - 1) / BK;
  auto load_stage = [&](int kt, int st) {
    const int k0 = kt * BK;
    bf16* base = ring + st * STAGE;
    load_tile<bf16, BM, BK, VEC>(base, LDX, x + (long)m0 * K + k0, K, M - m0, K - k0, tid);
    load_tile<bf16, BK, BN, VEC>(base + BM * LDX, LDW, w + (long)k0 * N + n0, N, K - k0,
                                 N - n0, tid);
    load_tile<bf16, BK, RP, VEC>(base + BM * LDX + BK * LDW, LDA, a + (long)k0 * r, r,
                                 K - k0, r, tid);
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
    const bf16* x_s = ring + (kt % STAGES) * STAGE;
    const bf16* w_s = x_s + BM * LDX;
    const bf16* a_s = w_s + BK * LDW;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4], bf[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) load_a(af[i], x_s, LDX, wm * 32 + i * 16, kk, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        load_b2(bf, w_s, LDW, kk, wn * 64 + j * 16, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * j], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * j + 1], af[i], bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        load_b2(bf, a_s, LDA, kk, t * 16, lane);
        mma_bf16(xa[2 * t], af[wn], bf[0], bf[1]);
        mma_bf16(xa[2 * t + 1], af[wn], bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                  // the ring is reused below

  // x@A rounded to B's dtype (lora_matmul.py:89)
  const int xr = wm * 32 + wn * 16 + g;
#pragma unroll
  for (int j = 0; j < 2 * RT; ++j) {
    const int col = j * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(xa_s + xr * LDXA + col) = pack_bf16(xa[j][0], xa[j][1]);
    *reinterpret_cast<uint32_t*>(xa_s + (xr + 8) * LDXA + col) = pack_bf16(xa[j][2], xa[j][3]);
  }
  // B rows >= r read as zeros
  load_tile<bf16, RP, BN, VEC>(b_s, LDB, b + n0, N, r, N - n0, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const bool pairs = (N % 2) == 0;  // two outputs per 4-byte store
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lo[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) lo[j][e] = 0.f;
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      uint32_t af[4], bf[4];
      load_a(af, xa_s, LDXA, wm * 32 + i * 16, t * 16, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        load_b2(bf, b_s, LDB, t * 16, wn * 64 + j * 16, lane);
        mma_bf16(lo[2 * j], af, bf[0], bf[1]);
        mma_bf16(lo[2 * j + 1], af, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + wn * 64 + j * 8 + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + wm * 32 + i * 16 + g + 8 * h;
        if (gm >= M) continue;
        const float v0 = acc[i][j][2 * h] + s * lo[j][2 * h];
        const float v1 = acc[i][j][2 * h + 1] + s * lo[j][2 * h + 1];
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
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA (no TF32)
// ---------------------------------------------------------------------------

namespace fp {
constexpr int BM = 64, BN = 64, BK = 16, PAD = 4, STAGES = 3;
constexpr int LDX = BK + PAD, LDW = BN + PAD, LDB = BN + PAD;
}  // namespace fp

// f32 elements of one pipeline stage: x tile, W tile, A tile
__host__ __device__ constexpr int fp_stage_elems(int rt) {
  return fp::BM * fp::LDX + fp::BK * fp::LDW + fp::BK * (16 * rt + fp::PAD);
}

__host__ __device__ constexpr int fp_smem_bytes(int rt) {
  return fp::STAGES * fp_stage_elems(rt) * 4 >
                 (fp::BM * (16 * rt + fp::PAD) + 16 * rt * fp::LDB) * 4
             ? fp::STAGES * fp_stage_elems(rt) * 4
             : (fp::BM * (16 * rt + fp::PAD) + 16 * rt * fp::LDB) * 4;
}

// 16 x 16 threads; thread (tx, ty) owns rows ty + 16i and columns
// tx + 16j (i, j < 4) of the tile, and rank columns tx + 16t of x@A.
template <int RT, bool VEC>
__global__ void __launch_bounds__(kThreads)
lora_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ out, int M, int N, int K, int r,
                float s) {
  using namespace fp;
  constexpr int RP = 16 * RT;
  constexpr int LDA = RP + PAD, LDXA = RP + PAD;
  constexpr int STAGE = fp_stage_elems(RT);
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* xa_s = reinterpret_cast<float*>(smem);   // epilogue aliases
  float* b_s = xa_s + BM * LDXA;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {}, xa[4][RT] = {};

  const int nk = (K + BK - 1) / BK;
  auto load_stage = [&](int kt, int st) {
    const int k0 = kt * BK;
    float* base = ring + st * STAGE;
    load_tile<float, BM, BK, VEC>(base, LDX, x + (long)m0 * K + k0, K, M - m0,
                                  K - k0, tid);
    load_tile<float, BK, BN, VEC>(base + BM * LDX, LDW, w + (long)k0 * N + n0, N,
                                  K - k0, N - n0, tid);
    load_tile<float, BK, RP, VEC>(base + BM * LDX + BK * LDW, LDA, a + (long)k0 * r,
                                  r, K - k0, r, tid);
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
    const float* x_s = ring + (kt % STAGES) * STAGE;
    const float* w_s = x_s + BM * LDX;
    const float* a_s = w_s + BK * LDW;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float xr[4], wc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xr[i] = x_s[(ty + 16 * i) * LDX + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) wc[j] = w_s[k * LDW + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xr[i], wc[j], acc[i][j]);
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        const float av = a_s[k * LDA + tx + 16 * t];
#pragma unroll
        for (int i = 0; i < 4; ++i) xa[i][t] = fmaf(xr[i], av, xa[i][t]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < RT; ++t) xa_s[(ty + 16 * i) * LDXA + tx + 16 * t] = xa[i][t];
  load_tile<float, RP, BN, VEC>(b_s, LDB, b + n0, N, r, N - n0, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      float lo = 0.f;
      for (int t = 0; t < RP; ++t)
        lo = fmaf(xa_s[(ty + 16 * i) * LDXA + t], b_s[t * LDB + tx + 16 * j], lo);
      if (gm < M && gn < N) out[(long)gm * N + gn] = acc[i][j] + s * lo;
    }
  }
}

template <int RT, bool VEC>
cudaError_t launch(int bf, const void* x, const void* w, const void* a,
                   const void* b, void* out, int M, int N, int K, int r,
                   float s, cudaStream_t stream) {
  if (bf) {
    const int smem = tc_smem_bytes(RT);
    auto kernel = lora_bf16_kernel<RT, VEC>;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    const dim3 grid((N + tc::BN - 1) / tc::BN, (M + tc::BM - 1) / tc::BM);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<const bf16*>(a), static_cast<const bf16*>(b),
        static_cast<bf16*>(out), M, N, K, r, s);
    return cudaGetLastError();
  }
  const int smem = fp_smem_bytes(RT);
  auto kernel = lora_f32_kernel<RT, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + fp::BN - 1) / fp::BN, (M + fp::BM - 1) / fp::BM);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), M, N, K, r, s);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_rank(int bf, const void* x, const void* w, const void* a,
                        const void* b, void* out, int M, int N, int K, int r,
                        float s, cudaStream_t st) {
  switch ((r + 15) / 16) {
    case 1: return launch<1, VEC>(bf, x, w, a, b, out, M, N, K, r, s, st);
    case 2: return launch<2, VEC>(bf, x, w, a, b, out, M, N, K, r, s, st);
    case 3: return launch<3, VEC>(bf, x, w, a, b, out, M, N, K, r, s, st);
    case 4: return launch<4, VEC>(bf, x, w, a, b, out, M, N, K, r, s, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (M,K), w (K,N), a (K,r), b (r,N), out (M,N): contiguous, one dtype
// (is_bf16 = 1: bfloat16, 0: float32), base addresses 16-byte aligned,
// 1 <= r <= 64. `vec` = 1 when K, N and r are whole 16-byte vectors
// (16-byte copies), else element copies. Returns cudaGetLastError().
int lora_matmul_launch(const void* x, const void* w, const void* a,
                       const void* b, void* out, int M, int N, int K, int r,
                       float s, int is_bf16, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r < 1 || r > 64 || M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
  return vec ? launch_rank<true>(is_bf16, x, w, a, b, out, M, N, K, r, s, st)
             : launch_rank<false>(is_bf16, x, w, a, b, out, M, N, K, r, s, st);
}

}  // extern "C"
