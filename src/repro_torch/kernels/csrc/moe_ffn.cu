// Batched expert SwiGLU FFN for Hopper (sm_90a):
//
//   out[e] = (silu(buf[e] @ Wg[e]) * (buf[e] @ Wu[e])) @ Wd[e]
//   buf (E,C,d), Wg/Wu (E,d,ff), Wd (E,ff,d), out (E,C,d)
//
// Replaces the TPU kernel `moe_expert_ffn_ecd` / `_moe_ffn_kernel` in
// src/repro/kernels/moe_ffn.py: per expert, gate and up accumulate in
// f32, the SwiGLU is taken in f32, the down product accumulates in f32
// and the result is rounded to buf's dtype once. In bf16 the hidden is
// rounded to bf16 once, for the tensor cores. Rows of buf that are all
// zero (empty capacity slots, empty experts) give exact zeros:
// silu(0) * 0 = 0, and a zero row of the hidden gives a zero output row.
//
// `fill` (optional, (E,) int32 on the device): expert e's rows at or past
// fill[e] give zeros, whatever buf holds there. The MoE block fills each
// expert's capacity buffer from position 0 on, so its rows past the fill
// are zero anyway; with the fill the kernel skips the tiles that lie
// wholly past it instead of multiplying zeros.
//
// What bounds it: operations. At the MoE training path's shape (E = 32,
// C = 1280, d = 1024, ff = 512, bf16) the three products are
// 3 * 2 * E * C * d * ff = 128.8 GFLOP on 268 MB of operands (buf, the
// three weights, the output), ~480 flops per byte, above the ~295 at
// which an H100 stops being memory bound.
//
// Two passes. On the TPU the (block_c, d) f32 output accumulator stays in
// VMEM while the kernel loops over ff blocks; at d = 1024 that is 512 KB
// for 128 rows, more than an SM holds. So the hidden (E, C, ff) makes one
// round trip through device memory in bf16 (84 MB at the path shape,
// ~25 us at 3.35 TB/s; L2 keeps part of it between the passes).
//
// bf16 (`wgmma`, the design the wrapper's plan picks): both passes are one
// warp-specialised kernel, 1 block an SM, three warpgroups. The
// producer's one thread keeps a ring of 192 KB filled by TMA (128-byte
// swizzled boxes, one "full" and one "empty" mbarrier a stage); two
// consumer warpgroups of 64 rows each run wgmma (bf16 in, f32
// accumulators in registers, B through the transpose bit) and release
// each stage once the next step's wgmma is in flight.
//
//   pass 1: hidden = silu(buf @ Wg) * (buf @ Wu), one block per 128-row
//           x 128-column tile of one expert's hidden. A stage holds the
//           128 x 64 buf tile and, as B, two 64 x 64 boxes of Wg beside
//           the same two boxes of Wu, so one m64n256k16 accumulator holds
//           gate in columns j and up in j + 128: the same thread holds
//           both, and the SwiGLU is taken in registers in the epilogue
//           (4 stages of 48 KB).
//   pass 2: out = hidden @ Wd, 128 x BN tiles, BN 256 or 128 by the
//           plan's waves rule (4 or 6 stages).
//
// The epilogues go through shared memory: once both warpgroups are done
// with the ring, each writes its 64 rows, rounded to bf16, as 64 x 64
// boxes in the 128-byte swizzled layout and one thread stores them by
// TMA. From registers, each warp's 4-byte stores hit 8 rows 16 bytes at
// a time; at ff 512 that made pass 2's 8-step tiles wait on their stores.
//
// Every operand is read through a 3-D tensor map (E, rows, cols), so a
// tile's ragged edge zero-fills inside its own expert: a 2-D view over
// (E * C, d) would read the next expert's rows of buf, Wg, Wu or Wd there.
// The stores go through 3-D maps too, which leave out rows past C and
// columns past d or ff. TMA needs 16-byte row strides: the wrapper
// zero-pads d and ff to multiples of 8 where they are not (no MoE config
// is ragged). Tiles wholly past an expert's fill are skipped: pass 1
// leaves their hidden unwritten, pass 2 stores their zeros without
// reading it. Inside a partly live tile both epilogues store zeros for
// the rows past the fill, and a consumer warpgroup whose 64 rows are all
// past it issues no wgmma. Blocks run expert by expert, row tiles
// fastest, so the blocks that run together share their expert's weight
// tiles in L2.
//
// Left in it: a 64-deep step takes ~0.9 us where the tensor cores need
// 0.56 (the rate `lora_matmul`'s same tile shape runs at), so pass 1 is
// the larger share; each block fills its ring from empty, with no other
// tile's loads behind its epilogue; the hidden's round trip. Tried and
// dropped (PERF.md): a persistent grid (one block an SM over tiles
// gridDim.x apart; slower with the fill, whose dead tiles leave blocks
// unevenly loaded) and clusters of two blocks sharing their weight boxes
// by TMA multicast (slower at every shape).
//
// The first bf16 design stays as `mma_sync` (mma.sync m16n8k16 fed by
// ldmatrix from a 3-stage cp.async ring, every warp 32 x 64 of a 128 x 128
// tile; pass 1 64 columns of gate beside the same 64 of up), and f32 runs
// on CUDA-core FMA (`fma`), not TF32, which would miss the f32 plain
// version's tolerance. Both mask ragged C, d and ff inside the kernel
// and take the fill the same way.
//
// Every mbarrier wait is bounded: a wait that fails ~2^26 times traps, so
// a protocol bug surfaces as a CUDA error at the next synchronize and not
// as a hung card.
//
// Plain C interface, loaded with ctypes by repro_torch/kernels/build.py;
// launches both passes on the caller's stream and returns
// cudaGetLastError(). cuTensorMapEncodeTiled is reached through the
// runtime's driver entry point, so nothing links libcuda.

#include <atomic>

#include <cuda.h>
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

// rows of expert `ex` that are live: fill[ex] clamped to [0, rows], or
// every row without a fill
__device__ __forceinline__ int live_rows(const int* fill, long ex, int rows) {
  return fill ? min(max(fill[ex], 0), rows) : rows;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills the destination when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n));
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

// zeros over rows [m0, m0 + ROWS) x cols [n0, n0 + COLS) of a row-major
// (M, N) matrix, clipped to it
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void zero_tile(T* out, int M, int N, int m0, int n0, int tid) {
  for (int i = tid; i < ROWS * COLS; i += kThreads) {
    const int row = m0 + i / COLS, col = n0 + i % COLS;
    if (row < M && col < N) out[(long)row * N + col] = zero<T>();
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// bf16 `mma_sync`: the first design
// ---------------------------------------------------------------------------

namespace tc {
constexpr int BM = 128, BN = 128, BK = 64, PAD = 8, STAGES = 3;
constexpr int LDA = BK + PAD, LDB = BN + PAD;
constexpr int STAGE = BM * LDA + BK * LDB;          // bf16 elements
constexpr int SMEM = STAGES * STAGE * 2;            // bytes
}  // namespace tc

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

// One expert's (M x K) @ (K x N) per blockIdx.z, bf16 in, f32 accumulate.
// SWIGLU: out (M x N) = silu(a @ b0) * (a @ b1), the block covering 64
// output columns (its B tile: 64 columns of b0 beside the same 64 of b1).
// Else: out = a @ b0, the block covering 128 output columns.
// Strides sa, sb, so step the three operands from one expert to the next.
// Rows at or past the expert's fill store zeros; a tile wholly past it
// returns at once (SWIGLU: its hidden is never read) or stores its zeros.
template <bool SWIGLU, bool VEC>
__global__ void __launch_bounds__(kThreads)
ffn_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b0,
                const bf16* __restrict__ b1, bf16* __restrict__ out,
                const int* __restrict__ fill, int M, int N, int K, long sa,
                long sb, long so) {
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
  const int live = live_rows(fill, ex, M);
  if (m0 >= live) {
    if constexpr (!SWIGLU) zero_tile<bf16, BM, WIDTH>(out, M, N, m0, n0, tid);
    return;
  }

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
        if (gm >= live) v0 = v1 = 0.f;
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
// bf16 `wgmma`: TMA ring, warp-specialised warpgroup MMA
// ---------------------------------------------------------------------------

namespace wg {
constexpr int BM = 128, BK = 64, THREADS = 384;
constexpr int A_BYTES = BM * BK * 2;     // buf / hidden tile: 128 rows of 128 bytes
constexpr int BOX_BYTES = BK * 64 * 2;   // one 64 (deep) x 64 (wide) weight box
// BN: accumulator columns of a block (pass 1: 256, gate and up)
template <int BN> __host__ __device__ constexpr int stage_bytes() {
  return A_BYTES + BN / 64 * BOX_BYTES;
}
// a 192 KB ring: 6 stages for BN 128, 4 for BN 256
template <int BN> __host__ __device__ constexpr int stages() {
  return 196608 / stage_bytes<BN>();
}
// the ring, its full and empty barriers, and slack to align it to 1 KB
template <int BN> __host__ __device__ constexpr int smem_bytes() {
  return stages<BN>() * stage_bytes<BN>() + 2 * 8 * stages<BN>() + 1024;
}
}  // namespace wg

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

// one 3-D TMA box (coordinates: column, row, expert) into shared memory;
// the bytes land on `bar`'s transaction count
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int col, int row, int ex) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(ex)
      : "memory");
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
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them
template <int R> __device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 f32, 64 a thread) = A (64 x 16, K-major) * B (16 x 128,
// MN-major, so tnspB = 1) + (accumulate ? d : 0), both from shared
// memory; bf16 inputs
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 256 f32, 128 a thread) = A (64 x 16, K-major) * B (16 x 256,
// MN-major, so tnspB = 1) + (accumulate ? d : 0), both from shared
// memory; bf16 inputs
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int BN> __device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                                             uint64_t db, int accumulate) {
  if constexpr (BN == 128) wgmma_n128(d, da, db, accumulate);
  else wgmma_n256(d, da, db, accumulate);
}

// one 3-D TMA box (coordinates: column, row, expert) from shared memory
// to global memory; elements past the tensor's edges are not written
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int col,
                                             int row, int ex) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row), "r"(ex)
      : "memory");
}
// barrier `id` over `count` threads (ids 1.. are free: __syncthreads uses 0)
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// One 128-row x WIDTH-column tile of one expert per block, blocks
// expert-major and row tiles fastest: blockIdx.x = (ex * num_n + n tile)
// * num_m + m tile. The depth is nk steps of 64. Shared memory per stage:
// the 128 x 64 A tile (consumer c reads rows 64c..64c+63, 8 KB in), then
// BN/64 boxes of 64 deep x 64 wide of B, 8 KB apart.
// SWIGLU (BN 256): out (E, M, N) = silu(a @ b0) * (a @ b1) over 128
// columns; boxes 0, 1 are columns n0.., n0+64.. of b0 and boxes 2, 3 the
// same columns of b1, so accumulator column j is gate and j + 128 up.
// Else: out = a @ b0 over BN columns (tm_b1 unused).
// out is (E, M, N) row-major, N % 8 == 0, written through tm_out in boxes
// of 64 x 64.
// The fill: a tile whose first row is past it has nothing to compute
// (pass 1 returns: pass 2 never reads its hidden; pass 2 stores zeros). A
// warpgroup whose 64 rows all lie past it issues no wgmma, and rows past
// it store zeros.
template <bool SWIGLU, int BN>
__global__ void __launch_bounds__(wg::THREADS, 1)
ffn_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                 const __grid_constant__ CUtensorMap tm_b0,
                 const __grid_constant__ CUtensorMap tm_b1,
                 const __grid_constant__ CUtensorMap tm_out, const int* __restrict__ fill,
                 int M, int N, int nk, int num_m, int num_n) {
  using namespace wg;
  static_assert(!SWIGLU || BN == 256, "pass 1 holds gate and up in one n256 accumulator");
  constexpr int S = stages<BN>(), STAGE = stage_bytes<BN>(), R = BN / 2;
  constexpr int WIDTH = SWIGLU ? BN / 2 : BN;       // output columns per block
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles need 1024-byte aligned bases
  const uint32_t tiles = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = tiles + S * STAGE, empty0 = full0 + 8 * S;

  const int ex = blockIdx.x / (num_m * num_n), t = blockIdx.x % (num_m * num_n);
  const int m0 = (t % num_m) * BM, n0 = (t / num_m) * WIDTH;
  const int live = live_rows(fill, ex, M);
  if constexpr (SWIGLU) {
    if (m0 >= live) return;
  }
  const int steps = m0 < live ? nk : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full0 + 8 * i, 1);    // the producer's expect_tx
      mbar_init(empty0 + 8 * i, 2);   // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int group = threadIdx.x / 128;

  if (group == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int i = 0; i < steps; ++i) {
        const int st = i % S;
        mbar_wait(empty0 + 8 * st, ((i / S) & 1) ^ 1);   // passes on the first lap
        const uint32_t bar = full0 + 8 * st, dst = tiles + st * STAGE;
        mbar_expect_tx(bar, STAGE);
        const int k0 = i * BK;
        tma_load_3d(dst, &tm_a, bar, k0, m0, ex);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) {
          if constexpr (SWIGLU)
            tma_load_3d(dst + A_BYTES + j * BOX_BYTES, j < 2 ? &tm_b0 : &tm_b1, bar,
                        n0 + 64 * (j % 2), k0, ex);
          else
            tma_load_3d(dst + A_BYTES + j * BOX_BYTES, &tm_b0, bar, n0 + 64 * j, k0, ex);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = group - 1;
    // this warpgroup's 64 rows all lie past the fill (so do a dead tile's):
    // it only releases, and stores zeros
    const bool idle = m0 + c * 64 >= live;
    // written whole by the tile's first wgmma (accumulate 0): a zero fill
    // by other instructions would sit in the wgmma pipeline, which ptxas
    // then serializes (C7515)
    float acc[R];
    auto release = [&](int st) {
      if (threadIdx.x % 128 == 0) mbar_arrive(empty0 + 8 * st);
    };
    int held = -1;   // the stage the wgmma group in flight reads
    for (int i = 0; i < steps; ++i) {
      const int st = i % S;
      mbar_wait(full0 + 8 * st, (i / S) & 1);
      if (idle) {
        release(st);
        continue;
      }
      const uint32_t a_s = tiles + st * STAGE + c * 64 * 128;
      const uint32_t b_s = tiles + st * STAGE + A_BYTES;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A: K-major, 16 deep = 32 bytes along the swizzled row; 8-row
        // groups 1024 bytes apart. B: N-major, 16 deep = 16 rows of 128
        // bytes; 64-wide boxes BOX_BYTES apart, 8-row groups 1024 apart.
        wgmma_tile<BN>(acc, sw128_desc(a_s + kk * 32, 16, 1024),
                       sw128_desc(b_s + kk * 2048, BOX_BYTES, 1024), i > 0 || kk > 0);
      }
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();   // step i-1's group is done with its stage
      fence_acc(acc);
      if (held >= 0) release(held);
      held = st;
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // acc[4j + 2h + e]: row 16 * warp + lane / 4 + 8h, column 8j + 2 (lane % 4) + e;
    // SWIGLU: up of gate column j at accumulator column j + 128, acc[64 + ...]
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    // the epilogue through shared memory: every stage has been read (each
    // warpgroup waited on every full barrier and on its wgmma), so once
    // both warpgroups are here the ring is free. Warpgroup c writes its
    // 64 rows as WIDTH/64 boxes of 64 x 64 in the 128-byte swizzled
    // layout (16-byte chunk q of row r at chunk q ^ (r % 8): a warp's
    // 4-byte stores hit 32 distinct banks) and one thread stores them by
    // TMA, which leaves out rows past M and columns past N.
    named_sync(1, 256);
    const uint32_t base = tiles + c * (64 * WIDTH * 2);
#pragma unroll
    for (int j = 0; j < WIDTH / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + lane / 4 + 8 * h;   // row in the warpgroup's 64
        float v0 = 0.f, v1 = 0.f;
        if (!idle && m0 + c * 64 + r < live) {
          v0 = acc[4 * j + 2 * h];
          v1 = acc[4 * j + 2 * h + 1];
          if constexpr (SWIGLU) {
            v0 = silu(v0) * acc[64 + 4 * j + 2 * h];
            v1 = silu(v1) * acc[64 + 4 * j + 2 * h + 1];
          }
        }
        const uint32_t addr = base + (j / 8) * 8192 + r * 128 +
                              (((j % 8) ^ (r % 8)) << 4) + (lane % 4) * 4;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(pack_bf16(v0, v1))
                     : "memory");
      }
    }
    // the generic-proxy writes above, seen by the TMA (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(2 + c, 128);
    if (threadIdx.x % 128 == 0) {
#pragma unroll
      for (int b = 0; b < WIDTH / 64; ++b)
        tma_store_3d(&tm_out, base + b * 8192, n0 + 64 * b, m0 + c * 64, ex);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // shared memory stays the block's until the TMA has read it
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// ---------------------------------------------------------------------------
// f32 `fma`: CUDA-core FMA (no TF32)
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
// j < 2 are the thread's gate columns and j + 2 their up columns. Rows
// past the fill as in ffn_bf16_kernel.
template <bool SWIGLU, bool VEC>
__global__ void __launch_bounds__(kThreads)
ffn_f32_kernel(const float* __restrict__ a, const float* __restrict__ b0,
               const float* __restrict__ b1, float* __restrict__ out,
               const int* __restrict__ fill, int M, int N, int K, long sa, long sb,
               long so) {
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
  const int live = live_rows(fill, ex, M);
  if (m0 >= live) {
    if constexpr (!SWIGLU) zero_tile<float, BM, WIDTH>(out, M, N, m0, n0, tid);
    return;
  }
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
      float v = acc[i][j];
      if constexpr (SWIGLU) v = silu(v) * acc[i][j + 2];
      out[(long)gm * N + gn] = gm < live ? v : 0.f;
    }
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

// one pass of the first designs: grid (column tiles, row tiles, experts)
template <typename T, bool SWIGLU, bool VEC>
cudaError_t launch_pass(const T* a, const T* b0, const T* b1, T* out, const int* fill, int E,
                        int M, int N, int K, cudaStream_t stream) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int BM = BF ? tc::BM : fp::BM;
  constexpr int WIDTH = (BF ? tc::BN : fp::BN) / (SWIGLU ? 2 : 1);
  const dim3 grid((N + WIDTH - 1) / WIDTH, (M + BM - 1) / BM, E);
  const long sa = (long)M * K, sb = (long)K * N, so = (long)M * N;
  if constexpr (BF) {
    auto kernel = ffn_bf16_kernel<SWIGLU, VEC>;
    static std::atomic<unsigned long long> done{0};
    const cudaError_t err = allow_smem(kernel, tc::SMEM, done);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, tc::SMEM, stream>>>(a, b0, b1, out, fill, M, N, K, sa, sb, so);
  } else {
    ffn_f32_kernel<SWIGLU, VEC><<<grid, kThreads, fp::SMEM, stream>>>(a, b0, b1, out, fill, M,
                                                                       N, K, sa, sb, so);
  }
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_first(const void* buf, const void* wg, const void* wu, const void* wd,
                         void* hidden, void* out, const int* fill, int E, int C, int d,
                         int ff, cudaStream_t stream) {
  const T* x = static_cast<const T*>(buf);
  T* h = static_cast<T*>(hidden);
  cudaError_t err = launch_pass<T, true, VEC>(x, static_cast<const T*>(wg),
                                              static_cast<const T*>(wu), h, fill, E, C, ff,
                                              d, stream);
  if (err != cudaSuccess) return err;
  return launch_pass<T, false, VEC>(h, static_cast<const T*>(wd), nullptr,
                                    static_cast<T*>(out), fill, E, C, d, ff, stream);
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

// TMA map of a row-major bf16 (experts, rows, cols) tensor, cols a
// multiple of 8, in 128-byte swizzled boxes of box_rows x 64 inside one
// expert; reads past the rows or columns of an expert give zeros
bool bf16_map3(EncodeTiled encode, CUtensorMap* map, const void* ptr, int experts, int rows,
               int cols, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)experts};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// one wgmma pass: out (E, M, N) from a (E, M, K) and b0 / b1 (E, K, N)
template <bool SWIGLU, int BN>
cudaError_t launch_wgmma_pass(const CUtensorMap& a, const CUtensorMap& b0, const CUtensorMap& b1,
                              const CUtensorMap& m_out, const int* fill, int E, int M, int N,
                              int K, cudaStream_t st) {
  constexpr int WIDTH = SWIGLU ? BN / 2 : BN;
  const int num_m = (M + wg::BM - 1) / wg::BM, num_n = (N + WIDTH - 1) / WIDTH;
  const long grid = (long)E * num_m * num_n;
  if (grid > 0x7FFFFFFF) return cudaErrorInvalidValue;
  auto kernel = ffn_wgmma_kernel<SWIGLU, BN>;
  static std::atomic<unsigned long long> done{0};
  const cudaError_t err = allow_smem(kernel, wg::smem_bytes<BN>(), done);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)grid, wg::THREADS, wg::smem_bytes<BN>(), st>>>(
      a, b0, b1, m_out, fill, M, N, (K + wg::BK - 1) / wg::BK, num_m, num_n);
  return cudaGetLastError();
}

cudaError_t launch_wgmma(const void* buf, const void* wg, const void* wu, const void* wd,
                         void* hidden, void* out, const int* fill, int E, int C, int d, int ff,
                         int block_n, cudaStream_t st) {
  if (d % 8 || ff % 8 || (block_n != 128 && block_n != 256)) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  // the hidden is read as pass 2's 128-row A tiles and stored by pass 1's
  // warpgroups in 64-row boxes: one map each
  CUtensorMap m_buf, m_wg, m_wu, m_h, m_wd, m_hs, m_out;
  if (!bf16_map3(encode, &m_buf, buf, E, C, d, wg::BM) ||
      !bf16_map3(encode, &m_wg, wg, E, d, ff, 64) || !bf16_map3(encode, &m_wu, wu, E, d, ff, 64) ||
      !bf16_map3(encode, &m_h, hidden, E, C, ff, wg::BM) ||
      !bf16_map3(encode, &m_wd, wd, E, ff, d, 64) ||
      !bf16_map3(encode, &m_hs, hidden, E, C, ff, 64) || !bf16_map3(encode, &m_out, out, E, C, d, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = launch_wgmma_pass<true, 256>(m_buf, m_wg, m_wu, m_hs, fill, E, C, ff, d, st);
  if (err != cudaSuccess) return err;
  return block_n == 256
             ? launch_wgmma_pass<false, 256>(m_h, m_wd, m_wd, m_out, fill, E, C, d, ff, st)
             : launch_wgmma_pass<false, 128>(m_h, m_wd, m_wd, m_out, fill, E, C, d, ff, st);
}

}  // namespace

extern "C" {

// Variants of moe_ffn_launch
enum { kFma = 0, kMmaSync = 1, kWgmma = 2 };

// buf (E,C,d), wg/wu (E,d,ff), wd (E,ff,d), hidden (E,C,ff) scratch,
// out (E,C,d): contiguous, one dtype. fill: (E,) int32 or null (every
// row live). variant kFma takes float32; kMmaSync and kWgmma bfloat16.
// kFma / kMmaSync: `vec` = 1 when d and ff are whole 16-byte vectors and
// every base address is 16-byte aligned (16-byte copies), else element
// copies. kWgmma: d and ff multiples of 8, 16-byte aligned bases,
// block_n (pass 2's tile width) 128 or 256. Returns cudaGetLastError().
int moe_ffn_launch(const void* buf, const void* wg, const void* wu, const void* wd,
                   void* hidden, void* out, const int* fill, int E, int C, int d, int ff,
                   int variant, int vec, int block_n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E < 1 || C < 1 || d < 1 || ff < 1) return cudaErrorInvalidValue;
  if (variant == kWgmma)
    return launch_wgmma(buf, wg, wu, wd, hidden, out, fill, E, C, d, ff, block_n, st);
  if (E > 65535) return cudaErrorInvalidValue;
  if (variant == kMmaSync)
    return vec ? launch_first<bf16, true>(buf, wg, wu, wd, hidden, out, fill, E, C, d, ff, st)
               : launch_first<bf16, false>(buf, wg, wu, wd, hidden, out, fill, E, C, d, ff, st);
  if (variant == kFma)
    return vec ? launch_first<float, true>(buf, wg, wu, wd, hidden, out, fill, E, C, d, ff, st)
               : launch_first<float, false>(buf, wg, wu, wd, hidden, out, fill, E, C, d, ff, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
