// Fused frozen-weight + LoRA matmul for Hopper (sm_90a):
//
//   out = x @ W + s * ((x @ A) @ B)      x (M,K), W (K,N), A (K,r), B (r,N)
//
// Replaces the TPU kernel `lora_matmul` / `_lora_kernel` in
// src/repro/kernels/lora_matmul.py, and computes what its body computes:
// f32 sums of x@W and x@A over the whole depth, x@A rounded to B's dtype
// (`:89`), the rank product in f32, and `acc + s * lora` rounded to x's
// dtype. s = alpha / r arrives by value. Any r.
//
// What bounds it: operations. At the training path's shape (M = 4096
// tokens, K = N = 4096, r = 32, bf16) it does 2*M*N*K + 2*M*r*(K+N)
// = 139.5 GFLOP on 100 MB of operands, ~1,400 flops per byte, far above
// the ~295 at which an H100 stops being memory bound. Two changes of the
// TPU kernel's order keep the tensor cores on x@W alone:
//
//   * A pre-pass computes xa = round(x @ A) once per call into an (M,
//     r_pad) scratch, r_pad = r rounded up to 64, columns past r zero.
//     The TPU kernel's blocks recompute x@A for every N tile (N/128 times
//     over); the pre-pass reads x once and is memory bound. bf16: one
//     block per 32 rows x 64 rank columns, mma.sync m16n8k16 fed by a
//     cp.async ring, so registers do not grow with r.
//   * The main kernel takes the rank product as the first r_pad/64 steps
//     of one GEMM over the depth [r_pad | K]: xa tiles times B tiles,
//     then the f32 accumulators are scaled by s in registers, then x@W
//     accumulates onto them. That is `s * lora + acc` in another order of
//     f32 sums, with no second accumulator and no shared memory that
//     grows with r. s is not folded into xa or B: round(s * xa) differs
//     from s * round(xa).
//
// bf16 main kernel: one 128 x BN output tile per block (BN 128 or 256,
// which the wrapper's plan picks by waves of blocks), three warpgroups.
// The producer's one thread issues TMA loads of the x / xa tile (128 rows
// x 64 deep, K-major) and of BN/64 boxes of 64 x 64 of W / B (N-major,
// row-major (K, N)), all 128-byte swizzled, into a ring of 6 (BN 128) or
// 4 (BN 256) stages of 192 KB in all, with one "full" and one "empty"
// mbarrier each. Two consumer
// warpgroups wait on "full", run wgmma m64nBNk16 (bf16 in, f32
// accumulators in registers; B through the transpose bit) on their 64
// rows, keep one wgmma group in flight and release the stage before it.
// The epilogue rounds to bf16 and stores with masked 4-byte stores. Blocks
// are rastered in groups of 8 M tiles, so blocks that run together share
// W tiles in L2. TMA needs 16-byte row strides: the wrapper zero-pads x
// along K, W, B and the output along N, and A along r (for the
// pre-pass's vector loads) to multiples of 8 where a shape is ragged (no
// training path's shape is).
//
// f32 (off the training paths) runs on CUDA-core FMA, not TF32, which
// would miss the f32 plain version's tolerance: the pre-pass and the main
// pass are the same tiled FMA kernel, the main pass over [r | K].
//
// Every mbarrier wait is bounded: a wait that fails ~2^26 times traps, so
// a protocol bug surfaces as a CUDA error at the next synchronize and not
// as a hung card.
//
// The input gradient (the backward's one large product; replaces no TPU
// kernel: the JAX package differentiates `lora_matmul_ref` in f32, the VJP
// `_lora_bwd`, src/repro/kernels/ops.py:206-212):
//
//   dx = g @ W^T + (s * g @ B^T) @ A^T       g (M,N) -> dx (M,K)
//
// It is 2*M*N*K operations, as the forward's, on the same operands. On the
// bf16 path g, W, A and B hold bf16 values, so bf16 products with f32
// accumulators form the f32 VJP's products exactly and sum them in f32; only
// the order of the sums moves. Two launches, the forward's design with the
// roles of K and N swapped:
//
//   * A pre-pass computes g_xa = s * (g @ B^T) over the depth N in f32 (the
//     forward's pre-pass, B's rows read as the columns of B^T; each 256-deep
//     tile's MMA sums added into f32 registers, as below), and writes it
//     twice: as f32 (M, r_pad), which dA = x^T @ g_xa takes, and split
//     into three bf16 terms hi + mid + lo whose sum is each f32 value
//     exactly (8 significant bits each, 24 in all), as (M, 3 r_pad)
//     [hi | mid | lo]. g_xa is never rounded to bf16 once.
//   * The main kernel runs one GEMM over the depth [3 r_pad | N]: the three
//     terms against A^T (the rank steps read A's columns once per term),
//     then g @ W^T, all into one f32 accumulator, rounded to bf16 once.
//     W (K, N) and A (K, r) are row-major, so each is already contiguous
//     along this GEMM's depth: one TMA box of BN rows x 64 deep is the
//     wgmma B operand as it lies (K-major, tnspB = 0); no copy, no
//     transpose, no f32 copy of W. The wgmma sums of every 4 depth steps
//     are added into the f32 accumulator on the CUDA cores, so that dx
//     keeps f32's rounding over depths of 16K and more (the tensor cores'
//     own accumulator does not; see lora_wgmma_kernel); that holds two
//     accumulators in registers, so dx's tiles are 128 x 128.
//
// Plain C interface, loaded with ctypes by repro_torch/kernels/build.py;
// launches on the caller's stream and returns cudaGetLastError().
// cuTensorMapEncodeTiled is reached through the runtime's driver entry
// point, so nothing links libcuda.

#include <atomic>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() {
  return __float2bfloat16(0.f);
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
// memory (row stride ldd) by THREADS threads, zeros past rows_left /
// cols_left. VEC: asynchronous 16-byte copies (the caller guarantees
// whole 16-byte rows and base); else synchronous element copies.
template <typename T, int ROWS, int COLS, bool VEC, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, int ldd, const T* src,
                                          long ld, int rows_left,
                                          int cols_left, int tid) {
  if constexpr (VEC) {
    constexpr int G = 16 / (int)sizeof(T), GPR = COLS / G;
    static_assert(COLS % G == 0, "tile width is whole vectors");
    for (int g = tid; g < ROWS * GPR; g += THREADS) {
      const int row = g / GPR, col = (g % GPR) * G;
      const bool ok = row < rows_left && col < cols_left;
      cp_async16(dst + row * ldd + col, ok ? src + (long)row * ld + col : src, ok);
    }
  } else {
    for (int i = tid; i < ROWS * COLS; i += THREADS) {
      const int row = i / COLS, col = i % COLS;
      dst[row * ldd + col] =
          (row < rows_left && col < cols_left) ? src[(long)row * ld + col] : zero<T>();
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// bf16 pre-pass: xa = round_bf16(x @ A), mma.sync
// ---------------------------------------------------------------------------

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

namespace pre {
// 32 x 256 tiles of x in a ring of 3; the 8 warps are 2 row groups of
// 16 times 4 depth slices of 64
constexpr int BM = 32, BR = 64, BK = 256, STAGES = 3, THREADS = 256, PAD = 8;
constexpr int KS = 4, KW = BK / KS;
constexpr int LDX = BK + PAD, LDA = BR + PAD, LDR = BR + 4;
constexpr int STAGE = BM * LDX + BK * LDA;   // bf16 elements
constexpr int SMEM = STAGES * STAGE * 2;     // 161,280 bytes
static_assert(KS * BM * LDR * 4 <= SMEM, "the partial sums fit in the ring");
static_assert(BM * 8 == THREADS, "one 8-column run of xa per thread");
static_assert(BR * LDX <= BK * LDA, "a tile of B^T fits where a tile of A goes");
}  // namespace pre

// v0 and v1 as three bf16 pairs that add up to them exactly: each term
// keeps 8 significant bits of what the ones before it left, so three hold
// f32's 24 (every difference below is exact). Exact down to |v| = 2^-110,
// where the last term, a multiple of v's f32 ulp, is still a bf16 value;
// below, off by less than bf16's least step, 2^-133.
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = v0 - hf.x, r1 = v1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// One block per 32 rows x 64 rank columns, 8 warps: a warp owns 16 rows
// and one depth slice of each 256-deep tile, all 64 columns, so eight
// warps keep the MMA pipe busy where one x tile is small; the depth
// slices' partial sums are added through shared memory at the end.
// Column pairs at or past r are skipped (r = 32 does half the MMAs of
// r = 64). x and the second operand are read in whole 16-byte vectors: the
// wrapper pads x's rows and A's (width r) or B's (width K) to multiples
// of 8. Block b walks the depth tiles from tile b on, so that the blocks
// do not all ask L2 for the same tile of the second operand at once.
//
// BT = false (the forward): xa = round_bf16(x @ A), A (K, r) row-major,
// into xa (M, r_pad). BT = true (the input gradient): x is g (M, K = the
// depth N) and `a` is B (r, K) with x's row stride, read as B^T; the sums
// times s go to xa32 (M, r_pad) in f32 and, split by split3, to xa (M,
// 3 r_pad) as [hi | mid | lo].
template <bool BT>
__global__ void __launch_bounds__(pre::THREADS)
xa_bf16_kernel(const bf16* __restrict__ x, int ldx, const bf16* __restrict__ a,
               bf16* __restrict__ xa, float* __restrict__ xa32, int M, int K, int r, int r_pad,
               float s) {
  using namespace pre;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4, rg = warp % 2, ks = warp / 2;
  const int m0 = blockIdx.x * BM, c0 = blockIdx.y * BR;

  // BT: each depth tile's MMA sums go to `part` from zero and then into
  // acc in f32 (the tensor cores' accumulator drops low bits; see
  // lora_wgmma_kernel), so that g_xa keeps f32's rounding over the depth N
  float acc[8][4], part[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int nk = (K + BK - 1) / BK;
  auto load_stage = [&](int kt, int st) {
    const int k0 = (kt + blockIdx.x) % nk * BK;
    bf16* base = ring + st * STAGE;
    load_tile<bf16, BM, BK, true, THREADS>(base, LDX, x + (long)m0 * ldx + k0, ldx,
                                           M - m0, K - k0, tid);
    if constexpr (BT)
      load_tile<bf16, BR, BK, true, THREADS>(base + BM * LDX, LDX, a + (long)c0 * ldx + k0,
                                             ldx, r - c0, K - k0, tid);
    else
      load_tile<bf16, BK, BR, true, THREADS>(base + BM * LDX, LDA, a + (long)k0 * r + c0, r,
                                             K - k0, r - c0, tid);
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
    const bf16* a_s = x_s + BM * LDX;
    if constexpr (BT) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = ks * KW; kk < ks * KW + KW; kk += 16) {
      uint32_t af[4], bf[4];
      ldsm_x4(af, x_s + (rg * 16 + lane % 16) * LDX + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c0 + 16 * j >= r) continue;   // zero columns: nothing to add
        // the same four 8x8 fragments either way: B^T's rows are the
        // columns of A's layout, so they need no transpose
        if constexpr (BT)
          ldsm_x4(bf, a_s + (j * 16 + lane % 8 + (lane / 16) * 8) * LDX + kk +
                          ((lane / 8) % 2) * 8);
        else
          ldsm_x4_trans(bf, a_s + (kk + lane % 8 + ((lane / 8) % 2) * 8) * LDA + j * 16 +
                                (lane / 16) * 8);
        float(&d)[8][4] = BT ? part : acc;
        mma_bf16(d[2 * j], af, bf[0], bf[1]);
        mma_bf16(d[2 * j + 1], af, bf[2], bf[3]);
      }
    }
    if constexpr (BT) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
    }
  }
  cp_async_wait<0>();
  __syncthreads();                  // the ring is reused below

  // the depth slices' partial sums, then 8 columns of one row at a time
  // summed; columns past r are 0
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* p = red + (ks * BM + rg * 16 + g + 8 * h) * LDR + j * 8 + 2 * t4;
      p[0] = acc[j][2 * h];
      p[1] = acc[j][2 * h + 1];
    }
  __syncthreads();
  const int row = tid / 8, col = (tid % 8) * 8;   // BM * 8 == THREADS
  if (m0 + row >= M) return;
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    v[e] = 0.f;
#pragma unroll
    for (int q = 0; q < KS; ++q) v[e] += red[(q * BM + row) * LDR + col + e];
  }
  const long at = (long)(m0 + row) * r_pad + c0 + col;
  if constexpr (BT) {
    // __fmul_rn: never contracted into an FMA with the split's subtractions
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __fmul_rn(v[e], s);
    *reinterpret_cast<float4*>(xa32 + at) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(xa32 + at + 4) = make_float4(v[4], v[5], v[6], v[7]);
    uint32_t hi[4], mid[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split3(v[2 * e], v[2 * e + 1], hi[e], mid[e], lo[e]);
    bf16* out = xa + (long)(m0 + row) * 3 * r_pad + c0 + col;
    *reinterpret_cast<uint4*>(out) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(out + r_pad) = make_uint4(mid[0], mid[1], mid[2], mid[3]);
    *reinterpret_cast<uint4*>(out + 2 * r_pad) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  } else {
    // rounded to B's dtype once (lora_matmul.py:89)
    uint32_t packed[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) packed[e] = pack_bf16(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<uint4*>(xa + at) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

// ---------------------------------------------------------------------------
// bf16 main kernel: wgmma fed by a TMA ring, warp-specialised
// ---------------------------------------------------------------------------

namespace wg {
constexpr int BM = 128, BK = 64, GROUP_M = 8, THREADS = 384;
// the input gradient adds its wgmma sums into f32 registers every PROMOTE
// depth steps (see lora_wgmma_kernel)
constexpr int PROMOTE = 4;
constexpr int A_BYTES = BM * BK * 2;     // x / xa tile: 128 rows of 128 bytes
constexpr int BOX_BYTES = BK * 64 * 2;   // one 64 (deep) x 64 (wide) box of W / B
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

// one 2-D TMA box (coordinates: column, row) into shared memory; the
// bytes land on `bar`'s transaction count
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
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

// d (64 x 128 f32, 64 a thread) = A (64 x 16, K-major) * B (16 x 128;
// TB = 1: MN-major, TB = 0: K-major) + (acc ? d : 0), both from shared
// memory; bf16 inputs
template <int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}

// d (64 x 256 f32, 128 a thread) = A (64 x 16, K-major) * B (16 x 256;
// TB as wgmma_n128) + (acc ? d : 0), both from shared memory; bf16 inputs
template <int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db, int acc) {
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
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
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
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}

template <int BN, int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                           int acc = 1) {
  if constexpr (BN == 128) wgmma_n128<TB>(d, da, db, acc);
  else wgmma_n256<TB>(d, da, db, acc);
}

// Depth steps 0..nr-1 read xa and B (the rank product), steps nr.. read x
// and W. Shared memory per stage: the 128 x 64 x / xa tile (consumer c
// reads rows 64c..64c+63, 8 KB in), then BN/64 boxes of 64 deep x 64 wide
// of W / B, 8 KB apart.
//
// BWD (the input gradient): xa is the split g_xa (M, 3 r_pad), x is g,
// and the second operands are A (K, r) and W (K, N) as they lie: one box of
// BN rows (dx's columns) x 64 deep each, K-major, the same 128-byte rows
// as the first operand's. Rank step i reads A's columns from (i % nr_b) *
// 64, so each of the three terms meets the same A^T. s is already in g_xa:
// no scaling between the two products. The tensor cores' accumulator does
// not round as f32 adds do (it drops low bits of the products it aligns,
// so its error grows with the number of wgmma steps, not their square
// root): over jamba's depth of 16,544 it left 1.1% of dx's bf16 elements a
// step off the f32 sums, as cuBLAS's bf16 GEMM does. So the wgmma steps
// of each chunk of PROMOTE depth steps sum into a part accumulator,
// started from zero, which is then added into `acc` on the CUDA cores in
// f32, as an FP8 GEMM promotes its partial sums. Both accumulators fit
// in ptxas's budget for a 384-thread block (168 registers a thread) at BN
// 128 only, so BWD runs at BN 128.
template <int BN, bool BWD>
__global__ void __launch_bounds__(wg::THREADS, 1)
lora_wgmma_kernel(const __grid_constant__ CUtensorMap tm_xa,
                  const __grid_constant__ CUtensorMap tm_b,
                  const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_w, bf16* __restrict__ out,
                  int M, int N, int nr, int nr_b, int nk, float s) {
  using namespace wg;
  constexpr int S = stages<BN>(), STAGE = stage_bytes<BN>(), R = BN / 2;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles need 1024-byte aligned bases
  const uint32_t tiles = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = tiles + S * STAGE, empty0 = full0 + 8 * S;

  // grouped raster: GROUP_M M tiles walk the N tiles together
  const int num_m = (M + BM - 1) / BM, num_n = (N + BN - 1) / BN;
  const int per_group = GROUP_M * num_n, pid = blockIdx.x;
  const int first_m = (pid / per_group) * GROUP_M;
  const int group_m = min(num_m - first_m, GROUP_M);
  const int m0 = (first_m + (pid % per_group) % group_m) * BM;
  const int n0 = ((pid % per_group) / group_m) * BN;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full0 + 8 * i, 1);    // the producer's expect_tx
      mbar_init(empty0 + 8 * i, 2);   // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n = nr + nk, group = threadIdx.x / 128;

  if (group == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int i = 0; i < n; ++i) {
        const int st = i % S;
        mbar_wait(empty0 + 8 * st, ((i / S) & 1) ^ 1);   // passes on the first lap
        const uint32_t bar = full0 + 8 * st, dst = tiles + st * STAGE;
        mbar_expect_tx(bar, STAGE);
        const bool rank = i < nr;
        const int k0 = (rank ? i : i - nr) * BK;
        tma_load_2d(dst, rank ? &tm_xa : &tm_x, bar, k0, m0);
        if constexpr (BWD) {
          tma_load_2d(dst + A_BYTES, rank ? &tm_b : &tm_w, bar, rank ? i % nr_b * BK : k0, n0);
        } else {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(dst + A_BYTES + j * BOX_BYTES, rank ? &tm_b : &tm_w, bar, n0 + 64 * j,
                        k0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = group - 1;
    float acc[R];
    float part[BWD ? R : 1];   // BWD: the current chunk's sum
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
    auto release = [&](int st) {
      if (threadIdx.x % 128 == 0) mbar_arrive(empty0 + 8 * st);
    };
    int held = -1;   // the stage the wgmma group in flight reads
    for (int i = 0; i < n; ++i) {
      const int st = i % S;
      mbar_wait(full0 + 8 * st, (i / S) & 1);
      const uint32_t a_s = tiles + st * STAGE + c * 64 * 128;
      const uint32_t b_s = tiles + st * STAGE + A_BYTES;
      // A: K-major, 16 deep = 32 bytes along the swizzled row; 8-row groups
      // 1024 bytes apart. B, forward: N-major, 16 deep = 16 rows of 128
      // bytes; 64-wide boxes BOX_BYTES apart, 8-row groups 1024 apart. B,
      // BWD: K-major as A, BN rows.
      if constexpr (BWD) {
        const bool first = i % PROMOTE == 0;
        fence_acc(part);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)   // a chunk starts its part from zero
          wgmma_tile<BN, 0>(part, sw128_desc(a_s + kk * 32, 16, 1024),
                            sw128_desc(b_s + kk * 32, 16, 1024), !first || kk != 0);
        wgmma_commit();
        fence_acc(part);
        if (i % PROMOTE == PROMOTE - 1 || i == n - 1) {
          wgmma_wait<0>();
          fence_acc(part);
          if (held >= 0) release(held);
          release(st);
          held = -1;
#pragma unroll
          for (int e = 0; e < R; ++e) acc[e] += part[e];
        } else {
          wgmma_wait<1>();   // step i-1's group is done with its stage
          fence_acc(part);
          if (held >= 0) release(held);
          held = st;
        }
        continue;
      }
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_tile<BN, 1>(acc, sw128_desc(a_s + kk * 32, 16, 1024),
                          sw128_desc(b_s + kk * 2048, BOX_BYTES, 1024));
      wgmma_commit();
      fence_acc(acc);
      if (i == nr - 1) {
        // the rank product is whole: scale it by s before x@W lands on it
        wgmma_wait<0>();
        fence_acc(acc);
        if (held >= 0) release(held);
        release(st);
        held = -1;
#pragma unroll
        for (int e = 0; e < R; ++e) acc[e] *= s;
      } else {
        wgmma_wait<1>();   // step i-1's group is done with its stage
        fence_acc(acc);
        if (held >= 0) release(held);
        held = st;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // acc[4j + 2h + e]: row 16 * warp + lane / 4 + 8h, column 8j + 2 (lane % 4) + e
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (col >= N) continue;          // N % 8 == 0: col + 1 < N too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + c * 64 + warp * 16 + lane / 4 + 8 * h;
        if (row < M)
          *reinterpret_cast<uint32_t*>(out + (long)row * N + col) =
              pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA (no TF32), pre-pass and main pass
// ---------------------------------------------------------------------------

namespace fp {
constexpr int BM = 64, BN = 64, BK = 16, PAD = 4, STAGES = 3, THREADS = 256;
constexpr int LDX = BK + PAD, LDW = BN + PAD;
constexpr int STAGE = BM * LDX + BK * LDW;   // f32 elements
constexpr int SMEM = STAGES * STAGE * 4;     // 28,416 bytes
}  // namespace fp

// out (row stride ldo) = s * (xa[:, :r] @ b) + x @ w over the depth
// [r | K]; b (r, ldw) and w (K, ldw) are read in columns < nw, zeros past
// it, and out is written in columns < N. The pre-pass is the same kernel
// with r = 0, w = A, nw = r and N = r_pad, so xa's columns past r are 0.
// 16 x 16 threads; thread (tx, ty) owns rows ty + 16i and columns tx + 16j.
template <bool VEC>
__global__ void __launch_bounds__(fp::THREADS)
lora_f32_kernel(const float* __restrict__ xa, int ldxa, const float* __restrict__ b, int r,
                const float* __restrict__ x, const float* __restrict__ w, int ldw, int nw,
                float* __restrict__ out, int ldo, int M, int N, int K, float s) {
  using namespace fp;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {};

  const int nr = (r + BK - 1) / BK, n = nr + (K + BK - 1) / BK;
  auto load_stage = [&](int i, int st) {
    float* xs = ring + st * STAGE;
    float* ws = xs + BM * LDX;
    if (i < nr) {
      const int k0 = i * BK;
      load_tile<float, BM, BK, VEC, THREADS>(xs, LDX, xa + (long)m0 * ldxa + k0, ldxa,
                                             M - m0, r - k0, tid);
      load_tile<float, BK, BN, VEC, THREADS>(ws, LDW, b + (long)k0 * ldw + n0, ldw, r - k0,
                                             nw - n0, tid);
    } else {
      const int k0 = (i - nr) * BK;
      load_tile<float, BM, BK, VEC, THREADS>(xs, LDX, x + (long)m0 * K + k0, K, M - m0,
                                             K - k0, tid);
      load_tile<float, BK, BN, VEC, THREADS>(ws, LDW, w + (long)k0 * ldw + n0, ldw, K - k0,
                                             nw - n0, tid);
    }
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n) load_stage(st, st);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < n) load_stage(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    if (i == nr && nr > 0) {   // the rank product is whole: scale it by s
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] *= s;
    }
    const float* x_s = ring + (i % STAGES) * STAGE;
    const float* w_s = x_s + BM * LDX;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float xr[4], wc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) xr[a] = x_s[(ty + 16 * a) * LDX + k];
#pragma unroll
      for (int c = 0; c < 4; ++c) wc[c] = w_s[k * LDW + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(xr[a], wc[c], acc[a][c]);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int gm = m0 + ty + 16 * a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gn = n0 + tx + 16 * c;
      if (gm < M && gn < N) out[(long)gm * ldo + gn] = acc[a][c];
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

cudaError_t launch_f32(const float* xa, int ldxa, const float* b, int r, const float* x,
                       const float* w, int ldw, int nw, float* out, int ldo, int M, int N,
                       int K, float s, dim3 grid, cudaStream_t st) {
  const bool vec = K % 4 == 0 && ldw % 4 == 0 && nw % 4 == 0 && ldxa % 4 == 0;
  auto kernel = vec ? lora_f32_kernel<true> : lora_f32_kernel<false>;
  kernel<<<grid, fp::THREADS, fp::SMEM, st>>>(xa, ldxa, b, r, x, w, ldw, nw, out, ldo, M, N,
                                               K, s);
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

// TMA map of a row-major bf16 (rows, cols) matrix, row stride `cols`
// elements (a multiple of 8), in 128-byte swizzled boxes of box_rows x 64;
// reads past either edge give zeros
bool bf16_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int rows, int cols,
              int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool BWD>
cudaError_t launch_wgmma(const CUtensorMap& m_xa, const CUtensorMap& m_b, const CUtensorMap& m_x,
                         const CUtensorMap& m_w, void* out, int M, int N, int nr, int nr_b,
                         int nk, float s, int grid, cudaStream_t st) {
  auto kernel = lora_wgmma_kernel<BN, BWD>;
  static std::atomic<unsigned long long> done{0};
  const cudaError_t err = allow_smem(kernel, wg::smem_bytes<BN>(), done);
  if (err != cudaSuccess) return err;
  kernel<<<grid, wg::THREADS, wg::smem_bytes<BN>(), st>>>(m_xa, m_b, m_x, m_w,
                                                          static_cast<bf16*>(out), M, N, nr, nr_b,
                                                          nk, s);
  return cudaGetLastError();
}

// the forward's or the input gradient's main kernel at tile width block_n
// over the four maps; the second operands' boxes are 64 wide (forward) or
// block_n rows (BWD)
template <bool BWD>
cudaError_t launch_main(const void* xa, int xa_rows, int xa_cols, const void* b, int b_rows,
                        int b_cols, const void* x, int x_cols, const void* w, int w_rows,
                        int w_cols, void* out, int M, int N, int nr, int nr_b, int nk, float s,
                        int block_n, int grid, cudaStream_t st) {
  if (block_n != 128 && (BWD || block_n != 256)) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const int box = BWD ? block_n : 64;
  CUtensorMap m_xa, m_b, m_x, m_w;
  if (!bf16_map(encode, &m_xa, xa, xa_rows, xa_cols, wg::BM) ||
      !bf16_map(encode, &m_b, b, b_rows, b_cols, box) ||
      !bf16_map(encode, &m_x, x, M, x_cols, wg::BM) ||
      !bf16_map(encode, &m_w, w, w_rows, w_cols, box))
    return cudaErrorInvalidValue;
  if (block_n == 128)
    return launch_wgmma<128, BWD>(m_xa, m_b, m_x, m_w, out, M, N, nr, nr_b, nk, s, grid, st);
  return launch_wgmma<256, false>(m_xa, m_b, m_x, m_w, out, M, N, nr, nr_b, nk, s, grid, st);
}

}  // namespace

extern "C" {

// The pre-pass: xa (M, r_pad) = x (M, K; row stride ldx) @ a (K, r),
// columns past r zero; rounded to bf16 (is_bf16 = 1) or kept f32 (0).
// bf16: ldx % 8 == 0 and x's columns in [K, ldx) zero, r % 8 == 0 (the
// caller zero-pads A's columns); r_pad % 64 == 0.
// grid: (M/32, r_pad/64) blocks for bf16 (32 x 256 tiles, a ring of 3),
// (r_pad/64, M/64) for f32.
int lora_xa_launch(const void* x, int ldx, const void* a, void* xa, int M, int K, int r,
                   int r_pad, int is_bf16, int grid_x, int grid_y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || r < 1 || r_pad % 64 || r_pad < r) return cudaErrorInvalidValue;
  const dim3 grid(grid_x, grid_y);
  if (!is_bf16)
    return launch_f32(nullptr, 0, nullptr, 0, static_cast<const float*>(x),
                      static_cast<const float*>(a), r, r, static_cast<float*>(xa), r_pad, M,
                      r_pad, K, 1.f, grid, st);
  if (ldx % 8 || r % 8) return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> done{0};
  const cudaError_t err = allow_smem(xa_bf16_kernel<false>, pre::SMEM, done);
  if (err != cudaSuccess) return err;
  xa_bf16_kernel<false><<<grid, pre::THREADS, pre::SMEM, st>>>(
      static_cast<const bf16*>(x), ldx, static_cast<const bf16*>(a), static_cast<bf16*>(xa),
      nullptr, M, K, r, r_pad, 1.f);
  return cudaGetLastError();
}

// The main pass: out (M, N) = s * (xa @ b) + x @ w, for xa (M, r_pad)
// from lora_xa_launch, x (M, K), w (kw, N), b (r, N), all contiguous.
// bf16 (is_bf16 = 1): the wgmma kernel, block_n 128 or 256, K and N
// multiples of 8, kw <= K with x's columns past kw zero, `grid_x` blocks.
// f32: the FMA kernel, K == kw, grid (grid_x, grid_y) of 64 x 64 tiles.
// Returns cudaGetLastError().
int lora_matmul_launch(const void* xa, const void* x, const void* w, const void* b, void* out,
                       int M, int N, int K, int kw, int r, int r_pad, float s, int is_bf16,
                       int block_n, int grid_x, int grid_y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || kw < 1 || kw > K || r < 1 || r_pad % 64 || r_pad < r)
    return cudaErrorInvalidValue;
  if (!is_bf16)
    return launch_f32(static_cast<const float*>(xa), r_pad, static_cast<const float*>(b), r,
                      static_cast<const float*>(x), static_cast<const float*>(w), N, N,
                      static_cast<float*>(out), N, M, N, K, s, dim3(grid_x, grid_y), st);
  if (K % 8 || N % 8) return cudaErrorInvalidValue;
  return launch_main<false>(xa, M, r_pad, b, r, N, x, K, w, kw, N, out, M, N, r_pad / 64,
                            r_pad / 64, (K + wg::BK - 1) / wg::BK, s, block_n, grid_x, st);
}

// The input gradient's pre-pass (bf16): gxa (M, r_pad) f32 = s * (g @
// b^T) for g (M, N) and b (r, N), both with row stride N (N % 8 == 0,
// columns past the true width zero), columns past r zero; and gs (M,
// 3 r_pad) bf16 = [hi | mid | lo] with hi + mid + lo == gxa exactly.
// grid: (M/32, r_pad/64) blocks.
int lora_gxa_launch(const void* g, const void* b, float* gxa, void* gs, int M, int N, int r,
                    int r_pad, float s, int grid_x, int grid_y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || r < 1 || r_pad % 64 || r_pad < r || N % 8)
    return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> done{0};
  const cudaError_t err = allow_smem(xa_bf16_kernel<true>, pre::SMEM, done);
  if (err != cudaSuccess) return err;
  xa_bf16_kernel<true><<<dim3(grid_x, grid_y), pre::THREADS, pre::SMEM, st>>>(
      static_cast<const bf16*>(g), N, static_cast<const bf16*>(b), static_cast<bf16*>(gs), gxa,
      M, N, r, r_pad, s);
  return cudaGetLastError();
}

// The input gradient's main pass (bf16): dx (M, K) = gs @ [A^T; A^T; A^T]
// + g @ W^T, for gs (M, 3 r_pad) from lora_gxa_launch, g (M, N), w (kw,
// N) and a (kw, r_a), all contiguous; K and N multiples of 8, r_a a
// multiple of 8 and at most r_pad, kw <= K (dx's columns past kw come out
// zero). 128 x 128 tiles of dx, `grid_x` blocks.
int lora_dx_launch(const void* gs, const void* g, const void* w, const void* a, void* dx, int M,
                   int K, int N, int kw, int r_a, int r_pad, int grid_x, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || kw < 1 || kw > K || r_a < 1 || r_pad % 64 || r_pad < r_a ||
      K % 8 || N % 8 || r_a % 8)
    return cudaErrorInvalidValue;
  return launch_main<true>(gs, M, 3 * r_pad, a, kw, r_a, g, N, w, kw, N, dx, M, K,
                           3 * r_pad / 64, r_pad / 64, (N + wg::BK - 1) / wg::BK, 1.f, 128,
                           grid_x, st);
}

}  // extern "C"
