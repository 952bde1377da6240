// Mamba-2 chunked SSD forward (state-space duality, arXiv:2405.21060)
// for Hopper (sm_90a), in model layout:
//
//   h_t = exp(dt_t * a) * h_{t-1} + dt_t * x_t b_t^T     (state (P, N), f32)
//   y_t = h_t c_t + d * x_t
//
//   x (B,S,H,P), b/c (B,S,G,N) in bf16 or f32, read in place through
//   their strides (on the model path they are slices of one conv output);
//   dt (B,S,H), a (H,), d (H,) in f32; y (B,S,H,P) contiguous, x's dtype.
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_scan_bhsp` in
// src/repro/kernels/ssd_scan.py and computes what its body computes, one
// chunk at a time: cum = cumsum(dt * a) within the chunk,
//
//   y_i  = sum_{j <= i} (c_i . b_j) exp(cum_i - cum_j) dt_j x_j   (intra)
//        + exp(cum_i) (c_i . state^T)                             (inter)
//        + d x_i                                                  (skip)
//   state = state exp(cum_last) + sum_j (x_j dt_j exp(cum_last - cum_j)) b_j^T
//
// The decay is always exp of a difference of cumulative sums, never a
// ratio of two exps: within a 256-row chunk cum reaches about -4000 at
// a = -16, where exp(cum) is 0 in f32 and a ratio would be 0/0. Rows past
// S add nothing and are not stored; a chunk longer than S is one chunk of
// S rows (the TPU wrapper's cap); b and c are indexed by group
// h / (H / G), never repeated to H heads in memory.
//
// What bounds it: at the training path's shape (B 4, S 1024, H 80, P 64,
// G 1, N 128, chunk 256, bf16) it moves 87 MB (x read, y written, b/c and
// dt read once), 26.06 us at 3.35 TB/s, and does 24.2 GFLOP on the live
// causal pairs, 24.5 us of bf16 tensor-core time: bytes and operations
// weigh about the same. Two variants, which the wrapper's plan picks by
// dtype, shape and alignment:
//
//   * mma (bf16 x/b/c; P and N multiples of 16 with P <= 64, N <= 128;
//     chunk <= 256; base addresses and row strides 16-byte aligned, as TMA
//     needs). The products run on wgmma tensor cores (bf16 in, f32
//     accumulate):
//       - the scores c.b^T per 64-row query tile over the 64-key tiles at
//         or below the diagonal (the tiles above it are skipped);
//       - weights.x, the weight (c.b) exp(cum_i - cum_j) dt_j formed in
//         f32 from the score accumulators and masked above the diagonal;
//       - the inter term c.state^T and the state increment
//         (x dt decay)^T.b.
//     Each f32 operand (the weights, the state, x dt decay) is split into
//     a bf16 high and a bf16 low part, and two products sum into one f32
//     accumulator, so against the TPU kernel's f32 products only the
//     summation order moves. (Rounding the weights to bf16, as the plain
//     version does, left 1.3x margin under the 2^-7 limit against the f32
//     oracle at the path shape; split, 2.1x, the fma design's.)
//     A block is one chunk of `hpb` heads of one group of one batch row,
//     two warpgroups, one block an SM; the heads share b and c, so the
//     chunk's b tiles stay in shared memory and its c tiles in registers
//     as A fragments, and x streams per head (the next head's by TMA while
//     this one computes). The state crosses chunks by a look-back: each
//     block takes a ticket from an atomic counter (chunk slowest, so every
//     block of chunk ci - 1 took an earlier ticket and is running or done:
//     no wait can deadlock), computes per head its chunk's cum, increment
//     and intra term, waits on the flag of the same head's previous chunk,
//     reads the state entering its chunk from a workspace, publishes prev
//     exp(cum_last) + increment for the next chunk (stores, a barrier,
//     thread 0's fence and release of the flag), and then adds the inter
//     term and writes y. Flags carry a per-call epoch, so they need no
//     reset; the block that draws the last ticket resets the counter. The
//     chain runs in chunk order, so two calls give the same bits. The
//     workspace (B H (nc - 1) P N f32, 31.5 MB at the path shape, mostly
//     L2 traffic) and the counters belong to the caller and are kept
//     between calls: two calls on two streams at once are not supported.
//     This is the chunk-parallel form of Mamba-2's own GPU kernels (chunk
//     state, state passing, chunk scan) in one launch, so each state makes
//     one trip through L2. The block runs its phases one after another,
//     at 243-248 registers a thread: the tensor cores wait while it forms
//     weights, splits x and passes the state (PERF.md, section 6).
//   * fma (f32 inputs, P or N not a multiple of 16, chunks over 256,
//     layouts TMA cannot take): the first design. One block per (batch,
//     head) walks its chunks in order with the f32 state in shared
//     memory, every product on CUDA-core f32 FMA (401 us at 67 TFLOP/s is
//     its own floor at the path shape). No intermediate is rounded: the
//     weights stay f32 for the product with x, as in the TPU kernel.
//
// Plain C interface, loaded with ctypes by repro_torch/kernels/build.py;
// launches on the caller's stream and returns cudaGetLastError().
// cuTensorMapEncodeTiled is reached through the runtime's driver entry
// point, so nothing links libcuda. Every wait is bounded: an mbarrier or
// flag wait that fails too long traps, so a protocol bug surfaces as a
// CUDA error at the next synchronize and not as a hung card.

#include <atomic>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// variant codes of the C interface (= the wrapper's _VARIANTS)
enum Variant { kFma = 0, kMma = 1 };

// ---------------------------------------------------------------------------
// fma: the first design (one block per (batch, head), CUDA-core f32 FMA)
//
// * The TPU carries the (P, N) state in VMEM across a grid axis that runs
//   in order; GPU blocks run in no order. So one block owns one (batch,
//   head) and loops over its chunks, the f32 state in shared memory (N x
//   P, 32 KB at N 128, P 64). Grid (H, B): the heads of one batch row,
//   which share b and c, run side by side and meet in L2.
// * The chunk's (c x c) weight matrix does not fit (256 KB in f32 at c
//   256): the intra term walks 64-row query tiles and, for each, the 64-
//   row key tiles at or below the diagonal; the tiles above it are
//   skipped.
// * The state update runs inside the last query tile's key loop, which
//   visits every key tile of the chunk with its b and x already in shared
//   memory; the state is written after every query tile has read the old
//   one for its inter term.
// * A ragged sequence needs no padding: the last chunk is shorter, and
//   rows past its end load as zeros (dt = 0 adds nothing).
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kT = 64;              // rows of a query or key tile
constexpr int kLd = kT + 4;         // row stride of the (N x 64) tiles
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxChunk = 512;      // a multiple of kT
constexpr int kXLd = kMaxP + 4;     // row stride of the x tile

constexpr int kSmemFloats = kMaxN * kMaxP      // state^T [n][p]
                            + 2 * kMaxN * kLd  // c^T, b^T [n][row]
                            + kT * kXLd        // x [row][p]
                            + kT * kLd         // w^T [key][query]
                            + 3 * kMaxChunk;   // cum, dt, decay to end
constexpr int kSmemBytes = kSmemFloats * 4;

struct Args {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* d;
  void* y;
  int S, H, P, G, N, chunk;
  long long xsb, xss, xsh, dtsb, dtss, dtsh, bsb, bss, bsg, csb, css, csg;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// rows x N of a row-major matrix (row stride ld elements) into a
// transposed f32 tile dst[n * kLd + row]; zeros for rows past `rows`
template <typename T>
__device__ __forceinline__ void load_transposed(float* dst, const T* src,
                                                long long ld, int rows, int n_dim,
                                                int tid) {
  for (int idx = tid; idx < kT * n_dim; idx += kThreads) {
    const int r = idx / n_dim, n = idx - r * n_dim;
    dst[n * kLd + r] = r < rows ? to_f32(src[r * ld + n]) : 0.f;
  }
}

// rows x P of x into dst[row * kXLd + p]; zeros for rows past `rows`
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long ld,
                                          int rows, int p_dim, int tid) {
  for (int idx = tid; idx < kT * p_dim; idx += kThreads) {
    const int r = idx / p_dim, p = idx - r * p_dim;
    dst[r * kXLd + p] = r < rows ? to_f32(src[r * ld + p]) : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_kernel(Args args) {
  extern __shared__ float4 smem4[];
  float* st = reinterpret_cast<float*>(smem4);  // state^T [n][p]
  float* ct = st + kMaxN * kMaxP;                // c^T of the query tile
  float* bt = ct + kMaxN * kLd;                  // b^T of the key tile
  float* xs = bt + kMaxN * kLd;                  // x of the key tile
  float* wt = xs + kT * kXLd;                    // weights^T [key][query]
  float* cum = wt + kT * kLd;                    // cumsum(dt * a)
  float* dts = cum + kMaxChunk;                  // dt
  float* dec = dts + kMaxChunk;                  // dt exp(cum_last - cum)

  const int S = args.S, H = args.H, P = args.P, N = args.N;
  const int chunk = args.chunk;
  const int h = blockIdx.x, bi = blockIdx.y;
  const int g = h / (H / args.G);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* xp = static_cast<const T*>(args.x) + bi * args.xsb + h * args.xsh;
  const float* dtp = args.dt + bi * args.dtsb + h * args.dtsh;
  const T* bp = static_cast<const T*>(args.b) + bi * args.bsb + g * args.bsg;
  const T* cp = static_cast<const T*>(args.c) + bi * args.csb + g * args.csg;
  T* yp = static_cast<T*>(args.y) + ((long long)bi * S * H + h) * P;
  const long long ys = (long long)H * P;          // y's row stride
  const float av = args.a[h], dv = args.d[h];

  for (int i = tid; i < kMaxN * kMaxP; i += kThreads) st[i] = 0.f;

  const int nchunks = (S + chunk - 1) / chunk;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int s0 = ci * chunk;
    const int cl = min(chunk, S - s0);
    const int ntiles = (cl + kT - 1) / kT;
    const int cpad = ntiles * kT;
    const bool carry = ci + 1 < nchunks;        // the state is needed next

    __syncthreads();  // the previous chunk's readers of cum/dts/dec are done
    for (int i = tid; i < cpad; i += kThreads)
      dts[i] = i < cl ? dtp[(long long)(s0 + i) * args.dtss] : 0.f;
    __syncthreads();
    if (tid < 32) {  // warp 0: inclusive scan of dt * a over the chunk
      const int seg = (cpad + 31) / 32;
      const int lo = min(tid * seg, cpad), hi = min(lo + seg, cpad);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) run += dts[i] * av;
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      float acc = incl - run;
      for (int i = lo; i < hi; ++i) {
        acc += dts[i] * av;
        cum[i] = acc;
      }
    }
    __syncthreads();
    const float cum_last = cum[cl - 1];
    for (int i = tid; i < cpad; i += kThreads)
      dec[i] = dts[i] * expf(cum_last - cum[i]);

    for (int qt = 0; qt < ntiles; ++qt) {
      const int i0 = qt * kT;
      const bool update = carry && qt == ntiles - 1;
      __syncthreads();  // the previous tile's readers of ct/bt/xs/wt are done
      load_transposed(ct, cp + (long long)(s0 + i0) * args.css, args.css,
                      min(kT, cl - i0), N, tid);
      __syncthreads();

      // inter-chunk term: exp(cum_i) * (c_i . state^T)
      float acc[4][4] = {};
      if (ci > 0) {
        for (int n = 0; n < N; ++n) {
          const float4 cv = ld4(ct + n * kLd + ty * 4);
          const float4 sv = ld4(st + n * kMaxP + tx * 4);
          const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
          const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(c4[r], s4[q], acc[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float e = expf(cum[i0 + ty * 4 + r]);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] *= e;
        }
      }

      float nst[8][4] = {};  // this chunk's state increment (update only)
      for (int kt = 0; kt <= qt; ++kt) {
        const int j0 = kt * kT;
        const int krows = min(kT, cl - j0);
        if (kt > 0) __syncthreads();  // readers of bt/xs/wt are done
        load_transposed(bt, bp + (long long)(s0 + j0) * args.bss, args.bss,
                        krows, N, tid);
        load_rows(xs, xp + (long long)(s0 + j0) * args.xss, args.xss, krows,
                  P, tid);
        __syncthreads();

        // scores c_i . b_j, weighted by exp(cum_i - cum_j) dt_j, causal
        float sc[4][4] = {};
        for (int n = 0; n < N; ++n) {
          const float4 cv = ld4(ct + n * kLd + ty * 4);
          const float4 bv = ld4(bt + n * kLd + tx * 4);
          const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
          const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) sc[r][q] = fmaf(c4[r], b4[q], sc[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty * 4 + r;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = j0 + tx * 4 + q;
            const float w = j <= i ? sc[r][q] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
            wt[(tx * 4 + q) * kLd + ty * 4 + r] = w;
          }
        }
        __syncthreads();

        // intra-chunk term: weights @ x
        for (int jj = 0; jj < krows; ++jj) {
          const float4 wv = ld4(wt + jj * kLd + ty * 4);
          const float4 xv = ld4(xs + jj * kXLd + tx * 4);
          const float w4[4] = {wv.x, wv.y, wv.z, wv.w};
          const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(w4[r], x4[q], acc[r][q]);
        }
        // state increment: (x_j dt_j exp(cum_last - cum_j))^T b_j, as
        // state^T [n][p] with n = ty * 8 + r, p = tx * 4 + q
        if (update) {
          for (int jj = 0; jj < krows; ++jj) {
            const float4 xv = ld4(xs + jj * kXLd + tx * 4);
            const float sj = dec[j0 + jj];
            const float x4[4] = {xv.x * sj, xv.y * sj, xv.z * sj, xv.w * sj};
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const float bv = bt[(ty * 8 + r) * kLd + jj];
#pragma unroll
              for (int q = 0; q < 4; ++q) nst[r][q] = fmaf(bv, x4[q], nst[r][q]);
            }
          }
        }
      }

      // skip term and store; xs holds the query rows (the diagonal tile
      // is the key loop's last)
      const int qrows = min(kT, cl - i0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ii = ty * 4 + r;
        if (ii >= qrows) continue;
        T* row = yp + (long long)(s0 + i0 + ii) * ys;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = tx * 4 + q;
          if (p < P) row[p] = from_f32<T>(acc[r][q] + dv * xs[ii * kXLd + p]);
        }
      }
      if (update) {
        // every query tile read the old state before this tile's key loop
        // passed its barriers
        const float total = expf(cum_last);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int n = ty * 8 + r;
          if (n >= N) continue;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int p = tx * 4 + q;
            st[n * kMaxP + p] = st[n * kMaxP + p] * total + nst[r][q];
          }
        }
      }
    }
  }
}

template <typename T>
int launch(const Args& args, int batch, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T><<<dim3(args.H, batch), kThreads, kSmemBytes, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// mma: bf16; resident TMA tiles, wgmma tensor cores, one block per (chunk,
// heads of one group), the state carried by a look-back
// ---------------------------------------------------------------------------

namespace mm {
constexpr int T = 64;                 // rows of a query or key tile
constexpr int WARPS = 8;              // two warpgroups
constexpr int THREADS = 32 * WARPS;
constexpr int BOX = T * 128;          // 64 rows x 64 bf16 columns, 128-byte swizzled (8 KB)
constexpr int MAX_TILES = 4;          // 64-row tiles of a chunk: chunk <= 256
// dynamic shared memory at nb 64-column boxes of N and `tiles` tiles a
// chunk: 1 KB of alignment slack, the chunk's b tiles, two buffers of a
// head's x tiles, the c tiles (whose place, at least 4 nb boxes, later
// holds the f32 increment and the state's high and low parts), cum, dt
// and the decay to the chunk's end, three barriers and the ticket
__host__ __device__ inline int smem_bytes(int nb, int tiles) {
  return 1024 + tiles * nb * BOX + 2 * tiles * BOX + (tiles > 4 ? tiles : 4) * nb * BOX +
         3 * MAX_TILES * T * 4 + 3 * 8 + 8;
}

struct Args {
  const float* dt;
  const float* a;
  const float* d;
  bf16* y;
  float* ws;      // (B H, nc - 1, P, N) f32: the state leaving each chunk but the last
  int* flags;     // [0]: ticket counter; [1 + (b H + h) (nc - 1) + ci]: ws slot ci published
  int epoch;      // this call's flag value (never 0)
  int hpb;        // heads a block, of one group
  int S, H, P, G, N, chunk, nc;
  long long dtsb, dtss, dtsh;
};
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

// waits until *flag == epoch (acquire, device scope); traps after ~2^24
// failed reads (seconds) instead of hanging the card
__device__ __forceinline__ void wait_flag(const int* flag, int epoch) {
  for (uint32_t tries = 0;; ++tries) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(flag) : "memory");
    if (v == epoch) return;
    if (tries == (1u << 24)) __trap();
  }
}
__device__ __forceinline__ void release_flag(int* flag, int epoch) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(flag), "r"(epoch) : "memory");
}

// one 4-D TMA box (coordinates: column, head or group, row, batch) into
// shared memory; the bytes land on `bar`'s transaction count
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
// (v0, v1) = (lo, hi) of `packed` times (s.x, s.y) in f32, split into a
// bf16 high part and the bf16 rounding of the remainder: hi + lo holds the
// f32 product to ~2^-17 of it
__device__ __forceinline__ void split_scaled(uint32_t packed, float2 s, uint32_t& hi,
                                             uint32_t& lo) {
  const float2 v = unpack_bf16(packed);
  const float v0 = v.x * s.x, v1 = v.y * s.y;
  hi = pack_bf16(v0, v1);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(v0 - h.x, v1 - h.y);
}

__device__ __forceinline__ void sts64(uint32_t addr, uint32_t lo, uint32_t hi) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(lo), "r"(hi) : "memory");
}
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
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
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns (accumulators, A fragments) across it
template <int R> __device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R, int C> __device__ __forceinline__ void fence_regs(uint32_t (&d)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// D (64 x 64 f32, 32 a thread) = D * (scale_d != 0) + A (64 x 16 bf16
// from registers: in each warp's 16 rows the m16n8k16 A fragment) * B (16
// x 64 from shared memory; TB 0: K-major, TB 1: MN-major)
template <int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}
// address of 16-byte chunk `chunk` of row `row` in a 128-byte-swizzled
// box at `box` (1 KB aligned): chunk k of row r sits at chunk k ^ (r % 8)
__device__ __forceinline__ uint32_t swz(uint32_t box, int row, int chunk) {
  return box + row * 128 + ((chunk ^ (row & 7)) << 4);
}

// Fragment addressing, per lane (g = lane / 4, t = lane % 4):
//   ldsm_x4 at (row base + lane % 16, chunk base + lane / 16) gives the A
//     fragment of 16 rows x 16 columns of a row-major tile (c);
//   ldsm_x4_trans at (row base + lane % 8 + (lane / 16) 8, chunk base +
//     (lane / 8) % 2) gives the A fragment of x^T: 16 columns (m: p) x 16
//     rows (k: keys).
// The accumulator of an m64nN wgmma: warp w of the warpgroup holds, for
// each 8-column slice j, columns 8j + 2t + {0, 1} of rows 16w + g
// (elements 4j, 4j + 1) and 16w + g + 8 (4j + 2, 4j + 3).
//
// Block mm::THREADS: two warpgroups, one block an SM. A block takes a
// ticket: one chunk of `hpb` heads of one group of one batch row, chunk
// slowest. The heads share b and c, so the block loads the chunk's b and
// c tiles once and keeps them: b in shared memory, c as each
// warpgroup's A fragments in registers. x streams per head through two
// buffers, the next head's loading while this one computes. Per head:
//   1. cum, dt and the decay to the chunk's end in shared memory;
//   2. the state increment (every chunk but the last): warpgroup w takes
//      N's 64-column box w, (P x keys) . (keys x 64) on wgmma with x dt
//      decay, transposed and split high/low, from registers and b's box
//      MN-major; the f32 result goes to shared memory;
//   3. the intra term of each of the warpgroup's query tiles (at most
//      two, balanced by their key tiles): per key tile up to the diagonal
//      the scores c.b^T (b K-major), the weights in f32 split high/low,
//      and weights.x (x MN-major), the accumulators in registers;
//   4. the state: wait for the flag of the same head's previous chunk,
//      read the state entering the chunk (prev), publish prev
//      exp(cum_last) + increment for the next chunk (stores, fence,
//      release), and keep prev high/low in shared memory;
//   5. per query tile, exp(cum_i) (c_i . prev^T) (prev K-major) added to
//      the intra term, and y = that + d x.
// Steps 1-3 need no other chunk. The chunks of a head run in order in
// the blocks of successive ticket rows, so a block that waits waits once
// for its predecessor to get ahead, and then runs a head behind it.
template <int NB>
__global__ void __launch_bounds__(mm::THREADS, 1)
ssd_mma_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_b,
               const __grid_constant__ CUtensorMap tm_c, const mm::Args args) {
  using namespace mm;
  constexpr int KK = NB * 4;       // 16-column steps over N (padded to 64 NB)
  constexpr int IST = 64 * NB;     // row stride (floats) of the increment
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - smem_addr(smem_raw));
  const int S = args.S, H = args.H, P = args.P, N = args.N, chunk = args.chunk, nc = args.nc;
  const int hpb = args.hpb;
  const int ntiles = (chunk + T - 1) / T;     // tiles of a full chunk (<= MAX_TILES)
  // b tile kt: NB boxes at bt + kt NB BOX; x of head j: tile kt at xt + (j
  // % 2) ntiles BOX + kt BOX; c tile qt: NB boxes at ct + qt NB BOX. Once
  // every c fragment is in registers the c tiles' place holds the f32
  // increment (NB 16 KB) and the state's high and low parts (NB boxes
  // each)
  const uint32_t bt = base, xt = bt + ntiles * NB * BOX, ct = xt + 2 * ntiles * BOX;
  const uint32_t phi = ct + 2 * NB * BOX, plo = phi + NB * BOX;
  float* inc_s = reinterpret_cast<float*>(base_ptr + (ct - base));  // [64][IST], swizzled
  float* cum = reinterpret_cast<float*>(base_ptr + (ct - base) + max(ntiles, 4) * NB * BOX);
  float* dts = cum + MAX_TILES * T;
  float* dec = dts + MAX_TILES * T;
  const uint32_t bar_bc = smem_addr(dec + MAX_TILES * T), bar_x = bar_bc + 8;
  int* ticket = reinterpret_cast<int*>(dec + MAX_TILES * T + 6);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wq = warp & 3;    // warpgroup, and warp within it
  const int g4 = lane >> 2, t4 = lane & 3;
  if (tid == 0) {
    const int t = atomicAdd(args.flags, 1);
    // tickets are handed out in order: the last one means every block has
    // drawn, so the counter is ready for the next call
    if (t == (int)gridDim.x - 1) atomicExch(args.flags, 0);
    *ticket = t;
    mbar_init(bar_bc, 1);
    mbar_init(bar_x, 1);
    mbar_init(bar_x + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int rows = gridDim.x / nc;            // tickets per chunk: (batch, head group)s
  const int ci = *ticket / rows, bg = *ticket - ci * rows;
  const int groups = H / hpb;                 // head groups per batch row
  const int bi = bg / groups, h0 = (bg - bi * groups) * hpb, g = h0 / (H / args.G);
  const int s0 = ci * chunk, cl = min(chunk, S - s0);
  const int nt = (cl + T - 1) / T, cpad = nt * T;  // this chunk's tiles
  const bool carry = ci + 1 < nc, has_prev = ci > 0;
  // x of head j into buffer j % 2, on barrier bar_x + 8 (j % 2)
  auto load_x = [&](int j) {
    const uint32_t bar = bar_x + 8 * (j & 1);
    mbar_expect_tx(bar, nt * BOX);
    for (int kt = 0; kt < nt; ++kt)
      tma_load_4d(xt + ((j & 1) * ntiles + kt) * BOX, &tm_x, bar, 0, h0 + j, s0 + T * kt, bi);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_bc, 2 * nt * NB * BOX);
    for (int kt = 0; kt < nt; ++kt)
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        tma_load_4d(bt + (kt * NB + i) * BOX, &tm_b, bar_bc, 64 * i, g, s0 + T * kt, bi);
        tma_load_4d(ct + (kt * NB + i) * BOX, &tm_c, bar_bc, 64 * i, g, s0 + T * kt, bi);
      }
    load_x(0);
  }

  // this warpgroup's query tiles, greedily balanced by their key tiles
  // (qt + 1 each), longest first: at most two for nt <= 4
  int my_qt[2] = {-1, -1};
  {
    int load[2] = {0, 0}, cnt[2] = {0, 0};
    for (int qt = nt - 1; qt >= 0; --qt) {
      const int w = load[1] < load[0] ? 1 : 0;
      load[w] += qt + 1;
      if (w == wg) my_qt[cnt[w]] = qt;
      ++cnt[w];
    }
  }
  // dt of head j, prefetched into a register a head ahead (cpad <= THREADS)
  auto load_dt = [&](int j) {
    return tid < cl ? args.dt[bi * args.dtsb + (long long)(s0 + tid) * args.dtss +
                              (h0 + j) * args.dtsh]
                    : 0.f;
  };
  float dt_next = load_dt(0);
  // c's A fragments of this warp's rows of those tiles, for every head
  uint32_t cf[2][KK][4];
  mbar_wait(bar_bc, 0);
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      ldsm_x4(cf[r][kk], swz(ct + (max(my_qt[r], 0) * NB + (kk >> 2)) * BOX,
                             16 * wq + (lane & 15), (kk & 3) * 2 + (lane >> 4)));
  __syncthreads();  // the c tiles' place is free

  for (int j = 0; j < hpb; ++j) {
    const int h = h0 + j;
    if (tid == 0 && j + 1 < hpb) load_x(j + 1);  // its buffer's last reader was head j - 1
    const uint32_t xh = xt + (j & 1) * ntiles * BOX;

    // 1. cum = cumsum(dt * a), dt and dt exp(cum_last - cum); zeros past
    // the chunk's end
    const float av = args.a[h], dv = args.d[h];
    if (tid < cpad) dts[tid] = dt_next;
    if (j + 1 < hpb) dt_next = load_dt(j + 1);
    __syncthreads();
    if (warp == 0) {  // inclusive scan, a segment per lane
      const int seg = (cpad + 31) / 32;
      const int lo = min(lane * seg, cpad), hi = min(lo + seg, cpad);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) run += dts[i] * av;
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      float acc = incl - run;
      for (int i = lo; i < hi; ++i) {
        acc += dts[i] * av;
        cum[i] = acc;
      }
    }
    __syncthreads();
    const float cum_last = cum[cl - 1];
    for (int i = tid; i < cpad; i += THREADS) dec[i] = dts[i] * expf(cum_last - cum[i]);
    __syncthreads();
    mbar_wait(bar_x + 8 * (j & 1), (j >> 1) & 1);

    // 2. the increment's box wg: rows p 16 wq + g (+ 8), columns 64 wg +
    // 8 jj + 2 t (+ 1), stored at column n ^ 4 (p % 8) against bank
    // conflicts
    if (carry && wg < NB) {
      float inc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) inc[e] = 0.f;
      for (int kt = 0; kt < nt; ++kt) {
        const uint32_t xs = xh + kt * BOX, bs = bt + (kt * NB + wg) * BOX;
        uint32_t ah[4][4], al[4][4];  // 16 keys a step
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t xa[4];
          ldsm_x4_trans(xa, swz(xs, 16 * ks + (lane & 7) + (lane >> 4) * 8,
                                2 * wq + ((lane >> 3) & 1)));
          const float* dk = dec + T * kt + 16 * ks + 2 * t4;
          const float2 s01 = *reinterpret_cast<const float2*>(dk);
          const float2 s89 = *reinterpret_cast<const float2*>(dk + 8);
          split_scaled(xa[0], s01, ah[ks][0], al[ks][0]);
          split_scaled(xa[1], s01, ah[ks][1], al[ks][1]);
          split_scaled(xa[2], s89, ah[ks][2], al[ks][2]);
          split_scaled(xa[3], s89, ah[ks][3], al[ks][3]);
        }
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint64_t db = sw128_desc(bs + ks * 2048, BOX, 1024);
          wgmma_n64<1>(inc, ah[ks], db, 1);
          wgmma_n64<1>(inc, al[ks], db, 1);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(inc);
        fence_regs(ah);
        fence_regs(al);
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = 16 * wq + g4 + 8 * r;
          *reinterpret_cast<float2*>(inc_s + p * IST + ((64 * wg + 8 * jj + 2 * t4) ^ ((p & 7) << 2))) =
              make_float2(inc[4 * jj + 2 * r], inc[4 * jj + 2 * r + 1]);
        }
    }

    // 3. the intra term of this warpgroup's query tiles
    float acc[2][32];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[r][e] = 0.f;
      const int qt = my_qt[r];
      if (qt < 0) continue;
      const int r0 = T * qt + 16 * wq + g4;  // this thread's rows r0, r0 + 8
      const float cq0 = cum[r0], cq1 = cum[r0 + 8];
      for (int kt = 0; kt <= qt; ++kt) {
        const uint32_t bs = bt + kt * NB * BOX, xs = xh + kt * BOX;
        // scores c_i . b_j of 64 rows x 64 keys (b K-major)
        float sc[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
          wgmma_n64<0>(sc, cf[r][kk],
                       sw128_desc(bs + (kk >> 2) * BOX + (kk & 3) * 32, 16, 1024), 1);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sc);
        // weights (c_i . b_j) exp(cum_i - cum_j) dt_j, zero above the
        // diagonal, as bf16 high and low A fragments of weights . x
        const bool diag = kt == qt;
        uint32_t wh[4][4], wl[4][4];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int key = T * kt + 8 * jj + 2 * t4;
          const float2 cj = *reinterpret_cast<const float2*>(cum + key);
          const float2 dj = *reinterpret_cast<const float2*>(dts + key);
          float w0 = sc[4 * jj] * __expf(cq0 - cj.x) * dj.x;
          float w1 = sc[4 * jj + 1] * __expf(cq0 - cj.y) * dj.y;
          float w2 = sc[4 * jj + 2] * __expf(cq1 - cj.x) * dj.x;
          float w3 = sc[4 * jj + 3] * __expf(cq1 - cj.y) * dj.y;
          if (diag) {
            if (key > r0) w0 = 0.f;
            if (key + 1 > r0) w1 = 0.f;
            if (key > r0 + 8) w2 = 0.f;
            if (key + 1 > r0 + 8) w3 = 0.f;
          }
          const uint32_t h01 = pack_bf16(w0, w1), h23 = pack_bf16(w2, w3);
          const float2 f01 = unpack_bf16(h01), f23 = unpack_bf16(h23);
          wh[jj >> 1][(jj & 1) * 2] = h01;
          wh[jj >> 1][(jj & 1) * 2 + 1] = h23;
          wl[jj >> 1][(jj & 1) * 2] = pack_bf16(w0 - f01.x, w1 - f01.y);
          wl[jj >> 1][(jj & 1) * 2 + 1] = pack_bf16(w2 - f23.x, w3 - f23.y);
        }
        // weights . x (x MN-major), high and low
        wgmma_fence();
#pragma unroll
        for (int kp = 0; kp < 4; ++kp) {
          const uint64_t dx = sw128_desc(xs + kp * 2048, BOX, 1024);
          wgmma_n64<1>(acc[r], wh[kp], dx, 1);
          wgmma_n64<1>(acc[r], wl[kp], dx, 1);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc[r]);
        fence_regs(wh);
        fence_regs(wl);
      }
    }

    // 4. the state entering the chunk (prev) and the one leaving it (prev
    // exp(cum_last) + increment): warp w takes rows p = w + 8 i, lane l
    // columns 4 l .. 4 l + 3
    const long long slot = (long long)(bi * H + h) * (nc - 1) + ci;  // ws slot of this chunk
    if (has_prev && tid == 0) wait_flag(args.flags + slot, args.epoch);  // slot - 1, + 1
    __syncthreads();  // the flag, and the increment in shared memory
    {
      const float decay = expf(cum_last);
      const float* ws_in = args.ws + (slot - 1) * P * N;
      float* ws_out = args.ws + slot * P * N;
      const int n = 4 * lane;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = warp + 8 * i;
        if (n >= 64 * NB) continue;
        const bool in = p < P && n < N;
        float4 pv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (has_prev && in) pv = __ldcg(reinterpret_cast<const float4*>(ws_in + p * N + n));
        if (carry && in) {
          const float4 iv =
              *reinterpret_cast<const float4*>(inc_s + p * IST + (n ^ ((p & 7) << 2)));
          __stcg(reinterpret_cast<float4*>(ws_out + p * N + n),
                 make_float4(pv.x * decay + iv.x, pv.y * decay + iv.y, pv.z * decay + iv.z,
                             pv.w * decay + iv.w));
        }
        if (has_prev) {  // zeros past P and N: c's zero columns meet them
          const uint32_t h01 = pack_bf16(pv.x, pv.y), h23 = pack_bf16(pv.z, pv.w);
          const float2 f01 = unpack_bf16(h01), f23 = unpack_bf16(h23);
          const uint32_t off = swz((n >> 6) * BOX, p, (n & 63) >> 3) + (n & 7) * 2;
          sts64(phi + off, h01, h23);
          sts64(plo + off, pack_bf16(pv.x - f01.x, pv.y - f01.y),
                pack_bf16(pv.z - f23.x, pv.w - f23.y));
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // phi / plo to wgmma
    __syncthreads();
    // every thread's stores of the state leaving the chunk precede the
    // barrier, so thread 0's fence makes them visible before its flag
    if (carry && tid == 0) {
      __threadfence();
      release_flag(args.flags + 1 + slot, args.epoch);
    }

    // 5. the inter term, and y = intra + inter + d x
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qt = my_qt[r];
      if (qt < 0) continue;
      const int r0 = T * qt + 16 * wq + g4;
      if (has_prev) {  // exp(cum_i) (c_i . prev^T), prev as high + low, K-major
        float it[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) it[e] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          const uint32_t off = (kk >> 2) * BOX + (kk & 3) * 32;
          wgmma_n64<0>(it, cf[r][kk], sw128_desc(phi + off, 16, 1024), 1);
          wgmma_n64<0>(it, cf[r][kk], sw128_desc(plo + off, 16, 1024), 1);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(it);
        const float e0 = expf(cum[r0]), e1 = expf(cum[r0 + 8]);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          acc[r][4 * jj] += e0 * it[4 * jj];
          acc[r][4 * jj + 1] += e0 * it[4 * jj + 1];
          acc[r][4 * jj + 2] += e1 * it[4 * jj + 2];
          acc[r][4 * jj + 3] += e1 * it[4 * jj + 3];
        }
      }
      const uint32_t xs = xh + qt * BOX;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int p = 8 * jj + 2 * t4;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = r0 + 8 * hh;
          if (p >= P || i >= cl) continue;
          const float2 xv = unpack_bf16(lds32(swz(xs, 16 * wq + g4 + 8 * hh, jj) + 4 * t4));
          *reinterpret_cast<uint32_t*>(args.y + (((long long)bi * S + s0 + i) * H + h) * P + p) =
              pack_bf16(acc[r][4 * jj + 2 * hh] + dv * xv.x,
                        acc[r][4 * jj + 2 * hh + 1] + dv * xv.y);
        }
      }
    }
    __syncthreads();  // this head's readers of x, cum, the increment and prev are done
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

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
// strides (sb, ss, sh) (the last dim contiguous): dims (d, heads, seq,
// batch), boxes of 64 columns x 64 rows of one head of one batch row,
// 128-byte swizzled; reads past d or seq give zeros, so a tile never
// reaches the next batch row
bool bf16_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int d, int heads, int seq,
              int batch, long long sb, long long ss, long long sh) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)mm::T, 1};
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
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int NB>
int launch_mma(const void* x, const void* b, const void* c, const mm::Args& args, int batch,
               const long long* st, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap m_x, m_b, m_c;
  if (!bf16_map(encode, &m_x, x, args.P, args.H, args.S, batch, st[0], st[1], st[2]) ||
      !bf16_map(encode, &m_b, b, args.N, args.G, args.S, batch, st[6], st[7], st[8]) ||
      !bf16_map(encode, &m_c, c, args.N, args.G, args.S, batch, st[9], st[10], st[11]))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ssd_mma_kernel<NB>;
  static std::atomic<unsigned long long> done{0};
  const cudaError_t err = allow_smem(kernel, mm::smem_bytes(NB, mm::MAX_TILES), done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (args.chunk + mm::T - 1) / mm::T;
  kernel<<<batch * (args.H / args.hpb) * args.nc, mm::THREADS, mm::smem_bytes(NB, tiles),
           stream>>>(m_x, m_b, m_c, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block of `variant` (0 fma, 1 mma) needs; mma
// with nb 64-column boxes of N (1: N <= 64, 2: N <= 128) and `tiles`
// 64-row tiles a chunk. -1 for an unknown variant.
int ssd_scan_smem_bytes(int variant, int nb, int tiles) {
  if (variant == kFma) return kSmemBytes;
  if (variant == kMma) return mm::smem_bytes(nb, tiles);
  return -1;
}

// x (B,S,H,P), b/c (B,S,G,N) read through element strides (x: b, s, h;
// dt: b, s, h; b: b, s, g; c: b, s, g; the last dim contiguous); dt
// (B,S,H), a (H,), d (H,) f32; y (B,S,H,P) contiguous in x's dtype
// (`dtype` 1 bf16, 0 f32). A chunk longer than S is one chunk of S rows.
// variant 0 (fma): P <= 64, N <= 128, chunk <= 512; ws, flags, epoch and
//   hpb unused.
// variant 1 (mma; bf16; P, N multiples of 16 with P <= 64, N <= 128;
//   chunk <= 256; x, b, c base addresses and row strides 16-byte aligned;
//   hpb heads a block, dividing H / G): grid B (H / hpb) nc blocks (nc =
//   ceil(S / chunk)); ws (B H (nc - 1) P N) f32,
//   any contents; flags (1 + B H (nc - 1)) int32, the counter flags[0]
//   zero before and after the call, no slot flag equal to `epoch` (> 0)
//   before it. Two calls may not share ws or flags at one time (on two
//   streams).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments the
// variant does not take.
int ssd_scan_launch(int variant, const void* x, const void* dt, const void* a, const void* b,
                    const void* c, const void* d, void* y, void* ws, void* flags, int epoch,
                    int hpb, int batch, int S, int H, int P, int G, int N, int chunk, long long xsb,
                    long long xss, long long xsh, long long dtsb, long long dtss, long long dtsh,
                    long long bsb, long long bss, long long bsg, long long csb, long long css,
                    long long csg, int dtype, void* stream) {
  if (batch < 1 || S < 1 || H < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN || chunk < 1 ||
      chunk > kMaxChunk || G < 1 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kMma) {
    if (dtype != 1 || P % 16 || N % 16 || epoch <= 0 || chunk > mm::MAX_TILES * mm::T ||
        hpb < 1 || (H / G) % hpb)
      return static_cast<int>(cudaErrorInvalidValue);
    const mm::Args args{static_cast<const float*>(dt), static_cast<const float*>(a),
                        static_cast<const float*>(d), static_cast<bf16*>(y),
                        static_cast<float*>(ws), static_cast<int*>(flags), epoch, hpb,
                        S, H, P, G, N, chunk, (S + chunk - 1) / chunk, dtsb, dtss, dtsh};
    const long long st[12] = {xsb, xss, xsh, dtsb, dtss, dtsh, bsb, bss, bsg, csb, css, csg};
    return N <= 64 ? launch_mma<1>(x, b, c, args, batch, st, s)
                   : launch_mma<2>(x, b, c, args, batch, st, s);
  }
  if (variant != kFma) return static_cast<int>(cudaErrorInvalidValue);
  const Args args{x, static_cast<const float*>(dt), static_cast<const float*>(a),
                  b, c, static_cast<const float*>(d), y, S, H, P, G, N, chunk,
                  xsb, xss, xsh, dtsb, dtss, dtsh, bsb, bss, bsg, csb, css, csg};
  return dtype == 1 ? launch<bf16>(args, batch, s) : launch<float>(args, batch, s);
}

}  // extern "C"
