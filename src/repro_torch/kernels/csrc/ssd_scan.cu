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
// chunk at a time, all in f32: cum = cumsum(dt * a) within the chunk,
//
//   y_i  = sum_{j <= i} (c_i . b_j) exp(cum_i - cum_j) dt_j x_j   (intra)
//        + exp(cum_i) (c_i . state^T)                             (inter)
//        + d x_i                                                  (skip)
//   state = state exp(cum_last) + sum_j (x_j dt_j exp(cum_last - cum_j)) b_j^T
//
// The decay is always exp of a difference of cumulative sums, never a
// ratio of two exps: within a 256-row chunk cum reaches about -4000 at
// a = -16, where exp(cum) is 0 in f32 and a ratio would be 0/0.
//
// What bounds it: at the training path's shape (B 4, S 1024, H 80, P 64,
// G 1, N 128, chunk 256, bf16) it moves 87 MB (x read, y written, b/c and
// dt read once) and does 26.9 GFLOP on the live causal pairs: about 26 us
// of memory time against 27 us of bf16 tensor-core time. This first
// version runs its products on CUDA-core f32 FMA (401 us at 67 TFLOP/s
// is its own floor); mma/wgmma and a chunk-parallel form are later work.
//
// Design, and how it differs from the TPU kernel:
//   * The TPU carries the (P, N) state in VMEM across a grid axis that
//     runs in order; GPU blocks run in no order. So one block owns one
//     (batch, head) and loops over its chunks, the f32 state in shared
//     memory (N x P, 32 KB at N 128, P 64). Grid (H, B): the heads of one
//     batch row, which share b and c, run side by side and meet in L2.
//   * The chunk's (c x c) weight matrix does not fit (256 KB in f32 at
//     c 256): the intra term walks 64-row query tiles and, for each, the
//     64-row key tiles at or below the diagonal, like a causal flash-
//     attention loop; the tiles above the diagonal are skipped.
//   * The state update runs inside the last query tile's key loop, which
//     visits every key tile of the chunk with its b and x already in
//     shared memory; the state is written after every query tile has
//     read the old one for its inter term.
//   * b and c are indexed by group (h / (H / G)), never repeated to H
//     heads in memory; x is not copied to heads-first.
//   * A ragged sequence needs no padding: the last chunk is shorter, and
//     rows past its end load as zeros (dt = 0 adds nothing) and are not
//     stored. A chunk longer than the sequence is one chunk of S rows
//     (the TPU wrapper's cap).
//   * No intermediate is rounded: the weights (c.b) L dt stay f32 for the
//     product with x, as in the TPU kernel. The plain PyTorch version
//     rounds them to x's dtype there; the difference is within a few
//     bf16 ulps of the output.
//
// Plain C interface, loaded with ctypes by repro_torch/kernels/build.py;
// launches on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

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

}  // namespace

extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* b, const void* c, const void* d,
                               void* y, int batch, int S, int H, int P, int G,
                               int N, int chunk, long long xsb, long long xss,
                               long long xsh, long long dtsb, long long dtss,
                               long long dtsh, long long bsb, long long bss,
                               long long bsg, long long csb, long long css,
                               long long csg, int dtype, void* stream) {
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || chunk < 1 ||
      chunk > kMaxChunk || G < 1 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{x, static_cast<const float*>(dt), static_cast<const float*>(a),
                  b, c, static_cast<const float*>(d), y, S, H, P, G, N, chunk,
                  xsb, xss, xsh, dtsb, dtss, dtsh, bsb, bss, bsg, csb, css, csg};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<bf16>(args, batch, s) : launch<float>(args, batch, s);
}
