// Per-chain weighted-KDE log-density of N points under that chain's own
// P-component Gaussian mixture (the AGLMCMC adaptation epoch's redrawn-pool
// density), batched over chains.
//
// Replaces glabc_tpu/ops/pallas/kde_logprob_kernel.py
// BatchedMixtureLogProb._kernel (K4).  The plain torch version is
// glabc_tpu_torch/ops/kernels/kde_logprob_kernel.py
// (BatchedMixtureLogProb.plain):
//
//   log q_c(x) = logsumexp_i(pre[c,i] + sum_f ms[c,i,f] x_f)
//                - 0.5 sum_f x_f^2 inv_h2[c,f]
//
// with ms = mu / h^2 and pre = log(w + 1e-10) - 0.5 sum_f mu_f^2 / h_f^2
// - sum_f log h_f - (d/2) log 2 pi, computed by the wrapper.  pre is finite
// (the 1e-10 stabilizer).
//
// What bounds it on an H100 (SXM, 700 W: 132 SMs at 1.98 GHz): C N P
// exponentials, each with d + 3 further 32-bit operations (the affine term
// as d multiply-adds, the max, the subtraction, the add), against
// 4 (C P (d+1) + C N (d+1)) bytes.  At the canonical 32,768 chains,
// N = P = 1000, d = 2 that is 3.3e10 exponentials: a bound of 7.8 ms at the
// special-function units' 16 per SM per clock, against about 5 ms of other
// operations at one per lane per clock and 0.8 ms of bytes.  So the kernel
// keeps every other instruction of a term under the 8 issue cycles one
// warp's exponential takes on its scheduler's MUFU unit:
//
// - the work is done in the log2 domain: pre and ms are scaled by log2(e)
//   as they are staged into shared memory, a term is d __fmaf_rn, and its
//   exponential is one ex2.approx.ftz.f32 (one MUFU.EX2) of (term - max);
//   the result is (max ln 2 + logf(sum)) - 0.5 q2.  So the kernel is not
//   bitwise with its plain version (it never was: its logsumexp is a
//   running one); chip_smoke.py holds it to 1e-4 max(1, |log q|);
// - the logsumexp is branch-free: a chunk of K = 16 components is computed
//   into registers for each of the thread's R = 2 points, the chunk max is
//   folded into the running max and the running sum rescaled once a chunk
//   (1 + 1/K exponentials a term), then the K exponentials are added with
//   no compare;
// - a block owns R * 256 points of one chain (two blocks per chain at
//   N = 1000), each thread R of them, so the support is staged once per
//   block and each shared-memory read feeds R terms; a component is one
//   16-byte row (pre, ms_0, ms_1, ms_2) for d <= 3, read by one broadcast
//   LDS.128 (wider d: d + 1 floats a row, zero-padded to the template
//   width); shared memory is sized to P (rows in chunks of at most 48 KB
//   when P does not fit, rows past P padded with pre = -inf).
// On an NVIDIA H100 80GB HBM3 at 700 W the inner loop issues 5.8
// instructions a term besides 1.06 MUFU (cuobjdump -sass, printed by
// chip_smoke.py's k4_sass_line), and the main shape takes 10.8 ms, 78 % of
// the MUFU rate a microbenchmark reaches on the same card (PERF.md).  R = 4,
// K = 8 (one block per chain) took 11.2 ms.
//
// D is a compile-time bound on d up to 32, one instantiation each, the
// thread's points in registers.  Above d = 32 (up to 128) one runtime-d
// kernel takes the launch, kde_logprob_wide_kernel: the block's 256 points
// (one a thread) sit in dynamic shared memory, coordinate-major (d x 256
// floats, 128 KB at d = 128), beside the staged component rows (d + 1
// floats each, 48 KB); a term is walked in chunks of 32 coordinates, the
// thread's 32 coordinates loaded into registers once per chunk of 16
// components, so that each shared-memory read of a row feeds one
// multiply-add and each point read 16.  Its
// arithmetic is the plain version's, not the log2 domain of the static
// kernels: a term is pre, then + x_f ms_f in coordinate order, each product
// and sum rounded on its own (--fmad=false), the running logsumexp over
// chunks of 16 by the accurate expf, and (max + log(sum)) - 0.5 q2.  At
// d = 40 a fitted per-chain KDE's terms are large and cancel, so each
// extra rounding of a term shows: on an H100 the log2-domain arithmetic
// read 1.4e-3 max(1, |log q|) from the plain version on the AGLMCMC d = 40
// epoch's densities, against the limit 1e-4.
// At d > 32 a term is over 33 multiply-adds, so the FP32 lanes bound it.
//
// The shared AGLMCMC epoch's pool epilogue (glabc_kde_logprob_pool: its own
// instantiation, kde_logprob_pool_kernel, up to d = 32, a runtime branch of
// the wide kernel above; C = 1, the points a redraw chunk's rows as K10
// drew them, csrc/shared_redraw.cu):
// log_w holds prior + log K on entry and (prior + log K) - log q on exit, a
// NaN as -inf; each point's row of x that holds a NaN is set to 0 after the
// point is read (the pool's theta).  A point is read by one block alone, and
// every read of the block's points precedes its first barrier, so the
// writes race with no read.  Per point 8 bytes more, beside C N P terms.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace glabc {

constexpr int kKdeThreads = 256;
constexpr int kKdeR = 2;                    // points per thread
constexpr int kKdeK = 16;                   // components per chunk
constexpr int kKdeSmemFloats = 12 * 1024;   // at most 48 KB of staged rows
constexpr float kLog2e = 1.44269504088896340736f;
constexpr float kLn2 = 0.69314718055994530942f;

// floats per staged component: (pre, ms_0 .. ms_{D-1}), 4 for D <= 3
__host__ __device__ constexpr int kde_row(int D) { return D <= 3 ? 4 : D + 1; }

struct KdeArgs {
  const float* x;       // (C, N, d)
  const float* ms;      // (C, P, d)
  const float* pre;     // (C, P)
  const float* inv_h2;  // (C, d)
  float* out;           // (C, N)
  float* log_w;         // (C, N) the pool epilogue's weights, or null
  float* pool_x;        // x itself, written by the pool epilogue
  int C, N, P, d, rows, tiles_n;
};

// The pool epilogue of point o (log q lq), whose row holds a NaN when
// nan_row.
__device__ __forceinline__ void pool_epilogue(const KdeArgs& a, size_t o,
                                              float lq, bool nan_row) {
  const float lw = a.log_w[o] - lq;
  a.log_w[o] = isnan(lw) ? -INFINITY : lw;
  if (nan_row) {
    for (int f = 0; f < a.d; ++f) a.pool_x[o * a.d + f] = 0.0f;
  }
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The static kernels' body; kPool: with the pool epilogue, compiled into
// its own entry point so that the plain kernel keeps its registers (the
// epilogue cost kde_logprob_kernel<2> a spill and 1.2 % at the per-chain
// epoch's shape on an H100).
template <int D, bool kPool>
__device__ __forceinline__ void kde_logprob_body(const KdeArgs& a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int W = kde_row(D);
  constexpr int kTile = kKdeR * kKdeThreads;
  const int d = a.d;
  const int c = blockIdx.x / a.tiles_n;
  const int n0 = (blockIdx.x - c * a.tiles_n) * kTile + threadIdx.x;
  // the thread's points, zero past d and past N (those lanes compute and
  // do not write)
  float xv[kKdeR][D];
#pragma unroll
  for (int r = 0; r < kKdeR; ++r) {
    const int n = n0 + r * kKdeThreads;
#pragma unroll
    for (int f = 0; f < D; ++f) {
      xv[r][f] = (f < d && n < a.N)
                     ? a.x[(static_cast<size_t>(c) * a.N + n) * d + f]
                     : 0.0f;
    }
  }
  float m[kKdeR], s[kKdeR];
#pragma unroll
  for (int r = 0; r < kKdeR; ++r) {
    m[r] = -INFINITY;
    s[r] = 0.0f;
  }
  const size_t base = static_cast<size_t>(c) * a.P;
  for (int p0 = 0; p0 < a.P; p0 += a.rows) {
    const int np = min(a.rows, a.P - p0);
    const int npad = (np + kKdeK - 1) / kKdeK * kKdeK;
    __syncthreads();
    for (int k = threadIdx.x; k < npad * W; k += kKdeThreads) {
      const int i = k / W, f = k - i * W;
      float v = 0.0f;
      if (i >= np) {
        v = f == 0 ? -INFINITY : 0.0f;
      } else if (f == 0) {
        v = a.pre[base + p0 + i] * kLog2e;
      } else if (f <= d) {
        v = a.ms[(base + p0 + i) * d + (f - 1)] * kLog2e;
      }
      smem[k] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int i0 = 0; i0 < npad; i0 += kKdeK) {
      float t[kKdeR][kKdeK];
#pragma unroll
      for (int k = 0; k < kKdeK; ++k) {
        float w[W];
        const float* row = smem + (i0 + k) * W;
        if constexpr (W == 4) {
          const float4 v = *reinterpret_cast<const float4*>(row);
          w[0] = v.x;
          w[1] = v.y;
          w[2] = v.z;
          w[3] = v.w;
        } else {
#pragma unroll
          for (int f = 0; f < W; ++f) w[f] = row[f];
        }
#pragma unroll
        for (int r = 0; r < kKdeR; ++r) {
          float acc = w[0];
#pragma unroll
          for (int f = 0; f < D; ++f) acc = __fmaf_rn(xv[r][f], w[1 + f], acc);
          t[r][k] = acc;
        }
      }
#pragma unroll
      for (int r = 0; r < kKdeR; ++r) {
        float mx = t[r][0];
#pragma unroll
        for (int k = 1; k < kKdeK; ++k) mx = fmaxf(mx, t[r][k]);
        const float mn = fmaxf(m[r], mx);
        float acc = s[r] * ex2_approx(m[r] - mn);
#pragma unroll
        for (int k = 0; k < kKdeK; ++k) acc = acc + ex2_approx(t[r][k] - mn);
        s[r] = acc;
        m[r] = mn;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kKdeR; ++r) {
    const int n = n0 + r * kKdeThreads;
    if (n >= a.N) continue;
    float q2 = 0.0f;
#pragma unroll
    for (int f = 0; f < D; ++f) {
      if (f < d) {
        q2 = q2 + (xv[r][f] * xv[r][f]) *
                      a.inv_h2[static_cast<size_t>(c) * d + f];
      }
    }
    const size_t o = static_cast<size_t>(c) * a.N + n;
    const float lq = (m[r] * kLn2 + logf(s[r])) - 0.5f * q2;
    a.out[o] = lq;
    if constexpr (kPool) {
      bool nan_row = false;
#pragma unroll
      for (int f = 0; f < D; ++f) nan_row = nan_row || isnan(xv[r][f]);
      pool_epilogue(a, o, lq, nan_row);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kKdeThreads)
kde_logprob_kernel(KdeArgs a) {
  kde_logprob_body<D, false>(a);
}

template <int D>
__global__ void __launch_bounds__(kKdeThreads)
kde_logprob_pool_kernel(KdeArgs a) {
  kde_logprob_body<D, true>(a);
}

constexpr int kKdeMaxD = 128;
constexpr int kKdeWideD = 32;   // the largest static instantiation
constexpr int kKdeWideK = 16;   // components a chunk
constexpr int kKdeWideF = 32;   // coordinates a chunk
constexpr int kKdeWideRowFloats = 12 * 1024;  // staged rows: 48 KB

__global__ void __launch_bounds__(kKdeThreads)
kde_logprob_wide_kernel(KdeArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int d = a.d, W = d + 1;
  float* const xs = smem;                       // (d, kKdeThreads)
  float* const rows = smem + d * kKdeThreads;   // (a.rows, W)
  const int c = blockIdx.x / a.tiles_n;
  const int p0n = (blockIdx.x - c * a.tiles_n) * kKdeThreads;
  const int n = p0n + threadIdx.x;
  // the block's points, zero past N (those lanes compute and do not write)
  for (int k = threadIdx.x; k < kKdeThreads * d; k += kKdeThreads) {
    const int i = k / d, f = k - i * d;
    xs[f * kKdeThreads + i] =
        p0n + i < a.N
            ? a.x[(static_cast<size_t>(c) * a.N + p0n + i) * d + f]
            : 0.0f;
  }
  float m = -INFINITY, s = 0.0f;
  const size_t base = static_cast<size_t>(c) * a.P;
  for (int p0 = 0; p0 < a.P; p0 += a.rows) {
    const int np = min(a.rows, a.P - p0);
    const int npad = (np + kKdeWideK - 1) / kKdeWideK * kKdeWideK;
    __syncthreads();
    for (int k = threadIdx.x; k < npad * W; k += kKdeThreads) {
      const int i = k / W, f = k - i * W;
      float v = 0.0f;
      if (i >= np) {
        v = f == 0 ? -INFINITY : 0.0f;
      } else if (f == 0) {
        v = a.pre[base + p0 + i];
      } else {
        v = a.ms[(base + p0 + i) * d + (f - 1)];
      }
      rows[k] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int i0 = 0; i0 < npad; i0 += kKdeWideK) {
      float t[kKdeWideK];
#pragma unroll
      for (int k = 0; k < kKdeWideK; ++k) t[k] = rows[(i0 + k) * W];
#pragma unroll 1
      for (int f0 = 0; f0 < d; f0 += kKdeWideF) {
        const int nf = min(kKdeWideF, d - f0);
        float xv[kKdeWideF];
#pragma unroll
        for (int f = 0; f < kKdeWideF; ++f)
          xv[f] = f < nf ? xs[(f0 + f) * kKdeThreads + threadIdx.x] : 0.0f;
#pragma unroll
        for (int k = 0; k < kKdeWideK; ++k) {
          const float* const row = rows + (i0 + k) * W + 1 + f0;
          float acc = t[k];
#pragma unroll
          for (int f = 0; f < kKdeWideF; ++f)
            if (f < nf) acc = acc + xv[f] * row[f];
          t[k] = acc;
        }
      }
      float mx = t[0];
#pragma unroll
      for (int k = 1; k < kKdeWideK; ++k) mx = fmaxf(mx, t[k]);
      const float mn = fmaxf(m, mx);
      float acc = s * expf(m - mn);
#pragma unroll
      for (int k = 0; k < kKdeWideK; ++k) acc = acc + expf(t[k] - mn);
      s = acc;
      m = mn;
    }
  }
  if (n >= a.N) return;
  float q2 = 0.0f;
  bool nan_row = false;
  for (int f = 0; f < d; ++f) {
    const float xf = xs[f * kKdeThreads + threadIdx.x];
    q2 = q2 + (xf * xf) * a.inv_h2[static_cast<size_t>(c) * d + f];
    nan_row = nan_row || isnan(xf);
  }
  const size_t o = static_cast<size_t>(c) * a.N + n;
  const float lq = (m + logf(s)) - 0.5f * q2;
  a.out[o] = lq;
  if (a.log_w != nullptr) pool_epilogue(a, o, lq, nan_row);
}

int launch_kde_wide(KdeArgs a, cudaStream_t s) {
  const int W = a.d + 1;
  const int cap = kKdeWideRowFloats / W / kKdeWideK * kKdeWideK;
  a.rows = min((a.P + kKdeWideK - 1) / kKdeWideK * kKdeWideK, cap);
  a.tiles_n = (a.N + kKdeThreads - 1) / kKdeThreads;
  const size_t smem = (static_cast<size_t>(a.d) * kKdeThreads +
                       static_cast<size_t>(a.rows) * W) *
                      sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      kde_logprob_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(a.C) * a.tiles_n);
  kde_logprob_wide_kernel<<<grid, kKdeThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_kde(KdeArgs a, cudaStream_t s) {
  constexpr int W = kde_row(D);
  constexpr int cap = kKdeSmemFloats / W / kKdeK * kKdeK;
  a.rows = min((a.P + kKdeK - 1) / kKdeK * kKdeK, cap);
  const int tile = kKdeR * kKdeThreads;
  a.tiles_n = (a.N + tile - 1) / tile;
  const dim3 grid(static_cast<unsigned>(a.C) * a.tiles_n);
  const size_t smem = static_cast<size_t>(a.rows) * W * sizeof(float);
  if (a.log_w != nullptr) {
    kde_logprob_pool_kernel<D><<<grid, kKdeThreads, smem, s>>>(a);
  } else {
    kde_logprob_kernel<D><<<grid, kKdeThreads, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace glabc

namespace {

int kde_logprob(float* x, const float* ms, const float* pre,
                const float* inv_h2, float* out, float* log_w, int C, int N,
                int P, int d, void* stream) {
  using namespace glabc;
  if (d < 1 || d > kKdeMaxD || P < 1) return -1;
  if (C == 0 || N == 0) return 0;
  KdeArgs a{x, ms, pre, inv_h2, out, log_w, x, C, N, P, d, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 1) return launch_kde<1>(a, s);
  if (d <= 2) return launch_kde<2>(a, s);
  if (d <= 3) return launch_kde<3>(a, s);
  if (d <= 4) return launch_kde<4>(a, s);
  if (d <= 8) return launch_kde<8>(a, s);
  if (d <= 16) return launch_kde<16>(a, s);
  if (d <= kKdeWideD) return launch_kde<32>(a, s);
  return launch_kde_wide(a, s);
}

}  // namespace

extern "C" int glabc_kde_logprob(const float* x, const float* ms,
                                 const float* pre, const float* inv_h2,
                                 float* out, int C, int N, int P, int d,
                                 void* stream) {
  // x is only read: the pool epilogue, which writes it, is off
  return kde_logprob(const_cast<float*>(x), ms, pre, inv_h2, out, nullptr, C,
                     N, P, d, stream);
}

// K4 with the shared epoch's pool epilogue: log_w (C, N) in place, x's rows
// that hold a NaN set to 0
extern "C" int glabc_kde_logprob_pool(float* x, const float* ms,
                                      const float* pre, const float* inv_h2,
                                      float* out, float* log_w, int C, int N,
                                      int P, int d, void* stream) {
  return kde_logprob(x, ms, pre, inv_h2, out, log_w, C, N, P, d, stream);
}
