// The shared AGLMCMC epoch's redraw of one chunk of chains (K10): each
// chain's oversampled draws from the shared KDE, the prior check, the
// stable valid-first partition, and the simulation, discrepancy and
// epsilon-kernel of the rows it keeps, in one launch.
//
// Replaces no kernel of the JAX package: there the shared epoch's redraw is
// XLA's fusion of KernelDensity.sample, the prior check,
// ops/resampling.blocked_stable_partition_take and the problem's simulator
// (glabc_tpu/samplers/aglmcmc.py _redraw, _pool_from_proposals).  The
// port ran it as some 60 ATen launches a chunk, two int64 scans among
// them.  The plain torch version is
// glabc_tpu_torch/ops/kernels/shared_redraw_kernel.py
// (SharedRedraw.plain), which is that sequence.
//
// For chain c of the chunk, candidate i < M = oversample P, with the
// chunk's u (C, M), z (C, M, d) and noise (C, P, d) drawn by torch:
//
//   k     = min(upper_bound(cdf, u[c,i] * cdf[n-1]), n - 1)
//   cand  = X[k] + z[c,i] * bw
//   prior = prior0 - 0.5 sum_f cand_f^2,  valid when prior > cutoff
//
// Slot s < P of the chain takes the s-th valid candidate, in order; when
// fewer than P of the M are valid, the invalid ones fill the rest in order.
// For the row in slot s: theta = cand (as drawn: K4 reads it, then zeroes
// the rows holding a NaN, csrc/kde_logprob.cu's pool epilogue),
// x = |theta_safe| + sigma noise[c,s] (theta_safe: 0 on a NaN row),
// dis = |x - y_obs| (nan_dis on a NaN row or a NaN distance), and
// plk = prior + (logk0 - 0.5 (dis / eps)^2), the pool's log-weight before
// the density is taken off.  Every product and sum is rounded on its own
// (--fmad=false) in the plain version's order, so at d = 2 theta and x are
// bitwise the plain version's (the search is ATen's upper bound, the sum
// of two squares has one order); above, torch's sum over d may take
// another order than this kernel's and round the prior differently.
//
// What bounds it on an H100: bytes.  A chain reads u and z only up to its
// P-th valid candidate (under the N(0, I) prior nearly every candidate is
// valid, so about P of the M = 4P), its noise, and writes P rows of
// 2 d + 2 floats: at 512 chains x P = 2,000, d = 2, about 45 MB, 13 us at
// 3.35 TB/s.  The design keeps the work to that single pass:
// - one block a chain walks its candidates in tiles of one a thread; the
//   block's valid count before each candidate is a ballot, a popcount and
//   the warps' counts in shared memory, so no rank is stored; the walk
//   stops once P valid rows are placed;
// - only a chain with fewer than P valid candidates walks them again, for
//   the invalid ones (recomputed from u and z, not stored);
// - the CDF (n floats) sits in shared memory, up to 12,280 entries, for
//   the binary search; the support rows and z are read where they lie.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace glabc {

constexpr int kRedrawThreads = 256;
constexpr int kRedrawWarps = kRedrawThreads / 32;
// CDF entries staged in dynamic shared memory: what the 48 KB a block may
// hold without an opt-in leaves beside the static warp counts
constexpr int kRedrawCdfSmem =
    static_cast<int>((48 * 1024 - kRedrawWarps * sizeof(int)) / sizeof(float));

struct RedrawArgs {
  const float* u;      // (C, M)
  const float* z;      // (C, M, d)
  const float* noise;  // (C, P, d)
  const float* cdf;    // (n,) nondecreasing
  const float* X;      // (n, d) support
  const float* bw;     // (d,)
  const float* y_obs;  // (d,)
  const float* logk0;  // () the epsilon-kernel's log-density at 0
  float* theta;        // (C, P, d)
  float* x;            // (C, P, d)
  float* dis;          // (C, P)
  float* plk;          // (C, P)
  int C, M, P, n, d;
  float prior0, cutoff, sigma, eps, nan_dis;
};

// torch.searchsorted(cdf, q, right=True) (ATen's upper bound: a NaN query
// runs to n), clamped to n - 1
__device__ __forceinline__ int pick(const float* cdf, int n, float q) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(cdf[mid] > q)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return min(lo, n - 1);
}

__device__ __forceinline__ float cand(const RedrawArgs& a, int d, int k,
                                      size_t zi, int f) {
  return a.X[static_cast<size_t>(k) * d + f] + a.z[zi * d + f] * a.bw[f];
}

// The exclusive count of set flags before this thread in the block, and
// the block's total; every thread of the block calls it.
__device__ __forceinline__ void block_count(bool flag, int* warp_counts,
                                            int& before, int& total) {
  const unsigned mask = __ballot_sync(0xffffffffu, flag);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_counts[warp] = __popc(mask);
  __syncthreads();
  int off = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kRedrawWarps; ++w) {
    const int cnt = warp_counts[w];
    off += w < warp ? cnt : 0;
    all += cnt;
  }
  before = off + __popc(mask & ((1u << lane) - 1u));
  total = all;
  __syncthreads();   // the counts are rewritten by the next tile
}

// Candidate i of chain c: its component k and its prior (top: cdf[n-1]).
__device__ __forceinline__ float prior_of(const RedrawArgs& a, const float* cdf,
                                          float top, int d, int c, int i,
                                          int& k) {
  const size_t zi = static_cast<size_t>(c) * a.M + i;
  k = pick(cdf, a.n, a.u[zi] * top);
  float s = 0.0f;
#pragma unroll
  for (int f = 0; f < d; ++f) {
    const float v = cand(a, d, k, zi, f);
    s = s + v * v;
  }
  return a.prior0 - 0.5f * s;
}

// Candidate i (component k, prior) into slot s of chain c.
__device__ __forceinline__ void write_row(const RedrawArgs& a, int d, int c,
                                          int i, int k, float prior, int s) {
  const size_t zi = static_cast<size_t>(c) * a.M + i;
  const size_t row = static_cast<size_t>(c) * a.P + s;
  bool nan_row = false;
#pragma unroll
  for (int f = 0; f < d; ++f) {
    const float v = cand(a, d, k, zi, f);
    a.theta[row * d + f] = v;
    nan_row = nan_row || isnan(v);
  }
  float ss = 0.0f;
#pragma unroll
  for (int f = 0; f < d; ++f) {
    const float v = nan_row ? 0.0f : cand(a, d, k, zi, f);
    const float xv = fabsf(v) + a.sigma * a.noise[row * d + f];
    a.x[row * d + f] = xv;
    const float diff = xv - a.y_obs[f];
    ss = ss + diff * diff;
  }
  float dis = sqrtf(ss);
  if (nan_row || isnan(dis)) dis = a.nan_dis;
  const float r = dis / a.eps;
  a.dis[row] = dis;
  a.plk[row] = prior + (*a.logk0 - 0.5f * (r * r));
}

template <int D>
__global__ void __launch_bounds__(kRedrawThreads)
shared_redraw_kernel(RedrawArgs a) {
  extern __shared__ __align__(16) float cdf_smem[];
  __shared__ int warp_counts[kRedrawWarps];
  const int d = D > 0 ? D : a.d;   // D > 0: d known to the compiler
  const int c = blockIdx.x;
  const float* cdf = a.cdf;
  const float top = a.cdf[a.n - 1];
  if (a.n <= kRedrawCdfSmem) {
    for (int j = threadIdx.x; j < a.n; j += kRedrawThreads)
      cdf_smem[j] = a.cdf[j];
    __syncthreads();
    cdf = cdf_smem;
  }
  // the valid candidates, in order, until P are placed
  int placed = 0;   // the same in every thread
  for (int t0 = 0; t0 < a.M && placed < a.P; t0 += kRedrawThreads) {
    const int i = t0 + threadIdx.x;
    int k = 0;
    float prior = 0.0f;
    bool ok = false;
    if (i < a.M) {
      prior = prior_of(a, cdf, top, d, c, i, k);
      ok = prior > a.cutoff;
    }
    int before, total;
    block_count(ok, warp_counts, before, total);
    if (ok && placed + before < a.P)
      write_row(a, d, c, i, k, prior, placed + before);
    placed += total;
  }
  // fewer than P valid: the invalid ones fill the rest, in order
  for (int t0 = 0; t0 < a.M && placed < a.P; t0 += kRedrawThreads) {
    const int i = t0 + threadIdx.x;
    int k = 0;
    float prior = 0.0f;
    bool bad = false;
    if (i < a.M) {
      prior = prior_of(a, cdf, top, d, c, i, k);
      bad = !(prior > a.cutoff);
    }
    int before, total;
    block_count(bad, warp_counts, before, total);
    if (bad && placed + before < a.P)
      write_row(a, d, c, i, k, prior, placed + before);
    placed += total;
  }
}

template <int D>
int launch_redraw(const RedrawArgs& a, cudaStream_t s) {
  const size_t smem =
      a.n <= kRedrawCdfSmem ? static_cast<size_t>(a.n) * sizeof(float) : 0;
  shared_redraw_kernel<D><<<a.C, kRedrawThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace glabc

extern "C" int glabc_shared_redraw(
    const float* u, const float* z, const float* noise, const float* cdf,
    const float* X, const float* bw, const float* y_obs, const float* logk0,
    float* theta, float* x, float* dis, float* plk, int C, int M, int P,
    int n, int d, float prior0, float cutoff, float sigma, float eps,
    float nan_dis, void* stream) {
  using namespace glabc;
  if (d < 1 || n < 1 || M < 0 || P < 0) return -1;
  if (C == 0 || P == 0) return 0;
  const RedrawArgs a{u,     z,     noise, cdf,    X,      bw,   y_obs,
                     logk0, theta, x,     dis,    plk,    C,    M,
                     P,     n,     d,     prior0, cutoff, sigma, eps,
                     nan_dis};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 2) return launch_redraw<2>(a, s);
  return launch_redraw<0>(a, s);
}
