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
// - sum_f log h_f - (d/2) log 2 pi, computed by the wrapper.  The terms are
// added in the plain version's order (--fmad=false); the logsumexp is a
// running one (max and rescaled sum) here and a two-pass one there, so the
// two agree to float32 rounding of the sum, not to the bit.
//
// What bounds it on an H100: C * N * P exponentials, each with d + 3
// further 32-bit operations (the affine term as d multiply-adds, the
// running max, the subtraction, the add), against 4 (C P (d+1) + C N (d+1))
// bytes.  At the canonical 32,768 chains, N = P = 1000, d = 2 that is
// 3.3e10 exponentials per epoch: 7.8 ms at the special-function units' 16
// per SM per clock, about 5 ms of other operations at one per lane per
// clock, and 0.8 ms of bytes.  The kernel is bound by its exponentials.  Its
// design spends nothing on memory: one thread block per (chain, tile of
// 256 points); the chain's support (pre and ms, (d+1) P floats, 12 KB at
// P=1000, d=2) is staged in shared memory, where every thread reads the
// same word at once (a broadcast); each thread owns one point, keeps it in
// registers and streams the support once.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace glabc {

constexpr int kKdeThreads = 256;
constexpr int kKdeSmemFloats = 12 * 1024;   // 48 KB of staged support

struct KdeArgs {
  const float* x;       // (C, N, d)
  const float* ms;      // (C, P, d)
  const float* pre;     // (C, P)
  const float* inv_h2;  // (C, d)
  float* out;           // (C, N)
  int C, N, P, d, tile, tiles_n;
};

template <int D>
__global__ void kde_logprob_kernel(KdeArgs a) {
  __shared__ float smem[kKdeSmemFloats];
  const int d = a.d;
  const int c = blockIdx.x / a.tiles_n;
  const int n = (blockIdx.x - c * a.tiles_n) * blockDim.x + threadIdx.x;
  const bool live = n < a.N;
  float xv[D];
#pragma unroll
  for (int f = 0; f < D; ++f) {
    if (f < d) {
      xv[f] = live ? a.x[(static_cast<size_t>(c) * a.N + n) * d + f] : 0.0f;
    }
  }
  float m = -INFINITY;
  float s = 0.0f;
  float* spre = smem;
  float* sms = smem + a.tile;
  const size_t base = static_cast<size_t>(c) * a.P;
  for (int p0 = 0; p0 < a.P; p0 += a.tile) {
    const int np = min(a.tile, a.P - p0);
    __syncthreads();
    for (int i = threadIdx.x; i < np; i += blockDim.x) {
      spre[i] = a.pre[base + p0 + i];
    }
    for (int k = threadIdx.x; k < np * d; k += blockDim.x) {
      sms[k] = a.ms[(base + p0) * d + k];
    }
    __syncthreads();
    if (live) {
      for (int i = 0; i < np; ++i) {
        float lw = spre[i];
#pragma unroll
        for (int f = 0; f < D; ++f) {
          if (f < d) lw = lw + xv[f] * sms[i * d + f];
        }
        if (lw > m) {
          s = s * expf(m - lw) + 1.0f;
          m = lw;
        } else {
          s = s + expf(lw - m);
        }
      }
    }
  }
  if (!live) return;
  float q2 = 0.0f;
#pragma unroll
  for (int f = 0; f < D; ++f) {
    if (f < d) q2 = q2 + (xv[f] * xv[f]) * a.inv_h2[static_cast<size_t>(c) * d + f];
  }
  a.out[static_cast<size_t>(c) * a.N + n] = (m + logf(s)) - 0.5f * q2;
}

}  // namespace glabc

extern "C" int glabc_kde_logprob(const float* x, const float* ms,
                                 const float* pre, const float* inv_h2,
                                 float* out, int C, int N, int P, int d,
                                 void* stream) {
  using namespace glabc;
  if (d < 1 || d > 32 || P < 1) return -1;
  const int tile = kKdeSmemFloats / (d + 1);
  const int tiles_n = (N + kKdeThreads - 1) / kKdeThreads;
  KdeArgs a{x, ms, pre, inv_h2, out, C, N, P, d, tile, tiles_n};
  const dim3 grid(static_cast<unsigned>(C) * tiles_n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 1) {
    kde_logprob_kernel<1><<<grid, kKdeThreads, 0, s>>>(a);
  } else if (d <= 2) {
    kde_logprob_kernel<2><<<grid, kKdeThreads, 0, s>>>(a);
  } else if (d <= 3) {
    kde_logprob_kernel<3><<<grid, kKdeThreads, 0, s>>>(a);
  } else if (d <= 4) {
    kde_logprob_kernel<4><<<grid, kKdeThreads, 0, s>>>(a);
  } else if (d <= 8) {
    kde_logprob_kernel<8><<<grid, kKdeThreads, 0, s>>>(a);
  } else if (d <= 16) {
    kde_logprob_kernel<16><<<grid, kKdeThreads, 0, s>>>(a);
  } else {
    kde_logprob_kernel<32><<<grid, kKdeThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
