// Generic fused GLMALA transitions over a tile program, one thread per
// chain, a loop over the launch's T steps.
//
// Replaces glabc_tpu/ops/pallas/generic_glmala_kernel.py
// GenericFusedGLMALA._kernel (K9).  The program is a device struct `Program`
// (csrc/programs/*.cuh) pre-included by the build (_build.py,
// -DGLABC_PROGRAM); the plain version is glabc_tpu_torch/ops/kernels/
// generic_glmala_kernel.py on the program's torch twin, every float
// operation in the same order (built with --fmad=false).
//
// A step is iSIR (global: B candidates from sample_global, each simulated
// once, a Gumbel-argmax against the current state, generic_moves.cuh's move
// shared with K8; the cached gradient stays stale, GLMALA.py:183-199) or
// MALA (local: theta' = (theta + tau z)
// + grad tau^2/2, the synthetic-likelihood gradient at theta', MH with the
// reverse drift; an accepted move carries its gradient).  The gradient is
// the JAX generic estimator: for coordinate k and replicate r the program
// simulates at theta' + fd e_k and at theta' - fd e_k from the same Philox
// block range (common random numbers: two passes of one cursor replayed,
// where the TPU kernel re-seeds its generator with _GRAD_STRIDE), keeps
// running sums of the discrepancy and its square per sign, then
//   mu = s1 / n, var = (s2 - (n mu) mu) / (n - 1), s = var + eps^2,
//   log p = -log(s)/2 - ((mu/2) mu) / s,
//   grad_k = (log p(+) - log p(-)) / (2 fd) + prior_grad_k.
//
// Coins: shared (one host coin per step for every chain, read from `coins`;
// a global step skips the gradient batch, as the TPU kernel's lax.cond) or
// per_chain (scalar slot B+2).  A thread computes only the move it takes.
//
// What bounds it on an H100: one MA(2) local step at num_grad=100, d=2 runs
// 2 d num_grad = 400 simulations of 102 innovations (26 Philox blocks, 51
// Box-Muller pairs, the recursion), about 1.5e6 operations, against 8
// bytes of history: bound by operations.  The state and the running sums
// stay in registers; the +fd and -fd simulations are two passes over the
// same blocks (one pass with the two recursions side by side would halve
// the Philox work: later work).
//
// Layouts: theta, grad (D, C); y (Y, C); logk and the four counters (C,);
// history (T, D, C) when collected; coins (T,) int32 in shared mode.
//
// Random numbers per step, counter (chain, step0 + t, block, 0):
//   blocks [0, S), S = ceil((B+3)/4): scalar slot s is lane s%4 of block s/4:
//       Gumbel 0 (current state), 1..B (candidates), B+1 the local accept
//       uniform, B+2 the per-chain coin;
//   candidate b: sample_global at S + b*G, its simulation at
//       S + b*G + (paired ? 0 : gb), G = max(gb, offset + sb);
//   L = S + B*G: the drift z, one Box-Muller pair per dim (cos branch),
//       ZB = ceil(D/2) blocks; the proposal's simulation at L + ZB;
//   gradient replicate r, coordinate k: L + ZB + sb + (r*D + k)*sb.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "generic_moves.cuh"
#include "philox.cuh"

#ifndef GLABC_PROGRAM
#error "generic_glmala.cu is built with a program header (_build.py)"
#endif

namespace glabc {

struct ProgMalaArgs {
  const float* theta_in;
  const float* y_in;
  const float* logk_in;
  const float* grad_in;
  const float* params;
  const int* coins;
  float* theta_out;
  float* y_out;
  float* logk_out;
  float* grad_out;
  float* hist;
  float* acc;
  float* gatt;
  float* gacc;
  float* lacc;
  int C, T, B, n_grad, collect, shared, gb, sb, paired;
  float gf, tau, half_tau2, fd, two_fd, eps2, c_norm;
  uint32_t key0, key1, step0;
};

using Prog = Program;
constexpr int D = Prog::D;
constexpr int Y = Prog::Y;
constexpr uint32_t ZB = (D + 1) / 2;

__device__ __forceinline__ float std_normal_lp(const float (&z)[D], float c) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float per = c - (0.5f * z[j]) * z[j];
    s = (j == 0) ? per : s + per;
  }
  return s;
}

__device__ __forceinline__ float sl_lp(const ProgMalaArgs& a, float s1,
                                       float s2) {
  const float n = static_cast<float>(a.n_grad);
  const float mu = s1 / n;
  const float var = (s2 - (n * mu) * mu) / static_cast<float>(a.n_grad - 1);
  const float s = var + a.eps2;
  return -0.5f * logf(s) - ((0.5f * mu) * mu) / s;
}

// grad log p_ABC at th: CRN central differences through the simulator
__device__ void sl_grad(const ProgMalaArgs& a, uint32_t chain, uint32_t step,
                        uint32_t first, const float (&th)[D], float (&g)[D]) {
  const float* p = a.params;
  float pg[D];
  Prog::prior_grad(p, th, pg);
  const uint32_t sb = static_cast<uint32_t>(a.sb);
#pragma unroll
  for (int k = 0; k < D; ++k) {
    float tp[D], tm[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const float e = (j == k) ? a.fd : 0.0f;
      tp[j] = th[j] + e;
      tm[j] = th[j] - e;
    }
    float s1p = 0.0f, s2p = 0.0f, s1m = 0.0f, s2m = 0.0f;
    for (int r = 0; r < a.n_grad; ++r) {
      const uint32_t blk =
          first + (static_cast<uint32_t>(r) * D + static_cast<uint32_t>(k)) *
                      sb;
      float yp[Y], ym[Y];
      Draws dp(chain, step, a.key0, a.key1, blk);
      Prog::simulate(p, tp, dp, yp);
      Draws dm(chain, step, a.key0, a.key1, blk);   // CRN: the same blocks
      Prog::simulate(p, tm, dm, ym);
      const float disp = Prog::discrepancy(p, yp);
      const float dism = Prog::discrepancy(p, ym);
      s1p = s1p + disp;
      s2p = s2p + disp * disp;
      s1m = s1m + dism;
      s2m = s2m + dism * dism;
    }
    g[k] = (sl_lp(a, s1p, s2p) - sl_lp(a, s1m, s2m)) / a.two_fd + pg[k];
  }
}

__global__ void generic_glmala_kernel(ProgMalaArgs a) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= a.C) return;
  const size_t C = static_cast<size_t>(a.C);
  const float* p = a.params;
  float th[D], yv[Y], gr[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    th[j] = a.theta_in[j * C + c];
    gr[j] = a.grad_in[j * C + c];
  }
#pragma unroll
  for (int j = 0; j < Y; ++j) yv[j] = a.y_in[j * C + c];
  float logk = a.logk_in[c];
  float n_acc = 0.0f, n_gatt = 0.0f, n_gacc = 0.0f, n_lacc = 0.0f;
  const uint32_t chain = static_cast<uint32_t>(c);
  const bool paired = a.paired != 0;
  const uint32_t S = static_cast<uint32_t>((a.B + 3 + 3) / 4);
  const uint32_t g_sim = paired ? 0u : static_cast<uint32_t>(a.gb);
  const uint32_t g_slot = max(static_cast<uint32_t>(a.gb),
                              g_sim + static_cast<uint32_t>(a.sb));
  const uint32_t L = S + static_cast<uint32_t>(a.B) * g_slot;
  const uint32_t grad_block = L + ZB + static_cast<uint32_t>(a.sb);

  for (int t = 0; t < a.T; ++t) {
    const uint32_t step = a.step0 + static_cast<uint32_t>(t);
    SlotScalars ss{chain, step, a.key0, a.key1, make_uint4(0u, 0u, 0u, 0u),
                   -1};
    const bool is_g =
        a.shared ? a.coins[t] != 0 : ss.uniform(a.B + 2) < a.gf;
    bool moved = false;
    if (is_g) {
      const CandidateBlocks cb{chain, step,   a.key0, a.key1,
                               S,     g_sim,  g_slot, paired};
      moved = isir_global<Prog>(p, cb, a.B, ss, th, yv, logk);
    } else {
      // ---- MALA with the reverse-drift density
      float z[D], thp[D], gp[D], yp[Y], zr[D];
      Draws rz(chain, step, a.key0, a.key1, L);
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float n2;
        rz.normal_pair(&z[j], &n2);
      }
      const float log_fwd = std_normal_lp(z, a.c_norm);
#pragma unroll
      for (int j = 0; j < D; ++j)
        thp[j] = (th[j] + a.tau * z[j]) + gr[j] * a.half_tau2;
      sl_grad(a, chain, step, grad_block, thp, gp);
      Draws rs(chain, step, a.key0, a.key1, L + ZB);
      Prog::simulate(p, thp, rs, yp);
      const float lkp = Prog::log_kernel(p, yp);
#pragma unroll
      for (int j = 0; j < D; ++j)
        zr[j] = ((th[j] - thp[j]) - gp[j] * a.half_tau2) / a.tau;
      const float log_rev = std_normal_lp(zr, a.c_norm);
      const float log_acc =
          (((Prog::prior_diff_lp(p, thp, th) + lkp) + log_rev) - logk) -
          log_fwd;
      moved = logf(ss.uniform(a.B + 1)) < log_acc;
      if (moved) {
        copy(th, thp);
        copy(yv, yp);
        copy(gr, gp);
        logk = lkp;
      }
    }
    n_acc += moved ? 1.0f : 0.0f;
    n_gatt += is_g ? 1.0f : 0.0f;
    n_gacc += (is_g && moved) ? 1.0f : 0.0f;
    n_lacc += (!is_g && moved) ? 1.0f : 0.0f;
    if (a.collect) {
      float* h = a.hist + static_cast<size_t>(t) * D * C + c;
#pragma unroll
      for (int j = 0; j < D; ++j) h[j * C] = th[j];
    }
  }
#pragma unroll
  for (int j = 0; j < D; ++j) {
    a.theta_out[j * C + c] = th[j];
    a.grad_out[j * C + c] = gr[j];
  }
#pragma unroll
  for (int j = 0; j < Y; ++j) a.y_out[j * C + c] = yv[j];
  a.logk_out[c] = logk;
  a.acc[c] = n_acc;
  a.gatt[c] = n_gatt;
  a.gacc[c] = n_gacc;
  a.lacc[c] = n_lacc;
}

}  // namespace glabc

extern "C" int glabc_generic_glmala(
    const float* theta_in, const float* y_in, const float* logk_in,
    const float* grad_in, const float* params, const int* coins,
    float* theta_out, float* y_out, float* logk_out, float* grad_out,
    float* hist, float* acc, float* gatt, float* gacc, float* lacc, int d,
    int y_rows, int C, int T, int B, int n_grad, int collect, int shared,
    int global_blocks, int sim_blocks, int sim_paired, float gf, float tau,
    float half_tau2, float fd, float two_fd, float eps2, float c_norm,
    unsigned int key0, unsigned int key1, unsigned int step0, int threads,
    void* stream) {
  using namespace glabc;
  if (d != D || y_rows != Y || B < 1 || B > 64 || n_grad < 2 ||
      (shared && coins == nullptr))
    return -1;
  ProgMalaArgs a{theta_in,  y_in,     logk_in,  grad_in,  params,
                 coins,     theta_out, y_out,   logk_out, grad_out,
                 hist,      acc,      gatt,     gacc,     lacc,
                 C,         T,        B,        n_grad,   collect,
                 shared,    global_blocks, sim_blocks, sim_paired, gf,
                 tau,       half_tau2, fd,      two_fd,   eps2,
                 c_norm,    key0,     key1,     step0};
  const dim3 grid((C + threads - 1) / threads);
  generic_glmala_kernel<<<grid, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
