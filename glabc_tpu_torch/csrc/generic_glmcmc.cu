// Generic fused GLMCMC / GlobalMCMC transitions over a tile program, one
// thread per chain, a loop over the launch's T steps.
//
// Replaces glabc_tpu/ops/pallas/generic_kernel.py GenericFusedGLMCMC._kernel
// (K8).  The program is a device struct `Program` (csrc/programs/*.cuh)
// pre-included by the build (_build.py, -DGLABC_PROGRAM); its torch twin and
// this kernel's plain version are glabc_tpu_torch/ops/kernels/program.py and
// generic_kernel.py, with every float operation in the same order (built
// with --fmad=false, so the two agree to the last bit up to the
// transcendental functions).
//
// A step flips the chain's coin first and computes only the move it picks
// (the TPU kernel computes both and masks one): every draw is keyed by its
// own block range, so a skipped move shifts nothing.
//   global, 'glmcmc': iSIR as a streaming Gumbel-argmax over the current
//     state (log w = prior_minus_global_lp + log K) and B candidates from
//     sample_global, each simulated once; strict > keeps the earlier (the
//     fold of generic_moves.cuh's isir_global, which K9 runs);
//   global, 'global': independence MH with one candidate;
//   local: random-walk MH, sample_local + simulate, log alpha =
//     prior_diff_lp(theta', theta) + log K' - log K.
// Out-of-support log densities are -1e30 (a -inf would make NaN in the
// argmax).
//
// What bounds it on an H100: the simulator.  MA(2) at num_draws=100 runs
// 102 innovations per simulation: 26 Philox4x32-10 blocks (80 integer
// operations each), 51 Box-Muller pairs (log, sqrt, sin, cos) and ~10
// operations of recursion and sums per innovation, about 3,600 operations,
// against 8 bytes of history per chain-step.  So the kernel is bound by
// operations; the state stays in registers for the whole launch, nothing is
// staged, and every load and store is coalesced (chains are the fastest
// axis).  A warp whose lanes hold both moves (nearly every warp at gf=0.9)
// would run B global simulations and then the local one in turn; instead
// one loop of candidate rounds serves both: in round r a global lane draws
// candidate r (sample_global), a local lane its random-walk proposal in
// round 0 (sample_local) and sits out the rest, and then every active lane
// runs the one Prog::simulate + Prog::log_kernel on its own cursor.  Such a
// warp runs B simulations a step, an all-local warp one.  The algorithm is
// a template parameter, so a round carries no code of the other.
// chip_smoke.py measures what the warps still pay (its divergence line).
//
// Layouts: theta (D, C), y (Y, C), logk and the four counters (C,), history
// (T, D, C) when collected; params the program's float vector.
//
// Random numbers per step, counter (chain0 + chain, step0 + t, block, 0):
//   blocks [0, S): scalar slot s is lane s%4 of block s/4; glmcmc: Gumbel 0
//       (current state), 1..B (candidates), B+1 the local accept uniform,
//       B+2 the coin; global: 0 the local accept, 1 the coin, 2 the global
//       accept;
//   candidate b: sample_global's cursor at S + b*G, its simulation's at
//       S + b*G + (paired ? 0 : gb), G = max(gb, offset + sb);
//   the local move: sample_local at S + Bp*G, its simulation at
//       S + Bp*G + (paired ? 0 : lb)   (Bp = B for glmcmc, 1 for global).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "generic_moves.cuh"
#include "philox.cuh"

#ifndef GLABC_PROGRAM
#error "generic_glmcmc.cu is built with a program header (_build.py)"
#endif

namespace glabc {

struct GenericArgs {
  const float* theta_in;
  const float* y_in;
  const float* logk_in;
  const float* params;
  float* theta_out;
  float* y_out;
  float* logk_out;
  float* hist;
  float* acc;
  float* gatt;
  float* gacc;
  float* lacc;
  int C, T, collect, glmcmc, B, gb, sb, lb, paired;
  float gf;
  uint32_t key0, key1, step0;
  uint32_t chain0;  // the global index of chain 0 (a shard's offset)
};

using Prog = Program;
constexpr int D = Prog::D;
constexpr int Y = Prog::Y;

template <bool GLMCMC>
__global__ void generic_glmcmc_kernel(GenericArgs a) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= a.C) return;
  const size_t C = static_cast<size_t>(a.C);
  const float* p = a.params;
  float th[D], yv[Y];
#pragma unroll
  for (int j = 0; j < D; ++j) th[j] = a.theta_in[j * C + c];
#pragma unroll
  for (int j = 0; j < Y; ++j) yv[j] = a.y_in[j * C + c];
  float logk = a.logk_in[c];
  float n_acc = 0.0f, n_gatt = 0.0f, n_gacc = 0.0f, n_lacc = 0.0f;
  const uint32_t chain = a.chain0 + static_cast<uint32_t>(c);
  const bool paired = a.paired != 0;
  const int Bp = GLMCMC ? a.B : 1;
  const int n_scalar = GLMCMC ? a.B + 3 : 3;
  const uint32_t S = static_cast<uint32_t>((n_scalar + 3) / 4);
  const uint32_t g_sim = paired ? 0u : static_cast<uint32_t>(a.gb);
  const uint32_t g_slot = max(static_cast<uint32_t>(a.gb),
                              g_sim + static_cast<uint32_t>(a.sb));
  const uint32_t l_sim = paired ? 0u : static_cast<uint32_t>(a.lb);
  const uint32_t local_block = S + static_cast<uint32_t>(Bp) * g_slot;
  const int s_local = GLMCMC ? a.B + 1 : 0;
  const int s_coin = GLMCMC ? a.B + 2 : 1;

  for (int t = 0; t < a.T; ++t) {
    const uint32_t step = a.step0 + static_cast<uint32_t>(t);
    SlotScalars ss{chain, step, a.key0, a.key1, make_uint4(0u, 0u, 0u, 0u),
                   -1};
    const bool is_g = ss.uniform(s_coin) < a.gf;
    float best = 0.0f;
    if (GLMCMC && is_g)
      best = (Prog::prior_minus_global_lp(p, th) + logk) +
             gumbel_from_uniform(ss.uniform(0));
    const int rounds = is_g ? Bp : 1;
    bool moved = false;
    // the candidate rounds, one loop for both moves: only the proposal
    // differs, the simulation is the same code for every lane
    for (int r = 0; r < rounds; ++r) {
      float cth[D], cy[Y];
      const uint32_t first =
          is_g ? S + static_cast<uint32_t>(r) * g_slot : local_block;
      Draws rp(chain, step, a.key0, a.key1, first);
      if (is_g)
        Prog::sample_global(p, rp, cth);
      else
        Prog::sample_local(p, th, rp, cth);
      Draws rs(chain, step, a.key0, a.key1, first + (is_g ? g_sim : l_sim),
               paired);
      Prog::simulate(p, cth, rs, cy);
      const float lk = Prog::log_kernel(p, cy);
      bool take;
      if (!is_g) {                     // random-walk MH
        take = logf(ss.uniform(s_local)) <
               (Prog::prior_diff_lp(p, cth, th) + lk) - logk;
      } else if constexpr (GLMCMC) {   // iSIR
        const float score = (Prog::prior_minus_global_lp(p, cth) + lk) +
                            gumbel_from_uniform(ss.uniform(r + 1));
        take = score > best;
        if (take) best = score;
      } else {                         // independence MH
        const float la = ((Prog::prior_minus_global_lp(p, cth) + lk) -
                          Prog::prior_minus_global_lp(p, th)) -
                         logk;
        take = logf(ss.uniform(2)) < la;
      }
      if (take) {
        copy(th, cth);
        copy(yv, cy);
        logk = lk;
        moved = true;
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
  for (int j = 0; j < D; ++j) a.theta_out[j * C + c] = th[j];
#pragma unroll
  for (int j = 0; j < Y; ++j) a.y_out[j * C + c] = yv[j];
  a.logk_out[c] = logk;
  a.acc[c] = n_acc;
  a.gatt[c] = n_gatt;
  a.gacc[c] = n_gacc;
  a.lacc[c] = n_lacc;
}

}  // namespace glabc

extern "C" int glabc_generic_glmcmc(
    const float* theta_in, const float* y_in, const float* logk_in,
    const float* params, float* theta_out, float* y_out, float* logk_out,
    float* hist, float* acc, float* gatt, float* gacc, float* lacc, int d,
    int y_rows, int C, int T, int collect, int glmcmc, int B,
    int global_blocks, int sim_blocks, int local_blocks, int sim_paired,
    float gf, unsigned int key0, unsigned int key1, unsigned int step0,
    unsigned int chain0, int threads, void* stream) {
  using namespace glabc;
  if (d != D || y_rows != Y || B < 1 || B > 64) return -1;
  GenericArgs a{theta_in, y_in,  logk_in, params,       theta_out,
                y_out,    logk_out, hist, acc,          gatt,
                gacc,     lacc,  C,       T,            collect,
                glmcmc,   B,     global_blocks, sim_blocks, local_blocks,
                sim_paired, gf,  key0,    key1,         step0,
                chain0};
  const dim3 grid((C + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (glmcmc)
    generic_glmcmc_kernel<true><<<grid, threads, 0, s>>>(a);
  else
    generic_glmcmc_kernel<false><<<grid, threads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
