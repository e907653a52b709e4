// The global move of the generic kernels, as templates over a tile program
// `P` (csrc/programs/*.cuh): generic_glmala.cu (K9) runs isir_global whole;
// generic_glmcmc.cu (K8) folds the same scores, in the same order, into its
// loop of candidate rounds.  The torch twin is ops/kernels/generic_kernel.py's
// global_candidate and isir_global; the float operations are in its order.
//
// Candidate b of a step draws sample_global from block first + b * slot and
// its simulation from first + b * slot + sim (sim = 0 when the program's
// simulator re-reads its proposal's blocks), counter (chain, step, block, 0).

#pragma once
#ifndef GLABC_GENERIC_MOVES_CUH
#define GLABC_GENERIC_MOVES_CUH
#include <cstdint>

#include "philox.cuh"

namespace glabc {

template <int N>
__device__ __forceinline__ void copy(float (&dst)[N], const float (&src)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) dst[j] = src[j];
}

// Where a step's global candidates draw: candidate b from first + b * slot,
// its simulation `sim` blocks further on.
struct CandidateBlocks {
  uint32_t chain, step, k0, k1, first, sim, slot;
  bool paired;
};

// Candidate b: theta from sample_global, its dataset, and its log
// epsilon-kernel value (returned).
template <class P>
__device__ __forceinline__ float global_candidate(const float* p,
                                                  const CandidateBlocks& cb,
                                                  int b, float (&cth)[P::D],
                                                  float (&cy)[P::Y]) {
  const uint32_t first = cb.first + static_cast<uint32_t>(b) * cb.slot;
  Draws rg(cb.chain, cb.step, cb.k0, cb.k1, first);
  P::sample_global(p, rg, cth);
  Draws rs(cb.chain, cb.step, cb.k0, cb.k1, first + cb.sim, cb.paired);
  P::simulate(p, cth, rs, cy);
  return P::log_kernel(p, cy);
}

// iSIR as a streaming Gumbel-argmax over the current state (log w =
// prior_minus_global_lp + log K, Gumbel slot 0) and B candidates (slots
// 1..B); strict > keeps the earlier.  The winner replaces (th, yv, logk);
// returns whether a candidate won.
template <class P>
__device__ __forceinline__ bool isir_global(const float* p,
                                            const CandidateBlocks& cb, int B,
                                            SlotScalars& ss,
                                            float (&th)[P::D],
                                            float (&yv)[P::Y], float& logk) {
  float best = (P::prior_minus_global_lp(p, th) + logk) +
               gumbel_from_uniform(ss.uniform(0));
  bool moved = false;
  for (int b = 0; b < B; ++b) {
    float cth[P::D], cy[P::Y];
    const float lkp = global_candidate<P>(p, cb, b, cth, cy);
    const float score = (P::prior_minus_global_lp(p, cth) + lkp) +
                        gumbel_from_uniform(ss.uniform(b + 1));
    if (score > best) {
      best = score;
      copy(th, cth);
      copy(yv, cy);
      logk = lkp;
      moved = true;
    }
  }
  return moved;
}

}  // namespace glabc

#endif  // GLABC_GENERIC_MOVES_CUH
