// Fused pool-iSIR transitions (AGLMCMC at global_frequency = 1), one thread
// per chain, a loop over the launch's T steps.
//
// Replaces glabc_tpu/ops/pallas/pool_isir_kernel.py PoolISIR._kernel (K3).
// The plain torch version of the same arithmetic is
// glabc_tpu_torch/ops/kernels/pool_isir_kernel.py (draw_gumbels +
// run_plain); the float operations below are written in its order and the
// library is built with --fmad=false, so the two agree to the last bit.
//
// Step t of chain c reads pool slice t: B candidate thetas and their
// precomputed log-weights log pi + log K_eps - log q.  The current state's
// log-weight is carried.  A Gumbel-argmax over the B + 1 log-weights picks
// the next state (Gumbel slot B is the current state, the initial best; a
// strict > keeps the earlier slot on ties).  The kernel records the flat
// slot t*B + j of the last selected candidate (-1 if the chain never moved
// in this launch) and a move count; the sampler gathers y / log K from the
// same pool afterwards.
//
// What bounds it on an H100: per chain-transition at d=2, B=5 it reads
// B*d + B floats of pool and writes d floats of history, 68 bytes, against
// two Philox4x32-10 blocks and B+1 Gumbels (about 250 32-bit operations).
// At 3.35 TB/s the bytes allow ~4.9e10 transitions/s, the operations
// ~1.3e11: the kernel is bound by memory.  So its layout is the card's, not
// the TPU's: chains are the fastest axis of every array (pool theta
// (T, B, d, C), pool log w (T, B, C), state (d, C), history (T, d, C)), so
// consecutive threads load and store consecutive words, and nothing is
// padded (the TPU layout padded d and B to 8 rows: 192 bytes per
// chain-transition).  Every candidate's theta is loaded whether it wins or
// not, as the TPU kernel streams whole slices.
//
// Random numbers: counter (chain, step0 + t, block, 0), key (seed low,
// seed high); Gumbel slot s is lane s % 4 of block s / 4.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "philox.cuh"

namespace glabc {

struct PoolArgs {
  const float* pool_theta;
  const float* pool_logw;
  const float* theta_in;
  const float* logw_in;
  float* theta_out;
  float* logw_out;
  float* sel;
  float* moved;
  float* hist;
  int d, C, T, B, collect;
  uint32_t key0, key1, step0;
};

// D is a compile-time upper bound on d; loops run to D and test j < d, so
// every vector stays in registers.
template <int D>
__global__ void pool_isir_kernel(PoolArgs a) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= a.C) return;
  const int d = a.d;
  const size_t C = static_cast<size_t>(a.C);
  float th[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    if (j < d) th[j] = a.theta_in[j * C + c];
  }
  float logw = a.logw_in[c];
  float sel = -1.0f;
  float moved = 0.0f;
  const uint32_t chain = static_cast<uint32_t>(c);

  for (int t = 0; t < a.T; ++t) {
    const uint32_t step = a.step0 + static_cast<uint32_t>(t);
    const uint4 b0 = philox4x32_10(make_uint4(chain, step, 0u, 0u), a.key0,
                                   a.key1);
    const uint4 b1 = a.B + 1 > 4
                         ? philox4x32_10(make_uint4(chain, step, 1u, 0u),
                                         a.key0, a.key1)
                         : make_uint4(0u, 0u, 0u, 0u);
    const int sb = a.B;
    float best = logw + gumbel_from_uniform(uniform_from_bits(
                            lane_of(sb < 4 ? b0 : b1, sb & 3)));
    bool mv = false;
    for (int j = 0; j < a.B; ++j) {
      const size_t slot = static_cast<size_t>(t) * a.B + j;
      const float lw = a.pool_logw[slot * C + c];
      float cand[D];
#pragma unroll
      for (int f = 0; f < D; ++f) {
        if (f < d) cand[f] = a.pool_theta[(slot * d + f) * C + c];
      }
      const float score =
          lw + gumbel_from_uniform(uniform_from_bits(lane_of(j < 4 ? b0 : b1,
                                                             j & 3)));
      if (score > best) {
        best = score;
#pragma unroll
        for (int f = 0; f < D; ++f) {
          if (f < d) th[f] = cand[f];
        }
        logw = lw;
        sel = static_cast<float>(static_cast<int>(slot));
        mv = true;
      }
    }
    moved += mv ? 1.0f : 0.0f;
    if (a.collect) {
      float* h = a.hist + static_cast<size_t>(t) * d * C + c;
#pragma unroll
      for (int f = 0; f < D; ++f) {
        if (f < d) h[f * C] = th[f];
      }
    }
  }
#pragma unroll
  for (int f = 0; f < D; ++f) {
    if (f < d) a.theta_out[f * C + c] = th[f];
  }
  a.logw_out[c] = logw;
  a.sel[c] = sel;
  a.moved[c] = moved;
}

}  // namespace glabc

extern "C" int glabc_pool_isir(const float* pool_theta, const float* pool_logw,
                               const float* theta_in, const float* logw_in,
                               float* theta_out, float* logw_out, float* sel,
                               float* moved, float* hist, int d, int C, int T,
                               int B, int collect, unsigned int key0,
                               unsigned int key1, unsigned int step0,
                               int threads, void* stream) {
  using namespace glabc;
  if (d < 1 || d > 32 || B < 1 || B > 7) return -1;
  PoolArgs a{pool_theta, pool_logw, theta_in, logw_in, theta_out, logw_out,
             sel,        moved,     hist,     d,       C,         T,
             B,          collect,   key0,     key1,    step0};
  const dim3 grid((C + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 1) {
    pool_isir_kernel<1><<<grid, threads, 0, s>>>(a);
  } else if (d <= 2) {
    pool_isir_kernel<2><<<grid, threads, 0, s>>>(a);
  } else if (d <= 3) {
    pool_isir_kernel<3><<<grid, threads, 0, s>>>(a);
  } else if (d <= 4) {
    pool_isir_kernel<4><<<grid, threads, 0, s>>>(a);
  } else if (d <= 8) {
    pool_isir_kernel<8><<<grid, threads, 0, s>>>(a);
  } else if (d <= 16) {
    pool_isir_kernel<16><<<grid, threads, 0, s>>>(a);
  } else {
    pool_isir_kernel<32><<<grid, threads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
