// Fused pool-iSIR transitions (AGLMCMC at global_frequency = 1): 32 chains a
// block, each chunk of the launch's T steps in a parallel phase over
// (step, chain) and a short serial phase per chain.
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
// What bounds it on an H100: per chain-step at d=2, B=5 the function needs
// the B log-weights (20 bytes), the winner's d floats on a step that moves
// and d floats of history (8 bytes), against two Philox4x32-10 blocks and
// B+1 Gumbels (about 250 32-bit operations and 12 logarithms): bound by
// memory at ~28 bytes a chain-step.  One thread per chain read every
// candidate's theta (68 bytes) at under two warps a scheduler.  Nothing but
// the final comparison depends on the chain's state, so a chunk of TC steps
// runs in phases, each separated by a barrier:
//   A. every warp of the block takes steps of the chunk (lane = chain, so
//      the log-weight loads coalesce): its Philox blocks, the Gumbels, and
//      the candidates' scores lw_j + g_j folded from -inf with a strict >
//      into the first index j* of their maximum M, with lw_{j*}; staged in
//      shared memory beside g_B;
//   B. warp 0, one lane a chain, runs the chunk's steps in order: the chain
//      moves iff M > logw + g_B, then carries logw = lw_{j*}, sel = t B + j*
//      and the move count.  This is the in-order strict-> fold from the
//      current state: that fold ends on the first index of the maximum when
//      the maximum beats the start, else on the start (-inf and NaN
//      log-weights never win either way);
//   C. the winner's d floats of each step that moved are read into shared
//      memory, and every warp writes the chunk's history from them (the
//      state after step t is the winner of the chunk's last move at or
//      before t, else the state at the chunk's start), coalesced over the
//      block's 32 chains.
// The block's size (its warps) comes from the chain count (the wrapper's
// choice); no result depends on it.
//
// D is a compile-time bound on d up to 32, one instantiation each.  Above
// d = 32 (up to 128) one runtime-d instantiation (D = 0) takes the launch:
// the winners' thetas and the chunk's start state, which grow with d, move
// from static to dynamic shared memory ((TC + 1) d 32 floats, 80 KB at
// d = 128), with TC = 4 steps a chunk; every float operation is the one of
// the static instantiations, so it is bit for bit the plain version too.
//
// Layout: chains are the fastest axis of every array: pool theta
// (T, B, d, C), pool log w (T, B, C), state (d, C), history (T, d, C).
// Random numbers: counter (chain0 + chain, step0 + t, block, 0), key (seed low,
// seed high); Gumbel slot s is lane s % 4 of block s / 4.

#include <cuda_runtime.h>

#include <cmath>
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
  uint32_t key0, key1, step0, chain0;  // chain0: a shard's first global chain
};

constexpr int kMaxB = 7;  // candidates a step
constexpr int kMaxD = 128;
constexpr int kWideD = 32;  // the largest static instantiation

// Steps a chunk: shared memory for the winners' thetas stays at 16 KB
// (D = 0, the runtime-d variant: 4 steps, the thetas in dynamic memory).
template <int D>
__host__ __device__ constexpr int chunk_steps() {
  return D <= 0 ? 4 : (D <= 4 ? 32 : (D <= 8 ? 16 : (D <= 16 ? 8 : 4)));
}

// Dynamic shared memory of the runtime-d variant: s_th and s_carry.
inline size_t wide_smem(int d) {
  return static_cast<size_t>(chunk_steps<0>() + 1) * d * 32 * sizeof(float);
}

// D is a compile-time upper bound on d (0: d itself, above kWideD); the
// winners' thetas s_th[TC][D][32] and the carried state s_carry[D][32] are
// static for D > 0 and dynamic for D = 0.
template <int D, int MaxThreads>
__global__ void __launch_bounds__(MaxThreads) pool_isir_kernel(PoolArgs a) {
  constexpr int TC = chunk_steps<D>();
  __shared__ float s_max[TC][32];       // M: the candidates' best score
  __shared__ float s_gcur[TC][32];      // g_B: the current state's Gumbel
  __shared__ float s_lw[TC][32];        // lw_{j*}
  __shared__ signed char s_win[TC][32]; // j* (-1: none); after B, -1 unless
                                        // the chain moved at the step
  __shared__ signed char s_last[TC][32];  // the chunk's last move <= t
  __shared__ float s_th_fixed[D > 0 ? TC * D * 32 : 1];
  __shared__ float s_carry_fixed[D > 0 ? D * 32 : 1];
  extern __shared__ float s_dyn[];
  // the winners' thetas at moves, (TC, DW, 32), and the state at the
  // chunk's start, (DW, 32)
  const int DW = D > 0 ? D : a.d;
  float* const s_th = D > 0 ? s_th_fixed : s_dyn;
  float* const s_carry = D > 0 ? s_carry_fixed : s_dyn + TC * DW * 32;
  const int lane = static_cast<int>(threadIdx.x & 31u);
  const int warp = static_cast<int>(threadIdx.x >> 5);
  const int nw = static_cast<int>(blockDim.x >> 5);
  const int c = blockIdx.x * 32 + lane;
  const bool valid = c < a.C;
  const int d = a.d, B = a.B;
  const size_t C = static_cast<size_t>(a.C);
  const uint32_t chain = a.chain0 + static_cast<uint32_t>(c);
  for (int f = warp; f < d; f += nw)
    s_carry[f * 32 + lane] = valid ? a.theta_in[f * C + c] : 0.0f;
  float logw = (warp == 0 && valid) ? a.logw_in[c] : 0.0f;
  float sel = -1.0f, moved = 0.0f;
  __syncthreads();

  for (int t0 = 0; t0 < a.T; t0 += TC) {
    const int tn = min(TC, a.T - t0);
    // A: the candidates' first maximum, every (step, chain) at once
    if (valid) {
      for (int r = warp; r < tn; r += nw) {
        const int t = t0 + r;
        const uint32_t step = a.step0 + static_cast<uint32_t>(t);
        // the slice's log-weights first: their loads fly during the Philox
        float lw[kMaxB];
#pragma unroll
        for (int j = 0; j < kMaxB; ++j)
          if (j < B)
            lw[j] = a.pool_logw[(static_cast<size_t>(t) * B + j) * C + c];
        const uint4 b0 = philox4x32_10(make_uint4(chain, step, 0u, 0u),
                                       a.key0, a.key1);
        const uint4 b1 = B + 1 > 4
                             ? philox4x32_10(make_uint4(chain, step, 1u, 0u),
                                             a.key0, a.key1)
                             : make_uint4(0u, 0u, 0u, 0u);
        s_gcur[r][lane] = gumbel_from_uniform(
            uniform_from_bits(lane_of(B < 4 ? b0 : b1, B & 3)));
        float best = -INFINITY, lw_best = 0.0f;
        int jb = -1;
#pragma unroll
        for (int j = 0; j < kMaxB; ++j) {
          if (j < B) {
            const float score =
                lw[j] + gumbel_from_uniform(uniform_from_bits(
                            lane_of(j < 4 ? b0 : b1, j & 3)));
            if (score > best) {
              best = score;
              lw_best = lw[j];
              jb = j;
            }
          }
        }
        s_max[r][lane] = best;
        s_lw[r][lane] = lw_best;
        s_win[r][lane] = static_cast<signed char>(jb);
      }
    }
    __syncthreads();
    // B: the moves, in step order, one lane a chain
    if (warp == 0 && valid) {
      int last = -1;
      for (int r = 0; r < tn; ++r) {
        const bool mv = s_max[r][lane] > logw + s_gcur[r][lane];
        const int j = s_win[r][lane];
        if (mv) {
          logw = s_lw[r][lane];
          sel = static_cast<float>((t0 + r) * B + j);
          moved += 1.0f;
          last = r;
        }
        s_win[r][lane] = static_cast<signed char>(mv ? j : -1);
        s_last[r][lane] = static_cast<signed char>(last);
      }
    }
    __syncthreads();
    // C: the winners' thetas at the moves, then the history
    if (valid) {
      for (int i = warp; i < tn * d; i += nw) {
        const int r = i / d, f = i - r * d;
        const int j = s_win[r][lane];
        if (j >= 0)
          s_th[(r * DW + f) * 32 + lane] =
              a.pool_theta[((static_cast<size_t>(t0 + r) * B + j) * d + f) *
                               C + c];
      }
    }
    __syncthreads();
    if (valid && a.collect) {
      for (int i = warp; i < tn * d; i += nw) {
        const int r = i / d, f = i - r * d;
        const int l = s_last[r][lane];
        a.hist[(static_cast<size_t>(t0 + r) * d + f) * C + c] =
            l >= 0 ? s_th[(l * DW + f) * 32 + lane]
                   : s_carry[f * 32 + lane];
      }
    }
    __syncthreads();
    if (valid) {
      const int l = s_last[tn - 1][lane];
      for (int f = warp; f < d; f += nw)
        if (l >= 0) s_carry[f * 32 + lane] = s_th[(l * DW + f) * 32 + lane];
    }
    __syncthreads();
  }
  if (!valid) return;
  for (int f = warp; f < d; f += nw)
    a.theta_out[f * C + c] = s_carry[f * 32 + lane];
  if (warp == 0) {
    a.logw_out[c] = logw;
    a.sel[c] = sel;
    a.moved[c] = moved;
  }
}

template <int D, int MaxThreads>
int launch_at(const PoolArgs& a, int threads, cudaStream_t s) {
  const dim3 grid((a.C + 31) / 32);
  size_t smem = 0;
  if (D == 0) {
    smem = wide_smem(a.d);
    const cudaError_t e = cudaFuncSetAttribute(
        pool_isir_kernel<D, MaxThreads>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pool_isir_kernel<D, MaxThreads><<<grid, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const PoolArgs& a, int threads, cudaStream_t s) {
  return threads <= 256 ? launch_at<D, 256>(a, threads, s)
                        : launch_at<D, 1024>(a, threads, s);
}

}  // namespace glabc

extern "C" int glabc_pool_isir(const float* pool_theta, const float* pool_logw,
                               const float* theta_in, const float* logw_in,
                               float* theta_out, float* logw_out, float* sel,
                               float* moved, float* hist, int d, int C, int T,
                               int B, int collect, unsigned int key0,
                               unsigned int key1, unsigned int step0,
                               unsigned int chain0, int threads,
                               void* stream) {
  using namespace glabc;
  if (d < 1 || d > kMaxD || B < 1 || B > kMaxB || threads < 32 ||
      threads > 1024 || threads % 32)
    return -1;
  if (C == 0) return 0;
  PoolArgs a{pool_theta, pool_logw, theta_in, logw_in, theta_out, logw_out,
             sel,        moved,     hist,     d,       C,         T,
             B,          collect,   key0,     key1,    step0,
             chain0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 1) return launch<1>(a, threads, s);
  if (d <= 2) return launch<2>(a, threads, s);
  if (d <= 3) return launch<3>(a, threads, s);
  if (d <= 4) return launch<4>(a, threads, s);
  if (d <= 8) return launch<8>(a, threads, s);
  if (d <= 16) return launch<16>(a, threads, s);
  if (d <= kWideD) return launch<32>(a, threads, s);
  return launch<0>(a, threads, s);
}
