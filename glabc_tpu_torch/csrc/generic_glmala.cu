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
// block range (common random numbers, where the TPU kernel re-seeds its
// generator with _GRAD_STRIDE), keeps running sums of the discrepancy and
// its square per sign, then
//   mu = s1 / n, var = (s2 - (n mu) mu) / (n - 1), s = var + eps^2,
//   log p = -log(s)/2 - ((mu/2) mu) / s,
//   grad_k = (log p(+) - log p(-)) / (2 fd) + prior_grad_k.
//
// Coins: shared (one host coin per step for every chain, read from `coins`;
// a global step skips the gradient batch, as the TPU kernel's lax.cond) or
// per_chain (scalar slot B+2).  A thread computes only the move it takes.
//
// What bounds it on an H100: one MA(2) local step at num_grad=100, d=2 runs
// d num_grad = 200 replicates, each two recursions over 102 innovations
// (26 Philox blocks, 51 Box-Muller pairs): about 1e6 operations
// (chip_smoke.py's ma2_step_ops), against 8 bytes of history, so it is
// bound by the instructions it issues.  The design:
//   * one pass per +-fd pair: the program's simulate_pair draws each
//     innovation once and runs the two recursions side by side (two
//     independent dependency chains in one thread), each bitwise what
//     simulate gives alone;
//   * the warp works through its local lanes' (chain, coordinate,
//     replicate) items 32 at a time with every lane, the discrepancies
//     staged in shared memory and added by the chain's own lane in
//     replicate order, so the sums are bitwise a per-thread loop's.  Where
//     the lanes disagree (the per-chain coin at gf=0.8: ~6 local lanes a
//     warp) the global lanes help instead of idling through 2 d num_grad
//     simulations; where all are local (the shared coin's local steps) it
//     does the per-thread loop's work, a little faster than that loop
//     (PERF.md).
//
// Layouts: theta, grad (D, C); y (Y, C); logk and the four counters (C,);
// history (T, D, C) when collected; coins (T,) int32 in shared mode.
//
// Random numbers per step, counter (chain0 + chain, step0 + t, block, 0):
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
  uint32_t chain0;  // the global index of chain 0 (a shard's offset)
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

__device__ __forceinline__ void sl_grad_from_sums(
    const ProgMalaArgs& a, const float (&th)[D], const float (&s1p)[D],
    const float (&s2p)[D], const float (&s1m)[D], const float (&s2m)[D],
    float (&g)[D]) {
  float pg[D];
  Prog::prior_grad(a.params, th, pg);
#pragma unroll
  for (int k = 0; k < D; ++k)
    g[k] = (sl_lp(a, s1p[k], s2p[k]) - sl_lp(a, s1m[k], s2m[k])) / a.two_fd +
           pg[k];
}

// theta' +- fd e_k
__device__ __forceinline__ void fd_pair(const ProgMalaArgs& a,
                                        const float* th, int k,
                                        float (&tp)[D], float (&tm)[D]) {
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float e = (j == k) ? a.fd : 0.0f;
    tp[j] = th[j] + e;
    tm[j] = th[j] - e;
  }
}

// One warp's staging: the local lanes' theta' by rank, their lanes, and one
// round's discrepancies (+fd, -fd), one per lane.
struct WarpStage {
  float th[32][D];
  int lane[32];
  float2 dis[32];
};

// grad log p_ABC at theta' of each of the warp's local lanes (`loc`;
// `mine`: this lane is one of them), by the whole warp: CRN central
// differences through the simulator, replicate r of coordinate k on blocks
// first + (r D + k) sb of the chain.  Item i = (rank q, coordinate k,
// replicate r), q-major then k then r, is lane i % 32's in round i / 32: it
// simulates the pair of chain q's replicate and stages the two
// discrepancies; then each local lane adds the items of its own range in
// replicate order, as one thread looping over its replicates would.  Every
// lane of the warp must call it.
__device__ void sl_grad(const ProgMalaArgs& a, WarpStage& ws,
                             unsigned loc, bool mine, uint32_t warp_first,
                             uint32_t step, uint32_t first,
                             const float (&th)[D], float (&g)[D]) {
  const float* p = a.params;
  const int lane = static_cast<int>(threadIdx.x & 31u);
  const int rank = __popc(loc & ((1u << lane) - 1u));
  if (mine) {
#pragma unroll
    for (int j = 0; j < D; ++j) ws.th[rank][j] = th[j];
    ws.lane[rank] = lane;
  }
  __syncwarp();
  const int N = a.n_grad;
  const int per = D * N;                       // items of one chain
  const int n_items = __popc(loc) * per;
  const int lo = rank * per;                  // a local lane's items
  const uint32_t sb = static_cast<uint32_t>(a.sb);
  float s1p[D], s2p[D], s1m[D], s2m[D];
#pragma unroll
  for (int k = 0; k < D; ++k)
    s1p[k] = 0.0f, s2p[k] = 0.0f, s1m[k] = 0.0f, s2m[k] = 0.0f;
  for (int i0 = 0; i0 < n_items; i0 += 32) {
    const int i = i0 + lane;
    if (i < n_items) {
      const int q = i / per;
      const int kr = i - q * per;
      const int k = kr / N;
      const int r = kr - k * N;
      float tp[D], tm[D];
      fd_pair(a, ws.th[q], k, tp, tm);
      const uint32_t blk =
          first + (static_cast<uint32_t>(r) * D + static_cast<uint32_t>(k)) *
                      sb;
      float yp[Y], ym[Y];
      Draws dr(warp_first + static_cast<uint32_t>(ws.lane[q]), step, a.key0,
               a.key1, blk);
      Prog::simulate_pair(p, tp, tm, dr, yp, ym);
      ws.dis[lane] =
          make_float2(Prog::discrepancy(p, yp), Prog::discrepancy(p, ym));
    }
    __syncwarp();
    if (mine) {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const int b1 = min(lo + (k + 1) * N, i0 + 32);
        for (int j = max(lo + k * N, i0); j < b1; ++j) {
          const float2 v = ws.dis[j - i0];
          s1p[k] = s1p[k] + v.x;
          s2p[k] = s2p[k] + v.x * v.x;
          s1m[k] = s1m[k] + v.y;
          s2m[k] = s2m[k] + v.y * v.y;
        }
      }
    }
    __syncwarp();
  }
  if (mine) sl_grad_from_sums(a, th, s1p, s2p, s1m, s2m, g);
}

__global__ void generic_glmala_kernel(ProgMalaArgs a) {
  extern __shared__ WarpStage stages[];
  WarpStage& ws = stages[threadIdx.x >> 5];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  // no early return: every lane of a warp takes part in its gradients
  const bool valid = c < a.C;
  // the global index of the warp's first chain
  const uint32_t warp_first =
      a.chain0 + static_cast<uint32_t>(c) - (threadIdx.x & 31u);
  const size_t C = static_cast<size_t>(a.C);
  const float* p = a.params;
  float th[D], yv[Y], gr[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    th[j] = valid ? a.theta_in[j * C + c] : 0.0f;
    gr[j] = valid ? a.grad_in[j * C + c] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < Y; ++j) yv[j] = valid ? a.y_in[j * C + c] : 0.0f;
  float logk = valid ? a.logk_in[c] : 0.0f;
  float n_acc = 0.0f, n_gatt = 0.0f, n_gacc = 0.0f, n_lacc = 0.0f;
  const uint32_t chain = a.chain0 + static_cast<uint32_t>(c);
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
        a.shared ? a.coins[t] != 0 : valid && ss.uniform(a.B + 2) < a.gf;
    const bool local = valid && !is_g;
    bool moved = false;
    if (valid && is_g) {
      const CandidateBlocks cb{chain, step,   a.key0, a.key1,
                               S,     g_sim,  g_slot, paired};
      moved = isir_global<Prog>(p, cb, a.B, ss, th, yv, logk);
    }
    const unsigned loc = __ballot_sync(0xffffffffu, local);
    if (loc != 0u) {
      // ---- MALA with the reverse-drift density
      float z[D], thp[D], gp[D];
      if (local) {
        Draws rz(chain, step, a.key0, a.key1, L);
#pragma unroll
        for (int j = 0; j < D; ++j) {
          float n2;
          rz.normal_pair(&z[j], &n2);
        }
#pragma unroll
        for (int j = 0; j < D; ++j)
          thp[j] = (th[j] + a.tau * z[j]) + gr[j] * a.half_tau2;
      }
      sl_grad(a, ws, loc, local, warp_first, step, grad_block, thp, gp);
      if (local) {
        float yp[Y], zr[D];
        const float log_fwd = std_normal_lp(z, a.c_norm);
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
    }
    if (!valid) continue;
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
  if (!valid) return;
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
    unsigned int key0, unsigned int key1, unsigned int step0,
    unsigned int chain0, int threads, void* stream) {
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
                 c_norm,    key0,     key1,     step0,    chain0};
  const dim3 grid((C + threads - 1) / threads);
  const size_t smem = static_cast<size_t>(threads / 32) * sizeof(WarpStage);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        generic_glmala_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  generic_glmala_kernel<<<grid, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
