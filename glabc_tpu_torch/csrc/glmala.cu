// Fused Mixture-family GLMALA transitions: W chains a warp (W in {32, 16, 8,
// 4}), every lane of the warp working on their moves, a loop over the
// launch's T steps.
//
// Replaces glabc_tpu/ops/pallas/glmala_kernel.py PackedMixtureGLMALA._kernel
// (K6).  The plain torch version of the same arithmetic is
// glabc_tpu_torch/ops/kernels/glmala_kernel.py (draw_mala_noise +
// mala_transition); every float operation below is written in its order and
// the library is built with --fmad=false, so the two agree to the last bit
// up to the transcendental functions.
//
// A step is iSIR (global: B candidates from N(ip_loc, ip_scale^2 I),
// simulated once each, Gumbel-argmax against the current state; the cached
// gradient stays stale, GLMALA.py:183-199) or MALA (local: theta' = theta +
// tau z + grad tau^2/2, the synthetic-likelihood gradient at theta', MH with
// the reverse drift; an accepted move carries its gradient).  The gradient is
// the TPU kernel's CRN estimator: replicate r draws one simulator-noise vector
// sigma z_r in R^d that serves both signs and all d perturbed coordinates;
// per sign and coordinate the kernel keeps running sums of the discrepancy
// and of its square over the num_grad replicates, then
//   var = (s2 - n mu^2) / (n - 1),  log p = -log(var + eps^2)/2
//         - mu^2 / (2 (var + eps^2)),
//   grad_k = (log p(+fd e_k) - log p(-fd e_k)) / (2 fd) - (theta_k - loc)/s^2.
//
// Coins: shared (one host coin per step for every chain, read from `coins`,
// so a global step skips the gradient batch as the TPU kernel's lax.cond
// does) or per_chain (scalar slot B+2).  Every draw is keyed by counter, so a
// chain computes only the move it takes: no other draw shifts.
//
// What bounds it on an H100: a local step at d=2, num_grad=100 runs 50
// Philox blocks and 50 Box-Muller pairs for the replicates and 2 * 2 * 100
// discrepancies (each d subtract-square-adds and a sqrt): about 1.1e4 32-bit
// operations against 8 bytes of history, so the kernel is bound by
// operations, and in fact by the instructions it issues: the accurate
// sqrtf, logf and sincosf take several each.  A launch whose every coin
// is local runs at the same speed at 1, 2 or 4 warps a scheduler (PERF.md),
// so a shared coin's steps gain nothing from more warps.  One thread per
// chain did waste the per-chain coin: every warp with a local lane ran the
// whole gradient in every lane, ~26 of 32 lanes idle.  So:
// - lane l of a warp serves chain q = l % W of the warp's W chains; lane q
//   (helper 0) owns the chain's state, the other 32/W - 1 helpers hold none;
//   the wrapper takes W from the chain count and the coin mode;
// - the step's scalar Philox blocks are dealt over a chain's helpers (block
//   k to helper k % (32/W), passed to the other helpers by shuffles), so
//   each is computed once and every lane of the chain reads every slot;
// - the global move's B candidates are dealt over a chain's helpers
//   (candidate b to helper b % (32/W)); each keeps its first best score with
//   a strict > from -inf, and an xor butterfly over the helpers takes the
//   largest score, the lower candidate on ties: the first index of the
//   maximum.  The owner moves iff it beats the current state's score.  That
//   is the in-order strict-> fold from the current state: the fold ends on
//   the first maximum when it beats the start, else on the start;
// - the gradient of the warp's local chains (a ballot) is dealt over all 32
//   lanes: item i = (rank i % n, replicate pair i / n) of the n local
//   chains, 32 items a round; each item draws its pair's Philox blocks and
//   Box-Muller pairs and stages the 2 * 2d discrepancies of its two
//   replicates in shared memory; then every running sum (chain, sign,
//   coordinate) is added by one lane over the round's items of its chain in
//   replicate order, so each sum is bitwise the per-thread loop's; the sums
//   go to the owner through shared memory.  A warp with no local chain
//   skips the gradient;
// - W = 32 (a lane a chain, no helpers) has a kernel of its own,
//   glmala_thread_kernel: the straight-line step of one thread a chain,
//   with no shuffle, ballot or staging, each lane adding its own chain's
//   replicates in order.  A shared coin's steps run it at the main shape.
// No result depends on W or the block size.
//
// Layouts: theta, y, grad (d, C); logk and the four counters (C,); history
// (T, d, C) when collected; coins (T,) int32 in shared mode.
//
// Random numbers per step, counter (chain0 + chain, step0 + t, block, 0):
//   blocks [0, S), S = ceil((B+3)/4): scalar slot s is lane s%4 of block s/4:
//       Gumbel 0 (current state), 1..B (candidates), B+1 the local accept
//       uniform, B+2 the per-chain coin;
//   blocks S + b*P + j/2, P = ceil(d/2): candidate b, dim j; lanes
//       (2(j%2), 2(j%2)+1) one Box-Muller pair -> (proposal, simulator);
//   blocks S + B*P + j/2: the local move's (z, z_sim) for dim j;
//   blocks S + (B+1)*P + i*P + j/2: gradient replicates 2i (cos branch) and
//       2i+1 (sin branch), dim j.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "philox.cuh"

namespace glabc {

struct MalaArgs {
  const float* theta_in;
  const float* y_in;
  const float* logk_in;
  const float* grad_in;
  const float* y_obs;
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
  int C, T, B, n_grad, collect, shared;
  float prior_loc, inv_prior_scale, c_prior, ps2;
  float ip_loc, ip_scale, inv_ip_scale, c_ip;
  float sigma, c_kern, a_kern, gf;
  float tau, half_tau2, fd, two_fd, eps2, c_norm;
  uint32_t key0, key1, step0;
  uint32_t chain0;  // the global index of chain 0 (a shard's offset)
  int lanes;  // chains a warp, W
};

// The Box-Muller pairs of dims 0..D-1 from blocks first + j/2.
template <int D>
__device__ __forceinline__ void normal_pairs(const MalaArgs& a, uint32_t chain,
                                             uint32_t step, uint32_t first,
                                             float (&n1)[D], float (&n2)[D]) {
  uint4 blk = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    if ((j & 1) == 0) {
      blk = philox4x32_10(
          make_uint4(chain, step, first + static_cast<uint32_t>(j >> 1), 0u),
          a.key0, a.key1);
    }
    normal_pair(uniform_from_bits((j & 1) ? blk.z : blk.x),
                uniform_from_bits((j & 1) ? blk.w : blk.y), &n1[j], &n2[j]);
  }
}

// sum_j (c - 0.5 * z_j^2), z = (th - loc) * (1 / scale), left to right
template <int D>
__device__ __forceinline__ float gauss_lp(const float (&th)[D], float loc,
                                          float inv_scale, float c) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float z = (th[j] - loc) * inv_scale;
    const float per = c - 0.5f * (z * z);
    s = (j == 0) ? per : s + per;
  }
  return s;
}

template <int D>
__device__ __forceinline__ float std_normal_lp(const float (&z)[D], float c) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float per = c - 0.5f * (z[j] * z[j]);
    s = (j == 0) ? per : s + per;
  }
  return s;
}

template <int D>
__device__ __forceinline__ float kern_lp(const MalaArgs& a,
                                         const float (&yv)[D],
                                         const float (&yo)[D]) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float diff = yv[j] - yo[j];
    const float sq = diff * diff;
    s = (j == 0) ? sq : s + sq;
  }
  return a.c_kern - s * a.a_kern;
}

__device__ __forceinline__ float sl_lp(const MalaArgs& a, float s1, float s2) {
  const float n = static_cast<float>(a.n_grad);
  const float mu = s1 / n;
  const float var = (s2 - (n * mu) * mu) / static_cast<float>(a.n_grad - 1);
  const float s = var + a.eps2;
  return -0.5f * logf(s) - ((0.5f * mu) * mu) / s;
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxScalar = 3;  // scalar blocks a step: ceil((7 + 3) / 4)

// The step's scalar blocks 0..S-1 (S = ceil((B + 3) / 4)) of chain `chain`
// in every lane that serves it: block k is fetched by its helper k % G
// (where `fetch`) and passed to the chain's other helpers by shuffles.
// Every lane of the warp must call it.
__device__ __forceinline__ void scalar_blocks(const MalaArgs& a, bool fetch,
                                              uint32_t chain, uint32_t step,
                                              int q, int h, int W, int G,
                                              uint4 (&sc)[kMaxScalar]) {
  const int S = (a.B + 6) / 4;
  uint4 mine[kMaxScalar];
#pragma unroll
  for (int m = 0; m < kMaxScalar; ++m) {
    const int k = m * G + h;
    mine[m] = make_uint4(0u, 0u, 0u, 0u);
    if (fetch && k < S)
      mine[m] = philox4x32_10(
          make_uint4(chain, step, static_cast<uint32_t>(k), 0u), a.key0,
          a.key1);
  }
#pragma unroll
  for (int k = 0; k < kMaxScalar; ++k) {
    if (k >= S) break;
    const int m = k / G;
    const uint4 v = m == 0 ? mine[0] : (m == 1 ? mine[1] : mine[2]);
    const int src = q + W * (k % G);
    sc[k] = make_uint4(__shfl_sync(kFull, v.x, src),
                       __shfl_sync(kFull, v.y, src),
                       __shfl_sync(kFull, v.z, src),
                       __shfl_sync(kFull, v.w, src));
  }
}

// The uniform of scalar slot s from the step's scalar blocks.
__device__ __forceinline__ float slot_uniform(const uint4 (&sc)[kMaxScalar],
                                              int s) {
  const int k = s >> 2;
  return uniform_from_bits(
      lane_of(k == 0 ? sc[0] : (k == 1 ? sc[1] : sc[2]), s & 3));
}

// One warp's staging for the gradient: theta' and the chain index of its
// local chains by rank, and one round's discrepancies, dis[item][replicate]
// [sign * D + k] (sign 0: +fd, 1: -fd); after the last round, the running
// sums (s1, s2) of rank q, sign and coordinate at sums[q * 2D + sign * D + k].
template <int D>
struct MalaStage {
  float th[32][D];
  uint32_t chain[32];
  union __align__(8) {
    float dis[32][2][2 * D];
    float2 sums[32 * 2 * D];
  };
};

// The discrepancies |theta' +- fd e_k| + zr - y_obs of one replicate, for
// every sign and coordinate, into out[sign * D + k].
template <int D>
__device__ __forceinline__ void discrepancies(const float (&ap)[D][D],
                                              const float (&am)[D][D],
                                              const float (&yo)[D],
                                              const float (&zr)[D],
                                              float* out) {
#pragma unroll
  for (int k = 0; k < D; ++k) {
    float sp = 0.0f, sm = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const float dp = (ap[k][j] + zr[j]) - yo[j];
      const float dm = (am[k][j] + zr[j]) - yo[j];
      const float qp = dp * dp, qm = dm * dm;
      sp = (j == 0) ? qp : sp + qp;
      sm = (j == 0) ? qm : sm + qm;
    }
    out[k] = sqrtf(sp);
    out[D + k] = sqrtf(sm);
  }
}

// grad log p_ABC at theta' (`th`) of one chain, by its own thread: the
// replicates' discrepancies added in order, sum s = sign * D + k.
template <int D>
__device__ __forceinline__ void sl_grad_thread(const MalaArgs& a,
                                               uint32_t chain, uint32_t step,
                                               uint32_t first,
                                               const float (&th)[D],
                                               const float (&yo)[D],
                                               float (&g)[D]) {
  constexpr uint32_t P = (D + 1) / 2;
  float ap[D][D], am[D][D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      ap[k][j] = fabsf(th[j] + (j == k ? a.fd : 0.0f));
      am[k][j] = fabsf(th[j] - (j == k ? a.fd : 0.0f));
    }
  }
  float s1[2 * D], s2[2 * D];
#pragma unroll
  for (int m = 0; m < 2 * D; ++m) s1[m] = 0.0f, s2[m] = 0.0f;
  const int whole = a.n_grad / 2;
  for (int p = 0; p < (a.n_grad + 1) / 2; ++p) {
    float za[D], zb[D], dv[2 * D];
    normal_pairs<D>(a, chain, step, first + static_cast<uint32_t>(p) * P, za,
                    zb);
#pragma unroll
    for (int j = 0; j < D; ++j) za[j] = a.sigma * za[j];
    discrepancies<D>(ap, am, yo, za, dv);
#pragma unroll
    for (int m = 0; m < 2 * D; ++m)
      s1[m] = s1[m] + dv[m], s2[m] = s2[m] + dv[m] * dv[m];
    if (p < whole) {
#pragma unroll
      for (int j = 0; j < D; ++j) zb[j] = a.sigma * zb[j];
      discrepancies<D>(ap, am, yo, zb, dv);
#pragma unroll
      for (int m = 0; m < 2 * D; ++m)
        s1[m] = s1[m] + dv[m], s2[m] = s2[m] + dv[m] * dv[m];
    }
  }
#pragma unroll
  for (int k = 0; k < D; ++k)
    g[k] = (sl_lp(a, s1[k], s2[k]) - sl_lp(a, s1[D + k], s2[D + k])) /
               a.two_fd +
           (-(th[k] - a.prior_loc)) / a.ps2;
}

// grad log p_ABC at theta' (`th`) of each of the warp's local chains
// (`loc`, bits at their owner lanes, at most 16; `mine`: this lane owns
// one), by the whole warp; the result lands in the owner's `g`.  Every lane
// of the warp must call it.
template <int D>
__device__ void sl_grad(const MalaArgs& a, MalaStage<D>& ws, unsigned loc,
                        bool mine, uint32_t chain, uint32_t step,
                        uint32_t first, const float (&th)[D],
                        const float (&yo)[D], float (&g)[D]) {
  constexpr uint32_t P = (D + 1) / 2;
  const int lane = static_cast<int>(threadIdx.x & 31u);
  const int rank = __popc(loc & ((1u << lane) - 1u));
  const int n = __popc(loc);
  const int whole = a.n_grad / 2;  // pairs with both replicates
  const int n_items = n * ((a.n_grad + 1) / 2);
  const int n_sums = n * 2 * D;
  float s1[2 * D], s2[2 * D];  // sums lane + 32 m, m = 0, 1, ...
#pragma unroll
  for (int m = 0; m < 2 * D; ++m) s1[m] = 0.0f, s2[m] = 0.0f;
  if (mine) {
#pragma unroll
    for (int j = 0; j < D; ++j) ws.th[rank][j] = th[j];
    ws.chain[rank] = chain;
  }
  __syncwarp();
  // this lane's item i0 + lane = p n + q, and the round's first i0 = p0 n +
  // r0, both stepped by 32 = dp n + dq without a division in the loop
  int q = lane % n, p = lane / n, p0 = 0, r0 = 0;
  const int dq = 32 % n, dp = 32 / n;
  for (int i0 = 0; i0 < n_items; i0 += 32) {
    if (i0 + lane < n_items) {
      float ap[D][D], am[D][D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
#pragma unroll
        for (int j = 0; j < D; ++j) {
          ap[k][j] = fabsf(ws.th[q][j] + (j == k ? a.fd : 0.0f));
          am[k][j] = fabsf(ws.th[q][j] - (j == k ? a.fd : 0.0f));
        }
      }
      float za[D], zb[D];
      normal_pairs<D>(a, ws.chain[q], step,
                      first + static_cast<uint32_t>(p) * P, za, zb);
#pragma unroll
      for (int j = 0; j < D; ++j) za[j] = a.sigma * za[j];
      discrepancies<D>(ap, am, yo, za, ws.dis[lane][0]);
      if (p < whole) {
#pragma unroll
        for (int j = 0; j < D; ++j) zb[j] = a.sigma * zb[j];
        discrepancies<D>(ap, am, yo, zb, ws.dis[lane][1]);
      }
    }
    __syncwarp();
    const int i_end = min(i0 + 32, n_items);
#pragma unroll
    for (int m = 0; m < 2 * D; ++m) {
      const int sg = lane + 32 * m;
      if (sg < n_sums) {
        const int qs = sg / (2 * D), s = sg - qs * 2 * D;
        // the round's items of rank qs, pair pj, in replicate order
        int pj = p0 + (qs < r0 ? 1 : 0);
        for (int j = pj * n + qs; j < i_end; j += n, ++pj) {
          const float va = ws.dis[j - i0][0][s];
          s1[m] = s1[m] + va;
          s2[m] = s2[m] + va * va;
          if (pj < whole) {
            const float vb = ws.dis[j - i0][1][s];
            s1[m] = s1[m] + vb;
            s2[m] = s2[m] + vb * vb;
          }
        }
      }
    }
    __syncwarp();
    q += dq, p += dp, r0 += dq, p0 += dp;
    if (q >= n) q -= n, ++p;
    if (r0 >= n) r0 -= n, ++p0;
  }
#pragma unroll
  for (int m = 0; m < 2 * D; ++m) {
    const int sg = lane + 32 * m;
    if (sg < n_sums) ws.sums[sg] = make_float2(s1[m], s2[m]);
  }
  __syncwarp();
  if (mine) {
    const float2* sm = ws.sums + rank * 2 * D;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      g[k] = (sl_lp(a, sm[k].x, sm[k].y) -
              sl_lp(a, sm[D + k].x, sm[D + k].y)) /
                 a.two_fd +
             (-(th[k] - a.prior_loc)) / a.ps2;
    }
  }
  __syncwarp();
}

// W = 32: one thread a chain.  No lane waits on another, so a lane past C
// returns at once; the global move folds its candidates in order from the
// current state's score, and the scalar slots are drawn as they are read.
template <int D>
__device__ __forceinline__ void thread_chain(const MalaArgs& a) {
  const int c = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (c >= a.C) return;
  const size_t C = static_cast<size_t>(a.C);
  float th[D], yv[D], gr[D], yo[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    th[j] = a.theta_in[j * C + c];
    yv[j] = a.y_in[j * C + c];
    gr[j] = a.grad_in[j * C + c];
    yo[j] = a.y_obs[j];
  }
  float logk = a.logk_in[c];
  float n_acc = 0.0f, n_gatt = 0.0f, n_gacc = 0.0f, n_lacc = 0.0f;
  const uint32_t chain = a.chain0 + static_cast<uint32_t>(c);
  constexpr uint32_t P = (D + 1) / 2;
  const uint32_t S = static_cast<uint32_t>((a.B + 3 + 3) / 4);
  const uint32_t local_block = S + static_cast<uint32_t>(a.B) * P;
  const uint32_t grad_block = local_block + P;

  for (int t = 0; t < a.T; ++t) {
    const uint32_t step = a.step0 + static_cast<uint32_t>(t);
    SlotScalars ss{chain, step, a.key0, a.key1, make_uint4(0u, 0u, 0u, 0u),
                   -1};
    const bool is_g =
        a.shared ? a.coins[t] != 0 : ss.uniform(a.B + 2) < a.gf;
    const float lp_theta = gauss_lp<D>(th, a.prior_loc, a.inv_prior_scale,
                                       a.c_prior);
    bool moved = false;
    if (is_g) {
      // ---- iSIR: the in-order fold from the current state, strict >
      float best = ((lp_theta + logk) -
                    gauss_lp<D>(th, a.ip_loc, a.inv_ip_scale, a.c_ip)) +
                   gumbel_from_uniform(ss.uniform(0));
      for (int b = 0; b < a.B; ++b) {
        float n1[D], n2[D], cth[D], cy[D];
        normal_pairs<D>(a, chain, step, S + static_cast<uint32_t>(b) * P, n1,
                        n2);
#pragma unroll
        for (int j = 0; j < D; ++j) {
          cth[j] = a.ip_loc + a.ip_scale * n1[j];
          cy[j] = fabsf(cth[j]) + a.sigma * n2[j];
        }
        const float lkp = kern_lp<D>(a, cy, yo);
        const float score =
            ((gauss_lp<D>(cth, a.prior_loc, a.inv_prior_scale, a.c_prior) +
              lkp) -
             gauss_lp<D>(cth, a.ip_loc, a.inv_ip_scale, a.c_ip)) +
            gumbel_from_uniform(ss.uniform(b + 1));
        if (score > best) {
          best = score;
#pragma unroll
          for (int j = 0; j < D; ++j) {
            th[j] = cth[j];
            yv[j] = cy[j];
          }
          logk = lkp;
          moved = true;
        }
      }
    } else {
      // ---- MALA with the reverse-drift density
      float z[D], zs[D], thp[D], gp[D], yp[D], zr[D];
      normal_pairs<D>(a, chain, step, local_block, z, zs);
      const float log_fwd = std_normal_lp<D>(z, a.c_norm);
#pragma unroll
      for (int j = 0; j < D; ++j)
        thp[j] = ((z[j] * a.tau) + th[j]) + gr[j] * a.half_tau2;
      sl_grad_thread<D>(a, chain, step, grad_block, thp, yo, gp);
#pragma unroll
      for (int j = 0; j < D; ++j) {
        yp[j] = fabsf(thp[j]) + a.sigma * zs[j];
        zr[j] = ((th[j] - thp[j]) - gp[j] * a.half_tau2) / a.tau;
      }
      const float lkp = kern_lp<D>(a, yp, yo);
      const float log_rev = std_normal_lp<D>(zr, a.c_norm);
      const float log_acc =
          ((((gauss_lp<D>(thp, a.prior_loc, a.inv_prior_scale, a.c_prior) +
              lkp) +
             log_rev) -
            lp_theta) -
           logk) -
          log_fwd;
      moved = logf(ss.uniform(a.B + 1)) < log_acc;
      if (moved) {
#pragma unroll
        for (int j = 0; j < D; ++j) {
          th[j] = thp[j];
          yv[j] = yp[j];
          gr[j] = gp[j];
        }
        logk = lkp;
      }
    }
    n_acc += moved ? 1.0f : 0.0f;
    n_gatt += is_g ? 1.0f : 0.0f;
    n_gacc += (is_g && moved) ? 1.0f : 0.0f;
    n_lacc += (!is_g && moved) ? 1.0f : 0.0f;
    if (a.collect) {
      float* hst = a.hist + static_cast<size_t>(t) * D * C + c;
#pragma unroll
      for (int j = 0; j < D; ++j) hst[j * C] = th[j];
    }
  }
#pragma unroll
  for (int j = 0; j < D; ++j) {
    a.theta_out[j * C + c] = th[j];
    a.y_out[j * C + c] = yv[j];
    a.grad_out[j * C + c] = gr[j];
  }
  a.logk_out[c] = logk;
  a.acc[c] = n_acc;
  a.gatt[c] = n_gatt;
  a.gacc[c] = n_gacc;
  a.lacc[c] = n_lacc;
}

// Blocks of up to 256 threads.  No launch bounds: under
// __launch_bounds__(256) ptxas allocates the step's registers otherwise
// (d = 2: 107 against 95) and it runs 1-2 % slower (PERF.md).
template <int D>
__global__ void glmala_thread_kernel(MalaArgs a) {
  thread_chain<D>(a);
}

template <int D>
__global__ void __launch_bounds__(1024)
    glmala_thread_kernel_1024(MalaArgs a) {
  thread_chain<D>(a);
}

// W in {16, 8, 4}: 32 / W lanes a chain, the warp dealing the work.
template <int D, int MaxThreads>
__global__ void __launch_bounds__(MaxThreads) glmala_kernel(MalaArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MalaStage<D>& ws =
      reinterpret_cast<MalaStage<D>*>(smem_raw)[threadIdx.x >> 5];
  const int lane = static_cast<int>(threadIdx.x & 31u);
  const int W = a.lanes, G = 32 / a.lanes;
  const int q = lane & (W - 1);      // the chain this lane serves
  const int h = lane / W;            // its helper index; 0 owns the state
  const int warp =
      static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int c = warp * W + q;
  // no early return: every lane of a warp takes part in its shuffles
  const bool valid = c < a.C;
  const bool own = valid && h == 0;
  const size_t C = static_cast<size_t>(a.C);
  float th[D], yv[D], gr[D], yo[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    th[j] = own ? a.theta_in[j * C + c] : 0.0f;
    yv[j] = own ? a.y_in[j * C + c] : 0.0f;
    gr[j] = own ? a.grad_in[j * C + c] : 0.0f;
    yo[j] = a.y_obs[j];
  }
  float logk = own ? a.logk_in[c] : 0.0f;
  float n_acc = 0.0f, n_gatt = 0.0f, n_gacc = 0.0f, n_lacc = 0.0f;
  const uint32_t chain = a.chain0 + static_cast<uint32_t>(c);
  constexpr uint32_t P = (D + 1) / 2;
  const uint32_t S = static_cast<uint32_t>((a.B + 3 + 3) / 4);
  const uint32_t local_block = S + static_cast<uint32_t>(a.B) * P;
  const uint32_t grad_block = local_block + P;

  for (int t = 0; t < a.T; ++t) {
    const uint32_t step = a.step0 + static_cast<uint32_t>(t);
    uint4 sc[kMaxScalar];
    scalar_blocks(a, valid, chain, step, q, h, W, G, sc);
    const bool is_g =
        a.shared ? a.coins[t] != 0 : slot_uniform(sc, a.B + 2) < a.gf;
    const float lp_theta = gauss_lp<D>(th, a.prior_loc, a.inv_prior_scale,
                                       a.c_prior);
    bool moved = false;
    const bool g_lane = valid && is_g;
    if (__any_sync(kFull, g_lane)) {
      // ---- iSIR: candidate b on helper b % G, first best by strict >
      float best = -INFINITY, cth[D], cy[D], clk = 0.0f;
      int jb = a.B;
#pragma unroll
      for (int j = 0; j < D; ++j) cth[j] = cy[j] = 0.0f;
      if (g_lane) {
        for (int b = h; b < a.B; b += G) {
          float n1[D], n2[D], pth[D], py[D];
          normal_pairs<D>(a, chain, step, S + static_cast<uint32_t>(b) * P,
                          n1, n2);
#pragma unroll
          for (int j = 0; j < D; ++j) {
            pth[j] = a.ip_loc + a.ip_scale * n1[j];
            py[j] = fabsf(pth[j]) + a.sigma * n2[j];
          }
          const float lkp = kern_lp<D>(a, py, yo);
          const float score =
              ((gauss_lp<D>(pth, a.prior_loc, a.inv_prior_scale, a.c_prior) +
                lkp) -
               gauss_lp<D>(pth, a.ip_loc, a.inv_ip_scale, a.c_ip)) +
              gumbel_from_uniform(slot_uniform(sc, b + 1));
          if (score > best) {
            best = score;
            jb = b;
#pragma unroll
            for (int j = 0; j < D; ++j) {
              cth[j] = pth[j];
              cy[j] = py[j];
            }
            clk = lkp;
          }
        }
      }
      // the first index of the maximum over the chain's helpers
      for (int off = W; off < 32; off <<= 1) {
        const float ob = __shfl_xor_sync(kFull, best, off);
        const int oj = __shfl_xor_sync(kFull, jb, off);
        if (ob > best || (ob == best && oj < jb)) {
          best = ob;
          jb = oj;
        }
      }
      const int src = q + W * (jb % G);
#pragma unroll
      for (int j = 0; j < D; ++j) {
        cth[j] = __shfl_sync(kFull, cth[j], src);
        cy[j] = __shfl_sync(kFull, cy[j], src);
      }
      clk = __shfl_sync(kFull, clk, src);
      const float cur =
          ((lp_theta + logk) -
           gauss_lp<D>(th, a.ip_loc, a.inv_ip_scale, a.c_ip)) +
          gumbel_from_uniform(slot_uniform(sc, 0));
      if (own && is_g && best > cur) {
#pragma unroll
        for (int j = 0; j < D; ++j) {
          th[j] = cth[j];
          yv[j] = cy[j];
        }
        logk = clk;
        moved = true;
      }
    }
    const bool l_own = own && !is_g;
    const unsigned loc = __ballot_sync(kFull, l_own);
    if (loc != 0u) {
      // ---- MALA with the reverse-drift density
      float z[D], zs[D], thp[D], gp[D];
      if (l_own) {
        normal_pairs<D>(a, chain, step, local_block, z, zs);
#pragma unroll
        for (int j = 0; j < D; ++j)
          thp[j] = ((z[j] * a.tau) + th[j]) + gr[j] * a.half_tau2;
      }
      sl_grad<D>(a, ws, loc, l_own, chain, step, grad_block, thp, yo, gp);
      if (l_own) {
        float yp[D], zr[D];
        const float log_fwd = std_normal_lp<D>(z, a.c_norm);
#pragma unroll
        for (int j = 0; j < D; ++j) {
          yp[j] = fabsf(thp[j]) + a.sigma * zs[j];
          zr[j] = ((th[j] - thp[j]) - gp[j] * a.half_tau2) / a.tau;
        }
        const float lkp = kern_lp<D>(a, yp, yo);
        const float log_rev = std_normal_lp<D>(zr, a.c_norm);
        const float log_acc =
            ((((gauss_lp<D>(thp, a.prior_loc, a.inv_prior_scale, a.c_prior) +
                lkp) +
               log_rev) -
              lp_theta) -
             logk) -
            log_fwd;
        moved = logf(slot_uniform(sc, a.B + 1)) < log_acc;
        if (moved) {
#pragma unroll
          for (int j = 0; j < D; ++j) {
            th[j] = thp[j];
            yv[j] = yp[j];
            gr[j] = gp[j];
          }
          logk = lkp;
        }
      }
    }
    if (!own) continue;
    n_acc += moved ? 1.0f : 0.0f;
    n_gatt += is_g ? 1.0f : 0.0f;
    n_gacc += (is_g && moved) ? 1.0f : 0.0f;
    n_lacc += (!is_g && moved) ? 1.0f : 0.0f;
    if (a.collect) {
      float* hst = a.hist + static_cast<size_t>(t) * D * C + c;
#pragma unroll
      for (int j = 0; j < D; ++j) hst[j * C] = th[j];
    }
  }
  if (!own) return;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    a.theta_out[j * C + c] = th[j];
    a.y_out[j * C + c] = yv[j];
    a.grad_out[j * C + c] = gr[j];
  }
  a.logk_out[c] = logk;
  a.acc[c] = n_acc;
  a.gatt[c] = n_gatt;
  a.gacc[c] = n_gacc;
  a.lacc[c] = n_lacc;
}

template <int D, int MaxThreads>
int launch_at(const MalaArgs& a, int threads, cudaStream_t s) {
  const long long warps = (a.C + a.lanes - 1) / a.lanes;
  const dim3 grid(static_cast<unsigned>((warps * 32 + threads - 1) / threads));
  if (a.lanes == 32) {
    if (MaxThreads <= 256)
      glmala_thread_kernel<D><<<grid, threads, 0, s>>>(a);
    else
      glmala_thread_kernel_1024<D><<<grid, threads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  auto kernel = glmala_kernel<D, MaxThreads>;
  const size_t smem = static_cast<size_t>(threads / 32) * sizeof(MalaStage<D>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const MalaArgs& a, int threads, cudaStream_t s) {
  if (threads <= 256) return launch_at<D, 256>(a, threads, s);
  return launch_at<D, 1024>(a, threads, s);
}

}  // namespace glabc

extern "C" int glabc_glmala(
    const float* theta_in, const float* y_in, const float* logk_in,
    const float* grad_in, const float* y_obs, const int* coins,
    float* theta_out, float* y_out, float* logk_out, float* grad_out,
    float* hist, float* acc, float* gatt, float* gacc, float* lacc, int d,
    int C, int T, int B, int n_grad, int collect, int shared, float prior_loc,
    float inv_prior_scale, float c_prior, float ps2, float ip_loc,
    float ip_scale, float inv_ip_scale, float c_ip, float sigma, float c_kern,
    float a_kern, float gf, float tau, float half_tau2, float fd, float two_fd,
    float eps2, float c_norm, unsigned int key0, unsigned int key1,
    unsigned int step0, unsigned int chain0, int threads, int lanes,
    void* stream) {
  using namespace glabc;
  if (B < 1 || B > 7 || n_grad < 2 || (shared && coins == nullptr) ||
      threads < 32 || threads > 1024 || threads % 32 ||
      (lanes != 32 && lanes != 16 && lanes != 8 && lanes != 4))
    return -1;
  if (C == 0) return 0;
  MalaArgs a{theta_in, y_in,  logk_in, grad_in, y_obs,   coins,
             theta_out, y_out, logk_out, grad_out, hist, acc,
             gatt,      gacc,  lacc,    C,        T,      B,
             n_grad,    collect, shared, prior_loc, inv_prior_scale, c_prior,
             ps2,       ip_loc, ip_scale, inv_ip_scale, c_ip, sigma,
             c_kern,    a_kern, gf,     tau,      half_tau2, fd,
             two_fd,    eps2,  c_norm,  key0,     key1,   step0,
             chain0,    lanes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch<1>(a, threads, s);
    case 2: return launch<2>(a, threads, s);
    case 4: return launch<4>(a, threads, s);
    case 8: return launch<8>(a, threads, s);
    default: return -1;
  }
}
