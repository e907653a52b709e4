// Fused Mixture-family GLMALA transitions, one thread per chain, a loop over
// the launch's T steps.
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
// thread computes only the move it takes: no other draw shifts.
//
// What bounds it on an H100: a local step at d=2, num_grad=100 runs 50
// Philox blocks and 50 Box-Muller pairs for the replicates and 2 * 2 * 100
// discrepancies (each d subtract-square-adds and a sqrt): about 2.4e4 32-bit
// operations against 8 bytes of history, so the kernel is bound by
// operations.  The state stays in registers for the whole launch; every
// store is coalesced (chains are the fastest axis).
//
// Layouts: theta, y, grad (d, C); logk and the four counters (C,); history
// (T, d, C) when collected; coins (T,) int32 in shared mode.
//
// Random numbers per step, counter (chain, step0 + t, block, 0):
//   blocks [0, S), S = ceil((B+3)/4): scalar slot s is lane s%4 of block s/4:
//       Gumbel 0 (current state), 1..B (candidates), B+1 the local accept
//       uniform, B+2 the per-chain coin;
//   blocks S + b*P + j/2, P = ceil(d/2): candidate b, dim j; lanes
//       (2(j%2), 2(j%2)+1) one Box-Muller pair -> (proposal, simulator);
//   blocks S + B*P + j/2: the local move's (z, z_sim) for dim j;
//   blocks S + (B+1)*P + i*P + j/2: gradient replicates 2i (cos branch) and
//       2i+1 (sin branch), dim j.

#include <cuda_runtime.h>

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
};

// Cached scalar block: scalar s is lane s%4 of block s/4.
struct Scalars {
  uint32_t chain, step, k0, k1;
  uint4 blk;
  int id;
  __device__ __forceinline__ float uniform(int s) {
    const int want = s >> 2;
    if (want != id) {
      blk = philox4x32_10(make_uint4(chain, step, static_cast<uint32_t>(want),
                                     0u),
                          k0, k1);
      id = want;
    }
    return uniform_from_bits(lane_of(blk, s & 3));
  }
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

// One replicate: the discrepancy of |theta +- fd e_k| + zr for every k,
// summed into the running sums of its sign and coordinate.
template <int D>
__device__ __forceinline__ void accumulate(const MalaArgs& a,
                                           const float (&ap)[D][D],
                                           const float (&am)[D][D],
                                           const float (&yo)[D],
                                           const float (&zr)[D],
                                           float (&s1p)[D], float (&s2p)[D],
                                           float (&s1m)[D], float (&s2m)[D]) {
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
    const float disp = sqrtf(sp), dism = sqrtf(sm);
    s1p[k] = s1p[k] + disp;
    s2p[k] = s2p[k] + disp * disp;
    s1m[k] = s1m[k] + dism;
    s2m[k] = s2m[k] + dism * dism;
  }
}

__device__ __forceinline__ float sl_lp(const MalaArgs& a, float s1, float s2) {
  const float n = static_cast<float>(a.n_grad);
  const float mu = s1 / n;
  const float var = (s2 - (n * mu) * mu) / static_cast<float>(a.n_grad - 1);
  const float s = var + a.eps2;
  return -0.5f * logf(s) - ((0.5f * mu) * mu) / s;
}

template <int D>
__device__ __forceinline__ void sl_grad(const MalaArgs& a, uint32_t chain,
                                        uint32_t step, uint32_t first,
                                        const float (&th)[D],
                                        const float (&yo)[D], float (&g)[D]) {
  float ap[D][D], am[D][D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      ap[k][j] = fabsf(th[j] + (j == k ? a.fd : 0.0f));
      am[k][j] = fabsf(th[j] - (j == k ? a.fd : 0.0f));
    }
  }
  float s1p[D], s2p[D], s1m[D], s2m[D];
#pragma unroll
  for (int k = 0; k < D; ++k) s1p[k] = s2p[k] = s1m[k] = s2m[k] = 0.0f;
  constexpr uint32_t P = (D + 1) / 2;
  const int pairs = (a.n_grad + 1) / 2;
  for (int i = 0; i < pairs; ++i) {
    float za[D], zb[D];
    normal_pairs<D>(a, chain, step, first + static_cast<uint32_t>(i) * P, za,
                    zb);
#pragma unroll
    for (int j = 0; j < D; ++j) za[j] = a.sigma * za[j];
    accumulate<D>(a, ap, am, yo, za, s1p, s2p, s1m, s2m);
    if (2 * i + 1 < a.n_grad) {
#pragma unroll
      for (int j = 0; j < D; ++j) zb[j] = a.sigma * zb[j];
      accumulate<D>(a, ap, am, yo, zb, s1p, s2p, s1m, s2m);
    }
  }
#pragma unroll
  for (int k = 0; k < D; ++k) {
    g[k] = (sl_lp(a, s1p[k], s2p[k]) - sl_lp(a, s1m[k], s2m[k])) / a.two_fd +
           (-(th[k] - a.prior_loc)) / a.ps2;
  }
}

template <int D>
__global__ void glmala_kernel(MalaArgs a) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
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
  const uint32_t chain = static_cast<uint32_t>(c);
  constexpr uint32_t P = (D + 1) / 2;
  const uint32_t S = static_cast<uint32_t>((a.B + 3 + 3) / 4);
  const uint32_t local_block = S + static_cast<uint32_t>(a.B) * P;
  const uint32_t grad_block = local_block + P;

  for (int t = 0; t < a.T; ++t) {
    const uint32_t step = a.step0 + static_cast<uint32_t>(t);
    Scalars ss{chain, step, a.key0, a.key1, make_uint4(0u, 0u, 0u, 0u), -1};
    const bool is_g =
        a.shared ? a.coins[t] != 0 : ss.uniform(a.B + 2) < a.gf;
    const float lp_theta = gauss_lp<D>(th, a.prior_loc, a.inv_prior_scale,
                                       a.c_prior);
    bool moved = false;
    if (is_g) {
      // ---- iSIR as a streaming Gumbel-argmax, strict > keeps ties
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
      sl_grad<D>(a, chain, step, grad_block, thp, yo, gp);
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
      float* h = a.hist + static_cast<size_t>(t) * D * C + c;
#pragma unroll
      for (int j = 0; j < D; ++j) h[j * C] = th[j];
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
    unsigned int step0, int threads, void* stream) {
  using namespace glabc;
  if (B < 1 || B > 7 || n_grad < 2 || (shared && coins == nullptr)) return -1;
  MalaArgs a{theta_in, y_in,  logk_in, grad_in, y_obs,   coins,
             theta_out, y_out, logk_out, grad_out, hist, acc,
             gatt,      gacc,  lacc,    C,        T,      B,
             n_grad,    collect, shared, prior_loc, inv_prior_scale, c_prior,
             ps2,       ip_loc, ip_scale, inv_ip_scale, c_ip, sigma,
             c_kern,    a_kern, gf,     tau,      half_tau2, fd,
             two_fd,    eps2,  c_norm,  key0,     key1,   step0};
  const dim3 grid((C + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: glmala_kernel<1><<<grid, threads, 0, s>>>(a); break;
    case 2: glmala_kernel<2><<<grid, threads, 0, s>>>(a); break;
    case 4: glmala_kernel<4><<<grid, threads, 0, s>>>(a); break;
    case 8: glmala_kernel<8><<<grid, threads, 0, s>>>(a); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
