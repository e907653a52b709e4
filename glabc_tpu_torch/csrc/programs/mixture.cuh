// The Mixture family as a tile program for the generic fused kernels:
// Gaussian prior N(loc, scale^2 I) and importance proposal N(ip_loc,
// ip_scale^2 I), simulator y = |theta| + sigma z, Euclidean discrepancy,
// Gaussian epsilon-kernel.  The device twin of
// glabc_tpu_torch/ops/kernels/program.py mixture_tile_program (JAX:
// glabc_tpu/ops/pallas/generic_kernel.py mixture_tile_program); every float
// operation is in the twin's order.  theta_dim is GLABC_MIXTURE_D (default 2).
//
// Random numbers: a proposal takes one Box-Muller pair per dim (its cos
// branch); a simulation on a paired cursor re-reads those pairs and takes
// the sin branch (the pairing JAX makes through tl._mix_noise), on its own
// cursor the cos branch of fresh pairs.
//
// Parameters (program.py's order): c_kern, eps^2, q2, q1, q0, prior_loc,
// 0.5/prior_scale^2, ip_loc, ip_scale, lp_scale, sigma, c_prior,
// prior_scale, prior_scale^2, y_obs[D].

#pragma once
#include "../philox.cuh"

#ifndef GLABC_MIXTURE_D
#define GLABC_MIXTURE_D 2
#endif

namespace glabc {

struct Program {
  static constexpr int D = GLABC_MIXTURE_D;
  static constexpr int Y = GLABC_MIXTURE_D;
  enum { kCKern, kEps2, kQ2, kQ1, kQ0, kLoc, kHalfInvPs2, kIpLoc, kIpScale,
         kLp, kSigma, kCPrior, kScale, kPs2, kYObs };

  __device__ static void sample_global(const float* p, Draws& r,
                                       float (&th)[D]) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float n1, n2;
      r.normal_pair(&n1, &n2);
      th[j] = p[kIpLoc] + p[kIpScale] * n1;
    }
  }

  __device__ static void simulate(const float* p, const float (&th)[D],
                                  Draws& r, float (&y)[Y]) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float n1, n2;
      r.normal_pair(&n1, &n2);
      y[j] = fabsf(th[j]) + p[kSigma] * (r.paired ? n2 : n1);
    }
  }

  // Two simulations on one cursor (K9's +-fd pair): the noise is drawn once,
  // and each y is bitwise what simulate() gives on its own cursor.
  __device__ static void simulate_pair(const float* p, const float (&ta)[D],
                                       const float (&tb)[D], Draws& r,
                                       float (&ya)[Y], float (&yb)[Y]) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float n1, n2;
      r.normal_pair(&n1, &n2);
      const float e = p[kSigma] * (r.paired ? n2 : n1);
      ya[j] = fabsf(ta[j]) + e;
      yb[j] = fabsf(tb[j]) + e;
    }
  }

  __device__ static float dis2(const float* p, const float (&y)[Y]) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < Y; ++j) {
      const float diff = y[j] - p[kYObs + j];
      const float sq = diff * diff;
      s = (j == 0) ? sq : s + sq;
    }
    return s;
  }

  __device__ static float log_kernel(const float* p, const float (&y)[Y]) {
    return p[kCKern] - (0.5f * dis2(p, y)) / p[kEps2];
  }

  __device__ static float discrepancy(const float* p, const float (&y)[Y]) {
    return sqrtf(dis2(p, y));
  }

  __device__ static float prior_minus_global_lp(const float* p,
                                                const float (&th)[D]) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const float v = (p[kQ2] * th[j] + p[kQ1]) * th[j] + p[kQ0];
      s = (j == 0) ? v : s + v;
    }
    return s;
  }

  __device__ static float prior_diff_lp(const float* p, const float (&a)[D],
                                        const float (&b)[D]) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const float za = a[j] - p[kLoc], zb = b[j] - p[kLoc];
      const float v = (zb * zb - za * za) * p[kHalfInvPs2];
      s = (j == 0) ? v : s + v;
    }
    return s;
  }

  __device__ static void sample_local(const float* p, const float (&th)[D],
                                      Draws& r, float (&out)[D]) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float n1, n2;
      r.normal_pair(&n1, &n2);
      out[j] = th[j] + p[kLp] * n1;
    }
  }

  __device__ static float prior_lp(const float* p, const float (&th)[D]) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const float z = (th[j] - p[kLoc]) / p[kScale];
      const float v = p[kCPrior] - (0.5f * z) * z;
      s = (j == 0) ? v : s + v;
    }
    return s;
  }

  __device__ static void prior_grad(const float* p, const float (&th)[D],
                                    float (&g)[D]) {
#pragma unroll
    for (int j = 0; j < D; ++j) g[j] = (-(th[j] - p[kLoc])) / p[kPs2];
  }
};

}  // namespace glabc
