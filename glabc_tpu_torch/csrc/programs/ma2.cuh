// MA(2) time-series ABC as a tile program for the generic fused kernels.
// The device twin of glabc_tpu_torch/ops/kernels/program.py ma2_tile_program
// (JAX: glabc_tpu/ops/pallas/generic_kernel.py ma2_tile_program); every
// float operation is in the twin's order.
//
// The simulator is a scalar recursion in registers: pair i of the cursor
// gives innovations 2i (cos) and 2i+1 (sin) of e_{-2}, e_{-1}, e_0, ...;
// y_t = (e_t + th1 e_{t-1}) + th2 e_{t-2} with y_{-1} = y_{-2} = 0, the sums
// s0 += y_t y_t, s1 += y_t y_{t-1}, s2 += y_t y_{t-2} in t order, then times
// 1/T.  JAX's 8-row block/roll form of the same recursion is TPU sublane
// layout and is not carried over; no series is kept.
//
// Prior: uniform on the triangle (-2, 1), (2, 1), (0, -1); global proposal:
// uniform on the box [-2, 2] x [-1, 1], one uniform per dim; local move:
// theta + lp_scale z, one Box-Muller pair per dim (its cos branch).
// Out-of-support log densities are -1e30, not -inf.
//
// Parameters (program.py's order): c_kern, eps^2, lp_scale, 1/T, T,
// y_obs[3].

#pragma once
#include "../philox.cuh"

namespace glabc {

struct Program {
  static constexpr int D = 2;
  static constexpr int Y = 3;
  enum { kCKern, kEps2, kLp, kInvT, kT, kYObs };
  static constexpr float kNeg = -1.0e30f;
  static constexpr float kLogPMinusQ = 0.6931471824645996f;   // log 2
  static constexpr float kLogPrior = -1.3862943649291992f;    // log 1/4

  __device__ static bool inside(const float (&th)[D]) {
    return (th[1] < 1.0f) && (th[1] > th[0] - 1.0f) && (th[1] > -th[0] - 1.0f);
  }

  __device__ static void sample_global(const float*, Draws& r,
                                       float (&th)[D]) {
    const float u0 = r.uniform();
    const float u1 = r.uniform();
    th[0] = -2.0f + 4.0f * u0;
    th[1] = -1.0f + 2.0f * u1;
  }

  __device__ static void simulate(const float* p, const float (&th)[D],
                                  Draws& r, float (&y)[Y]) {
    const int T = static_cast<int>(p[kT]);
    float e2, e1;                      // e_{t-2}, e_{t-1}
    r.normal_pair(&e2, &e1);
    float y1 = 0.0f, y2 = 0.0f;        // y_{t-1}, y_{t-2}
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
    for (int t = 0; t < T; t += 2) {
      float ea, eb;
      r.normal_pair(&ea, &eb);
      float yt = (ea + th[0] * e1) + th[1] * e2;
      s0 = s0 + yt * yt;
      s1 = s1 + yt * y1;
      s2 = s2 + yt * y2;
      e2 = e1;
      e1 = ea;
      y2 = y1;
      y1 = yt;
      if (t + 1 < T) {
        yt = (eb + th[0] * e1) + th[1] * e2;
        s0 = s0 + yt * yt;
        s1 = s1 + yt * y1;
        s2 = s2 + yt * y2;
        e2 = e1;
        e1 = eb;
        y2 = y1;
        y1 = yt;
      }
    }
    y[0] = s0 * p[kInvT];
    y[1] = s1 * p[kInvT];
    y[2] = s2 * p[kInvT];
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

  __device__ static float prior_minus_global_lp(const float*,
                                                const float (&th)[D]) {
    return inside(th) ? float(kLogPMinusQ) : float(kNeg);
  }

  // b is the current state, always inside the support
  __device__ static float prior_diff_lp(const float*, const float (&a)[D],
                                        const float (&)[D]) {
    return inside(a) ? 0.0f : float(kNeg);
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

  __device__ static float prior_lp(const float*, const float (&th)[D]) {
    return inside(th) ? float(kLogPrior) : float(kNeg);
  }

  // flat inside the triangle (the JAX program's th * 0.0)
  __device__ static void prior_grad(const float*, const float (&)[D],
                                    float (&g)[D]) {
#pragma unroll
    for (int j = 0; j < D; ++j) g[j] = 0.0f;
  }
};

}  // namespace glabc
