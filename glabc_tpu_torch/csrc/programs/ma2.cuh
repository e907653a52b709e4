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
// layout and is not carried over; no series is kept.  simulate_pair runs
// the recursion at two thetas on one draw of the innovations (K9's +-fd
// pair); both draw whole Philox blocks once the cursor is block-aligned.
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

  // One series of the recursion: y_t from e_t, e_{t-1}, e_{t-2} into the
  // running sums, in t order.
  struct Series {
    float y1 = 0.0f, y2 = 0.0f;        // y_{t-1}, y_{t-2}
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;

    __device__ void push(const float (&th)[D], float e, float e1, float e2) {
      const float yt = (e + th[0] * e1) + th[1] * e2;
      s0 = s0 + yt * yt;
      s1 = s1 + yt * y1;
      s2 = s2 + yt * y2;
      y2 = y1;
      y1 = yt;
    }

    __device__ void out(const float* p, float (&y)[Y]) const {
      y[0] = s0 * p[kInvT];
      y[1] = s1 * p[kInvT];
      y[2] = s2 * p[kInvT];
    }
  };

  // Innovations ea, eb (eb only when `second`) into every series.
  template <int N>
  __device__ static void push_pair(const float (&th)[N][D], Series (&s)[N],
                                   float ea, float eb, bool second,
                                   float& e1, float& e2) {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i].push(th[i], ea, e1, e2);
    e2 = e1;
    e1 = ea;
    if (second) {
#pragma unroll
      for (int i = 0; i < N; ++i) s[i].push(th[i], eb, e1, e2);
      e2 = e1;
      e1 = eb;
    }
  }

  // N series at N thetas on one cursor: each innovation is drawn once and
  // fed to every series, so each series is bitwise what simulate() gives
  // on its own cursor over the same blocks.  Once the cursor sits at a
  // block boundary, a whole block (two pairs, four steps) is drawn at a
  // time, without the cursor's per-uniform bookkeeping.
  template <int N>
  __device__ static void simulate_n(const float* p, const float (&th)[N][D],
                                    Draws& r, float (&y)[N][Y]) {
    const int T = static_cast<int>(p[kT]);
    float e2, e1;                      // e_{t-2}, e_{t-1}
    r.normal_pair(&e2, &e1);
    Series s[N];
    int t = 0;
    for (; t < T && r.lane != 4; t += 2) {   // up to a block boundary
      float ea, eb;
      r.normal_pair(&ea, &eb);
      push_pair<N>(th, s, ea, eb, t + 1 < T, e1, e2);
    }
    for (; t + 4 <= T; t += 4) {             // a whole block: two pairs
      const uint4 b = philox4x32_10(make_uint4(r.chain, r.step, r.block, 0u),
                                    r.k0, r.k1);
      ++r.block;
      float ea, eb, ec, ed;
      normal_pair(uniform_from_bits(b.x), uniform_from_bits(b.y), &ea, &eb);
      normal_pair(uniform_from_bits(b.z), uniform_from_bits(b.w), &ec, &ed);
      push_pair<N>(th, s, ea, eb, true, e1, e2);
      push_pair<N>(th, s, ec, ed, true, e1, e2);
    }
    for (; t < T; t += 2) {                  // the tail
      float ea, eb;
      r.normal_pair(&ea, &eb);
      push_pair<N>(th, s, ea, eb, t + 1 < T, e1, e2);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) s[i].out(p, y[i]);
  }

  __device__ static void simulate(const float* p, const float (&th)[D],
                                  Draws& r, float (&y)[Y]) {
    const float ths[1][D] = {{th[0], th[1]}};
    float ys[1][Y];
    simulate_n<1>(p, ths, r, ys);
#pragma unroll
    for (int j = 0; j < Y; ++j) y[j] = ys[0][j];
  }

  // The +fd and -fd simulations of a gradient replicate (common random
  // numbers): one pass, two recursions side by side.
  __device__ static void simulate_pair(const float* p, const float (&ta)[D],
                                       const float (&tb)[D], Draws& r,
                                       float (&ya)[Y], float (&yb)[Y]) {
    const float ths[2][D] = {{ta[0], ta[1]}, {tb[0], tb[1]}};
    float ys[2][Y];
    simulate_n<2>(p, ths, r, ys);
#pragma unroll
    for (int j = 0; j < Y; ++j) {
      ya[j] = ys[0][j];
      yb[j] = ys[1][j];
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
