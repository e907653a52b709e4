// Fused pool-iSIR + Mixture random-walk transitions (AGLMCMC at
// global_frequency < 1, shared adaptation), one thread per chain, a loop
// over the launch's T steps.
//
// Replaces glabc_tpu/ops/pallas/pool_isir_mixed_kernel.py
// PoolISIRMixed._kernel (K5), both of its local moves: the built-in
// Mixture-family move (BuiltinLocal) and a tile program's
// (ProgramLocal, pool_isir_mixed_kernel.py:213-226), one kernel template
// over the two.  The program build pre-includes the program's header
// (_build.py, -DGLABC_PROGRAM) and adds glabc_pool_isir_mixed_program; only
// the local move, the prior of the carried-state weight and the dataset
// rows (Y of them) change.  The plain torch version is
// glabc_tpu_torch/ops/kernels/pool_isir_mixed_kernel.py (draw_mixed_noise +
// mixed_transition, or program_transition); the float operations below are
// in its order and the library is built with --fmad=false, except the order
// of the sum in step 1.
//
// Per step, in the TPU kernel's order:
//   1. log q(theta) of the current state under the resident shared mixture
//      (S components: mu / h^2, pre, 1/h^2), a logsumexp over S: the max,
//      then the float32 sum of exp(sc - m), as the plain version computes
//      it.  The two sum in different orders, so they differ by float32
//      rounding of the sum: a chain whose iSIR decision sits at that
//      rounding can go either way;
//   2. logw_cur = prior(theta) + log K - log q;
//   3. iSIR over pool slice t by a Gumbel-argmax over B + 1 log-weights
//      (slot B is the current state; strict > keeps the earlier on ties),
//      carrying theta, y and log K of the winner;
//   4. the local move: built-in, theta + lp_scale z, y = |theta'| + sigma
//      z', the Gaussian epsilon-kernel, MH accept (the arithmetic of
//      mixture_glmcmc.cu's local branch); or the program's sample_local,
//      simulate, log_kernel and log alpha = prior_diff_lp + log K' - log K;
//   5. the coin u < gf, then the three counters and the history row.
//
// What bounds it on an H100: per chain-step the resident logsumexp needs S
// exponentials and S (d + 3) other operations (the affine term, the max,
// the subtraction, the add; the second pass repeats the affine term and
// adds 2 d + 1 more); the pool costs 2 B d + 2 B floats read and d
// written.  At S = 1024, d = 2, B = 5 that is 1024 exponentials against 68
// bytes: the kernel is bound by the special-function units' exponentials.
// So the mixture (S (d+1) + 2d floats, 12 KB at S = 1024) is staged in
// shared memory once per block, where all threads of a warp read the same
// word (a broadcast), and the chain's state stays in registers for the
// whole launch; chains are the fastest axis of every array, so pool loads
// and history stores coalesce.
//
// Random numbers: counter (chain, step0 + t, block, 0).  Scalar slots
// (lane s % 4 of block s / 4): Gumbels 0..B, u_local B+1, u_coin B+2; then
// blocks S_b + j/2 hold dim j's Box-Muller pair (lanes 2(j%2), 2(j%2)+1),
// S_b = ceil((B + 3) / 4), as in mixture_glmcmc.cu.  A program's local move
// draws sample_local from block S_b on and its simulation from
// S_b + (paired ? 0 : local_blocks).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "philox.cuh"

namespace glabc {

struct MixedArgs {
  const float* mu;       // (S, d)
  const float* pre;      // (S,)
  const float* inv2h;    // (d,)
  const float* y_obs;    // (d,), built-in move only
  const float* prog;     // the program's parameters, program move only
  const float* ptheta;   // (T, B, d, C)
  const float* px;       // (T, B, yd, C)
  const float* plogw;    // (T, B, C)
  const float* plogk;    // (T, B, C)
  const float* theta_in; // (d, C)
  const float* y_in;     // (yd, C)
  const float* logk_in;  // (C,)
  float* theta_out;
  float* y_out;
  float* logk_out;
  float* gatt;
  float* gacc;
  float* lacc;
  float* hist;           // (T, d, C)
  int d, yd, C, T, B, S, collect, local_blocks, paired;
  float prior_loc, inv_prior_scale, c_prior, lp_scale, sigma, c_kern, a_kern,
      gf;
  uint32_t key0, key1, step0;
};

struct Scalars {
  uint4 b[3];
  __device__ __forceinline__ float u(int s) const {
    return uniform_from_bits(lane_of(b[s >> 2], s & 3));
  }
};

template <int D>
__device__ __forceinline__ float prior_lp(const MixedArgs& a, const float* th,
                                          int d) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    if (j < d) {
      const float z = (th[j] - a.prior_loc) * a.inv_prior_scale;
      const float per = a.c_prior - 0.5f * (z * z);
      s = (j == 0) ? per : s + per;
    }
  }
  return s;
}

// The built-in Mixture-family move: prior N(loc, scale^2 I), theta + lp_scale
// z, y = |theta'| + sigma z', the Gaussian epsilon-kernel.
struct BuiltinLocal {
  template <int D>
  __device__ static float prior(const MixedArgs& a, const float (&th)[D],
                                int d) {
    return prior_lp<D>(a, th, d);
  }

  template <int D, int YD>
  __device__ static void move(const MixedArgs& a, const float* s_yobs,
                              uint32_t chain, uint32_t step, uint32_t first,
                              const float (&th)[D], float lp_theta,
                              float logk, float (&cth)[D], float (&cy)[YD],
                              float* lkl, float* la) {
    const int d = a.d;
    uint4 blk = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      if (j < d) {
        if ((j & 1) == 0) {
          blk = philox4x32_10(
              make_uint4(chain, step,
                         first + static_cast<uint32_t>(j >> 1), 0u),
              a.key0, a.key1);
        }
        const float u1 = uniform_from_bits((j & 1) ? blk.z : blk.x);
        const float u2 = uniform_from_bits((j & 1) ? blk.w : blk.y);
        float n1, n2;
        normal_pair(u1, u2, &n1, &n2);
        cth[j] = th[j] + a.lp_scale * n1;
        cy[j] = fabsf(cth[j]) + a.sigma * n2;
      }
    }
    float ssq = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      if (j < d) {
        const float diff = cy[j] - s_yobs[j];
        const float sq = diff * diff;
        ssq = (j == 0) ? sq : ssq + sq;
      }
    }
    *lkl = a.c_kern - ssq * a.a_kern;
    *la = ((prior_lp<D>(a, cth, d) + *lkl) - lp_theta) - logk;
  }
};

#ifdef GLABC_PROGRAM
// A tile program's move (the program's header is pre-included).
struct ProgramLocal {
  template <int D>
  __device__ static float prior(const MixedArgs& a, const float (&th)[D],
                                int) {
    return Program::prior_lp(a.prog, th);
  }

  template <int D, int YD>
  __device__ static void move(const MixedArgs& a, const float*,
                              uint32_t chain, uint32_t step, uint32_t first,
                              const float (&th)[D], float, float logk,
                              float (&cth)[D], float (&cy)[YD], float* lkl,
                              float* la) {
    const bool paired = a.paired != 0;
    Draws rl(chain, step, a.key0, a.key1, first);
    Program::sample_local(a.prog, th, rl, cth);
    Draws rs(chain, step, a.key0, a.key1,
             first + (paired ? 0u : static_cast<uint32_t>(a.local_blocks)),
             paired);
    Program::simulate(a.prog, cth, rs, cy);
    *lkl = Program::log_kernel(a.prog, cy);
    *la = (Program::prior_diff_lp(a.prog, cth, th) + *lkl) - logk;
  }
};
#endif

// D, YD: register capacity of theta and y (a.d <= D, a.yd <= YD live).
template <int D, int YD, class Local>
__global__ void pool_isir_mixed_kernel(MixedArgs a) {
  extern __shared__ float smem[];
  const int d = a.d, yd = a.yd;
  float* s_mu = smem;                       // S * d
  float* s_pre = smem + a.S * d;            // S
  float* s_inv2h = s_pre + a.S;             // d
  float* s_yobs = s_inv2h + d;              // d
  for (int k = threadIdx.x; k < a.S * d; k += blockDim.x) s_mu[k] = a.mu[k];
  for (int k = threadIdx.x; k < a.S; k += blockDim.x) s_pre[k] = a.pre[k];
  for (int k = threadIdx.x; k < d; k += blockDim.x) {
    s_inv2h[k] = a.inv2h[k];
    s_yobs[k] = a.y_obs ? a.y_obs[k] : 0.0f;
  }
  __syncthreads();

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= a.C) return;
  const size_t C = static_cast<size_t>(a.C);
  float th[D], yv[YD], cth[D], cy[YD];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    if (j < d) th[j] = a.theta_in[j * C + c];
  }
#pragma unroll
  for (int j = 0; j < YD; ++j) {
    if (j < yd) yv[j] = a.y_in[j * C + c];
  }
  float logk = a.logk_in[c];
  float gatt = 0.0f, gacc = 0.0f, lacc = 0.0f;
  const uint32_t chain = static_cast<uint32_t>(c);
  const int n_scalar_blocks = (a.B + 3 + 3) / 4;
  const int B = a.B;

  for (int t = 0; t < a.T; ++t) {
    const uint32_t step = a.step0 + static_cast<uint32_t>(t);
    Scalars sc;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sc.b[k] = k < n_scalar_blocks
                    ? philox4x32_10(make_uint4(chain, step,
                                               static_cast<uint32_t>(k), 0u),
                                    a.key0, a.key1)
                    : make_uint4(0u, 0u, 0u, 0u);
    }

    // ---- 1. resident proposal density at the current state, in two
    // passes over the S components: the max, then the float32 sum of
    // exp(sc - m).  The second pass recomputes the affine term: with one
    // chain per thread there is about one warp per scheduler, and a
    // one-pass running logsumexp, whose exponentials wait on the running
    // max, ran slower on an H100 than these two independent loops.
    float m = -1.0e30f;
    for (int i = 0; i < a.S; ++i) {
      float dot = 0.0f;
#pragma unroll
      for (int f = 0; f < D; ++f) {
        if (f < d) {
          const float p = s_mu[i * d + f] * th[f];
          dot = (f == 0) ? p : dot + p;
        }
      }
      m = fmaxf(m, dot + s_pre[i]);
    }
    float sum = 0.0f;
    for (int i = 0; i < a.S; ++i) {
      float dot = 0.0f;
#pragma unroll
      for (int f = 0; f < D; ++f) {
        if (f < d) {
          const float p = s_mu[i * d + f] * th[f];
          dot = (f == 0) ? p : dot + p;
        }
      }
      sum = sum + expf((dot + s_pre[i]) - m);
    }
    float q2 = 0.0f;
#pragma unroll
    for (int f = 0; f < D; ++f) {
      if (f < d) {
        const float p = (th[f] * th[f]) * s_inv2h[f];
        q2 = (f == 0) ? p : q2 + p;
      }
    }
    const float logq = (logf(sum) + m) - 0.5f * q2;
    const float lp_theta = Local::template prior<D>(a, th, d);
    const float logw_cur = (lp_theta + logk) - logq;

    // ---- 2. global: iSIR over pool slice t
    float best = logw_cur + gumbel_from_uniform(sc.u(B));
    float bth[D], by[YD];
#pragma unroll
    for (int f = 0; f < D; ++f) {
      if (f < d) bth[f] = th[f];
    }
#pragma unroll
    for (int f = 0; f < YD; ++f) {
      if (f < yd) by[f] = yv[f];
    }
    float blogk = logk;
    bool bmoved = false;
    for (int j = 0; j < B; ++j) {
      const size_t slot = static_cast<size_t>(t) * B + j;
      const float lw = a.plogw[slot * C + c];
      const float lk = a.plogk[slot * C + c];
#pragma unroll
      for (int f = 0; f < D; ++f) {
        if (f < d) cth[f] = a.ptheta[(slot * d + f) * C + c];
      }
#pragma unroll
      for (int f = 0; f < YD; ++f) {
        if (f < yd) cy[f] = a.px[(slot * yd + f) * C + c];
      }
      const float score = lw + gumbel_from_uniform(sc.u(j));
      if (score > best) {
        best = score;
#pragma unroll
        for (int f = 0; f < D; ++f) {
          if (f < d) bth[f] = cth[f];
        }
#pragma unroll
        for (int f = 0; f < YD; ++f) {
          if (f < yd) by[f] = cy[f];
        }
        blogk = lk;
        bmoved = true;
      }
    }

    // ---- 3. local: random-walk MH
    float lkl, la_l;
    Local::template move<D, YD>(a, s_yobs, chain, step,
                                static_cast<uint32_t>(n_scalar_blocks), th,
                                lp_theta, logk, cth, cy, &lkl, &la_l);
    const bool l_acc = logf(sc.u(B + 1)) < la_l;

    // ---- 4. coin, update, counters, history
    const bool is_g = sc.u(B + 2) < a.gf;
    if (is_g) {
#pragma unroll
      for (int f = 0; f < D; ++f) {
        if (f < d) th[f] = bth[f];
      }
#pragma unroll
      for (int f = 0; f < YD; ++f) {
        if (f < yd) yv[f] = by[f];
      }
      logk = blogk;
    } else if (l_acc) {
#pragma unroll
      for (int f = 0; f < D; ++f) {
        if (f < d) th[f] = cth[f];
      }
#pragma unroll
      for (int f = 0; f < YD; ++f) {
        if (f < yd) yv[f] = cy[f];
      }
      logk = lkl;
    }
    gatt += is_g ? 1.0f : 0.0f;
    gacc += (is_g && bmoved) ? 1.0f : 0.0f;
    lacc += (!is_g && l_acc) ? 1.0f : 0.0f;
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
#pragma unroll
  for (int f = 0; f < YD; ++f) {
    if (f < yd) a.y_out[f * C + c] = yv[f];
  }
  a.logk_out[c] = logk;
  a.gatt[c] = gatt;
  a.gacc[c] = gacc;
  a.lacc[c] = lacc;
}

template <int D, int YD, class Local>
int launch_mixed(const MixedArgs& a, int threads, cudaStream_t s) {
  const size_t smem = (static_cast<size_t>(a.S) * (a.d + 1) + 2 * a.d) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pool_isir_mixed_kernel<D, YD, Local>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((a.C + threads - 1) / threads);
  pool_isir_mixed_kernel<D, YD, Local><<<grid, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_builtin(const MixedArgs& a, int threads, cudaStream_t s) {
  return launch_mixed<D, D, BuiltinLocal>(a, threads, s);
}

}  // namespace glabc

extern "C" int glabc_pool_isir_mixed(
    const float* mu, const float* pre, const float* inv2h, const float* y_obs,
    const float* ptheta, const float* px, const float* plogw,
    const float* plogk, const float* theta_in, const float* y_in,
    const float* logk_in, float* theta_out, float* y_out, float* logk_out,
    float* gatt, float* gacc, float* lacc, float* hist, int d, int C, int T,
    int B, int S, int collect, float prior_loc, float inv_prior_scale,
    float c_prior, float lp_scale, float sigma, float c_kern, float a_kern,
    float gf, unsigned int key0, unsigned int key1, unsigned int step0,
    int threads, void* stream) {
  using namespace glabc;
  if (d < 1 || d > 32 || B < 1 || B > 7 || S < 1) return -1;
  MixedArgs a{mu,        pre,      inv2h,    y_obs,    nullptr,  ptheta,
              px,        plogw,    plogk,    theta_in, y_in,     logk_in,
              theta_out, y_out,    logk_out, gatt,     gacc,     lacc,
              hist,      d,        d,        C,        T,        B,
              S,         collect,  0,        0,        prior_loc,
              inv_prior_scale,     c_prior,  lp_scale, sigma,    c_kern,
              a_kern,    gf,       key0,     key1,     step0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 1) return launch_builtin<1>(a, threads, s);
  if (d <= 2) return launch_builtin<2>(a, threads, s);
  if (d <= 3) return launch_builtin<3>(a, threads, s);
  if (d <= 4) return launch_builtin<4>(a, threads, s);
  if (d <= 8) return launch_builtin<8>(a, threads, s);
  if (d <= 16) return launch_builtin<16>(a, threads, s);
  return launch_builtin<32>(a, threads, s);
}

#ifdef GLABC_PROGRAM
extern "C" int glabc_pool_isir_mixed_program(
    const float* mu, const float* pre, const float* inv2h, const float* prog,
    const float* ptheta, const float* px, const float* plogw,
    const float* plogk, const float* theta_in, const float* y_in,
    const float* logk_in, float* theta_out, float* y_out, float* logk_out,
    float* gatt, float* gacc, float* lacc, float* hist, int d, int y_rows,
    int C, int T, int B, int S, int collect, int local_blocks, int paired,
    float gf, unsigned int key0, unsigned int key1, unsigned int step0,
    int threads, void* stream) {
  using namespace glabc;
  if (d != Program::D || y_rows != Program::Y || B < 1 || B > 7 || S < 1)
    return -1;
  MixedArgs a{mu,        pre,      inv2h,    nullptr,  prog,     ptheta,
              px,        plogw,    plogk,    theta_in, y_in,     logk_in,
              theta_out, y_out,    logk_out, gatt,     gacc,     lacc,
              hist,      d,        y_rows,   C,        T,        B,
              S,         collect,  local_blocks, paired, 0.0f,
              0.0f,      0.0f,     0.0f,     0.0f,     0.0f,
              0.0f,      gf,       key0,     key1,     step0};
  return launch_mixed<Program::D, Program::Y, ProgramLocal>(
      a, threads, static_cast<cudaStream_t>(stream));
}
#endif
