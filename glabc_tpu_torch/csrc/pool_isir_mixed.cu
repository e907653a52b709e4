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
// in its order and the library is built with --fmad=false.
//
// Per step, in the TPU kernel's order:
//   1. log q(theta) of the current state under the resident shared mixture
//      (S components: mu / h^2, pre, 1/h^2), a logsumexp over S, and the
//      prior of theta: carried in registers, and recomputed only at the
//      launch's first step and after a step in which the chain moved (the
//      mixture is fixed for the launch, so both are functions of theta
//      alone and an unmoved chain's are the last step's to the bit);
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
// The resident logsumexp is warp-cooperative: the lanes that need it are
// taken from a __ballot_sync one at a time (__ffs); the owner's theta is
// broadcast by __shfl_sync, lane l takes components l, l + 32, l + 64, ...
// (the max, combined by an xor butterfly, then its float32 sum of
// expf(sc - max) in that order), and the 32 partial sums are combined by
// an xor butterfly (offsets 16, 8, 4, 2, 1).  The plain version
// (resident_log_q) sums in exactly this order, so with the accurate expf
// and --fmad=false the kernel is bitwise equal to it.  Lanes without a
// chain (past C, or past the warp's chain count) stay in their warp as
// inert lanes (loads clamped to chain C - 1, no stores), so every shuffle
// has its whole warp.
//
// What bounds it on an H100: the resident logsumexp costs S exponentials
// and S (d + 3) other operations, but only on the chain-steps that follow
// a move (2.5 % at the AGLMCMC gf=0.5 entry run's acceptance, 0.8 lanes a
// warp-step; 44 % on the MA(2) program's run); the rest of a step is its
// Philox blocks, Gumbels, the local move and B (d + yd + 2) floats of pool
// read (30 at d = yd = 2, B = 5).  With one chain per thread the
// launch is latency-bound: a few warps per SM, each waiting on its loads,
// shuffles and exponentials in turn.  So:
// - a warp takes 32 chains, or 16 when 32 would leave one of the card's
//   schedulers without a warp (the wrapper's choice; the inert upper half
//   still shares the resident densities): 8,192 chains run as 512 warps;
// - the block size comes from the chain count, so that every SM gets work;
// - the step's pool slice is loaded into registers at the top of the step,
//   so its loads are in flight while the Philox blocks and the density
//   run, where a load per slot in the iSIR loop waited on memory B times;
// - the density's strided loops are unrolled by 8: a lane's loads, affine
//   terms and exponentials overlap while its sum still adds them in order;
// - the mixture (one 16-byte row (mu_scaled_0..2, pre) a component for
//   d <= 3, so the strided lanes read distinct rows; (mu_0..mu_{d-1}, pre)
//   for wider d) is staged in shared memory once per block, and the
//   chain's state stays in registers for the whole launch; chains are the
//   fastest axis of every array, so pool loads and history stores
//   coalesce.
// On an NVIDIA H100 80GB HBM3 at 700 W the gf=0.5 entry run's launch
// (16,384 chains x 400 steps, S = 1024) takes 1.55 ms where the per-thread
// two-pass logsumexp at every step took 18.3 ms, and the MA(2) program's
// (8,192 x 400) 9.8 ms where it took 26.1 ms (PERF.md).
//
// D is a compile-time bound on d up to 32, one instantiation each, the
// chain's state and its step's pool slice in registers and the mixture in
// shared memory.  Above d = 32 (up to 128) the built-in move runs one
// runtime-d kernel, pool_isir_mixed_wide_kernel: the chain's theta, y and
// local proposal live in thread-local arrays (local memory, the L1's), the
// pool slice is read where it is used (the winner of the iSIR is carried as
// its slot and its theta and y copied only at a global move), the
// mixture's rows are read from global memory (S (d + 1) floats, 528 KB at
// S = 1,024, d = 128: past what a block's shared memory holds), and the
// resident logsumexp's theta is broadcast through a warp's slot in shared
// memory instead of d shuffles.  Every float operation is the static
// kernels', in their order, so it is bit for bit the plain version too.
//
// Random numbers: counter (chain0 + chain, step0 + t, block, 0).  Scalar slots
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
  uint32_t chain0;       // the global index of chain 0 (a shard's offset)
  int lanes;             // chains per warp (lanes past it are inert)
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

constexpr unsigned kFullMask = 0xffffffffu;

// floats per staged mixture component: (mu_0 .. mu_{d-1}, pre), 4 for d <= 3
__host__ __device__ constexpr int mix_row(int d) { return d <= 3 ? 4 : d + 1; }

// logf(sum) + max of the resident logsumexp at theta tv, by the whole warp:
// lane l takes components l, l + 32, ...; every lane returns the same value.
template <int D>
__device__ __forceinline__ float warp_resident_lse(const float* s_rows, int S,
                                                  int d, const float (&tv)[D],
                                                  int lane) {
  const int W = mix_row(d);
  auto score = [&](int i) {
    const float* row = s_rows + i * W;
    float mu[D];
    float pre;
    if constexpr (D <= 3) {
      const float4 v = *reinterpret_cast<const float4*>(row);
      const float r4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int f = 0; f < D; ++f) mu[f] = r4[f];
      pre = v.w;
    } else {
#pragma unroll
      for (int f = 0; f < D; ++f) mu[f] = f < d ? row[f] : 0.0f;
      pre = row[d];
    }
    float dot = 0.0f;
#pragma unroll
    for (int f = 0; f < D; ++f) {
      if (f < d) {
        const float p = mu[f] * tv[f];
        dot = (f == 0) ? p : dot + p;
      }
    }
    return dot + pre;
  };
  // unrolled: a lane's loads, affine terms and exponentials of several
  // components are in flight at once; its sum still adds them in order
  float m = -1.0e30f;
#pragma unroll 8
  for (int i = lane; i < S; i += 32) m = fmaxf(m, score(i));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFullMask, m, off));
  float sum = 0.0f;
#pragma unroll 8
  for (int i = lane; i < S; i += 32) sum = sum + expf(score(i) - m);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum = sum + __shfl_xor_sync(kFullMask, sum, off);
  return logf(sum) + m;
}

constexpr int kMaxB = 7;

// One step's pool slice of one chain (B <= kMaxB slots) in registers.
template <int D, int YD>
struct PoolSlice {
  float lw[kMaxB], lk[kMaxB], th[kMaxB][D], x[kMaxB][YD];

  __device__ __forceinline__ void load(const MixedArgs& a, int t, int cl) {
    const size_t C = static_cast<size_t>(a.C);
#pragma unroll
    for (int j = 0; j < kMaxB; ++j) {
      if (j < a.B) {
        const size_t slot = static_cast<size_t>(t) * a.B + j;
        lw[j] = a.plogw[slot * C + cl];
        lk[j] = a.plogk[slot * C + cl];
#pragma unroll
        for (int f = 0; f < D; ++f) {
          if (f < a.d) th[j][f] = a.ptheta[(slot * a.d + f) * C + cl];
        }
#pragma unroll
        for (int f = 0; f < YD; ++f) {
          if (f < a.yd) x[j][f] = a.px[(slot * a.yd + f) * C + cl];
        }
      }
    }
  }
};

// D, YD: register capacity of theta and y (a.d <= D, a.yd <= YD live).
// MaxThreads: the block size the registers are budgeted for (256, or 1024
// for larger blocks).
template <int D, int YD, class Local, int MaxThreads>
__global__ void __launch_bounds__(MaxThreads)
pool_isir_mixed_kernel(MixedArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int d = a.d, yd = a.yd;
  const int W = mix_row(d);
  float* s_rows = smem;                     // S * W
  float* s_inv2h = smem + a.S * W;          // d
  float* s_yobs = s_inv2h + d;              // d
  for (int k = threadIdx.x; k < a.S * W; k += blockDim.x) {
    const int i = k / W, f = k - i * W;
    s_rows[k] = f < d ? a.mu[i * d + f] : (f == W - 1 ? a.pre[i] : 0.0f);
  }
  for (int k = threadIdx.x; k < d; k += blockDim.x) {
    s_inv2h[k] = a.inv2h[k];
    s_yobs[k] = a.y_obs ? a.y_obs[k] : 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int c = warp * a.lanes + lane;
  const bool live = lane < a.lanes && c < a.C;
  const int cl = live ? c : a.C - 1;        // an inert lane reads chain C - 1
  const size_t C = static_cast<size_t>(a.C);
  float th[D], yv[YD], cth[D], cy[YD];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    if (j < d) th[j] = a.theta_in[j * C + cl];
  }
#pragma unroll
  for (int j = 0; j < YD; ++j) {
    if (j < yd) yv[j] = a.y_in[j * C + cl];
  }
  float logk = a.logk_in[cl];
  float gatt = 0.0f, gacc = 0.0f, lacc = 0.0f;
  const uint32_t chain = a.chain0 + static_cast<uint32_t>(c);
  const int n_scalar_blocks = (a.B + 3 + 3) / 4;
  const int B = a.B;
  bool dirty = live;       // log q and the prior of theta need computing
  float logq = 0.0f, lp_theta = 0.0f;

  for (int t = 0; t < a.T; ++t) {
    const uint32_t step = a.step0 + static_cast<uint32_t>(t);
    // the step's pool slice, loaded at the top of the step: its loads are
    // in flight while the Philox blocks and the resident density run
    PoolSlice<D, YD> cur;
    cur.load(a, t, cl);
    Scalars sc;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sc.b[k] = k < n_scalar_blocks
                    ? philox4x32_10(make_uint4(chain, step,
                                               static_cast<uint32_t>(k), 0u),
                                    a.key0, a.key1)
                    : make_uint4(0u, 0u, 0u, 0u);
    }

    // ---- 1. resident proposal density and prior at the current state,
    // for the lanes whose state moved (all at t = 0), one lane at a time
    // by the whole warp
    unsigned need = __ballot_sync(kFullMask, dirty);
    float lse = 0.0f;
    while (need) {
      const int src = __ffs(need) - 1;
      need &= need - 1;
      float tv[D];
#pragma unroll
      for (int f = 0; f < D; ++f) {
        if (f < d) tv[f] = __shfl_sync(kFullMask, th[f], src);
      }
      const float v = warp_resident_lse<D>(s_rows, a.S, d, tv, lane);
      if (lane == src) lse = v;
    }
    if (dirty) {
      float q2 = 0.0f;
#pragma unroll
      for (int f = 0; f < D; ++f) {
        if (f < d) {
          const float p = (th[f] * th[f]) * s_inv2h[f];
          q2 = (f == 0) ? p : q2 + p;
        }
      }
      logq = lse - 0.5f * q2;
      lp_theta = Local::template prior<D>(a, th, d);
    }
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
#pragma unroll
    for (int j = 0; j < kMaxB; ++j) {
      if (j >= B) break;
      const float lw = cur.lw[j], lk = cur.lk[j];
#pragma unroll
      for (int f = 0; f < D; ++f) {
        if (f < d) cth[f] = cur.th[j][f];
      }
#pragma unroll
      for (int f = 0; f < YD; ++f) {
        if (f < yd) cy[f] = cur.x[j][f];
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
    dirty = live && (is_g ? bmoved : l_acc);
    gatt += is_g ? 1.0f : 0.0f;
    gacc += (is_g && bmoved) ? 1.0f : 0.0f;
    lacc += (!is_g && l_acc) ? 1.0f : 0.0f;
    if (a.collect && live) {
      float* h = a.hist + static_cast<size_t>(t) * d * C + c;
#pragma unroll
      for (int f = 0; f < D; ++f) {
        if (f < d) h[f * C] = th[f];
      }
    }
  }
  if (!live) return;
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

constexpr int kMixedMaxD = 128;
constexpr int kMixedWideD = 32;  // the largest static instantiation

// The built-in move at runtime d (kMixedWideD < d <= kMixedMaxD), one thread
// a chain as above; the steps' float operations are pool_isir_mixed_kernel's
// with BuiltinLocal, in its order.
template <int MaxThreads>
__global__ void __launch_bounds__(MaxThreads)
pool_isir_mixed_wide_kernel(MixedArgs a) {
  extern __shared__ __align__(16) float s_tv[];  // a warp's d, per warp
  const int d = a.d;
  const int lane = threadIdx.x & 31;
  float* const tv = s_tv + (threadIdx.x >> 5) * d;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int c = warp * a.lanes + lane;
  const bool live = lane < a.lanes && c < a.C;
  const int cl = live ? c : a.C - 1;        // an inert lane reads chain C - 1
  const size_t C = static_cast<size_t>(a.C);
  float th[kMixedMaxD], yv[kMixedMaxD], cth[kMixedMaxD], cy[kMixedMaxD];
  for (int j = 0; j < d; ++j) {
    th[j] = a.theta_in[j * C + cl];
    yv[j] = a.y_in[j * C + cl];
  }
  float logk = a.logk_in[cl];
  float gatt = 0.0f, gacc = 0.0f, lacc = 0.0f;
  const uint32_t chain = a.chain0 + static_cast<uint32_t>(c);
  const int n_scalar_blocks = (a.B + 3 + 3) / 4;
  const int B = a.B;
  bool dirty = live;       // log q and the prior of theta need computing
  float logq = 0.0f, lp_theta = 0.0f;
  auto prior = [&](const float* x) {
    float s = 0.0f;
    for (int j = 0; j < d; ++j) {
      const float z = (x[j] - a.prior_loc) * a.inv_prior_scale;
      const float per = a.c_prior - 0.5f * (z * z);
      s = (j == 0) ? per : s + per;
    }
    return s;
  };
  // the resident mixture's score of component i at the warp's tv
  auto score = [&](int i) {
    const float* const mu = a.mu + static_cast<size_t>(i) * d;
    float dot = 0.0f;
    for (int f = 0; f < d; ++f) {
      const float p = __ldg(mu + f) * tv[f];
      dot = (f == 0) ? p : dot + p;
    }
    return dot + __ldg(a.pre + i);
  };

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

    // ---- 1. resident proposal density and prior at the current state,
    // for the lanes whose state moved, one lane at a time by the whole warp
    unsigned need = __ballot_sync(kFullMask, dirty);
    float lse = 0.0f;
    while (need) {
      const int src = __ffs(need) - 1;
      need &= need - 1;
      if (lane == src)
        for (int f = 0; f < d; ++f) tv[f] = th[f];
      __syncwarp();
      float m = -1.0e30f;
      for (int i = lane; i < a.S; i += 32) m = fmaxf(m, score(i));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(kFullMask, m, off));
      float sum = 0.0f;
      for (int i = lane; i < a.S; i += 32) sum = sum + expf(score(i) - m);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum = sum + __shfl_xor_sync(kFullMask, sum, off);
      if (lane == src) lse = logf(sum) + m;
      __syncwarp();  // every lane is done with tv
    }
    if (dirty) {
      float q2 = 0.0f;
      for (int f = 0; f < d; ++f) {
        const float p = (th[f] * th[f]) * __ldg(a.inv2h + f);
        q2 = (f == 0) ? p : q2 + p;
      }
      logq = lse - 0.5f * q2;
      lp_theta = prior(th);
    }
    const float logw_cur = (lp_theta + logk) - logq;

    // ---- 2. global: iSIR over pool slice t; the winner carried as its slot
    float best = logw_cur + gumbel_from_uniform(sc.u(B));
    float blogk = logk;
    int bj = -1;
    for (int j = 0; j < B; ++j) {
      const size_t slot = static_cast<size_t>(t) * B + j;
      const float score_j =
          a.plogw[slot * C + cl] + gumbel_from_uniform(sc.u(j));
      if (score_j > best) {
        best = score_j;
        blogk = a.plogk[slot * C + cl];
        bj = j;
      }
    }

    // ---- 3. local: random-walk MH (BuiltinLocal::move)
    uint4 blk = make_uint4(0u, 0u, 0u, 0u);
    for (int j = 0; j < d; ++j) {
      if ((j & 1) == 0) {
        blk = philox4x32_10(
            make_uint4(chain, step,
                       static_cast<uint32_t>(n_scalar_blocks + (j >> 1)), 0u),
            a.key0, a.key1);
      }
      const float u1 = uniform_from_bits((j & 1) ? blk.z : blk.x);
      const float u2 = uniform_from_bits((j & 1) ? blk.w : blk.y);
      float n1, n2;
      normal_pair(u1, u2, &n1, &n2);
      cth[j] = th[j] + a.lp_scale * n1;
      cy[j] = fabsf(cth[j]) + a.sigma * n2;
    }
    float ssq = 0.0f;
    for (int j = 0; j < d; ++j) {
      const float diff = cy[j] - __ldg(a.y_obs + j);
      const float sq = diff * diff;
      ssq = (j == 0) ? sq : ssq + sq;
    }
    const float lkl = a.c_kern - ssq * a.a_kern;
    const float la_l = ((prior(cth) + lkl) - lp_theta) - logk;
    const bool l_acc = logf(sc.u(B + 1)) < la_l;

    // ---- 4. coin, update, counters, history
    const bool is_g = sc.u(B + 2) < a.gf;
    const bool bmoved = bj >= 0;
    if (is_g) {
      if (bmoved) {
        const size_t slot = static_cast<size_t>(t) * B + bj;
        for (int f = 0; f < d; ++f) {
          th[f] = a.ptheta[(slot * d + f) * C + cl];
          yv[f] = a.px[(slot * d + f) * C + cl];
        }
      }
      logk = blogk;
    } else if (l_acc) {
      for (int f = 0; f < d; ++f) {
        th[f] = cth[f];
        yv[f] = cy[f];
      }
      logk = lkl;
    }
    dirty = live && (is_g ? bmoved : l_acc);
    gatt += is_g ? 1.0f : 0.0f;
    gacc += (is_g && bmoved) ? 1.0f : 0.0f;
    lacc += (!is_g && l_acc) ? 1.0f : 0.0f;
    if (a.collect && live) {
      float* h = a.hist + static_cast<size_t>(t) * d * C + c;
      for (int f = 0; f < d; ++f) h[f * C] = th[f];
    }
  }
  if (!live) return;
  for (int f = 0; f < d; ++f) {
    a.theta_out[f * C + c] = th[f];
    a.y_out[f * C + c] = yv[f];
  }
  a.logk_out[c] = logk;
  a.gatt[c] = gatt;
  a.gacc[c] = gacc;
  a.lacc[c] = lacc;
}

template <int MaxThreads>
int launch_mixed_wide_at(const MixedArgs& a, int threads, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(threads / 32) * a.d * sizeof(float);
  const long long warps = (a.C + a.lanes - 1) / a.lanes;
  const dim3 grid(static_cast<unsigned>((warps * 32 + threads - 1) / threads));
  pool_isir_mixed_wide_kernel<MaxThreads><<<grid, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_mixed_wide(const MixedArgs& a, int threads, cudaStream_t s) {
  if (threads < 32 || threads > 1024 || threads % 32 || a.lanes < 1 ||
      a.lanes > 32)
    return -1;
  if (a.C == 0) return 0;
  return threads <= 256 ? launch_mixed_wide_at<256>(a, threads, s)
                        : launch_mixed_wide_at<1024>(a, threads, s);
}

template <int D, int YD, class Local, int MaxThreads>
int launch_mixed_at(const MixedArgs& a, int threads, size_t smem,
                    cudaStream_t s) {
  auto kernel = pool_isir_mixed_kernel<D, YD, Local, MaxThreads>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long warps = (a.C + a.lanes - 1) / a.lanes;
  const dim3 grid(static_cast<unsigned>((warps * 32 + threads - 1) / threads));
  kernel<<<grid, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int YD, class Local>
int launch_mixed(const MixedArgs& a, int threads, cudaStream_t s) {
  if (threads < 32 || threads > 1024 || threads % 32 || a.lanes < 1 ||
      a.lanes > 32)
    return -1;
  if (a.C == 0) return 0;
  const size_t smem =
      (static_cast<size_t>(a.S) * mix_row(a.d) + 2 * a.d) * sizeof(float);
  if (threads <= 256)
    return launch_mixed_at<D, YD, Local, 256>(a, threads, smem, s);
  return launch_mixed_at<D, YD, Local, 1024>(a, threads, smem, s);
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
    unsigned int chain0, int threads, int lanes, void* stream) {
  using namespace glabc;
  if (d < 1 || d > kMixedMaxD || B < 1 || B > kMaxB || S < 1) return -1;
  MixedArgs a{mu,        pre,      inv2h,    y_obs,    nullptr,  ptheta,
              px,        plogw,    plogk,    theta_in, y_in,     logk_in,
              theta_out, y_out,    logk_out, gatt,     gacc,     lacc,
              hist,      d,        d,        C,        T,        B,
              S,         collect,  0,        0,        prior_loc,
              inv_prior_scale,     c_prior,  lp_scale, sigma,    c_kern,
              a_kern,    gf,       key0,     key1,     step0,    chain0,
              lanes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 1) return launch_builtin<1>(a, threads, s);
  if (d <= 2) return launch_builtin<2>(a, threads, s);
  if (d <= 3) return launch_builtin<3>(a, threads, s);
  if (d <= 4) return launch_builtin<4>(a, threads, s);
  if (d <= 8) return launch_builtin<8>(a, threads, s);
  if (d <= 16) return launch_builtin<16>(a, threads, s);
  if (d <= kMixedWideD) return launch_builtin<32>(a, threads, s);
  return launch_mixed_wide(a, threads, s);
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
    unsigned int chain0, int threads, int lanes, void* stream) {
  using namespace glabc;
  if (d != Program::D || y_rows != Program::Y || B < 1 || B > kMaxB ||
      S < 1)
    return -1;
  MixedArgs a{mu,        pre,      inv2h,    nullptr,  prog,     ptheta,
              px,        plogw,    plogk,    theta_in, y_in,     logk_in,
              theta_out, y_out,    logk_out, gatt,     gacc,     lacc,
              hist,      d,        y_rows,   C,        T,        B,
              S,         collect,  local_blocks, paired, 0.0f,
              0.0f,      0.0f,     0.0f,     0.0f,     0.0f,
              0.0f,      gf,       key0,     key1,     step0,    chain0,
              lanes};
  return launch_mixed<Program::D, Program::Y, ProgramLocal>(
      a, threads, static_cast<cudaStream_t>(stream));
}
#endif
