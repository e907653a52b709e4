// Fused Mixture-family GLMCMC / GlobalMCMC transitions, one thread per chain.
//
// Replaces two TPU kernels that differ only in their sublane layout:
//   glabc_tpu/ops/pallas/packed_kernel.py  PackedMixtureGLMCMC._kernel (K1)
//   glabc_tpu/ops/pallas/mixture_kernel.py FusedMixtureGLMCMC._kernel  (K2)
// and the PRNG helpers they share (mixture_kernel.py:55-89, K0), which live in
// philox.cuh.  The plain torch version of the same arithmetic is
// glabc_tpu_torch/ops/kernels/mixture_kernel.py (draw_noise + transition);
// every float operation below is written in the same order as there, and the
// library is built with --fmad=false, so the two agree to the last bit up to
// the transcendental functions.
//
// What bounds it on an H100: per transition at d=2, B=5 the kernel writes
// 8 bytes of history and reads nothing (the state stays in registers for the
// whole launch), but a global step runs 7 Philox4x32-10 blocks (2 of
// scalars, 5 candidates), 10 Box-Muller pairs (logf, sqrtf, sinf, cosf) and
// up to 7 more logf for the Gumbels, and a local step 2 blocks, 2 pairs and
// one logf: at least ~1,005 32-bit operations per transition at gf=0.9
// (chip_smoke.py's transition_ops by move) against 8 bytes.  At 3.35 TB/s
// the bytes allow ~4e11 transitions/s; at one operation per lane per clock
// (33.5e12/s) the operations allow ~3.3e10.  The kernel is bound by the
// instructions it issues (~3,300 static SASS instructions on a global
// step's path), so its design spends nothing on memory (no shared
// memory, no staging, one coalesced store per dimension per step, every
// random number made in registers from a counter) and issues as few as it
// can:
//   * the coin is read first, and one loop of candidate rounds serves both
//     moves: a global lane draws candidate c in round c, a local lane its
//     random-walk candidate in round 0 and sits out the rest.  A warp that
//     holds both kinds of lane (nearly every warp at gf=0.9) runs B rounds,
//     not B + 1, and an all-local warp one; the plain version computes both
//     moves and selects, with the same numbers;
//   * a local lane fetches only the scalar block that holds its coin and
//     accept slots;
//   * the algorithm (GLMCMC's iSIR or GlobalMCMC's independence MH) is a
//     template parameter, so a round carries no code of the other;
//   * the prior log-density of the current state is carried from step to
//     step (a move takes its candidate's, computed in the same order).
// Philox's round keys are left to the compiler, which keeps them in uniform
// registers; a table of them among the kernel's parameters was read with a
// load per round and made the launch slower (PERF.md).
//
// Layouts (the JAX package's, so both packages' tests compare like with like):
//   packed   (8, C_cols): dim j of chain p*C_cols + c at row p*d + j, col c;
//            logk on every row of the chain's group, counters on the leader
//            row p*d and 0 on the others.
//   unpacked (d_pad, C): dim j of chain c at row j; rows >= d written 0;
//            logk and counters (1, C).
// In both, a chain owns `rows_per_group` state rows and `aux_rows` logk /
// counter rows, starting at group g = n / ncols.  History is (T, rows, ncols)
// with the state's layout, or one plane holding the final state when history
// is off.
//
// Random numbers per transition, counter (chain, step, block, 0), chain the
// global index chain0 + n:
//   blocks [0, S)            scalars: glmcmc -> Gumbel 0..B, u_local, u_coin
//                                      global -> u_local, u_coin, u_global
//   blocks S + b*P + j/2     proposal b, dim j: lanes (2(j%2), 2(j%2)+1) form
//                            one Box-Muller pair -> (proposal, simulator) noise
//   blocks S + Bp*P + j/2    the local move's pair for dim j
// with P = ceil(d/2), S = ceil(n_scalars/4), Bp = B (glmcmc) or 1 (global).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "philox.cuh"

namespace glabc {

struct Params {
  float prior_loc, inv_prior_scale, c_prior;
  float ip_loc, ip_scale, inv_ip_scale, c_ip;
  float lp_scale, sigma, c_kern, a_kern, gf;
  int d, groups, rows_per_group, aux_rows, ncols, nchains;
  int T, collect, B, n_scalar_blocks, pair_blocks;
  // chain0: the global index of this launch's chain 0 (a shard's offset)
  uint32_t key0, key1, step0, chain0;
};

struct Buffers {
  const float* theta_in;
  const float* y_in;
  const float* logk_in;
  const float* y_obs;
  float* theta_out;
  float* y_out;
  float* logk_out;
  float* hist;
  float* acc;
  float* gatt;
  float* gacc;
  float* lacc;
  float* scratch;
};

// A chain's d-vector: registers when d is a compile-time constant, a strided
// column of scratch memory (4 vectors x d x nchains) for the runtime-d build.
template <int D>
struct Vec {
  float v[D];
  __device__ __forceinline__ float& operator[](int j) { return v[j]; }
  __device__ __forceinline__ void bind(float*, int, int, int, int) {}
};

template <>
struct Vec<0> {
  float* p;
  int stride;
  __device__ __forceinline__ float& operator[](int j) {
    return p[static_cast<size_t>(j) * stride];
  }
  __device__ __forceinline__ void bind(float* scratch, int which, int d,
                                       int n, int nchains) {
    p = scratch + static_cast<size_t>(which) * d * nchains + n;
    stride = nchains;
  }
};

template <int D>
struct Chain {
  const Params& q;
  Vec<D> yo;

  __device__ __forceinline__ int dim() const { return D > 0 ? D : q.d; }

  // sum_j (c - 0.5 * z_j^2), z = (th - loc) * (1 / scale), left to right
  __device__ __forceinline__ float gauss_lp(Vec<D>& th, float loc,
                                            float inv_scale, float c) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < dim(); ++j) {
      const float z = (th[j] - loc) * inv_scale;
      const float per = c - 0.5f * (z * z);
      s = (j == 0) ? per : s + per;
    }
    return s;
  }

  __device__ __forceinline__ float kern_lp(Vec<D>& yv) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < dim(); ++j) {
      const float diff = yv[j] - yo[j];
      const float sq = diff * diff;
      s = (j == 0) ? sq : s + sq;
    }
    return q.c_kern - s * q.a_kern;
  }
};

template <int D>
__device__ __forceinline__ void copy_vec(Vec<D>& dst, Vec<D>& src, int d) {
#pragma unroll
  for (int j = 0; j < (D > 0 ? D : d); ++j) dst[j] = src[j];
}

// One candidate from the pairs of blocks first_block + j/2:
// th_j = base_j + scale * n1_j, y_j = |th_j| + sigma * n2_j, where base_j is
// ip_loc for a global proposal and the current state for the random walk.
template <int D>
__device__ __forceinline__ void candidate(const Params& q, uint32_t chain,
                                          uint32_t step, uint32_t first_block,
                                          Vec<D>& cur, bool global,
                                          float scale, Vec<D>& th, Vec<D>& yv,
                                          int d) {
  uint4 blk = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int j = 0; j < (D > 0 ? D : d); ++j) {
    if ((j & 1) == 0) {
      blk = philox4x32_10(
          make_uint4(chain, step, first_block + static_cast<uint32_t>(j >> 1),
                     0u),
          q.key0, q.key1);
    }
    const float u1 = uniform_from_bits((j & 1) ? blk.z : blk.x);
    const float u2 = uniform_from_bits((j & 1) ? blk.w : blk.y);
    float n1, n2;
    normal_pair(u1, u2, &n1, &n2);
    const float t = (global ? q.ip_loc : cur[j]) + scale * n1;
    th[j] = t;
    yv[j] = fabsf(t) + q.sigma * n2;
  }
}

template <int D, bool GLMCMC>
__global__ void mixture_glmcmc_kernel(Buffers b, Params q) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= q.nchains) return;
  const int d = D > 0 ? D : q.d;
  const size_t rs = static_cast<size_t>(q.ncols);
  const int grp = n / q.ncols;
  const int col = n - grp * q.ncols;
  const size_t base = static_cast<size_t>(grp) * q.rows_per_group * rs + col;
  const size_t aux = static_cast<size_t>(grp) * q.aux_rows * rs + col;
  const size_t plane = static_cast<size_t>(q.groups) * q.rows_per_group * rs;

  Chain<D> ch{q, {}};
  Vec<D> th, yv, cth, cy;
  th.bind(b.scratch, 0, d, n, q.nchains);
  yv.bind(b.scratch, 1, d, n, q.nchains);
  cth.bind(b.scratch, 2, d, n, q.nchains);
  cy.bind(b.scratch, 3, d, n, q.nchains);
  if constexpr (D == 0) {
    ch.yo.p = const_cast<float*>(b.y_obs);
    ch.yo.stride = 1;
  } else {
#pragma unroll
    for (int j = 0; j < D; ++j) ch.yo[j] = b.y_obs[j];
  }
#pragma unroll
  for (int j = 0; j < d; ++j) {
    th[j] = b.theta_in[base + j * rs];
    yv[j] = b.y_in[base + j * rs];
  }
  float logk = b.logk_in[aux];
  float acc = 0.0f, gatt = 0.0f, gacc = 0.0f, lacc = 0.0f;
  const uint32_t chain = q.chain0 + static_cast<uint32_t>(n);
  const int Bp = GLMCMC ? q.B : 1;
  const uint32_t S = static_cast<uint32_t>(q.n_scalar_blocks);
  const uint32_t P = static_cast<uint32_t>(q.pair_blocks);
  // scalar slots
  const int s_local = GLMCMC ? q.B + 1 : 0;
  const int s_coin = GLMCMC ? q.B + 2 : 1;
  const int s_global = 2;
  // the prior log-density of th, carried: a move takes its candidate's
  float lp_theta = ch.gauss_lp(th, q.prior_loc, q.inv_prior_scale, q.c_prior);

  for (int t = 0; t < q.T; ++t) {
    const uint32_t step = q.step0 + static_cast<uint32_t>(t);
    // the coin's block is pinned, so a global lane fetches each block once
    // and a local lane only the coin's unless its accept slot lies in another
    PinnedSlots ss(chain, step, q.key0, q.key1, s_coin);
    const bool is_g = ss.uniform(s_coin) < q.gf;
    float ip_theta = 0.0f, best = 0.0f;
    if (is_g) {
      ip_theta = ch.gauss_lp(th, q.ip_loc, q.inv_ip_scale, q.c_ip);
      // iSIR as a streaming Gumbel-argmax, strict > keeps ties
      if constexpr (GLMCMC)
        best = ((lp_theta + logk) - ip_theta) +
               gumbel_from_uniform(ss.uniform(0));
    }
    const float scale = is_g ? q.ip_scale : q.lp_scale;
    const int rounds = is_g ? Bp : 1;
    const float lp_cur = lp_theta, logk_cur = logk;
    bool moved = false;
    // the candidate rounds, one loop for both moves: a local lane takes its
    // random-walk candidate (blocks S + Bp P) in round 0 and sits out the rest
    for (int c = 0; c < rounds; ++c) {
      const uint32_t first = S + static_cast<uint32_t>(is_g ? c : Bp) * P;
      candidate<D>(q, chain, step, first, th, is_g, scale, cth, cy, d);
      const float lk = ch.kern_lp(cy);
      const float lp_c =
          ch.gauss_lp(cth, q.prior_loc, q.inv_prior_scale, q.c_prior);
      const float lw = lp_c + lk;
      bool take;
      if (!is_g) {         // random-walk MH
        take = logf(ss.uniform(s_local)) < ((lw - lp_cur) - logk_cur);
      } else if constexpr (GLMCMC) {  // iSIR
        const float score =
            (lw - ch.gauss_lp(cth, q.ip_loc, q.inv_ip_scale, q.c_ip)) +
            gumbel_from_uniform(ss.uniform(c + 1));
        take = score > best;
        if (take) best = score;
      } else {              // independence MH
        const float la =
            (((lw + ip_theta) -
              ch.gauss_lp(cth, q.ip_loc, q.inv_ip_scale, q.c_ip)) -
             lp_cur) -
            logk_cur;
        take = logf(ss.uniform(s_global)) < la;
      }
      if (take) {
        copy_vec(th, cth, d);
        copy_vec(yv, cy, d);
        logk = lk;
        lp_theta = lp_c;
        moved = true;
      }
    }
    acc += moved ? 1.0f : 0.0f;
    gatt += is_g ? 1.0f : 0.0f;
    gacc += (is_g && moved) ? 1.0f : 0.0f;
    lacc += (!is_g && moved) ? 1.0f : 0.0f;

    if (q.collect) {
      float* h = b.hist + static_cast<size_t>(t) * plane + base;
#pragma unroll
      for (int j = 0; j < d; ++j) h[j * rs] = th[j];
      for (int j = d; j < q.rows_per_group; ++j) h[j * rs] = 0.0f;
    }
  }

  for (int j = 0; j < d; ++j) {
    b.theta_out[base + j * rs] = th[j];
    b.y_out[base + j * rs] = yv[j];
  }
  for (int j = d; j < q.rows_per_group; ++j) {
    b.theta_out[base + j * rs] = 0.0f;
    b.y_out[base + j * rs] = 0.0f;
  }
  if (!q.collect) {
    for (int j = 0; j < d; ++j) b.hist[base + j * rs] = th[j];
    for (int j = d; j < q.rows_per_group; ++j) b.hist[base + j * rs] = 0.0f;
  }
  for (int k = 0; k < q.aux_rows; ++k) {
    const size_t o = aux + k * rs;
    const bool lead = k == 0;
    b.logk_out[o] = logk;
    b.acc[o] = lead ? acc : 0.0f;
    b.gatt[o] = lead ? gatt : 0.0f;
    b.gacc[o] = lead ? gacc : 0.0f;
    b.lacc[o] = lead ? lacc : 0.0f;
  }
}

template <bool GLMCMC>
void launch(int d, dim3 grid, int threads, cudaStream_t s, const Buffers& b,
            const Params& q) {
  switch (d) {
    case 1: mixture_glmcmc_kernel<1, GLMCMC><<<grid, threads, 0, s>>>(b, q); break;
    case 2: mixture_glmcmc_kernel<2, GLMCMC><<<grid, threads, 0, s>>>(b, q); break;
    case 3: mixture_glmcmc_kernel<3, GLMCMC><<<grid, threads, 0, s>>>(b, q); break;
    case 4: mixture_glmcmc_kernel<4, GLMCMC><<<grid, threads, 0, s>>>(b, q); break;
    case 8: mixture_glmcmc_kernel<8, GLMCMC><<<grid, threads, 0, s>>>(b, q); break;
    default: mixture_glmcmc_kernel<0, GLMCMC><<<grid, threads, 0, s>>>(b, q); break;
  }
}

__global__ void philox_kernel(const uint32_t* in, uint32_t* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t* c = in + 6 * i;
  const uint4 r = philox4x32_10(make_uint4(c[0], c[1], c[2], c[3]), c[4], c[5]);
  out[4 * i + 0] = r.x;
  out[4 * i + 1] = r.y;
  out[4 * i + 2] = r.z;
  out[4 * i + 3] = r.w;
}

}  // namespace glabc

extern "C" int glabc_mixture_glmcmc(
    const float* theta_in, const float* y_in, const float* logk_in,
    const float* y_obs, float* theta_out, float* y_out, float* logk_out,
    float* hist, float* acc, float* gatt, float* gacc, float* lacc,
    float* scratch, int d, int groups, int rows_per_group, int aux_rows,
    int ncols, int T, int collect, int glmcmc, int B, float prior_loc,
    float inv_prior_scale, float c_prior, float ip_loc, float ip_scale,
    float inv_ip_scale, float c_ip, float lp_scale, float sigma, float c_kern, float a_kern,
    float gf, unsigned int key0, unsigned int key1, unsigned int step0,
    unsigned int chain0, int threads, void* stream) {
  using namespace glabc;
  Params q;
  q.prior_loc = prior_loc;
  q.inv_prior_scale = inv_prior_scale;
  q.c_prior = c_prior;
  q.ip_loc = ip_loc;
  q.ip_scale = ip_scale;
  q.inv_ip_scale = inv_ip_scale;
  q.c_ip = c_ip;
  q.lp_scale = lp_scale;
  q.sigma = sigma;
  q.c_kern = c_kern;
  q.a_kern = a_kern;
  q.gf = gf;
  q.d = d;
  q.groups = groups;
  q.rows_per_group = rows_per_group;
  q.aux_rows = aux_rows;
  q.ncols = ncols;
  q.nchains = groups * ncols;
  q.T = T;
  q.collect = collect;
  q.B = B;
  const int n_scalar = glmcmc ? B + 3 : 3;
  q.n_scalar_blocks = (n_scalar + 3) / 4;
  q.pair_blocks = (d + 1) / 2;
  q.key0 = key0;
  q.key1 = key1;
  q.step0 = step0;
  q.chain0 = chain0;
  Buffers b{theta_in, y_in, logk_in, y_obs, theta_out, y_out, logk_out,
            hist, acc, gatt, gacc, lacc, scratch};
  const dim3 grid((q.nchains + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (glmcmc)
    launch<true>(d, grid, threads, s, b, q);
  else
    launch<false>(d, grid, threads, s, b, q);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int glabc_philox4x32(const unsigned int* in, unsigned int* out,
                                int n, void* stream) {
  const int threads = 256;
  glabc::philox_kernel<<<(n + threads - 1) / threads, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(in, out, n);
  return static_cast<int>(cudaGetLastError());
}

// d values that have a register build; any other d runs the scratch build.
extern "C" int glabc_mixture_register_dims(int d) {
  return d == 1 || d == 2 || d == 3 || d == 4 || d == 8;
}
