// Philox4x32-10 counter-based generator and the variates built on it.
//
// Replaces the TPU hardware PRNG helpers of glabc_tpu/ops/pallas/
// mixture_kernel.py:55-89 (_uniform, _normal_pair, _gumbel).  The TPU kernels
// seed the hardware generator once per grid program and reseed per launch;
// here every draw is a pure function of (seed, chain, step, block), so a
// chain's stream depends neither on the thread-block size nor on how many
// steps one launch runs.
//
// Counter = (global chain index, absolute step index, draw block, 0),
// key = (seed low 32 bits, seed high 32 bits).  Each block yields four
// uniforms.  The torch twin is glabc_tpu_torch/ops/kernels/philox.py; both
// must give the same bits.

#pragma once
#ifndef GLABC_PHILOX_CUH
#define GLABC_PHILOX_CUH
#include <cstdint>

namespace glabc {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

// 2*pi rounded to float32, as the TPU kernel's (2.0 * np.pi) * u2 is.
constexpr float kTwoPi = 6.28318530717958647692f;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The TPU mapping: top 24 bits, u = (bits >> 8) * 2^-24 + 2^-25.  In float32
// the top value rounds to exactly 1.0; it is sent to the largest float below
// 1 so that u stays strictly inside (0, 1).
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  const float u = __uint2float_rn(bits >> 8) * 0x1p-24f + 0x1p-25f;
  return fminf(u, 0x1.fffffep-1f);
}

__device__ __forceinline__ float gumbel_from_uniform(float u) {
  return -logf(-logf(u));
}

// Box-Muller: both the cos and the sin branch are used, from one sincosf
// (one range reduction; the same bits as cosf and sinf apart, which every
// kernel's bitwise check against its plain version holds it to).
__device__ __forceinline__ void normal_pair(float u1, float u2, float* n1,
                                            float* n2) {
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincosf(kTwoPi * u2, &s, &c);
  *n1 = r * c;
  *n2 = r * s;
}

__device__ __forceinline__ uint32_t lane_of(uint4 v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// The scalar slots of one chain and step: slot s is lane s%4 of block s/4,
// the last block fetched cached (slots are read in rising order).
struct SlotScalars {
  uint32_t chain, step, k0, k1;
  uint4 blk;
  int id;
  __device__ __forceinline__ float uniform(int s) {
    const int want = s >> 2;
    if (want != id) {
      blk = philox4x32_10(
          make_uint4(chain, step, static_cast<uint32_t>(want), 0u), k0, k1);
      id = want;
    }
    return uniform_from_bits(lane_of(blk, s & 3));
  }
};

// SlotScalars with the block of one slot, read first (the coin), kept beside
// the cache, so that the other slots, read after it in rising order, do not
// fetch it again.  A separate type: the check costs the kernels that pin
// nothing registers and time (generic GLMCMC 0.9 %, PERF.md).
struct PinnedSlots {
  SlotScalars cache;
  uint4 pinned;
  int pinned_id;

  __device__ __forceinline__ PinnedSlots(uint32_t chain, uint32_t step,
                                         uint32_t k0, uint32_t k1, int s)
      : cache{chain, step, k0, k1, make_uint4(0u, 0u, 0u, 0u), -1},
        pinned_id(s >> 2) {
    pinned = philox4x32_10(
        make_uint4(chain, step, static_cast<uint32_t>(pinned_id), 0u), k0, k1);
  }

  __device__ __forceinline__ float uniform(int s) {
    if ((s >> 2) == pinned_id) return uniform_from_bits(lane_of(pinned, s & 3));
    return cache.uniform(s);
  }
};

// A cursor over consecutive Philox blocks of one chain and step: it starts
// at lane 0 of block `first` and hands out one uniform per lane, fetching
// the next block after lane 3.  A normal pair is Box-Muller on the next two
// uniforms.  The kernels give every use (a proposal, a simulation, a
// gradient replicate) its own block range, so no draw shifts another.
// `paired` marks a simulator cursor that re-reads its proposal's blocks
// (a program may then take the sin branch of the proposal's pairs).  The
// torch twin is ops/kernels/philox.py's Draws.
struct Draws {
  uint32_t chain, step, k0, k1, block;
  int lane;
  uint4 cur;
  bool paired;

  __device__ __forceinline__ Draws(uint32_t chain_, uint32_t step_,
                                   uint32_t k0_, uint32_t k1_,
                                   uint32_t first, bool paired_ = false)
      : chain(chain_), step(step_), k0(k0_), k1(k1_), block(first), lane(4),
        cur(make_uint4(0u, 0u, 0u, 0u)), paired(paired_) {}

  __device__ __forceinline__ float uniform() {
    if (lane == 4) {
      cur = philox4x32_10(make_uint4(chain, step, block, 0u), k0, k1);
      ++block;
      lane = 0;
    }
    return uniform_from_bits(lane_of(cur, lane++));
  }

  __device__ __forceinline__ void normal_pair(float* n1, float* n2) {
    const float u1 = uniform();
    const float u2 = uniform();
    glabc::normal_pair(u1, u2, n1, n2);
  }
};

}  // namespace glabc

#endif  // GLABC_PHILOX_CUH
