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

// Box-Muller: both the cos and the sin branch are used.
__device__ __forceinline__ void normal_pair(float u1, float u2, float* n1,
                                            float* n2) {
  const float r = sqrtf(-2.0f * logf(u1));
  const float a = kTwoPi * u2;
  *n1 = r * cosf(a);
  *n2 = r * sinf(a);
}

__device__ __forceinline__ uint32_t lane_of(uint4 v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

}  // namespace glabc
