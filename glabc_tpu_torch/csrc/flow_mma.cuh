// Tensor-core and copy helpers of the coupling-flow kernels
// (coupling_flow.cu, coupling_flow_bf16.cu, coupling_flow_wide.cu).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace glabc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo: hi its TF32 rounding (the low 13 bits cleared, so that
// x - hi is exact), lo the TF32 rounding of the remainder
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x) & 0xffffe000u;
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a b on one m16n8k8 tile: TF32 operands, float32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the three split products of one k-tile into c: lo hi, hi lo, hi hi (the
// small terms first); the B fragment {hi(k), hi(k + 4), lo(k), lo(k + 4)}
// as one 16-byte load
template <int MT>
__device__ __forceinline__ void mma3(float (&c)[MT][4],
                                     const uint32_t (&hi)[MT][4],
                                     const uint32_t (&lo)[MT][4],
                                     const float4 b) {
  const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
  const uint32_t bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) mma_tf32(c[mt], lo[mt], bh0, bh1);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) mma_tf32(c[mt], hi[mt], bl0, bl1);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) mma_tf32(c[mt], hi[mt], bh0, bh1);
}

// relu of two floats, rounded to bf16 (to nearest even) in one
// conversion, lo in the low half: the rounding of relu(x) is relu of the
// rounding
__device__ __forceinline__ uint32_t pack_relu_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// c += a b on one m16n8k16 tile: bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace glabc
