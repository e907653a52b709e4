// The whole L-layer affine coupling flow in one launch at the shapes the
// weight-resident kernels do not take: hidden widths above 128 (up to 512)
// or dims above 17 (up to 64), in float32 (3xTF32 products) or with bf16
// product operands.  base -> data (push) or data -> base (pull), with the
// summed log-scale of every row.
//
// Replaces glabc_tpu/ops/pallas/flow_kernel.py FusedCouplingFlow
// _push_kernel (:149), _pull_kernel (:164), their layer body _layer (:103)
// and the pallas_call (:204), with matmul_dtype='float32' (K7) and
// 'bfloat16' (K7-bf16), at every (dim, hidden) that coupling_flow.cu and
// coupling_flow_bf16.cu refuse: the JAX kernel asserts nothing on either.
// The plain torch version is CouplingFlow.push_t / pull_t
// (glabc_tpu_torch/models/flows.py) under no_grad with the same
// matmul_dtype.  Widths up to 128 at dims up to 17 keep those kernels.
//
// Per row and layer the conditioner [d1, H, H, 2 d2] with ReLU; the H x H
// product h1 = relu(h0 w1 + b1) is most of it (262,144 of 272,384
// multiply-adds at H=512, d=64).  What bounds it on an H100 SXM: at the
// float32 flow, the three split TF32 products, 6 H^2 FLOPs a row and layer
// over 495 TFLOP/s; at bf16, 2 H^2 over 989 TFLOP/s; the rows (4 (2 d + 1)
// bytes each) and the weights (read from L2 once per block and layer) are
// far below that.  The weight-resident kernels keep a whole layer's image
// in shared memory; at H=256 the float32 layer's split w1 alone is 512 KB,
// and the bf16 layer 128 KB, past what a ring of layers can hold in the
// 227 KB of a block.  So here:
//
//   * a block's rows keep their coordinates u (d x RB), log-scale sums and
//     the running ts = h1 w2 (2 d2 padded to 16, x RB) in shared memory for
//     the whole launch; nothing but x and out/s touches device memory
//     besides the weights;
//   * the hidden units are walked in chunks of 64 (kNC), and each chunk's
//     K = H rows of w1 in slices of 32 (kKS).  Each slice is one
//     contiguous piece of the layer's image (pack_wide_weights): the B
//     fragments of w1 for its 32 K-rows x 64 columns, w0 for the 32 hidden
//     units of h0 that are its K-rows (float32: B fragments; bf16: d1 x 32
//     bf16-rounded floats), and their 32 b0.
//     The block streams the slices through a ring of two shared-memory
//     buffers with cp.async: slice i + 1 is in flight while the warps
//     multiply slice i, one __syncthreads between;
//   * a warp owns one tile of 32 rows (two m16 tiles) or, where few rows
//     must be spread over many warps, 16 rows, and keeps the chunk's 64
//     accumulators a row in registers (64 a thread at 32 rows).  Per
//     k-step of the slice, h0 at the k-step's hidden units (u1 read from
//     shared memory), + b0 and ReLU, lands in place as the A fragment of
//     h0 w1: float32 by three split MMAs a k8 step of u1 (d1 up to 32),
//     the C fragment split into hi and lo (the image orders w1's K-rows to
//     match, as coupling_flow.cu does); bf16 on the FP32 lanes, term by
//     term in ascending order as coupling_flow_bf16.cu does (the plain
//     float32 matmul's order), rounded into m16n8k16's A layout, which
//     is two C tiles side by side.  h0 is never stored; it is made again
//     for each chunk.  A slice's products sum into a partial from zero,
//     added to the accumulators with float32 adds (the tensor cores' own
//     additions drop the low bits of a small term added to a large sum);
//   * at a chunk's end: b1 and ReLU on the accumulators (then the bf16
//     rounding), ts += h1 w2 over the chunk's 64 units on the FP32 lanes
//     (w2 and b1 from L2), 16 columns of ts at a time, the quad's sums by
//     shuffles, added into the row's ts in shared memory by the lane that
//     owns the row; at the layer's last chunk that lane runs the
//     epilogue: exp(+-s), the affine update, the roll by d2 (the new
//     coordinates through the ts buffer, so that every value is read
//     before it is written) and s summed into the row.
//
// The products: float32 as coupling_flow.cu, x = hi + lo in TF32 pieces
// (cvt.rna), x y = lo(x) hi(y) + hi(x) lo(y) + hi(x) hi(y) by
// mma.sync.m16n8k8 tf32 with float32 accumulators, ts on the FP32 lanes in
// float32; bf16: operands rounded to nearest even (u1, h0, w0, w1, h1, w2),
// h1 = h0 w1 by mma.sync.m16n8k16 with float32 accumulators, h0 and ts on
// the FP32 lanes (each product exact in float32).  Kernel and plain
// version sum in other orders: within chip_smoke.py's limits, not bitwise;
// on integer-valued weights every product and sum is exact and they agree
// bit for bit.
//
// Layouts: rows fastest, as the port's state tensors: x_in / x_out (d, N),
// s_out (N,); the weights (L, layer floats) as pack_wide_weights writes
// them (wide_image below).  2 <= d <= 64, 1 <= H <= 512 zero-padded to a
// multiple of 64 (a zero unit adds exactly 0); N need not be a multiple of
// anything: the last block masks its tail.  One instantiation per
// direction, tile height and product type.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "flow_mma.cuh"

namespace glabc {

constexpr int kWideWarps = 8;
constexpr int kNC = 64;        // hidden units (columns of w1) a chunk
constexpr int kKS = 32;        // K-rows of w1 a slice
constexpr int kWideMaxD = 64;
constexpr int kWideMaxH = 512;

// float offsets inside one layer's image (ops/kernels/flow_kernel.py
// wide_layout and pack_wide_weights write the same): slices (chunk c,
// k-slice q) in the order c HP / 32 + q, each [w1 fragments | w0 | b0
// (32)], then b1 (HP), w2 (HP, tsp) and b2 (tsp) with the t and s columns
// interleaved; nk: u1's k8 steps (float32)
struct WideImage {
  int HP, nk, w0, sf, slices, b1, w2, b2, tsp, floats;
};

__host__ __device__ inline WideImage wide_image(int d, int H, bool bf16) {
  const int d2 = d / 2, d1 = d - d2;
  WideImage o;
  o.HP = (H + kNC - 1) / kNC * kNC;
  o.nk = (d1 + 7) / 8;
  o.tsp = (2 * d2 + 15) / 16 * 16;
  // w1: float32 4 k8-tiles x 8 n-tiles x 32 lanes x {hi, hi, lo, lo};
  // bf16 2 k16-steps x 8 n-tiles x 32 lanes x 2 words of 2 bf16
  o.w0 = bf16 ? 1024 : 4096;
  // w0: float32 4 n-tiles x nk x 32 lanes x 4; bf16 d1 x 32 floats
  o.sf = o.w0 + (bf16 ? 32 * d1 : 512 * o.nk) + 32;
  o.slices = (o.HP / kNC) * (o.HP / kKS);
  o.b1 = o.slices * o.sf;
  o.w2 = o.b1 + o.HP;
  o.b2 = o.w2 + o.HP * o.tsp;
  o.floats = o.b2 + o.tsp;
  return o;
}

struct WideArgs {
  const float* x_in;
  float* x_out;
  float* s_out;
  const float* w;  // (L, layer floats)
  int N, L;
  int d, d1, d2;
  int warps, RB;   // warps and rows per block
  WideImage img;
};

// the slice ring, u (d x RB), s (RB) and ts (tsp x RB)
__host__ __device__ inline size_t wide_smem(int d, int H, bool bf16,
                                            int warps, int tile_rows) {
  const WideImage img = wide_image(d, H, bf16);
  const size_t rb = static_cast<size_t>(warps) * tile_rows;
  return (2 * static_cast<size_t>(img.sf) +
          static_cast<size_t>(d + 1 + img.tsp) * rb) *
         sizeof(float);
}

// two floats rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __uint_as_float(pack_bf16(x, 0.0f) << 16);
}

// MT m16 tiles a warp tile: 2 (32 rows) where there are rows enough to fill
// the card, 1 (16 rows) to spread few rows over more warps
template <bool kInverse, int MT, bool kBf16>
__global__ void __launch_bounds__(kWideWarps * 32, 1)
    coupling_flow_wide_kernel(const WideArgs a) {
  constexpr int NT = kNC / 8;  // n-tiles of a chunk
  constexpr int kTileRows = 16 * MT;
  // float32: n-tiles whose B fragments are in flight, as coupling_flow.cu
  constexpr int kChunk = MT == 2 ? 2 : 4;
  extern __shared__ __align__(16) float smem[];
  const WideImage& img = a.img;
  float* const U = smem + 2 * img.sf;
  float* const S = U + a.d * a.RB;
  float* const TS = S + a.RB;
  const size_t N = static_cast<size_t>(a.N);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * a.RB;
  const int nrows = static_cast<int>(
      N - row0 < static_cast<size_t>(a.RB) ? N - row0 : a.RB);
  const int rb = warp * kTileRows;  // the warp's tile
  const bool active = rb < nrows;   // the same for the whole warp
  // the row whose epilogue this lane runs: row g or g + 8 of m-tile t >> 1,
  // so that the four lanes of a quad cover their rows of the m-tiles (with
  // MT = 1 the lanes t >> 1 = 1 have none)
  const int emt = t >> 1;
  const int my_row = rb + 16 * emt + 8 * (t & 1) + g;
  // the conditioner reads u1: rows [0, d1) in the u layout (push), rows
  // [d2, d2 + d1) in the rolled [v2; u1] layout (pull)
  const int in_off = kInverse ? a.d2 : 0;

  for (int f = 0; f < a.d; ++f)
    for (int r = threadIdx.x; r < a.RB; r += blockDim.x)
      U[f * a.RB + r] = r < nrows ? a.x_in[f * N + row0 + r] : 0.0f;
  for (int r = threadIdx.x; r < a.RB; r += blockDim.x) S[r] = 0.0f;

  const int nq = img.HP / kKS, nc = img.HP / kNC;
  const int per_layer = nq * nc, total = a.L * per_layer;
  const uint32_t ring = smem_addr(smem);
  // slice i of the launch (layer i / per_layer in the direction's order)
  // into ring buffer i % 2
  auto fetch = [&](int i) {
    const int step = i / per_layer, rem = i - step * per_layer;
    const int l = kInverse ? a.L - 1 - step : step;
    const float* const src = a.w + static_cast<size_t>(l) * img.floats +
                             static_cast<size_t>(rem) * img.sf;
    const uint32_t dst = ring + static_cast<uint32_t>((i & 1) * img.sf * 4);
    for (int k = threadIdx.x; k < img.sf / 4; k += blockDim.x)
      cp_async16(dst + 16 * k, src + 4 * k);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  fetch(0);

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

#pragma unroll 1
  for (int i = 0; i < total; ++i) {
    if (i + 1 < total) {
      fetch(i + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // slice i is in for every thread, and U is current
    const int step = i / per_layer, rem = i - step * per_layer;
    const int c = rem / nq, q = rem - c * nq;
    const float* const st = smem + (i & 1) * img.sf;
    if (active) {
      // the slice's products go into a partial sum from zero, which is
      // then added to the chunk's accumulators with float32 adds: the
      // tensor cores' own additions drop the low bits of a small term
      // added to a large sum, and over K = 512 rows the split's lo terms
      // were lost (on an H100 the float32 flow read 9.5e-6 from the plain
      // one at H = 512 so, 2.2e-6 with the partials)
      float part[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.0f;
      if constexpr (!kBf16) {
        // 4 k-tiles of 8: hidden units 32 q + 8 j .. + 7 of h0 are the
        // K-rows of w1 that k-tile j of the slice multiplies
        const float4* const W1s = reinterpret_cast<const float4*>(st) + lane;
        const float4* const W0s =
            reinterpret_cast<const float4*>(st + img.w0) + lane;
        const float* const B0s = st + img.sf - 32;
#pragma unroll 1
        for (int j = 0; j < 4; ++j) {
          uint32_t ahi[MT][4], alo[MT][4];
          {
            float c0[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int e = 0; e < 4; ++e) c0[mt][e] = 0.0f;
#pragma unroll 1
            for (int kk = 0; kk < img.nk; ++kk) {
              // u1's A fragments of k-tile kk, split: rows 16 mt + g
              // (registers 0, 2) and + 8 (1, 3), coordinates 8 kk + t
              // (0, 1) and + 4 (2, 3), zero from d1 on
              uint32_t uhi[MT][4], ulo[MT][4];
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int k = 8 * kk + t + 4 * (e >> 1);
                  const int row = rb + 16 * mt + 8 * (e & 1) + g;
                  const float v =
                      U[(in_off + (k < a.d1 ? k : 0)) * a.RB + row];
                  split_tf32(k < a.d1 ? v : 0.0f, uhi[mt][e], ulo[mt][e]);
                }
              mma3<MT>(c0, uhi, ulo, W0s[(j * img.nk + kk) * 32]);
            }
            const float2 b =
                *reinterpret_cast<const float2*>(B0s + 8 * j + 2 * t);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              // C (row, unit): 0 (g, 2t), 1 (g, 2t+1), 2 (g+8, 2t),
              // 3 (g+8, 2t+1) -> A (row, k slot): 0 (g, t), 1 (g+8, t),
              // 2 (g, t+4), 3 (g+8, t+4)
              split_tf32(fmaxf(c0[mt][0] + b.x, 0.0f), ahi[mt][0],
                         alo[mt][0]);
              split_tf32(fmaxf(c0[mt][2] + b.x, 0.0f), ahi[mt][1],
                         alo[mt][1]);
              split_tf32(fmaxf(c0[mt][1] + b.y, 0.0f), ahi[mt][2],
                         alo[mt][2]);
              split_tf32(fmaxf(c0[mt][3] + b.y, 0.0f), ahi[mt][3],
                         alo[mt][3]);
            }
          }
#pragma unroll
          for (int n0 = 0; n0 < NT; n0 += kChunk) {
            float4 bw[kChunk];
#pragma unroll
            for (int jj = 0; jj < kChunk; ++jj)
              bw[jj] = W1s[(j * NT + n0 + jj) * 32];
#pragma unroll
            for (int jj = 0; jj < kChunk; ++jj)
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
                mma_tf32(part[mt][n0 + jj], alo[mt],
                         __float_as_uint(bw[jj].x), __float_as_uint(bw[jj].y));
#pragma unroll
            for (int jj = 0; jj < kChunk; ++jj)
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
                mma_tf32(part[mt][n0 + jj], ahi[mt],
                         __float_as_uint(bw[jj].z), __float_as_uint(bw[jj].w));
#pragma unroll
            for (int jj = 0; jj < kChunk; ++jj)
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
                mma_tf32(part[mt][n0 + jj], ahi[mt],
                         __float_as_uint(bw[jj].x), __float_as_uint(bw[jj].y));
          }
        }
      } else {
        // 2 k-steps of 16: hidden units 32 q + 16 j .. + 15 of h0, two
        // n-tiles nh of 8, are the K-rows of w1 that k-step j multiplies.
        // h0 on the FP32 lanes, as coupling_flow_bf16.cu computes it: term
        // kk of the thread's units (16 j + 8 nh + 2 t, + 1) for its rows,
        // terms in ascending order, one fmaf each (a product of two bf16
        // values is exact in float32, so fmaf is the plain multiply and
        // add; with one term the bias joins the product in one rounding,
        // as the plain sum rounds it), straight into m16n8k16's A layout
        const uint2* const W1s = reinterpret_cast<const uint2*>(st) + lane;
        const float* const W0f = st + img.w0;  // (d1, 32): w0[kk, 32 q + i]
        const float* const B0s = st + img.sf - 32;
        const bool one = a.d1 == 1;
#pragma unroll 1
        for (int j = 0; j < 2; ++j) {
          uint32_t af[MT][4];
          {
            float2 b[2];
#pragma unroll
            for (int nh = 0; nh < 2; ++nh)
              b[nh] = *reinterpret_cast<const float2*>(B0s + 16 * j +
                                                       8 * nh + 2 * t);
            // [m-tile][n-tile][(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)]
            float h[MT][2][4];
#pragma unroll 1
            for (int kk = 0; kk < a.d1; ++kk) {
              float2 w[2];
#pragma unroll
              for (int nh = 0; nh < 2; ++nh)
                w[nh] = *reinterpret_cast<const float2*>(
                    W0f + kk * 32 + 16 * j + 8 * nh + 2 * t);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                const float* const u = U + (in_off + kk) * a.RB + rb + 16 * mt;
                const float ul = round_bf16(u[g]), uh = round_bf16(u[g + 8]);
#pragma unroll
                for (int nh = 0; nh < 2; ++nh) {
                  float* const x = h[mt][nh];
                  if (kk == 0) {
                    x[0] = fmaf(ul, w[nh].x, one ? b[nh].x : 0.0f);
                    x[1] = fmaf(ul, w[nh].y, one ? b[nh].y : 0.0f);
                    x[2] = fmaf(uh, w[nh].x, one ? b[nh].x : 0.0f);
                    x[3] = fmaf(uh, w[nh].y, one ? b[nh].y : 0.0f);
                  } else {
                    x[0] = fmaf(ul, w[nh].x, x[0]);
                    x[1] = fmaf(ul, w[nh].y, x[1]);
                    x[2] = fmaf(uh, w[nh].x, x[2]);
                    x[3] = fmaf(uh, w[nh].y, x[3]);
                  }
                }
              }
            }
            // n-tile nh's rows g and g + 8, + b0, ReLU and bf16: A
            // registers 2 nh (row g) and 2 nh + 1 (row g + 8)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int nh = 0; nh < 2; ++nh) {
                const float* const x = h[mt][nh];
                const float bx = b[nh].x, by = b[nh].y;
                af[mt][2 * nh] = pack_relu_bf16(one ? x[0] : x[0] + bx,
                                                one ? x[1] : x[1] + by);
                af[mt][2 * nh + 1] = pack_relu_bf16(one ? x[2] : x[2] + bx,
                                                    one ? x[3] : x[3] + by);
              }
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint2 b = W1s[(j * NT + nt) * 32];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_bf16(part[mt][nt], af[mt], b.x, b.y);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];

      if (q == nq - 1) {
        // the chunk's end: h1 = relu(acc + b1) (bf16-rounded for the bf16
        // flow), ts += h1 w2 over the chunk's units 64 c + 8 nt + 2 t, + 1
        const int l = kInverse ? a.L - 1 - step : step;
        const float* const lw = a.w + static_cast<size_t>(l) * img.floats;
        const float* const B1 = lw + img.b1 + c * kNC;
        const float* const W2 =
            lw + img.w2 + static_cast<size_t>(c) * kNC * img.tsp;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float2 b =
                __ldg(reinterpret_cast<const float2*>(B1 + 8 * nt + 2 * t));
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float h = fmaxf(acc[mt][nt][e] + ((e & 1) ? b.y : b.x), 0.0f);
              if constexpr (kBf16) h = round_bf16(h);
              acc[mt][nt][e] = h;
            }
          }
#pragma unroll 1
        for (int g16 = 0; g16 < img.tsp / 16; ++g16) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            float p[2][16];  // rows g, g + 8 of m-tile mt
#pragma unroll
            for (int hr = 0; hr < 2; ++hr)
#pragma unroll
              for (int m = 0; m < 16; ++m) p[hr][m] = 0.0f;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const float4* const wa = reinterpret_cast<const float4*>(
                  W2 + (8 * nt + 2 * t) * img.tsp + 16 * g16);
              const float4* const wb =
                  reinterpret_cast<const float4*>(
                      W2 + (8 * nt + 2 * t + 1) * img.tsp + 16 * g16);
#pragma unroll
              for (int v = 0; v < 4; ++v) {
                const float4 x4 = __ldg(wa + v), y4 = __ldg(wb + v);
                const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
                const float ys[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
                for (int i2 = 0; i2 < 4; ++i2)
#pragma unroll
                  for (int hr = 0; hr < 2; ++hr)
                    p[hr][4 * v + i2] =
                        fmaf(acc[mt][nt][2 * hr + 1], ys[i2],
                             fmaf(acc[mt][nt][2 * hr], xs[i2],
                                  p[hr][4 * v + i2]));
              }
            }
#pragma unroll
            for (int hr = 0; hr < 2; ++hr)
#pragma unroll
              for (int m = 0; m < 16; ++m) {
                p[hr][m] += __shfl_xor_sync(0xffffffffu, p[hr][m], 1);
                p[hr][m] += __shfl_xor_sync(0xffffffffu, p[hr][m], 2);
              }
            if (emt == mt) {
#pragma unroll
              for (int m = 0; m < 16; ++m) {
                float* const dst = TS + (16 * g16 + m) * a.RB + my_row;
                const float v = (t & 1) ? p[1][m] : p[0][m];
                *dst = c == 0 ? v : *dst + v;
              }
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

        if (c == nc - 1 && emt < MT) {
          // the layer's epilogue, one lane per row: the new coordinates
          // go through the row's ts slots (t_j's, read first), so that
          // every value is read before it is written
          //   push: [u1; u2] -> [u2 exp(s) + t; u1]
          //   pull: [v2; u1] -> [u1; (v2 - t) exp(-s)]
          const float* const B2 = lw + img.b2;
          const int r = my_row, RB = a.RB, d1 = a.d1, d2 = a.d2;
          float s_sum = 0.0f;
          for (int jj = 0; jj < d2; ++jj) {
            const float tj = TS[(2 * jj) * RB + r] + __ldg(B2 + 2 * jj);
            const float sj =
                TS[(2 * jj + 1) * RB + r] + __ldg(B2 + 2 * jj + 1);
            TS[(2 * jj) * RB + r] =
                kInverse ? (U[jj * RB + r] - tj) * expf(-sj)
                         : U[(d1 + jj) * RB + r] * expf(sj) + tj;
            s_sum = jj == 0 ? sj : s_sum + sj;
          }
          if (kInverse) {
            for (int jj = 0; jj < d1; ++jj)
              U[jj * RB + r] = U[(d2 + jj) * RB + r];
          } else {
            for (int jj = d1 - 1; jj >= 0; --jj)
              U[(d2 + jj) * RB + r] = U[jj * RB + r];
          }
          for (int jj = 0; jj < d2; ++jj)
            U[((kInverse ? d1 : 0) + jj) * RB + r] = TS[(2 * jj) * RB + r];
          S[r] += s_sum;
        }
      }
    }
    __syncthreads();  // every warp is done with slice i's buffer and U
  }

  for (int f = 0; f < a.d; ++f)
    for (int r = threadIdx.x; r < nrows; r += blockDim.x)
      a.x_out[f * N + row0 + r] = U[f * a.RB + r];
  for (int r = threadIdx.x; r < nrows; r += blockDim.x)
    a.s_out[row0 + r] = S[r];
}

template <bool kInverse, int MT, bool kBf16>
static int launch_wide(const WideArgs& a, dim3 grid, size_t smem,
                       cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      coupling_flow_wide_kernel<kInverse, MT, kBf16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  coupling_flow_wide_kernel<kInverse, MT, kBf16>
      <<<grid, a.warps * 32, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int MT, bool kBf16>
static int launch_dir(const WideArgs& a, int inverse, dim3 grid, size_t smem,
                      cudaStream_t s) {
  return inverse ? launch_wide<true, MT, kBf16>(a, grid, smem, s)
                 : launch_wide<false, MT, kBf16>(a, grid, smem, s);
}

}  // namespace glabc

// Floats of one layer's image for (d, H): what pack_wide_weights must give.
extern "C" int glabc_coupling_flow_wide_layer_floats(int d, int H, int bf16) {
  return glabc::wide_image(d, H, bf16 != 0).floats;
}

extern "C" int glabc_coupling_flow_wide(const float* x_in, float* x_out,
                                        float* s_out, const void* w, int d,
                                        int N, int L, int H, int inverse,
                                        int bf16, int warps, int tile_rows,
                                        void* stream) {
  using namespace glabc;
  if (d < 2 || d > kWideMaxD || H < 1 || H > kWideMaxH ||
      (tile_rows != 16 && tile_rows != 32) || warps < 1 ||
      warps > kWideWarps || N < 1 || L < 1)
    return -1;
  const int rb = warps * tile_rows;
  const WideArgs a{x_in, x_out, s_out, static_cast<const float*>(w),
                   N,    L,     d,     d - d / 2, d / 2, warps, rb,
                   wide_image(d, H, bf16 != 0)};
  const size_t smem = wide_smem(d, H, bf16 != 0, warps, tile_rows);
  const dim3 grid(static_cast<unsigned>((static_cast<size_t>(N) + rb - 1) /
                                        rb));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return tile_rows == 32 ? launch_dir<2, true>(a, inverse, grid, smem, s)
                           : launch_dir<1, true>(a, inverse, grid, smem, s);
  return tile_rows == 32 ? launch_dir<2, false>(a, inverse, grid, smem, s)
                         : launch_dir<1, false>(a, inverse, grid, smem, s);
}
