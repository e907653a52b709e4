// The whole L-layer affine coupling flow in one launch, in float32, with the
// conditioner's products on the tensor cores: base -> data (push) or data ->
// base (pull), with the summed log-scale of every row.
//
// Replaces glabc_tpu/ops/pallas/flow_kernel.py FusedCouplingFlow._push_kernel
// (:149), _pull_kernel (:164), their layer body _layer (:103) and the
// pallas_call (:204) with matmul_dtype='float32' (K7).  The plain torch
// version is CouplingFlow.push_t / pull_t (glabc_tpu_torch/models/flows.py)
// under no_grad, on per-layer float32 matmuls.
//
// Per row and layer the conditioner [d1, H, H, 2 d2] with ReLU needs
// d1 H + H^2 + 2 d2 H multiply-adds, of which the H x H product
// h1 = relu(h0 w1 + b1) is 16,384 of 16,768 at d=2, H=128.  The products
// h0 = u1 w0 and h0 w1 run on the tensor cores as 3xTF32 splits (CUTLASS's
// "fast accurate fp32"): x = hi + lo with hi = tf32(x) and lo =
// tf32(x - hi), both rounded to nearest with ties away from zero
// (cvt.rna), and
//     x y = lo(x) hi(y) + hi(x) lo(y) + hi(x) hi(y),
// the small terms first, accumulated in float32 by
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32.  The dropped lo lo term and
// the roundings leave about 2^-21 of each product, the order of float32
// rounding: a float32 flow, not a TF32 one (one TF32 product alone keeps 10
// mantissa bits).  Biases, ReLUs, ts = h1 w2, exp(+-s), the affine update
// and the log-scale sum run on the FP32 lanes in float32.  Kernel and plain
// version sum in other orders, so they agree to 1e-4 relative at 32 layers
// (chip_smoke.py states the limit), not bitwise; on integer-valued weights
// every product and sum is exact and they agree bit for bit.
//
// What bounds it on an H100 SXM at 700 W, at the NF pool push (32,768,000
// rows, 32 layers x 128, d=2): 3 x 2 x 1.718e13 = 1.03e14 tensor-core FLOPs
// over 495e12 TF32 FLOP/s (the wgmma peak) = 208 ms, and mma.sync, used
// here, issues below that peak.  On the FP32 lanes the split, the biases,
// ReLUs, ts and the epilogue, about 1.3e3 operations per row and layer,
// 40 ms; 0.66 GB of rows and weights over 3.35 TB/s, 0.2 ms.  The tensor
// cores bind (all products on the FP32 lanes: 526 ms).  So:
//
//   * nothing but x and out/s touches device memory: a block's rows keep
//     their coordinates u (d x RB) and log-scale sums in shared memory for
//     the whole launch;
//   * layers are the outer loop.  Each layer's weights are one image
//     (pack_tf32_weights: the B fragments of w1 and w0, hi and lo, in
//     fragment order, then b0, b1, w2 and b2 in float32), about 142 KB at
//     H=128, copied by cp.async into one buffer between two __syncthreads;
//     a warp walks up to nsub tiles per layer, so the refill is paid once
//     for many tiles;
//   * a warp owns its tiles of 32 rows (two m16 tiles; 16 rows, one m16
//     tile, where few rows must be spread over many warps) outright and
//     keeps the accumulators of the whole padded hidden width in registers,
//     HP a thread at 32 rows.  k is the outer loop; per k-tile of 8:
//       1. h0 at the k-tile's 8 hidden units by three MMAs on u1's split A
//          fragments (loaded once per tile), + b0, ReLU and split: the C
//          fragment lands in place as the A fragment of h0 w1, because the
//          image orders w1's rows to match (k slots t, t + 4 = units
//          8 kt + 2 t, + 1).  h0 is never stored;
//       2. per n-tile one conflict-free 16-byte load brings this lane's B
//          fragments, {hi, lo} of w1, which feed 3 MMAs per m-tile, the
//          three products in turn over chunks of n-tiles so that an
//          accumulator's next MMA comes several MMAs after its last;
//   * then b1 and ReLU on the accumulators, ts = h1 w2 + b2 on the FP32
//     lanes (each lane's partial sums over its own columns, two shuffles
//     add the quad; the image interleaves w2's t and s columns so that
//     every register index is a constant), and the epilogue, one lane per
//     row: exp(+-s), the affine update of the d2 transformed coordinates,
//     the roll by d2, s summed into the row;
//   * what does not change during the launch sits in the kernel's
//     parameters and the layer counter in shared memory, so that the MMA
//     loop has every register (ptxas -v, sm_90a: 254 registers a thread at
//     HP=128 with 32-row tiles, 179 with 16-row tiles, no spills).
//
// Layouts: rows fastest, as the port's state tensors: x_in / x_out (d, N),
// s_out (N,); the weights (L, layer floats) as pack_tf32_weights writes
// them.  H is a multiple of 8 up to 128, zero-padded to HP in
// {32, 64, 96, 128} (a zero unit adds exactly 0), one instantiation per HP,
// tile height and direction with the n loops unrolled whole.  d <= 17; N
// need not be a multiple of anything: the last block masks its tail.
// wgmma, TMA and warp specialisation are not used here.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "flow_mma.cuh"

namespace glabc {

constexpr int kMaxWarps = 8;
constexpr int kMaxD = 17;       // 2 * (d / 2) <= 16
constexpr int kMaxD1 = 9;
constexpr int kMaxTs = 16;      // 2 d2, and the length of b2 in the image

// float offsets inside one layer's image (ops/kernels/flow_kernel.py
// pack_tf32_weights writes the same order): the B fragments of w1 (HP/8
// k-tiles) and of w0 (nk0 = ceil(d1 / 8) k-tiles), hi and lo, then b0 and
// b1 (HP), w2 (HP, ldw2) and b2 (16) with the t and s columns interleaved
struct LayerImage {
  int w1, w0, b0, b1, w2, b2, ldw2, nk0, floats;
};

__host__ __device__ inline LayerImage layer_image(int d, int HP) {
  const int d2 = d / 2, d1 = d - d2;
  LayerImage o;
  o.ldw2 = (2 * d2 + 3) & ~3;
  o.nk0 = (d1 + 7) / 8;
  o.w1 = 0;
  o.w0 = 2 * HP * HP;
  o.b0 = o.w0 + o.nk0 * 8 * HP * 2;
  o.b1 = o.b0 + HP;
  o.w2 = o.b1 + HP;
  o.b2 = o.w2 + HP * o.ldw2;
  o.floats = o.b2 + kMaxTs;
  return o;
}

// Everything a block needs that does not change during the launch, in the
// kernel's parameters: the kernel reads them from the constant bank where
// it needs them, so that they hold no register across the MMA loop.
struct FlowArgs {
  const float* x_in;
  float* x_out;
  float* s_out;
  const float* w;  // (L, layer floats)
  int N, L;
  int d, d1, d2, ts;     // coordinates, u1's and v2's, and 2 d2
  int warps, RB;         // warps and rows per block
  LayerImage img;
};

// the layer image, u (d x RB), s (RB) and the layer counter (padded to 4)
__host__ __device__ inline size_t flow_smem(int d, int HP, int warps,
                                            int nsub, int tile_rows) {
  const size_t rb = static_cast<size_t>(warps) * nsub * tile_rows;
  return (static_cast<size_t>(layer_image(d, HP).floats) +
          static_cast<size_t>(d + 1) * rb + 4) *
         sizeof(float);
}

// the lane's and the block's index, read where they are used (a volatile
// read is not hoisted out of the loops, so it holds no register there)
__device__ __forceinline__ int lane_id() {
  int r;
  asm volatile("mov.u32 %0, %%laneid;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ int block_id() {
  int r;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(r));
  return r;
}

// MT m16 tiles per warp tile: 2 (32 rows) where there are rows enough to
// fill the card, 1 (16 rows) to spread few rows over more warps
template <bool kInverse, int HP, int MT>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    coupling_flow_kernel(const FlowArgs a) {
  constexpr int NT = HP / 8;               // n-tiles, and k-tiles
  constexpr int kTileRows = 16 * MT;
  // n-tiles whose B fragments are in flight: an accumulator's next MMA is
  // kChunk MT MMAs behind its last
  constexpr int kChunk = MT == 2 ? 2 : 4;
  extern __shared__ __align__(16) float smem[];
  const float* const W1 = smem + a.img.w1;
  const float* const W0 = smem + a.img.w0;
  const float* const B0 = smem + a.img.b0;
  const float* const B1 = smem + a.img.b1;
  const float* const W2 = smem + a.img.w2;
  const float* const B2 = smem + a.img.b2;
  float* const U = smem + a.img.floats;
  float* const S = U + a.d * a.RB;
  int* const layer = reinterpret_cast<int*>(S + a.RB);
  const size_t N = static_cast<size_t>(a.N);
  // the conditioner reads u1: rows [0, d1) in the u layout (push), rows
  // [d2, d2 + d1) in the rolled [v2; u1] layout (pull)
  const int in_off = kInverse ? a.d2 : 0;

  int tiles;  // the block's tiles with rows in them
  {
    const size_t row0 = static_cast<size_t>(block_id()) * a.RB;
    const int nrows = static_cast<int>(
        N - row0 < static_cast<size_t>(a.RB) ? N - row0 : a.RB);
    tiles = (nrows + kTileRows - 1) / kTileRows;
    for (int f = 0; f < a.d; ++f)
      for (int r = threadIdx.x; r < a.RB; r += blockDim.x)
        U[f * a.RB + r] = r < nrows ? a.x_in[f * N + row0 + r] : 0.0f;
    for (int r = threadIdx.x; r < a.RB; r += blockDim.x) S[r] = 0.0f;
    if (threadIdx.x == 0) *layer = 0;
  }

  // Layers are the outer loop.  Their counter lives in shared memory: the
  // MMA loop needs every register, and a counter held across it would be
  // spilled.
  for (;;) {
    __syncthreads();  // every warp is done with the previous layer
    const int step = *reinterpret_cast<volatile int*>(layer);
    if (step >= a.L) break;
    {
      const int l = kInverse ? a.L - 1 - step : step;
      const float* src = a.w + static_cast<unsigned>(l * a.img.floats);
      const uint32_t dst = smem_addr(smem);
      for (int i = threadIdx.x; i < a.img.floats / 4; i += blockDim.x)
        cp_async16(dst + 16 * i, src + 4 * i);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    __syncthreads();  // this layer's weights are in; the counter was read
    if (threadIdx.x == 0) *layer = step + 1;

    for (int tile = threadIdx.x / 32; tile < tiles; tile += a.warps) {
      const int rb = tile * kTileRows;
      const int lane = lane_id(), g = lane >> 2, t = lane & 3;

      // u1's A fragments of k-tile kk for h0 = u1 w0, split: tile rows
      // 16 mt + g (A registers 0, 2) and + 8 (1, 3), coordinates
      // k = 8 kk + t (0, 1) and + 4 (2, 3), zero from d1 on
      auto u1_frags = [&](int kk, uint32_t (&hi)[MT][4],
                          uint32_t (&lo)[MT][4]) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = 8 * kk + t + 4 * (e >> 1);
            const int row = rb + 16 * mt + 8 * (e & 1) + g;
            const float v = U[(in_off + (k < a.d1 ? k : 0)) * a.RB + row];
            split_tf32(k < a.d1 ? v : 0.0f, hi[mt][e], lo[mt][e]);
          }
      };
      uint32_t uhi[MT][4], ulo[MT][4];
      u1_frags(0, uhi, ulo);

      // h1 = h0 w1: k is the outer loop.  Per k-tile kt:
      //   1. h0 = relu(u1 w0 + b0) at the k-tile's hidden units on the
      //      tensor cores, three split products per k-tile of u1.  The C
      //      fragment (rows g, g + 8; units 8 kt + 2 t, + 1), + b0, ReLU and
      //      split, is in place as the A fragment of h0 w1 when the k slots
      //      t and t + 4 stand for units 8 kt + 2 t and + 1: the image packs
      //      w1's rows in that order.  h0 is never stored;
      //   2. chunks of kChunk n-tiles, whose B fragments ({hi, lo} of w1 at
      //      the two k slots and n = g: one 16-byte load a lane) feed 3 MT
      //      MMAs each.
      float acc[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
      const float4* const w0f = reinterpret_cast<const float4*>(W0) + lane;
      const float4* const w1f = reinterpret_cast<const float4*>(W1) + lane;
#pragma unroll 1
      for (int kt = 0; kt < NT; ++kt) {
        uint32_t ahi[MT][4], alo[MT][4];
        {
          float c[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) c[mt][e] = 0.0f;
          mma3<MT>(c, uhi, ulo, w0f[kt * 32]);
          if (a.img.nk0 > 1) {  // d1 = 9: u1's second k-tile
            uint32_t xhi[MT][4], xlo[MT][4];
            u1_frags(1, xhi, xlo);
            mma3<MT>(c, xhi, xlo, w0f[(NT + kt) * 32]);
          }
          const float2 b =
              *reinterpret_cast<const float2*>(B0 + 8 * kt + 2 * t);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            // C (row, unit): 0 (g, 2t), 1 (g, 2t+1), 2 (g+8, 2t),
            // 3 (g+8, 2t+1) -> A (row, k slot): 0 (g, t), 1 (g+8, t),
            // 2 (g, t+4), 3 (g+8, t+4)
            split_tf32(fmaxf(c[mt][0] + b.x, 0.0f), ahi[mt][0], alo[mt][0]);
            split_tf32(fmaxf(c[mt][2] + b.x, 0.0f), ahi[mt][1], alo[mt][1]);
            split_tf32(fmaxf(c[mt][1] + b.y, 0.0f), ahi[mt][2], alo[mt][2]);
            split_tf32(fmaxf(c[mt][3] + b.y, 0.0f), ahi[mt][3], alo[mt][3]);
          }
        }
#pragma unroll
        for (int n0 = 0; n0 < NT; n0 += kChunk) {
          float4 b[kChunk];
#pragma unroll
          for (int j = 0; j < kChunk; ++j) b[j] = w1f[(kt * NT + n0 + j) * 32];
          // the three products in turn over the chunk (lo hi, hi lo, hi hi:
          // the small terms first)
#pragma unroll
          for (int j = 0; j < kChunk; ++j)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_tf32(acc[mt][n0 + j], alo[mt], __float_as_uint(b[j].x),
                       __float_as_uint(b[j].y));
#pragma unroll
          for (int j = 0; j < kChunk; ++j)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_tf32(acc[mt][n0 + j], ahi[mt], __float_as_uint(b[j].z),
                       __float_as_uint(b[j].w));
#pragma unroll
          for (int j = 0; j < kChunk; ++j)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_tf32(acc[mt][n0 + j], ahi[mt], __float_as_uint(b[j].x),
                       __float_as_uint(b[j].y));
        }
      }

      // 3. h1 = relu(acc + b1) and ts = h1 w2 over this lane's columns
      //    8 nt + 2 t and + 1, the quad's sums by shuffles; `mine` keeps
      //    the ts of the lane's own row, columns t_j, s_j at 2 j, 2 j + 1
      const int lane2 = lane_id(), t2 = lane2 & 3;
      // the tile row whose epilogue this lane runs: row g or g + 8 of m-tile
      // t >> 1, so that the four lanes of a quad cover their rows of the
      // m-tiles (with MT = 1 the lanes t >> 1 = 1 have none)
      const int emt = t2 >> 1;
      float mine[kMaxTs];
#pragma unroll
      for (int m = 0; m < kMaxTs; ++m) mine[m] = 0.0f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float p[2][kMaxTs];  // rows g, g + 8 of m-tile mt
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int m = 0; m < kMaxTs; ++m) p[hr][m] = 0.0f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float2 b =
              *reinterpret_cast<const float2*>(B1 + 8 * nt + 2 * t2);
          acc[mt][nt][0] = fmaxf(acc[mt][nt][0] + b.x, 0.0f);
          acc[mt][nt][1] = fmaxf(acc[mt][nt][1] + b.y, 0.0f);
          acc[mt][nt][2] = fmaxf(acc[mt][nt][2] + b.x, 0.0f);
          acc[mt][nt][3] = fmaxf(acc[mt][nt][3] + b.y, 0.0f);
        }
        // the columns of ts four at a time, as many groups as ts needs
#pragma unroll
        for (int m4 = 0; m4 < kMaxTs / 4; ++m4) {
          if (4 * m4 < a.ts) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const float* const wa =
                  W2 + (8 * nt + 2 * t2) * a.img.ldw2 + 4 * m4;
              const float4 x4 = *reinterpret_cast<const float4*>(wa);
              const float4 y4 =
                  *reinterpret_cast<const float4*>(wa + a.img.ldw2);
              const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
              const float ys[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int hr = 0; hr < 2; ++hr)
                  p[hr][4 * m4 + i] = fmaf(
                      acc[mt][nt][2 * hr + 1], ys[i],
                      fmaf(acc[mt][nt][2 * hr], xs[i], p[hr][4 * m4 + i]));
            }
          }
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int m = 0; m < kMaxTs; ++m) {
            if (m < a.ts) {
              p[hr][m] += __shfl_xor_sync(0xffffffffu, p[hr][m], 1);
              p[hr][m] += __shfl_xor_sync(0xffffffffu, p[hr][m], 2);
            }
          }
        if (emt == mt) {
#pragma unroll
          for (int m = 0; m < kMaxTs; ++m)
            mine[m] = (t2 & 1) ? p[1][m] : p[0][m];
        }
      }
      __syncwarp();  // every lane has read its u1 rows

      // 4. the epilogue, one lane per row: every new value is read before
      //    any is written (register arrays indexed by unrolled constants)
      if (emt < MT) {
        const int r = rb + 16 * emt + 8 * (t2 & 1) + (lane2 >> 2);
        const int d1 = a.d1, d2 = a.d2;
        float v2[kMaxTs / 2], keep[kMaxD1];
        float s_sum = 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxTs / 2; ++j) {
          if (j < d2) {
            const float tj = mine[2 * j] + B2[2 * j];
            const float sj = mine[2 * j + 1] + B2[2 * j + 1];
            // push: [u1; u2] -> [u2 exp(s) + t; u1]
            // pull: [v2; u1] -> [u1; (v2 - t) exp(-s)]
            v2[j] = kInverse ? (U[j * a.RB + r] - tj) * expf(-sj)
                             : U[(d1 + j) * a.RB + r] * expf(sj) + tj;
            s_sum = j == 0 ? sj : s_sum + sj;
          }
        }
#pragma unroll
        for (int j = 0; j < kMaxD1; ++j)
          if (j < d1) keep[j] = U[((kInverse ? d2 : 0) + j) * a.RB + r];
#pragma unroll
        for (int j = 0; j < kMaxTs / 2; ++j)
          if (j < d2) U[((kInverse ? d1 : 0) + j) * a.RB + r] = v2[j];
#pragma unroll
        for (int j = 0; j < kMaxD1; ++j)
          if (j < d1) U[((kInverse ? 0 : d2) + j) * a.RB + r] = keep[j];
        S[r] += s_sum;
      }
      __syncwarp();  // the tile's rows are done
    }
  }
  {
    const size_t row0 = static_cast<size_t>(block_id()) * a.RB;
    const int nrows = static_cast<int>(
        N - row0 < static_cast<size_t>(a.RB) ? N - row0 : a.RB);
    for (int f = 0; f < a.d; ++f)
      for (int r = threadIdx.x; r < nrows; r += blockDim.x)
        a.x_out[f * N + row0 + r] = U[f * a.RB + r];
    for (int r = threadIdx.x; r < nrows; r += blockDim.x)
      a.s_out[row0 + r] = S[r];
  }
}

// one direction's kernel for the padded width HP, after opting in to its
// shared memory
template <int HP, int MT>
static int launch_flow(const FlowArgs& a, int inverse, dim3 grid, int warps,
                       size_t smem, cudaStream_t s) {
  cudaError_t err;
  if (inverse) {
    err = cudaFuncSetAttribute(coupling_flow_kernel<true, HP, MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    coupling_flow_kernel<true, HP, MT><<<grid, warps * 32, smem, s>>>(a);
  } else {
    err = cudaFuncSetAttribute(coupling_flow_kernel<false, HP, MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    coupling_flow_kernel<false, HP, MT><<<grid, warps * 32, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
static int launch_width(const FlowArgs& a, int HP, int inverse, dim3 grid,
                        int warps, size_t smem, cudaStream_t s) {
  switch (HP) {
    case 32: return launch_flow<32, MT>(a, inverse, grid, warps, smem, s);
    case 64: return launch_flow<64, MT>(a, inverse, grid, warps, smem, s);
    case 96: return launch_flow<96, MT>(a, inverse, grid, warps, smem, s);
    default: return launch_flow<128, MT>(a, inverse, grid, warps, smem, s);
  }
}

}  // namespace glabc

// Largest number of tiles of tile_rows rows per warp that the shared memory
// allows for `warps` warps per block, 0 when even one does not fit.
extern "C" int glabc_coupling_flow_max_sub(int d, int HP, int warps,
                                           int tile_rows) {
  using namespace glabc;
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  const size_t fixed = flow_smem(d, HP, warps, 0, tile_rows);
  if (fixed >= static_cast<size_t>(limit)) return 0;
  const size_t per_sub =
      static_cast<size_t>(d + 1) * warps * tile_rows * sizeof(float);
  return static_cast<int>((static_cast<size_t>(limit) - fixed) / per_sub);
}

extern "C" int glabc_coupling_flow(const float* x_in, float* x_out,
                                   float* s_out, const void* w, int d, int N,
                                   int L, int HP, int inverse, int warps,
                                   int nsub, int tile_rows, void* stream) {
  using namespace glabc;
  if (d < 2 || d > kMaxD || (HP != 32 && HP != 64 && HP != 96 && HP != 128) ||
      (tile_rows != 16 && tile_rows != 32) || warps < 1 ||
      warps > kMaxWarps || nsub < 1 || N < 1 || L < 1)
    return -1;
  const int rb = warps * nsub * tile_rows;
  const FlowArgs a{x_in, x_out, s_out, static_cast<const float*>(w), N, L,
                   d, d - d / 2, d / 2, 2 * (d / 2), warps, rb,
                   layer_image(d, HP)};
  const size_t smem = flow_smem(d, HP, warps, nsub, tile_rows);
  const dim3 grid(static_cast<unsigned>((static_cast<size_t>(N) + rb - 1) /
                                        rb));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tile_rows == 32
             ? launch_width<2>(a, HP, inverse, grid, warps, smem, s)
             : launch_width<1>(a, HP, inverse, grid, warps, smem, s);
}
