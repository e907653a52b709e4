// The whole L-layer affine coupling flow in one launch with bf16 product
// operands on the tensor cores: base -> data (push) or data -> base (pull),
// with the summed log-scale of every row.
//
// Replaces glabc_tpu/ops/pallas/flow_kernel.py FusedCouplingFlow with
// matmul_dtype='bfloat16': _push_kernel (:149), _pull_kernel (:164) and their
// layer body _layer (:103), weights cast by pack_flow_weights (:52) (K7-bf16).
// Per layer, on the row's current coordinates:
//   h0 = relu(bf16(u1) bf16(w0) + b0), h1 = relu(bf16(h0) bf16(w1) + b1),
//   ts = bf16(h1) bf16(w2) + b2,
// bf16() rounding to nearest even, every product accumulated in float32;
// biases, ReLU, exp(+-s), the affine update, the roll and the log-scale sum
// in float32, and the carried coordinates are never rounded.  The plain torch
// version is CouplingFlow.push_t / pull_t(matmul_dtype='bfloat16')
// (glabc_tpu_torch/models/flows.py).  The tensor cores add their products in
// another order than a float32 matmul, so an accumulator can differ in its
// last bit and, rarely, a bf16 rounding of h0 or h1 with it: kernel and plain
// version agree closely on almost every row, not bitwise (chip_smoke.py
// states the limit).
//
// What bounds it on an H100 SXM: per row and layer 2 H (H + 2 d2) tensor-core
// FLOPs (33,792 at H=128, d=2) against ~780 FP32-lane operations (h0 from
// d1 terms, the biases, ReLUs and bf16 conversions, the epilogue) and
// 4 (2 d + 1) bytes of input and output per row for the whole stack.  At
// 32.8M rows, 32 layers x 128: 3.5e13 FLOPs over 989 TFLOP/s dense bf16 =
// 35 ms, 8.2e11 operations over 33.5e12/s = 24 ms, 0.66 GB over 3.35 TB/s =
// 0.2 ms: the tensor cores bind, with the FP32 lanes close behind.  So:
//
//   * nothing but x and out/s touches device memory: a block's rows keep
//     their coordinates u (d x RB) and log-scale sums in shared memory for
//     the whole launch;
//   * layers are the outer loop.  Each layer's weights are one contiguous
//     image (pack_bf16_weights: w1 (H, H+8) and w2 (H, 24) in bf16, the row
//     pad keeps ldmatrix free of bank conflicts; w0 rounded to bf16 and the
//     biases in float32) copied with cp.async into one of two buffers while
//     the block computes the previous layer: one __syncthreads per layer;
//   * a warp owns 32-row tiles (two m16 tiles) outright, so within a layer it
//     needs only __syncwarp:
//       1. h0 on the FP32 lanes straight into m16n8k16 A fragments: each
//          thread computes the elements its fragments hold (rows gid, gid+8;
//          columns 2 tig, 2 tig + 1, + 8 of each k-tile) from bf16 u1 and w0,
//          terms in ascending order (a product of two bf16 values is exact in
//          float32, so fmaf equals the plain multiply and add), + b0, ReLU,
//          packed to bf16x2;
//       2. h1 = h0 w1 in chunks of 32 columns (16 where H / 16 is odd) by
//          mma.sync m16n8k16 (bf16 in, f32 accumulate): eight independent
//          accumulators per warp, B fragments by ldmatrix.trans from the
//          row-major (K x N) w1.  Each 16 columns' two C fragments, + b1,
//          ReLU and packed to bf16, are the A fragment of k-tile j of
//          ts = h1 w2, which runs at once: h1 never leaves the registers;
//       3. ts + b2 to a per-warp 32 x 17 scratch, one row per lane;
//       4. the epilogue, one lane per row: exp(+-s), the affine update of the
//          d2 transformed coordinates, the roll by d2, s summed into the row.
//
// Layouts: rows fastest, as the port's state tensors: x_in / x_out (d, N),
// s_out (N,); the weights (L, layer_bytes) as pack_bf16_weights writes them.
// d <= 17, H in {16, 32, ..., 128}, one instantiation per H / 16 (the k
// loops unroll whole); N need not be a multiple of anything.  wgmma, TMA and
// warp specialisation are not used here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace glabc {

constexpr int kTile = 32;       // rows per warp tile: two m16 MMA tiles
constexpr int kMaxWarps = 8;
constexpr int kMaxKT = 8;       // H / 16
constexpr int kMaxD = 17;       // 2 * (d / 2) <= 16
constexpr int kMaxD1 = 9;
constexpr int kMaxTs = 16;
constexpr int kLdw1Pad = 8;     // bf16 pad of a w1 row (kernel and wrapper)
constexpr int kLdw2 = 24;       // bf16 row of w2 (kernel and wrapper)
constexpr int kTsLd = 17;       // float row of the ts scratch

struct Bf16FlowArgs {
  const float* x_in;
  float* x_out;
  float* s_out;
  const unsigned char* w;  // (L, layer_bytes)
  int d, N, L, H, nsub;
};

// byte offsets inside one layer's image (ops/kernels/flow_kernel.py
// pack_bf16_weights writes the same order)
struct LayerImage {
  int w1, w2, w0, b0, b1, b2, bytes;
};

__host__ __device__ inline LayerImage layer_image(int d1, int H) {
  LayerImage o;
  o.w1 = 0;
  o.w2 = o.w1 + H * (H + kLdw1Pad) * 2;
  o.w0 = o.w2 + H * kLdw2 * 2;
  o.b0 = o.w0 + d1 * H * 4;
  o.b1 = o.b0 + H * 4;
  o.b2 = o.b1 + H * 4;
  o.bytes = o.b2 + kMaxTs * 4;
  return o;
}

// two layer buffers, the ts scratch of each warp, u (d x RB) and s (RB)
__host__ __device__ inline size_t bf16_flow_smem(int d, int H, int warps,
                                                 int nsub) {
  const int d1 = d - d / 2;
  const size_t rb = static_cast<size_t>(warps) * nsub * kTile;
  return 2 * static_cast<size_t>(layer_image(d1, H).bytes) +
         static_cast<size_t>(warps) * kTile * kTsLd * sizeof(float) +
         static_cast<size_t>(d + 1) * rb * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
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

// two floats rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool kInverse, int KT>
__global__ void __launch_bounds__(kMaxWarps * 32)
    coupling_flow_bf16_kernel(Bf16FlowArgs a) {
  constexpr int kCh = KT % 2 == 0 ? 2 : 1;  // 16-column groups per chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.H, d = a.d, d2 = d / 2, d1 = d - d2, ts = 2 * d2;
  const int warps = blockDim.x / 32;
  const int RB = warps * a.nsub * kTile;
  const LayerImage img = layer_image(d1, H);
  const int ldw1 = H + kLdw1Pad;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  float* const ts_all = reinterpret_cast<float*>(smem + 2 * img.bytes);
  float* const TS = ts_all + warp * kTile * kTsLd;
  float* const U = ts_all + warps * kTile * kTsLd;
  float* const S = U + d * RB;

  const size_t N = static_cast<size_t>(a.N);
  const size_t row0 = static_cast<size_t>(blockIdx.x) * RB;
  const int nrows = static_cast<int>(
      (N - row0) < static_cast<size_t>(RB) ? N - row0 : RB);

  // the layer `step` runs (layers reversed for pull) into buffer step & 1
  const int nchunks = img.bytes / 16;
  auto stage = [&](int step) {
    const int l = kInverse ? a.L - 1 - step : step;
    const unsigned char* src = a.w + static_cast<size_t>(l) * img.bytes;
    const uint32_t dst = smem_addr(smem + (step & 1) * img.bytes);
    for (int i = tid; i < nchunks; i += blockDim.x)
      cp_async16(dst + 16 * i, src + 16 * i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  stage(0);
  for (int i = tid; i < d * RB; i += blockDim.x) {
    const int f = i / RB, r = i - f * RB;
    U[i] = r < nrows ? a.x_in[f * N + row0 + r] : 0.0f;
  }
  for (int r = tid; r < RB; r += blockDim.x) S[r] = 0.0f;

  // the conditioner reads u1: rows [0, d1) in the u layout (push), rows
  // [d2, d2 + d1) in the rolled [v2; u1] layout (pull)
  const int in_off = kInverse ? d2 : 0;
  const int ntiles = warps * a.nsub;
  // ldmatrix.x4: lane -> a row of one of four 8x8 matrices, (k 0-7, n 0-7),
  // (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15) of a 16 x 16 block
  const int lm_k = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int lm_n = (lane >> 4) * 8;

  for (int step = 0; step < a.L; ++step) {
    // this layer's weights are in, and every warp is done with the other
    // buffer (the previous layer) and with the rows' initial load
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (step + 1 < a.L) stage(step + 1);
    const unsigned char* buf = smem + (step & 1) * img.bytes;
    const uint32_t w1s = smem_addr(buf + img.w1);
    const uint32_t w2s = smem_addr(buf + img.w2);
    const float* const W0 = reinterpret_cast<const float*>(buf + img.w0);
    const float* const B0 = reinterpret_cast<const float*>(buf + img.b0);
    const float* const B1 = reinterpret_cast<const float*>(buf + img.b1);
    const float* const B2 = reinterpret_cast<const float*>(buf + img.b2);

    for (int tile = warp; tile < ntiles; tile += warps) {
      const int rb = tile * kTile;
      if (rb >= nrows) break;  // the same for the whole warp

      // 1. h0 = relu(bf16(u1) bf16(w0) + b0) into the A fragments
      float u1[2][2][kMaxD1];  // [m-tile][row gid, gid + 8][term]
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int j = 0; j < kMaxD1; ++j)
            u1[mt][hr][j] =
                j < d1 ? round_bf16(U[(in_off + j) * RB + rb + mt * 16 +
                                      hr * 8 + gid])
                       : 0.0f;
      uint32_t af[2][KT][4];
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = 16 * kt + 8 * half + 2 * tig;
          float h[2][2][2];  // [m-tile][row][column c, c + 1]
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
            for (int j = 0; j < kMaxD1; ++j) {
              if (j < d1) {
                const float w = W0[j * H + c + cc];
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                  for (int hr = 0; hr < 2; ++hr)
                    acc[mt][hr] = fmaf(u1[mt][hr][j], w, acc[mt][hr]);
              }
            }
            const float b = B0[c + cc];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int hr = 0; hr < 2; ++hr)
                h[mt][hr][cc] = fmaxf(acc[mt][hr] + b, 0.0f);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            af[mt][kt][2 * half] = pack_bf16(h[mt][0][0], h[mt][0][1]);
            af[mt][kt][2 * half + 1] = pack_bf16(h[mt][1][0], h[mt][1][1]);
          }
        }
      }

      // 2. h1 = h0 w1 in chunks of 16 kCh columns, each 16 of them k-tile
      //    j + q of ts = h1 w2 at once
      float c2[2][2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) c2[mt][nt][e] = 0.0f;
      for (int j = 0; j < KT; j += kCh) {
        float c1[2][2 * kCh][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2 * kCh; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) c1[mt][nt][e] = 0.0f;
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          uint32_t b[kCh][4];
#pragma unroll
          for (int q = 0; q < kCh; ++q)
            ldmatrix_x4_trans(b[q], w1s + 2 * ((16 * kt + lm_k) * ldw1 +
                                               16 * (j + q) + lm_n));
#pragma unroll
          for (int q = 0; q < kCh; ++q)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_bf16(c1[mt][2 * q], af[mt][kt], b[q][0], b[q][1]);
              mma_bf16(c1[mt][2 * q + 1], af[mt][kt], b[q][2], b[q][3]);
            }
        }
#pragma unroll
        for (int q = 0; q < kCh; ++q) {
          uint32_t bw[4];
          ldmatrix_x4_trans(bw,
                            w2s + 2 * ((16 * (j + q) + lm_k) * kLdw2 + lm_n));
          const int c = 16 * (j + q) + 2 * tig;
          const float b1a = B1[c], b1b = B1[c + 1];
          const float b1c = B1[c + 8], b1d = B1[c + 9];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const uint32_t a2[4] = {
                pack_bf16(fmaxf(c1[mt][2 * q][0] + b1a, 0.0f),
                          fmaxf(c1[mt][2 * q][1] + b1b, 0.0f)),
                pack_bf16(fmaxf(c1[mt][2 * q][2] + b1a, 0.0f),
                          fmaxf(c1[mt][2 * q][3] + b1b, 0.0f)),
                pack_bf16(fmaxf(c1[mt][2 * q + 1][0] + b1c, 0.0f),
                          fmaxf(c1[mt][2 * q + 1][1] + b1d, 0.0f)),
                pack_bf16(fmaxf(c1[mt][2 * q + 1][2] + b1c, 0.0f),
                          fmaxf(c1[mt][2 * q + 1][3] + b1d, 0.0f))};
            mma_bf16(c2[mt][0], a2, bw[0], bw[1]);
            if (ts > 8) mma_bf16(c2[mt][1], a2, bw[2], bw[3]);
          }
        }
      }

      // 3. ts + b2 to the warp's scratch, row r of the tile in row r
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = 8 * nt + 2 * tig;
          float* const lo = TS + (mt * 16 + gid) * kTsLd + col;
          float* const hi = lo + 8 * kTsLd;
          lo[0] = c2[mt][nt][0] + B2[col];
          lo[1] = c2[mt][nt][1] + B2[col + 1];
          hi[0] = c2[mt][nt][2] + B2[col];
          hi[1] = c2[mt][nt][3] + B2[col + 1];
        }
      }
      __syncwarp();

      // 4. the epilogue, one lane per row: every new value is read before
      //    any is written (register arrays indexed by unrolled constants)
      {
        const int r = rb + lane;
        const float* const tsr = TS + lane * kTsLd;
        float v2[kMaxTs / 2], keep[kMaxD1];
        float s_sum = 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxTs / 2; ++j) {
          if (j < d2) {
            const float t = tsr[j];
            const float s = tsr[d2 + j];
            // push: [u1; u2] -> [u2 exp(s) + t; u1]
            // pull: [v2; u1] -> [u1; (v2 - t) exp(-s)]
            v2[j] = kInverse ? (U[j * RB + r] - t) * expf(-s)
                             : U[(d1 + j) * RB + r] * expf(s) + t;
            s_sum = j == 0 ? s : s_sum + s;
          }
        }
#pragma unroll
        for (int j = 0; j < kMaxD1; ++j)
          if (j < d1) keep[j] = U[((kInverse ? d2 : 0) + j) * RB + r];
#pragma unroll
        for (int j = 0; j < kMaxTs / 2; ++j)
          if (j < d2) U[((kInverse ? d1 : 0) + j) * RB + r] = v2[j];
#pragma unroll
        for (int j = 0; j < kMaxD1; ++j)
          if (j < d1) U[((kInverse ? 0 : d2) + j) * RB + r] = keep[j];
        S[r] += s_sum;
      }
      __syncwarp();  // the scratch and the tile's rows are done
    }
  }
  __syncthreads();
  for (int i = tid; i < d * RB; i += blockDim.x) {
    const int f = i / RB, r = i - f * RB;
    if (r < nrows) a.x_out[f * N + row0 + r] = U[i];
  }
  for (int r = tid; r < nrows; r += blockDim.x) a.s_out[row0 + r] = S[r];
}

}  // namespace glabc

// Largest number of 32-row tiles per warp that the shared memory allows for
// `warps` warps per block, 0 when even one does not fit.
extern "C" int glabc_coupling_flow_bf16_max_sub(int d, int H, int warps) {
  using namespace glabc;
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  const size_t fixed = bf16_flow_smem(d, H, warps, 0);
  if (fixed >= static_cast<size_t>(limit)) return 0;
  const size_t per_sub =
      static_cast<size_t>(d + 1) * warps * kTile * sizeof(float);
  return static_cast<int>((static_cast<size_t>(limit) - fixed) / per_sub);
}

namespace glabc {

// one direction's kernel for H = 16 KT, after opting in to its shared memory
template <int KT>
static int launch_bf16(const Bf16FlowArgs& a, int inverse, dim3 grid,
                       int warps, size_t smem, cudaStream_t s) {
  cudaError_t err;
  if (inverse) {
    err = cudaFuncSetAttribute(coupling_flow_bf16_kernel<true, KT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    coupling_flow_bf16_kernel<true, KT><<<grid, warps * 32, smem, s>>>(a);
  } else {
    err = cudaFuncSetAttribute(coupling_flow_bf16_kernel<false, KT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    coupling_flow_bf16_kernel<false, KT><<<grid, warps * 32, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace glabc

extern "C" int glabc_coupling_flow_bf16(const float* x_in, float* x_out,
                                        float* s_out, const void* w, int d,
                                        int N, int L, int H, int inverse,
                                        int warps, int nsub, void* stream) {
  using namespace glabc;
  if (d < 2 || d > kMaxD || H < 16 || H % 16 || H / 16 > kMaxKT ||
      warps < 1 || warps > kMaxWarps || nsub < 1 || N < 1 || L < 1)
    return -1;
  Bf16FlowArgs a{x_in, x_out, s_out, static_cast<const unsigned char*>(w),
                 d, N, L, H, nsub};
  const size_t rb = static_cast<size_t>(warps) * nsub * kTile;
  const size_t smem = bf16_flow_smem(d, H, warps, nsub);
  const dim3 grid(static_cast<unsigned>((static_cast<size_t>(N) + rb - 1) / rb));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H / 16) {
    case 1: return launch_bf16<1>(a, inverse, grid, warps, smem, s);
    case 2: return launch_bf16<2>(a, inverse, grid, warps, smem, s);
    case 3: return launch_bf16<3>(a, inverse, grid, warps, smem, s);
    case 4: return launch_bf16<4>(a, inverse, grid, warps, smem, s);
    case 5: return launch_bf16<5>(a, inverse, grid, warps, smem, s);
    case 6: return launch_bf16<6>(a, inverse, grid, warps, smem, s);
    case 7: return launch_bf16<7>(a, inverse, grid, warps, smem, s);
    default: return launch_bf16<8>(a, inverse, grid, warps, smem, s);
  }
}
