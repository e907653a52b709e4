// The whole L-layer affine coupling flow in one launch: base -> data (push)
// or data -> base (pull), with the summed log-scale of every row.
//
// Replaces glabc_tpu/ops/pallas/flow_kernel.py FusedCouplingFlow._push_kernel
// (:149), _pull_kernel (:164) and their shared layer body _layer (:103)
// (K7).  The plain torch version is CouplingFlow.push_t / pull_t
// (glabc_tpu_torch/models/flows.py) under no_grad, on per-layer matmuls; the
// kernel sums its products in another order, so the two agree to float32
// rounding (relative 1e-4 at 32 layers), not bitwise.
//
// What one row needs, per layer: the conditioner MLP [d1, H, H, 2*d2] with
// ReLU, i.e. d1*H + H*H + 2*d2*H fused multiply-adds (536,576 per row at
// d=2, L=32, H=128), then exp(+-s), the affine update and the running sum of
// s.  Against 4*(2*d + 1) bytes of input and output per row the flow is
// bound by its multiply-adds many times over, so everything between the
// input tile and the output tile stays on the SM:
//
//   * a block owns RB = nsub * R consecutive rows; their coordinates u
//     (d x RB) and log-scale sums (RB) live in shared memory for the whole
//     launch, and only the input and the output touch device memory;
//   * layers are the outer loop: each layer's weights are staged once per
//     block in dynamic shared memory (w1 alone is 64 KB at H=128, so the
//     launch opts in above 48 KB), then the block walks its R-row sub-tiles:
//       1. h0 = relu(u1 w0 + b0) into A (H x R, feature-major);
//       2. h1 = relu(h0 w1 + b1) into A2, a register-tiled FP32 FMA loop:
//          each of the 256 threads owns 4 rows x 8 hidden units and reads one
//          float4 of A and two of w1 per k;
//       3. ts = h1 w2 + b2: four threads per row each sum a quarter of H,
//          then two warp shuffles add the quarters;
//       4. the epilogue on the row: exp(+-s), the affine update of the d2
//          transformed coordinates, the roll by d2, s summed into the row.
//
// Layouts: rows fastest, as the JAX kernel's (d_pad, N) tile and the port's
// state tensors: x_in / x_out (d, N), s_out (N,).  Weights in the JAX stack's
// layout, contiguous: w0 (L, d1, H), b0 (L, H), w1 (L, H, H), b1 (L, H),
// w2 (L, H, 2*d2), b2 (L, 2*d2).  N need not be a multiple of anything: the
// last block masks its tail.  Tensor cores (TF32/bf16 wgmma), TMA and a
// bf16-operand variant are not used here.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace glabc {

constexpr int kThreads = 256;
constexpr int kRows = 64;      // R: rows per sub-tile (4 threads per row)
constexpr int kMaxTs = 16;     // 2*d2 <= 16, so d <= 17

struct FlowArgs {
  const float* x_in;
  float* x_out;
  float* s_out;
  const float* w0;
  const float* b0;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  int d, N, L, H, nsub;
};

__host__ __device__ inline int ts_pad(int ts) { return (ts + 3) & ~3; }

// Shared memory, in floats: A and A2 (H x R each), w1 (H x H), w0 (d1 x H),
// b0, b1 (H each), w2 (H x ts), b2 (ts, padded to 4), u (d x RB), s (RB).
__host__ __device__ inline size_t flow_smem_floats(int d, int H, int rb) {
  const int d2 = d / 2, d1 = d - d2, ts = 2 * d2;
  return static_cast<size_t>(2) * H * kRows + static_cast<size_t>(H) * H +
         static_cast<size_t>(d1) * H + 2 * H + static_cast<size_t>(H) * ts +
         ts_pad(ts) + static_cast<size_t>(d + 1) * rb;
}

template <bool kInverse>
__global__ void __launch_bounds__(kThreads)
    coupling_flow_kernel(FlowArgs a) {
  extern __shared__ float4 smem4[];
  float* const A = reinterpret_cast<float*>(smem4);
  const int H = a.H, d = a.d, d2 = d / 2, d1 = d - d2, ts = 2 * d2;
  const int RB = a.nsub * kRows;
  float* const A2 = A + H * kRows;
  float* const W1 = A2 + H * kRows;
  float* const W0 = W1 + H * H;
  float* const B0 = W0 + d1 * H;
  float* const B1 = B0 + H;
  float* const W2 = B1 + H;
  float* const B2 = W2 + H * ts;
  float* const U = B2 + ts_pad(ts);
  float* const S = U + d * RB;

  const int tid = threadIdx.x;
  const size_t N = static_cast<size_t>(a.N);
  const size_t row0 = static_cast<size_t>(blockIdx.x) * RB;
  const int nrows = static_cast<int>(min(static_cast<size_t>(RB), N - row0));
  for (int i = tid; i < d * RB; i += kThreads) {
    const int f = i / RB, r = i - f * RB;
    U[i] = r < nrows ? a.x_in[f * N + row0 + r] : 0.0f;
  }
  for (int r = tid; r < RB; r += kThreads) S[r] = 0.0f;

  // the conditioner reads u1: rows [0, d1) in the u layout (push), rows
  // [d2, d2 + d1) in the rolled [v2; u1] layout (pull)
  const int in_off = kInverse ? d2 : 0;
  const int n_tiles = (kRows / 4) * (H / 8);
  const int kq = H / 4;          // step 3: each of four threads sums H/4 terms
  const int row3 = tid >> 2, part = tid & 3;

  for (int step = 0; step < a.L; ++step) {
    const int l = kInverse ? a.L - 1 - step : step;
    __syncthreads();  // the previous layer is done with the weights
    {
      const float4* src = reinterpret_cast<const float4*>(
          a.w1 + static_cast<size_t>(l) * H * H);
      float4* dst = reinterpret_cast<float4*>(W1);
      for (int i = tid; i < H * H / 4; i += kThreads) dst[i] = src[i];
      for (int i = tid; i < d1 * H; i += kThreads)
        W0[i] = a.w0[static_cast<size_t>(l) * d1 * H + i];
      for (int i = tid; i < H; i += kThreads) {
        B0[i] = a.b0[static_cast<size_t>(l) * H + i];
        B1[i] = a.b1[static_cast<size_t>(l) * H + i];
      }
      for (int i = tid; i < H * ts; i += kThreads)
        W2[i] = a.w2[static_cast<size_t>(l) * H * ts + i];
      for (int i = tid; i < ts; i += kThreads)
        B2[i] = a.b2[static_cast<size_t>(l) * ts + i];
    }
    __syncthreads();

    for (int sub = 0; sub < a.nsub; ++sub) {
      const int rb = sub * kRows;
      if (rb >= nrows) break;  // the same for every thread of the block
      // 1. h0 = relu(u1 w0 + b0), feature-major A[k][r]
      for (int i = tid; i < H * kRows; i += kThreads) {
        const int k = i / kRows, r = i - k * kRows;
        float acc = 0.0f;
        for (int j = 0; j < d1; ++j)
          acc = fmaf(U[(in_off + j) * RB + rb + r], W0[j * H + k], acc);
        A[i] = fmaxf(acc + B0[k], 0.0f);
      }
      __syncthreads();
      // 2. h1 = relu(h0 w1 + b1): a 4-row x 8-unit register tile per thread
      for (int tile = tid; tile < n_tiles; tile += kThreads) {
        const int tr = tile % (kRows / 4), tc = tile / (kRows / 4);
        float c[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) c[i][j] = 0.0f;
        const float* ap = A + 4 * tr;
        const float* wp = W1 + 8 * tc;
#pragma unroll 4
        for (int k = 0; k < H; ++k) {
          const float4 av = *reinterpret_cast<const float4*>(ap + k * kRows);
          const float4 w_lo = *reinterpret_cast<const float4*>(wp + k * H);
          const float4 w_hi = *reinterpret_cast<const float4*>(wp + k * H + 4);
          const float ar[4] = {av.x, av.y, av.z, av.w};
          const float wr[8] = {w_lo.x, w_lo.y, w_lo.z, w_lo.w,
                               w_hi.x, w_hi.y, w_hi.z, w_hi.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) c[i][j] = fmaf(ar[i], wr[j], c[i][j]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float bj = B1[8 * tc + j];
          float4 o;
          o.x = fmaxf(c[0][j] + bj, 0.0f);
          o.y = fmaxf(c[1][j] + bj, 0.0f);
          o.z = fmaxf(c[2][j] + bj, 0.0f);
          o.w = fmaxf(c[3][j] + bj, 0.0f);
          *reinterpret_cast<float4*>(A2 + (8 * tc + j) * kRows + 4 * tr) = o;
        }
      }
      __syncthreads();
      // 3. ts = h1 w2 + b2: four threads per row, one quarter of H each
      float t_acc[kMaxTs];
#pragma unroll
      for (int m = 0; m < kMaxTs; ++m) t_acc[m] = 0.0f;
      for (int k = part * kq; k < (part + 1) * kq; ++k) {
        const float h = A2[k * kRows + row3];
#pragma unroll
        for (int m = 0; m < kMaxTs; ++m)
          if (m < ts) t_acc[m] = fmaf(h, W2[k * ts + m], t_acc[m]);
      }
#pragma unroll
      for (int m = 0; m < kMaxTs; ++m) {
        if (m < ts) {
          t_acc[m] += __shfl_xor_sync(0xffffffffu, t_acc[m], 1);
          t_acc[m] += __shfl_xor_sync(0xffffffffu, t_acc[m], 2);
        }
      }
      // 4. the epilogue, one thread per row
      if (part == 0) {
        const int r = rb + row3;
        float u[2 * kMaxTs + 1];
#pragma unroll
        for (int f = 0; f < 2 * kMaxTs + 1; ++f)
          if (f < d) u[f] = U[f * RB + r];
        float s_sum = 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxTs / 2; ++j) {
          if (j < d2) {
            const float t = t_acc[j] + B2[j];
            const float s = t_acc[d2 + j] + B2[d2 + j];
            if (kInverse) {
              // [v2; u1] -> [u1; (v2 - t) exp(-s)]
              U[(d1 + j) * RB + r] = (u[j] - t) * expf(-s);
            } else {
              // [u1; u2] -> [u2 exp(s) + t; u1]
              U[j * RB + r] = u[d1 + j] * expf(s) + t;
            }
            s_sum = j == 0 ? s : s_sum + s;
          }
        }
#pragma unroll
        for (int j = 0; j < 2 * kMaxTs + 1; ++j) {
          if (j < d1) {
            if (kInverse) {
              U[j * RB + r] = u[d2 + j];
            } else {
              U[(d2 + j) * RB + r] = u[j];
            }
          }
        }
        S[r] += s_sum;
      }
      __syncthreads();  // A and A2 are reused by the next sub-tile
    }
  }
  __syncthreads();
  for (int i = tid; i < d * RB; i += kThreads) {
    const int f = i / RB, r = i - f * RB;
    if (r < nrows) a.x_out[f * N + row0 + r] = U[i];
  }
  for (int r = tid; r < nrows; r += kThreads) a.s_out[row0 + r] = S[r];
}

}  // namespace glabc

// Largest rows-per-block the shared memory allows (a multiple of the
// sub-tile), 0 when even one sub-tile does not fit.
extern "C" int glabc_coupling_flow_max_rows(int d, int H) {
  using namespace glabc;
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  const size_t fixed = flow_smem_floats(d, H, 0) * sizeof(float);
  if (fixed >= static_cast<size_t>(limit)) return 0;
  const size_t per_row = static_cast<size_t>(d + 1) * sizeof(float);
  const size_t rows = (static_cast<size_t>(limit) - fixed) / per_row;
  return static_cast<int>(rows / kRows) * kRows;
}

extern "C" int glabc_coupling_flow(const float* x_in, float* x_out,
                                   float* s_out, const float* w0,
                                   const float* b0, const float* w1,
                                   const float* b1, const float* w2,
                                   const float* b2, int d, int N, int L, int H,
                                   int inverse, int nsub, void* stream) {
  using namespace glabc;
  if (d < 2 || 2 * (d / 2) > kMaxTs || H < 8 || H % 8 || nsub < 1 ||
      N < 1 || L < 1)
    return -1;
  FlowArgs a{x_in, x_out, s_out, w0, b0, w1, b1, w2, b2, d, N, L, H, nsub};
  const int rb = nsub * kRows;
  const size_t smem = flow_smem_floats(d, H, rb) * sizeof(float);
  const dim3 grid(static_cast<unsigned>((static_cast<size_t>(N) + rb - 1) / rb));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (inverse) {
    err = cudaFuncSetAttribute(coupling_flow_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    coupling_flow_kernel<true><<<grid, kThreads, smem, s>>>(a);
  } else {
    err = cudaFuncSetAttribute(coupling_flow_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    coupling_flow_kernel<false><<<grid, kThreads, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
