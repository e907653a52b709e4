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
// 0.2 ms: the tensor cores bind, with the FP32 lanes close behind; but a
// tile's steps depend on each other, so a warp mostly waits, and the design
// keeps many warps and little per-tile work (PERF.md, K7-bf16's "what was
// tried").  So:
//
//   * nothing but x and out/s touches device memory: a block's rows keep
//     their coordinates (d x RB) and log-scale sums in shared memory for the
//     whole stack, and the layers are the outer loop (the 1.36 MB of a
//     32 x 128 flow's weights cannot stay on chip; streamed once per RB
//     rows, up to ~8,500, they cost the L2 little);
//   * a block is one producer warpgroup and three consumer warpgroups;
//     setmaxnreg leaves the producer 24 registers a thread and gives the
//     consumers 160.  Each layer's weights are one contiguous image
//     (pack_bf16_weights), which one thread of the producer moves into a
//     ring of kStages buffers with one cp.async.bulk copy, completing on
//     the stage's `full` mbarrier (expect_tx); the consumers wait on it and
//     arrive on the stage's `empty` mbarrier when done with the layer,
//     which the producer waits on before it refills the stage.  No
//     __syncthreads after the start;
//   * a consumer warpgroup owns 64-row tiles outright (tile k goes to
//     warpgroup k % 3), and a warp the tile's 16 rows that its wgmma
//     fragments hold, so the rows need no barrier beyond __syncwarp.  The
//     warpgroups run on their own: while one waits on its wgmma the
//     others' FP32-lane work issues.  Per tile and layer:
//       1. h0 on the FP32 lanes straight into the A fragments of
//          wgmma m64nHk16 (warp w of the group holds rows 16 w .. 16 w + 15
//          in mma.sync's m16n8k16 A layout: rows gid, gid + 8, columns
//          2 tig, 2 tig + 1, + 8 of each k-tile), one pass over the
//          thread's columns per term in ascending order (a product of two
//          bf16 values is exact in float32, so fmaf equals the plain
//          multiply and add), + b0, then ReLU and the bf16 rounding in one
//          conversion (cvt.rn.relu.bf16x2);
//       2. h1 = h0 w1 by H/16 wgmma.mma_async m64nHk16, A from registers, B
//          (w1) from shared memory through a matrix descriptor;
//       3. h1's accumulators + b1, then ReLU and bf16 in one conversion:
//          the A fragments of ts = h1 w2 (a warp's slice of wgmma's
//          accumulators has mma.sync's layout), by H/16 mma.sync m16n8k16
//          per 8 columns of ts, B by ldmatrix from w2's image.  Not wgmma:
//          ts's 8 or 16 columns make an m64n8k16 wgmma cost the tensor
//          pipe far more than its share (PERF.md, K7-bf16's "what was
//          tried": on an H100 at 700 W, leaving ts's wgmma out took a
//          91 ms push to 65 ms);
//       4. the epilogue where the accumulators lie: the thread holding
//          ts's columns 8 c + 2 tig, + 1 of rows gid, gid + 8 holds t_j and
//          s_j, j = 4 c + tig (pack_bf16_weights interleaves w2's columns
//          as t_0, s_0, t_1, s_1, ...), updates that coordinate of its two
//          rows, and the row's four threads sum their s by shuffles.
//     The roll by d2 moves no data: logical coordinate i of a row lives in
//     slot (off + i) mod d, and a layer only advances `off` (by d1 for
//     push, d2 for pull).
//
// The weight image of a layer (ops/kernels/flow_kernel.py pack_bf16_weights
// writes the same offsets; layer_image below):
//   w1  KC x H rows x 128 bytes, KC = ceil(H / 64): w1 transposed (row n
//       holds w1[:, n], K-major), 64 values of k per 128-byte row, in the
//       128-byte swizzle of wgmma's canonical layout: value k of row n at
//       byte kc H 128 + n 128 + ((k % 64 / 8) ^ (n % 8)) 16 + (k % 8) 2;
//   w2  KC x TSN rows x 128 bytes likewise (TSN = 8, or 16 where 2 d2 > 8),
//       row n = column (n % 2) d2 + n / 2 of w2, zero from 2 d2 on;
//   w0 (d1, H) rounded to bf16 and held in float32, b0 (H), b1 (H), b2 (16,
//       interleaved as w2's rows) in float32; the image padded to 1,024
//       bytes, so that every stage and both matrices start on a swizzle
//       atom (8 rows x 128 bytes) and every copy is 16-byte aligned.
//   A descriptor (start >> 4, leading offset 1, stride 1,024 bytes between
//   8-row groups, swizzle mode 128 B) reads k-tile kt at kc = kt / 4, 32
//   (kt % 4) bytes into the row.
//
// Layouts: rows fastest, as the port's state tensors: x_in / x_out (d, N),
// s_out (N,); the weights (L, layer_bytes).  d <= 17, H in {16, 32, ...,
// 128}, one instantiation per H / 16, direction and ts width; N need not
// be a multiple of anything (a tile's rows past N are computed on zeros and
// never stored).  Built for sm_90a (wgmma).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "flow_mma.cuh"

namespace glabc {

constexpr int kTileM = 64;      // rows of a wgmma tile
constexpr int kConsumers = 3;   // consumer warpgroups a block
// + the producer warpgroup (one thread of it copies; a whole group, so that
// setmaxnreg can hand its registers to the consumers)
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 24;   // setmaxnreg: 128 x 24 + 384 x 160
constexpr int kConsumerRegs = 160;  // <= 65,536
constexpr int kStages = 3;      // layer buffers in the ring
constexpr int kMaxKT = 8;       // H / 16
constexpr int kMaxD = 17;       // 2 * (d / 2) <= 16
constexpr int kMaxTs = 16;
constexpr int kSwRow = 128;     // bytes of a swizzled row: 64 bf16 values
constexpr int kAtom = 1024;     // 8 swizzled rows

struct Bf16FlowArgs {
  const float* x_in;
  float* x_out;
  float* s_out;
  const unsigned char* w;  // (L, layer_bytes)
  int d, N, L, ntiles;
};

// byte offsets inside one layer's image
struct LayerImage {
  int w1, w2, w0, b0, b1, b2, bytes;
};

__host__ __device__ inline int ts_rows(int d) { return d / 2 <= 4 ? 8 : 16; }

__host__ __device__ inline LayerImage layer_image(int d, int H) {
  const int kc = (H + 63) / 64, d1 = d - d / 2;
  LayerImage o;
  o.w1 = 0;
  o.w2 = o.w1 + kc * H * kSwRow;
  o.w0 = o.w2 + kc * ts_rows(d) * kSwRow;
  o.b0 = o.w0 + d1 * H * 4;
  o.b1 = o.b0 + H * 4;
  o.b2 = o.b1 + H * 4;
  o.bytes = (o.b2 + kMaxTs * 4 + kAtom - 1) / kAtom * kAtom;
  return o;
}

// the ring, its 2 kStages mbarriers, the rows' coordinates (d x RB) and
// log-scale sums (RB), and the slack that aligns the ring to kAtom
__host__ __device__ inline size_t bf16_flow_smem(int d, int H, int ntiles) {
  const size_t rb = static_cast<size_t>(ntiles) * kTileM;
  return kAtom + static_cast<size_t>(kStages) * layer_image(d, H).bytes +
         2 * kStages * sizeof(uint64_t) +
         static_cast<size_t>(d + 1) * rb * sizeof(float);
}

// ---- mbarriers and the bulk copy
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16) from global to shared memory, completing on
// the mbarrier `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- wgmma
// the matrix descriptor of a K-major operand in the 128-byte swizzle: start
// address >> 4, leading offset 1 (unused by this layout), 1,024 bytes
// between 8-row groups, swizzle mode 1 (128 B)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(kAtom >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep registers that an asynchronous wgmma reads or writes in place until
// its wait: the compiler sees an access here and cannot move others across
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (+)= a b on one k16 step of a 64 x N tile: a (bf16) from registers in
// the m16n8k16 A layout per warp, b (bf16) from shared memory by
// descriptor, d float32 in the m16n8 C layout per n8 column block; the
// product replaces d where scale_d is 0
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // d = a b
  __device__ __forceinline__ static void zero(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
          "=f"(d[5]), "=f"(d[6]), "=f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  }
  // d += a b
  __device__ __forceinline__ static void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  // d = a b
  __device__ __forceinline__ static void zero(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
          "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
          "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
          "=f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  }
  // d += a b
  __device__ __forceinline__ static void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<48> {
  // d = a b
  __device__ __forceinline__ static void zero(float (&d)[24],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
          "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
          "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
          "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
          "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  }
  // d += a b
  __device__ __forceinline__ static void mma(float (&d)[24],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  // d = a b
  __device__ __forceinline__ static void zero(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
          "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
          "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
          "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
          "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
          "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
          "=f"(d[30]), "=f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  }
  // d += a b
  __device__ __forceinline__ static void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<80> {
  // d = a b
  __device__ __forceinline__ static void zero(float (&d)[40],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
          "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
          "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
          "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
          "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
          "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
          "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
          "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  }
  // d += a b
  __device__ __forceinline__ static void mma(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<96> {
  // d = a b
  __device__ __forceinline__ static void zero(float (&d)[48],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
          "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
          "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
          "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
          "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
          "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
          "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
          "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
          "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]),
          "=f"(d[45]), "=f"(d[46]), "=f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  }
  // d += a b
  __device__ __forceinline__ static void mma(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<112> {
  // d = a b
  __device__ __forceinline__ static void zero(float (&d)[56],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55"
        "}, {%56, %57, %58, %59}, %60, p, 1, 1, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
          "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
          "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
          "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
          "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
          "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
          "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
          "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
          "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]),
          "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]),
          "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]),
          "=f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  }
  // d += a b
  __device__ __forceinline__ static void mma(float (&d)[56],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55"
        "}, {%56, %57, %58, %59}, %60, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // d = a b
  __device__ __forceinline__ static void zero(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
          "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
          "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
          "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
          "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
          "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
          "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
          "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
          "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]),
          "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]),
          "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]),
          "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
          "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  }
  // d += a b
  __device__ __forceinline__ static void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two 8 x 8 bf16 matrices from shared memory, one 16-byte row per lane
// address (lanes 0-15): thread t gets elements 2 (t % 4), + 1 of row t / 4
// of each
__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr)
      : "memory");
}

// ts = relu(h1 + b1) w2 for the warp's 16 rows of the tile: A from h1's
// accumulators (+ b1, then ReLU and bf16 in one conversion: in the
// warp's rows, wgmma's accumulator layout is mma.sync's), B from the
// TSN-row K-major w2 image by ldmatrix (row n = 8 nb + lane % 8, k-half
// lane / 8 % 2 of k-tile kt, swizzled as the image is), mma.sync m16n8k16
// per n8 block, k-tiles in order
template <int KT, int TSN>
__device__ __forceinline__ void ts_product(const float (&h1)[8 * KT],
                                           const float* B1, uint32_t w2s,
                                           int lane, float (&ts)[TSN / 8][4]) {
  const int tig = lane & 3, r = lane & 7, half = (lane >> 3) & 1;
#pragma unroll
  for (int nb = 0; nb < TSN / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) ts[nb][e] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const int c = 16 * kt + 2 * tig;
    const float2 lo = *reinterpret_cast<const float2*>(B1 + c);
    const float2 hi = *reinterpret_cast<const float2*>(B1 + c + 8);
    uint32_t a[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {  // rows gid, gid + 8
      a[e] = pack_relu_bf16(h1[8 * kt + 2 * e] + lo.x,
                            h1[8 * kt + 2 * e + 1] + lo.y);
      a[2 + e] = pack_relu_bf16(h1[8 * kt + 4 + 2 * e] + hi.x,
                                h1[8 * kt + 5 + 2 * e] + hi.y);
    }
    const int k = 16 * kt + 8 * half;
#pragma unroll
    for (int nb = 0; nb < TSN / 8; ++nb) {
      const int n = 8 * nb + r;
      uint32_t b0, b1;
      ldmatrix_x2(b0, b1, w2s + (k / 64) * TSN * kSwRow + n * kSwRow +
                              ((((k % 64) >> 3) ^ (n & 7)) << 4));
      mma_bf16(ts[nb], a, b0, b1);
    }
  }
}

template <bool kInverse, int KT, int TSN>
__global__ void __launch_bounds__(kThreads, 1)
    coupling_flow_bf16_kernel(Bf16FlowArgs a) {
  constexpr int H = 16 * KT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem =
      smem_raw + ((kAtom - (smem_addr(smem_raw) & (kAtom - 1))) & (kAtom - 1));
  const int d = a.d, d2 = d / 2, d1 = d - d2;
  const LayerImage img = layer_image(d, H);
  const uint32_t ring = smem_addr(smem);
  const uint32_t full = ring + kStages * img.bytes;
  const uint32_t empty = full + kStages * sizeof(uint64_t);
  const int RB = a.ntiles * kTileM;
  float* const U = reinterpret_cast<float*>(smem + kStages * img.bytes +
                                            2 * kStages * sizeof(uint64_t));
  float* const Ssum = U + d * RB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // the producer: layer `step` (reversed for pull) into stage step % kStages
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 4 * kConsumers && lane == 0) {
      for (int step = 0; step < a.L; ++step) {
        const int s = step % kStages;
        if (step >= kStages)
          mbar_wait(empty + 8 * s,
                    static_cast<uint32_t>(step / kStages - 1) & 1u);
        const int l = kInverse ? a.L - 1 - step : step;
        mbar_expect_tx(full + 8 * s, img.bytes);
        bulk_copy(ring + s * img.bytes,
                  a.w + static_cast<size_t>(l) * img.bytes, img.bytes,
                  full + 8 * s);
      }
    }
    return;
  }

  // a consumer: warpgroup wg, warp wq of it
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2, wq = warp & 3;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t N = static_cast<size_t>(a.N);
  const size_t row0 = static_cast<size_t>(blockIdx.x) * RB;
  const int nrows = static_cast<int>(
      (N - row0) < static_cast<size_t>(RB) ? N - row0 : RB);

  // the warp's 16 rows of each of its group's tiles, zero past N
  for (int k = wg; k < a.ntiles; k += kConsumers) {
    const int rb = k * kTileM + 16 * wq;
    for (int i = lane; i < d * 16; i += 32) {
      const int f = i >> 4, r = rb + (i & 15);
      U[f * RB + r] = r < nrows ? a.x_in[f * N + row0 + r] : 0.0f;
    }
    if (lane < 16) Ssum[rb + lane] = 0.0f;
  }
  __syncwarp();

  // the conditioner reads logical coordinates [in0, in0 + d1), the layer
  // transforms [out0, out0 + d2): push u1 = [0, d1), u2 = [d1, d); pull
  // u1 = [d2, d), v2 = [0, d2)
  const int in0 = kInverse ? d2 : 0, out0 = kInverse ? 0 : d1;
  int off = 0;  // logical coordinate i of a row lives in slot (off + i) % d
  auto slot = [&](int i) {
    const int x = off + i;
    return x >= d ? x - d : x;
  };

  for (int step = 0; step < a.L; ++step) {
    const int s = step % kStages;
    mbar_wait(full + 8 * s, static_cast<uint32_t>(step / kStages) & 1u);
    const unsigned char* const buf = smem + s * img.bytes;
    const uint32_t w1s = ring + s * img.bytes + img.w1;
    const uint32_t w2s = ring + s * img.bytes + img.w2;
    const float* const W0 = reinterpret_cast<const float*>(buf + img.w0);
    const float* const B0 = reinterpret_cast<const float*>(buf + img.b0);
    const float* const B1 = reinterpret_cast<const float*>(buf + img.b1);
    const float* const B2 = reinterpret_cast<const float*>(buf + img.b2);

    for (int k = wg; k < a.ntiles; k += kConsumers) {
      if (k * kTileM >= nrows) break;  // the same for the whole group
      const int r_lo = k * kTileM + 16 * wq + gid, r_hi = r_lo + 8;

      // 1. h0 = relu(bf16(u1) bf16(w0) + b0) into the A fragments: term j
      //    of the columns this thread holds (16 kt + 8 half + 2 tig, + 1)
      //    for both rows, terms in ascending order, one pass each.  A
      //    product of two bf16 values is exact in float32, so fmaf is the
      //    plain multiply and add, and with one term the bias joins the
      //    product in one rounding, as the plain sum rounds it
      float h0[KT][2][4];  // [k-tile][half][lo c, lo c + 1, hi c, hi c + 1]
      {
        const bool one = d1 == 1;
        const float* const u = U + slot(in0) * RB;
        const float ul = round_bf16(u[r_lo]), uh = round_bf16(u[r_hi]);
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int c = 16 * kt + 8 * half + 2 * tig;
            const float2 w = *reinterpret_cast<const float2*>(W0 + c);
            const float2 b = one ? *reinterpret_cast<const float2*>(B0 + c)
                                 : make_float2(0.0f, 0.0f);
            float* const h = h0[kt][half];
            h[0] = fmaf(ul, w.x, b.x);
            h[1] = fmaf(ul, w.y, b.y);
            h[2] = fmaf(uh, w.x, b.x);
            h[3] = fmaf(uh, w.y, b.y);
          }
      }
      for (int j = 1; j < d1; ++j) {
        const float* const u = U + slot(in0 + j) * RB;
        const float ul = round_bf16(u[r_lo]), uh = round_bf16(u[r_hi]);
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int c = 16 * kt + 8 * half + 2 * tig;
            const float2 w = *reinterpret_cast<const float2*>(W0 + j * H + c);
            float* const h = h0[kt][half];
            h[0] = fmaf(ul, w.x, h[0]);
            h[1] = fmaf(ul, w.y, h[1]);
            h[2] = fmaf(uh, w.x, h[2]);
            h[3] = fmaf(uh, w.y, h[3]);
          }
      }
      uint32_t af[KT][4];
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* const h = h0[kt][half];
          if (d1 == 1) {  // the bias is in
            af[kt][2 * half] = pack_relu_bf16(h[0], h[1]);
            af[kt][2 * half + 1] = pack_relu_bf16(h[2], h[3]);
          } else {
            const float2 b = *reinterpret_cast<const float2*>(
                B0 + 16 * kt + 8 * half + 2 * tig);
            af[kt][2 * half] = pack_relu_bf16(h[0] + b.x, h[1] + b.y);
            af[kt][2 * half + 1] = pack_relu_bf16(h[2] + b.x, h[3] + b.y);
          }
        }

      // 2. h1 = h0 w1
      __syncwarp();
      float h1[8 * KT];
      wgmma_fence();
      Wgmma<H>::zero(h1, af[0], sw128_desc(w1s));
#pragma unroll
      for (int kt = 1; kt < KT; ++kt)
        Wgmma<H>::mma(h1, af[kt],
                      sw128_desc(w1s + (kt / 4) * H * kSwRow + (kt % 4) * 32));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(h1);
      fence_regs(af);

      // 3. ts = relu(h1 + b1) w2
      float ts[TSN / 8][4];
      ts_product<KT, TSN>(h1, B1, w2s, lane, ts);

      // 4. the epilogue: thread tig holds t_j, s_j of rows r_lo, r_hi for
      //    j = tig (+ 4)
      float s_lo = 0.0f, s_hi = 0.0f;
#pragma unroll
      for (int nb = 0; nb < TSN / 8; ++nb) {
        const int j = 4 * nb + tig;
        const float2 b =
            *reinterpret_cast<const float2*>(B2 + 8 * nb + 2 * tig);
        if (j < d2) {
          const float t0 = ts[nb][0] + b.x, sc0 = ts[nb][1] + b.y;
          const float t1 = ts[nb][2] + b.x, sc1 = ts[nb][3] + b.y;
          float* const u = U + slot(out0 + j) * RB;
          // push: u2 exp(s) + t; pull: (v2 - t) exp(-s)
          u[r_lo] = kInverse ? (u[r_lo] - t0) * expf(-sc0)
                             : u[r_lo] * expf(sc0) + t0;
          u[r_hi] = kInverse ? (u[r_hi] - t1) * expf(-sc1)
                             : u[r_hi] * expf(sc1) + t1;
          s_lo += sc0;
          s_hi += sc1;
        }
      }
      s_lo += __shfl_xor_sync(0xffffffffu, s_lo, 1);
      s_hi += __shfl_xor_sync(0xffffffffu, s_hi, 1);
      s_lo += __shfl_xor_sync(0xffffffffu, s_lo, 2);
      s_hi += __shfl_xor_sync(0xffffffffu, s_hi, 2);
      if (tig == 0) {
        Ssum[r_lo] += s_lo;
        Ssum[r_hi] += s_hi;
      }
    }
    __syncwarp();  // the next layer's h0 reads what the quads wrote
    mbar_arrive(empty + 8 * s);  // this thread is done with the stage
    off = slot(kInverse ? d2 : d1);
  }

  for (int k = wg; k < a.ntiles; k += kConsumers) {
    const int rb = k * kTileM + 16 * wq;
    for (int i = lane; i < d * 16; i += 32) {
      const int f = i >> 4, r = rb + (i & 15);
      if (r < nrows) a.x_out[f * N + row0 + r] = U[slot(f) * RB + r];
    }
    if (lane < 16 && rb + lane < nrows)
      a.s_out[row0 + rb + lane] = Ssum[rb + lane];
  }
}

// one kernel for H = 16 KT, a direction and ts's wgmma width, after opting
// in to its shared memory
template <bool kInverse, int KT, int TSN>
static int launch_one(const Bf16FlowArgs& a, dim3 grid, size_t smem,
                      cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      coupling_flow_bf16_kernel<kInverse, KT, TSN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  coupling_flow_bf16_kernel<kInverse, KT, TSN><<<grid, kThreads, smem, s>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

template <int KT>
static int launch_bf16(const Bf16FlowArgs& a, int inverse, dim3 grid,
                       size_t smem, cudaStream_t s) {
  const bool n8 = ts_rows(a.d) == 8;
  if (inverse)
    return n8 ? launch_one<true, KT, 8>(a, grid, smem, s)
              : launch_one<true, KT, 16>(a, grid, smem, s);
  return n8 ? launch_one<false, KT, 8>(a, grid, smem, s)
            : launch_one<false, KT, 16>(a, grid, smem, s);
}

}  // namespace glabc

// Bytes of one layer's weight image for (d, H): what pack_bf16_weights
// must give.
extern "C" int glabc_coupling_flow_bf16_layer_bytes(int d, int H) {
  return glabc::layer_image(d, H).bytes;
}

// Largest number of 64-row tiles a block's shared memory holds beside the
// weight ring, 0 when not even one fits.
extern "C" int glabc_coupling_flow_bf16_max_tiles(int d, int H) {
  using namespace glabc;
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  const size_t fixed = bf16_flow_smem(d, H, 0);
  if (fixed >= static_cast<size_t>(limit)) return 0;
  const size_t per_tile = static_cast<size_t>(d + 1) * kTileM * sizeof(float);
  return static_cast<int>((static_cast<size_t>(limit) - fixed) / per_tile);
}

extern "C" int glabc_coupling_flow_bf16(const float* x_in, float* x_out,
                                        float* s_out, const void* w, int d,
                                        int N, int L, int H, int inverse,
                                        int ntiles, void* stream) {
  using namespace glabc;
  if (d < 2 || d > kMaxD || H < 16 || H % 16 || H / 16 > kMaxKT ||
      ntiles < 1 || N < 1 || L < 1)
    return -1;
  Bf16FlowArgs a{x_in, x_out, s_out, static_cast<const unsigned char*>(w),
                 d, N, L, ntiles};
  const size_t rb = static_cast<size_t>(ntiles) * kTileM;
  const size_t smem = bf16_flow_smem(d, H, ntiles);
  const dim3 grid(
      static_cast<unsigned>((static_cast<size_t>(N) + rb - 1) / rb));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H / 16) {
    case 1: return launch_bf16<1>(a, inverse, grid, smem, s);
    case 2: return launch_bf16<2>(a, inverse, grid, smem, s);
    case 3: return launch_bf16<3>(a, inverse, grid, smem, s);
    case 4: return launch_bf16<4>(a, inverse, grid, smem, s);
    case 5: return launch_bf16<5>(a, inverse, grid, smem, s);
    case 6: return launch_bf16<6>(a, inverse, grid, smem, s);
    case 7: return launch_bf16<7>(a, inverse, grid, smem, s);
    default: return launch_bf16<8>(a, inverse, grid, smem, s);
  }
}
