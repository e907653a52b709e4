// One digit pass of an exact radix select over float32 values (K11): for
// each of two targets, the histogram of one digit of the order-preserving
// keys of the values whose higher digits equal that target's prefix; and
// the pick of each target's digit from those histograms.
//
// Replaces no Pallas kernel: the JAX package's quantile is jnp.sort under
// XLA, on one device and after a gather on a mesh.  It was added for the
// chain-sharded AGLMCMC epoch (glabc_tpu_torch/parallel/sharded.py
// distributed_quantile), where every rank would otherwise gather and sort
// every rank's pool discrepancies to read two order statistics: with a
// digit histogram a pass, the ranks exchange 2 x 2^bits counts instead of
// the values.  The plain torch version and the select built on it are
// glabc_tpu_torch/ops/kernels/radix_select_kernel.py (RadixSelect.plain_hist,
// RadixSelect.plain_pick, radix_select).
//
// The key of a value v is its bits with the sign bit flipped for v >= 0 and
// every bit flipped for v < 0, so unsigned order is the order of the values;
// -0.0 is read as +0.0 (equal values tie, as under torch.sort) and every NaN
// as 0xFFFFFFFF (above +inf: torch.sort puts NaNs last).  A pass at shift s
// and width b counts, for target t, digit (key >> s) & (2^b - 1) of the keys
// with key >> (s + b) == prefix[t].  When the two prefixes are equal, as
// they are in the first pass and mostly after it, the keys are counted once
// and the counts added to both histograms.
//
// The select's state lives on the device, int64 (prefix_0, prefix_1, k_0,
// k_1): the prefixes so far and each target's rank among the keys under
// its prefix.  After a pass's histograms are complete (on a mesh: summed
// over the ranks), one block picks each target's digit, the first whose
// cumulative count exceeds k, subtracts the counts below it from k and
// appends it to the prefix; after the last pass the prefixes are the keys
// sought, and the pick writes their values.  So no pass waits for the host,
// and a pass is two launches beside its exchange.
//
// What bounds it on an H100 (SXM, 700 W): bytes.  A pass reads each value
// once, 4 bytes, and does a handful of integer operations on it; at the
// mesh cell's shard of 32,768,000 values that is 131 MB, ~39 us at
// 3.35 TB/s.  So the values are read as float4 by a grid of a few blocks
// an SM that strides over the array, each block counts into shared memory
// (2 x 2^b 32-bit counters, 16 KB at b = 11) with shared atomics, and adds
// its nonzero counters to the int64 histograms in device memory once, at
// its end: at most 2 x 2^b global atomics a block, so up to blocks x 2 x
// 2^b a pass (2.2 M at b = 11 on 132 SMs x 4 blocks, where the keys under
// a prefix spread over every digit; 2 a block where they all tie).  Keys
// of one value tie on one shared counter; that serialises atomics within
// a warp on data with bulk ties (PERF.md gives the time on the cell's
// data).
//
// The kernels allocate nothing: the wrapper passes a zeroed (2, 2^b) int64
// histogram, which the pass adds to, the state and the values.

#include <cuda_runtime.h>

#include <cstdint>

namespace glabc {

constexpr int kRsThreads = 512;
constexpr int kPickThreads = 256;
constexpr int kRsBlocksPerSm = 4;
constexpr int kRsMaxBits = 11;

__device__ __forceinline__ uint32_t order_key(float v) {
  if (isnan(v)) return 0xFFFFFFFFu;
  const uint32_t u = (v == 0.0f) ? 0u : __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(kRsThreads)
    radix_select_hist_kernel(const float* __restrict__ x, long long n,
                             const long long* __restrict__ prefix,
                             unsigned long long* __restrict__ hist, int shift,
                             int bits) {
  extern __shared__ unsigned int counts[];  // (2, 2^bits)
  const int nb = 1 << bits;
  const unsigned mask = static_cast<unsigned>(nb - 1);
  const int high = shift + bits;  // at most 32: compared as 64-bit
  const unsigned long long p0 = static_cast<unsigned long long>(prefix[0]);
  const unsigned long long p1 = static_cast<unsigned long long>(prefix[1]);
  const bool two = p0 != p1;
  for (int i = threadIdx.x; i < 2 * nb; i += blockDim.x) counts[i] = 0u;
  __syncthreads();

  auto count = [&](float v) {
    const uint32_t key = order_key(v);
    const unsigned long long h = static_cast<unsigned long long>(key) >> high;
    const unsigned d = (key >> shift) & mask;
    if (h == p0) atomicAdd(&counts[d], 1u);
    if (two && h == p1) atomicAdd(&counts[nb + d], 1u);
  };
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const long long n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (long long i = tid; i < n4; i += stride) {
      const float4 v = __ldg(x4 + i);
      count(v.x);
      count(v.y);
      count(v.z);
      count(v.w);
    }
    done = n4 << 2;
  }
  for (long long i = done + tid; i < n; i += stride) count(__ldg(x + i));
  __syncthreads();

  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    const unsigned c0 = counts[i];
    if (c0) {
      atomicAdd(hist + i, static_cast<unsigned long long>(c0));
      if (!two) atomicAdd(hist + nb + i, static_cast<unsigned long long>(c0));
    }
    if (two) {
      const unsigned c1 = counts[nb + i];
      if (c1) atomicAdd(hist + nb + i, static_cast<unsigned long long>(c1));
    }
  }
}

// The value of a key (order_key's inverse, a zero as +0.0).
__device__ __forceinline__ float key_value(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key ^ 0x80000000u) : ~key);
}

// One block: state (prefix_0, prefix_1, k_0, k_1) from the (2, 2^bits)
// histograms; values (2,), where given, the values of the new prefixes.
__global__ void __launch_bounds__(kPickThreads)
    radix_select_pick_kernel(const long long* __restrict__ hist,
                             long long* __restrict__ state, int bits,
                             float* __restrict__ values) {
  __shared__ long long part[kPickThreads];
  __shared__ long long total;
  __shared__ int digit[2];
  __shared__ long long below[2];
  const int nb = 1 << bits;
  const int per = (nb + kPickThreads - 1) / kPickThreads;
  const int b0 = min(nb, static_cast<int>(threadIdx.x) * per);
  const int b1 = min(nb, b0 + per);
  for (int t = 0; t < 2; ++t) {
    const long long* h = hist + static_cast<size_t>(t) * nb;
    const long long k = state[2 + t];
    long long own = 0;
    for (int b = b0; b < b1; ++b) own += h[b];
    part[threadIdx.x] = own;
    __syncthreads();
    if (threadIdx.x == 0) {  // exclusive prefix of the threads' sums
      long long run = 0;
      for (int i = 0; i < kPickThreads; ++i) {
        const long long v = part[i];
        part[i] = run;
        run += v;
      }
      total = run;
      digit[t] = -1;
    }
    __syncthreads();
    long long run = part[threadIdx.x];
    if (run <= k) {  // the crossing bin, if in this chunk: one thread
      for (int b = b0; b < b1; ++b) {
        run += h[b];
        if (run > k) {
          digit[t] = b;
          below[t] = run - h[b];
          break;
        }
      }
    }
    __syncthreads();
    if (threadIdx.x == 0 && digit[t] < 0) {  // k past every key: the last
      digit[t] = nb - 1;
      below[t] = total - h[nb - 1];
    }
    __syncthreads();
  }
  if (threadIdx.x < 2) {
    const int t = threadIdx.x;
    const long long prefix = state[t] * nb + digit[t];
    state[2 + t] -= below[t];
    state[t] = prefix;
    if (values) values[t] = key_value(static_cast<uint32_t>(prefix));
  }
}

}  // namespace glabc

// x (n,) float32; prefix (2,) int64 on the device; hist (2, 2^bits) int64,
// zeroed by the caller, added to.  Returns a CUDA error code (0: launched).
extern "C" int glabc_radix_select_hist(const float* x, long long n,
                                       const long long* prefix,
                                       long long* hist, int shift, int bits,
                                       void* stream) {
  using namespace glabc;
  if (n < 0 || bits < 1 || bits > kRsMaxBits || shift < 0 ||
      shift + bits > 32)
    return -1;
  if (n == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_block = 4LL * kRsThreads;
  long long blocks = (n + per_block - 1) / per_block;
  const long long most = static_cast<long long>(sms) * kRsBlocksPerSm;
  if (blocks > most) blocks = most;
  const size_t smem = 2u * (1u << bits) * sizeof(unsigned int);
  radix_select_hist_kernel<<<static_cast<unsigned>(blocks), kRsThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      x, n, prefix, reinterpret_cast<unsigned long long*>(hist), shift, bits);
  return static_cast<int>(cudaGetLastError());
}

// hist (2, 2^bits) int64 complete; state (4,) int64 updated in place;
// values (2,) float32 or null.  Returns a CUDA error code (0: launched).
extern "C" int glabc_radix_select_pick(const long long* hist,
                                       long long* state, int bits,
                                       float* values, void* stream) {
  using namespace glabc;
  if (bits < 1 || bits > kRsMaxBits) return -1;
  radix_select_pick_kernel<<<1, kPickThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      hist, state, bits, values);
  return static_cast<int>(cudaGetLastError());
}
