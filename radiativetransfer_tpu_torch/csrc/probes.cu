// Elementwise chain probes for Hopper (sm_90a): the card's own stream, exp,
// div and fma rates, the floors of the sweep kernel's roofline.
//
// Replaces two TPU kernels of the JAX package:
// * bench.py::_exp_kernel (8 chained exp(-x) per element, the bench's exp
//   throughput probe): body exp, depth 8;
// * scripts/roofline_sweep.py::_plane_call (one elementwise body per
//   element over a (3, N, N, N) field): v + 1 at depth 1 (the HBM stream),
//   and 64-deep chains of exp(-x), 1/(x + 1.5) and x*1.0000001 + 0.1.
// A fifth body, exp2(-x), is exp2f as csrc/sweep_variants.cu's exp2 variant
// issues it: its SASS gives that variant's FP32 count per exp.
//
// The chains: one kernel, x -> o over a contiguous float32 array, with the
// body a template parameter and the depth a run-time one.  Each step of a
// chain reads the last, so the compiler cannot fold it; a grid-stride loop
// walks the array in 16-byte float4 loads and stores.
//
// The stream (v + 1, depth 1) has a kernel of its own, the shape of
// PyTorch's vectorised elementwise add: one pass, no grid-stride loop;
// each thread issues its kStreamUnroll float4 loads (blockDim apart, so a
// warp's loads stay coalesced) before any store, with streaming hints
// (__ldcs, __stcs: each byte is read once and written once, nothing to
// keep in L1 or L2).  The grid-stride chain kernel held one load in flight
// before each store and ran 0.5-0.7% behind torch.add at 256^3 on the
// H100; the block size and unroll were fitted there (PERF.md).
//
// What bounds it on this card: the stream body moves 8 bytes per element
// for one add, so it is bound by HBM bytes (3.35 TB/s published).  The
// 64-deep chains do 64 dependent operations per element against the same 8
// bytes: exp and div are bound by the special-function unit (expf is
// ex2.approx on the SFU plus a few FP32 instructions for the range
// reduction; IEEE division a reciprocal on the SFU plus its Newton
// correction), fma by FP32 issue.  Each thread carries 4 independent chains
// (the float4 lanes) and many warps per SM hide the dependent latency.
//
// Build: the flags of csrc/sweep_merged.cu (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -fmad=false, never --use_fast_math), so
// expf and the division are the very instructions the sweep kernel issues;
// with -fmad=false the fma body compiles to a separate multiply and add (2
// FP32 ops).  Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

namespace {

enum Body : int { kExp = 0, kStream = 1, kDiv = 2, kFma = 3, kExp2 = 4 };

template <int BODY>
__device__ __forceinline__ float step(float acc) {
  if (BODY == kExp) return expf(-acc);
  if (BODY == kExp2) return exp2f(-acc);
  if (BODY == kStream) return acc + 1.0f;
  if (BODY == kDiv) return 1.0f / (acc + 1.5f);
  return acc * 1.0000001f + 0.1f;
}

template <int BODY>
__device__ __forceinline__ float chain(float v, int depth) {
  for (int d = 0; d < depth; ++d) v = step<BODY>(v);
  return v;
}

template <int BODY>
__global__ void __launch_bounds__(256)
chain_kernel(const float* __restrict__ x, float* __restrict__ o,
             long long n, int depth) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const long long n4 = n / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(o);
  for (long long i = first; i < n4; i += stride) {
    float4 v = x4[i];
    for (int d = 0; d < depth; ++d) {
      v.x = step<BODY>(v.x);
      v.y = step<BODY>(v.y);
      v.z = step<BODY>(v.z);
      v.w = step<BODY>(v.w);
    }
    o4[i] = v;
  }
  // the ragged tail (n not a multiple of 4), one element per thread
  for (long long i = 4 * n4 + first; i < n; i += stride)
    o[i] = chain<BODY>(x[i], depth);
}

// the stream's launch shape, fitted on the H100 (PERF.md)
constexpr int kStreamThreads = 256;
constexpr int kStreamUnroll = 2;

__global__ void __launch_bounds__(kStreamThreads)
stream_kernel(const float* __restrict__ x, float* __restrict__ o,
              long long n) {
  const long long n4 = n / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(o);
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x * kStreamUnroll +
      threadIdx.x;
  float4 v[kStreamUnroll];
#pragma unroll
  for (int u = 0; u < kStreamUnroll; ++u) {
    const long long i = first + static_cast<long long>(u) * blockDim.x;
    if (i < n4) v[u] = __ldcs(x4 + i);
  }
#pragma unroll
  for (int u = 0; u < kStreamUnroll; ++u) {
    const long long i = first + static_cast<long long>(u) * blockDim.x;
    if (i < n4) {
      v[u].x = step<kStream>(v[u].x);
      v[u].y = step<kStream>(v[u].y);
      v[u].z = step<kStream>(v[u].z);
      v[u].w = step<kStream>(v[u].w);
      __stcs(o4 + i, v[u]);
    }
  }
  // the ragged tail (n not a multiple of 4): at most 3 values
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4)
    o[4 * n4 + threadIdx.x] = step<kStream>(x[4 * n4 + threadIdx.x]);
}

cudaError_t launch_stream(const float* x, float* o, long long n,
                          cudaStream_t stream) {
  const long long per_block =
      static_cast<long long>(kStreamThreads) * kStreamUnroll;
  long long blocks = (n / 4 + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  stream_kernel<<<static_cast<unsigned>(blocks), kStreamThreads, 0, stream>>>(
      x, o, n);
  return cudaGetLastError();
}

template <int BODY>
cudaError_t launch(const float* x, float* o, long long n, int depth,
                   cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  constexpr int kThreads = 256;
  const long long work = n / 4 > 0 ? n / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  // 8 resident blocks of 256 threads fill an SM's 2048 threads; beyond 16
  // waves of them a block just loops
  const long long cap = 16LL * 8 * sms;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  chain_kernel<BODY><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      x, o, n, depth);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// o = depth-fold body(x), elementwise over n float32 values on `stream`.
// body: 0 exp(-v), 1 v + 1 (the stream kernel, depth 1 only), 2 1/(v +
// 1.5), 3 v*1.0000001 + 0.1, 4 exp2(-v).  x and o
// must be 16-byte aligned.  Returns the cudaError_t of the launch (0 on
// success); the kernel runs asynchronously.
int rt_chain(int body, int depth, const float* x, float* o, long long n,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || depth < 1) return cudaErrorInvalidValue;
  switch (body) {
    case kExp: return launch<kExp>(x, o, n, depth, s);
    case kStream:
      if (depth != 1) return cudaErrorInvalidValue;
      return launch_stream(x, o, n, s);
    case kDiv: return launch<kDiv>(x, o, n, depth, s);
    case kFma: return launch<kFma>(x, o, n, depth, s);
    case kExp2: return launch<kExp2>(x, o, n, depth, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* rt_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
