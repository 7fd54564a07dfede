// Row scatter-add for Hopper (sm_90a): acc[idx[r], :] += vals[r, :] for
// rows of 8 float32 values, in place.
//
// Replaces: scripts/exp_pallas_scatter.py::_scatter_kernel, the TPU
// experiment that kept a (N^3, 8) accumulator in VMEM and walked the rows
// with a scalar loop: the deposit pattern of the point-source tracer
// (core/rays.py's index_add_ deposits), 8 channels per cell.
//
// What bounds it on this card: per row 4 bytes of index and 32 of values
// read, and the touched 32-byte sector of the accumulator read and written
// (100 bytes), against 8 adds: HBM bytes, and the latency of scattered
// read-modify-writes in L2.  The design: one thread per row, two 16-byte
// vector atomics (atomicAdd on float4, global memory, compute capability
// 9.x), so each row is two L2 atomic operations and neighbouring threads
// stream their index and value loads.  The TPU kernel's order of adds is
// fixed; here rows that share a cell add in no fixed order, so sums of
// several rows vary by float32 rounding from run to run.  A row whose index
// lies outside the accumulator is dropped, as JAX's scatter drops such
// updates: nothing is written out of bounds.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false.  Plain
// C interface, loaded with ctypes.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
scatter_rows_kernel(float4* __restrict__ acc, long long n_cells,
                    const int* __restrict__ idx,
                    const float4* __restrict__ vals, long long m) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (r >= m) return;
  const long long cell = idx[r];
  if (cell < 0 || cell >= n_cells) return;
  const float4 lo = vals[2 * r];
  const float4 hi = vals[2 * r + 1];
  atomicAdd(acc + 2 * cell, lo);
  atomicAdd(acc + 2 * cell + 1, hi);
}

}  // namespace

extern "C" {

// acc (n_cells, 8) += rows vals (m, 8) at cells idx (m,), on `stream`;
// rows with idx outside [0, n_cells) are dropped.  acc and vals must be
// 16-byte aligned.  Returns the cudaError_t of the launch (0 on success).
int rt_scatter_rows(float* acc, long long n_cells, const int* idx,
                    const float* vals, long long m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1) return cudaErrorInvalidValue;
  constexpr int kThreads = 256;
  const long long blocks = (m + kThreads - 1) / kThreads;
  scatter_rows_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
      reinterpret_cast<float4*>(acc), n_cells, idx,
      reinterpret_cast<const float4*>(vals), m);
  return cudaGetLastError();
}

const char* rt_scatter_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
