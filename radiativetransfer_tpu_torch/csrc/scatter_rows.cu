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
// (100 bytes), against 8 adds: HBM bytes, and the throughput of scattered
// read-modify-writes in L2 (a (128^3, 8) accumulator is 67 MB, more than
// the 50 MB L2, and rows land on random sectors).  The design:
//
// * each thread takes kRows rows, kRows * gridDim.x * blockDim.x apart in
//   a grid-stride loop (a warp's rows stay contiguous), and issues all
//   their index and value loads before its first reduction, so kRows rows
//   of loads are in flight per thread;
// * the index and value loads are streaming loads (ld.global.cs,
//   evict-first), so the once-read rows do not displace the accumulator's
//   sectors in L2;
// * each row is two 16-byte vector reductions (atomicAdd on float4 with
//   its result unused: red.global.add.v4.f32, compute capability 9.x);
// * the grid is sized to the SMs: at most the blocks the card holds at
//   once (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs),
//   one wave.
//
// The TPU kernel's order of adds is fixed; here rows that share a cell add
// in no fixed order, so sums of several rows vary by float32 rounding from
// run to run.  A row whose index lies outside the accumulator is dropped,
// as JAX's scatter drops such updates: nothing is written out of bounds.
//
// Also the floor probe (rt_red_floor): the same reductions of ones into
// cells hashed from the row number, with no index or value loads, into an
// accumulator that fits L2 or into the 67 MB one: the most float4
// reductions per second this card takes into random 32-byte sectors.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false.  Plain
// C interface, loaded with ctypes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// rows a thread
constexpr int kRows = 4;

__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(float4* __restrict__ acc, long long n_cells,
                    const int* __restrict__ idx,
                    const float4* __restrict__ vals, long long m) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
       base < m; base += kRows * stride) {
    int cell[kRows];
    float4 lo[kRows], hi[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const long long r = base + q * stride;
      if (r < m) {
        cell[q] = __ldcs(idx + r);
        lo[q] = __ldcs(vals + 2 * r);
        hi[q] = __ldcs(vals + 2 * r + 1);
      } else {
        cell[q] = -1;
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      if (cell[q] < 0 || cell[q] >= n_cells) continue;
      float4* row = acc + 2 * static_cast<long long>(cell[q]);
      atomicAdd(row, lo[q]);
      atomicAdd(row + 1, hi[q]);
    }
  }
}

// A 32-bit integer hash (lowbias32): the floor probe's cells, and
// core/scatter_cuda.py::red_floor_cells's.
__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__global__ void __launch_bounds__(kThreads)
red_floor_kernel(float4* __restrict__ acc, long long n_cells, long long m) {
  const float4 one = make_float4(1.f, 1.f, 1.f, 1.f);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < m; r += stride) {
    const long long cell = hash32(static_cast<uint32_t>(r)) % n_cells;
    atomicAdd(acc + 2 * cell, one);
    atomicAdd(acc + 2 * cell + 1, one);
  }
}

// The blocks of `kernel` the current device holds at once (kThreads
// threads, no shared memory); 0 where a query fails.
long long resident_blocks(const void* kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    0) != cudaSuccess)
    return 0;
  return static_cast<long long>(sms) * per_sm;
}

// Blocks for m rows at kRows rows a thread: one pass over the rows, and at
// most the `resident` blocks the card holds at once.
unsigned int grid_for(long long m, long long resident) {
  long long blocks = (m + static_cast<long long>(kThreads) * kRows - 1) /
                     (static_cast<long long>(kThreads) * kRows);
  if (resident > 0 && blocks > resident) blocks = resident;
  return static_cast<unsigned int>(blocks);
}

}  // namespace

extern "C" {

// acc (n_cells, 8) += rows vals (m, 8) at cells idx (m,), on `stream`;
// rows with idx outside [0, n_cells) are dropped.  acc and vals must be
// 16-byte aligned.  Returns the cudaError_t of the launch (0 on success).
int rt_scatter_rows(float* acc, long long n_cells, const int* idx,
                    const float* vals, long long m, void* stream) {
  if (m < 1 || n_cells < 1) return cudaErrorInvalidValue;
  // asked once (the first launch's device)
  static const long long resident =
      resident_blocks(reinterpret_cast<const void*>(scatter_rows_kernel));
  scatter_rows_kernel<<<grid_for(m, resident), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<float4*>(acc), n_cells, idx,
      reinterpret_cast<const float4*>(vals), m);
  return cudaGetLastError();
}

// The floor probe: 2 float4 reductions of ones per row r < m into the cell
// hash32(r) % n_cells of acc (n_cells, 8).  Returns the cudaError_t of the
// launch.
int rt_red_floor(float* acc, long long n_cells, long long m, void* stream) {
  if (m < 1 || n_cells < 1) return cudaErrorInvalidValue;
  static const long long resident =
      resident_blocks(reinterpret_cast<const void*>(red_floor_kernel));
  red_floor_kernel<<<grid_for(m, resident), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<float4*>(acc), n_cells, m);
  return cudaGetLastError();
}

const char* rt_scatter_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
