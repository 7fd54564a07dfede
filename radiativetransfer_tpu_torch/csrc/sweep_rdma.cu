// The halo-ring per-zone sweep of a 1-D grid mesh for Hopper (sm_90a).
//
// Replaces radiativetransfer_tpu/parallel/sweep_rdma.py::
// _sweep_zone_rdma_kernel (TPU kernel #3): one octant zone's sweep on the
// P k-blocks (nslab, 3, ny, nz/P) of a rotate_to_sweep-ed field.  Only the
// in-slab yz segments (chain code 2, upwind neighbour k-1) cross a block
// edge: rank r's first k-column is rank r-1's exit column of the same slab
// and segment, and rank 0 takes the band's UVB.  On the TPU the exit
// columns travel by in-kernel remote copies into 2-slot ping-pong buffers,
// with reverse ACKs gating slot reuse.
//
// Here every rank lives on one card and every rank's CTAs run in one
// launch: one CTA per (rank, direction, band) walks all slabs of its
// rank's plane (ny x nz/P), as the per-zone kernel #2
// (csrc/sweep_variants.cu) walks a whole plane; zone_segment and upwind are
// copied from there.  For each active yz segment of slab i the CTA of rank
// r < P-1 writes its exit column (ny values) into rank r+1's slot i % 2 of
// that stage and publishes sequence number i + 1 on the slot's flag; the
// CTA of rank r > 0 waits for >= i + 1, reads the line in its stage and
// publishes i + 1 on the slot's ACK; a sender rewrites a slot only after
// the ACK of the line it last wrote there.  The chain tables are the same
// on every rank, so sender and receiver skip the same inactive segments.
// The sequence numbers are zeroed by the caller before each launch, so no
// ACK drain is needed at the end, and the ring stays open (rank P-1 sends
// nothing: the TPU closed it only for its interpreter's lockstep
// rendezvous, and rank 0 masks that line anyway).
//
// Memory order: lines are written with __stcg and read with __ldcg (L2; L1
// is not coherent across SMs); a flag is published by one thread after
// __syncthreads() and __threadfence() with a release store, and waited on
// by one thread with acquire loads, then a barrier.  Every wait is bounded
// by a clock64 budget: an expired wait (or another CTA's) sets *status and
// ends the CTA, and the caller turns that into an error.  A spin on a CTA
// that was never scheduled would hang, so the grid is launched
// cooperatively: a grid that cannot be co-resident is refused before it
// runs.
//
// What bounds it: as #2, FP32 issue and the special-function unit (the
// exps), at a few per cent of that bound; the halo lines add 2 ny values
// per rank edge, stage and slab to the compulsory bytes.  The handshakes
// put each rank one stage behind its left neighbour, so the ring adds a
// pipeline fill of ~2P stages per zone.  Jmean: one atomicAdd per cell,
// direction and band into the rank's block, as #2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (never
// --use_fast_math).  Plain C interface, loaded with ctypes.

#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kSegXZ = 1;  // chain code of an xz segment (shift along j)
constexpr int kSegYZ = 2;  // chain code of a yz segment (shift along k)

// The memory scope of the ring's flags: every rank on one device.  Ranks
// on several devices (peer memory over NVLink) need
// cuda::thread_scope_system here and nowhere else.
constexpr cuda::thread_scope kRingScope = cuda::thread_scope_device;
using FlagRef = cuda::atomic_ref<int, kRingScope>;

// *status after a launch: 0, or a wait of the ring that ran out of time
constexpr int kStatusTimeout = 1;

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }

template <typename T>
__device__ __forceinline__ void swap_planes(T*& a, T*& b) {
  T* t = a;
  a = b;
  b = t;
}

template <typename T>
struct RingParams {
  const T* kappa;     // (ranks, nslab, 3, ny, nz): each rank's k-block
  T* jout;            // the same shape, zeroed
  const T* lens;      // (nslab, ndir, 3): len * cell of xy, xz, yz
  const int* chains;  // (nslab, ndir, 3): chain2, chain3, n_active
  T* scratch;         // (gridDim.x, 3, ny*nz) when planes are global
  T* halo;            // (ranks, ndir, 3, 2 stages, 2 slots, ny): lines
  //                     into each rank
  int* seq;           // (ranks, ndir, 3, 2, 2): the sequence number of
  //                     the line in a slot, zeroed
  int* ack;           // (ranks, ndir, 3, 2, 2): the last one consumed
  int* status;        // one int, zeroed
  T uvb[3];
  T scale;            // angular weight 1/N
  T eps;              // small-tau switch of the logmean
  long long spin_budget;  // clock64 cycles one wait may take
  int ranks, ndir, nslab, ny, nz;  // nz: the block's, nz/P of the field
};

// The three working planes of a CTA: in dynamic shared memory or in its
// slice of the global scratch.
template <typename T, bool SMEM>
__device__ __forceinline__ T* cta_planes(unsigned char* smem, T* scratch,
                                         int plane) {
  return SMEM ? reinterpret_cast<T*>(smem)
              : scratch + static_cast<size_t>(blockIdx.x) * 3 * plane;
}

// The upwind neighbour of cell c = j*nz + k in `src`: along j (chain code
// 1) or k (2), past the block's k edge the left rank's line (`halo`, read
// from L2) or, without one, the band's UVB.
template <typename T>
__device__ __forceinline__ T upwind(const T* src, int c, int nz, int chain,
                                    T pad, const T* halo) {
  const int j = c / nz;
  const int k = c - j * nz;
  if (chain == kSegXZ) return (j > 0) ? src[c - nz] : pad;
  if (k > 0) return src[c - 1];
  return halo ? __ldcg(halo + j) : pad;
}

// One segment of length len: Iout = Iin e^-tau, logmean Iin (1 - e^-tau)/tau
// with the small-tau limit Iin (1 - tau/2).
template <typename T>
__device__ __forceinline__ void zone_segment(T i_in, T kap, T len, T eps,
                                             T& i_out, T& lm) {
  const T tau = kap * len;
  const T a = dev_exp(-tau);
  const T emi = (tau > eps) ? (T(1) - a) / tau : T(1) - T(0.5) * tau;
  i_out = i_in * a;
  lm = i_in * emi;
}

// Thread 0 waits until *flag >= target, within the spin budget; then the
// whole CTA learns whether it may go on (false: this wait, or another
// CTA's, ran out of time).
template <typename T>
__device__ bool wait_flag(const RingParams<T>& p, int* flag, int target) {
  int ok = 1;
  if (threadIdx.x == 0) {
    FlagRef f(*flag);
    FlagRef failed(*p.status);
    const long long t0 = clock64();
    while (f.load(cuda::std::memory_order_acquire) < target) {
      if (failed.load(cuda::std::memory_order_relaxed) != 0) {
        ok = 0;
        break;
      }
      if (clock64() - t0 > p.spin_budget) {
        failed.store(kStatusTimeout, cuda::std::memory_order_relaxed);
        ok = 0;
        break;
      }
    }
  }
  return __syncthreads_and(ok) != 0;
}

// Thread 0 publishes `value` on a flag once every thread's prior stores
// (or reads) of the CTA are done.
__device__ __forceinline__ void publish(int* flag, int value) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    FlagRef(*flag).store(value, cuda::std::memory_order_release);
  }
}

template <typename T, bool SMEM>
__global__ void __launch_bounds__(1024)
sweep_zone_rdma_kernel(const RingParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int per_rank = 3 * p.ndir;
  const int rank = blockIdx.x / per_rank;
  const int chain_id = blockIdx.x - rank * per_rank;  // dir * 3 + band
  const int dir = chain_id / 3;
  const int band = chain_id - 3 * dir;
  const int plane = p.ny * p.nz;
  T* planes = cta_planes<T, SMEM>(smem_raw, p.scratch, plane);
  T* cur = planes;
  T* oth = planes + plane;
  T* jacc = planes + 2 * plane;
  const T pad = p.uvb[band];
  const size_t block = static_cast<size_t>(rank) * p.nslab * 3 * plane;
  const T* kappa = p.kappa + block;
  T* jout = p.jout + block;
  // this chain's 4 slots (stage, slot) of lines into this rank, and those
  // of the same chain into the right rank
  const size_t mine = (static_cast<size_t>(rank) * per_rank + chain_id) * 4;
  const size_t right = mine + static_cast<size_t>(per_rank) * 4;
  const bool has_left = rank > 0;
  const bool has_right = rank + 1 < p.ranks;
  int last_sent[4] = {-1, -1, -1, -1};  // slab of the last line per slot

  for (int c = threadIdx.x; c < plane; c += blockDim.x) cur[c] = pad;

  for (int i = 0; i < p.nslab; ++i) {
    const size_t row = (static_cast<size_t>(i) * p.ndir + dir) * 3;
    const T* l = p.lens + row;
    const int chain[2] = {p.chains[row], p.chains[row + 1]};
    const T n_act = static_cast<T>(p.chains[row + 2]);
    const size_t off = (static_cast<size_t>(i) * 3 + band) * plane;
    const T* kap = kappa + off;

    for (int c = threadIdx.x; c < plane; c += blockDim.x) {
      T i_out, lm;
      zone_segment(cur[c], kap[c], l[0], p.eps, i_out, lm);
      cur[c] = i_out;
      jacc[c] = lm;
    }
    // stage 0: segment 2, stage 1: segment 3 (a chain has no gap)
    for (int s = 0; s < 2 && chain[s] != 0; ++s) {
      const int ch = chain[s];
      const int slot = 2 * s + (i & 1);
      const T* line = nullptr;
      __syncthreads();
      if (ch == kSegYZ) {
        if (has_right) {
          const int last = last_sent[slot];
          if (last >= 0 && !wait_flag(p, p.ack + right + slot, last + 1))
            return;
          T* dst = p.halo + (right + slot) * p.ny;
          for (int j = threadIdx.x; j < p.ny; j += blockDim.x)
            __stcg(dst + j, cur[j * p.nz + p.nz - 1]);
          publish(p.seq + right + slot, i + 1);
          last_sent[slot] = i;
        }
        if (has_left) {
          if (!wait_flag(p, p.seq + mine + slot, i + 1)) return;
          line = p.halo + (mine + slot) * p.ny;
        }
      }
      const T len = (ch == kSegXZ) ? l[1] : l[2];
      for (int c = threadIdx.x; c < plane; c += blockDim.x) {
        T i_out, lm;
        zone_segment(upwind(cur, c, p.nz, ch, pad, line), kap[c], len, p.eps,
                     i_out, lm);
        oth[c] = i_out;
        jacc[c] += lm;
      }
      swap_planes(cur, oth);
      if (line) publish(p.ack + mine + slot, i + 1);
    }
    T* j_slab = jout + off;
    for (int c = threadIdx.x; c < plane; c += blockDim.x)
      atomicAdd(j_slab + c, p.scale * (jacc[c] / n_act));
  }
}

// Launch cooperatively, so that every CTA of the ring is resident at once:
// from min(1024, plane) threads, halve the block until the occupancy
// calculator puts the whole grid on the card's SMs, else refuse
// (cudaErrorCooperativeLaunchTooLarge) without launching.
template <typename T, bool SMEM>
cudaError_t launch_ring(RingParams<T> p, int* launch_info, cudaStream_t s) {
  auto kernel = sweep_zone_rdma_kernel<T, SMEM>;
  const int plane = p.ny * p.nz;
  const size_t smem = SMEM ? 3 * static_cast<size_t>(plane) * sizeof(T) : 0;
  cudaError_t err;
  if (SMEM) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int grid = p.ranks * p.ndir * 3;
  int threads = ((plane + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  int per_sm = 0;
  for (;;) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm * sms >= grid) break;
    if (threads <= 32) {
      launch_info[0] = threads;
      launch_info[1] = per_sm * sms;
      return cudaErrorCooperativeLaunchTooLarge;
    }
    threads = ((threads / 2 + 31) / 32) * 32;
  }
  launch_info[0] = threads;
  launch_info[1] = per_sm * sms;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(grid), dim3(threads), args, smem,
                                     s);
}

template <typename T>
cudaError_t ring_dispatch(const void* kappa, void* jout, const void* lens,
                          const int* chains, void* scratch, void* halo,
                          int* flags, int* status, const double uvb[3],
                          double scale, double eps, long long spin_budget,
                          int ranks, int ndir, int nslab, int ny, int nz,
                          int use_smem, int* launch_info, cudaStream_t s) {
  RingParams<T> p;
  p.kappa = static_cast<const T*>(kappa);
  p.jout = static_cast<T*>(jout);
  p.lens = static_cast<const T*>(lens);
  p.chains = chains;
  p.scratch = static_cast<T*>(scratch);
  p.halo = static_cast<T*>(halo);
  p.seq = flags;
  p.ack = flags + static_cast<size_t>(ranks) * ndir * 3 * 4;
  p.status = status;
  for (int b = 0; b < 3; ++b) p.uvb[b] = static_cast<T>(uvb[b]);
  p.scale = static_cast<T>(scale);
  p.eps = static_cast<T>(eps);
  p.spin_budget = spin_budget;
  p.ranks = ranks;
  p.ndir = ndir;
  p.nslab = nslab;
  p.ny = ny;
  p.nz = nz;
  if (use_smem) return launch_ring<T, true>(p, launch_info, s);
  return launch_ring<T, false>(p, launch_info, s);
}

}  // namespace

extern "C" {

// One zone's ring sweep over `ranks` k-blocks x ndir directions x 3 bands
// on `stream`.  dtype: 0 = float32, 1 = float64.  flags: 2 * ranks * ndir
// * 12 ints (sequence numbers, then ACKs), zeroed; halo: ranks * ndir * 12
// * ny values; status: one int, zeroed, 1 after a wait ran out of
// spin_budget cycles.  launch_info (host): the block size and the CTAs the
// card holds at once.  Returns the cudaError_t of the launch
// (cudaErrorCooperativeLaunchTooLarge: the grid cannot be co-resident).
int rt_sweep_zone_rdma(int dtype, const void* kappa, void* jout,
                       const void* lens, const int* chains, void* scratch,
                       void* halo, int* flags, int* status, double uvb0,
                       double uvb1, double uvb2, double scale, double eps,
                       long long spin_budget, int ranks, int ndir, int nslab,
                       int ny, int nz, int use_smem, int* launch_info,
                       void* stream) {
  const double uvb[3] = {uvb0, uvb1, uvb2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ranks < 1 || ndir < 1 || nslab < 1 || ny < 1 || nz < 1)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return ring_dispatch<float>(kappa, jout, lens, chains, scratch, halo,
                                flags, status, uvb, scale, eps, spin_budget,
                                ranks, ndir, nslab, ny, nz, use_smem,
                                launch_info, s);
  if (dtype == 1)
    return ring_dispatch<double>(kappa, jout, lens, chains, scratch, halo,
                                 flags, status, uvb, scale, eps, spin_budget,
                                 ranks, ndir, nslab, ny, nz, use_smem,
                                 launch_info, s);
  return cudaErrorInvalidValue;
}

const char* rt_rdma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
