// Merged flip-folded diffuse sweep for Hopper (sm_90a).
//
// Replaces: radiativetransfer_tpu/core/sweep_pallas.py::_merged_kernel (the
// TPU wavefront kernel of the JAX package).  Same mathematics: every
// direction of the plan walks its slabs in order; per slab each cell runs
// up to 3 chained ray segments (attenuate by exp(kappa*len_n), logmean
// emissivity in the exact two-branch or the clamped branch-free form,
// upwind shift along j or k between segments, reversed under a flip with
// the band's UVB as the boundary pad); the top-exit plane is carried to
// the next slab and weight * inv_n * sum(logmean) is added into Jmean.
//
// What bounds it on this card: per cell, direction and band it runs up to
// 3 exp (the SFU; IEEE expf, no fast math) and ~20 other FP32 ops, against
// about 8 bytes streamed per cell-band per direction (kappa and 1/kappa
// reads from L1/L2) plus one Jmean atomic add.  That is exp/SFU and FP32
// issue once the planes stay on chip, so the design keeps every
// intermediate on chip and spends no instruction on what can be hoisted:
//
// * one CTA owns one (direction, band) plane and walks all nslab slabs in
//   its own loop (TPU grid steps run in order, CUDA blocks do not), so the
//   carry never leaves the CTA; 3 * ndir CTAs (576 at 192 directions) fill
//   132 SMs in ~4.4 waves;
// * the carry, one staging plane and the per-slab logmean accumulator live
//   in dynamic shared memory when 3 planes fit (128^2 f32 = 192 KB), else in
//   a per-CTA global scratch slice (256^2 f32: 768 KB);
// * the in-slab stencil crosses threads, so each active chain segment is
//   one stage with a __syncthreads() before it; inactive segments are
//   skipped by a CTA-uniform branch;
// * 1/kappa is hoisted out of the kernel (one division per cell-band per
//   sweep, by the caller) and segment-length reciprocals come from the host
//   tables, so the logmean costs multiplies, not divides;
// * Jmean is accumulated with one atomicAdd per cell, direction and band
//   into a zeroed buffer (the order of the 192 adds varies run to run).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// (never --use_fast_math: the clamped-vs-exact bounds were set with IEEE exp
// and division; -fmad=false keeps each op rounded as the plain PyTorch
// version rounds it).  Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPerms = 6;  // axis permutations of the 24 octant zones

template <typename T>
struct SweepParams {
  // per axis permutation, each (3, nslab, ny, nz) in that permutation's
  // order: kappa, its hoisted reciprocal, and the zeroed Jmean output
  const T* kappa[kMaxPerms];
  const T* inv_kappa[kMaxPerms];
  T* jout[kMaxPerms];
  const int* dir_meta;   // (ndir, 4): perm index, reverse, flip_j, flip_k
  const T* lens;         // (ndir, nslab, 8): -len*cell x3, inv_n,
                         //                   -1/(len*cell) x3, pad
  const int* chains;     // (ndir, nslab, 2): chain2, chain3 (0/1=XZ/2=YZ)
  T* scratch;            // (gridDim.x, 3, ny*nz) when planes are global
  T uvb[3];
  T scale;               // angular weight 1/N
  T eps;                 // small-tau switch of the exact logmean
  T a_eps;               // exp(-EPS_CL) of the clamped logmean
  T inv_eps_cl;          // 1/EPS_CL
  int nslab, ny, nz;
};

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
__device__ __forceinline__ float dev_min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double dev_min(double a, double b) { return fmin(a, b); }

// One segment: len_n = -length*cell, inv_len_n = 1/len_n.
template <typename T, bool CLAMPED>
__device__ __forceinline__ void segment(const SweepParams<T>& p, T i_in, T kap,
                                        T inv_kap, T len_n, T inv_len_n,
                                        T& i_out, T& lm) {
  const T tau_n = kap * len_n;  // = -tau
  const T a = dev_exp(tau_n);
  i_out = i_in * a;
  if (CLAMPED) {
    // 1 - min(a, a_eps) is exact for a >= 1/2: one rounding in d
    const T d = i_in * (T(1) - dev_min(a, p.a_eps));
    const T r = dev_min(inv_kap * (-inv_len_n), p.inv_eps_cl);
    lm = d * r;
  } else {
    const T emi = (tau_n < -p.eps) ? (a - T(1)) * inv_kap * inv_len_n
                                   : T(1) + T(0.5) * tau_n;
    lm = i_in * emi;
  }
}

// Chain segment 2 or 3 over the plane: reads `src` one cell upwind along j
// (chain code 1) or k (chain code 2), writes `dst`, accumulates into jacc.
template <typename T, bool CLAMPED>
__device__ __forceinline__ void chained_stage(
    const SweepParams<T>& p, const T* __restrict__ kap_slab,
    const T* __restrict__ ikap_slab, const T* src, T* dst, T* jacc, int chain,
    bool flip_j, bool flip_k, T pad, T len_n, T inv_len_n) {
  const int ny = p.ny, nz = p.nz, plane = ny * nz;
  for (int c = threadIdx.x; c < plane; c += blockDim.x) {
    const int j = c / nz;
    const int k = c - j * nz;
    T i_in;
    if (chain == 1) {
      if (flip_j) i_in = (j + 1 < ny) ? src[c + nz] : pad;
      else        i_in = (j > 0) ? src[c - nz] : pad;
    } else {
      if (flip_k) i_in = (k + 1 < nz) ? src[c + 1] : pad;
      else        i_in = (k > 0) ? src[c - 1] : pad;
    }
    T i_out, lm;
    segment<T, CLAMPED>(p, i_in, kap_slab[c], ikap_slab[c], len_n, inv_len_n,
                        i_out, lm);
    dst[c] = i_out;
    jacc[c] += lm;
  }
}

template <typename T, bool CLAMPED, bool SMEM>
__global__ void __launch_bounds__(1024)
sweep_merged_kernel(const SweepParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dir = blockIdx.x / 3;
  const int band = blockIdx.x - 3 * dir;
  const int nslab = p.nslab, plane = p.ny * p.nz;

  T* planes = SMEM ? reinterpret_cast<T*>(smem_raw)
                   : p.scratch + static_cast<size_t>(blockIdx.x) * 3 * plane;
  T* cur = planes;            // carry: the top-exit intensity plane
  T* oth = planes + plane;    // staging plane of the chained stages
  T* jacc = planes + 2 * plane;

  const int* meta = p.dir_meta + 4 * dir;
  const int perm = meta[0];
  const bool reverse = meta[1] != 0;
  const bool flip_j = meta[2] != 0;
  const bool flip_k = meta[3] != 0;
  const size_t band_off = static_cast<size_t>(band) * nslab * plane;
  const T* kap_band = p.kappa[perm] + band_off;
  const T* ikap_band = p.inv_kappa[perm] + band_off;
  T* j_band = p.jout[perm] + band_off;
  const T pad = p.uvb[band];

  for (int c = threadIdx.x; c < plane; c += blockDim.x) cur[c] = pad;

  for (int i = 0; i < nslab; ++i) {
    const int s = reverse ? nslab - 1 - i : i;
    const size_t row = static_cast<size_t>(dir) * nslab + i;
    const T* l = p.lens + 8 * row;
    const int ch2 = p.chains[2 * row];
    const int ch3 = p.chains[2 * row + 1];
    const size_t slab_off = static_cast<size_t>(s) * plane;
    const T* kap_slab = kap_band + slab_off;
    const T* ikap_slab = ikap_band + slab_off;

    // segment 1 (xy): each thread touches only its own cells, in place
    for (int c = threadIdx.x; c < plane; c += blockDim.x) {
      T i_out, lm;
      segment<T, CLAMPED>(p, cur[c], kap_slab[c], ikap_slab[c], l[0], l[4],
                          i_out, lm);
      cur[c] = i_out;
      jacc[c] = lm;
    }
    if (ch2 != 0) {
      __syncthreads();
      chained_stage<T, CLAMPED>(p, kap_slab, ikap_slab, cur, oth, jacc, ch2,
                                flip_j, flip_k, pad, l[1], l[5]);
      T* t = cur; cur = oth; oth = t;
      if (ch3 != 0) {
        __syncthreads();
        chained_stage<T, CLAMPED>(p, kap_slab, ikap_slab, cur, oth, jacc, ch3,
                                  flip_j, flip_k, pad, l[2], l[6]);
        t = cur; cur = oth; oth = t;
      }
    }
    // jacc[c] and cur[c] of the next slab's segment 1 are this thread's own
    // cells; the next write of a plane that neighbours read (oth) comes
    // after the next stage's __syncthreads()
    const T inv_n = l[3];
    T* j_slab = j_band + slab_off;
    for (int c = threadIdx.x; c < plane; c += blockDim.x)
      atomicAdd(j_slab + c, p.scale * (inv_n * jacc[c]));
  }
}

template <typename T, bool CLAMPED, bool SMEM>
cudaError_t launch(const SweepParams<T>& p, int ndir, cudaStream_t stream) {
  const int plane = p.ny * p.nz;
  int threads = ((plane + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = SMEM ? 3 * static_cast<size_t>(plane) * sizeof(T) : 0;
  auto kernel = sweep_merged_kernel<T, CLAMPED, SMEM>;
  if (SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<3 * ndir, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int nperm, const void* const* kappa,
                     const void* const* inv_kappa, void* const* jout,
                     const int* dir_meta, const void* lens, const int* chains,
                     void* scratch, const double uvb[3], double scale,
                     double eps, double a_eps, double inv_eps_cl, int ndir,
                     int nslab, int ny, int nz, int clamped, int use_smem,
                     cudaStream_t stream) {
  SweepParams<T> p;
  for (int q = 0; q < kMaxPerms; ++q) {
    const bool used = q < nperm;
    p.kappa[q] = used ? static_cast<const T*>(kappa[q]) : nullptr;
    p.inv_kappa[q] = used ? static_cast<const T*>(inv_kappa[q]) : nullptr;
    p.jout[q] = used ? static_cast<T*>(jout[q]) : nullptr;
  }
  for (int b = 0; b < 3; ++b) p.uvb[b] = static_cast<T>(uvb[b]);
  p.dir_meta = dir_meta;
  p.lens = static_cast<const T*>(lens);
  p.chains = chains;
  p.scratch = static_cast<T*>(scratch);
  p.scale = static_cast<T>(scale);
  p.eps = static_cast<T>(eps);
  p.a_eps = static_cast<T>(a_eps);
  p.inv_eps_cl = static_cast<T>(inv_eps_cl);
  p.nslab = nslab;
  p.ny = ny;
  p.nz = nz;
  if (clamped) {
    return use_smem ? launch<T, true, true>(p, ndir, stream)
                    : launch<T, true, false>(p, ndir, stream);
  }
  return use_smem ? launch<T, false, true>(p, ndir, stream)
                  : launch<T, false, false>(p, ndir, stream);
}

}  // namespace

extern "C" {

// Launches one merged sweep over all ndir directions x 3 bands on `stream`.
// dtype: 0 = float32, 1 = float64.  kappa/inv_kappa/jout: host arrays of
// nperm (<= 6) device pointers, one per axis permutation.  Returns the
// cudaError_t of the launch (0 on success); the kernel runs asynchronously.
int rt_sweep_merged(int dtype, int nperm, const void* const* kappa,
                    const void* const* inv_kappa, void* const* jout,
                    const int* dir_meta, const void* lens, const int* chains,
                    void* scratch, double uvb0, double uvb1, double uvb2,
                    double scale, double eps, double a_eps, double inv_eps_cl,
                    int ndir, int nslab, int ny, int nz, int clamped,
                    int use_smem, void* stream) {
  const double uvb[3] = {uvb0, uvb1, uvb2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nperm < 1 || nperm > kMaxPerms || ndir < 1) return cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(nperm, kappa, inv_kappa, jout, dir_meta, lens,
                          chains, scratch, uvb, scale, eps, a_eps, inv_eps_cl,
                          ndir, nslab, ny, nz, clamped, use_smem, s);
  } else if (dtype == 1) {
    err = dispatch<double>(nperm, kappa, inv_kappa, jout, dir_meta, lens,
                           chains, scratch, uvb, scale, eps, a_eps,
                           inv_eps_cl, ndir, nslab, ny, nz, clamped, use_smem,
                           s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
