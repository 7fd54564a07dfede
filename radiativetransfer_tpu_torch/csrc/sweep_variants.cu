// The per-zone sweep and the two sweep experiments for Hopper (sm_90a).
//
// Replaces three TPU kernels of the JAX package:
// * radiativetransfer_tpu/core/sweep_pallas.py::_sweep_zone_kernel (#2):
//   one octant zone's sweep over a rotate_to_sweep-ed (nslab, 3, ny, nz)
//   field, the exact logmean (1 - a)/tau with its division, one launch per
//   zone.  It is the body that parallel/sweep_rdma.py wraps in a halo ring;
// * scripts/exp_sweep_pair.py::_pair_kernel (#6): the merged flip-folded
//   sweep (exact logmean, hoisted 1/kappa) walking two slabs per step;
// * scripts/exp_sweep_variants.py::_lean_kernel (#7): the merged sweep with
//   act-folded 16-slot tables (lm from i_out - i_in, no masks), with the
//   flags clamped, exp2, seg1, noemi and noshift of its variants.
//
// The pair and lean kernels here are the plane kernels that the cluster
// instances of csrc/sweep_cluster_exp.cu are timed against (core/
// variants_cuda.py launches those, and these where no cluster shape fits).
//
// Every kernel keeps the design of csrc/sweep_merged.cu (kernel #1), whose
// bound is FP32 issue and the special-function unit once the planes stay on
// chip: one CTA per (direction, band) plane walks all slabs in its own loop,
// so the carry never leaves the CTA; the carry, a staging plane and the
// logmean accumulator sit in dynamic shared memory when 3 planes fit, else
// in a per-CTA global scratch slice; each chained segment reads in-plane
// neighbours, so it is one stage with a __syncthreads() before it; Jmean is
// accumulated by one atomicAdd per cell, direction and band.  What each
// adds:
// * the zone kernel reads its zone's (nslab, D, 3) tables and skips
//   inactive segments by a CTA-uniform branch (the TPU kernel evaluates and
//   masks them: the same function, since a masked term adds 0);
// * the pair kernel fuses the last segment of the pair's first slab, that
//   slab's Jmean deposit and the second slab's segment 1 into one pass over
//   the thread's own cells: the carry between the two slabs stays in
//   registers and one store and reload of the carry and of the accumulator
//   per pair go away;
// * the lean kernel is a template over the variant's flags.  exp2 is
//   IEEE-rounded exp2f on lengths pre-scaled by log2(e) (no fast math);
//   noshift reads the thread's own cell, so its stages need no barrier;
//   noemi evaluates inactive segments too, as the TPU kernel does, since
//   there they add i_in.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (never
// --use_fast_math: each operation rounds as the plain PyTorch versions
// round it).  Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPerms = 6;  // axis permutations of the 24 octant zones
constexpr int kSegXZ = 1;     // chain code of an xz segment (shift along j)

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
__device__ __forceinline__ float dev_exp2(float x) { return exp2f(x); }
__device__ __forceinline__ double dev_exp2(double x) { return exp2(x); }
__device__ __forceinline__ float dev_min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double dev_min(double a, double b) { return fmin(a, b); }

template <typename T>
__device__ __forceinline__ void swap_planes(T*& a, T*& b) {
  T* t = a;
  a = b;
  b = t;
}

// The three working planes of a CTA: in dynamic shared memory or in its
// slice of the global scratch.
template <typename T, bool SMEM>
__device__ __forceinline__ T* cta_planes(unsigned char* smem, T* scratch,
                                         int plane) {
  return SMEM ? reinterpret_cast<T*>(smem)
              : scratch + static_cast<size_t>(blockIdx.x) * 3 * plane;
}

// The upwind neighbour of cell c = j*nz + k in `src`: along j (chain code
// 1) or k (2), reversed under a flip, the band's UVB past the edge.
template <typename T>
__device__ __forceinline__ T upwind(const T* src, int c, int ny, int nz,
                                    int chain, bool flip_j, bool flip_k,
                                    T pad) {
  const int j = c / nz;
  const int k = c - j * nz;
  if (chain == kSegXZ) {
    if (flip_j) return (j + 1 < ny) ? src[c + nz] : pad;
    return (j > 0) ? src[c - nz] : pad;
  }
  if (flip_k) return (k + 1 < nz) ? src[c + 1] : pad;
  return (k > 0) ? src[c - 1] : pad;
}

// ---------------------------------------------------------------------------
// #2: one zone on a rotated field
// ---------------------------------------------------------------------------

template <typename T>
struct ZoneParams {
  const T* kappa;     // (nslab, 3, ny, nz), rotated to the zone's sweep
  T* jout;            // (nslab, 3, ny, nz), zeroed
  const T* lens;      // (nslab, ndir, 3): len * cell of xy, xz, yz
  const int* chains;  // (nslab, ndir, 3): chain2, chain3, n_active
  T* scratch;         // (gridDim.x, 3, ny*nz) when planes are global
  T uvb[3];
  T scale;            // angular weight 1/N
  T eps;              // small-tau switch of the logmean
  int ndir, nslab, ny, nz;
};

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

template <typename T>
__device__ __forceinline__ void zone_stage(const ZoneParams<T>& p,
                                           const T* __restrict__ kap,
                                           const T* src, T* dst, T* jacc,
                                           int chain, T pad, T len) {
  const int plane = p.ny * p.nz;
  for (int c = threadIdx.x; c < plane; c += blockDim.x) {
    T i_out, lm;
    zone_segment(upwind(src, c, p.ny, p.nz, chain, false, false, pad), kap[c],
                 len, p.eps, i_out, lm);
    dst[c] = i_out;
    jacc[c] += lm;
  }
}

template <typename T, bool SMEM>
__global__ void __launch_bounds__(1024)
sweep_zone_kernel(const ZoneParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dir = blockIdx.x / 3;
  const int band = blockIdx.x - 3 * dir;
  const int plane = p.ny * p.nz;
  T* planes = cta_planes<T, SMEM>(smem_raw, p.scratch, plane);
  T* cur = planes;
  T* oth = planes + plane;
  T* jacc = planes + 2 * plane;
  const T pad = p.uvb[band];

  for (int c = threadIdx.x; c < plane; c += blockDim.x) cur[c] = pad;

  for (int i = 0; i < p.nslab; ++i) {
    const size_t row = (static_cast<size_t>(i) * p.ndir + dir) * 3;
    const T* l = p.lens + row;
    const int ch2 = p.chains[row];
    const int ch3 = p.chains[row + 1];
    const T n_act = static_cast<T>(p.chains[row + 2]);
    const size_t off = (static_cast<size_t>(i) * 3 + band) * plane;
    const T* kap = p.kappa + off;

    for (int c = threadIdx.x; c < plane; c += blockDim.x) {
      T i_out, lm;
      zone_segment(cur[c], kap[c], l[0], p.eps, i_out, lm);
      cur[c] = i_out;
      jacc[c] = lm;
    }
    if (ch2 != 0) {
      __syncthreads();
      zone_stage(p, kap, cur, oth, jacc, ch2, pad, ch2 == kSegXZ ? l[1] : l[2]);
      swap_planes(cur, oth);
      if (ch3 != 0) {
        __syncthreads();
        zone_stage(p, kap, cur, oth, jacc, ch3, pad,
                   ch3 == kSegXZ ? l[1] : l[2]);
        swap_planes(cur, oth);
      }
    }
    T* j_slab = p.jout + off;
    for (int c = threadIdx.x; c < plane; c += blockDim.x)
      atomicAdd(j_slab + c, p.scale * (jacc[c] / n_act));
  }
}

// ---------------------------------------------------------------------------
// #6 and #7: merged launches (all directions of every permutation at once)
// ---------------------------------------------------------------------------

template <typename T>
struct MergedParams {
  // per axis permutation, each (3, nslab, ny, nz) in that permutation's
  // order: kappa, its hoisted reciprocal and the zeroed Jmean output
  const T* kappa[kMaxPerms];
  const T* inv_kappa[kMaxPerms];
  T* jout[kMaxPerms];
  const int* dir_meta;   // (ndir, 4): perm index, reverse, flip_j, flip_k
  const T* lens;         // (ndir, nslab, lstride), in sweep order
  const int* chains;     // (ndir, nslab, 2): chain2, chain3
  T* scratch;            // (gridDim.x, 3, ny*nz) when planes are global
  T uvb[3];
  T scale;               // angular weight 1/N
  T eps;                 // small-tau switch (in the tau_n domain)
  T a_eps;               // exp(-EPS_CL) of the clamped logmean
  T inv_eps_cl;          // 1/EPS_CL
  int lstride, nslab, ny, nz;
};

// What one CTA reads of the merged tables: its direction's permutation,
// slab order and flips, and its band's planes.
template <typename T>
struct Plane {
  const T* kap;
  const T* ikap;
  T* jout;
  bool reverse, flip_j, flip_k;
  T pad;
  __device__ Plane(const MergedParams<T>& p, int dir, int band) {
    const int* meta = p.dir_meta + 4 * dir;
    const size_t band_off =
        static_cast<size_t>(band) * p.nslab * p.ny * p.nz;
    kap = p.kappa[meta[0]] + band_off;
    ikap = p.inv_kappa[meta[0]] + band_off;
    jout = p.jout[meta[0]] + band_off;
    reverse = meta[1] != 0;
    flip_j = meta[2] != 0;
    flip_k = meta[3] != 0;
    pad = p.uvb[band];
  }
  // offset of sweep-order slab i in the band's (nslab, ny, nz) block
  __device__ size_t slab(const MergedParams<T>& p, int i) const {
    const int s = reverse ? p.nslab - 1 - i : i;
    return static_cast<size_t>(s) * p.ny * p.nz;
  }
};

// The exact logmean segment of sweep_merged.cu: len_n = -len*cell,
// inv_len_n = 1/len_n, ikap = 1/kappa.
template <typename T>
__device__ __forceinline__ void exact_segment(T eps, T i_in, T kap, T ikap,
                                              T len_n, T inv_len_n, T& i_out,
                                              T& lm) {
  const T tau_n = kap * len_n;
  const T a = dev_exp(tau_n);
  i_out = i_in * a;
  const T emi = (tau_n < -eps) ? (a - T(1)) * ikap * inv_len_n
                               : T(1) + T(0.5) * tau_n;
  lm = i_in * emi;
}

template <typename T>
__device__ __forceinline__ void exact_stage(const MergedParams<T>& p,
                                            const Plane<T>& pl, size_t off,
                                            const T* src, T* dst, T* jacc,
                                            int chain, T len_n, T inv_len_n) {
  const int plane = p.ny * p.nz;
  for (int c = threadIdx.x; c < plane; c += blockDim.x) {
    T i_out, lm;
    exact_segment(p.eps,
                  upwind(src, c, p.ny, p.nz, chain, pl.flip_j, pl.flip_k,
                         pl.pad),
                  pl.kap[off + c], pl.ikap[off + c], len_n, inv_len_n, i_out,
                  lm);
    dst[c] = i_out;
    jacc[c] += lm;
  }
}

// #6.  Tables: lens (ndir, nslab, 8) = -len*cell x3, inv_n, 1/len_n x3, pad.
template <typename T, bool SMEM>
__global__ void __launch_bounds__(1024)
sweep_pair_kernel(const MergedParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dir = blockIdx.x / 3;
  const int band = blockIdx.x - 3 * dir;
  const int plane = p.ny * p.nz;
  T* planes = cta_planes<T, SMEM>(smem_raw, p.scratch, plane);
  T* cur = planes;
  T* oth = planes + plane;
  T* jacc = planes + 2 * plane;
  const Plane<T> pl(p, dir, band);

  for (int c = threadIdx.x; c < plane; c += blockDim.x) cur[c] = pl.pad;

  for (int ia = 0; ia < p.nslab; ia += 2) {
    const int ib = ia + 1;
    const size_t ra = static_cast<size_t>(dir) * p.nslab + ia;
    const size_t rb = ra + 1;
    const T* la = p.lens + 8 * ra;
    const T* lb = p.lens + 8 * rb;
    const int ch2a = p.chains[2 * ra], ch3a = p.chains[2 * ra + 1];
    const int ch2b = p.chains[2 * rb], ch3b = p.chains[2 * rb + 1];
    const size_t oa = pl.slab(p, ia), ob = pl.slab(p, ib);

    // slab a's last segment, its deposit and slab b's segment 1, in one
    // pass over the thread's own cells
    if (ch2a == 0) {
      for (int c = threadIdx.x; c < plane; c += blockDim.x) {
        T i1, lm1, i1b, lm1b;
        exact_segment(p.eps, cur[c], pl.kap[oa + c], pl.ikap[oa + c], la[0],
                      la[4], i1, lm1);
        atomicAdd(pl.jout + oa + c, p.scale * (la[3] * lm1));
        exact_segment(p.eps, i1, pl.kap[ob + c], pl.ikap[ob + c], lb[0],
                      lb[4], i1b, lm1b);
        cur[c] = i1b;
        jacc[c] = lm1b;
      }
    } else {
      for (int c = threadIdx.x; c < plane; c += blockDim.x) {
        T i1, lm1;
        exact_segment(p.eps, cur[c], pl.kap[oa + c], pl.ikap[oa + c], la[0],
                      la[4], i1, lm1);
        cur[c] = i1;
        jacc[c] = lm1;
      }
      int last = ch2a;
      T len_n = la[1], inv_len_n = la[5];
      if (ch3a != 0) {
        __syncthreads();
        exact_stage(p, pl, oa, cur, oth, jacc, ch2a, la[1], la[5]);
        swap_planes(cur, oth);
        last = ch3a;
        len_n = la[2];
        inv_len_n = la[6];
      }
      __syncthreads();
      for (int c = threadIdx.x; c < plane; c += blockDim.x) {
        T io, lm, i1b, lm1b;
        exact_segment(p.eps,
                      upwind(cur, c, p.ny, p.nz, last, pl.flip_j, pl.flip_k,
                             pl.pad),
                      pl.kap[oa + c], pl.ikap[oa + c], len_n, inv_len_n, io,
                      lm);
        atomicAdd(pl.jout + oa + c, p.scale * (la[3] * (jacc[c] + lm)));
        exact_segment(p.eps, io, pl.kap[ob + c], pl.ikap[ob + c], lb[0],
                      lb[4], i1b, lm1b);
        oth[c] = i1b;
        jacc[c] = lm1b;
      }
      swap_planes(cur, oth);
    }
    // slab b's chained segments and deposit
    if (ch2b != 0) {
      __syncthreads();
      exact_stage(p, pl, ob, cur, oth, jacc, ch2b, lb[1], lb[5]);
      swap_planes(cur, oth);
      if (ch3b != 0) {
        __syncthreads();
        exact_stage(p, pl, ob, cur, oth, jacc, ch3b, lb[2], lb[6]);
        swap_planes(cur, oth);
      }
    }
    for (int c = threadIdx.x; c < plane; c += blockDim.x)
      atomicAdd(pl.jout + ob + c, p.scale * (lb[3] * jacc[c]));
  }
}

// #7.  Tables: lens (ndir, nslab, 16) = ln x3 (-len*cell, times log2(e)
// under exp2), C x3, h x3, s x3, pad x4, every slot act-folded
// (exp_sweep_variants.py::_lean_pack).
template <typename T, bool CLAMPED, bool EXP2, bool NOEMI>
__device__ __forceinline__ void lean_segment(const MergedParams<T>& p, T i_in,
                                             T kap, T ikap, T ln, T C, T h,
                                             T sp, T& i_out, T& lm) {
  const T tau_n = kap * ln;
  const T a = EXP2 ? dev_exp2(tau_n) : dev_exp(tau_n);
  i_out = i_in * a;
  if (NOEMI) {
    lm = i_out;
  } else if (CLAMPED) {
    const T d = i_in - i_in * dev_min(a, p.a_eps);
    lm = d * dev_min(ikap * C, sp * p.inv_eps_cl);
  } else {
    lm = (tau_n < -p.eps) ? (i_out - i_in) * (ikap * C) : i_in * (sp + h * kap);
  }
}

template <typename T, bool CLAMPED, bool EXP2, bool NOEMI, bool NOSHIFT>
__device__ __forceinline__ void lean_stage(const MergedParams<T>& p,
                                           const Plane<T>& pl, size_t off,
                                           const T* l, int k, const T* src,
                                           T* dst, T* jacc, int chain,
                                           bool store) {
  const int plane = p.ny * p.nz;
  if (!NOSHIFT) __syncthreads();
  for (int c = threadIdx.x; c < plane; c += blockDim.x) {
    const T i_in = NOSHIFT ? src[c]
                           : upwind(src, c, p.ny, p.nz, chain, pl.flip_j,
                                    pl.flip_k, pl.pad);
    T i_out, lm;
    lean_segment<T, CLAMPED, EXP2, NOEMI>(p, i_in, pl.kap[off + c],
                                          pl.ikap[off + c], l[k], l[3 + k],
                                          l[6 + k], l[9 + k], i_out, lm);
    if (store) dst[c] = i_out;
    jacc[c] += lm;
  }
}

template <typename T, bool CLAMPED, bool EXP2, bool SEG1, bool NOEMI,
          bool NOSHIFT, bool SMEM>
__global__ void __launch_bounds__(1024)
sweep_lean_kernel(const MergedParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dir = blockIdx.x / 3;
  const int band = blockIdx.x - 3 * dir;
  const int plane = p.ny * p.nz;
  T* planes = cta_planes<T, SMEM>(smem_raw, p.scratch, plane);
  T* cur = planes;
  T* oth = planes + plane;
  T* jacc = planes + 2 * plane;
  const Plane<T> pl(p, dir, band);

  for (int c = threadIdx.x; c < plane; c += blockDim.x) cur[c] = pl.pad;

  for (int i = 0; i < p.nslab; ++i) {
    const size_t row = static_cast<size_t>(dir) * p.nslab + i;
    const T* l = p.lens + static_cast<size_t>(p.lstride) * row;
    const int ch2 = p.chains[2 * row];
    const int ch3 = p.chains[2 * row + 1];
    const size_t off = pl.slab(p, i);

    for (int c = threadIdx.x; c < plane; c += blockDim.x) {
      T i_out, lm;
      lean_segment<T, CLAMPED, EXP2, NOEMI>(p, cur[c], pl.kap[off + c],
                                            pl.ikap[off + c], l[0], l[3],
                                            l[6], l[9], i_out, lm);
      cur[c] = i_out;
      jacc[c] = lm;
    }
    if (!SEG1) {
      if (NOEMI) {
        // inactive segments add their i_in: evaluate all three; the carry
        // is the last active segment's output
        lean_stage<T, CLAMPED, EXP2, NOEMI, NOSHIFT>(p, pl, off, l, 1, cur,
                                                     oth, jacc, ch2, true);
        if (ch2 != 0) swap_planes(cur, oth);
        lean_stage<T, CLAMPED, EXP2, NOEMI, NOSHIFT>(
            p, pl, off, l, 2, ch2 != 0 ? cur : oth, oth, jacc, ch3,
            ch3 != 0);
        if (ch3 != 0) swap_planes(cur, oth);
      } else if (ch2 != 0) {
        // inactive segments add exactly 0: skip them
        lean_stage<T, CLAMPED, EXP2, NOEMI, NOSHIFT>(p, pl, off, l, 1, cur,
                                                     oth, jacc, ch2, true);
        swap_planes(cur, oth);
        if (ch3 != 0) {
          lean_stage<T, CLAMPED, EXP2, NOEMI, NOSHIFT>(p, pl, off, l, 2, cur,
                                                       oth, jacc, ch3, true);
          swap_planes(cur, oth);
        }
      }
    }
    T* j_slab = pl.jout + off;
    for (int c = threadIdx.x; c < plane; c += blockDim.x)
      atomicAdd(j_slab + c, p.scale * jacc[c]);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename T, typename Kernel, typename Params>
cudaError_t launch(Kernel kernel, const Params& p, int ndir, int plane,
                   bool smem_planes, cudaStream_t stream) {
  int threads = ((plane + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = smem_planes ? 3 * static_cast<size_t>(plane) * sizeof(T)
                                  : 0;
  if (smem_planes) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<3 * ndir, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
MergedParams<T> merged_params(int nperm, const void* const* kappa,
                              const void* const* inv_kappa, void* const* jout,
                              const int* dir_meta, const void* lens,
                              int lstride, const int* chains, void* scratch,
                              const double uvb[3], double scale, double eps,
                              double a_eps, double inv_eps_cl, int nslab,
                              int ny, int nz) {
  MergedParams<T> p;
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
  p.lstride = lstride;
  p.nslab = nslab;
  p.ny = ny;
  p.nz = nz;
  return p;
}

template <bool CLAMPED, bool EXP2, bool SEG1, bool NOEMI, bool NOSHIFT>
cudaError_t launch_lean(const MergedParams<float>& p, int ndir, int use_smem,
                        cudaStream_t s) {
  const int plane = p.ny * p.nz;
  if (use_smem)
    return launch<float>(
        sweep_lean_kernel<float, CLAMPED, EXP2, SEG1, NOEMI, NOSHIFT, true>,
        p, ndir, plane, true, s);
  return launch<float>(
      sweep_lean_kernel<float, CLAMPED, EXP2, SEG1, NOEMI, NOSHIFT, false>, p,
      ndir, plane, false, s);
}

template <typename T>
cudaError_t zone_dispatch(const void* kappa, void* jout, const void* lens,
                          const int* chains, void* scratch, const double uvb[3],
                          double scale, double eps, int ndir, int nslab,
                          int ny, int nz, int use_smem, cudaStream_t s) {
  ZoneParams<T> p;
  p.kappa = static_cast<const T*>(kappa);
  p.jout = static_cast<T*>(jout);
  p.lens = static_cast<const T*>(lens);
  p.chains = chains;
  p.scratch = static_cast<T*>(scratch);
  for (int b = 0; b < 3; ++b) p.uvb[b] = static_cast<T>(uvb[b]);
  p.scale = static_cast<T>(scale);
  p.eps = static_cast<T>(eps);
  p.ndir = ndir;
  p.nslab = nslab;
  p.ny = ny;
  p.nz = nz;
  const int plane = ny * nz;
  if (use_smem)
    return launch<T>(sweep_zone_kernel<T, true>, p, ndir, plane, true, s);
  return launch<T>(sweep_zone_kernel<T, false>, p, ndir, plane, false, s);
}

}  // namespace

extern "C" {

// One zone's sweep over all its ndir directions x 3 bands on `stream`.
// dtype: 0 = float32, 1 = float64.  Returns the cudaError_t of the launch.
int rt_sweep_zone(int dtype, const void* kappa, void* jout, const void* lens,
                  const int* chains, void* scratch, double uvb0, double uvb1,
                  double uvb2, double scale, double eps, int ndir, int nslab,
                  int ny, int nz, int use_smem, void* stream) {
  const double uvb[3] = {uvb0, uvb1, uvb2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ndir < 1 || nslab < 1) return cudaErrorInvalidValue;
  if (dtype == 0)
    return zone_dispatch<float>(kappa, jout, lens, chains, scratch, uvb, scale,
                                eps, ndir, nslab, ny, nz, use_smem, s);
  if (dtype == 1)
    return zone_dispatch<double>(kappa, jout, lens, chains, scratch, uvb,
                                 scale, eps, ndir, nslab, ny, nz, use_smem, s);
  return cudaErrorInvalidValue;
}

// The two-slab merged sweep (exact logmean) over all ndir directions x 3
// bands; nslab must be even.  Arguments as rt_sweep_merged's.
int rt_sweep_pair(int dtype, int nperm, const void* const* kappa,
                  const void* const* inv_kappa, void* const* jout,
                  const int* dir_meta, const void* lens, const int* chains,
                  void* scratch, double uvb0, double uvb1, double uvb2,
                  double scale, double eps, int ndir, int nslab, int ny,
                  int nz, int use_smem, void* stream) {
  const double uvb[3] = {uvb0, uvb1, uvb2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nperm < 1 || nperm > kMaxPerms || ndir < 1 || nslab % 2 != 0)
    return cudaErrorInvalidValue;
  const int plane = ny * nz;
  if (dtype == 0) {
    const auto p = merged_params<float>(nperm, kappa, inv_kappa, jout,
                                        dir_meta, lens, 8, chains, scratch,
                                        uvb, scale, eps, 0.0, 0.0, nslab, ny,
                                        nz);
    return use_smem ? launch<float>(sweep_pair_kernel<float, true>, p, ndir,
                                    plane, true, s)
                    : launch<float>(sweep_pair_kernel<float, false>, p, ndir,
                                    plane, false, s);
  }
  if (dtype == 1) {
    const auto p = merged_params<double>(nperm, kappa, inv_kappa, jout,
                                         dir_meta, lens, 8, chains, scratch,
                                         uvb, scale, eps, 0.0, 0.0, nslab, ny,
                                         nz);
    return use_smem ? launch<double>(sweep_pair_kernel<double, true>, p, ndir,
                                     plane, true, s)
                    : launch<double>(sweep_pair_kernel<double, false>, p, ndir,
                                     plane, false, s);
  }
  return cudaErrorInvalidValue;
}

// One lean variant (float32) over all ndir directions x 3 bands.  variant:
// 0 lean, 1 clamp, 2 clamp2, 3 seg1, 4 noemi, 5 noshift
// (exp_sweep_variants.py:291-298).  eps is in the tau_n domain of the
// variant's exp.  Other arguments as rt_sweep_merged's.
int rt_sweep_lean(int variant, int nperm, const void* const* kappa,
                  const void* const* inv_kappa, void* const* jout,
                  const int* dir_meta, const void* lens, const int* chains,
                  void* scratch, double uvb0, double uvb1, double uvb2,
                  double scale, double eps, double a_eps, double inv_eps_cl,
                  int ndir, int nslab, int ny, int nz, int use_smem,
                  void* stream) {
  const double uvb[3] = {uvb0, uvb1, uvb2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nperm < 1 || nperm > kMaxPerms || ndir < 1) return cudaErrorInvalidValue;
  const auto p = merged_params<float>(nperm, kappa, inv_kappa, jout, dir_meta,
                                      lens, 16, chains, scratch, uvb, scale,
                                      eps, a_eps, inv_eps_cl, nslab, ny, nz);
  //                         CLAMPED EXP2   SEG1   NOEMI  NOSHIFT
  switch (variant) {
    case 0: return launch_lean<false, false, false, false, false>(p, ndir, use_smem, s);
    case 1: return launch_lean<true, false, false, false, false>(p, ndir, use_smem, s);
    case 2: return launch_lean<true, true, false, false, false>(p, ndir, use_smem, s);
    case 3: return launch_lean<false, false, true, false, false>(p, ndir, use_smem, s);
    case 4: return launch_lean<false, false, false, true, false>(p, ndir, use_smem, s);
    case 5: return launch_lean<false, false, false, false, true>(p, ndir, use_smem, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* rt_variants_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
