// The TPU's two sweep experiments on the cluster kernel's design, for
// Hopper (sm_90a): the body of csrc/sweep_cluster.cuh in the experiments'
// Modes, so that what they measure is the design the main path's sweep runs.
//
// Replaces two TPU kernels of the JAX package, as csrc/sweep_variants.cu's
// plane kernels (one CTA per direction and band) do:
// * scripts/exp_sweep_pair.py::_pair_kernel (#6): the merged sweep, exact
//   logmean, two slabs per grid step.  On this design the carry already
//   stays in registers across every slab, so pairing can only take the
//   loop's and the tables' overhead per slab, prefetch both slabs' kappa and
//   1/kappa two slabs ahead, and issue the first slab's deposit after the
//   second slab's segment 1 (kPair; f32 and f64, nslab even);
// * scripts/exp_sweep_variants.py::_lean_kernel (#7): the merged sweep on
//   act-folded 16-slot rows, in its variants lean, clamp, clamp2, seg1,
//   noemi and noshift (kLean .. kNoshift; f32, the experiment's type).
//   seg1, noemi and noshift compute other functions on purpose: each takes
//   a part of the sweep away (segments 2 and 3 with their barriers, the
//   emissivity, the shifts with their barriers and distributed shared
//   memory reads), so its time against lean's attributes that part.
//
// What bounds them on this card is what bounds the main path's sweep: FP32
// issue (PERF.md).  The design is csrc/sweep_cluster.cu's (C CTAs split a
// plane by rows, G directions a CTA share each kappa slab, carry and
// logmean in registers, the next slab's kappa prefetched, one atomicAdd per
// cell, band and slab); these instances also stage their G directions'
// rows of every slab in shared memory once per CTA, so no thread reads a
// row from global memory in its stages.  Built for G 1 and 2 and 2 or 4
// cells per thread; the size rule is core/variants_cuda.py::
// choose_variant_cluster's, measured on the H100 (PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// (never --use_fast_math: IEEE expf, exp2f and division, each op rounded as
// the plain PyTorch versions round it).  Plain C interface, loaded with
// ctypes.

#include "sweep_cluster.cuh"

namespace {

template <typename T, int M, int G, int CPT>
__global__ void __launch_bounds__(max_threads<T, M, G, CPT>())
sweep_variant_cluster_kernel(const ClusterParams<T> p) {
  cluster_body<T, M, G, CPT>(p);
}

template <typename T, int M, int G>
int by_cpt(const ClusterParams<T>& p, int cpt, const Launch& l) {
  switch (cpt) {
    case 2:
      return launch_shape<T, M, G, 2>(sweep_variant_cluster_kernel<T, M, G, 2>,
                                      p, l);
    case 4:
      return launch_shape<T, M, G, 4>(sweep_variant_cluster_kernel<T, M, G, 4>,
                                      p, l);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int M>
int by_g(const ClusterParams<T>& p, int g, int cpt, Launch l) {
  l.smem = smem_bytes<T, M>(g, p.rows_max, p.nz, p.nslab);
  switch (g) {
    case 1: return by_cpt<T, M, 1>(p, cpt, l);
    case 2: return by_cpt<T, M, 2>(p, cpt, l);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches one experiment sweep over every work item (n_items clusters of
// csize CTAs of `threads` threads, g directions and cpt cells per thread)
// on `stream`, or with query_only only asks the occupancy.  variant: 0
// lean, 1 clamp, 2 clamp2, 3 seg1, 4 noemi, 5 noshift (float32; rt_sweep_
// lean's codes, 16-slot rows, eps in the tau_n domain of the variant's
// exp) or 6 the pair (dtype 0 float32, 1 float64; nslab even; 8-slot
// rows).  The fields, tables and occupancy as rt_sweep_cluster's, on
// (3, nslab, ny, nz) fields.  Returns 0, a cudaError_t, or -1 when no
// cluster of this shape can be scheduled (nothing launched).
int rt_sweep_cluster_variant(int variant, int dtype, int nperm,
                             const void* const* kappa,
                             const void* const* inv_kappa, void* const* jout,
                             const int* dir_meta, const void* lens,
                             const int* chains, const int* items, double uvb0,
                             double uvb1, double uvb2, double scale,
                             double eps, double a_eps, double inv_eps_cl,
                             int n_items, int nslab, int ny, int nz,
                             int csize, int g, int cpt, int threads,
                             int query_only, int* occupancy, void* stream) {
  const double uvb[3] = {uvb0, uvb1, uvb2};
  if (nperm < 1 || nperm > kMaxPerms || n_items < 1 || csize < 1 ||
      csize > ny || nslab < 1)
    return cudaErrorInvalidValue;
  const bool pair = variant == 6;
  if ((pair && nslab % 2 != 0) || (!pair && dtype != 0) ||
      variant < 0 || variant > 6)
    return cudaErrorInvalidValue;
  const long long plane = static_cast<long long>(ny) * nz;
  const Launch l = {n_items, threads, 0, query_only, occupancy,
                    static_cast<cudaStream_t>(stream)};
  if (dtype == 1) {
    if (!pair) return cudaErrorInvalidValue;
    ClusterParams<double> p;
    merged_fields(p, nperm, kappa, inv_kappa, jout);
    common_params(p, dir_meta, lens, chains, items, uvb, scale, eps, a_eps,
                  inv_eps_cl, nslab, ny, nz, plane, nslab * plane, csize);
    return by_g<double, kPair>(p, g, cpt, l);
  }
  if (dtype != 0) return cudaErrorInvalidValue;
  ClusterParams<float> p;
  merged_fields(p, nperm, kappa, inv_kappa, jout);
  common_params(p, dir_meta, lens, chains, items, uvb, scale, eps, a_eps,
                inv_eps_cl, nslab, ny, nz, plane, nslab * plane, csize);
  switch (variant) {
    case 0: return by_g<float, kLean>(p, g, cpt, l);
    case 1: return by_g<float, kLeanClamp>(p, g, cpt, l);
    case 2: return by_g<float, kLeanClamp2>(p, g, cpt, l);
    case 3: return by_g<float, kSeg1>(p, g, cpt, l);
    case 4: return by_g<float, kNoemi>(p, g, cpt, l);
    case 5: return by_g<float, kNoshift>(p, g, cpt, l);
    default: return by_g<float, kPair>(p, g, cpt, l);
  }
}

const char* rt_cluster_variant_error_string(int err) {
  if (err == kNotSchedulable) return "no cluster of this shape fits the card";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
