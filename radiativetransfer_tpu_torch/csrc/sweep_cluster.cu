// Merged flip-folded diffuse sweep for Hopper (sm_90a), with each plane
// split across a thread-block cluster and each kappa slab shared by G
// directions; also one octant zone's sweep on a rotated field.
//
// Replaces two TPU kernels of the JAX package:
// * radiativetransfer_tpu/core/sweep_pallas.py::_merged_kernel (#1, the
//   TPU wavefront kernel), as csrc/sweep_merged.cu does, with the same
//   mathematics and the same host tables (core/sweep_cuda.py::
//   kernel_tables): fields (3, nslab, ny, nz) per axis permutation;
// * radiativetransfer_tpu/core/sweep_pallas.py::_sweep_zone_kernel (#2),
//   as csrc/sweep_variants.cu's zone kernel does: one zone on its
//   rotate_to_sweep-ed (nslab, 3, ny, nz) field is one merged launch with
//   the identity permutation, no flips and the zone's tables
//   (core/sweep_cluster.py::zone_tables); only the field's slab and band
//   strides differ, and the launch passes them;
// * radiativetransfer_tpu/parallel/sweep_rdma.py::_sweep_zone_rdma_kernel
//   (#3, the halo ring), as csrc/sweep_rdma.cu does: one zone on the P
//   k-blocks (P, nslab, 3, ny, nz/P) of its rotated field is one launch of
//   the RING instances, P clusters per work item (below).
//
// The kernel's body, its register model and its launch are in
// csrc/sweep_cluster.cuh, shared with csrc/sweep_cluster_exp.cu, whose
// instances of the same body run the TPU's two sweep experiments (#6, #7).
//
// Every direction walks its slabs in order; per slab each
// cell runs up to 3 chained ray segments (attenuate by exp(kappa*len_n),
// logmean emissivity in the exact two-branch or the clamped branch-free
// form, upwind shift along j or k between segments, reversed under a flip,
// the band's UVB as the boundary pad); the top-exit plane is carried to the
// next slab and weight * inv_n * sum(logmean) is added into Jmean.
//
// What bounds it on this card: FP32 issue (each IEEE expf is one MUFU.EX2
// and 6 FP32 instructions, ~8 more per segment), at ~1.07 ms for 128^3 x
// 192 directions.  What held csrc/sweep_merged.cu (one CTA per direction
// and band) at 12% of that bound at 128^3 and 3.7% at 256^3:
//
// * at 256^3 its 3 working planes (768 KiB) do not fit one SM, so they
//   live in global scratch (99 MiB for 132 resident CTAs, twice the L2);
// * every CTA reads its kappa and 1/kappa slab once per direction: 9.66 GB
//   per sweep at 128^3, 77.3 GB at 256^3, from L2 at best, loaded inside
//   the cell loop with nothing in flight ahead of it;
// * one atomicAdd per cell, direction and band (1.21e9 at 128^3);
// * its logmean accumulator is a shared plane that only its owner touches.
//
// This kernel:
//
// * a cluster of C CTAs owns one work item (a band and G directions of
//   one merged launch, so one axis permutation and one slab order); CTA r
//   holds the rows [r*ny/C, (r+1)*ny/C) of the plane and a fixed set of
//   cells per thread (cell t + m*blockDim.x of its rows, m < CPT).  The
//   in-slab k-shift (chain code 2) stays inside the CTA; the j-shift
//   (chain code 1) reads the neighbour CTA's edge row through distributed
//   shared memory (rank - 1, or rank + 1 under flip_j; the UVB pad at the
//   plane's edge).  Each chained stage writes the stage's input plane into
//   shared memory, passes a cluster barrier (release/acquire; a CTA
//   barrier when C = 1), and reads its upwind neighbours; two planes per
//   direction alternate, so a plane is rewritten only after the barrier
//   that follows every read of it.  At 256^3 in f32 the size rule's
//   C = 16, G = 2 planes are 64 KiB per CTA: nothing goes to global
//   scratch;
// * the G directions of a CTA read each kappa and 1/kappa slab once; the
//   CTA runs the union of their active chained stages (the same tables on
//   every CTA of the cluster, so all pass the same barriers) and each
//   direction skips its own inactive ones; the G logmeans of a cell are
//   summed in registers before ONE atomicAdd per cell, band and slab;
// * the carry (top-exit intensity of the thread's own cells) and the
//   logmean accumulator live in registers;
// * the next slab's kappa and 1/kappa are loaded into registers while the
//   current slab is computed (a one-slab-ahead register prefetch).
//
// Ragged groups (launches of 15 and 17 directions) run their G slots with
// the missing directions predicated off.  The cluster launch asks
// cudaOccupancyMaxActiveClusters first and refuses a cluster that cannot
// be scheduled (0 resident clusters) before it runs.  C, G and the cells
// per thread come from core/sweep_cluster.py's size rules, measured on the
// H100: in f32 C 8, G 2, 512 threads x 4 cells at 128^3 (1.38x csrc/
// sweep_merged.cu) and C 16, G 2, 1024 x 4 at 256^3 (3.9x); in f64 C 16,
// G 1, 512 x 2 at 128^3 (2.3x); one zone's launch takes the same rule,
// which ran the 24 zone launches at 128^3 fastest with 4 zones in flight
// (core/sweep_cuda.py::ZONE_STREAMS); PERF.md.
//
// The halo ring (RING instances, the exact logmean, G 1 and 2): a cluster
// per (rank, work item) on rank r's k-block, with the rank's block stride
// added to the field's.  Only the in-slab yz segments (chain code 2, the
// k-shift) cross a block edge: rank r's first k-column is rank r-1's exit
// column of the same slab and stage, rank 0 takes the band's UVB.  CTA c of
// a cluster owns rows [c*ny/C, (c+1)*ny/C), so it sends only those rows of
// its k = nz-1 column, to CTA c of the same work item on rank r+1, and
// receives its rows of rank r-1's.  Each (rank, item, CTA, direction, stage)
// has its own line buffer of `nlines` lines (the most yz segments a
// direction of the zone has at one stage; zeroed before each launch); line n
// of a direction and stage (its n-th yz segment there,
// core/sweep_cluster.py::ring_lines) goes to slot n, so no slot is reused
// and no ACK is waited for: a rank waits only on its left neighbour.  A
// line's every value travels with its sequence number n + 1: each 32-bit
// half of the value and the number in one 64-bit word, stored and loaded
// relaxed at device scope (single-copy atomic, past L1, which is not
// coherent across SMs), so no fence and no flag stands between a sender's
// cells and its receiver: a sender's cells at k = nz-1 store their words as
// the stage begins; the receiver's row threads load theirs as the stage
// begins too, check the numbers after the stage's plane barrier (reloading
// until they match), and put the values in shared memory for its cells at k
// = 0.  (A first design published one flag a line after a CTA barrier and a
// GPU-scope fence, waited for by thread 0 before the plane barrier: the
// fences on every stage's critical path took the 24 launches at 128^3 on 4
// ranks from 16 to 25 ms on the H100; two slots a direction behind the
// receiver's ACKs ran ~6% slower than a slot a line, PERF.md.)  Every wait
// is bounded by spin_budget clock64 cycles: one that runs out marks *status,
// and every later wait of the launch returns at once, so every CTA still
// passes the same barriers to the end (garbage, which the caller turns into
// an error).  A spin on a CTA that never runs would hang, so the ring is
// launched cooperatively and a grid of more clusters than the card holds at
// once (cudaOccupancyMaxActiveClusters) is refused before it runs.  The size
// rule is core/sweep_cluster.py::choose_ring's, measured on the H100
// (PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// (never --use_fast_math: IEEE expf and division, each op rounded as the
// plain PyTorch version rounds it).  Plain C interface, loaded with ctypes.

#include "sweep_cluster.cuh"

namespace {

// The main path's instances: the merged sweep and one zone's (kExact,
// kClamped) and the halo ring (kRing).
__host__ __device__ constexpr int main_mode(bool clamped, bool ring) {
  return ring ? kRing : clamped ? kClamped : kExact;
}

template <typename T, bool CLAMPED, int G, int CPT, bool RING>
__global__ void __launch_bounds__(
    max_threads<T, main_mode(CLAMPED, RING), G, CPT>())
sweep_cluster_kernel(const ClusterParams<T> p) {
  cluster_body<T, main_mode(CLAMPED, RING), G, CPT>(p);
}

template <typename T, bool CLAMPED, int G, int CPT, bool RING>
int launch_main(const ClusterParams<T>& p, const Launch& l) {
  return launch_shape<T, main_mode(CLAMPED, RING), G, CPT>(
      sweep_cluster_kernel<T, CLAMPED, G, CPT, RING>, p, l);
}

// 1, 2 or 4 cells per thread (core/sweep_cluster.py::CELLS_PER_THREAD):
// 8 and 16 ran slower at every (C, G) on the H100 (PERF.md)
// (the ring: 2 and 4 only, core/sweep_cluster.py::RING_CELLS_PER_THREAD;
// a ring of 1 cell a thread was never co-resident at 128^3)
template <typename T, bool CLAMPED, int G, bool RING>
int by_cpt(const ClusterParams<T>& p, int cpt, const Launch& l) {
  switch (cpt) {
    case 1:
      if constexpr (!RING) return launch_main<T, CLAMPED, G, 1, RING>(p, l);
      return cudaErrorInvalidValue;
    case 2: return launch_main<T, CLAMPED, G, 2, RING>(p, l);
    case 4: return launch_main<T, CLAMPED, G, 4, RING>(p, l);
    default: return cudaErrorInvalidValue;
  }
}

// the ring is built for G 1 and 2 only (core/sweep_cluster.py::
// RING_GROUP_SIZES)
template <typename T, bool CLAMPED, bool RING>
int by_g(const ClusterParams<T>& p, int g, int cpt, const Launch& l) {
  switch (g) {
    case 1: return by_cpt<T, CLAMPED, 1, RING>(p, cpt, l);
    case 2: return by_cpt<T, CLAMPED, 2, RING>(p, cpt, l);
    case 4:
      if constexpr (!RING) return by_cpt<T, CLAMPED, 4, RING>(p, cpt, l);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(int nperm, const void* const* kappa, const void* const* inv_kappa,
             void* const* jout, const int* dir_meta, const void* lens,
             const int* chains, const int* items, const double uvb[3],
             double scale, double eps, double a_eps, double inv_eps_cl,
             int n_items, int nslab, int ny, int nz, long long slab_stride,
             long long band_stride, int clamped, int csize, int g, int cpt,
             int threads, int query_only, int* occupancy,
             cudaStream_t stream) {
  ClusterParams<T> p;
  merged_fields(p, nperm, kappa, inv_kappa, jout);
  common_params(p, dir_meta, lens, chains, items, uvb, scale, eps, a_eps,
                inv_eps_cl, nslab, ny, nz, slab_stride, band_stride, csize);
  const Launch l = {n_items, threads,
                    smem_bytes<T, kExact>(g, p.rows_max, nz, nslab),
                    query_only, occupancy, stream};
  return clamped ? by_g<T, true, false>(p, g, cpt, l)
                 : by_g<T, false, false>(p, g, cpt, l);
}

template <typename T>
int ring_dispatch(const void* kappa, const void* inv_kappa, void* jout,
                  const int* dir_meta, const void* lens, const int* chains,
                  const int* items, const int* lines, void* halo, int* status,
                  const double uvb[3], double scale, double eps,
                  int n_items, int ranks, int nslab, int ny, int nz,
                  long long rank_stride, long long slab_stride,
                  long long band_stride, int nlines, long long spin_budget,
                  int hold_rank, long long hold_cycles, int csize, int g,
                  int cpt,
                  int threads, int query_only, int* occupancy,
                  cudaStream_t stream) {
  ClusterParams<T> p;
  for (int q = 0; q < kMaxPerms; ++q) {
    p.kappa[q] = q == 0 ? static_cast<const T*>(kappa) : nullptr;
    p.inv_kappa[q] = q == 0 ? static_cast<const T*>(inv_kappa) : nullptr;
    p.jout[q] = q == 0 ? static_cast<T*>(jout) : nullptr;
  }
  common_params(p, dir_meta, lens, chains, items, uvb, scale, eps, 0.0, 0.0,
                nslab, ny, nz, slab_stride, band_stride, csize);
  p.rank_stride = rank_stride;
  p.halo = static_cast<HaloWord*>(halo);
  p.status = status;
  p.lines = lines;
  p.spin_budget = spin_budget;
  p.hold_cycles = hold_cycles;
  p.n_items = n_items;
  p.ranks = ranks;
  p.nlines = nlines;
  p.hold_rank = hold_rank;
  const Launch l = {ranks * n_items, threads,
                    smem_bytes<T, kRing>(g, p.rows_max, nz, nslab),
                    query_only, occupancy, stream};
  return by_g<T, false, true>(p, g, cpt, l);
}

}  // namespace

extern "C" {

// Launches one sweep over every work item (n_items clusters of csize CTAs
// of `threads` threads, g directions and cpt cells per thread) on
// `stream`, or with query_only only asks the occupancy.  dtype: 0 =
// float32, 1 = float64.  kappa/inv_kappa/jout: host arrays of nperm (<= 6)
// device pointers, one per axis permutation, each field with the given
// slab and band strides (in elements; a row is nz contiguous elements,
// rows ny apart by nz).  occupancy (2 ints): the
// clusters of this shape the card holds at once, and the occupancy query's
// cudaError_t.  Returns 0, a cudaError_t, or -1 when no cluster of this
// shape can be scheduled (nothing launched).
int rt_sweep_cluster(int dtype, int nperm, const void* const* kappa,
                     const void* const* inv_kappa, void* const* jout,
                     const int* dir_meta, const void* lens, const int* chains,
                     const int* items, double uvb0, double uvb1, double uvb2,
                     double scale, double eps, double a_eps,
                     double inv_eps_cl, int n_items, int nslab, int ny, int nz,
                     long long slab_stride, long long band_stride,
                     int clamped, int csize, int g, int cpt, int threads,
                     int query_only, int* occupancy, void* stream) {
  const double uvb[3] = {uvb0, uvb1, uvb2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long plane = static_cast<long long>(ny) * nz;
  if (nperm < 1 || nperm > kMaxPerms || n_items < 1 || csize < 1 ||
      csize > ny || slab_stride < plane || band_stride < plane)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(nperm, kappa, inv_kappa, jout, dir_meta, lens,
                           chains, items, uvb, scale, eps, a_eps, inv_eps_cl,
                           n_items, nslab, ny, nz, slab_stride, band_stride,
                           clamped, csize, g, cpt, threads, query_only,
                           occupancy, s);
  if (dtype == 1)
    return dispatch<double>(nperm, kappa, inv_kappa, jout, dir_meta, lens,
                            chains, items, uvb, scale, eps, a_eps, inv_eps_cl,
                            n_items, nslab, ny, nz, slab_stride, band_stride,
                            clamped, csize, g, cpt, threads, query_only,
                            occupancy, s);
  return cudaErrorInvalidValue;
}

// Launches one zone's halo-ring sweep on `ranks` k-blocks of a rotated
// field (the exact logmean): ranks x n_items clusters of csize CTAs, rank
// major, or with query_only only asks the occupancy.  kappa, inv_kappa and
// jout: (ranks, nslab, 3, ny, nz) fields with the given rank, slab and
// band strides; dir_meta, lens, chains, items: one zone's tables as
// rt_sweep_cluster takes them; lines (ndir, nslab, 2): a yz stage's line
// number, -1 elsewhere; nlines: the most lines one direction sends at one
// stage; halo: ranks * n_items * csize * g * 2 * nlines * ceil(ny / csize)
// * (sizeof(value) / 4) 64-bit words, zeroed; status: one int, zeroed, 1
// after a wait ran out of spin_budget cycles.  hold_rank's CTAs start
// hold_cycles late (-1: none).  The launch is cooperative
// (cudaLaunchAttributeCooperative).  Returns as rt_sweep_cluster, and
// cudaErrorCooperativeLaunchTooLarge (nothing launched) when the card
// cannot hold every cluster at once.
int rt_sweep_cluster_ring(int dtype, const void* kappa, const void* inv_kappa,
                          void* jout, const int* dir_meta, const void* lens,
                          const int* chains, const int* items,
                          const int* lines, void* halo, int* status,
                          double uvb0, double uvb1, double uvb2,
                          double scale, double eps, int n_items, int ranks,
                          int nslab, int ny, int nz, long long rank_stride,
                          long long slab_stride, long long band_stride,
                          int nlines, long long spin_budget,
                          int hold_rank, long long hold_cycles, int csize,
                          int g, int cpt, int threads, int query_only,
                          int* occupancy, void* stream) {
  const double uvb[3] = {uvb0, uvb1, uvb2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long plane = static_cast<long long>(ny) * nz;
  if (n_items < 1 || ranks < 1 || csize < 1 || csize > ny || nlines < 1 ||
      slab_stride < plane || band_stride < plane ||
      (ranks > 1 && rank_stride < nslab * slab_stride))
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return ring_dispatch<float>(
        kappa, inv_kappa, jout, dir_meta, lens, chains, items, lines, halo,
        status, uvb, scale, eps, n_items, ranks, nslab, ny, nz,
        rank_stride, slab_stride, band_stride, nlines, spin_budget,
        hold_rank, hold_cycles, csize, g, cpt, threads, query_only,
        occupancy, s);
  if (dtype == 1)
    return ring_dispatch<double>(
        kappa, inv_kappa, jout, dir_meta, lens, chains, items, lines, halo,
        status, uvb, scale, eps, n_items, ranks, nslab, ny, nz,
        rank_stride, slab_stride, band_stride, nlines, spin_budget,
        hold_rank, hold_cycles, csize, g, cpt, threads, query_only,
        occupancy, s);
  return cudaErrorInvalidValue;
}

const char* rt_cluster_error_string(int err) {
  if (err == kNotSchedulable) return "no cluster of this shape fits the card";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
