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

#include <cooperative_groups.h>
#include <cstring>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxPerms = 6;  // axis permutations of the 24 octant zones
// returned when the occupancy query finds no cluster of the shape fits the
// card, or refuses the shape itself
constexpr int kNotSchedulable = -1;
constexpr int kSegYZ = 2;  // chain code of a yz segment (the k-shift)
// *status after a ring launch: 0, or a wait that ran out of time
constexpr int kStatusTimeout = 1;
// The memory scope of the ring's flags: every rank on one device.
constexpr cuda::thread_scope kRingScope = cuda::thread_scope_device;
using FlagRef = cuda::atomic_ref<int, kRingScope>;
// a halo word: 32 bits of a value (low) and its line's sequence number
using HaloWord = unsigned long long;
using WordRef = cuda::atomic_ref<HaloWord, kRingScope>;

template <typename T>
struct ClusterParams {
  // per axis permutation, each (3, nslab, ny, nz) in that permutation's
  // order: kappa, its hoisted reciprocal, and the zeroed Jmean output
  const T* kappa[kMaxPerms];
  const T* inv_kappa[kMaxPerms];
  T* jout[kMaxPerms];
  const int* dir_meta;   // (ndir, 4): perm index, reverse, flip_j, flip_k
  const T* lens;         // (ndir, nslab, 8): -len*cell x3, inv_n,
                         //                   -1/(len*cell) x3, pad
  const int* chains;     // (ndir, nslab, 2): chain2, chain3 (0/1=XZ/2=YZ)
  const int* items;      // (n_items, 4): first direction, directions
                         //   (<= G), band, 0; one item per cluster
  T uvb[3];
  T scale;               // angular weight 1/N
  T eps;                 // small-tau switch of the exact logmean
  T a_eps;               // exp(-EPS_CL) of the clamped logmean
  T inv_eps_cl;          // 1/EPS_CL
  long long slab_stride;  // elements between slabs of a field: ny*nz in
  long long band_stride;  // (3, nslab, ny, nz), 3*ny*nz in (nslab, 3, ny,
                          // nz); between bands nslab*ny*nz or ny*nz
  int nslab, ny, nz;
  int csize;             // C, CTAs per cluster
  int rows_max;          // ceil(ny / C): the row stride of a staging plane
  // the halo ring (RING instances only): clusters are (rank, item), rank
  // major; line buffers by (rank, item, CTA, direction slot, stage)
  long long rank_stride;  // elements between ranks' k-blocks
  HaloWord* halo;        // (..., nlines, rows_max, words of T): lines into
                         // each rank, zeroed
  int* status;           // one int, zeroed: kStatusTimeout after a timeout
  const int* lines;      // (ndir, nslab, 2): a yz stage's line number, -1
  long long spin_budget;  // clock64 cycles one wait may take
  long long hold_cycles;  // the CTAs of rank hold_rank start this late
  int n_items, ranks, nlines, hold_rank;
};

// The most threads a CTA of <T, G, CPT> may have: the registers one thread
// needs without spilling (carry and logmean per direction and cell, kappa
// and 1/kappa of this slab and the next: ~2.5 G + 4.5 per f32 cell, twice
// that in f64, and ~26 of addresses, lengths and loop state, ~58 in f64;
// fitted to ptxas -v's counts and spills; the ring's line numbers,
// pointers and flags ~RING_REGS more) under the per-thread cap that this
// block size leaves (65,536 per SM).
// core/sweep_cluster.py::max_threads computes the same, and
// tests/test_torch_sweep_cluster.py reads both formulas here and holds the
// two to each other.
template <typename T>
constexpr int kWords = static_cast<int>(sizeof(T) / 4);  // 32-bit registers
constexpr int RING_REGS = 16;
template <typename T, int G, int CPT, bool RING>
constexpr int kRegs = ((5 * G + 9) * CPT * kWords<T> + 1) / 2 + 26 +
                      32 * (kWords<T> - 1) + RING_REGS * RING;

// 0 where no block size leaves enough
template <typename T, int G, int CPT, bool RING>
constexpr int max_threads() {
  constexpr int regs = kRegs<T, G, CPT, RING>;
  return regs <= 64 ? 1024 : regs <= 80 ? 768 : regs <= 128 ? 512
       : regs <= 168 ? 384 : regs <= 255 ? 256 : 0;
}

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
__device__ __forceinline__ float dev_min(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ double dev_min(double a, double b) {
  return fmin(a, b);
}

// One segment: len_n = -length*cell, inv_len_n = 1/len_n.  The same
// operations, in the same order, as csrc/sweep_merged.cu's.
template <typename T, bool CLAMPED>
__device__ __forceinline__ void segment(const ClusterParams<T>& p, T i_in,
                                        T kap, T inv_kap, T len_n,
                                        T inv_len_n, T& i_out, T& lm) {
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

// The barrier before a chained stage's reads: the whole cluster when the
// plane is split (a neighbour's edge row is read), else the CTA.
__device__ __forceinline__ void plane_barrier(int csize) {
  if (csize > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// One halo value as kWords<T> words, each 32 bits of it and the line's
// sequence number seq, stored relaxed.
template <typename T>
__device__ __forceinline__ void put_words(HaloWord* dst, T v, unsigned seq) {
  unsigned bits[kWords<T>];
  memcpy(bits, &v, sizeof(T));
#pragma unroll
  for (int w = 0; w < kWords<T>; ++w)
    WordRef(dst[w]).store((static_cast<HaloWord>(seq) << 32) | bits[w],
                          cuda::std::memory_order_relaxed);
}

// A halo word loaded earlier (`word`), or reloaded until it carries seq,
// within the spin budget.  An expired wait marks *status; once it is
// marked (by this CTA or any other of the launch) every wait returns at
// once, so the launch runs to its end through the same barriers.
template <typename T>
__device__ HaloWord word_of(const ClusterParams<T>& p, HaloWord* src,
                            HaloWord word, unsigned seq) {
  if ((word >> 32) == seq) return word;
  WordRef ref(*src);
  FlagRef failed(*p.status);
  const long long t0 = clock64();
  for (;;) {
    word = ref.load(cuda::std::memory_order_relaxed);
    if ((word >> 32) == seq) return word;
    if (failed.load(cuda::std::memory_order_relaxed) != 0) return word;
    if (clock64() - t0 > p.spin_budget) {
      failed.store(kStatusTimeout, cuda::std::memory_order_relaxed);
      return word;
    }
  }
}

// The row of the CTA's cell c = row * nz + k without an integer division:
// (c + 1/2) / nz in float32 is row + (k + 1/2)/nz with an error below
// (row + 1) * 2^-23, far inside the 1/(2 nz) margin for planes of up to
// thousands of rows.
__device__ __forceinline__ int cell_row(int c, float inv_nz) {
  return __float2int_rz((static_cast<float>(c) + 0.5f) * inv_nz);
}

template <typename T, bool CLAMPED, int G, int CPT, bool RING>
__global__ void __launch_bounds__(max_threads<T, G, CPT, RING>())
sweep_cluster_kernel(const ClusterParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // staging planes [parity][direction][rows_max * nz]; in the ring then
  // the incoming lines [direction][rows_max]
  T* planes = reinterpret_cast<T*>(smem_raw);
  T* lines_in = planes + 2 * G * p.rows_max * p.nz;
  const int csize = p.csize;
  const int rank =
      csize > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  // the cluster's work item and, in the ring, its rank (clusters rank
  // major)
  const int cid = blockIdx.x / csize;
  const int ring_rank = RING ? cid / p.n_items : 0;
  const int* item = p.items + 4 * (RING ? cid - ring_rank * p.n_items : cid);
  const int d0 = item[0], gcount = item[1], band = item[2];
  const int ny = p.ny, nz = p.nz, nslab = p.nslab;
  const int r0 = (rank * ny) / csize;
  const int rows = ((rank + 1) * ny) / csize - r0;
  const int cells = rows * nz;
  const int pstride = p.rows_max * nz;
  const int lo_rows = rank > 0 ? r0 - ((rank - 1) * ny) / csize : 0;
  // the neighbours' staging planes, in distributed shared memory
  const T* lo_planes = nullptr;
  const T* hi_planes = nullptr;
  if (csize > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (rank > 0) lo_planes = cluster.map_shared_rank(planes, rank - 1);
    if (rank + 1 < csize)
      hi_planes = cluster.map_shared_rank(planes, rank + 1);
  }

  const int* meta0 = p.dir_meta + 4 * d0;
  const int perm = meta0[0];
  const bool reverse = meta0[1] != 0;
  bool flip_j[G], flip_k[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int* meta = p.dir_meta + 4 * (d0 + (g < gcount ? g : 0));
    flip_j[g] = meta[2] != 0;
    flip_k[g] = meta[3] != 0;
  }
  const long long slab_stride = p.slab_stride;
  const size_t band_off =
      static_cast<size_t>(band) * p.band_stride +
      static_cast<size_t>(r0) * nz +
      (RING ? static_cast<size_t>(ring_rank) * p.rank_stride : 0);
  const T* kap_band = p.kappa[perm] + band_off;
  const T* ikap_band = p.inv_kappa[perm] + band_off;
  T* j_band = p.jout[perm] + band_off;
  const T pad = p.uvb[band];
  const int t = threadIdx.x, nt = blockDim.x;

  // the ring: this CTA's line buffers (lines into its rank) and the same
  // CTA's of the right rank, each direction slot g and stage st at 2 g + st
  const size_t buf_in =
      RING ? (static_cast<size_t>(cid) * csize + rank) * G * 2 : 0;
  const size_t buf_out =
      buf_in + static_cast<size_t>(p.n_items) * csize * G * 2;
  const bool has_left = RING && ring_rank > 0;
  const bool has_right = RING && ring_rank + 1 < p.ranks;
  const float inv_nz = 1.0f / static_cast<float>(nz);
  if (RING && ring_rank == p.hold_rank) {  // a test's late rank
    const long long t0 = clock64();
    while (clock64() - t0 < p.hold_cycles) {
    }
  }

  T carry[G][CPT], acc[G][CPT], kap[CPT], ikap[CPT];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int m = 0; m < CPT; ++m) carry[g][m] = pad;
  {
    const size_t off =
        static_cast<size_t>(reverse ? nslab - 1 : 0) * slab_stride;
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      const int c = t + m * nt;
      kap[m] = c < cells ? __ldg(kap_band + off + c) : T(0);
      ikap[m] = c < cells ? __ldg(ikap_band + off + c) : T(0);
    }
  }

  // the thread's cells at the plane's k edges (bit 2m: k = 0, bit 2m + 1:
  // k = nz - 1), so the stages divide by nz nowhere
  static_assert(CPT <= 16, "two edge bits per cell in 32 bits");
  unsigned kedge = 0;
#pragma unroll
  for (int m = 0; m < CPT; ++m) {
    const int k = (t + m * nt) % nz;
    kedge |= (k == 0 ? 1u : 0u) << (2 * m);
    kedge |= (k == nz - 1 ? 1u : 0u) << (2 * m + 1);
  }

  int parity = 0;
  for (int i = 0; i < nslab; ++i) {
    const int s = reverse ? nslab - 1 - i : i;
    T kc[CPT], ikc[CPT];
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      kc[m] = kap[m];
      ikc[m] = ikap[m];
    }
    if (i + 1 < nslab) {  // the next slab's loads, in flight over this one
      const size_t off =
          static_cast<size_t>(reverse ? s - 1 : s + 1) * slab_stride;
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int c = t + m * nt;
        if (c < cells) {
          kap[m] = __ldg(kap_band + off + c);
          ikap[m] = __ldg(ikap_band + off + c);
        }
      }
    }

    // segment 1 (xy) of every direction: the thread's own cells only
    int ch2[G], ch3[G];
    int any2 = 0, any3 = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      ch2[g] = 0;
      ch3[g] = 0;
      if (g < gcount) {
        const size_t row = static_cast<size_t>(d0 + g) * nslab + i;
        const T* l = p.lens + 8 * row;
        ch2[g] = p.chains[2 * row];
        ch3[g] = p.chains[2 * row + 1];
        any2 |= ch2[g];
        any3 |= ch3[g];
        const T len_n = l[0], inv_len_n = l[4];
#pragma unroll
        for (int m = 0; m < CPT; ++m) {
          T i_out, lm;
          segment<T, CLAMPED>(p, carry[g][m], kc[m], ikc[m], len_n, inv_len_n,
                              i_out, lm);
          carry[g][m] = i_out;
          acc[g][m] = lm;
        }
      }
    }

    // chained segments 2 and 3: the union of the directions' active ones
#pragma unroll
    for (int stage = 1; stage <= 2; ++stage) {
      if ((stage == 1 ? any2 : any3) == 0) break;
      // the ring: each direction's line number at this stage (-1: no yz
      // segment); the same tables on every rank, so sender and receiver
      // agree on which stages carry a line.  A receiver's row threads load
      // their words of the incoming lines now, checked after the barrier
      int line[G];
      bool any_line = false;
      HaloWord got[G][kWords<T>];
#pragma unroll
      for (int g = 0; g < G; ++g) line[g] = -1;
      if (RING) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int chain = stage == 1 ? ch2[g] : ch3[g];
          line[g] = chain == kSegYZ
              ? p.lines[2 * (static_cast<size_t>(d0 + g) * nslab + i) +
                        stage - 1]
              : -1;
          any_line |= line[g] >= 0;
        }
        if (any_line && has_left && t < rows) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (line[g] < 0) continue;
            const HaloWord* src =
                p.halo + (((buf_in + 2 * g + stage - 1) * p.nlines +
                           line[g]) * p.rows_max + t) * kWords<T>;
#pragma unroll
            for (int w = 0; w < kWords<T>; ++w)
              got[g][w] = WordRef(const_cast<HaloWord&>(src[w]))
                              .load(cuda::std::memory_order_relaxed);
          }
        }
      }
      T* own = planes + parity * G * pstride;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if ((stage == 1 ? ch2[g] : ch3[g]) == 0) continue;
#pragma unroll
        for (int m = 0; m < CPT; ++m) {
          const int c = t + m * nt;
          if (c < cells) own[g * pstride + c] = carry[g][m];
        }
      }
      if (RING && any_line && has_right) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (line[g] < 0) continue;
          HaloWord* dst = p.halo + ((buf_out + 2 * g + stage - 1) *
                                    p.nlines + line[g]) *
                                       p.rows_max * kWords<T>;
#pragma unroll
          for (int m = 0; m < CPT; ++m) {
            const int c = t + m * nt;
            if (c < cells && ((kedge >> (2 * m + 1)) & 1u))
              put_words(dst + cell_row(c, inv_nz) * kWords<T>, carry[g][m],
                        line[g] + 1);
          }
        }
      }
      plane_barrier(csize);
      if (RING && any_line && has_left) {
        if (t < rows) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (line[g] < 0) continue;
            HaloWord* src =
                p.halo + (((buf_in + 2 * g + stage - 1) * p.nlines +
                           line[g]) * p.rows_max + t) * kWords<T>;
            unsigned bits[kWords<T>];
#pragma unroll
            for (int w = 0; w < kWords<T>; ++w)
              bits[w] = static_cast<unsigned>(
                  word_of(p, src + w, got[g][w], line[g] + 1));
            T v;
            memcpy(&v, bits, sizeof(T));
            lines_in[g * p.rows_max + t] = v;
          }
        }
        __syncthreads();
      }
      T len_n[G], inv_len_n[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const T* l = p.lens + 8 * (static_cast<size_t>(d0 + g) * nslab + i);
        len_n[g] = g < gcount ? l[stage] : T(0);
        inv_len_n[g] = g < gcount ? l[4 + stage] : T(0);
      }
      const T* lo = lo_planes == nullptr ? nullptr
          : lo_planes + parity * G * pstride + (lo_rows - 1) * nz;
      const T* hi = hi_planes == nullptr ? nullptr
          : hi_planes + parity * G * pstride;
      const int last_row = cells - nz;  // the last row's first cell
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int c = t + m * nt;
        if (c >= cells) continue;
        const bool k_first = (kedge >> (2 * m)) & 1u;
        const bool k_last = (kedge >> (2 * m + 1)) & 1u;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int chain = stage == 1 ? ch2[g] : ch3[g];
          if (chain == 0) continue;
          const T* src = own + g * pstride;
          T i_in;
          if (chain == 1) {
            if (flip_j[g]) {
              if (c + nz < cells) i_in = src[c + nz];
              else if (hi != nullptr) i_in = hi[g * pstride + c - last_row];
              else i_in = pad;
            } else {
              if (c >= nz) i_in = src[c - nz];
              else if (lo != nullptr) i_in = lo[g * pstride + c];
              else i_in = pad;
            }
          } else if (flip_k[g]) {
            i_in = k_last ? pad : src[c + 1];
          } else if (!k_first) {
            i_in = src[c - 1];
          } else if (has_left) {  // the left rank's exit column
            i_in = lines_in[g * p.rows_max + cell_row(c, inv_nz)];
          } else {
            i_in = pad;
          }
          T i_out, lm;
          segment<T, CLAMPED>(p, i_in, kc[m], ikc[m], len_n[g], inv_len_n[g],
                              i_out, lm);
          carry[g][m] = i_out;
          acc[g][m] += lm;
        }
      }
      parity ^= 1;
    }

    // one deposit per cell for the G directions: their weighted logmeans
    // summed in registers (only the order of Jmean's adds changes), each
    // direction's weight 1/N * 1/n_active taken once per slab
    T w[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      w[g] = g < gcount
          ? p.scale *
                p.lens[8 * (static_cast<size_t>(d0 + g) * nslab + i) + 3]
          : T(0);
    T* j_slab = j_band + static_cast<size_t>(s) * slab_stride;
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      const int c = t + m * nt;
      if (c >= cells) continue;
      T dep = w[0] * acc[0][m];
#pragma unroll
      for (int g = 1; g < G; ++g)
        if (g < gcount) dep += w[g] * acc[g][m];
      atomicAdd(j_slab + c, dep);
    }
  }
  // no CTA leaves while a neighbour may still read its planes
  if (csize > 1) cg::this_cluster().sync();
}

// One launch's shape and where it reports: n_clusters clusters of csize
// CTAs of `threads` threads with `smem` bytes each; query_only asks the
// occupancy and launches nothing; occupancy[0] gets the clusters of this
// shape the card holds at once, occupancy[1] the query's cudaError_t.
struct Launch {
  int n_clusters, threads;
  size_t smem;
  int query_only;
  int* occupancy;
  cudaStream_t stream;
};

// Sets the kernel's attributes, asks the occupancy, refuses 0 or a failed
// query (kNotSchedulable) and, in the ring, more clusters than the card
// holds at once (cudaErrorCooperativeLaunchTooLarge), and unless
// query_only launches (the ring cooperatively: all co-resident, or not at
// all).
template <typename T, bool CLAMPED, int G, int CPT, bool RING>
int launch_shape(const ClusterParams<T>& p, const Launch& l) {
  static_assert(max_threads<T, G, CPT, RING>() > 0, "registers of no block");
  auto kernel = sweep_cluster_kernel<T, CLAMPED, G, CPT, RING>;
  const long long covered = static_cast<long long>(l.threads) * CPT;
  if (l.threads < 32 || l.threads > max_threads<T, G, CPT, RING>() ||
      covered < static_cast<long long>(p.rows_max) * p.nz ||
      (RING && l.threads < p.rows_max))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.smem));
  if (err != cudaSuccess) return err;
  if (p.csize > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(l.n_clusters * p.csize));
  cfg.blockDim = dim3(static_cast<unsigned>(l.threads));
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = l.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;  // the occupancy query: the cluster's shape alone
  l.occupancy[0] = 0;
  err = cudaOccupancyMaxActiveClusters(&l.occupancy[0], kernel, &cfg);
  l.occupancy[1] = static_cast<int>(err);
  if (err != cudaSuccess) {
    cudaGetLastError();  // the query's error is reported, not left sticky
    return kNotSchedulable;
  }
  if (l.occupancy[0] < 1) return kNotSchedulable;
  if (RING && l.occupancy[0] < l.n_clusters)
    return cudaErrorCooperativeLaunchTooLarge;
  if (l.query_only) return cudaSuccess;
  cfg.numAttrs = RING ? 2 : 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// 1, 2 or 4 cells per thread (core/sweep_cluster.py::CELLS_PER_THREAD):
// 8 and 16 ran slower at every (C, G) on the H100 (PERF.md)
// (the ring: 2 and 4 only, core/sweep_cluster.py::RING_CELLS_PER_THREAD;
// a ring of 1 cell a thread was never co-resident at 128^3)
template <typename T, bool CLAMPED, int G, bool RING>
int by_cpt(const ClusterParams<T>& p, int cpt, const Launch& l) {
  switch (cpt) {
    case 1:
      if constexpr (!RING) return launch_shape<T, CLAMPED, G, 1, RING>(p, l);
      return cudaErrorInvalidValue;
    case 2: return launch_shape<T, CLAMPED, G, 2, RING>(p, l);
    case 4: return launch_shape<T, CLAMPED, G, 4, RING>(p, l);
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

// What the merged, zone and ring launches pass alike.
template <typename T>
void common_params(ClusterParams<T>& p, const int* dir_meta, const void* lens,
                   const int* chains, const int* items, const double uvb[3],
                   double scale, double eps, double a_eps, double inv_eps_cl,
                   int nslab, int ny, int nz, long long slab_stride,
                   long long band_stride, int csize) {
  for (int b = 0; b < 3; ++b) p.uvb[b] = static_cast<T>(uvb[b]);
  p.dir_meta = dir_meta;
  p.lens = static_cast<const T*>(lens);
  p.chains = chains;
  p.items = items;
  p.scale = static_cast<T>(scale);
  p.eps = static_cast<T>(eps);
  p.a_eps = static_cast<T>(a_eps);
  p.inv_eps_cl = static_cast<T>(inv_eps_cl);
  p.slab_stride = slab_stride;
  p.band_stride = band_stride;
  p.nslab = nslab;
  p.ny = ny;
  p.nz = nz;
  p.csize = csize;
  p.rows_max = (ny + csize - 1) / csize;
  p.rank_stride = 0;
  p.halo = nullptr;
  p.status = nullptr;
  p.lines = nullptr;
  p.spin_budget = p.hold_cycles = 0;
  p.n_items = p.ranks = p.nlines = 0;
  p.hold_rank = -1;
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
  for (int q = 0; q < kMaxPerms; ++q) {
    const bool used = q < nperm;
    p.kappa[q] = used ? static_cast<const T*>(kappa[q]) : nullptr;
    p.inv_kappa[q] = used ? static_cast<const T*>(inv_kappa[q]) : nullptr;
    p.jout[q] = used ? static_cast<T*>(jout[q]) : nullptr;
  }
  common_params(p, dir_meta, lens, chains, items, uvb, scale, eps, a_eps,
                inv_eps_cl, nslab, ny, nz, slab_stride, band_stride, csize);
  const Launch l = {n_items, threads,
                    2 * static_cast<size_t>(g) * p.rows_max * nz * sizeof(T),
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
  // the staging planes, then the incoming lines
  const Launch l = {ranks * n_items, threads,
                    static_cast<size_t>(g) * p.rows_max * (2 * nz + 1) *
                        sizeof(T),
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
