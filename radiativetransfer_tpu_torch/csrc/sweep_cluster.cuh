// The cluster sweep kernel's body, shared by csrc/sweep_cluster.cu (the
// main path's instances: the merged sweep, one zone's sweep and the halo
// ring) and csrc/sweep_cluster_exp.cu (the two TPU sweep experiments' #6
// and #7 instances), with the launch that both use.  The design is
// described in csrc/sweep_cluster.cu; what an instance computes is its Mode
// (a compile-time policy), below.

#pragma once

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

// What an instance of the body computes (its traits below are evaluated
// at compile time, on the host and on the device).
// * kExact, kClamped: the merged sweep (and one zone's) in the exact or the
//   clamped logmean, from the 8-slot rows of core/sweep_cuda.py::
//   kernel_tables; kRing: the halo ring, exact (csrc/sweep_cluster.cu).
// * kPair (#6, scripts/exp_sweep_pair.py::_pair_kernel): kExact's
//   arithmetic op for op, one loop trip per two slabs: both slabs' kappa
//   and 1/kappa prefetched two slabs ahead, the first slab's deposit issued
//   after the second slab's segment 1.
// * the lean variants (#7, scripts/exp_sweep_variants.py::_lean_kernel),
//   from act-folded 16-slot rows (ln, C, h, s per segment; core/
//   variants_cuda.py::_lean_pack), in rt_sweep_lean's order: kLean (lm from
//   (i_out - i_in) * 1/kappa * C, small tau i_in * (s + h kappa)),
//   kLeanClamp (the clamped form with the rows' positive C), kLeanClamp2
//   (that with exp2f on lengths pre-scaled by log2 e), kSeg1 (segment 1
//   only: no staging plane, no barrier, no distributed shared memory),
//   kNoemi (lm = i_out) and kNoshift (a chained segment reads the thread's
//   own cell: no staging plane, no barrier).  An inactive segment adds
//   exactly 0 through its act-folded row, so a direction skips it, except
//   under kNoemi, where it adds its i_out (its upwind k-neighbour, chain
//   code 0): there every direction runs both chained stages.
// The experiments' instances stage their G directions' rows (and chain
// codes) of every slab in shared memory once, before the first slab.
enum Mode : int {
  kExact,
  kClamped,
  kRing,
  kPair,
  kLean,
  kLeanClamp,
  kLeanClamp2,
  kSeg1,
  kNoemi,
  kNoshift,
};
__host__ __device__ constexpr bool is_lean(int m) { return m >= kLean; }
__host__ __device__ constexpr bool lean_clamped(int m) {
  return m == kLeanClamp || m == kLeanClamp2;
}
// runs segments 2 and 3
__host__ __device__ constexpr bool chained(int m) { return m != kSeg1; }
// a chained segment reads its upwind neighbour: staging planes, barriers
__host__ __device__ constexpr bool shifts(int m) {
  return chained(m) && m != kNoshift;
}
// the rows and chain codes of the G directions staged in shared memory
__host__ __device__ constexpr bool staged_tables(int m) { return m >= kPair; }
__host__ __device__ constexpr int row_slots(int m) {
  return is_lean(m) ? 16 : 8;
}
__host__ __device__ constexpr int slabs_per_trip(int m) {
  return m == kPair ? 2 : 1;
}

template <typename T>
struct ClusterParams {
  // per axis permutation, each (3, nslab, ny, nz) in that permutation's
  // order: kappa, its hoisted reciprocal, and the zeroed Jmean output
  const T* kappa[kMaxPerms];
  const T* inv_kappa[kMaxPerms];
  T* jout[kMaxPerms];
  const int* dir_meta;   // (ndir, 4): perm index, reverse, flip_j, flip_k
  const T* lens;         // (ndir, nslab, 8): -len*cell x3, inv_n,
                         //   -1/(len*cell) x3, pad; the lean variants'
                         //   (ndir, nslab, 16): ln x3, C x3, h x3, s x3, pad
  const int* chains;     // (ndir, nslab, 2): chain2, chain3 (0/1=XZ/2=YZ)
  const int* items;      // (n_items, 4): first direction, directions
                         //   (<= G), band, 0; one item per cluster
  T uvb[3];
  T scale;               // angular weight 1/N
  T eps;                 // small-tau switch of the exact logmean (of the
                         //   lean variants: in the tau_n domain of its exp)
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

// The most threads a CTA of <T, M, G, CPT> may have: the registers one
// thread needs without spilling (carry and logmean per direction and cell,
// kappa and 1/kappa of this slab and the next: ~2.5 G + 4.5 per f32 cell,
// twice that in f64, and ~26 of addresses, lengths and loop state, ~58 in
// f64; fitted to ptxas -v's counts and spills; the ring's line numbers,
// pointers and flags ~RING_REGS more; and each Mode's own terms, below)
// under the per-thread cap that this block size leaves (65,536 per SM).
// core/sweep_cluster.py::max_threads computes the same, and
// tests/test_torch_sweep_cluster.py reads both formulas here and holds the
// two to each other.
template <typename T>
constexpr int kWords = static_cast<int>(sizeof(T) / 4);  // 32-bit registers
constexpr int RING_REGS = 16;
// Each Mode's registers beyond the merged sweep's, per cell, 32-bit word
// and direction, in halves (core/sweep_cluster.py::CELL_REGS_G), fitted to
// ptxas -v's counts and spills of each instance at every block size: the
// pair's second slab of kappa and 1/kappa, current and prefetched, and its
// held deposit (fitted so that its G 1 x 4 cells instance keeps the
// 1024-thread block that 256^3 needs, where it spills 80 B).  The lean
// variants fit the merged sweep's blocks; at G 2 x 4 cells the lean, clamp
// and clamp2 instances spill 76-88 B there, and ran faster on the H100 at
// that block than at 768 threads without spills (PERF.md).
constexpr int kCellRegsG[] = {0, 0, 0, 5, 0, 0, 0, 0, 0, 0};
template <typename T, int M, int G, int CPT>
constexpr int kRegs = ((5 * G + 9 + kCellRegsG[M] * G) * CPT * kWords<T> +
                       1) / 2 + 26 + 32 * (kWords<T> - 1) +
                      RING_REGS * (M == kRing);

// 0 where no block size leaves enough
template <typename T, int M, int G, int CPT>
constexpr int max_threads() {
  constexpr int regs = kRegs<T, M, G, CPT>;
  return regs <= 64 ? 1024 : regs <= 80 ? 768 : regs <= 128 ? 512
       : regs <= 168 ? 384 : regs <= 255 ? 256 : 0;
}

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
__device__ __forceinline__ float dev_exp2(float x) { return exp2f(x); }
__device__ __forceinline__ double dev_exp2(double x) { return exp2(x); }
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

// One segment of a lean variant, op for op as the TPU kernel and csrc/
// sweep_variants.cu's lean kernel (exp_sweep_variants.py:92-109).
// A segment's coefficients: ln, C, h, s from the row's slots k, 3 + k,
// 6 + k, 9 + k.
template <typename T, int M>
__device__ __forceinline__ void lean_segment(const ClusterParams<T>& p,
                                             T i_in, T kap, T inv_kap, T ln,
                                             T C, T h, T sp, T& i_out,
                                             T& lm) {
  const T tau_n = kap * ln;
  const T a = M == kLeanClamp2 ? dev_exp2(tau_n) : dev_exp(tau_n);
  i_out = i_in * a;
  if constexpr (M == kNoemi) {
    lm = i_out;
  } else if constexpr (lean_clamped(M)) {
    const T d = i_in - i_in * dev_min(a, p.a_eps);
    lm = d * dev_min(inv_kap * C, sp * p.inv_eps_cl);
  } else {
    lm = (tau_n < -p.eps) ? (i_out - i_in) * (inv_kap * C)
                          : i_in * (sp + h * kap);
  }
}

// A segment of mode M: of an 8-slot row ln = len_n and c = 1/len_n (h and
// sp unused), of a lean row ln, C, h and s.
template <typename T, int M>
__device__ __forceinline__ void any_segment(const ClusterParams<T>& p,
                                            T i_in, T kap, T inv_kap, T ln,
                                            T c, T h, T sp, T& i_out,
                                            T& lm) {
  if constexpr (is_lean(M)) {
    lean_segment<T, M>(p, i_in, kap, inv_kap, ln, c, h, sp, i_out, lm);
  } else {
    segment<T, M == kClamped>(p, i_in, kap, inv_kap, ln, c, i_out, lm);
  }
}

// the slot of a row's c (8-slot: 1/len_n) or C (lean) of segment 0
template <int M>
constexpr int kCSlot = is_lean(M) ? 3 : 4;

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

// Dynamic shared memory of a CTA of mode M: the staging planes [parity]
// [direction][rows_max * nz] (modes that shift), then in the ring the
// incoming lines [direction][rows_max], or the experiments' staged rows
// [direction][slab][row_slots] and chain codes [direction][slab][2].
template <typename T, int M>
size_t smem_bytes(int g, int rows_max, int nz, int nslab) {
  size_t planes = shifts(M) ? 2 * static_cast<size_t>(g) * rows_max * nz : 0;
  if (M == kRing) planes += static_cast<size_t>(g) * rows_max;
  const size_t tables =
      staged_tables(M)
          ? static_cast<size_t>(g) * nslab *
                (row_slots(M) * sizeof(T) + 2 * sizeof(int))
          : 0;
  return planes * sizeof(T) + tables;
}

template <typename T, int M, int G, int CPT>
__device__ __forceinline__ void cluster_body(const ClusterParams<T>& p) {
  constexpr bool RING = M == kRing;
  constexpr bool TABLES = staged_tables(M);
  constexpr int LS = row_slots(M);
  constexpr int SLABS = slabs_per_trip(M);
  // noemi adds the output of inactive segments: every stage runs
  constexpr bool ALL_STAGES = M == kNoemi;
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
  if (shifts(M) && csize > 1) {
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

  // the experiments: the G directions' rows and chain codes of every slab,
  // staged once (a missing direction's all 0)
  T* tab = planes + (shifts(M) ? 2 * G * pstride : 0);
  int* tch = reinterpret_cast<int*>(tab + (TABLES ? G * nslab * LS : 0));
  if constexpr (TABLES) {
    const size_t first = static_cast<size_t>(d0) * nslab;
    for (int e = t; e < G * nslab * LS; e += nt)
      tab[e] = e < gcount * nslab * LS ? p.lens[first * LS + e] : T(0);
    for (int e = t; e < G * nslab * 2; e += nt)
      tch[e] = e < gcount * nslab * 2 ? p.chains[first * 2 + e] : 0;
    __syncthreads();
  }

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

  // kap/ikap: the next trip's slabs, loaded while this one is computed (a
  // register prefetch one trip ahead: one slab, two in the pair)
  T carry[G][CPT], acc[G][CPT], kap[SLABS][CPT], ikap[SLABS][CPT];
  // noemi: each direction's last segment output, active or not, which its
  // next stage shifts (the carry is its last active one)
  T last[ALL_STAGES ? G : 1][ALL_STAGES ? CPT : 1];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      carry[g][m] = pad;
      if constexpr (ALL_STAGES) last[g][m] = pad;
    }
#pragma unroll
  for (int h = 0; h < SLABS; ++h) {
    const size_t off =
        static_cast<size_t>(reverse ? nslab - 1 - h : h) * slab_stride;
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      const int c = t + m * nt;
      kap[h][m] = c < cells ? __ldg(kap_band + off + c) : T(0);
      ikap[h][m] = c < cells ? __ldg(ikap_band + off + c) : T(0);
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

  // the pair: its first slab's deposit, held over the second slab's
  // segment 1
  T held[SLABS == 2 ? CPT : 1];
  int parity = 0;
  for (int i0 = 0; i0 < nslab; i0 += SLABS) {
    const int s0 = reverse ? nslab - 1 - i0 : i0;
    T kc[SLABS][CPT], ikc[SLABS][CPT];
#pragma unroll
    for (int h = 0; h < SLABS; ++h)
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        kc[h][m] = kap[h][m];
        ikc[h][m] = ikap[h][m];
      }
    if (i0 + SLABS < nslab) {  // the next trip's loads, in flight over this
#pragma unroll
      for (int h = 0; h < SLABS; ++h) {
        const size_t off = static_cast<size_t>(
            reverse ? s0 - SLABS - h : s0 + SLABS + h) * slab_stride;
#pragma unroll
        for (int m = 0; m < CPT; ++m) {
          const int c = t + m * nt;
          if (c < cells) {
            kap[h][m] = __ldg(kap_band + off + c);
            ikap[h][m] = __ldg(ikap_band + off + c);
          }
        }
      }
    }

#pragma unroll
    for (int h = 0; h < SLABS; ++h) {
    // sweep-order slab i, physical slab s
    const int i = i0 + h;
    const int s = reverse ? s0 - h : s0 + h;

    // segment 1 (xy) of every direction: the thread's own cells only
    int ch2[G], ch3[G];
    int any2 = 0, any3 = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      ch2[g] = 0;
      ch3[g] = 0;
      if (g < gcount) {
        const size_t row = TABLES ? static_cast<size_t>(g) * nslab + i
                                  : static_cast<size_t>(d0 + g) * nslab + i;
        const T* l = (TABLES ? tab : p.lens) + LS * row;
        const int* ch = TABLES ? tch : p.chains;
        ch2[g] = ch[2 * row];
        ch3[g] = ch[2 * row + 1];
        any2 |= ch2[g];
        any3 |= ch3[g];
        const T ln = l[0], cc = l[kCSlot<M>];
        T hh = T(0), sp = T(0);
        if constexpr (is_lean(M)) {
          hh = l[6];
          sp = l[9];
        }
#pragma unroll
        for (int m = 0; m < CPT; ++m) {
          T i_out, lm;
          any_segment<T, M>(p, carry[g][m], kc[h][m], ikc[h][m], ln, cc, hh,
                            sp, i_out, lm);
          carry[g][m] = i_out;
          acc[g][m] = lm;
          if constexpr (ALL_STAGES) last[g][m] = i_out;
        }
      }
    }
    if constexpr (SLABS == 2) {
      if (h == 1) {  // the pair's first slab's deposit
        T* j_slab = j_band + static_cast<size_t>(s0) * slab_stride;
#pragma unroll
        for (int m = 0; m < CPT; ++m) {
          const int c = t + m * nt;
          if (c < cells) atomicAdd(j_slab + c, held[m]);
        }
      }
    }

    // chained segments 2 and 3: the union of the directions' active ones
    // (under noemi every stage, inactive segments as k-shifts)
#pragma unroll
    for (int stage = 1; stage <= 2; ++stage) {
      if (!chained(M)) break;
      if (!ALL_STAGES && (stage == 1 ? any2 : any3) == 0) break;
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
        if (!shifts(M)) break;
        if (!ALL_STAGES && (stage == 1 ? ch2[g] : ch3[g]) == 0) continue;
#pragma unroll
        for (int m = 0; m < CPT; ++m) {
          const int c = t + m * nt;
          T v;
          if constexpr (ALL_STAGES) {
            v = last[g][m];
          } else {
            v = carry[g][m];
          }
          if (c < cells) own[g * pstride + c] = v;
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
      if (shifts(M)) plane_barrier(csize);
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
      T ln[G], cc[G], hh[G], sp[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const size_t row = TABLES ? static_cast<size_t>(g) * nslab + i
                                  : static_cast<size_t>(d0 + g) * nslab + i;
        const T* l = (TABLES ? tab : p.lens) + LS * row;
        ln[g] = g < gcount ? l[stage] : T(0);
        cc[g] = g < gcount ? l[kCSlot<M> + stage] : T(0);
        if constexpr (is_lean(M)) {
          hh[g] = g < gcount ? l[6 + stage] : T(0);
          sp[g] = g < gcount ? l[9 + stage] : T(0);
        } else {
          hh[g] = sp[g] = T(0);
        }
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
          if (!ALL_STAGES && chain == 0) continue;
          const T* src = own + g * pstride;
          T i_in;
          if (!shifts(M)) {  // noshift: the thread's own cell
            i_in = carry[g][m];
          } else if (chain == 1) {
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
          any_segment<T, M>(p, i_in, kc[h][m], ikc[h][m], ln[g], cc[g],
                            hh[g], sp[g], i_out, lm);
          if constexpr (ALL_STAGES) {
            last[g][m] = i_out;
            if (chain != 0) carry[g][m] = i_out;
          } else {
            carry[g][m] = i_out;
          }
          acc[g][m] += lm;
        }
      }
      if (shifts(M)) parity ^= 1;
    }

    // one deposit per cell for the G directions: their weighted logmeans
    // summed in registers (only the order of Jmean's adds changes), each
    // direction's weight 1/N * 1/n_active (a lean row has its 1/n_active
    // folded in: 1/N) taken once per slab
    T w[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const size_t row = TABLES ? static_cast<size_t>(g) * nslab + i
                                : static_cast<size_t>(d0 + g) * nslab + i;
      w[g] = g < gcount
          ? (is_lean(M) ? p.scale
                        : p.scale * (TABLES ? tab : p.lens)[LS * row + 3])
          : T(0);
    }
    T* j_slab = j_band + static_cast<size_t>(s) * slab_stride;
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      const int c = t + m * nt;
      if (c >= cells) continue;
      T dep = w[0] * acc[0][m];
#pragma unroll
      for (int g = 1; g < G; ++g)
        if (g < gcount) dep += w[g] * acc[g][m];
      if constexpr (SLABS == 2) {
        if (h == 0) {
          held[m] = dep;
        } else {
          atomicAdd(j_slab + c, dep);
        }
      } else {
        atomicAdd(j_slab + c, dep);
      }
    }
    }
  }
  // no CTA leaves while a neighbour may still read its planes
  if (shifts(M) && csize > 1) cg::this_cluster().sync();
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
// all).  `kernel` is an instance of cluster_body<T, M, G, CPT>.
template <typename T, int M, int G, int CPT, typename Kernel>
int launch_shape(Kernel kernel, const ClusterParams<T>& p, const Launch& l) {
  constexpr bool RING = M == kRing;
  static_assert(max_threads<T, M, G, CPT>() > 0, "registers of no block");
  const long long covered = static_cast<long long>(l.threads) * CPT;
  if (l.threads < 32 || l.threads > max_threads<T, M, G, CPT>() ||
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

// What every launch passes alike.
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

// The merged launch's fields: per axis permutation (nperm of them)
// kappa, 1/kappa and Jmean.
template <typename T>
void merged_fields(ClusterParams<T>& p, int nperm, const void* const* kappa,
                   const void* const* inv_kappa, void* const* jout) {
  for (int q = 0; q < kMaxPerms; ++q) {
    const bool used = q < nperm;
    p.kappa[q] = used ? static_cast<const T*>(kappa[q]) : nullptr;
    p.inv_kappa[q] = used ? static_cast<const T*>(inv_kappa[q]) : nullptr;
    p.jout[q] = used ? static_cast<T*>(jout[q]) : nullptr;
  }
}

}  // namespace
