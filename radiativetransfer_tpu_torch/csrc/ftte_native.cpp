// Native runtime components for the TPU radiative-transfer framework.
//
// The reference's runtime (grid walk, snapshot flattening, format
// converters) is compiled Fortran; this library provides the equivalent
// native implementations for the host-side paths that are not device
// compute:
//
//  * the depth-first space-filling-curve leaf enumeration used by the
//    cellArray snapshot format (writeCell, equiSources.f90:4044-4079:
//    base cells in i,j,k order, children recursively in 2x2x2 i,j,k
//    order) and its inverse, matching readCellArray.f90 /
//    convertFormats.f90 semantics;
//  * leaf coordinate reconstruction (computeCellCoordinates,
//    hdf42bin.f90:222-269).
//
// Exposed through a C ABI for ctypes (no pybind11 in the image).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Enumerator {
  int nlevels;                      // number of refinement levels present
  const uint8_t* const* refined;    // per level l: dense (nx<<l)^3 bitmap
  int64_t nx, ny, nz;
  int64_t* out_level;
  double* out_x;                    // leaf centers in [0,1)
  double* out_y;
  double* out_z;
  int64_t* out_src;                 // flat index into the leaf's level grid
  int64_t count;
  bool record;

  inline bool is_refined(int level, int64_t i, int64_t j, int64_t k) const {
    if (level >= nlevels) return false;
    const uint8_t* map = refined[level];
    if (!map) return false;
    const int64_t sy = ny << level, sz = nz << level;
    return map[(i * sy + j) * sz + k] != 0;
  }

  void visit(int level, int64_t i, int64_t j, int64_t k) {
    if (is_refined(level, i, j, k)) {
      // children in the reference's i,j,k order (writeCell :4053-4060)
      for (int di = 0; di < 2; ++di)
        for (int dj = 0; dj < 2; ++dj)
          for (int dk = 0; dk < 2; ++dk)
            visit(level + 1, 2 * i + di, 2 * j + dj, 2 * k + dk);
    } else {
      if (record) {
        const int64_t sy = ny << level, sz = nz << level;
        out_level[count] = level;
        out_src[count] = (i * sy + j) * sz + k;
        const double sx = static_cast<double>(nx << level);
        out_x[count] = (i + 0.5) / sx;
        out_y[count] = (j + 0.5) / (static_cast<double>(ny << level));
        out_z[count] = (k + 0.5) / (static_cast<double>(nz << level));
      }
      ++count;
    }
  }

  void run() {
    count = 0;
    for (int64_t i = 0; i < nx; ++i)
      for (int64_t j = 0; j < ny; ++j)
        for (int64_t k = 0; k < nz; ++k)
          visit(0, i, j, k);
  }
};

}  // namespace

extern "C" {

// Count leaves of the octree described by per-level refinement bitmaps.
int64_t ftte_sfc_count(int64_t nx, int64_t ny, int64_t nz, int nlevels,
                       const uint8_t* const* refined) {
  Enumerator e{nlevels, refined, nx, ny, nz,
               nullptr, nullptr, nullptr, nullptr, nullptr, 0, false};
  e.run();
  return e.count;
}

// Enumerate leaves in the reference's depth-first snapshot order.
// out_level[n], out_src[n] (flat index into that level's dense grid),
// out_x/y/z[n] (leaf centers in box units).  Returns the leaf count.
int64_t ftte_sfc_enumerate(int64_t nx, int64_t ny, int64_t nz, int nlevels,
                           const uint8_t* const* refined, int64_t* out_level,
                           int64_t* out_src, double* out_x, double* out_y,
                           double* out_z) {
  Enumerator e{nlevels, refined, nx, ny, nz,
               out_level, out_x, out_y, out_z, out_src, 0, true};
  e.run();
  return e.count;
}

// Gather leaf values from per-level dense field arrays into SFC order:
// out[n] = fields[level[n]][src[n]].
void ftte_sfc_gather(int64_t nleaf, const int64_t* level, const int64_t* src,
                     const double* const* fields, double* out) {
  for (int64_t n = 0; n < nleaf; ++n) out[n] = fields[level[n]][src[n]];
}

// Scatter SFC-ordered leaf values back onto per-level dense field arrays.
void ftte_sfc_scatter(int64_t nleaf, const int64_t* level, const int64_t* src,
                      const double* values, double* const* fields) {
  for (int64_t n = 0; n < nleaf; ++n) fields[level[n]][src[n]] = values[n];
}

}  // extern "C"
