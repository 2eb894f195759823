// Uniform-grid cell-table builder — C++ runtime component (SURVEY.md §2.2
// "Accel grid/BVH": the reference's accelerator build is native; ours too).
// Python computes bbox/resolution (cheap); this fills the fixed-capacity cell
// table + overflow list with semantics identical to the NumPy fallback in
// raytracer/accel/grid.py (ascending triangle ids per cell; sorted
// overflow) so the two builders produce byte-identical arrays.

#include <algorithm>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <set>
#include <vector>

namespace {

// SAT triangle/box overlap (touching counts as overlap; all separation
// comparisons strict). Byte-identical twin of
// raytracer/accel/satbin.py:tri_cells_overlap — identical f64 expression
// trees in identical association order; this translation unit is compiled
// with -ffp-contract=off so no FMA fusion diverges from NumPy. Keep in sync.
struct SatAxes {
  double L[10][3];  // 9 edge-cross axes + triangle normal
  double r[10];     // box projection radius per axis
};

inline void sat_axes(const double e0[3], const double e1[3],
                     const double e2[3], const double half[3], SatAxes* ax) {
  const double* es[3] = {e0, e1, e2};
  int k = 0;
  for (int j = 0; j < 3; ++j) {
    const double ex = es[j][0], ey = es[j][1], ez = es[j][2];
    const double axes[3][3] = {
        {0.0, -ez, ey}, {ez, 0.0, -ex}, {-ey, ex, 0.0}};
    for (int a = 0; a < 3; ++a, ++k) {
      ax->L[k][0] = axes[a][0];
      ax->L[k][1] = axes[a][1];
      ax->L[k][2] = axes[a][2];
    }
  }
  // n = e0 × e1
  ax->L[9][0] = e0[1] * e1[2] - e0[2] * e1[1];
  ax->L[9][1] = e0[2] * e1[0] - e0[0] * e1[2];
  ax->L[9][2] = e0[0] * e1[1] - e0[1] * e1[0];
  for (int k2 = 0; k2 < 10; ++k2)
    ax->r[k2] = (half[0] * std::fabs(ax->L[k2][0]) +
                 half[1] * std::fabs(ax->L[k2][1])) +
                half[2] * std::fabs(ax->L[k2][2]);
}

inline bool sat_overlap(const SatAxes& ax, const double w0[3],
                        const double w1[3], const double w2[3]) {
  for (int k = 0; k < 10; ++k) {
    const double* L = ax.L[k];
    const double q0 = (w0[0] * L[0] + w0[1] * L[1]) + w0[2] * L[2];
    const double q1 = (w1[0] * L[0] + w1[1] * L[1]) + w1[2] * L[2];
    const double q2 = (w2[0] * L[0] + w2[1] * L[1]) + w2[2] * L[2];
    const double lo = std::min(q0, std::min(q1, q2));
    const double hi = std::max(q0, std::max(q1, q2));
    if (lo > ax.r[k] || hi < -ax.r[k]) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// Returns 0 on success. cell_tris_out: malloc'd [nx*ny*nz*capacity] i32 filled
// with `nt` sentinels; overflow_out: malloc'd sorted unique spilled ids.
int rt_grid_build(const float* verts, int nv, const int* tris, int nt,
                  const double* bmin, const double* cell_size, int nx, int ny,
                  int nz, int capacity, int** cell_tris_out,
                  int** overflow_out, int* n_overflow) {
  (void)nv;
  const long ncells = (long)nx * ny * nz;
  int* table = (int*)std::malloc(sizeof(int) * ncells * capacity);
  if (!table) return 1;
  std::vector<int> counts(ncells, 0);
  for (long c = 0; c < ncells * capacity; ++c) table[c] = nt;
  std::set<int> overflow;

  auto clampi = [](int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
  };

  for (int i = 0; i < nt; ++i) {
    double tmin[3], tmax[3];
    for (int a = 0; a < 3; ++a) {
      double p0 = verts[3 * tris[3 * i] + a];
      double p1 = verts[3 * tris[3 * i + 1] + a];
      double p2 = verts[3 * tris[3 * i + 2] + a];
      tmin[a] = std::min(p0, std::min(p1, p2));
      tmax[a] = std::max(p0, std::max(p1, p2));
    }
    int lo[3], hi[3];
    const int res[3] = {nx, ny, nz};
    for (int a = 0; a < 3; ++a) {
      lo[a] = clampi((int)((tmin[a] - bmin[a]) / cell_size[a]), 0, res[a] - 1);
      hi[a] = clampi((int)((tmax[a] - bmin[a]) / cell_size[a]), 0, res[a] - 1);
    }
    for (int cx = lo[0]; cx <= hi[0]; ++cx)
      for (int cy = lo[1]; cy <= hi[1]; ++cy)
        for (int cz = lo[2]; cz <= hi[2]; ++cz) {
          long c = ((long)cx * ny + cy) * nz + cz;
          if (counts[c] < capacity)
            table[c * capacity + counts[c]++] = i;
          else
            overflow.insert(i);
        }
  }

  int* ov = (int*)std::malloc(sizeof(int) * std::max<size_t>(overflow.size(), 1));
  if (!ov) {
    std::free(table);
    return 1;
  }
  int k = 0;
  for (int id : overflow) ov[k++] = id;
  *cell_tris_out = table;
  *overflow_out = ov;
  *n_overflow = (int)overflow.size();
  return 0;
}

// Exact-binning variant: same contract as rt_grid_build, but a triangle is
// listed only in cells it geometrically overlaps (SAT; touching counts), not
// every cell its AABB touches. Twin of raytracer/accel/satbin.py:bin_exact.
int rt_grid_build_sat(const float* verts, int nv, const int* tris, int nt,
                      const double* bmin, const double* cell_size, int nx,
                      int ny, int nz, int capacity, int** cell_tris_out,
                      int** overflow_out, int* n_overflow) {
  (void)nv;
  const long ncells = (long)nx * ny * nz;
  int* table = (int*)std::malloc(sizeof(int) * ncells * capacity);
  if (!table) return 1;
  std::vector<int> counts(ncells, 0);
  for (long c = 0; c < ncells * capacity; ++c) table[c] = nt;
  std::set<int> overflow;

  auto clampi = [](int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
  };
  const double half[3] = {cell_size[0] * 0.5, cell_size[1] * 0.5,
                          cell_size[2] * 0.5};

  for (int i = 0; i < nt; ++i) {
    double p[3][3];
    for (int k = 0; k < 3; ++k)
      for (int a = 0; a < 3; ++a) p[k][a] = verts[3 * tris[3 * i + k] + a];
    double tmin[3], tmax[3];
    for (int a = 0; a < 3; ++a) {
      tmin[a] = std::min(p[0][a], std::min(p[1][a], p[2][a]));
      tmax[a] = std::max(p[0][a], std::max(p[1][a], p[2][a]));
    }
    int lo[3], hi[3];
    const int res[3] = {nx, ny, nz};
    for (int a = 0; a < 3; ++a) {
      lo[a] = clampi((int)((tmin[a] - bmin[a]) / cell_size[a]), 0, res[a] - 1);
      hi[a] = clampi((int)((tmax[a] - bmin[a]) / cell_size[a]), 0, res[a] - 1);
    }
    double e0[3], e1[3], e2[3];
    for (int a = 0; a < 3; ++a) {
      e0[a] = p[1][a] - p[0][a];
      e1[a] = p[2][a] - p[1][a];
      e2[a] = p[0][a] - p[2][a];
    }
    SatAxes ax;
    sat_axes(e0, e1, e2, half, &ax);

    for (int cx = lo[0]; cx <= hi[0]; ++cx)
      for (int cy = lo[1]; cy <= hi[1]; ++cy)
        for (int cz = lo[2]; cz <= hi[2]; ++cz) {
          const int ci[3] = {cx, cy, cz};
          double w[3][3];
          for (int a = 0; a < 3; ++a) {
            const double center = bmin[a] + (ci[a] + 0.5) * cell_size[a];
            w[0][a] = p[0][a] - center;
            w[1][a] = p[1][a] - center;
            w[2][a] = p[2][a] - center;
          }
          if (!sat_overlap(ax, w[0], w[1], w[2])) continue;
          long c = ((long)cx * ny + cy) * nz + cz;
          if (counts[c] < capacity)
            table[c * capacity + counts[c]++] = i;
          else
            overflow.insert(i);
        }
  }

  int* ov = (int*)std::malloc(sizeof(int) * std::max<size_t>(overflow.size(), 1));
  if (!ov) {
    std::free(table);
    return 1;
  }
  int k = 0;
  for (int id : overflow) ov[k++] = id;
  *cell_tris_out = table;
  *overflow_out = ov;
  *n_overflow = (int)overflow.size();
  return 0;
}

}  // extern "C"
