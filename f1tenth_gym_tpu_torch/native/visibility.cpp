// Per-tile segment-visibility umbra sweep (ops/culling.py's hot loop).
//
// blocked(tile, S) = exists wall W properly crossing ALL 8 corner->endpoint
// sightlines (4 tile corners x 2 endpoints of S) — the conservative-exact
// umbra test documented in ops/culling.py. The numpy implementation is
// O(T*K^2) without early exit and takes minutes on the reference's vegas
// (K=709) / stata_basement (K=1555) maps; this version prunes occluders by
// range per tile, orders them longest-first, early-exits each (tile, S) on
// the first blocker and each candidate W on the first uncrossed sightline,
// and parallelizes over tiles with OpenMP. Same strict f64 predicates and
// margin as the numpy path (1e-6 on cross-product products).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {
constexpr double kEps = 1e-6;

inline double cross(double ax, double ay, double bx, double by) {
  return ax * by - ay * bx;
}

struct Seg {
  double ax, ay, bx, by, ex, ey, len2;
};
}  // namespace

extern "C" {

// segs: (K,4) targets; occ: (Kw,4) occluder walls; corners: (T,4,2) tile
// corners (world frame); blocked_out: (T,K) 0/1, 1 = provably occluded.
// max_range prunes occluders per tile (a blocker of an in-range sightline
// lies within max_range + 2*tile_diag of the tile center).
void tile_blocked_mask(const double* segs, int K, const double* occ, int Kw,
                       const double* corners, int T, double max_range,
                       double tile_diag, unsigned char* blocked_out) {
  std::vector<Seg> walls(Kw);
  std::vector<int> order(Kw);
  for (int w = 0; w < Kw; ++w) {
    Seg& s = walls[w];
    s.ax = occ[4 * w], s.ay = occ[4 * w + 1];
    s.bx = occ[4 * w + 2], s.by = occ[4 * w + 3];
    s.ex = s.bx - s.ax, s.ey = s.by - s.ay;
    s.len2 = s.ex * s.ex + s.ey * s.ey;
    order[w] = w;
  }
  // longest walls first: they block the most, so the early exit fires fast
  std::sort(order.begin(), order.end(), [&](int a, int b) {
    return walls[a].len2 > walls[b].len2;
  });

  const double prune = max_range + 2.0 * tile_diag;
  const double prune2 = prune * prune;

#pragma omp parallel for schedule(dynamic, 4)
  for (int t = 0; t < T; ++t) {
    const double* c = corners + 8 * t;  // 4 corners (x,y)
    const double cx = (c[0] + c[2] + c[4] + c[6]) * 0.25;
    const double cy = (c[1] + c[3] + c[5] + c[7]) * 0.25;

    // Pass 1 over targets: in-range flags (targets beyond max_range of the
    // tile are removed by the caller's range mask anyway — skip their
    // umbra tests; on multi-track worlds this is most of the pair matrix)
    // and the tile's sightline reach. A blocker must CROSS some
    // corner->endpoint sightline, i.e. contain a point of it, and every
    // point of such a sightline lies within max(corner dist, endpoint
    // dist) of the tile center — so the occluder prune radius must cover
    // the farthest ENDPOINT of any in-range target (which can exceed
    // max_range for a long wall whose near end is in range), not just
    // max_range itself.
    std::vector<unsigned char> in_range(K);
    double reach = tile_diag;  // corners are within tile_diag of center
    for (int s = 0; s < K; ++s) {
      const double qx[2] = {segs[4 * s], segs[4 * s + 2]};
      const double qy[2] = {segs[4 * s + 1], segs[4 * s + 3]};
      double ex = qx[1] - qx[0], ey = qy[1] - qy[0];
      double l2 = ex * ex + ey * ey;
      double apx = cx - qx[0], apy = cy - qy[0];
      double u = l2 > 1e-30 ? (apx * ex + apy * ey) / l2 : 0.0;
      u = u < 0.0 ? 0.0 : (u > 1.0 ? 1.0 : u);
      double dx = apx - u * ex, dy = apy - u * ey;
      in_range[s] = (dx * dx + dy * dy <= prune2);
      if (in_range[s]) {
        for (int e = 0; e < 2; ++e) {
          double d2 = (qx[e] - cx) * (qx[e] - cx) + (qy[e] - cy) * (qy[e] - cy);
          if (d2 > reach * reach) reach = std::sqrt(d2);
        }
      }
    }
    const double oprune2 = (reach + 1e-6) * (reach + 1e-6);

    // occluders within sightline reach of this tile, longest first
    std::vector<int> local;
    local.reserve(Kw);
    for (int oi = 0; oi < Kw; ++oi) {
      const Seg& w = walls[order[oi]];
      if (w.len2 < 1e-12) continue;
      // point-to-segment distance from tile center
      double apx = cx - w.ax, apy = cy - w.ay;
      double u = (apx * w.ex + apy * w.ey) / w.len2;
      u = u < 0.0 ? 0.0 : (u > 1.0 ? 1.0 : u);
      double dx = apx - u * w.ex, dy = apy - u * w.ey;
      if (dx * dx + dy * dy <= oprune2) local.push_back(order[oi]);
    }

    for (int s = 0; s < K; ++s) {
      const double qx[2] = {segs[4 * s], segs[4 * s + 2]};
      const double qy[2] = {segs[4 * s + 1], segs[4 * s + 3]};
      if (!in_range[s]) {
        blocked_out[(size_t)t * K + s] = 0;
        continue;
      }
      unsigned char hit = 0;
      for (int wi : local) {
        const Seg& w = walls[wi];
        bool all_cross = true;
        for (int ci = 0; ci < 4 && all_cross; ++ci) {
          const double px = c[2 * ci], py = c[2 * ci + 1];
          // corner side of W (shared across both endpoints)
          const double d3 =
              cross(w.ex, w.ey, px - w.ax, py - w.ay);
          for (int e = 0; e < 2; ++e) {
            const double d4 =
                cross(w.ex, w.ey, qx[e] - w.ax, qy[e] - w.ay);
            if (!(d3 * d4 < -kEps)) { all_cross = false; break; }
            const double qpx = qx[e] - px, qpy = qy[e] - py;
            const double d1 = cross(qpx, qpy, w.ax - px, w.ay - py);
            const double d2 = cross(qpx, qpy, w.bx - px, w.by - py);
            if (!(d1 * d2 < -kEps)) { all_cross = false; break; }
          }
        }
        if (all_cross) { hit = 1; break; }
      }
      blocked_out[(size_t)t * K + s] = hit;
    }
  }
}

}  // extern "C"
